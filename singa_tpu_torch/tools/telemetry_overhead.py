"""Measure the flight recorder's step-path overhead: on vs off.

The PyTorch counterpart of ``singa_tpu/tools/telemetry_overhead.py``:
the same probe, flags, defaults, threshold and JSON keys.

The telemetry plane's contract (singa_tpu_torch/obs/) is that it is
ALWAYS ON for free: per-step cost is an O(1) in-memory span append (span
mode), with no write syscalls and no device syncs, and file I/O only at
display cadence. This tool gates that claim the way ckpt_stall and
input_stall gate theirs: the same small MLP job timed with telemetry off
and on (span recording active, a step record + flush every
``--display`` steps), interleaved best-of-trials windows, one JSON
line::

  {"off_step_ms": .., "on_step_ms": .., "ratio": ..,
   "events": .., "writes": .., "threshold": .., "pass": ..}

Exit 0 iff ``on <= threshold x off`` (default 1.02: telemetry may cost
at most 2% of mean step time). ``writes`` in the JSON is the recorder's
file-open count: it must equal the number of cadence flushes, never the
number of steps.

Usage::

  python -m singa_tpu_torch.tools.telemetry_overhead [--steps N]
      [--warmup N] [--trials N] [--display N] [--threshold R]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

from .collective_stall import sync


_CONF = """
name: "telemetry-overhead-probe"
train_steps: 100000
updater {{
  base_learning_rate: 0.05
  learning_rate_change_method: kFixed
  momentum: 0.9
  type: kSGD
}}
neuralnet {{
  layer {{
    name: "data"
    type: "kShardData"
    data_param {{ path: "{shard}" batchsize: {batch} }}
  }}
  layer {{
    name: "mnist"
    type: "kMnistImage"
    srclayers: "data"
    mnist_param {{ norm_a: 127.5 norm_b: 1 }}
  }}
  layer {{ name: "label" type: "kLabel" srclayers: "data" }}
  layer {{
    name: "fc1"
    type: "kInnerProduct"
    srclayers: "mnist"
    inner_product_param {{ num_output: {hidden} }}
    param {{ name: "weight" init_method: kUniform low: -0.05 high: 0.05 }}
    param {{ name: "bias" init_method: kConstant value: 0 }}
  }}
  layer {{ name: "tanh1" type: "kTanh" srclayers: "fc1" }}
  layer {{
    name: "fc2"
    type: "kInnerProduct"
    srclayers: "tanh1"
    inner_product_param {{ num_output: 10 }}
    param {{ name: "weight" init_method: kUniform low: -0.05 high: 0.05 }}
    param {{ name: "bias" init_method: kConstant value: 0 }}
  }}
  layer {{
    name: "loss"
    type: "kSoftmaxLoss"
    softmaxloss_param {{ topk: 1 }}
    srclayers: "fc2"
    srclayers: "label"
  }}
}}
"""


def _make_runner(root: str, shard: str, batch: int, hidden: int,
                 warmup: int, display: int, telemetry: bool, device=None):
    """-> (window(steps) -> seconds, recorder-or-None). Per-step
    driving (whole-window wall clock, one final device sync) with the
    device-cached dataset, so windows measure the step's replay + the
    recorder's buffer appends, not batch assembly noise."""
    from ..config import parse_model_config
    from ..device import resolve_device
    from ..trainer import Trainer

    cfg = parse_model_config(
        _CONF.format(shard=shard, batch=batch, hidden=hidden)
    )
    dev = resolve_device(device)
    trainer = Trainer(
        cfg, None, seed=0, log=lambda s: None, device=dev,
        prefetch=False, device_cache=True,
    )
    rec = None
    if telemetry:
        from ..obs.recorder import FlightRecorder

        rec = FlightRecorder(
            tempfile.mkdtemp(prefix="tel_events_", dir=root),
            rank=0, run_id="overhead-probe", log=lambda s: None,
        )
        trainer.attach_telemetry(rec)

    state = {"step": 0}
    for _ in range(warmup):
        trainer.train_one_batch(state["step"])
        state["step"] += 1
    sync(dev)

    def window(steps: int) -> float:
        step = state["step"]
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_one_batch(step)
            step += 1
            if rec is not None and step % display == 0:
                # the display-cadence path telemetry actually adds: a
                # step record (host values only) + the buffered flush
                rec.event(
                    "step", step=step,
                    phase_ms={
                        p: trainer.timers.mean_ms(p)
                        for p in trainer.timers.phases()
                    },
                )
                rec.flush()
        sync(dev)
        elapsed = time.perf_counter() - t0
        state["step"] = step
        return elapsed

    return window, rec


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="telemetry_overhead", description=__doc__
    )
    ap.add_argument("--steps", type=int, default=60, help="timed steps")
    ap.add_argument("--warmup", type=int, default=5, help="untimed steps")
    ap.add_argument(
        "--trials", type=int, default=4,
        help="windows per mode; the best (least-contended) one counts",
    )
    ap.add_argument("--display", type=int, default=10,
                    help="steps per display-cadence flush")
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument(
        "--threshold", type=float, default=1.02,
        help="max allowed on/off mean-step-time ratio",
    )
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' must be asked "
                    "for)")
    args = ap.parse_args(argv)

    from ..data.loader import synthetic_arrays, write_records

    root = tempfile.mkdtemp(prefix="singa_tpu_torch_tel_")
    shard = os.path.join(root, "shard")
    write_records(shard, *synthetic_arrays(1024, seed=0))
    # interleaved best-of-trials (the stall tools' methodology): one
    # window per mode per round, minimum per mode, so ambient host load
    # spreads across both modes instead of skewing the ratio
    runners = {
        mode: _make_runner(
            root, shard, args.batch, args.hidden, args.warmup,
            args.display, telemetry=mode, device=args.device,
        )
        for mode in (False, True)
    }
    best = {mode: float("inf") for mode in runners}
    for _ in range(args.trials):
        for mode, (window, _) in runners.items():
            best[mode] = min(best[mode], window(args.steps))
    off_ms = best[False] / args.steps * 1e3
    on_ms = best[True] / args.steps * 1e3
    rec = runners[True][1]
    out = {
        "off_step_ms": round(off_ms, 3),
        "on_step_ms": round(on_ms, 3),
        "ratio": round(on_ms / off_ms, 4),
        "events": rec.recorded,
        "writes": rec.writes,
        "threshold": args.threshold,
        "pass": on_ms / off_ms <= args.threshold,
    }
    print(json.dumps(out))
    return 0 if out["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
