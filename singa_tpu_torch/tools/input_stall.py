"""Measure the input stall: streaming step time with prefetch off vs on.

The PyTorch counterpart of ``singa_tpu/tools/input_stall.py``: the same
modes, flags, defaults, threshold and JSON keys, on the port's
``feeder_mode``.

The zero-stall input pipeline's claim (data/device_prefetch.py) is that a
dataset too large to keep on the device no longer pays host batch
assembly + the copy to the device on the step path: per-step runs get a
double-buffered device feeder (batch k+1 copies while step k computes),
and chunked runs get staged blocks (one stacked copy per window,
double-buffered at chunk granularity, one graph replay per step of the
window and no host work between). This tool measures it — and reproduces the OLD synchronous stall
as the baseline — by timing the same small MLP job on a NON-device-cached
(streaming) config three ways:

  sync      prefetch off: assemble + copy on the step path (the
            reference behavior)
  prefetch  the per-step device feeder (feeder_mode "prefetch")
  stream    staged chunk blocks (feeder_mode "stream")

and printing one JSON line::

  {"sync_step_ms": .., "prefetch_step_ms": .., "stream_step_ms": ..,
   "prefetch_ratio": .., "stream_ratio": .., "threshold": .., "pass": ..}

Exit status 0 iff EITHER mode's ratio vs sync is <= ``threshold``
(default 1.0: prefetch-on must not be slower than prefetch-off).
``pass_mode`` in the JSON says which mode carried.

Usage::

  python -m singa_tpu_torch.tools.input_stall [--steps N] [--warmup N]
      [--batch N] [--hidden N] [--records N] [--trials N] [--threshold R]
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
name: "input-stall-probe"
train_steps: 1000000
checkpoint_frequency: 0
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
    inner_product_param {{ num_output: {head} }}
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


def _make_runner(shard: str, batch: int, hidden: int, warmup: int,
                 mode: str, chunk: int, device=None):
    """-> window(steps) -> seconds, for one probe mode.

    ``mode``: "sync" / "prefetch" / "stream". All three run NON-cached
    (``device_cache=False`` — the streaming regime this tool is about).
    The runner is warmed (graph capture + first staged block) before
    returning. Window timing is whole-window wall clock with one final
    device sync (ckpt_stall's methodology): a per-step sync would
    serialize the stream against the feeder's copies and measure the
    serialization, not the stall."""
    from ..config import parse_model_config
    from ..device import resolve_device
    from ..trainer import Trainer

    cfg = parse_model_config(_CONF.format(shard=shard, batch=batch,
                                          hidden=hidden, head=10))
    dev = resolve_device(device)
    trainer = Trainer(
        cfg, seed=0, log=lambda s: None, device=dev,
        prefetch=mode != "sync",
        device_cache=False,
        stream_chunks=mode == "stream",
    )
    assert trainer.feeder_mode == mode, (trainer.feeder_mode, mode)

    if mode == "stream":
        # chunk windows on the run() loop's schedule. NEVER clamp a
        # window: the stager staged exactly _chunk_len(s) steps, and a
        # shorter take is a schedule mismatch — run whole windows until
        # at least `steps` steps have elapsed and normalize by the
        # actual count (with cadences off, _chunk_len is the chunk cap)
        def run(step0: int, steps: int) -> int:
            s, end = step0, step0 + steps
            while s < end:
                n = trainer._chunk_len(s)
                trainer.train_chunk(s, n)
                s += n
            return s
    else:
        def run(step0: int, steps: int) -> int:
            for s in range(step0, step0 + steps):
                trainer.train_one_batch(s)
            return step0 + steps

    state = {"step": 0}
    state["step"] = run(0, max(warmup, chunk))  # capture + fill buffers
    sync(dev)

    def window(steps: int) -> tuple[float, int]:
        step0 = state["step"]
        t0 = time.perf_counter()
        state["step"] = run(step0, steps)
        sync(dev)
        return time.perf_counter() - t0, state["step"] - step0

    window.trainer = trainer
    return window


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="input_stall", description=__doc__)
    ap.add_argument("--steps", type=int, default=96, help="timed steps")
    ap.add_argument("--warmup", type=int, default=8, help="untimed steps")
    ap.add_argument(
        "--trials", type=int, default=3,
        help="windows per mode; the best (least-contended) one counts",
    )
    # the probe regime: a small step whose batch assembly (a ~3 MB
    # fancy-index gather + copy per 1024-record batch) is a real share
    # of the step path
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--records", type=int, default=4096,
                    help="synthetic dataset size (streamed, never cached)")
    ap.add_argument(
        "--threshold", type=float, default=1.0,
        help="max allowed prefetch-on/prefetch-off step-time ratio "
        "(either feeder mode may carry it)",
    )
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' must be asked "
                    "for)")
    args = ap.parse_args(argv)

    from ..data.loader import synthetic_arrays, write_records

    # a modest chunk cap keeps the staged blocks (2 in flight) small
    chunk = int(os.environ.get("SINGA_TPU_CHUNK", "16"))
    os.environ["SINGA_TPU_CHUNK"] = str(chunk)
    root = tempfile.mkdtemp(prefix="singa_tpu_torch_input_stall_")
    shard = os.path.join(root, "shard")
    write_records(shard, *synthetic_arrays(args.records, seed=0))
    # INTERLEAVED best-of-trials (ckpt_stall's methodology): one window
    # per mode per round, minimum per mode — ambient host-load bursts
    # land on all modes instead of skewing one ratio
    runners = {
        mode: _make_runner(shard, args.batch, args.hidden, args.warmup,
                           mode, chunk, device=args.device)
        for mode in ("sync", "prefetch", "stream")
    }
    best = {mode: float("inf") for mode in runners}
    for _ in range(args.trials):
        for mode, window in runners.items():
            elapsed, nsteps = window(args.steps)
            best[mode] = min(best[mode], elapsed / nsteps)
    sync_ms = best["sync"] * 1e3
    prefetch_ms = best["prefetch"] * 1e3
    stream_ms = best["stream"] * 1e3
    prefetch_ok = prefetch_ms <= sync_ms * args.threshold
    stream_ok = stream_ms <= sync_ms * args.threshold
    out = {
        "sync_step_ms": round(sync_ms, 3),
        "prefetch_step_ms": round(prefetch_ms, 3),
        "stream_step_ms": round(stream_ms, 3),
        "prefetch_ratio": round(prefetch_ms / sync_ms, 3),
        "stream_ratio": round(stream_ms / sync_ms, 3),
        "threshold": args.threshold,
        "pass_mode": (
            "stream" if stream_ok else "prefetch" if prefetch_ok else None
        ),
        "pass": stream_ok or prefetch_ok,
    }
    print(json.dumps(out))
    return 0 if out["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
