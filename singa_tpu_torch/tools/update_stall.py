"""Measure the update-phase stall: replicated vs ZeRO-sharded update.

The PyTorch counterpart of ``singa_tpu/tools/update_stall.py``: the same
modes, flags, defaults, threshold and JSON keys.

The zero_update claim (parallel/shardings.py) is that reducing
gradients to each rank's shard, updating that shard only, and stitching
fresh params back shrinks per-rank optimizer state by the data-parallel
degree WITHOUT slowing the step down. This tool measures it by timing
the same small MLP job on an ``ndata``-wide data mesh (every rank on one
device: the GPU, or the CPU with ``--device cpu``) both ways:

  replicated  every rank applies the full update (the reference's
              ParamSync semantics)
  zero        grads reduced to each rank's shard -> shard-local
              optimizer -> params stitched back (update_mode "zero")

and printing one JSON line::

  {"replicated_step_ms": .., "zero_step_ms": .., "ratio": ..,
   "replicated_update_ms": .., "zero_update_ms": ..,
   "opt_bytes_replicated": .., "opt_bytes_zero": .., "opt_bytes_ratio": ..,
   "threshold": .., "pass": ..}

Exit status 0 iff zero/replicated step time <= ``threshold`` (default
1.05) AND per-rank opt-state bytes actually shrank.

``measure_update_ms`` is importable: it slope-fits the update phase in
isolation, N chained updater applications on copies of the live params
and slots, so the reported ms is the marginal per-update cost.

Usage::

  python -m singa_tpu_torch.tools.update_stall [--steps N] [--warmup N]
      [--trials N] [--batch N] [--hidden N] [--ndata N] [--threshold R]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

from .collective_stall import sync


def _update_chain(trainer, n: int):
    """-> run() applying the updater ``n`` times in a chain, as the step
    lays the update out (every device's replica in full for replicated
    params; each rank's box of a zero-sharded param, against its own slot
    shards), on copies of the live params and slots with zero grads (the
    same dense elementwise math), then waiting for the device."""
    mesh = trainer.mesh
    zero = set(trainer._zero_names())
    reps = {dev: ({nm: v.clone() for nm, v in rep["params"].items()
                   if nm not in zero},
                  {nm: {s: v.clone() for s, v in slots.items()}
                   for nm, slots in rep["state"].items() if nm not in zero})
            for dev, rep in trainer._replicas.items()}
    boxes = {}
    for r in mesh.local_ranks:
        params = trainer._replicas[mesh.device(r)]["params"]
        boxes[r] = ({nm: trainer._zero_box(nm, params[nm], r).clone()
                     for nm in zero},
                    {nm: {s: v.clone() for s, v in
                          trainer._zero_slots[r][nm].items()}
                     for nm in zero})

    @torch.no_grad()
    def run() -> None:
        cur = dict(reps)
        mine = dict(boxes)
        for i in range(n):
            for dev, (p, s) in cur.items():
                g = {nm: torch.zeros_like(v) for nm, v in p.items()}
                cur[dev] = trainer.updater.apply(i, p, g, s, trainer.specs)
            for r, (p, s) in mine.items():
                if not p:
                    continue
                g = {nm: torch.zeros_like(v) for nm, v in p.items()}
                mine[r] = trainer.updater.apply(i, p, g, s, trainer.specs)
        sync(trainer.device)

    return run


def measure_update_ms(trainer, i1: int = 4, i2: int = 20,
                      trials: int = 3) -> float:
    """Slope-fit the update phase in isolation: time two chained-update
    window sizes (``_update_chain``) and return the marginal per-update
    cost in ms (the two-window method). Floored at 0: a tiny update's
    window delta can sink under host jitter."""
    fns = {n: _update_chain(trainer, n) for n in (i1, i2)}

    def run(n) -> float:
        t0 = time.perf_counter()
        fns[n]()
        return time.perf_counter() - t0

    for n in fns:  # warm
        run(n)
    best = {n: float("inf") for n in fns}
    for _ in range(trials):
        for n in fns:
            best[n] = min(best[n], run(n))
    return max(0.0, (best[i2] - best[i1]) / (i2 - i1) * 1e3)


def _make_runner(shard: str, batch: int, hidden: int, warmup: int,
                 zero: bool, ndata: int, device=None):
    """-> (trainer, window(steps) -> (seconds, steps)) for one mode.

    Both modes run the identical per-step sync loop on the same
    ndata-wide data mesh (device_cache off so the step is the honest
    assemble + step path, like input_stall's sync baseline); only the
    update layout differs."""
    from ..config import parse_model_config
    from ..device import resolve_device
    from ..parallel import build_mesh
    from ..trainer import Trainer
    from .input_stall import _CONF

    cfg = parse_model_config(_CONF.format(shard=shard, batch=batch,
                                          hidden=hidden, head=10))
    cfg.zero_update = zero
    dev = resolve_device(device)
    mesh = build_mesh(ndata, 1, [dev] * ndata)
    trainer = Trainer(
        cfg, seed=0, log=lambda s: None, mesh=mesh,
        prefetch=False, device_cache=False,
    )
    assert trainer.update_mode == ("zero" if zero else "replicated")

    state = {"step": 0}

    def run(steps: int) -> None:
        step0 = state["step"]
        for s in range(step0, step0 + steps):
            trainer.train_one_batch(s)
        state["step"] = step0 + steps

    run(warmup)
    sync(dev)

    def window(steps: int) -> float:
        t0 = time.perf_counter()
        run(steps)
        sync(dev)
        return time.perf_counter() - t0

    return trainer, window


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="update_stall", description=__doc__)
    ap.add_argument("--steps", type=int, default=12, help="timed steps")
    ap.add_argument("--warmup", type=int, default=4, help="untimed steps")
    ap.add_argument(
        "--trials", type=int, default=3,
        help="windows per mode; the best (least-contended) one counts",
    )
    # the probe regime: a compute-representative step against which the
    # zero update's fixed per-step cost is the small share it is on
    # real models
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--records", type=int, default=8192,
                    help="synthetic dataset size")
    ap.add_argument("--ndata", type=int, default=2,
                    help="data-axis width (ranks sharing the device)")
    ap.add_argument(
        "--threshold", type=float, default=1.05,
        help="max allowed zero/replicated step-time ratio",
    )
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' must be asked "
                    "for)")
    args = ap.parse_args(argv)

    from ..data.loader import synthetic_arrays, write_records

    root = tempfile.mkdtemp(prefix="singa_tpu_torch_update_stall_")
    shard = os.path.join(root, "shard")
    write_records(shard, *synthetic_arrays(args.records, seed=0))
    runners = {
        mode: _make_runner(shard, args.batch, args.hidden, args.warmup,
                           mode == "zero", args.ndata, device=args.device)
        for mode in ("replicated", "zero")
    }
    # interleaved best-of-trials (ckpt/input_stall's methodology): one
    # window per mode per round so host-load bursts land on both modes
    best = {mode: float("inf") for mode in runners}
    for _ in range(args.trials):
        for mode, (_, window) in runners.items():
            best[mode] = min(best[mode], window(args.steps) / args.steps)
    repl_ms = best["replicated"] * 1e3
    zero_ms = best["zero"] * 1e3
    t_repl, _ = runners["replicated"]
    t_zero, _ = runners["zero"]
    ob_repl = t_repl.opt_state_bytes_per_device()
    ob_zero = t_zero.opt_state_bytes_per_device()
    shrank = args.ndata == 1 or ob_zero < ob_repl
    ok = zero_ms <= repl_ms * args.threshold and shrank
    out = {
        "replicated_step_ms": round(repl_ms, 3),
        "zero_step_ms": round(zero_ms, 3),
        "ratio": round(zero_ms / repl_ms, 3),
        "replicated_update_ms": round(measure_update_ms(t_repl), 3),
        "zero_update_ms": round(measure_update_ms(t_zero), 3),
        "opt_bytes_replicated": ob_repl,
        "opt_bytes_zero": ob_zero,
        "opt_bytes_ratio": round(ob_zero / ob_repl, 3) if ob_repl else None,
        "ndata": args.ndata,
        "threshold": args.threshold,
        "pass": ok,
    }
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
