"""Scaling sweep: the reference's batch.sh as a harness (the PyTorch
counterpart of ``singa_tpu/tools/sweep.py``: the same flags and row
keys).

batch.sh reruns a job over nworkers in {1,2,4,8,16}, rewriting
cluster.conf each time and logging to log1k/NwMsTt
(examples/mnist/batch.sh:3-17). Here each sweep point runs the job for a
fixed step count on an nworkers-rank data mesh and reports samples/sec
plus scaling efficiency vs the smallest point.

Each point runs in a fresh child process (as a multi-host run is one
process per host, like run.sh's ssh fan-out). The point's ranks all lie
on one device, the GPU or (``--device cpu``) the CPU, as the port's
mesh allows several ranks to share a device; ``--virtual`` is accepted
for the JAX tool's command lines and changes nothing here.

Usage:
  python -m singa_tpu_torch.tools.sweep --model_conf job.conf \
      [--workers 1 2 4 8] [--steps 30] [--device cpu] [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from .collective_stall import sync


def _child(model_conf: str, nworkers: int, steps: int,
           zero_update: bool = False, grad_comm: str = "",
           device=None) -> None:
    """Run `steps` training steps on an nworkers-wide data mesh; print one
    JSON line. Runs inside the sweep's child process."""
    from ..config import load_model_config
    from ..device import resolve_device
    from ..parallel import build_mesh
    from ..trainer import make_trainer

    cfg = load_model_config(model_conf)
    cfg.train_steps = steps
    cfg.test_steps = cfg.validation_steps = 0
    cfg.display_frequency = 0
    cfg.checkpoint_frequency = 0
    if zero_update:
        cfg.zero_update = True
    if grad_comm:
        from ..parallel import apply_grad_comm_tag

        apply_grad_comm_tag(cfg, grad_comm)
    dev = resolve_device(device)
    mesh = build_mesh(nworkers, 1, [dev] * nworkers)
    trainer = make_trainer(cfg, None, mesh=mesh, log=lambda s: None)
    warmup = min(3, steps - 1)
    for step in range(warmup):
        trainer.train_one_batch(step)
    sync(dev)
    t0 = time.perf_counter()
    for step in range(warmup, steps):
        trainer.train_one_batch(step)
    sync(dev)
    dt = time.perf_counter() - t0
    print(json.dumps({
        "nworkers": nworkers,
        "batch": trainer.train_net.batchsize,
        "samples_per_sec": (steps - warmup) * trainer.train_net.batchsize / dt,
        # which input path and update layout fed the point (bench.py's
        # feeder/update_mode row fields) — a scaling knee stays
        # attributable to the data path or the update sharding
        "feeder": trainer.feeder_mode,
        "update_mode": trainer.update_mode,
        "opt_state_bytes_per_device": trainer.opt_state_bytes_per_device(),
        # how gradients crossed the data axis at this point (exact /
        # quantized + wire dtype) and the machinery's isolated marginal
        # ms — a scaling knee stays attributable to the collective
        "comm_mode": trainer.comm_mode,
        "comm_dtype": trainer.comm_dtype,
        "comm_ms": round(_comm_ms(trainer), 3),
    }))


def _comm_ms(trainer) -> float:
    from .collective_stall import measure_comm_ms

    return measure_comm_ms(trainer, i1=2, i2=6, trials=1)


def _child_env() -> dict:
    """The children's environment: this package importable from any
    working directory."""
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    return env


def run_sweep(
    model_conf: str,
    workers: list[int],
    steps: int,
    virtual: bool,
    zero_update: bool = False,
    grad_comm: str = "",
    device: str | None = None,
) -> list[dict]:
    del virtual  # the ranks share one device either way
    results = []
    for nw in workers:
        proc = subprocess.run(
            [sys.executable, "-m", "singa_tpu_torch.tools.sweep",
             "--_child", "--model_conf", model_conf, "--nworkers", str(nw),
             "--steps", str(steps)]
            + (["--zero_update"] if zero_update else [])
            + (["--grad_comm", grad_comm] if grad_comm else [])
            + (["--device", device] if device else []),
            env=_child_env(), capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"sweep point nworkers={nw} failed:\n{proc.stderr[-2000:]}"
            )
        line = proc.stdout.strip().splitlines()[-1]
        results.append(json.loads(line))
    base = results[0]
    for r in results:
        ideal = base["samples_per_sec"] * r["nworkers"] / base["nworkers"]
        r["efficiency"] = r["samples_per_sec"] / ideal
    return results


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="singa_tpu_torch.tools.sweep")
    ap.add_argument("--model_conf", required=True)
    ap.add_argument("--workers", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--virtual", action="store_true",
                    help="accepted for the JAX tool's command lines: the "
                    "port's ranks share one device either way")
    ap.add_argument("--device", default=None,
                    help="torch device of every rank (default cuda; 'cpu' "
                    "must be asked for)")
    ap.add_argument("--zero_update", action="store_true",
                    help="sweep with the ZeRO update sharding "
                    "(zero_update: true) — opt-state bytes per device "
                    "should FALL as nworkers grows")
    ap.add_argument("--grad_comm", default="",
                    choices=("", "exact", "q8", "q8wire", "bf16"),
                    help="sweep with a grad_comm block (q8 = quantized "
                    "int8 + error feedback; bf16 = quantized bf16) — "
                    "the quantized wire format should HOLD efficiency "
                    "as the data axis widens")
    ap.add_argument("--json", default=None, help="also write results here")
    ap.add_argument("--_child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--nworkers", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args._child:
        _child(args.model_conf, args.nworkers, args.steps,
               zero_update=args.zero_update, grad_comm=args.grad_comm,
               device=args.device)
        return 0

    results = run_sweep(args.model_conf, args.workers, args.steps,
                        args.virtual, zero_update=args.zero_update,
                        grad_comm=args.grad_comm, device=args.device)
    print(
        f"{'nworkers':>8} {'batch':>6} {'samples/s':>12} {'efficiency':>10} "
        f"{'update':>10} {'opt-B/dev':>10} {'comm':>14} {'comm-ms':>8}"
    )
    for r in results:
        comm = r["comm_mode"] + (f":{r['comm_dtype']}" if r["comm_dtype"]
                                 else "")
        print(
            f"{r['nworkers']:>8} {r['batch']:>6} "
            f"{r['samples_per_sec']:>12.0f} {r['efficiency']:>10.2f} "
            f"{r['update_mode']:>10} {r['opt_state_bytes_per_device']:>10} "
            f"{comm:>14} {r['comm_ms']:>8.3f}"
        )
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
