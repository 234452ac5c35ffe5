"""Elastic gang launcher: relaunch resumable gangs under a restart
budget, optionally at a different process count (the PyTorch
counterpart of ``singa_tpu/tools/elastic_launch.py``, on the port's
``resilience/launcher.py``).

Usage:
  python -m singa_tpu_torch.tools.elastic_launch \\
      -model_conf job.conf -cluster_conf cluster.conf -nprocs 2 \\
      [-device cpu]

Spawns ``-nprocs`` ranks of ``python -m singa_tpu_torch.main`` (a generated
localhost hostfile carries the rendezvous, the reference's run.sh
fan-out shape), waits for the gang, and:

  - every rank 0            -> done (exit 0)
  - every non-zero rank 75  -> the gang drained (preemption) or a rank
                               died and its peers' watchdogs followed —
                               RELAUNCH the whole gang from the newest
                               committed checkpoint, while the
                               ``resilience { max_restarts_per_window,
                               restart_window_s }`` budget grants
                               (resilience/launcher.py); the in-process
                               circuit breaker never sees these exits,
                               which is exactly why the launcher needs
                               its own budget
  - any other status        -> fatal; surface it, never replay it

``-resize_after N`` relaunches at a different nprocs once N resumable
exits have happened — the elastic drill: the reshard-on-restore path
(resilience/reshard.py) re-slices the drained checkpoint onto the new
world size, so shrinking a preempted 8-host gang to whatever capacity
is left is one flag, not a migration project.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys

from ..config import load_model_config
from ..resilience.launcher import RestartBudget, supervise_gang


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_hostfile(workdir: str, nprocs: int) -> str:
    path = os.path.join(workdir, f"hostfile_{os.getpid()}")
    with open(path, "w") as f:
        f.write(f"127.0.0.1:{_free_port()}\n")
        f.write("127.0.0.1\n" * (nprocs - 1))
    return path


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="singa_tpu_torch.tools.elastic_launch", description=__doc__
    )
    ap.add_argument("-model_conf", required=True)
    ap.add_argument("-cluster_conf", default=None)
    ap.add_argument("-nprocs", type=int, default=1)
    ap.add_argument(
        "-resize_to", type=int, default=0,
        help="relaunch at this nprocs instead (0 = keep -nprocs)",
    )
    ap.add_argument(
        "-resize_after", type=int, default=1,
        help="resumable exits before -resize_to takes effect",
    )
    ap.add_argument("-seed", type=int, default=0)
    ap.add_argument("-faults", default=None,
                    help="fault plan forwarded to EVERY rank")
    ap.add_argument("-device", default=None,
                    help="forwarded to every rank (default: the GPU; "
                    "'cpu' must be asked for)")
    return ap.parse_args(argv)


def run_gang_once(args, nprocs: int, *, log=print) -> list[int]:
    """One gang attempt: spawn nprocs ranks, wait, return exit codes."""
    workdir = os.path.dirname(os.path.abspath(args.model_conf)) or "."
    hostfile = _write_hostfile(workdir, nprocs) if nprocs > 1 else None
    procs = []
    for rank in range(nprocs):
        argv = [
            sys.executable, "-m", "singa_tpu_torch.main",
            "-model_conf", args.model_conf,
            "-procsID", str(rank),
            "-seed", str(args.seed),
        ]
        if args.cluster_conf:
            argv += ["-cluster_conf", args.cluster_conf]
        if hostfile:
            argv += ["-hostfile", hostfile]
        if args.faults:
            argv += ["-faults", args.faults]
        if args.device:
            argv += ["-device", args.device]
        procs.append(subprocess.Popen(argv))
    codes = [p.wait() for p in procs]
    if hostfile:
        try:
            os.unlink(hostfile)
        except OSError:
            pass
    log(f"launcher: gang of {nprocs} exited {codes}")
    return codes


def main(argv=None) -> int:
    args = parse_args(argv)
    model_cfg = load_model_config(args.model_conf)
    budget = RestartBudget.from_config(
        getattr(model_cfg, "resilience", None)
    )
    state = {"nprocs": max(1, args.nprocs), "resumes": 0}

    def run_gang():
        return run_gang_once(args, state["nprocs"])

    def on_relaunch(attempt):
        del attempt
        state["resumes"] += 1
        if args.resize_to and state["resumes"] >= args.resize_after:
            if state["nprocs"] != args.resize_to:
                print(
                    f"launcher: resizing gang {state['nprocs']} -> "
                    f"{args.resize_to} ranks (elastic restore reshards "
                    "the drained checkpoint)"
                )
            state["nprocs"] = max(1, args.resize_to)

    return supervise_gang(
        run_gang, budget, log=print, on_relaunch=on_relaunch
    )


if __name__ == "__main__":
    sys.exit(main())
