"""CLI entry point: ``python -m singa_tpu_torch.main -model_conf F
[-cluster_conf F] [-seed N] [-device cpu] [-procsID K] [-hostfile F]
[-faults PLAN]``.

Counterpart of ``singa_tpu/main.py`` for training: it reads the job
conf, builds its engine with :func:`make_trainer` (the CDTrainer for alg
kContrastiveDivergence, the ReplicaTrainer for a cluster with
``nservers`` that is not ``synchronous``, such as
examples/mnist/cluster_elastic.conf, else the Trainer) and runs it.
The cluster conf gives the workspace (where checkpoints go) and the
data-parallel width: ``nworkers`` worker groups become ranks over the
visible GPUs, or over the one ``-device`` named, repeated (``-device
cpu``: that many CPU ranks). The trainer runs on the GPU unless
``-device cpu`` is given.

Every training job runs under the resilience supervisor
(``resilience/supervisor.py``), as ``singa_tpu.main``'s do: a job with a
``resilience { ... }`` block (examples/mnist/mlp_resilient.conf,
mlp_async.conf) gets supervised auto-resume from the newest complete
checkpoint, SIGTERM/SIGINT drain with the resumable exit status (75),
the divergence guard inside the step, asynchronous checkpoints, keep-
last-N retention and the step watchdog; a job with neither the block
nor a fault plan takes the supervisor's transparent single-attempt
path. ``-faults`` (or ``SINGA_TPU_FAULTS``) arms a deterministic fault
plan, the training kinds (``crash@7,sigterm@12,nanloss@5``,
``corrupt_ckpt@1``, ``async_torn_write@1``, ``slowstep@9=2``,
``profile@20:steps=5``) as well as the fleet's. Telemetry is on for
jobs with a workspace: each process appends lifecycle events and phase
spans to ``<workspace>/events/rank_k.jsonl`` (flushed at display
cadence; the step path gains no write and no device sync), unless the
``telemetry { enabled: false }`` block turns it off.

A cluster's ``nprocs_per_group`` above 1 splits each worker group over
the model axis (kLayerPartition) or the axes its ``nseq_per_group``,
``nexperts_per_group`` and ``npipes_per_group`` carve out; with
``nservers`` on an asynchronous cluster each replica of the replica
engine is then a lane of model ranks.

A hostfile of more than one line makes the job one process per line
(``parallel/launch.py``): each process is started with its own
``-procsID k`` and the same ``-hostfile``, line 0 hosts the rendezvous,
and the cluster's ``nworkers`` ranks are laid over the processes
(``nworkers`` / processes each; a process may hold whole model groups,
never part of one). Only training confs start a process
group. Every process of a multi-process job prints one ``TRAIN
PROCESS: {json}`` line at its clean end (its index, the backend, its
device, the quant_acc launches and ring bytes of its ranks, its host
seconds in cross-process exchanges, the share of those three that the
Trainer's one-shot comm probe added (``comm_probe``), the host seconds
of its run and of its steps since its last display line, and the digest
of its params and slots, ``Trainer.digest``); a process that fails, or drains with status
75, leaves with its exit code at once, without waiting on its peers (a
crash in one process of several is not restarted in place: the process
exits 75, for a launcher to relaunch every process from the newest
complete checkpoint, as in the JAX package).

A ``fleet { ... }`` block makes this process a serving-fleet host
instead (``serve/fleet/host.run_from_conf``), as ``singa_tpu.main``
does: ``-procsID`` picks its prefill/decode/unified role, hosts share
only the conf's transport (a filesystem mailbox under
``<workspace>/fleet``, or sockets), a SIGTERM drains its in-flight
sequences to a peer and exits 75, and ``-faults`` arms the wire and
rollout fault terms (``wire_drop@K``, ``torn_weights@K``, ...). The
engine runs on the GPU unless ``-device cpu`` is given.

The LM confs (examples/lm/) and the image nets' (examples/mnist/mlp.conf,
conv.conf, autoencoder.conf, rbm.conf, examples/cifar10/alexnet.conf,
examples/imagenet/resnet50.conf) run as written once their shards
exist: ``python -m singa_tpu_torch.data.loader synthetic --output DIR``
makes MNIST-shaped ones (``--channels 3 --size 32`` CIFAR-shaped;
``imagenet-shaped`` 3 x 256 x 256 over 1000 classes), and
``compute-mean`` the mean file kRGBImage reads.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

from .config import load_cluster_config, load_model_config
from .parallel.launch import backend, init_distributed, shutdown
from .trainer import make_trainer


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="singa_tpu_torch", description=__doc__, add_help=True
    )
    ap.add_argument("-model_conf", required=True, help="ModelProto text file")
    ap.add_argument("-cluster_conf", default=None,
                    help="ClusterProto text file (its workspace holds the "
                    "checkpoints; nworkers sets the data-parallel width)")
    ap.add_argument("-seed", type=int, default=0, help="init RNG seed")
    ap.add_argument("-device", default=None,
                    help="torch device; default cuda (raises without a GPU)")
    ap.add_argument("-procsID", type=int, default=0,
                    help="process rank: a training process's rank among "
                    "the hostfile's processes, or a fleet host's role")
    ap.add_argument("-hostfile", default=None,
                    help="one host per line (#-comments allowed); line 0 "
                    "hosts the rendezvous, a line may carry :port; more "
                    "than one line makes a multi-process training job")
    ap.add_argument("-faults", default=os.environ.get("SINGA_TPU_FAULTS"),
                    help="deterministic fault plan, e.g. 'crash@7,sigterm@12',"
                    " 'nanloss@5', a 'profile@20:steps=5' torch.profiler "
                    "trigger, or a fleet host's 'wire_drop@3' "
                    "(resilience/faults.py grammar; also via "
                    "SINGA_TPU_FAULTS)")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    model_cfg = load_model_config(args.model_conf)
    cluster_cfg = (
        load_cluster_config(args.cluster_conf) if args.cluster_conf else None
    )
    if model_cfg.fleet is not None:
        from .serve.fleet.host import run_from_conf

        return run_from_conf(
            model_cfg, cluster_cfg, procs_id=args.procsID, seed=args.seed,
            faults=args.faults, device=args.device,
        )
    from .resilience import supervisor

    if not init_distributed(args.procsID, args.hostfile, device=args.device):
        return supervisor.run(model_cfg, cluster_cfg, seed=args.seed,
                              faults=args.faults, device=args.device)
    built = [0.0]

    def factory(*a, **kw):
        trainer = make_trainer(*a, **kw)
        built[0] = time.perf_counter()
        return trainer

    def report(trainer) -> None:
        out = process_report(trainer)
        out["run_s"] = time.perf_counter() - built[0]
        # one write, its newline included: the processes of a gang may
        # share one stdout, unbuffered, where print's two writes let a
        # peer's line land between the report and its newline
        sys.stdout.write("TRAIN PROCESS: " + json.dumps(out) + "\n")
        sys.stdout.flush()

    try:
        rc = supervisor.run(model_cfg, cluster_cfg, seed=args.seed,
                            faults=args.faults, device=args.device,
                            trainer_factory=factory, on_complete=report)
    except BaseException:
        traceback.print_exc()
        rc = 1
    if rc != 0:
        # a peer blocked in a collective (or draining in parallel) would
        # hold this process at exit (the process group's shutdown); leave
        # with the status now
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(rc)
    shutdown()
    return 0


def process_report(trainer) -> dict:
    """What one process of a multi-process job reports at its end."""
    from .ops import attention as ta
    from .ops import quantized_collective as qc
    from .parallel.mesh import EXCHANGE, LAYER_EXCHANGE

    mesh = trainer.mesh
    return {
        "proc": mesh.proc, "nprocs": mesh.nprocs, "backend": backend(),
        "device": str(trainer.device), "ranks": list(mesh.local_ranks),
        "quant_acc_launches": qc.quant_acc.launches,
        "flash_launches": {n: getattr(ta, n).launches
                           for names in ta.KERNEL_NAMES.values()
                           for n in names},
        "ring_sent_bytes": sum(qc.ppermute.sent_bytes.values()),
        "exchange_s": EXCHANGE.seconds,
        # a spanning model group's layer exchanges, forward and backward
        "layer_exchange_s": LAYER_EXCHANGE.seconds,
        # what the one-shot comm probe added to the three counters above
        "comm_probe": dict(trainer.comm_probe_counts),
        "steps": trainer.completed_steps - trainer.start_step,
        # the data and train phases since the last display line
        "steps_s": trainer.timers.total("data") + trainer.timers.total(
            "train"),
        "digest": trainer.digest(),
        # the guard's counters ({} unguarded) and the context's rollbacks
        "guard": trainer.guard_counters(),
        "rollbacks": getattr(trainer.resilience, "rollbacks", 0),
    }


if __name__ == "__main__":
    sys.exit(main())
