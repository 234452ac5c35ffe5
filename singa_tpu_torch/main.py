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
cpu``: that many CPU ranks). A parallel axis other than the data axis
raises, as do the resilience supervisor and the other knobs the
trainer lists. The trainer runs on the GPU unless ``-device cpu`` is
given.

A hostfile of more than one line makes the job one process per line
(``parallel/launch.py``): each process is started with its own
``-procsID k`` and the same ``-hostfile``, line 0 hosts the rendezvous,
and the cluster's ``nworkers`` ranks are laid over the processes
(``nworkers`` / processes each). Only training confs start a process
group. Every process of a multi-process job prints one ``TRAIN
PROCESS: {json}`` line at its clean end (its index, the backend, its
device, the quant_acc launches and ring bytes of its ranks, its host
seconds in cross-process exchanges, the host seconds of its run and of
its steps since its last display line, and the digest of its params and
slots, ``Trainer.digest``); a process that fails leaves with its exit
code at once, without waiting on its peers.

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
                    help="fault plan for a fleet host, e.g. 'wire_drop@3' "
                    "or 'torn_weights@1' (resilience/faults.py grammar; "
                    "also via SINGA_TPU_FAULTS)")
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
    if not init_distributed(args.procsID, args.hostfile, device=args.device):
        make_trainer(model_cfg, cluster_cfg, seed=args.seed,
                     device=args.device).run()
        return 0
    try:
        trainer = make_trainer(model_cfg, cluster_cfg, seed=args.seed,
                               device=args.device)
        t0 = time.perf_counter()
        trainer.run()
        report = process_report(trainer)
        report["run_s"] = time.perf_counter() - t0
        print("TRAIN PROCESS: " + json.dumps(report), flush=True)
    except BaseException:
        # a peer blocked in a collective would hold this process at exit
        # (the process group's shutdown); leave with the status now
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    shutdown()
    return 0


def process_report(trainer) -> dict:
    """What one process of a multi-process job reports at its end."""
    from .ops import quantized_collective as qc
    from .parallel.mesh import EXCHANGE

    mesh = trainer.mesh
    return {
        "proc": mesh.proc, "nprocs": mesh.nprocs, "backend": backend(),
        "device": str(trainer.device), "ranks": list(mesh.local_ranks),
        "quant_acc_launches": qc.quant_acc.launches,
        "ring_sent_bytes": sum(qc.ppermute.sent_bytes.values()),
        "exchange_s": EXCHANGE.seconds,
        "steps": trainer.completed_steps - trainer.start_step,
        # the data and train phases since the last display line
        "steps_s": trainer.timers.total("data") + trainer.timers.total(
            "train"),
        "digest": trainer.digest(),
    }


if __name__ == "__main__":
    sys.exit(main())
