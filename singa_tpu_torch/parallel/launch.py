"""Multi-process bootstrap: the reference's process identity on
``torch.distributed``.

Counterpart of ``singa_tpu/parallel/launch.py``. The reference assigns
roles from ``-procsID`` and a hostfile (one address per line, comments
allowed; src/utils/cluster.cc:18-24) and hand-shakes every process
through its router. Here line 0 of the hostfile hosts the rendezvous
(a ``torch.distributed`` TCP store), every process joins with its
``-procsID`` as its rank, and the data axis's ranks are laid over the
processes process-major (``parallel/mesh.py``): what crosses processes
afterwards is the ring's point-to-point exchange and the Trainer's
gathers, through the process group.

The backend is gloo, unless every process owns a distinct CUDA device
(a CUDA job with no more processes on this host than visible cards),
which takes NCCL. Gloo moves CPU tensors, so on the card the bytes a
process exchanges go through host copies. Every process is given the
group's ``timeout``: a peer that never joins, or dies mid-collective,
ends the job with an error instead of a hang.

The JAX package's pod branch (a TPU runtime's injected coordinator) has
a torchrun-style counterpart: with no hostfile, ``MASTER_ADDR``,
``WORLD_SIZE`` and ``RANK`` in the environment (and ``WORLD_SIZE``
above 1) start the group from the environment.
"""

from __future__ import annotations

import datetime
import os
import sys

import torch

DEFAULT_PORT = 9999  # arbitrary; the reference's start_port plays this role
#: the process group's timeout: a rendezvous or collective that waits
#: longer on a peer raises
DEFAULT_TIMEOUT_S = 300.0


class RendezvousError(RuntimeError):
    """A process group that could not be formed: a peer did not join
    within the timeout, or the rendezvous address was unusable."""


def read_hostfile(path: str) -> list[str]:
    """Hostfile -> ordered address list (cluster.cc:18-24 semantics:
    one host per line, blank lines and #-comments skipped, order is
    process rank order)."""
    hosts: list[str] = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                hosts.append(line)
    return hosts


def coordinator_address(hosts: list[str], port: int = DEFAULT_PORT) -> str:
    """Line 0 hosts the rendezvous, like the reference's server-0 router
    bind (router.cc:46-86). A host may carry its own ``:port``."""
    if not hosts:
        raise ValueError("empty hostfile")
    head = hosts[0]
    return head if ":" in head else f"{head}:{port}"


def _host(line: str) -> str:
    return line.rsplit(":", 1)[0] if ":" in line else line


def choose_backend(hosts: list[str], procs_id: int, device=None
                   ) -> tuple[str, torch.device]:
    """-> (backend, this process's device). ``device`` None is the GPU.
    NCCL when the device is CUDA and this host's processes (the
    hostfile's lines naming its host) fit its visible cards, each taking
    its own, in hostfile order; else gloo on ``device`` (several
    processes may then share a card)."""
    from ..device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return "gloo", dev
    mine = _host(hosts[procs_id])
    same = [k for k, h in enumerate(hosts) if _host(h) == mine]
    if len(same) > torch.cuda.device_count():
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return "gloo", dev
    return "nccl", torch.device("cuda", same.index(procs_id))


def _start(backend: str, timeout: float, **kw) -> None:
    import torch.distributed as dist

    try:
        dist.init_process_group(
            backend, timeout=datetime.timedelta(seconds=timeout), **kw)
    except (dist.DistError, RuntimeError) as e:
        where = kw.get("init_method", "env://")
        raise RendezvousError(
            f"process {kw.get('rank', os.environ.get('RANK'))} of "
            f"{kw.get('world_size', os.environ.get('WORLD_SIZE'))}: no "
            f"process group at {where} within {timeout:g} s ({e})"
        ) from e


def init_distributed(
    procs_id: int | None = None,
    hostfile: str | None = None,
    *,
    port: int = DEFAULT_PORT,
    device=None,
    timeout: float = DEFAULT_TIMEOUT_S,
    log=print,
) -> bool:
    """Start the process group of a multi-process run; returns whether
    one was started.

    1. No hostfile and no torchrun-style environment, or a hostfile of
       one line -> one process, a no-op.
    2. No hostfile, ``MASTER_ADDR``/``WORLD_SIZE``/``RANK`` set with a
       world above 1 -> the group from the environment.
    3. Hostfile + ``procs_id`` -> the rendezvous at line 0, a world of
       the hostfile's lines, rank ``procs_id`` (main.cc:13-18).

    ``device`` is where this process's ranks run (None: the GPU); it
    picks the backend (:func:`choose_backend`), which is logged. A CUDA
    process under NCCL makes its own card the current device."""
    import torch.distributed as dist

    if hostfile is None:
        world = int(os.environ.get("WORLD_SIZE", "1") or 1)
        if not all(v in os.environ for v in ("MASTER_ADDR", "RANK")) \
                or world <= 1:
            return False
        rank = int(os.environ["RANK"])
        hosts = [os.environ["MASTER_ADDR"]] * world
        backend, dev = choose_backend(hosts, rank, device)
        _start(backend, timeout)
    else:
        hosts = read_hostfile(hostfile)
        if len(hosts) <= 1:
            return False
        if procs_id is None or not 0 <= procs_id < len(hosts):
            raise ValueError(
                f"procs_id {procs_id!r} out of range for {len(hosts)} hosts"
            )
        backend, dev = choose_backend(hosts, procs_id, device)
        _start(backend, timeout,
               init_method=f"tcp://{coordinator_address(hosts, port)}",
               world_size=len(hosts), rank=procs_id)
    if backend == "nccl":
        torch.cuda.set_device(dev)
    log(f"process {dist.get_rank()} of {dist.get_world_size()}: backend "
        f"{backend}, device {dev}")
    sys.stdout.flush()
    return True


def process_device(device=None) -> torch.device:
    """This process's device for its ranks: under a process group and
    NCCL its own card (the current CUDA device), else ``device``
    resolved (None: the GPU)."""
    from ..device import resolve_device

    if backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def backend() -> str:
    """The process group's backend, "" with none."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return str(dist.get_backend())
    return ""


def shutdown() -> None:
    """Destroy the process group (and the model groups' subgroups), if
    one is up."""
    import torch.distributed as dist

    from .mesh import _GROUPS

    _GROUPS.clear()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
