"""The data-parallel mesh: rank -> torch device, over one or more
processes.

Counterpart of ``singa_tpu/parallel/mesh.py``, data axis only. The JAX
package maps the reference's worker groups onto a (data, model) device
mesh; the port's mesh is the data axis alone, a tuple that gives each
of this process's ranks its device. A device may repeat: several ranks
on one card run an n-wide data axis on one GPU, as the JAX package's
tests run one on XLA's virtual host devices. A model, seq, expert or
pipe width above 1 raises a ConfigError that names it.

Under a ``torch.distributed`` process group of P processes
(``parallel/launch.py``) an n-wide axis is laid process-major, the
order in which the JAX global mesh lists its devices: rank r lives on
process r // (n / P), and ``devices`` holds this process's n / P ranks.
:meth:`Mesh.gather` hands every process every rank's tensors in rank
order; it is the one collective of the Trainer's reductions and of
synchronised BatchNorm.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ..config.schema import ClusterConfig, ConfigError
from ..device import resolve_device

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices[i]`` is the device of this process's i-th rank, global
    rank ``proc * len(devices) + i`` of ``nprocs * len(devices)``."""

    devices: tuple[torch.device, ...]
    nprocs: int = 1
    proc: int = 0

    @property
    def width(self) -> int:
        """The data axis's width: every process's ranks."""
        return len(self.devices) * self.nprocs

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.width}

    @property
    def local_ranks(self) -> range:
        """This process's global ranks, in order."""
        k = len(self.devices)
        return range(self.proc * k, (self.proc + 1) * k)

    def device(self, r: int) -> torch.device:
        """The device of this process's global rank ``r``."""
        return self.devices[r - self.proc * len(self.devices)]

    def is_local(self, r: int) -> bool:
        return r in self.local_ranks

    def gather(self, local: list, device) -> list:
        """Every rank's dict of tensors, in rank order, on ``device``.
        ``local`` holds this process's ranks' dicts (the same keys,
        shapes and dtypes on every rank); one process returns it as it
        is. Across processes each dtype's values travel as one flat row
        per rank through one ``all_gather`` (on CPU rows under gloo),
        so the bits arrive unchanged."""
        if self.nprocs == 1:
            return list(local)
        import torch.distributed as dist

        t0 = time.perf_counter()
        keys = list(local[0])
        out = [dict() for _ in range(self.width)]
        by_dtype: dict[torch.dtype, list] = {}
        for k in keys:
            by_dtype.setdefault(local[0][k].dtype, []).append(k)
        host = dist.get_backend() == "gloo"
        for dtype, ks in by_dtype.items():
            rows = torch.stack([
                torch.cat([d[k].to(device).reshape(-1)
                           for k in ks]) for d in local])
            wire = rows.cpu() if host else rows
            parts = [torch.empty_like(wire) for _ in range(self.nprocs)]
            dist.all_gather(parts, wire)
            flat = torch.cat(parts).to(device)
            for r in range(self.width):
                o = 0
                for k in ks:
                    like = local[0][k]
                    size = like.numel()
                    out[r][k] = flat[r, o:o + size].reshape(like.shape)
                    o += size
        EXCHANGE.add(t0)
        return out


class _Exchange:
    """Host seconds spent in cross-process exchanges (the gathers and
    the ring's point-to-point calls), host copies and waits on peers
    included; read by the multi-process report."""

    def __init__(self):
        self.seconds = 0.0

    def add(self, t0: float) -> None:
        self.seconds += time.perf_counter() - t0


EXCHANGE = _Exchange()


def _visible_gpus() -> list[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _device(d) -> torch.device:
    """A torch device with its index filled in, so that two ranks on one
    card compare equal however they were named."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _processes() -> tuple[int, int]:
    """(process count, this process's index) of the live process group,
    (1, 0) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def build_mesh(ndata: int = 1, nmodel: int = 1, devices=None) -> Mesh:
    """A mesh of ``ndata`` ranks. In one process they take the first
    ``ndata`` of ``devices`` (default: the visible GPUs); under a
    process group of P processes this process takes ranks [k·ndata/P,
    (k+1)·ndata/P) on the first ndata/P of ``devices`` (default: this
    process's card, once per rank). ``nmodel`` above 1 raises: the model
    axis is not ported; so does an ``ndata`` that P does not divide."""
    if nmodel > 1:
        raise ConfigError(
            f"model axis width {nmodel}: singa_tpu_torch ports the data "
            "axis only"
        )
    nprocs, proc = _processes()
    if ndata % nprocs:
        raise ConfigError(
            f"data axis width {ndata} is not divisible by the process "
            f"count {nprocs}: every process holds the same number of ranks"
        )
    local = ndata // nprocs
    if devices is None:
        if nprocs > 1:
            from .launch import process_device

            devices = [process_device()] * local
        else:
            devices = _visible_gpus()
    devices = list(devices)
    if local > len(devices):
        raise ConfigError(
            f"mesh wants {ndata}x{nmodel}={ndata * nmodel} devices, "
            f"only {len(devices)} visible"
            + (f" to process {proc} of {nprocs}" if nprocs > 1 else "")
        )
    return Mesh(tuple(_device(d) for d in devices[:local]), nprocs, proc)


def mesh_from_cluster(cluster: ClusterConfig | None, devices=None) -> Mesh:
    """The cluster's worker groups -> data-axis ranks over ``devices``
    (default: the visible GPUs, or this process's card under a process
    group). With no cluster, or no ``nworkers``, every device is a rank.
    A seq, expert, pipe or model width above 1 raises, naming the
    axis."""
    if cluster is None or not cluster.nworkers:
        devices = _visible_gpus() if devices is None else list(devices)
        return build_mesh(len(devices), 1, devices)
    widths = cluster.axis_widths
    for axis in ("seq", "expert", "pipe"):
        if widths[axis] > 1:
            raise ConfigError(
                f"{axis} axis width {widths[axis]}: singa_tpu_torch ports "
                "the data axis only"
            )
    return build_mesh(widths["data"], widths["model"], devices)
