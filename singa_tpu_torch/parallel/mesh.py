"""The mesh: rank -> torch device and rank -> coordinates on the five
axes, over one or more processes.

Counterpart of ``singa_tpu/parallel/mesh.py``. The JAX package maps the
reference's worker groups onto a device mesh whose axes are, outermost
first, ``FULL_AXES``: data, pipe, expert, seq and model (model
innermost). The port's mesh is the same grid on one controller: a
tuple that gives each of this process's ranks its device, and the
widths of the four axes inside a worker group. Rank r's coordinates
are r written row-major over ``FULL_AXES`` (``coords``), as the JAX
mesh lays its device array. A device may repeat: several ranks on one
card run the mesh on one GPU, as the JAX package's tests run theirs on
XLA's virtual host devices.

Under a ``torch.distributed`` process group of P processes
(``parallel/launch.py``) an n-wide axis is laid process-major, the
order in which the JAX global mesh lists its devices: rank r lives on
process r // (n / P), and ``devices`` holds this process's n / P ranks.
:meth:`Mesh.gather` hands every process every rank's tensors in rank
order; it is the one collective of the Trainer's reductions and of
synchronised BatchNorm. The data axis spans processes, and so does
every inner axis: for each of pipe, expert, seq and model a process
holds whole groups of the axis (the ranks that differ only in its
index), or a group spans whole processes. The layers' exchanges over a
group that spans processes (``parallel/axes.py``: ring attention's K/V,
kMoE's tokens and partial sums, the pipeline's stage hops,
kLayerPartition's Concate) cross them through :meth:`Mesh.gather_rows`
over a process group of those processes. A process that would hold
parts of two groups of one axis raises a ConfigError that names the
axis.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ..config.schema import ClusterConfig, ConfigError
from ..device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
#: the mesh's axes, outermost first: model innermost (its exchanges are
#: densest), then the seq ring, the expert exchange, the pipe hops, data
#: outermost (the JAX package's ``FULL_AXES``)
FULL_AXES = ("data", "pipe", "expert", "seq", "model")
#: the axes inside a worker group, in ``FULL_AXES`` order
INNER_AXES = FULL_AXES[1:]
#: the cluster conf field that carves each inner axis out of
#: ``nprocs_per_group`` (the model axis takes what the others leave)
CLUSTER_FIELDS = {"pipe": "npipes_per_group",
                  "expert": "nexperts_per_group",
                  "seq": "nseq_per_group", "model": "nprocs_per_group"}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices[i]`` is the device of this process's i-th rank, global
    rank ``proc * len(devices) + i`` of ``nprocs * len(devices)``;
    ``inner`` the widths of the pipe, expert, seq and model axes (all 1:
    the data axis alone)."""

    devices: tuple[torch.device, ...]
    nprocs: int = 1
    proc: int = 0
    inner: tuple[int, int, int, int] = (1, 1, 1, 1)

    @property
    def width(self) -> int:
        """Every rank of the mesh, on every process (on a data-only mesh
        the data axis's width)."""
        return len(self.devices) * self.nprocs

    @property
    def widths(self) -> dict[str, int]:
        """{axis: width} over ``FULL_AXES``."""
        group = 1
        for w in self.inner:
            group *= w
        return {DATA_AXIS: self.width // group,
                **dict(zip(INNER_AXES, self.inner))}

    @property
    def has_axes(self) -> bool:
        """A pipe, expert, seq or model width above 1."""
        return any(w > 1 for w in self.inner)

    @property
    def shape(self) -> dict[str, int]:
        """The JAX mesh's axis widths: the data axis alone on a
        data-only mesh, (data, model) when no pipe, expert or seq width
        is above 1, else all five."""
        w = self.widths
        if not self.has_axes:
            return {DATA_AXIS: self.width}
        if all(w[a] == 1 for a in ("pipe", "expert", "seq")):
            return {DATA_AXIS: w[DATA_AXIS], MODEL_AXIS: w[MODEL_AXIS]}
        return w

    def coords(self, r: int) -> dict[str, int]:
        """Global rank ``r``'s index on every axis (row-major over
        ``FULL_AXES``)."""
        out = {}
        for axis in reversed(FULL_AXES):
            w = self.widths[axis]
            out[axis] = r % w
            r //= w
        return {a: out[a] for a in FULL_AXES}

    def rank(self, **coords) -> int:
        """The global rank at ``coords`` (axes left out: index 0)."""
        r = 0
        for axis in FULL_AXES:
            r = r * self.widths[axis] + coords.get(axis, 0)
        return r

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

    def procs_of(self, ranks) -> tuple[int, ...]:
        """The processes that hold the global ``ranks``, in order."""
        k = len(self.devices)
        return tuple(sorted({r // k for r in ranks}))

    def gather_rows(self, row: torch.Tensor, procs: tuple[int, ...]
                    ) -> torch.Tensor:
        """Every process of ``procs``' ``row`` (one shape and dtype on
        each; this process among them), stacked in process order on
        ``row``'s device. The bytes travel as one flat uint8 row per
        process through one ``all_gather`` over those processes (on CPU
        rows under gloo), so the bits arrive unchanged."""
        import torch.distributed as dist

        flat = row.contiguous().reshape(-1).view(torch.uint8)
        wire = flat.cpu() if dist.get_backend() == "gloo" else flat
        parts = [torch.empty_like(wire) for _ in procs]
        dist.all_gather(parts, wire, group=_process_group(self, procs))
        return torch.stack(parts).to(row.device).view(row.dtype).reshape(
            len(procs), *row.shape)

    def group_of(self, r: int, axes) -> tuple[int, ...]:
        """The ranks that differ from rank ``r`` only in their indices
        on ``axes``, in rank order (row-major over ``axes``)."""
        c = self.coords(r)
        out = [c]
        for axis in FULL_AXES:
            if axis in axes:
                out = [{**o, axis: i} for o in out
                       for i in range(self.widths[axis])]
        return tuple(sorted(self.rank(**o) for o in out))

    def groups_over(self, axes) -> list[tuple[int, ...]]:
        """Every group over ``axes`` (:meth:`group_of`), ordered by its
        first rank."""
        out, seen = [], set()
        for r in range(self.width):
            if r not in seen:
                g = self.group_of(r, axes)
                seen.update(g)
                out.append(g)
        return out

    def spanning_groups(self, axes=(MODEL_AXIS,)) -> list[tuple[int, ...]]:
        """The processes of each group over ``axes`` (default: each
        model group) that spans more than one, in group order, each set
        once."""
        out = []
        for g in self.groups_over(axes):
            ps = self.procs_of(g)
            if len(ps) > 1 and ps not in out:
                out.append(ps)
        return out

    def gather(self, local: list, device) -> list:
        """Every rank's dict of tensors, in rank order, on ``device``.
        ``local`` holds this process's ranks' dicts (the same keys,
        shapes and dtypes on every rank); one process returns it as it
        is. Across processes each dtype's values travel as one flat row
        per rank through one ``gather_rows``, so the bits arrive
        unchanged."""
        if self.nprocs == 1:
            return list(local)
        t0 = time.perf_counter()
        # one key order on every process, whatever order its dicts hold
        keys = sorted(local[0], key=repr)
        out = [dict() for _ in range(self.width)]
        by_dtype: dict[torch.dtype, list] = {}
        for k in keys:
            by_dtype.setdefault(local[0][k].dtype, []).append(k)
        for ks in by_dtype.values():
            rows = torch.stack([
                torch.cat([d[k].to(device).reshape(-1)
                           for k in ks]) for d in local])
            flat = self.gather_rows(rows, tuple(range(self.nprocs))) \
                .reshape(self.width, -1)
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
#: the kLayerPartition exchanges' share: a spanning model group's
#: Concate and partial sums, forward and backward
LAYER_EXCHANGE = _Exchange()

#: the axis sets the layers' exchanges run over (``Lanes.exchange``):
#: kLayerPartition's model groups, the seq groups of ring attention and
#: kLMLoss, kMoE's expert groups, the data axis of its all-to-all
#: statistics and its routing groups, the pipeline's hops
EXCHANGE_AXES = (("model",), ("seq",), ("expert",), ("data",),
                 ("data", "seq"), ("pipe",))

#: (the world group's id, processes) -> their torch.distributed group
_GROUPS: dict = {}


def _process_group(mesh: Mesh, procs: tuple[int, ...]):
    """The process group of ``procs`` (None: every process, the default
    group). ``torch.distributed.new_group`` is collective over the
    world: at a process's first collective every process creates the
    group of every set of processes that a group over one of
    EXCHANGE_AXES spans (some but not all processes), in one sorted
    order, so their calls match whichever exchange comes first."""
    import torch.distributed as dist

    world = id(dist.group.WORLD)
    if (world, None) not in _GROUPS:
        sets = {ps for axes in EXCHANGE_AXES
                for ps in mesh.spanning_groups(axes)
                if len(ps) < mesh.nprocs}
        for ps in sorted(sets):
            _GROUPS[world, ps] = dist.new_group(list(ps))
        _GROUPS[world, None] = None
    if len(procs) == mesh.nprocs:
        return None
    return _GROUPS[world, procs]


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
    """A (data, model) mesh of ``ndata`` x ``nmodel`` ranks: the JAX
    package's ``build_mesh``, over :func:`build_full_mesh`."""
    return build_full_mesh({DATA_AXIS: ndata, MODEL_AXIS: nmodel}, devices)


def build_full_mesh(widths: dict[str, int], devices=None) -> Mesh:
    """A mesh over ``FULL_AXES`` (widths left out are 1). In one process
    its ranks take the first of ``devices`` (default: the visible GPUs);
    under a process group of P processes this process takes ranks
    [k·n/P, (k+1)·n/P) on the first n/P of ``devices`` (default: this
    process's card, once per rank). A group of any inner axis (the ranks
    that differ only in its index) may lie on one process or span whole
    processes; its parts then cross processes in the layers' exchanges.
    Raises when P does not divide the rank count, or when a process
    would hold parts of two groups of one axis (naming it)."""
    shape = [max(1, int(widths.get(a, 1))) for a in FULL_AXES]
    need = 1
    for w in shape:
        need *= w
    nprocs, proc = _processes()
    if nprocs > 1:
        if need % nprocs:
            what = (f"data axis width {need}" if need == shape[0]
                    else f"rank count {need}")
            raise ConfigError(
                f"{what} is not divisible by the process count {nprocs}: "
                "every process holds the same number of ranks"
            )
        local = need // nprocs
        layout = Mesh((None,) * local, nprocs, proc, tuple(shape[1:]))
        for axis, w in zip(INNER_AXES, shape[1:]):
            if any(len(ps) > 1 and len(g) != len(ps) * local
                   for g in layout.groups_over((axis,))
                   for ps in [layout.procs_of(g)]):
                raise ConfigError(
                    f"{axis} axis width {w} ({CLUSTER_FIELDS[axis]}) "
                    f"across {nprocs} processes of {local} ranks: a "
                    f"process would hold parts of two {axis} groups; "
                    f"singa_tpu_torch lays whole {axis} groups on a "
                    f"process or a {axis} group over whole processes"
                )
    local = need // nprocs
    if devices is None:
        if nprocs > 1:
            from .launch import process_device

            devices = [process_device()] * local
        else:
            devices = _visible_gpus()
    devices = list(devices)
    if local > len(devices):
        if shape[2:4] == [1, 1] and shape[1] == 1:
            want = f"{shape[0]}x{shape[4]}={need}"
        else:
            want = f"{dict(zip(FULL_AXES, shape))} = {need}"
        raise ConfigError(
            f"mesh wants {want} devices, only {len(devices)} visible"
            + (f" to process {proc} of {nprocs}" if nprocs > 1 else "")
        )
    return Mesh(tuple(_device(d) for d in devices[:local]), nprocs, proc,
                tuple(shape[1:]))


def mesh_from_cluster(cluster: ClusterConfig | None, devices=None) -> Mesh:
    """The cluster's topology -> the mesh over ``devices`` (default: the
    visible GPUs, or this process's card under a process group):
    ``ngroups`` worker groups on the data axis, ``nprocs_per_group``
    split into the pipe, expert, seq and model axes
    (``ClusterConfig.axis_widths``). With no cluster, or no
    ``nworkers``, every device is a data rank."""
    if cluster is None or not cluster.nworkers:
        devices = _visible_gpus() if devices is None else list(devices)
        return build_mesh(len(devices), 1, devices)
    return build_full_mesh(cluster.axis_widths, devices)
