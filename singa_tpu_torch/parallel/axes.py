"""Lanes: the ranks one lockstep walk of a net runs, and the exchanges
between them.

The JAX package runs one program over its device mesh: GSPMD and
``shard_map`` move activations between devices (ring attention's K/V
``ppermute``, kMoE's ``psum`` and ``all_to_all``, kLayerPartition's
Slice/Concate, the pipeline's stage hops). The port runs the mesh on one
controller per process: ``Net`` walks the layers once for every rank of
the process in lockstep, a lane per rank, and a layer whose work crosses
ranks takes every lane's input in one call (``Layer.apply_ranks``).
Most such layers read the other ranks' tensors directly, and autograd
carries the gradients back along the same reads.

kLayerPartition's Concate and partial sums go through one exchange
instead, :meth:`Lanes.exchange` (``GroupExchange``), because a model
group may span processes: its forward hands every consumer the group's
parts in rank order (the parts of other processes through one
collective), and its backward sums each part's gradients over the
consumers in rank order and hands the sum back to the part's owner.
One process runs the same exchange over its own lanes, so P processes
and one add every gradient in the same order.

Every cross-rank sum here runs in rank order, so two runs of the port
give the same bits.
"""
from __future__ import annotations

import dataclasses
import functools
import time

import torch
from torch.autograd.function import once_differentiable

from .mesh import FULL_AXES, LAYER_EXCHANGE, MODEL_AXIS, Mesh


@dataclasses.dataclass(frozen=True)
class Lanes:
    """The lanes of one walk: ``ranks[j]`` is lane j's global rank on
    ``mesh``."""

    mesh: Mesh
    ranks: tuple[int, ...]

    def coords(self, j: int) -> dict[str, int]:
        return self.mesh.coords(self.ranks[j])

    def groups(self, *axes: str) -> list[list[int]]:
        """Lane indices grouped by every coordinate but those on
        ``axes``; each group is ordered row-major over ``axes`` (in
        ``FULL_AXES`` order), the groups by their first lane."""
        order = [a for a in FULL_AXES if a in axes]
        by: dict[tuple, list] = {}
        for j in range(len(self.ranks)):
            c = self.coords(j)
            key = tuple(c[a] for a in FULL_AXES if a not in axes)
            by.setdefault(key, []).append((tuple(c[a] for a in order), j))
        return [[j for _, j in sorted(g)] for g in by.values()]

    def sub(self, idx) -> "Lanes":
        """The lanes ``idx`` (indices into this walk's lanes)."""
        return Lanes(self.mesh, tuple(self.ranks[j] for j in idx))

    def exchange(self, g: list[int], parts: list, *,
                 per_lane: bool = True) -> list[list[torch.Tensor]]:
        """kLayerPartition's exchange over one model group. ``g``: this
        walk's lanes of the group (all of it, or this process's share of
        a group that spans processes), ``parts[k]`` lane ``g[k]``'s part
        (one shape and dtype for all). -> the group's parts in rank
        order, once for each lane of ``g`` (``per_lane``) or once for
        this process (one consumer: the attention a process runs once
        for its share of a group). Each part's gradient is the sum, in
        consumer rank order, of every consumer's gradient of it
        (``GroupExchange``)."""
        mesh = self.mesh
        ranks = [self.ranks[j] for j in g]
        c = mesh.coords(ranks[0])
        group = [mesh.rank(**{**c, MODEL_AXIS: m})
                 for m in range(mesh.widths[MODEL_AXIS])]
        first = c[MODEL_AXIS]
        if ranks != group[first:first + len(ranks)]:
            raise ValueError(f"lanes {ranks} are not one process's "
                             f"share of the model group {group}")
        plan = _Plan(mesh, mesh.procs_of(group), first, len(ranks),
                     len(ranks) if per_lane else 1)
        return [list(o.unbind(0)) for o in GroupExchange.apply(plan, *parts)]


@dataclasses.dataclass(frozen=True)
class _Plan:
    """One exchange: the processes that hold the group (one: no
    collective), this process's first model index in it, its part
    count and its consumer count."""

    mesh: Mesh
    procs: tuple[int, ...]
    first: int
    local: int
    consumers: int

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every process's ``t`` (leading dim: its rows), joined along
        the leading dim in process order; counted on
        ``LAYER_EXCHANGE``."""
        if len(self.procs) == 1:
            return t
        t0 = time.perf_counter()
        rows = self.mesh.gather_rows(t, self.procs)
        LAYER_EXCHANGE.add(t0)
        return rows.reshape(-1, *t.shape[1:])


class GroupExchange(torch.autograd.Function):
    """The exchange of one model group (:meth:`Lanes.exchange`).

    Forward: this process's parts -> for each of its consumers the
    group's parts stacked ``(M, ...)`` in rank order, the other
    processes' parts through one all_gather over the processes that
    hold the group (``Mesh.gather_rows``: the bytes, unchanged).
    Backward: every consumer's gradient of the stack, those of the
    other processes through one all_gather; each of this process's
    parts takes the sum of every consumer's gradient of it, in consumer
    rank order (process order, then lane order).

    The backward's collective relies on every process of a group
    reaching its exchanges' backward nodes in the same order. Each
    process builds the same graph: the same layers over the same number
    of lanes, the walk's exchanges in the same order, each node
    differing only in values. The autograd engine runs the nodes of one
    graph in an order fixed by the graph and the nodes' creation order,
    so the k-th exchange backward of a process meets the k-th of its
    peers. A peer that never arrives ends the job at the process
    group's timeout."""

    @staticmethod
    def forward(ctx, plan, *parts):
        ctx.plan = plan
        whole = plan.gather(torch.stack(parts))
        return tuple(whole if k == 0 else whole.clone()
                     for k in range(plan.consumers))

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        plan = ctx.plan
        every = plan.gather(torch.stack(grads))
        return (None, *(rank_sum(every[c, plan.first + k]
                                 for c in range(every.shape[0]))
                        for k in range(plan.local)))


def concate(parts: list, dim: int) -> torch.Tensor:
    """The reference's Concate (neuralnet.cc:265-280): the model ranks'
    slices of one output, joined in rank order."""
    return torch.cat(parts, dim)


def rank_sum(parts) -> torch.Tensor:
    """The ranks' partial values summed in rank order (the JAX
    package's ``psum``)."""
    return functools.reduce(torch.add, parts)


def split_rows(x: torch.Tensor, n: int, i: int, dim: int = 0
               ) -> torch.Tensor:
    """Piece ``i`` of ``n`` equal contiguous pieces of ``x`` along
    ``dim`` (a mesh axis's shard)."""
    size = x.shape[dim] // n
    return x.narrow(dim, i * size, size)
