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

Work that crosses ranks goes through one exchange, :meth:`Lanes.exchange`
(``GroupExchange``), over a group of ranks on a named set of axes:
kLayerPartition's Concate and partial sums (the model axis), ring
attention's K/V and kLMLoss's shift (seq), kMoE's tokens, partial sums
and aux statistics (seq, expert, data), the pipeline's stage hops
(pipe). A group may span processes: the exchange's forward hands every
consumer the group's parts in rank order (the parts of other processes
through one collective), and its backward sums each part's gradients
over the consumers in rank order and hands the sum back to the part's
owner. One process runs the same exchange over its own lanes, so P
processes and one add every gradient in the same order.

Every cross-rank sum here runs in rank order, so two runs of the port
give the same bits.
"""
from __future__ import annotations

import dataclasses
import functools
import time

import torch
from torch.autograd.function import once_differentiable

from .mesh import (EXCHANGE_AXES, FULL_AXES, LAYER_EXCHANGE, MODEL_AXIS,
                   Mesh)


@dataclasses.dataclass(frozen=True)
class Lanes:
    """The lanes of one walk: ``ranks[j]`` is lane j's global rank on
    ``mesh``. ``data``: whether the walk's data ranks train one model
    (the sync Trainer: kMoE routes their tokens together) or each its
    own replica (the replica engine: no exchange crosses the data axis).
    ``order``: the walk's exchange chain (shared with its ``sub`` walks;
    see :meth:`exchange` and :meth:`tie`)."""

    mesh: Mesh
    ranks: tuple[int, ...]
    data: bool = True
    order: list = dataclasses.field(default_factory=list, compare=False,
                                    repr=False)

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
        """The lanes ``idx`` (indices into this walk's lanes), on this
        walk's exchange chain."""
        return Lanes(self.mesh, tuple(self.ranks[j] for j in idx),
                     self.data, self.order)

    def exchange(self, g: list[int], parts: list, *, axes=(MODEL_AXIS,),
                 per_lane: bool = True) -> list[list[torch.Tensor]]:
        """The exchange over one group on ``axes`` (the ranks that differ
        only there). ``g``: this walk's lanes of the group (all of it,
        or this process's share of a group that spans processes),
        ``parts[k]`` lane ``g[k]``'s part (one shape and dtype for all).
        -> the group's parts in rank order, once for each lane of ``g``
        (``per_lane``) or once for this process (one consumer: the
        attention a process runs once for its share of a model group).
        Each part's gradient is the sum, in consumer rank order, of
        every consumer's gradient of it (``GroupExchange``).

        The exchanges of a walk form a chain: each one's first part
        carries a link from the previous one's output (``_Link``), so
        that every process runs its exchanges' backward nodes, those
        whose outputs it never reads too, in the reverse of their
        forward order (the order contract of ``GroupExchange``); the
        walk ties the last one to its loss (:meth:`tie`)."""
        mesh = self.mesh
        if tuple(axes) not in EXCHANGE_AXES:
            raise ValueError(f"an exchange over {axes}: not one of "
                             f"EXCHANGE_AXES {EXCHANGE_AXES}")
        ranks = [self.ranks[j] for j in g]
        group = mesh.group_of(ranks[0], axes)
        first = group.index(ranks[0])
        procs = mesh.procs_of(group)
        # every process of the group holds an equal share of it
        if (ranks != [r for r in group if mesh.is_local(r)]
                or len(group) != len(ranks) * len(procs)):
            raise ValueError(f"lanes {ranks} are not one process's "
                             f"share of the {'/'.join(axes)} group "
                             f"{list(group)}")
        plan = _Plan(mesh, procs, first, len(ranks),
                     len(ranks) if per_lane else 1)
        parts = list(parts)
        if parts[0].is_floating_point() and torch.is_grad_enabled():
            if not self.order:
                self.order.append(torch.zeros(
                    (), device=parts[0].device, requires_grad=True))
            parts[0] = _Link.apply(parts[0], self.order[-1])
        outs = GroupExchange.apply(plan, *parts)
        if outs[0].requires_grad:
            self.order[-1:] = [outs[0]]
        return [list(o.unbind(0)) for o in outs]

    def tie(self, loss: torch.Tensor) -> torch.Tensor:
        """``loss`` (unchanged) linked to the walk's last exchange, so
        that the backward from it reaches every exchange of the walk."""
        if self.order and self.order[-1].grad_fn is not None:
            return _Link.apply(loss, self.order[-1])
        return loss


class _Link(torch.autograd.Function):
    """``x`` unchanged, with ``dep`` as an input that takes no gradient:
    ``dep``'s node runs its backward only after this one has."""

    @staticmethod
    def forward(ctx, x, dep):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


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
    process issues its exchanges in one order, the order of the walk
    (the same layers, the pipeline's ticks, each group's exchanges in
    group order), and every pair of processes meets its shared
    exchanges in the same forward order. The walk's chain
    (:meth:`Lanes.exchange`) runs each process's exchange backwards in
    the reverse of that order, the nodes whose outputs that process
    never reads too (a pipe stage idle at a tick, a seq shard whose
    blocks only its peers fold), so the k-th exchange backward of a
    process meets the k-th of its peers. A peer that never arrives ends
    the job at the process group's timeout."""

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
