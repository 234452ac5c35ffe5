"""Lanes: the ranks one lockstep walk of a net runs, and the exchanges
between them.

The JAX package runs one program over its device mesh: GSPMD and
``shard_map`` move activations between devices (ring attention's K/V
``ppermute``, kMoE's ``psum`` and ``all_to_all``, kLayerPartition's
Slice/Concate, the pipeline's stage hops). The port runs the mesh on one
controller: ``Net`` walks the layers once for every rank in lockstep, a
lane per rank, and a layer whose work crosses ranks takes every lane's
input in one call (``Layer.apply_ranks``) and reads the other ranks'
tensors directly. Autograd carries the gradients back along the same
reads, so the backward needs no exchange code of its own.

Every cross-rank sum here runs in rank order, so two runs of the port
give the same bits.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .mesh import FULL_AXES, Mesh


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
