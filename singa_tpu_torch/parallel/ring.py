"""Ring attention: sequence parallelism over the mesh's seq axis.

Counterpart of ``singa_tpu/parallel/ring.py``. Q, K and V live
sequence-sharded over the seq ranks; each rank computes attention for
its own query block while the K/V blocks travel round the ring, one hop
a step, and every visiting block is folded into flash-style running
statistics (``ops.attention.block_attn_update``). At hop i rank ``my``
holds the block that started on rank ``(my - i) % n``, and masks it
causally by that rank's global ``k_offset``, so a block from later in
the sequence contributes nothing. The statistics run in float32 and K/V
stay in the input dtype, as in the JAX package.

On the port's one controller a hop is a read of the other rank's block,
and autograd runs the backward over the same visits. The fold is plain
PyTorch here, as it is plain JAX there (``block_attn_update`` is not a
Pallas kernel); the ring's hops through the flash kernels are later
kernel work (ROADMAP §2).
"""

from __future__ import annotations

import torch

from ..ops.attention import (
    attention,
    block_attn_finish,
    block_attn_init,
    block_attn_update,
)
from .axes import split_rows

SEQ_AXIS = "seq"


def _visitor(my: int, i: int, n: int) -> int:
    """The rank whose K/V block rank ``my`` holds at hop ``i``: blocks
    move one rank forward a hop, so it started ``i`` ranks back."""
    return (my - i) % n


def _rotate(held: list) -> list:
    """One hop: rank j's block moves to rank j + 1 (the JAX ring's
    ppermute)."""
    return held[-1:] + held[:-1]


def ring_attention_ranks(qs: list, ks: list, vs: list, *,
                         causal: bool) -> list:
    """One seq group's ring: ``qs[i]``, ``ks[i]``, ``vs[i]`` are seq
    rank i's (batch, heads, s_local, head_dim) blocks -> each rank's
    output block, in the input dtype. Each hop every rank folds the
    block it holds, masked by the global offset of the rank it came
    from (``_visitor``), then the blocks rotate."""
    n = len(qs)
    s_local = qs[0].shape[2]
    q32 = [q.float() for q in qs]
    stats = [block_attn_init(q) for q in q32]
    held = list(zip(ks, vs))
    for i in range(n):
        for my in range(n):
            k, v = held[my]
            stats[my] = block_attn_update(
                q32[my], k.float(), v.float(), *stats[my],
                q_offset=my * s_local,
                k_offset=_visitor(my, i, n) * s_local, causal=causal)
        held = _rotate(held)
    return [block_attn_finish(*st).to(q.dtype)
            for st, q in zip(stats, qs)]


def ring_attention(q, k, v, *, ndata: int = 1, nseq: int = 1,
                   causal: bool = False) -> torch.Tensor:
    """Sequence-parallel attention of global (batch, heads, seq,
    head_dim) arrays: the batch split over ``ndata`` data ranks, the
    sequence over ``nseq`` seq ranks, each data rank's seq group run as
    one ring; -> the global output. A 1-wide seq axis is the dense
    attention, as in the JAX package."""
    if nseq == 1:
        return attention(q, k, v, causal=causal)
    rows = []
    for d in range(ndata):
        blocks = [[split_rows(split_rows(t, ndata, d), nseq, i, dim=2)
                   for i in range(nseq)] for t in (q, k, v)]
        rows.append(torch.cat(
            ring_attention_ranks(*blocks, causal=causal), dim=2))
    return torch.cat(rows)
