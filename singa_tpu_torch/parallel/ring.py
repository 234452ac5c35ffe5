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
and autograd runs the backward over the same visits. A Trainer's walk
hands each of its seq lanes every rank's K/V block through one exchange
over the seq group (``Lanes.exchange``, which may cross processes) and
folds each lane's query block on its own (:func:`ring_fold`); each
block's gradient is then summed over the lanes that folded it, in rank
order, whatever processes hold them. The fold is plain
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


def ring_fold(q, blocks: list, my: int, *, causal: bool):
    """Seq rank ``my``'s ring: its (batch, heads, s_local, head_dim)
    query block, ``blocks[i]`` rank i's (k, v) -> its output block, in
    the input dtype. At hop i it holds the block that started i ranks
    back, one hop a step round the ring, and masks it by the global
    offset of the rank it came from (``_visitor``)."""
    n = len(blocks)
    s_local = q.shape[2]
    q32 = q.float()
    stats = block_attn_init(q32)
    for i in range(n):
        k, v = blocks[(my - i) % n]
        stats = block_attn_update(
            q32, k.float(), v.float(), *stats, q_offset=my * s_local,
            k_offset=_visitor(my, i, n) * s_local, causal=causal)
    return block_attn_finish(*stats).to(q.dtype)


def ring_attention_ranks(qs: list, ks: list, vs: list, *,
                         causal: bool) -> list:
    """One seq group's ring: ``qs[i]``, ``ks[i]``, ``vs[i]`` are seq
    rank i's (batch, heads, s_local, head_dim) blocks -> each rank's
    output block (:func:`ring_fold`)."""
    blocks = list(zip(ks, vs))
    return [ring_fold(q, blocks, my, causal=causal)
            for my, q in enumerate(qs)]


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
