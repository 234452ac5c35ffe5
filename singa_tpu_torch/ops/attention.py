"""Attention ops: the dense reference attention.

Counterpart of ``singa_tpu/ops/attention.py``. Only ``NEG_INF`` and the
dense ``attention`` are ported in this slice; the flash-attention
kernels (forward and backward) come with the training slice.

All shapes are (batch, heads, seq, head_dim).
"""

from __future__ import annotations

import math

import torch

#: masked score: finite, so ``exp(m - m)`` stays 1 on fully-masked rows
NEG_INF = -1e30


def attention(q, k, v, *, causal: bool = False) -> torch.Tensor:
    """Reference dense attention: softmax(QK^T / sqrt(d)) V."""
    d = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(d)
    if causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        mask = torch.ones(
            (sq, sk), dtype=torch.bool, device=q.device
        ).tril(diagonal=sk - sq)
        scores = torch.where(mask, scores, NEG_INF)
    return torch.einsum("bhqk,bhkd->bhqd", scores.softmax(-1), v)
