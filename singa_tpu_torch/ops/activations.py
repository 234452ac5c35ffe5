"""Scalar activation ops.

Counterpart of ``singa_tpu/ops/activations.py``: the formulas of the
reference's mshadow scalar op structs (reference:
include/mshadow/cxxnet_op.h:14-113), written as the JAX package writes
them so that autograd gives the same gradients (relu's is 0 at exactly
0, like relu_grad's strict ``a > 0``), sigmoid excepted: its JAX
gradient overflows to NaN (see :func:`sigmoid`).
"""

from __future__ import annotations

import torch

# LeCun scaled-tanh constants, hard-coded in the reference
# (cxxnet_op.h:77-87). kTanh layers always use these.
STANH_OUTER = 1.7159047
STANH_INNER = 0.66666667


def relu(x: torch.Tensor, negative_slope: float = 0.0) -> torch.Tensor:
    """max(x, 0), with optional leaky slope (ReLUProto.negative_slope)."""
    # where (not maximum) so the grad at exactly 0 is 0 (cxxnet_op.h:31-35)
    return torch.where(
        x > 0, x, negative_slope * x if negative_slope else torch.zeros_like(x)
    )


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)). ``torch.sigmoid``, whose gradient s * (1 - s)
    stays finite: the JAX package's formula differentiates to
    exp(-x) / (1 + exp(-x))^2, which is inf / inf = NaN once exp(-x)
    overflows (x < -88.7 in float32)."""
    return torch.sigmoid(x)


def stanh(x: torch.Tensor) -> torch.Tensor:
    """Scaled tanh: 1.7159047 * tanh(0.66666667 * x)."""
    return STANH_OUTER * torch.tanh(STANH_INNER * x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.log1p(torch.exp(x))


def bnll(x: torch.Tensor) -> torch.Tensor:
    """Binomial negative log-likelihood, the overflow-safe softplus
    (cxxnet_op.h:57-61): x > 0 ? x + log(1+exp(-x)) : log(1+exp(x))."""
    # minimum (not clamp): it splits the grad at a tie, as jnp.minimum does
    return torch.where(
        x > 0, x + torch.log1p(torch.exp(-torch.abs(x))),
        torch.log1p(torch.exp(torch.minimum(x, torch.zeros_like(x)))))
