"""Mixture-of-experts FFN, dense (single-device) path: the counterpart of
``singa_tpu/parallel/moe.py``'s ``_route`` and ``moe_ffn_dense``.

Switch-style top-1 routing with a capacity limit: each token goes to
its highest-probability expert, takes the next free place in that
expert's queue of ``capacity = max(1, int(cf * N / E))`` places, and is
dropped to the residual (output 0) once the queue is full. The
load-balancing aux loss is ``E * sum(frac * mean_prob)``. Routing and
combine math run in float32 under bf16 compute.

Two forms of the same function:

- :func:`moe_ffn_dense_plain` is the JAX form, kept as the plain
  version: a one-hot dispatch tensor (N, E, C) and four einsums. At
  examples/lm/tinylm_moe.conf's width (N = 16384 tokens, E = 8, C =
  2560) the dispatch and combine tensors are 1.34 GB each in float32,
  and their two einsums do ~16x the experts' own operations.
- :func:`moe_ffn_dense`, the main path, is the index form: each token's
  place in the (E * C + 1)-row slot buffer (the last row takes the
  dropped tokens), the tokens gathered into (E, C, D) with
  ``index_select``, the experts as batched matmuls, and each token's
  output row gathered back and scaled by its gate. Every sum of the
  dense form has one nonzero term, so on finite inputs the forward
  equals the plain form's to the bit; the gate's gradient (a dot over
  D) differs from the plain form's only in summation order.

The index form is graph-capturable (the host dispatch rule of
``utils/graphs.py``): static shapes, no ``nonzero()``, no boolean-mask
indexing, no reads back to the host.

The expert einsums of the JAX package run a float32 ``expert_in``
against bf16-cast weights, which JAX promotes to float32; PyTorch does
not promote a mixed matmul, so both forms cast the weights to float32
explicitly and cast the output back to ``x.dtype`` at the end.

Expert parallelism (``moe_ffn``/``moe_ffn_a2a`` under ``shard_map``) is
not in this module: it waits for the process-per-GPU transport
(ROADMAP.md §1 item 6).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def capacity_of(n_tokens: int, n_experts: int, capacity_factor: float) -> int:
    """Places per expert queue: max(1, int(cf * N / E)), as in JAX."""
    return max(1, int(capacity_factor * n_tokens / n_experts))


def _probs_and_choice(x2d, gate_w):
    """(probs (N, E) f32, onehot (N, E) f32 of each token's top-1
    expert, the queue position of each token in its expert (N,) f32)."""
    logits = x2d.float() @ gate_w.float()
    probs = logits.softmax(-1)
    expert = probs.argmax(-1)
    onehot = (expert[:, None] == torch.arange(
        gate_w.shape[1], device=x2d.device)).float()
    # the running count along the tokens, scanned over the (E, N)
    # transpose: a scan of the innermost dim. The same scan over dim 0 of
    # (N, E) runs on the card as E threads stepping through N tokens one
    # after another (2.5 ms at N = 16384 on an H100). The counts are
    # integers, exact in float32 either way.
    count = onehot.t().contiguous().cumsum(1).t()
    pos = ((count - 1.0) * onehot).sum(-1)
    return probs, onehot, expert, pos


def _aux(probs, onehot):
    """Switch load-balancing loss: E * sum(frac routed * mean prob)."""
    frac = onehot.mean(0)
    mean_prob = probs.mean(0)
    return probs.shape[1] * (frac * mean_prob).sum()


def _route(x2d, gate_w, capacity):
    """The JAX form's routing: (dispatch (N, E, C) one-hot, combine
    weights (N, E, C), aux loss). All float32."""
    probs, onehot, _, pos = _probs_and_choice(x2d, gate_w)
    kept = pos < capacity  # over-capacity tokens drop to the residual
    slot = (pos.long()[:, None] == torch.arange(
        capacity, device=x2d.device)).float() * kept[:, None]
    dispatch = onehot[:, :, None] * slot[:, None, :]
    gate_val = (probs * onehot).sum(-1)
    combine = dispatch * gate_val[:, None, None]
    return dispatch, combine, _aux(probs, onehot)


def _experts(expert_in, params):
    """(E, C, D) f32 -> (E, C, D) f32: gelu(x @ up) @ down per expert,
    in float32 whatever the weights' dtype (JAX's promotion)."""
    h = F.gelu(torch.bmm(expert_in, params["up"].float()),
               approximate="tanh")
    return torch.bmm(h, params["down"].float())


def moe_ffn_dense_plain(x, params, capacity_factor: float = 1.25):
    """The plain version (the JAX form): x (B, S, D) -> (y, aux)."""
    b, s, d = x.shape
    n = b * s
    e = params["gate"].shape[1]
    capacity = capacity_of(n, e, capacity_factor)
    x2d = x.reshape(n, d)
    dispatch, combine, aux = _route(x2d, params["gate"], capacity)
    expert_in = torch.einsum("nec,nd->ecd", dispatch, x2d.float())
    expert_out = _experts(expert_in, params)
    y = torch.einsum("nec,ecd->nd", combine, expert_out)
    return y.reshape(b, s, d).to(x.dtype), aux


def _slots(expert, pos, capacity, n_experts):
    """Each token's row of the slot buffer: expert * C + position while
    the queue has room, else the drop row E * C."""
    kept = pos < capacity
    return torch.where(kept, expert * capacity + pos.long(),
                       n_experts * capacity)


def moe_ffn_dense(x, params, capacity_factor: float = 1.25):
    """The index form, the main path: x (B, S, D) -> (y, aux), equal to
    :func:`moe_ffn_dense_plain`."""
    b, s, d = x.shape
    n = b * s
    e = params["gate"].shape[1]
    capacity = capacity_of(n, e, capacity_factor)
    rows = e * capacity
    x2d = x.reshape(n, d)
    probs, onehot, expert, pos = _probs_and_choice(x2d, params["gate"])
    aux = _aux(probs, onehot)
    gate_val = (probs * onehot).sum(-1)
    slot = _slots(expert, pos, capacity, e)                       # (N,)
    # the token in each row (n, a zero row, where none is); every
    # dropped token writes the drop row, which nothing reads
    token = torch.full((rows + 1,), n, dtype=torch.long, device=x.device)
    token.scatter_(0, slot, torch.arange(n, device=x.device))
    xf = x2d.float()
    x_pad = torch.cat([xf, xf.new_zeros(1, d)])
    expert_in = x_pad.index_select(0, token[:rows]).view(e, capacity, d)
    out = _experts(expert_in, params).reshape(rows, d)
    out_pad = torch.cat([out, out.new_zeros(1, d)])
    y = out_pad.index_select(0, slot) * gate_val[:, None]
    return y.reshape(b, s, d).to(x.dtype), aux
