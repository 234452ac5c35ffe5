"""Mixture-of-experts FFN: the counterpart of ``singa_tpu/parallel/moe.py``
(``_route``, ``moe_ffn_dense``, ``moe_ffn`` and ``moe_ffn_a2a``).

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

Expert parallelism (the JAX package's ``moe_ffn`` and ``moe_ffn_a2a``
under ``shard_map``) runs over the mesh's expert axis on the index
form, each expert rank holding ``e_local = E / n`` experts' weights:

- the psum form (:func:`moe_psum_ranks`, each rank's share
  :func:`moe_psum_part`): the tokens are the same on every expert rank
  of a group; each rank routes them, runs its own experts
  [my·e_local, (my+1)·e_local) on the tokens routed there, and the
  partial outputs are summed over the expert ranks in rank order. Its
  aux loss is each rank's own (the same on every rank of a group).
- the all-to-all form (:func:`moe_a2a_ranks`: :func:`a2a_route`,
  :func:`a2a_experts`, :func:`a2a_back`): expert rank j routes only rows
  [j·b/n, (j+1)·b/n) of its group's batch, with a capacity per (source
  rank, expert) of ``max(1, int(cf * n_local / E))``; the slot buffers
  of every expert go to the expert's owner, which runs its experts on
  the buffers of every source, and the outputs go back. The aux loss
  takes ``frac`` and ``mean_prob`` averaged over every token shard
  before their product, the global batch's value.

:func:`moe_ffn` and :func:`moe_ffn_a2a` are the same two forms on global
arrays, the JAX functions' signatures with the mesh given as widths.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .axes import rank_sum, split_rows

EXPERT_AXIS = "expert"


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


def _shard_of(e: int, n: int) -> int:
    """The expert shard whose tokens expert rank ``e`` computes: its
    own, experts [e·e_local, (e+1)·e_local)."""
    return e


def _slot_rows(x2d, slot, rows: int):
    """The (rows, D) float32 slot buffer of the tokens whose slot is in
    [0, rows) (``slot`` == rows marks the others)."""
    n, d = x2d.shape
    token = torch.full((rows + 1,), n, dtype=torch.long, device=x2d.device)
    token.scatter_(0, slot, torch.arange(n, device=x2d.device))
    xf = x2d.float()
    x_pad = torch.cat([xf, xf.new_zeros(1, d)])
    return x_pad.index_select(0, token[:rows])


def _gather_back(out, slot, gate_val):
    """Each token's output row (``slot`` indexes ``out``; the row past
    its end is the zero row of the tokens it does not hold), scaled by
    its gate."""
    out_pad = torch.cat([out, out.new_zeros(1, out.shape[1])])
    return out_pad.index_select(0, slot) * gate_val[:, None]


def moe_psum_part(x, p: dict, e: int, nexp: int,
                  capacity_factor: float = 1.25):
    """Expert rank ``e``'s share of the psum form: its routing of the
    (B, S, D) tokens ``x`` with its params ``p`` (``gate`` whole,
    ``up``/``down`` its e_local experts) -> (its partial output (B·S, D)
    in float32: its experts' rows, the others' zero; its aux loss)."""
    b, s, d = x.shape
    n = b * s
    e_total = p["gate"].shape[1]
    cap = capacity_of(n, e_total, capacity_factor)
    x2d = x.reshape(n, d)
    probs, onehot, expert, pos = _probs_and_choice(x2d, p["gate"])
    gate_val = (probs * onehot).sum(-1)
    e_local = p["up"].shape[0]
    rows = e_local * cap
    local = _slots(expert, pos, cap, e_total) - _shard_of(e, nexp) * rows
    local = torch.where((local >= 0) & (local < rows), local, rows)
    expert_in = _slot_rows(x2d, local, rows).view(e_local, cap, d)
    out = _experts(expert_in, p).reshape(rows, d)
    return _gather_back(out, local, gate_val), _aux(probs, onehot)


def moe_psum_ranks(xs: list, ps: list, capacity_factor: float = 1.25):
    """The psum form over one group's expert ranks: ``xs[e]`` is rank
    e's (B, S, D) tokens (the same values on every rank), ``ps[e]`` its
    params (``gate`` whole, ``up``/``down`` its e_local experts) -> (y,
    [each rank's aux]), y the ranks' partial outputs
    (:func:`moe_psum_part`) summed in rank order. A layer whose expert
    ranks span processes sums the same partials after an exchange."""
    nexp = len(xs)
    parts, auxes = zip(*(moe_psum_part(x, p, e, nexp, capacity_factor)
                         for e, (x, p) in enumerate(zip(xs, ps))))
    return rank_sum(parts).reshape(xs[0].shape).to(xs[0].dtype), \
        list(auxes)


def a2a_route(x, p: dict, j: int, nexp: int,
              capacity_factor: float = 1.25):
    """Source rank ``j``'s routing in the all-to-all form: rows
    [j·b/n, (j+1)·b/n) of the (B, S, D) tokens ``x`` through the gate
    ``p["gate"]`` -> (the slot buffers of every expert (E, cap, D), its
    route (slot, gate value) for :func:`a2a_back`, its ``frac``, its
    ``mean_prob``)."""
    b, s, d = x.shape
    e_total = p["gate"].shape[1]
    n = (b // nexp) * s
    cap = capacity_of(n, e_total, capacity_factor)
    x2d = split_rows(x, nexp, j).reshape(n, d)
    probs, onehot, expert, pos = _probs_and_choice(x2d, p["gate"])
    slot = _slots(expert, pos, cap, e_total)
    send = _slot_rows(x2d, slot, e_total * cap).view(e_total, cap, d)
    return (send, (slot, (probs * onehot).sum(-1)), onehot.mean(0),
            probs.mean(0))


def a2a_experts(sends: list, p: dict, k: int) -> torch.Tensor:
    """Owner ``k`` of ``len(sends)`` expert ranks runs its local experts
    (``p``'s ``up``/``down``) on every source's buffers for them
    (``sends[j]``: source j's (E, cap, D); source-major along each
    expert's rows, as the JAX all_to_all concatenates them) -> (e_local,
    sources, cap, D)."""
    nexp = len(sends)
    e_local = p["up"].shape[0]
    cap, d = sends[0].shape[1:]
    lo = _shard_of(k, nexp) * e_local
    expert_in = torch.stack([t[lo:lo + e_local] for t in sends], 1) \
        .reshape(e_local, nexp * cap, d)
    return _experts(expert_in, p).view(e_local, nexp, cap, d)


def a2a_back(outs: list, route: tuple, j: int) -> torch.Tensor:
    """Source ``j``'s rows back from every owner's output (``outs[k]``:
    :func:`a2a_experts`' of owner k), each scaled by its gate ->
    (tokens, D) in float32."""
    ret = torch.cat([o[:, j] for o in outs])
    return _gather_back(ret.reshape(-1, ret.shape[-1]), *route)


def moe_a2a_ranks(xs: list, ps: list, capacity_factor: float = 1.25):
    """The all-to-all form over one group's expert ranks: rank j routes
    rows [j·b/n, (j+1)·b/n) of ``xs[j]`` (B, S, D) -> (y (B, S, D), the
    group's rows from every rank, the same on each; [each rank's
    ``frac``]; [each rank's ``mean_prob``])."""
    nexp = len(xs)
    b, s, d = xs[0].shape
    routed = [a2a_route(x, p, j, nexp, capacity_factor)
              for j, (x, p) in enumerate(zip(xs, ps))]
    sends = [r[0] for r in routed]
    outs = [a2a_experts(sends, ps[k], k) for k in range(nexp)]
    ys = [a2a_back(outs, routed[j][1], j).reshape(b // nexp, s, d)
          for j in range(nexp)]
    return (torch.cat(ys).to(xs[0].dtype), [r[2] for r in routed],
            [r[3] for r in routed])


def share(lanes, g: list, parts: list, axes) -> list:
    """kMoE's exchanges (its routing group's tokens, the expert ranks'
    partial outputs, the all-to-all form's expert outputs and
    statistics): ``parts[k]`` lane ``g[k]``'s -> for each lane of ``g``
    every part of its group over ``axes`` in rank order
    (``Lanes.exchange``, across processes when the group spans them)."""
    return lanes.exchange(g, parts, axes=axes)


def a2a_aux(fracs: list, mprobs: list) -> torch.Tensor:
    """The all-to-all form's aux loss: ``frac`` and ``mean_prob``
    averaged over every token shard (in rank order) before their
    product, as the JAX form's ``pmean`` over the token axes."""
    frac = rank_sum(fracs) / len(fracs)
    mean_prob = rank_sum(mprobs) / len(mprobs)
    return frac.shape[0] * (frac * mean_prob).sum()


def _expert_params(params: dict, nexp: int, e: int) -> dict:
    return {"gate": params["gate"],
            "up": split_rows(params["up"], nexp, e),
            "down": split_rows(params["down"], nexp, e)}


def moe_ffn(x, params, *, ndata: int = 1, nexpert: int = 1,
            capacity_factor: float = 1.25):
    """The psum form on global arrays: x (B, S, D) split over ``ndata``
    data ranks, the experts over ``nexpert`` expert ranks -> (y, aux),
    aux the mean of the data ranks' (the JAX ``moe_ffn``)."""
    if nexpert == 1:
        return moe_ffn_dense(x, params, capacity_factor)
    ps = [_expert_params(params, nexpert, e) for e in range(nexpert)]
    ys, auxes = [], []
    for dd in range(ndata):
        xd = split_rows(x, ndata, dd)
        y, aux = moe_psum_ranks([xd] * nexpert, ps, capacity_factor)
        ys.append(y)
        auxes.append(aux[0])
    return torch.cat(ys), rank_sum(auxes) / ndata


def moe_ffn_a2a(x, params, *, ndata: int = 1, nexpert: int = 1,
                capacity_factor: float = 1.25):
    """The all-to-all form on global arrays (the JAX ``moe_ffn_a2a``):
    -> (y, aux), aux the global batch's."""
    if nexpert == 1:
        return moe_ffn_dense(x, params, capacity_factor)
    ps = [_expert_params(params, nexpert, e) for e in range(nexpert)]
    ys, fracs, mprobs = [], [], []
    for dd in range(ndata):
        xd = split_rows(x, ndata, dd)
        y, f, m = moe_a2a_ranks([xd] * nexpert, ps, capacity_factor)
        ys.append(y)
        fracs += f
        mprobs += m
    return torch.cat(ys), a2a_aux(fracs, mprobs)
