"""Decoder-only transformer LM: the PyTorch counterpart of
``singa_tpu/models/transformer.py``.

Params are the same flat name-keyed dict (``"embed/tok"``,
``"blk0/attn/qkv"``, ...) of float32 tensors, so one set of weights
moves between the two packages through :func:`load_jax_params` and
:func:`export_params`. The block body (:func:`_block_apply`), the LM
head and :func:`cache_attend` are single definitions shared by every
forward here and by the serving engine, as in the JAX package.

Two numerical points where PyTorch's defaults differ from JAX's:

- ``jax.nn.gelu`` defaults to the tanh approximation, so the FFN uses
  ``gelu(approximate="tanh")``;
- ``jnp.var`` is the population variance, so the layer norm uses
  ``correction=0``.

``moe_experts > 0`` replaces every block's FFN with a Switch MoE
(``parallel/moe.py``'s dense path; params ``blk{i}/moe/{gate,up,down}``),
whose load-balancing aux :func:`_block_apply` returns beside its output.
Decode, prefill and verify route at capacity factor E (drop-free and
independent of what shares the batch), as in the JAX package. ``attn``
other than ``"dense"`` raises ``NotImplementedError``.

Tensor parallelism (the serving engine on a mesh): :func:`lm_param_shardings`
is the JAX package's layout of this param tree over the model axis
(``mlp/up`` split on its output dim; ``mlp/down``, ``attn/qkv`` and
``attn/out`` on their contraction dim; everything else, and any dim the
width does not divide, replicated). :func:`_block_apply_tp` is the block
over the model ranks' pieces (:func:`split_lm_params`): each split
contraction's partial products are summed over the ranks in rank order,
each rank attends its own heads of the summed q, k and v (contiguous, so
rank m's rows of ``attn/out`` are exactly its heads' outputs), and the
MLP's gelu stays on each rank's columns. :func:`lm_apply_tp` is
``lm_apply`` over it.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.attention import NEG_INF, attention
from ..parallel.axes import rank_sum
from ..parallel.moe import moe_ffn_dense


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int
    d_model: int = 256
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 1024
    max_len: int = 1024
    attn: str = "dense"  # dense only in this slice (flash, ring later)
    #: > 0 replaces every block's FFN with a Switch MoE of this many
    #: experts (parallel/moe.py's dense path)
    moe_experts: int = 0
    moe_aux_weight: float = 0.01

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads


def _check_supported(cfg: TransformerConfig) -> None:
    if cfg.attn != "dense":
        raise NotImplementedError(
            f"attn={cfg.attn!r}: flash and ring attention come with the "
            "training and distribution slices; this slice runs 'dense'"
        )


def init_lm(generator: torch.Generator, cfg: TransformerConfig,
            device=None) -> dict:
    """Flat name-keyed params, scaled-normal init, drawn in the JAX
    package's order from the CPU ``generator`` and moved to ``device``
    (None = cuda). Same seed -> same weights; the values differ from
    JAX's ``init_lm`` (another RNG), so parity tests feed one set of
    weights to both packages through :func:`load_jax_params`."""
    _check_supported(cfg)
    dev = resolve_device(device)
    params: dict[str, torch.Tensor] = {}

    def norm(shape, scale):
        return scale * torch.randn(shape, generator=generator)

    d, f = cfg.d_model, cfg.d_ff
    params["embed/tok"] = norm((cfg.vocab, d), 0.02)
    params["embed/pos"] = norm((cfg.max_len, d), 0.02)
    for i in range(cfg.n_layers):
        p = f"blk{i}"
        params[f"{p}/ln1/scale"] = torch.ones(d)
        params[f"{p}/ln1/bias"] = torch.zeros(d)
        params[f"{p}/attn/qkv"] = norm((d, 3 * d), 1 / math.sqrt(d))
        params[f"{p}/attn/out"] = norm(
            (d, d), 1 / math.sqrt(d * 2 * cfg.n_layers)
        )
        params[f"{p}/ln2/scale"] = torch.ones(d)
        params[f"{p}/ln2/bias"] = torch.zeros(d)
        if cfg.moe_experts:
            # the JAX package's init_moe: gate, up, down
            e = cfg.moe_experts
            params[f"{p}/moe/gate"] = norm((d, e), 1 / math.sqrt(d))
            params[f"{p}/moe/up"] = norm((e, d, f), 1 / math.sqrt(d))
            params[f"{p}/moe/down"] = norm((e, f, d), 1 / math.sqrt(f))
        else:
            params[f"{p}/mlp/up"] = norm((d, f), 1 / math.sqrt(d))
            params[f"{p}/mlp/down"] = norm(
                (f, d), 1 / math.sqrt(f * 2 * cfg.n_layers)
            )
    params["ln_f/scale"] = torch.ones(d)
    params["ln_f/bias"] = torch.zeros(d)
    return {k: v.to(dev) for k, v in params.items()}


def load_jax_params(np_params: dict, device=None) -> dict:
    """The JAX package's flat param dict (values as numpy arrays, e.g.
    ``{k: np.asarray(v)}`` of ``singa_tpu``'s ``init_lm``) -> this
    package's params on ``device`` (None = cuda), same names, same
    dtypes."""
    dev = resolve_device(device)
    return {
        k: torch.from_numpy(np.array(v, copy=True)).to(dev)
        for k, v in np_params.items()
    }


def export_params(params: dict) -> dict:
    """Params -> ``{name: numpy array}`` on the host, the form
    :func:`load_jax_params` and the JAX package both take."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def _layernorm(x, scale, bias, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)  # population, as jnp.var
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _block_apply(params, p, x, attend, cfg, moe_capacity_factor=1.25):
    """One transformer block with a pluggable attention implementation
    -> (x', aux, extra).

    ``attend(q, k, v) -> (o, extra)`` receives/returns (B, H, S, D);
    ``extra`` passes through (K/V caches for decode, None otherwise).
    ``aux`` is the MoE load-balancing loss (the float 0.0 without
    experts); ``moe_capacity_factor`` is the MoE capacity factor, the
    training default unless given (decode, prefill and verify pass E,
    so routing drops nothing). The single definition of block
    semantics: ``lm_apply``, ``generate`` and every serving-engine
    program run this body."""
    _check_supported(cfg)
    b, s, _ = x.shape
    h = _layernorm(x, params[f"{p}/ln1/scale"], params[f"{p}/ln1/bias"])
    qkv = (h @ params[f"{p}/attn/qkv"]).reshape(
        b, s, 3, cfg.n_heads, cfg.head_dim
    )
    q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
    o, extra = attend(q, k, v)
    o = o.transpose(1, 2).reshape(b, s, cfg.d_model)
    x = x + o @ params[f"{p}/attn/out"]
    h = _layernorm(x, params[f"{p}/ln2/scale"], params[f"{p}/ln2/bias"])
    if cfg.moe_experts:
        moe = {k: params[f"{p}/moe/{k}"] for k in ("gate", "up", "down")}
        y, aux = moe_ffn_dense(h, moe, moe_capacity_factor)
        return x + y, aux, extra
    h = F.gelu(h @ params[f"{p}/mlp/up"], approximate="tanh")
    x = x + h @ params[f"{p}/mlp/down"]
    return x, 0.0, extra


def lm_param_shardings(nmodel: int, params: dict) -> dict:
    """{param name: the dim it splits over ``nmodel`` model ranks, or
    None (replicated)}: the JAX package's ``lm_param_shardings``.
    ``mlp/up`` splits its output dim, ``mlp/down``, ``attn/qkv`` and
    ``attn/out`` their contraction dim (the packed (d, 3d) qkv reshapes
    to (3, heads, head_dim) downstream, which a column split would
    cross); a dim ``nmodel`` does not divide, and every other param,
    replicates, as in the JAX package."""
    out = {}
    for name, v in params.items():
        dim = None
        if nmodel > 1 and v.ndim == 2:
            if name.endswith("/mlp/up"):
                dim = 1
            elif name.endswith(("/attn/qkv", "/attn/out", "/mlp/down")):
                dim = 0
            if dim is not None and v.shape[dim] % nmodel:
                dim = None
        out[name] = dim
    return out


def split_lm_params(params: dict, layout: dict, devices) -> list[dict]:
    """Each model rank's own contiguous copies of its pieces of the split
    params (``layout``: :func:`lm_param_shardings`), rank m's on
    ``devices[m]``."""
    n = len(devices)
    return [{name: v.chunk(n, dim=d)[m].to(dev).clone(
                 memory_format=torch.contiguous_format)
             for name, v in params.items()
             if (d := layout.get(name)) is not None}
            for m, dev in enumerate(devices)]


def _contract(x, params, pieces, layout, name):
    """``x @ params[name]``; split on its contraction dim, the model
    ranks' partial products (rank m's slice of x's last dim times its
    rows) summed in rank order on x's device."""
    if layout.get(name) is None:
        return x @ params[name]
    return rank_sum(
        (x[..., m * pc[name].shape[0]:(m + 1) * pc[name].shape[0]]
         .to(pc[name].device) @ pc[name]).to(x.device)
        for m, pc in enumerate(pieces))


def _block_apply_tp(params, pieces, layout, p, x, attend, cfg,
                    moe_capacity_factor=1.25):
    """:func:`_block_apply` over the model ranks -> (x', aux, [each
    rank's extra]). ``params`` is the whole tree (the replicated params
    run once, on x's device), ``pieces[m]`` rank m's pieces of the split
    ones, ``layout`` :func:`lm_param_shardings`. ``attend(m, q, k, v) ->
    (o, extra)`` gets rank m's heads (B, H/M, S, D), or every head when
    the model width does not divide them (each rank then attends all of
    them and takes its own slice of the output's contraction)."""
    _check_supported(cfg)
    b, s, d = x.shape
    nm = len(pieces)
    h = _layernorm(x, params[f"{p}/ln1/scale"], params[f"{p}/ln1/bias"])
    qkv = _contract(h, params, pieces, layout, f"{p}/attn/qkv").reshape(
        b, s, 3, cfg.n_heads, cfg.head_dim)
    q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
    hm = cfg.n_heads // nm if cfg.n_heads % nm == 0 else cfg.n_heads
    outs, extras = [], []
    for m, pc in enumerate(pieces):
        dev = next(iter(pc.values())).device if pc else x.device
        sl = slice(0, hm) if hm == cfg.n_heads else slice(m * hm,
                                                           (m + 1) * hm)
        o, extra = attend(m, q[:, sl].to(dev), k[:, sl].to(dev),
                          v[:, sl].to(dev))
        outs.append(o.transpose(1, 2).reshape(b, s, hm * cfg.head_dim)
                    .to(x.device))
        extras.append(extra)
    o = outs[0] if hm == cfg.n_heads else torch.cat(outs, dim=-1)
    x = x + _contract(o, params, pieces, layout, f"{p}/attn/out")
    h = _layernorm(x, params[f"{p}/ln2/scale"], params[f"{p}/ln2/bias"])
    if cfg.moe_experts:
        moe = {k: params[f"{p}/moe/{k}"] for k in ("gate", "up", "down")}
        y, aux = moe_ffn_dense(h, moe, moe_capacity_factor)
        return x + y, aux, extras
    up, down = f"{p}/mlp/up", f"{p}/mlp/down"
    if layout.get(up) is None or layout.get(down) is None:
        h = F.gelu(h @ params[up], approximate="tanh")
        return x + h @ params[down], 0.0, extras
    y = rank_sum(
        (F.gelu(h.to(pc[up].device) @ pc[up], approximate="tanh")
         @ pc[down]).to(x.device) for pc in pieces)
    return x + y, 0.0, extras


def lm_apply_tp(params: dict, pieces: list, layout: dict,
                tokens: torch.Tensor, cfg: TransformerConfig):
    """:func:`lm_apply` split over the model ranks whose pieces are
    ``pieces`` (:func:`split_lm_params`): the same logits within the
    rounding of the split contractions' sums."""
    s = tokens.shape[1]
    x = params["embed/tok"][tokens.long()] + params["embed/pos"][:s]

    def attend(m, q, k, v):
        return attention(q, k, v, causal=True), None

    for i in range(cfg.n_layers):
        x, _, _ = _block_apply_tp(params, pieces, layout, f"blk{i}", x,
                                  attend, cfg)
    return lm_head(params, x)


def decode_capacity(cfg: TransformerConfig) -> float:
    """The capacity factor of every cached forward: E, which makes the
    capacity the token count, so no token is dropped and a row's output
    never depends on what shares the batch."""
    return float(max(cfg.moe_experts, 1))


def lm_head(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Final layernorm + tied-embedding projection, the one LM head every
    forward shares (so the speculative verify's per-position logits are
    the one-token tick's math)."""
    xf = _layernorm(x, params["ln_f/scale"], params["ln_f/bias"])
    return xf @ params["embed/tok"].T


def lm_apply(params: dict, tokens: torch.Tensor,
             cfg: TransformerConfig) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, vocab); causal, dense
    attention."""
    _check_supported(cfg)
    s = tokens.shape[1]
    x = params["embed/tok"][tokens.long()] + params["embed/pos"][:s]

    def attend(q, k, v):
        return attention(q, k, v, causal=True), None

    for i in range(cfg.n_layers):
        x, _, _ = _block_apply(params, f"blk{i}", x, attend, cfg)
    return lm_head(params, x)


def cache_attend(q, k_cache, v_cache, positions):
    """Masked attention of Q queries against a full cache, the attention
    body the reference serving path shares with ``generate``.

    ``q`` (B, H, Q, D) holds queries at absolute ``positions`` (B, Q);
    ``k_cache``/``v_cache`` (B, H, C, D) the whole (padded) cache. Cache
    entries beyond a query's position score -1e30, so their softmax
    weight underflows to exactly 0.0 and cache garbage never moves an
    output bit."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q, k_cache) * scale
    cols = torch.arange(k_cache.shape[2], device=q.device)
    mask = cols[None, None, None, :] <= positions[:, None, :, None]
    s = torch.where(mask, s, NEG_INF)
    return torch.einsum("bhqk,bhkd->bhqd", s.softmax(-1), v_cache)


def _block_step(params, p, x, k_cache, v_cache, pos, cfg):
    """One block on Q tokens (B, Q, d) against the (B, H, C, D) caches,
    which are written IN PLACE at positions [pos, pos + Q) (JAX returns
    new caches; here ``generate`` owns them). -> x'."""

    def attend(q, k, v):
        n = q.shape[2]
        k_cache[:, :, pos:pos + n] = k
        v_cache[:, :, pos:pos + n] = v
        positions = (
            pos + torch.arange(n, device=q.device)
        )[None, :].expand(q.shape[0], n)
        return cache_attend(q, k_cache, v_cache, positions), None

    x, _, _ = _block_apply(params, p, x, attend, cfg,
                           moe_capacity_factor=decode_capacity(cfg))
    return x


@torch.no_grad()
def generate(params: dict, prompt: torch.Tensor, cfg: TransformerConfig,
             n_tokens: int, *, generator: torch.Generator | None = None,
             temperature: float = 0.0,
             prefill_chunk: int | None = None) -> torch.Tensor:
    """Autoregressive decode with a KV cache: the sequential stream
    oracle.

    ``prompt`` (B, P) int -> (B, P + n_tokens) int64. Greedy when
    ``temperature`` == 0, else softmax sampling at that temperature
    from ``generator`` (required; on the prompt's device). Prefill runs
    the same ``_block_step`` body as the decode loop, in chunks of
    ``prefill_chunk`` tokens (default min(P, 512)); each query attends
    the full masked cache, so chunking never changes a token."""
    b, plen = prompt.shape
    if plen < 1:
        raise ValueError("generate: prompt must hold at least one token")
    if plen + n_tokens > cfg.max_len:
        raise ValueError(
            f"generate: prompt {plen} + n_tokens {n_tokens} exceeds "
            f"max_len {cfg.max_len}"
        )
    if temperature > 0.0 and generator is None:
        raise ValueError("generate: sampling (temperature > 0) needs a "
                         "generator")
    if prefill_chunk is None:
        prefill_chunk = max(1, min(plen, 512))
    prompt = prompt.long()
    dev = prompt.device
    shape = (b, cfg.n_heads, cfg.max_len, cfg.head_dim)
    dtype = params["embed/tok"].dtype
    ks = [torch.zeros(shape, dtype=dtype, device=dev)
          for _ in range(cfg.n_layers)]
    vs = [torch.zeros(shape, dtype=dtype, device=dev)
          for _ in range(cfg.n_layers)]

    def step(x, pos):
        for i in range(cfg.n_layers):
            x = _block_step(params, f"blk{i}", x, ks[i], vs[i], pos, cfg)
        return lm_head(params, x)[:, -1]

    def sample(logits):
        if temperature <= 0.0:
            return logits.argmax(-1)
        probs = (logits / temperature).softmax(-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    for c0 in range(0, plen, prefill_chunk):
        n = min(prefill_chunk, plen - c0)
        x = (
            params["embed/tok"][prompt[:, c0:c0 + n]]
            + params["embed/pos"][c0:c0 + n]
        )
        logits = step(x, c0)
    out = [sample(logits)]
    for t in range(1, n_tokens):
        pos = plen + t - 1
        x = (
            params["embed/tok"][out[-1]][:, None, :]
            + params["embed/pos"][pos][None, None, :]
        )
        out.append(sample(step(x, pos)))
    gen = torch.stack(out[:n_tokens], dim=1) if n_tokens else prompt[:, :0]
    return torch.cat([prompt, gen], dim=1)
