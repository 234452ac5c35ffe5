"""Attention ops: the dense reference attention, the online-softmax
block primitives, and flash attention (forward and backward) on the
CUDA kernels of ``csrc/flash_attention.cu`` (float32) and
``csrc/flash_attention_bf16.cu`` (bfloat16).

Counterpart of ``singa_tpu/ops/attention.py``, whose six Pallas kernels
(staged and streamed forward, dQ and dK/dV) become Hopper kernel entry
points here. The TPU's staged/streamed split is a VMEM budget
(``_variant`` there); on the GPU one kernel streams its tiles through
shared memory for every S. bf16 runs on the tensor cores
(``flash_attention_bf16.cu``: ``flash_fwd``, and the backward as the pair
``flash_bwd_dq`` + ``flash_bwd_dkv``, P and dS rounded once to bf16
before their products); float32 runs on the CUDA cores
(``flash_attention.cu``: ``flash_fwd``, and the backward as one fused
kernel, ``flash_bwd``). ``kernel_source`` says which entry runs where;
``flash_bwd`` is the backward for both types.

Each kernel wrapper takes flattened ``(B*H, S, D)`` rows (the layout of
the Pallas calls) with ``lse`` and ``delta`` laid out ``(B*H, S)`` in
float32, and dispatches by device and nothing else: a CUDA tensor
launches the kernel or raises; a CPU tensor takes the plain PyTorch
version beside it (``flash_fwd_plain``, ``flash_bwd_plain``,
``flash_bwd_dq_plain``, ``flash_bwd_dkv_plain``), which the CPU tests
hold against the JAX package. Each wrapper counts its kernel launches in
its ``launches`` attribute (CPU calls do not count): ``flash_bwd`` counts
the fused float32 kernel; on bf16 it calls the pair, which count theirs.

Masking follows the JAX kernels exactly: masked scores are ``NEG_INF``
(-1e30, finite), their probabilities are set to 0, a row whose every
entry is masked emits 0, and the scale is 1/sqrt(D).

All public shapes are (batch, heads, seq, head_dim).
"""

from __future__ import annotations

import ctypes
import functools
import math
import os

import torch

#: masked score: finite, so ``exp(m - m)`` stays 1 on fully-masked rows
NEG_INF = -1e30

#: head widths the kernels are instantiated for (each thread keeps its
#: share of D output columns in registers)
KERNEL_HEAD_DIMS = (64, 128)
#: query and key rows per kernel tile: S must be a multiple
KERNEL_TILE = 64
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel entries of each type: float32's backward is one fused
#: kernel, bf16's the dQ and dK/dV pair
KERNEL_NAMES = {
    torch.float32: ("flash_fwd", "flash_bwd"),
    torch.bfloat16: ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
}
#: int32 scratch of the fused backward before its per-(bh, q tile)
#: counters: three uint64 statistics (cycles spent polling, cycles the
#: blocks ran, blocks run), the ticket and one spare
#: (``kScratchHead`` in ``csrc/flash_attention.cu``)
BWD_SCRATCH_HEAD = 8


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


# ---------------------------------------------------------------------
# online-softmax block math: fold one K/V block into running (out, m, l)
# ---------------------------------------------------------------------


def block_attn_update(q, k, v, out, m, l, *, q_offset=0, k_offset=0,
                      causal: bool = False):
    """Fold one K/V block into running flash statistics.

    q (..., Sq, D); k/v (..., Sk, D); out (..., Sq, D) unnormalized;
    m/l (..., Sq) running rowmax / normalizer. Offsets give the global
    positions of the local blocks so causal masking works when the
    sequence is blocked. Returns the updated (out, m, l)."""
    d = q.shape[-1]
    scores = torch.einsum("...qd,...kd->...qk", q, k) / math.sqrt(d)
    if causal:
        qpos = q_offset + torch.arange(q.shape[-2], device=q.device)
        kpos = k_offset + torch.arange(k.shape[-2], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        scores = torch.where(mask, scores, NEG_INF)
    m_new = torch.maximum(m, scores.amax(-1))
    # guard fully-masked rows: exp(NEG_INF - NEG_INF) would be 1
    alpha = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    if causal:
        p = torch.where(mask, p, 0.0)
    out = out * alpha[..., None] + torch.einsum("...qk,...kd->...qd", p, v)
    l = l * alpha + p.sum(-1)
    return out, m_new, l


def block_attn_init(q_like):
    """Zero-state (out, m, l) for block_attn_update accumulation."""
    out = torch.zeros_like(q_like)
    m = torch.full_like(q_like[..., 0], NEG_INF)
    l = torch.zeros_like(q_like[..., 0])
    return out, m, l


def block_attn_finish(out, m, l):
    """Normalize accumulated output (fully-masked rows emit zeros)."""
    safe = torch.where(l == 0.0, 1.0, l)
    return out / safe[..., None]


def _causal_nlive(q_offset: int, bq: int, block_k: int) -> int:
    """Number of K blocks at or below a q block's diagonal."""
    return (q_offset + bq - 1) // block_k + 1


def _causal_first(k_offset: int, block_q: int) -> int:
    """First q block that can see a k block (the dK/dV loop start)."""
    return k_offset // block_q


def _auto_block(s: int) -> int:
    """Largest supported block size dividing S (the JAX package's rule;
    here it picks the plain versions' blocking and, with
    ``_use_kernel``, the dense-or-flash route)."""
    for b in (512, 256, 128):
        if s % b == 0:
            return b
    return 128  # _use_kernel rejects non-128-divisible S anyway


def _use_kernel(q, k, block_q: int, block_k: int) -> bool:
    """The JAX package's routing on hardware: dense when Sq != Sk, when
    S does not divide into the blocks, or when a block is not a multiple
    of 128 (so a conf routes the same way in both packages)."""
    s = q.shape[2]
    if s != k.shape[2]:
        return False
    if s % block_q or s % block_k:
        return False
    return not (block_q % 128 or block_k % 128)


# ---------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and what the kernels are held to)
# ---------------------------------------------------------------------


def _scores(q, k, q0, k0, causal, scale):
    """Blockwise float32 scores ``q k^T * scale`` with the causal mask
    (query at absolute ``q0 + i`` sees keys at ``k0 + j`` <= it) ->
    (scores with masked entries NEG_INF, mask or None)."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if not causal:
        return s, None
    qpos = q0 + torch.arange(q.shape[1], device=q.device)
    kpos = k0 + torch.arange(k.shape[1], device=q.device)
    mask = qpos[:, None] >= kpos[None, :]
    return torch.where(mask, s, NEG_INF), mask


def flash_fwd_plain(q, k, v, causal: bool, block: int | None = None):
    """Plain version of :func:`flash_fwd`: one q block at a time against
    the keys it can see. -> (out in q's dtype, lse (BH, S) float32)."""
    bh, s, d = q.shape
    block = block or _auto_block(s)
    scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    for q0 in range(0, s, block):
        q1 = min(q0 + block, s)
        kend = q1 if causal else s
        sc, mask = _scores(q[:, q0:q1], k[:, :kend], q0, 0, causal, scale)
        m = sc.amax(-1, keepdim=True)
        p = torch.exp(sc - m)
        if mask is not None:
            p = torch.where(mask, p, 0.0)
        l = p.sum(-1, keepdim=True)
        safe = torch.where(l == 0.0, 1.0, l)
        o = torch.einsum("bqk,bkd->bqd", p, v[:, :kend].float()) / safe
        out[:, q0:q1] = o.to(q.dtype)
        lse[:, q0:q1] = (m + torch.log(safe))[..., 0]
    return out, lse


def flash_bwd_dq_plain(q, k, v, dout, lse, delta, causal: bool,
                       block: int | None = None):
    """Plain version of :func:`flash_bwd_dq`: dQ = scale * dS K with
    P = exp(S * scale - lse) and dS = P * (dO V^T - delta)."""
    bh, s, d = q.shape
    block = block or _auto_block(s)
    scale = 1.0 / math.sqrt(d)
    dq = torch.empty_like(q)
    for q0 in range(0, s, block):
        q1 = min(q0 + block, s)
        kend = q1 if causal else s
        sc, mask = _scores(q[:, q0:q1], k[:, :kend], q0, 0, causal, scale)
        p = torch.exp(sc - lse[:, q0:q1, None])
        if mask is not None:
            p = torch.where(mask, p, 0.0)
        dp = torch.einsum("bqd,bkd->bqk", dout[:, q0:q1].float(),
                          v[:, :kend].float())
        ds = p * (dp - delta[:, q0:q1, None])
        dq[:, q0:q1] = (
            torch.einsum("bqk,bkd->bqd", ds, k[:, :kend].float()) * scale
        ).to(q.dtype)
    return dq


def flash_bwd_dkv_plain(q, k, v, dout, lse, delta, causal: bool,
                        block: int | None = None):
    """Plain version of :func:`flash_bwd_dkv`: one k block at a time
    against the queries that see it. -> (dK, dV)."""
    bh, s, d = q.shape
    block = block or _auto_block(s)
    scale = 1.0 / math.sqrt(d)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    for k0 in range(0, s, block):
        k1 = min(k0 + block, s)
        qs = _causal_first(k0, block) * block if causal else 0
        sc, mask = _scores(q[:, qs:], k[:, k0:k1], qs, k0, causal, scale)
        p = torch.exp(sc - lse[:, qs:, None])
        if mask is not None:
            p = torch.where(mask, p, 0.0)
        do = dout[:, qs:].float()
        dp = torch.einsum("bqd,bkd->bqk", do, v[:, k0:k1].float())
        ds = p * (dp - delta[:, qs:, None])
        dv[:, k0:k1] = torch.einsum("bqk,bqd->bkd", p, do).to(v.dtype)
        dk[:, k0:k1] = (
            torch.einsum("bqk,bqd->bkd", ds, q[:, qs:].float()) * scale
        ).to(k.dtype)
    return dk, dv


def flash_bwd_plain(q, k, v, dout, lse, delta, causal: bool,
                    block: int | None = None):
    """Plain version of :func:`flash_bwd`: the dQ and dK/dV plain versions
    composed. -> (dQ, dK, dV)."""
    dq = flash_bwd_dq_plain(q, k, v, dout, lse, delta, causal, block)
    return (dq, *flash_bwd_dkv_plain(q, k, v, dout, lse, delta, causal,
                                     block))


# ---------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------


def fusable(seq_len: int, head_dim: int, dtype) -> str | None:
    """None if the CUDA kernels can take this geometry, else the reason."""
    if head_dim not in KERNEL_HEAD_DIMS:
        return (f"head_dim {head_dim} not in {KERNEL_HEAD_DIMS}: the "
                "kernels are compiled for these widths only")
    if seq_len % KERNEL_TILE:
        return f"seq_len {seq_len} is not a multiple of {KERNEL_TILE}"
    if dtype not in KERNEL_DTYPES:
        return (f"dtype {dtype} not in "
                f"{tuple(str(t) for t in KERNEL_DTYPES)}")
    return None


def kernel_source(name: str, dtype) -> tuple[str, str]:
    """(source under ``csrc/``, C symbol) of kernel ``name`` for inputs of
    ``dtype``: bf16 runs on the tensor cores (``flash_attention_bf16.cu``),
    float32 on the CUDA cores (``flash_attention.cu``). Raises for a name
    that type has no kernel of (``KERNEL_NAMES``)."""
    names = KERNEL_NAMES.get(dtype, ())
    if name not in names:
        raise ValueError(f"no {name} kernel for {dtype}: its kernels are "
                         f"{names}")
    if dtype == torch.bfloat16:
        return "flash_attention_bf16", f"singa_{name}_bf16"
    return "flash_attention", f"singa_{name}"


@functools.cache
def _entry(name: str, dtype):
    """The C entry point of kernel ``name`` for ``dtype`` (its library
    built at first use), with its argument types declared."""
    from .. import _build

    source, symbol = kernel_source(name, dtype)
    fn = getattr(_build.load(source), symbol)
    n_ptr = {"flash_fwd": 5, "flash_bwd_dq": 7, "flash_bwd_dkv": 8,
             "flash_bwd": 10}[name]
    fn.argtypes = (
        [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _check(name, rows, floats):
    """Shapes, devices, dtypes, contiguity and alignment of one call."""
    bh, s, d = rows[0].shape
    for t in rows:
        if tuple(t.shape) != (bh, s, d) or t.dtype != rows[0].dtype:
            raise ValueError(f"{name}: operands {[tuple(x.shape) for x in rows]}"
                             f" / {[x.dtype for x in rows]} do not match")
    for t in floats:
        if tuple(t.shape) != (bh, s) or t.dtype != torch.float32:
            raise ValueError(f"{name}: lse/delta must be float32 {(bh, s)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if len({t.device for t in (*rows, *floats)}) != 1:
        raise ValueError(f"{name}: operands on different devices")


def _launch(name, rows, floats, outs, causal):
    """Launch one kernel on the current stream; raise on anything it does
    not take or on a refused launch."""
    bh, s, d = rows[0].shape
    reason = fusable(s, d, rows[0].dtype)
    if reason is not None:
        raise ValueError(f"{name} cannot run: {reason}")
    for t in (*rows, *floats, *outs):
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned "
                             "(the kernel loads 16 bytes at a time)")
    if bh == 0:
        return
    err = _entry(name, rows[0].dtype)(
        *(t.data_ptr() for t in (*rows, *floats, *outs)),
        bh, s, d, KERNEL_DTYPES[rows[0].dtype], int(bool(causal)),
        ctypes.c_float(1.0 / math.sqrt(d)),
        torch.cuda.current_stream(rows[0].device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _no_path(name, device):
    return ValueError(f"{name}: no path for {device}")


def flash_fwd(q, k, v, causal: bool):
    """Flash forward over (BH, S, D) rows -> (out in q's dtype, lse
    (BH, S) float32)."""
    _check("flash_fwd", (q, k, v), ())
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise _no_path("flash_fwd", q.device)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _launch("flash_fwd", (q, k, v), (), (out, lse), causal)
    flash_fwd.launches += 1
    return out, lse


def _pair_only(name, q):
    """Refuse a float32 CUDA call of a bf16 pair entry."""
    if q.dtype == torch.float32:
        raise ValueError(f"{name}: float32 has no pair kernel on the card; "
                         "its backward is the fused flash_bwd")


def flash_bwd_scratch(bh: int, s: int, device) -> torch.Tensor:
    """The fused backward's zeroed int32 scratch: the head
    (``BWD_SCRATCH_HEAD``), then one counter per (bh, q tile)."""
    return torch.zeros(BWD_SCRATCH_HEAD + bh * (s // KERNEL_TILE),
                       dtype=torch.int32, device=device)


def launch_flash_bwd(q, k, v, dout, lse, delta, causal: bool):
    """One launch of the fused float32 backward on CUDA rows, counted
    nowhere -> (dq, dk, dv, scratch); ``scratch`` holds the statistics of
    ``BWD_SCRATCH_HEAD`` and the counters as the kernel left them."""
    dq = torch.zeros_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    scratch = flash_bwd_scratch(q.shape[0], q.shape[1], q.device)
    _launch("flash_bwd", (q, k, v, dout), (lse, delta),
            (dq, dk, dv, scratch), causal)
    return dq, dk, dv, scratch


def flash_bwd(q, k, v, dout, lse, delta, causal: bool):
    """(dQ, dK, dV) of flash attention over (BH, S, D) rows, given the
    forward's ``lse`` and ``delta = rowsum(dO * O)`` (both (BH, S)
    float32). float32 on the card: one launch of the fused kernel; bf16:
    the pair ``flash_bwd_dq`` + ``flash_bwd_dkv``."""
    _check("flash_bwd", (q, k, v, dout), (lse, delta))
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, dout, lse, delta, causal)
    if q.device.type != "cuda":
        raise _no_path("flash_bwd", q.device)
    if q.dtype == torch.bfloat16:
        dq = flash_bwd_dq(q, k, v, dout, lse, delta, causal)
        return (dq, *flash_bwd_dkv(q, k, v, dout, lse, delta, causal))
    dq, dk, dv, _ = launch_flash_bwd(q, k, v, dout, lse, delta, causal)
    flash_bwd.launches += 1
    return dq, dk, dv


def flash_bwd_dq(q, k, v, dout, lse, delta, causal: bool):
    """dQ of flash attention over (BH, S, D) rows, given the forward's
    ``lse`` and ``delta = rowsum(dO * O)`` (both (BH, S) float32); on the
    card bf16 only (float32 runs :func:`flash_bwd`)."""
    _check("flash_bwd_dq", (q, k, v, dout), (lse, delta))
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, dout, lse, delta, causal)
    if q.device.type != "cuda":
        raise _no_path("flash_bwd_dq", q.device)
    _pair_only("flash_bwd_dq", q)
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", (q, k, v, dout), (lse, delta), (dq,), causal)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal: bool):
    """(dK, dV) of flash attention over (BH, S, D) rows; on the card bf16
    only (float32 runs :func:`flash_bwd`)."""
    _check("flash_bwd_dkv", (q, k, v, dout), (lse, delta))
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, dout, lse, delta, causal)
    if q.device.type != "cuda":
        raise _no_path("flash_bwd_dkv", q.device)
    _pair_only("flash_bwd_dkv", q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_bwd_dkv", (q, k, v, dout), (lse, delta), (dk, dv), causal)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_bwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Forward saves (q, k, v, out, lse); backward computes
    delta = rowsum(dO * O) in float32 outside the kernels (as the JAX
    package's ``_flash_bwd`` does), then runs the backward kernels
    (:func:`flash_bwd`)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        b, h, s, d = q.shape
        rows = [t.reshape(b * h, s, d).contiguous() for t in (q, k, v)]
        out, lse = flash_fwd(*rows, causal)
        ctx.save_for_backward(*rows, out, lse)
        ctx.causal = causal
        return out.reshape(b, h, s, d)

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        bh, s, d = q.shape
        do = g.reshape(bh, s, d).to(q.dtype).contiguous()
        delta = (do.float() * out.float()).sum(-1)
        dq, dk, dv = flash_bwd(q, k, v, do, lse, delta, ctx.causal)
        shape = g.shape
        return dq.reshape(shape), dk.reshape(shape), dv.reshape(shape), None


def flash_attention(q, k, v, causal: bool = False):
    """Flash attention with the kernels forward AND backward; dense
    reference attention where the JAX package's routing at its default
    blocks would fall back (``_use_kernel`` at ``_auto_block(S)``: Sq !=
    Sk, or S not a multiple of 128).

    Training memory is O(S) per head row (out + lse residuals) instead
    of the dense O(S^2): the backward recomputes P tile by tile from
    (q, k, v, lse)."""
    if not _use_kernel(q, k, _auto_block(q.shape[2]),
                       _auto_block(k.shape[2])):
        return attention(q, k, v, causal=causal)
    return _FlashAttention.apply(q, k, v, causal)


def auto_attention(q, k, v, *, causal=False, n_devices=1):
    """Pick dense vs flash by the score tensor's footprint, the JAX
    package's rule: dense while the forward+backward float32 scores
    (B*H*S*S*8 bytes per device) are at most SINGA_TPU_DENSE_ATTN_MB
    (default 512, read on every call), flash above."""
    b, h, s, _ = q.shape
    scores_mb = b * h * s * s * 4 * 2 / 1e6 / max(1, n_devices)
    if scores_mb <= float(os.environ.get("SINGA_TPU_DENSE_ATTN_MB", "512")):
        return attention(q, k, v, causal=causal)
    return flash_attention(q, k, v, causal)
