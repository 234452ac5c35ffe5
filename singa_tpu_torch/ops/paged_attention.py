"""Paged attention: a CUDA kernel that reads K/V blocks in place
through the block table, and its plain PyTorch version.

Counterpart of ``singa_tpu/ops/paged_attention.py``, whose Pallas
kernel (``_kernel``, launched by ``_call``) this replaces on the GPU.
The serving engine's reference path gathers a dense
``(slots, heads, cache_len, head_dim)`` view of the paged pool per
layer before ``cache_attend`` runs; the kernel reads each sequence's
live blocks straight from the pool instead.

Two entry points cover the engine's three call shapes:

``paged_attention``
    write-then-read: the decode tick ``(slots, 1)`` and chunked prefill
    ``(1, chunk)``. The fresh K/V were already scattered into the pool,
    so the mask is ``cache_attend``'s: pool position <= query position.

``paged_attention_overlay``
    the speculative verify ``(slots, k+1)``: the pool is NOT written
    before acceptance is known, so the chunk's fresh K/V ride as a
    separate operand folded after the pool: pool entries strictly
    before ``positions[:, 0]``, chunk columns causal within the chunk
    and masked by ``chunk_valid``.

Masking follows the JAX kernel: masked scores are ``NEG_INF`` (-1e30,
finite) and their probabilities are set to 0 explicitly; a query row
whose every entry is masked emits zeros (the ``l == 0`` guard), where
``cache_attend`` would emit an average of garbage. No caller reads such
rows (dead slots, padding queries); the plain versions here reproduce
the kernel's rule, not ``cache_attend``'s.

Dispatch is by device and nothing else: a CUDA tensor launches the
kernel (``csrc/paged_attention.cu``) or raises; a CPU tensor takes the
plain version. Each wrapper counts its kernel launches in its
``launches`` attribute (CPU calls do not count). The kernel splits each
sequence's key range across thread blocks (``launch_geometry``, from
shapes alone); with more than one split a wrapper call is two launches,
the attention kernel and a small combine that merges the splits in a
fixed order, and counts as one.

Tables and positions must be int32 (the JAX package's index dtype, and
what the kernel reads).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from .attention import NEG_INF

#: head widths the kernel is instantiated for: each of a warp's 32 lanes
#: owns head_dim / 32 output columns, kept in registers
KERNEL_HEAD_DIMS = (64, 128)
#: warps of a thread block, and key positions of a staged tile
KERNEL_WARPS = 4
KERNEL_TILE = 32
#: thread blocks the split aims for per SM
BLOCKS_PER_SM = 2


def fusable(block_len: int, head_dim: int):
    """None if the CUDA kernel can serve this geometry, else the reason.

    The kernel stages 32 key positions per tile whatever the block
    length (each position looks up its own block), so any
    ``block_len >= 1`` works; the head width must be one it is compiled
    for. (The TPU kernel's (8, 128) tile rule does not apply here.)"""
    if block_len < 1:
        return f"kv_block_len {block_len} < 1"
    if head_dim not in KERNEL_HEAD_DIMS:
        return (
            f"head_dim {head_dim} not in {KERNEL_HEAD_DIMS}: the kernel "
            "keeps head_dim / 32 output columns per lane and is compiled "
            "for these widths only"
        )
    return None


def live_blocks(last_position, block_len, max_blocks):
    """Blocks the kernel reads for one sequence whose last attended pool
    position is ``last_position`` (= ceil((last_position + 1) /
    block_len), clipped to the table width; -1 = no pool blocks). The
    one formula shared by the kernel and ``modeled_bytes``' callers.
    Works on Python ints, numpy arrays and tensors."""
    n = (last_position + block_len) // block_len
    if isinstance(n, torch.Tensor):
        return n.clamp(0, max_blocks)
    return np.clip(n, 0, max_blocks)


def launch_geometry(n_seqs: int, n_heads: int, n_queries: int,
                    max_blocks: int, block_len: int, n_sms: int):
    """-> (rows per block, key-range splits, thread blocks) of one kernel
    call, from shapes alone (never positions: reading them would add a
    device-to-host copy per call).

    A block's 4 warps share R query rows (1 at Q = 1, 2 at Q = 2, else
    4), so every warp has work at decode. The splits aim for
    ``BLOCKS_PER_SM`` blocks per SM, capped by the table's 32-key tiles
    (more splits than tiles would only add empty ones)."""
    rows = 1 if n_queries == 1 else 2 if n_queries == 2 else KERNEL_WARPS
    base = n_seqs * n_heads * -(-n_queries // rows)
    tiles = -(-max_blocks * block_len // KERNEL_TILE)
    splits = max(1, min(-(-BLOCKS_PER_SM * n_sms // base), tiles))
    return rows, splits, base * splits


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def modeled_bytes(
    n_seqs: int, n_heads: int, n_queries: int, head_dim: int,
    block_len: int, live_blocks_total: int, *, overlay: bool = False,
    itemsize: int = 4,
) -> int:
    """The kernel's bytes for one call, each read or written once: Q in,
    the live K/V block tiles, the overlay chunk if any, and O out.
    ``live_blocks_total`` is the sum over sequences of ``live_blocks``."""
    qo = 2 * n_seqs * n_heads * n_queries * head_dim * itemsize
    kv = 2 * live_blocks_total * n_heads * block_len * head_dim * itemsize
    chunk = (
        2 * n_seqs * n_heads * n_queries * head_dim * itemsize
        if overlay else 0
    )
    return qo + kv + chunk


# ---------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and what the kernel is held to)
# ---------------------------------------------------------------------


def _gather(pool, tables):
    """(NB, H, BL, D) pool + (S, MB) tables -> (S, H, MB * BL, D) dense
    per-sequence views (the serving engine's reference path too)."""
    # table entries are allocator-issued block ids (rows beyond a
    # sequence's allocation hold the trash block 0); the clamp only keeps
    # a corrupt table from indexing out of the pool
    idx = tables.long().clamp(0, pool.shape[0] - 1)
    g = pool[idx].transpose(1, 2)               # (S, H, MB, BL, D)
    s, h, mb, bl, d = g.shape
    return g.reshape(s, h, mb * bl, d)


def _mask(positions, block_len, n_blocks, chunk_valid=None):
    """The kernel's visibility rule over ``_gather``'s first ``n_blocks``
    blocks -> (S, 1, Q, n_blocks * block_len) bool; with ``chunk_valid``
    (the overlay form) the chunk's Q columns follow the pool's.

    Write-then-read: pool position <= query position, within the
    sequence's live blocks. Overlay: pool positions strictly before
    ``positions[:, 0]``; chunk columns causal and where ``chunk_valid``."""
    cols = torch.arange(n_blocks * block_len, device=positions.device)
    if chunk_valid is None:
        live = live_blocks(positions.amax(1), block_len, n_blocks)  # (S,)
        mask = (
            (cols[None, None, :] <= positions[:, :, None])
            & (cols[None, None, :] < (live * block_len)[:, None, None])
        )
    else:
        nq = positions.shape[1]
        pool = (cols[None, None, :] < positions[:, :1, None]).expand(
            -1, nq, -1
        )
        chunk = (
            (positions[:, None, :] <= positions[:, :, None])
            & (chunk_valid != 0)[:, None, :]
        )
        mask = torch.cat([pool, chunk], dim=-1)
    return mask[:, None]


def _masked_softmax_attend(q, keys, values, mask):
    """The kernel's arithmetic in one pass: masked scores NEG_INF,
    masked probabilities exactly 0, fully-masked rows -> 0."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("shqd,shkd->shqk", q, keys) * scale
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    safe = torch.where(l == 0.0, 1.0, l)
    return torch.einsum("shqk,shkd->shqd", p, values) / safe


def paged_attention_plain(q, k_pool, v_pool, tables, positions):
    """Plain version of the write-then-read form (see
    :func:`paged_attention`)."""
    mask = _mask(positions, k_pool.shape[2], tables.shape[1])
    return _masked_softmax_attend(
        q, _gather(k_pool, tables), _gather(v_pool, tables), mask
    )


def paged_attention_overlay_plain(q, k_pool, v_pool, tables, positions,
                                  chunk_k, chunk_v, chunk_valid):
    """Plain version of the overlay form (see
    :func:`paged_attention_overlay`)."""
    mask = _mask(positions, k_pool.shape[2], tables.shape[1], chunk_valid)
    keys = torch.cat([_gather(k_pool, tables), chunk_k], dim=2)
    values = torch.cat([_gather(v_pool, tables), chunk_v], dim=2)
    return _masked_softmax_attend(q, keys, values, mask)


# ---------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------


def _check(q, k_pool, v_pool, tables, positions, chunk):
    s, h, nq, d = q.shape
    nb, hp, bl, dp = k_pool.shape
    if (hp, dp) != (h, d) or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"paged_attention: q {tuple(q.shape)} vs pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}"
        )
    if tables.dim() != 2 or tables.shape[0] != s:
        raise ValueError(f"paged_attention: tables {tuple(tables.shape)} "
                         f"for {s} sequences")
    if tuple(positions.shape) != (s, nq):
        raise ValueError(f"paged_attention: positions "
                         f"{tuple(positions.shape)} != {(s, nq)}")
    for name, t in (("tables", tables), ("positions", positions)):
        if t.dtype != torch.int32:
            raise TypeError(f"paged_attention: {name} must be int32, "
                            f"got {t.dtype}")
    if chunk is not None:
        ck, cv, valid = chunk
        if ck.shape != q.shape or cv.shape != q.shape:
            raise ValueError("paged_attention_overlay: chunk K/V must "
                             f"match q {tuple(q.shape)}")
        if tuple(valid.shape) != (s, nq):
            raise ValueError("paged_attention_overlay: chunk_valid "
                             f"{tuple(valid.shape)} != {(s, nq)}")
    tensors = [q, k_pool, v_pool, tables, positions] + list(chunk or ())
    if len({t.device for t in tensors}) != 1:
        raise ValueError("paged_attention: operands on different devices")


@functools.cache
def _kernel():
    """The C entry point of ``csrc/paged_attention.cu`` (built at first
    use), with its argument types declared."""
    from .. import _build

    fn = _build.load("paged_attention").singa_paged_attention
    fn.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
        + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k_pool, v_pool, tables, positions, chunk):
    """Launch the CUDA kernel on the current stream; raise on anything
    it does not take or on a refused launch."""
    s, h, nq, d = q.shape
    nb, _, bl, _ = k_pool.shape
    reason = fusable(bl, d)
    if reason is not None:
        raise ValueError(f"paged_attention cannot run: {reason}")
    floats = [q, k_pool, v_pool]
    if chunk is not None:
        floats += [chunk[0], chunk[1]]
    for t in floats:
        if t.dtype != torch.float32:
            raise TypeError(f"paged_attention: the kernel takes float32, "
                            f"got {t.dtype}")
    ints = [tables, positions]
    if chunk is not None:
        valid = chunk[2].to(torch.int32).contiguous()
        ints.append(valid)
    for t in floats + ints:
        if not t.is_contiguous():
            raise ValueError("paged_attention: operands must be contiguous")
    for t in floats:
        if t.data_ptr() % 16:
            raise ValueError("paged_attention: float operands must be "
                             "16-byte aligned (the kernel loads float4)")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if chunk is not None:
        ck, cv = chunk[0].data_ptr(), chunk[1].data_ptr()
        cvalid = valid.data_ptr()
    else:
        ck = cv = cvalid = None
    mb = tables.shape[1]
    rows, splits, _ = launch_geometry(s, h, nq, mb, bl,
                                      _sm_count(q.device.index))
    # each split's unnormalized (acc, m, l) per query row
    part = (torch.empty(s * h * nq * splits * (d + 2), device=q.device)
            if splits > 1 else None)
    err = _kernel()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), positions.data_ptr(), ck, cv, cvalid,
        out.data_ptr(), None if part is None else part.data_ptr(),
        s, h, nq, d, nb, bl, mb, 1 if chunk is not None else 0, rows,
        splits, ctypes.c_float(1.0 / math.sqrt(d)),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    return out


def paged_attention(q, k_pool, v_pool, tables, positions):
    """Masked paged attention, write-then-read form.

    ``q`` (S, H, Q, D) float32 queries at absolute ``positions`` (S, Q)
    int32; ``k_pool``/``v_pool`` (n_blocks, H, block_len, D) pools
    already holding every attended entry; ``tables`` (S, max_blocks)
    int32 block ids. -> (S, H, Q, D), allclose to
    ``cache_attend(q, gather(k_pool), gather(v_pool), positions)`` on
    every row with at least one visible entry, without the gather."""
    _check(q, k_pool, v_pool, tables, positions, None)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, tables, positions)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no path for {q.device}")
    out = _launch(q, k_pool, v_pool, tables, positions, None)
    paged_attention.launches += 1
    return out


def paged_attention_overlay(q, k_pool, v_pool, tables, positions,
                            chunk_k, chunk_v, chunk_valid):
    """Masked paged attention with the fresh chunk overlaid: the verify
    tick's no-pool-write form (KV rewind by construction).

    ``chunk_k``/``chunk_v`` (S, H, Q, D) hold the K/V of the chunk's own
    positions (column jj lives at ``positions[s, jj]``); ``chunk_valid``
    (S, Q) marks real columns. Pool entries are attended strictly
    before ``positions[:, 0]``; the pool is never written."""
    chunk = (chunk_k, chunk_v, chunk_valid)
    _check(q, k_pool, v_pool, tables, positions, chunk)
    if q.device.type == "cpu":
        return paged_attention_overlay_plain(
            q, k_pool, v_pool, tables, positions, *chunk
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_overlay: no path for {q.device}")
    out = _launch(q, k_pool, v_pool, tables, positions, chunk)
    paged_attention_overlay.launches += 1
    return out


paged_attention.launches = 0
paged_attention_overlay.launches = 0
