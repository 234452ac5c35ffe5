"""The quantized gradient ring: int8 on the wire, one controller for
every rank.

Counterpart of ``singa_tpu/ops/quantized_collective.py``. The JAX ring
runs per shard inside ``shard_map``: every rank executes the same
program and indexes its chunks by its own position on the data axis.
Here one Python process holds a list with one entry per rank (a dict of
tensors on that rank's device) and runs each hop for every rank in
turn. What moves between ranks goes through :func:`ppermute` alone:
rank r receives what rank (r - 1) mod n sent, copied to rank r's device
(cloned when both ranks share a device, so no rank ever aliases
another's tensor). A process-per-GPU transport replaces that one
function and leaves the ring as it is.

  bucket rows      each param's gradient is chunked over the n ranks
                   (``chunk_dims``), and a bucket's chunks are laid out
                   once per rank as one float32 (n, C) tensor: row j
                   holds chunk j of every param of the bucket, flattened,
                   in bucket order. Every step below runs on whole rows,
                   so a hop is one quantize, one send and one
                   :func:`quant_acc` launch per rank and bucket, whatever
                   the number of params in the bucket.
  reduce-scatter   at hop t every rank quantizes its accumulated row to
                   int8 with one symmetric max-abs scale, sends the bytes
                   and the scale one hop, and :func:`quant_acc`
                   dequantizes what arrived and adds the rank's own
                   float32 row of that chunk (rank r starts at chunk r-1
                   and adds chunk r-t-2 at hop t, so after n-1 hops it
                   holds the sum of chunk r). Where the sum feeds another
                   scale, the same launch returns its max-abs, so the next
                   scale needs no pass of its own over the row.
  owner quantize   the owner adds its error-feedback residual in float32,
                   quantizes the finished sum once and banks the exact
                   quantization error as the next step's residual (the
                   per-hop rounding errors are not fed back: the JAX
                   package's documented trade).
  allgather        the (int8 bytes, scale) pairs ride n-1 more hops and
                   every rank dequantizes the same bytes with the same
                   scale, so the reduced gradient is bitwise identical on
                   every rank.

``hier=(K, M)`` is the hierarchical ``q8_hier`` ring in its factored
form (``ring { intra_degree: K }``): rank r = g*K + p, a float32
reduce-scatter among the K ranks of a group, the quantized ring above
among the M groups (the "inter" hop, through :func:`quant_acc` too),
then a two-level allgather of the bytes. Chunk granularity stays n, so
residual layouts are those of the flat ring of the same width.

Scales stay device tensors from end to end: nothing here reads a value
back to the host, so the ring never waits for the device. The scale is
one per bucket, max is exact, and every element goes through the same
operations as on per-param chunks, so the row layout changes no bit of
the result and no byte on the wire.

Dispatch of :func:`quant_acc` is by device and nothing else: a CUDA
tensor launches the kernel of ``csrc/quant_acc.cu`` or raises; a CPU
tensor takes :func:`quant_acc_plain`. Launches are counted in
``quant_acc.launches`` (CPU calls do not count).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

#: int8 symmetric range: q in [-127, 127], scale = max|e| / 127 (shared
#: with parallel/collectives.py's reference quantized path)
INT8_MAX = 127.0

#: scale floor: an all-zero bucket must not divide by zero
_SCALE_FLOOR = 1e-30

#: the TPU kernel's (8, 128) float32 tile; ring_fusable keeps its floor so
#: both packages accept the same confs (the CUDA kernel has none)
_SUBLANE, _LANE = 8, 128


# ---------------------------------------------------------------------------
# shared quantize/dequantize helpers
# ---------------------------------------------------------------------------


def _const(like: torch.Tensor, value: float) -> torch.Tensor:
    """A float32 scalar on ``like``'s device (made once per device and
    value; nothing writes to it). Dividing by a Python number would let
    PyTorch's CUDA division multiply by its reciprocal, which rounds
    differently from the CPU's true division."""
    return _const_on(like.device, value)


@functools.cache
def _const_on(device: torch.device, value: float) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=device)


def scale_from_amax(amax: torch.Tensor) -> torch.Tensor:
    """The symmetric int8 scale of a bucket whose max-abs is ``amax`` (a
    float32 0-d tensor): floored away from zero, over 127. A NaN max
    gives a NaN scale (``torch.maximum`` propagates NaN)."""
    return (torch.maximum(amax, _const(amax, _SCALE_FLOOR))
            / _const(amax, INT8_MAX))


def symmetric_scale(arrays) -> torch.Tensor:
    """One symmetric int8 scale for a bucket: max-abs over every array
    in it, floored away from zero. Max is exactly associative, so the
    scale does not depend on layout; a NaN/Inf element poisons it
    (``torch.maximum`` propagates NaN), the guard's contract."""
    return scale_from_amax(functools.reduce(
        torch.maximum, (a.float().abs().max() for a in arrays)
    ))


def quantize_int8(e: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 cast: round(e / scale) (half to even, as
    ``jnp.round``), clipped to [-127, 127]."""
    return torch.clamp(
        torch.round(e.float() / scale), -INT8_MAX, INT8_MAX
    ).to(torch.int8)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 wire value back to float32: q * scale (NaN scale -> NaN)."""
    return q.float() * scale


def wire_cast(e: torch.Tensor, scale, dtype: str) -> torch.Tensor:
    """Cast ``e`` to the wire dtype (int8 with ``scale``, or bf16)."""
    if dtype == "int8":
        return quantize_int8(e, scale)
    return e.to(torch.bfloat16)


def wire_uncast(w: torch.Tensor, scale, dtype: str) -> torch.Tensor:
    if dtype == "int8":
        return dequantize_int8(w, scale)
    return w.float()


# ---------------------------------------------------------------------------
# geometry predicates (the JAX package's, so both accept the same confs)
# ---------------------------------------------------------------------------


def ring_reducible(
    shapes: dict, ndata: int, chunk_dims: dict | None = None
) -> str | None:
    """None if the ring can chunk every gradient over an ``ndata``-wide
    data axis, else the reason it cannot. ``shapes`` maps param name ->
    shape; ``chunk_dims`` maps name -> the dim the ring chunks (default
    0). The ring sends fixed equal chunks, so the chunk dim must divide
    evenly."""
    if ndata <= 1:
        return None
    for name in sorted(shapes):
        shape = tuple(shapes[name])
        if not shape:
            return (
                f"param {name!r} is a scalar: the ring cannot chunk a "
                "0-d gradient over the data axis"
            )
        d = (chunk_dims or {}).get(name, 0)
        if shape[d] % ndata:
            return (
                f"param {name!r} dim {d} ({shape[d]}) not divisible by "
                f"the data-axis width {ndata}: the ring's bucket "
                "chunking cannot split it into equal wire chunks"
            )
    return None


def ring_fusable(
    shapes: dict, ndata: int, chunk_dims: dict | None = None,
    interpret: bool = True,
) -> str | None:
    """None if the JAX package's compiled (Mosaic) per-hop kernel could
    serve this geometry, else the reason: with ``interpret`` off each
    chunk must align to the TPU's (8, 128) float32 tile. The port's CUDA
    kernel takes any chunk; the predicate stays so that a conf the JAX
    package refuses (``kernels { interpret: false }`` on untileable
    geometry) is refused here too."""
    reason = ring_reducible(shapes, ndata, chunk_dims)
    if reason is not None:
        return reason
    if interpret or ndata <= 0:
        return None
    tile = _SUBLANE * _LANE
    for name in sorted(shapes):
        shape = tuple(shapes[name])
        d = (chunk_dims or {}).get(name, 0)
        elems = shape[d] // max(1, ndata)
        for i, s in enumerate(shape):
            if i != d:
                elems *= s
        if elems % tile:
            return (
                f"param {name!r} ring chunk has {elems} elements, not a "
                f"multiple of the ({_SUBLANE}, {_LANE}) f32 tile: the "
                "compiled quantize+accumulate kernel cannot tile it"
            )
    return None


def hier_ring_geometry(widths, ring, *, data_axis: str = "data"):
    """Resolve the two-level ring geometry for ``q8_hier``: ``(intra_axis,
    inter_axis, K, M)`` when the mesh admits the factorization, else the
    reason string (the JAX package's predicate, word for word).
    ``widths`` maps mesh axis -> width; ``ring`` is the conf's ``ring {}``
    block (or None). Factored form: ``intra_degree: K`` splits the data
    axis into M = n/K groups of K adjacent ranks. Named form:
    ``intra_axis`` / ``inter_axis`` name two mesh axes."""
    widths = {k: int(v) for k, v in (widths or {}).items()}
    intra = getattr(ring, "intra_axis", "") if ring is not None else ""
    inter = getattr(ring, "inter_axis", "") if ring is not None else ""
    degree = int(getattr(ring, "intra_degree", 0) or 0)
    if not degree and not intra and not inter:
        return (
            "kernels { grad_allreduce: q8_hier } needs a ring {} block "
            "declaring the two-level geometry: intra_degree to factor "
            "the data axis, or intra_axis/inter_axis naming mesh axes"
        )
    if degree and (intra or inter):
        return (
            "ring { intra_degree } and ring { intra_axis/inter_axis } "
            "are mutually exclusive: the factored form splits the data "
            "axis itself, the named form rides two real mesh axes"
        )
    if degree:
        n = widths.get(data_axis, 1)
        others = sorted(
            a for a, wd in widths.items() if a != data_axis and wd > 1
        )
        if others:
            return (
                f"ring {{ intra_degree: {degree} }} factors the "
                f"{data_axis!r} axis only, but the mesh also shards "
                + ", ".join(f"{a!r} (width {widths[a]})" for a in others)
                + " — name the extra axis with ring { intra_axis/"
                "inter_axis } if the reduction should ride it"
            )
        if n <= 1:
            return (data_axis, data_axis, 1, 1)
        if degree > n or n % degree:
            return (
                f"ring {{ intra_degree: {degree} }} does not divide the "
                f"{data_axis!r} axis width {n}: the two-level "
                "factorization needs n = intra_degree * inter groups"
            )
        return (data_axis, data_axis, degree, n // degree)
    if not intra or not inter:
        return (
            "ring { intra_axis/inter_axis } must name BOTH axes (got "
            f"intra_axis={intra!r}, inter_axis={inter!r}) — or use "
            "intra_degree to factor the data axis"
        )
    if intra == inter:
        return (
            f"ring {{ intra_axis: {intra!r} }} and inter_axis name the "
            "same mesh axis — use intra_degree to factor one axis"
        )
    for role, ax in (("intra_axis", intra), ("inter_axis", inter)):
        if ax not in widths:
            return (
                f"ring {{ {role}: {ax!r} }} names no mesh axis "
                f"(mesh axes: {', '.join(sorted(widths)) or 'none'})"
            )
    if widths.get(data_axis, 1) > 1 and data_axis not in (intra, inter):
        return (
            f"the {data_axis!r} axis (width {widths[data_axis]}) is "
            "not covered by ring { intra_axis/inter_axis } — the "
            "gradient reduction must include every data shard"
        )
    leftovers = sorted(
        a for a, wd in widths.items()
        if wd > 1 and a not in (intra, inter)
    )
    if leftovers:
        return (
            "mesh axes "
            + ", ".join(f"{a!r} (width {widths[a]})" for a in leftovers)
            + " are >1-wide but outside the ring { intra_axis/"
            "inter_axis } factorization — the two-level ring covers "
            "exactly two axes"
        )
    return (intra, inter, widths[intra], widths[inter])


# ---------------------------------------------------------------------------
# the per-hop kernel: dequantize + accumulate
# ---------------------------------------------------------------------------


def quant_acc_plain(q: torch.Tensor, scale: torch.Tensor,
                    local: torch.Tensor, *, amax: bool = False):
    """``dequantize_int8(q, scale) + local``: the multiply and the add
    rounded separately, as the kernel does them. With ``amax``, also
    max |out| as a float32 0-d tensor (0 for an empty ``out``; NaN if any
    element is NaN) -> ``(out, amax)``."""
    out = q.float() * scale + local
    if not amax:
        return out
    if out.numel() == 0:
        return out, torch.zeros((), dtype=torch.float32, device=out.device)
    return out, out.abs().max()


@functools.cache
def _kernel():
    """The C entry point of ``csrc/quant_acc.cu`` (built at first use),
    with its argument types declared."""
    from .. import _build

    fn = _build.load("quant_acc").singa_quant_acc
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(q: torch.Tensor, scale: torch.Tensor, local: torch.Tensor,
            amax: bool):
    """One launch of the kernel on CUDA operands that :func:`quant_acc`
    has checked -> ``out`` or ``(out, amax)``."""
    out = torch.empty_like(local)
    mx = (torch.empty((), dtype=torch.float32, device=local.device)
          if amax else None)
    err = _kernel()(
        q.data_ptr(), scale.data_ptr(), local.data_ptr(), out.data_ptr(),
        None if mx is None else mx.data_ptr(), local.numel(),
        torch.cuda.current_stream(local.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"quant_acc kernel launch failed: CUDA error {err}")
    return out if mx is None else (out, mx)


def quant_acc(q: torch.Tensor, scale: torch.Tensor, local: torch.Tensor,
              *, amax: bool = False):
    """``float(q) * scale + local`` elementwise -> a new float32 tensor
    of ``local``'s shape: the ring's per-hop step. ``q`` int8 and
    ``local`` float32 of one shape, both contiguous; ``scale`` a
    one-element float32 tensor; all on one device. With ``amax``, also
    max |out| as a float32 0-d tensor on that device, from the same pass
    -> ``(out, amax)``. A CUDA tensor launches the kernel (one read of
    the int8 chunk and of the local partial, one write); a CPU tensor
    takes :func:`quant_acc_plain`."""
    if q.dtype != torch.int8 or local.dtype != torch.float32:
        raise ValueError(f"quant_acc: q must be int8 and local float32, got "
                         f"{q.dtype} and {local.dtype}")
    if scale.dtype != torch.float32 or scale.numel() != 1:
        raise ValueError("quant_acc: scale must be one float32 element")
    if q.shape != local.shape:
        raise ValueError(f"quant_acc: q {tuple(q.shape)} and local "
                         f"{tuple(local.shape)} differ in shape")
    if len({q.device, scale.device, local.device}) != 1:
        raise ValueError("quant_acc: operands on different devices")
    if not (q.is_contiguous() and local.is_contiguous()):
        raise ValueError("quant_acc: q and local must be contiguous")
    if local.device.type == "cpu":
        return quant_acc_plain(q, scale, local, amax=amax)
    if local.device.type != "cuda":
        raise ValueError(f"quant_acc: no path for {local.device}")
    got = _launch(q, scale, local, amax)
    quant_acc.launches += 1
    return got


quant_acc.launches = 0


# ---------------------------------------------------------------------------
# the exchange between ranks
# ---------------------------------------------------------------------------


def ppermute(xs: list, perm, level: str = "data") -> list:
    """One collective permute over the ranks: for each ``(src, dst)`` of
    ``perm``, rank ``dst`` receives a copy of ``xs[src]`` on its own
    device (the device of ``xs[dst]``). Every copy is a new tensor,
    also between ranks on one device. The bytes each rank sends are
    added to ``ppermute.sent_bytes[(level, src)]``."""
    out = [None] * len(xs)
    for src, dst in perm:
        x = xs[src]
        out[dst] = x.to(xs[dst].device, copy=True)
        ppermute.sent_bytes[(level, src)] += x.numel() * x.element_size()
    return out


ppermute.sent_bytes = collections.Counter()


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------


def _chunked(x: torch.Tensor, d: int, n: int) -> torch.Tensor:
    """(..., S[d], ...) -> (n, S[d]//n, ...rest), chunk dim moved to the
    front, contiguous (a view of ``x`` when ``d`` is 0)."""
    y = torch.movedim(x, d, 0)
    return y.reshape((n, y.shape[0] // n) + tuple(y.shape[1:])).contiguous()


def _unchunk(y: torch.Tensor, d: int, shape) -> torch.Tensor:
    """Inverse of ``_chunked``: (n, c, ...rest) -> the original shape."""
    z = y.reshape((y.shape[0] * y.shape[1],) + tuple(y.shape[2:]))
    return torch.movedim(z, 0, d).reshape(shape)


def _bucket_table(grads: dict, bucket, chunk_dims: dict, n: int) -> list:
    """Where each param of ``bucket`` lies in a bucket row: ``[(name,
    offset, size, chunk shape)]`` in bucket order, the chunk shape that of
    ``_chunked(g, d, n)[j]``."""
    table, offset = [], 0
    for nm in bucket:
        shape = list(grads[nm].shape)
        d = chunk_dims[nm]
        chunk = (shape[d] // n,) + tuple(shape[:d] + shape[d + 1:])
        size = math.prod(chunk)
        table.append((nm, offset, size, chunk))
        offset += size
    return table


def _bucket_rows(grads: dict, table: list, chunk_dims: dict,
                 n: int) -> torch.Tensor:
    """One rank's bucket as a float32 (n, C) tensor: row j holds chunk j
    of every param of ``table``, flattened, in table order."""
    return torch.cat([_chunked(grads[nm], chunk_dims[nm], n)
                      .reshape(n, -1).float() for nm, *_ in table], dim=1)


def _hop(acc: list, local: list, perm, dtype: str, level: str,
         scales: list | None = None, fused: bool = False):
    """One reduce hop for every rank: quantize the accumulated row (one
    scale per rank: ``scales`` if given, else its max-abs), send bytes
    and scale along ``perm``, then dequantize what arrived and add the
    local row. -> (new rows, next scales): with ``fused`` the kernel also
    returns each new row's max-abs and the next hop's scales come from it
    (bitwise those :func:`symmetric_scale` would give), else None."""
    if dtype != "int8":
        moved = ppermute([wire_cast(a, None, dtype) for a in acc], perm,
                         level)
        return [wire_uncast(w, None, dtype) + x
                for w, x in zip(moved, local)], None
    if scales is None:
        scales = [symmetric_scale([a]) for a in acc]
    moved = ppermute([wire_cast(a, s, dtype) for a, s in zip(acc, scales)],
                     perm, level)
    scales = ppermute(scales, perm, level)
    got = [quant_acc(w, s, x, amax=fused)
           for w, s, x in zip(moved, scales, local)]
    if not fused:
        return got, None
    return [o for o, _ in got], [scale_from_amax(m) for _, m in got]


def _hier_perms(K: int, M: int):
    """(intra, inter) permutations of the factored ring, rank g*K + p:
    the intra ring among a group's K ranks, the inter ring among the M
    ranks of one intra position."""
    intra = [(g * K + j, g * K + (j + 1) % K)
             for g in range(M) for j in range(K)]
    inter = [(g * K + j, ((g + 1) % M) * K + j)
             for g in range(M) for j in range(K)]
    return intra, inter


def _hier_reduce_scatter(rows: list, K: int, M: int, dtype: str,
                         fuse_last: bool):
    """Two-level reduce-scatter over bucket rows (per rank (n, C)) ->
    (each rank's sum of its own chunk g*K + p, the flat ring's
    post-scatter state; that sum's scales if the last hop fused them).

    Level 1 (intra, float32 on the wire): view the n = K*M rows
    piece-major as (K, M, C), piece j holding every row at intra position
    j, and reduce-scatter the K pieces within the group: after K-1 hops
    rank (g, p) holds the group's sum of piece p, an (M, C) plane. Level
    2 (inter, int8 on the wire): the flat ring's hop over the M rows of
    that plane; every hop but the last fuses the next scale, the last
    one too with ``fuse_last``."""
    iperm, xperm = _hier_perms(K, M)
    pieces = [torch.swapaxes(x.reshape(M, K, -1), 0, 1).contiguous()
              for x in rows]
    acc = [pc[(r % K - 1) % K] for r, pc in enumerate(pieces)]
    for t in range(K - 1):
        moved = ppermute(acc, iperm, "intra")
        acc = [moved[r] + pc[(r % K - t - 2) % K]
               for r, pc in enumerate(pieces)]
    out = [a[(r // K - 1) % M] for r, a in enumerate(acc)]
    scales = None
    for t in range(M - 1):
        local = [a[(r // K - t - 2) % M] for r, a in enumerate(acc)]
        out, scales = _hop(out, local, xperm, dtype, "inter", scales,
                           fused=t < M - 2 or fuse_last)
    return out, scales


def _allgather(fq: list, fscale: list, deq: list, dtype: str) -> list:
    """Flat allgather of the owner-quantized (bytes, scale) rows -> per
    rank the (n, C) float32 bucket rows in chunk order. Rank r writes what
    arrives at hop t into row (r - t - 1) mod n."""
    n = len(fq)
    perm = [(j, (j + 1) % n) for j in range(n)]
    bufs = [[None] * n for _ in range(n)]
    for r in range(n):
        bufs[r][r] = deq[r]
    w, s = fq, fscale
    for t in range(n - 1):
        w = ppermute(w, perm)
        if dtype == "int8":
            s = ppermute(s, perm)
        for r in range(n):
            bufs[r][(r - t - 1) % n] = wire_uncast(w[r], s[r], dtype)
    return [torch.stack(b) for b in bufs]


def _hier_allgather(fq: list, fscale: list, K: int, M: int,
                    dtype: str) -> list:
    """Two-level allgather of the owner-quantized (bytes, scale) rows:
    the inter ring collects the M rows at this rank's intra position,
    then the intra ring carries the (M, C) byte plane and its M scales
    around the group whole. Every rank dequantizes the same bytes with
    the same scales. -> per rank the (n, C) float32 bucket rows in chunk
    order."""
    n = K * M
    iperm, xperm = _hier_perms(K, M)
    int8 = dtype == "int8"
    planes = [[None] * M for _ in range(n)]
    scales = [[None] * M for _ in range(n)]
    for r in range(n):
        planes[r][r // K] = fq[r]
        scales[r][r // K] = fscale[r]
    w, s = fq, fscale
    for t in range(M - 1):
        w = ppermute(w, xperm, "inter")
        if int8:
            s = ppermute(s, xperm, "inter")
        for r in range(n):
            idx = (r // K - t - 1) % M
            planes[r][idx] = w[r]
            scales[r][idx] = s[r]
    w = [torch.stack(p) for p in planes]
    s = [torch.stack(sc) for sc in scales] if int8 else [None] * n
    big = [[None] * K for _ in range(n)]
    bigs = [[None] * K for _ in range(n)]
    for r in range(n):
        big[r][r % K] = w[r]
        bigs[r][r % K] = s[r]
    for t in range(K - 1):
        w = ppermute(w, iperm, "intra")
        if int8:
            s = ppermute(s, iperm, "intra")
        for r in range(n):
            idx = (r % K - t - 1) % K
            big[r][idx] = w[r]
            bigs[r][idx] = s[r]
    out = []
    for r in range(n):
        f = torch.stack(big[r]).float()  # (K, M, C)
        if int8:
            f = f * torch.stack(bigs[r]).reshape(K, M, 1)
        # [j, g] holds row g*K + j -> chunk-index order (n, C)
        out.append(torch.swapaxes(f, 0, 1).reshape(n, -1))
    return out


def ring_reduce_gradients(
    grads: list,
    residuals: list,
    buckets: tuple,
    *,
    chunk_dims: dict,
    dtype: str = "int8",
    error_feedback: bool = True,
    residual_key=None,
    hier: tuple | None = None,
) -> tuple[list, list]:
    """The quantized ring all-reduce over n ranks -> (per rank reduced
    grads, per rank new error-feedback residual chunks).

    ``grads[r]`` are rank r's local partials, each on r's device and
    pre-scaled so that the sum over ranks is the wanted reduction (the
    Trainer divides its local-batch mean grads by n). ``residuals[r]``
    hold rank r's own chunk of each param's residual, keyed by
    ``residual_key(name)``, in the param's dim order (chunk r of dim
    ``chunk_dims[name]``). ``buckets`` are the reverse-topo groups of
    ``parallel.collectives.reverse_topo_buckets``: one wire scale per
    bucket per hop. Buckets run in their order, which in eager PyTorch is
    the issue order; the JAX package's optimization_barrier chain has
    nothing to add here. Inside the ring each bucket is one (n, C) row
    tensor per rank (the module's docstring); grads and residuals go in
    and come out per param.

    The reduced grads are dequantized from the same (bytes, scale) pairs
    on every rank, so they are bitwise identical across ranks.
    ``hier = (K, M)`` with K*M == n runs the factored two-level ring."""
    n = len(grads)
    perm = [(j, (j + 1) % n) for j in range(n)]
    if hier is not None and hier[0] * hier[1] != n:
        raise ValueError(f"hier geometry {hier[0]}x{hier[1]} does not "
                         f"match {n} ranks")
    banks = error_feedback and residual_key is not None
    int8 = dtype == "int8"
    out = [{} for _ in range(n)]
    new_res = [{} for _ in range(n)]
    for bucket in buckets:
        table = _bucket_table(grads[0], bucket, chunk_dims, n)
        rows = [_bucket_rows(g, table, chunk_dims, n) for g in grads]
        # the owner scales the finished sum as it is unless it adds a
        # residual first: then the last reduce hop's max-abs is of use
        if hier is not None:
            acc, scales = _hier_reduce_scatter(rows, *hier, dtype,
                                               fuse_last=not banks)
        else:
            acc = [x[(r - 1) % n] for r, x in enumerate(rows)]
            scales = None
            for t in range(n - 1):
                local = [x[(r - t - 2) % n] for r, x in enumerate(rows)]
                acc, scales = _hop(acc, local, perm, dtype, "data", scales,
                                   fused=t < n - 2 or not banks)
        if banks:
            acc = [a + torch.cat([
                       torch.movedim(residuals[r][residual_key(nm)].float(),
                                     chunk_dims[nm], 0).reshape(-1)
                       for nm, *_ in table])
                   for r, a in enumerate(acc)]
            scales = None
        if not int8:
            fscale = [None] * n
        elif scales is not None:
            fscale = scales
        else:
            fscale = [symmetric_scale([a]) for a in acc]
        fq = [wire_cast(a, s, dtype) for a, s in zip(acc, fscale)]
        deq = [wire_uncast(w, s, dtype) for w, s in zip(fq, fscale)]
        if banks:
            for r in range(n):
                err = acc[r] - deq[r]
                for nm, off, size, chunk in table:
                    new_res[r][residual_key(nm)] = torch.movedim(
                        err[off:off + size].reshape(chunk), 0,
                        chunk_dims[nm])
        if n == 1:
            full = [deq[0][None]]
        elif hier is not None:
            full = _hier_allgather(fq, fscale, *hier, dtype)
        else:
            full = _allgather(fq, fscale, deq, dtype)
        for r in range(n):
            for nm, off, size, chunk in table:
                g = grads[r][nm]
                out[r][nm] = _unchunk(
                    full[r][:, off:off + size].reshape((n,) + chunk),
                    chunk_dims[nm], g.shape).to(g.dtype)
    return out, new_res


# ---------------------------------------------------------------------------
# wire-bytes accounting
# ---------------------------------------------------------------------------


def _wire_itemsize(dtype: str) -> int:
    return 1 if dtype == "int8" else 2


def modeled_wire_bytes(sizes: dict, buckets: tuple, ndata: int, *,
                       dtype: str = "int8") -> int:
    """Per-rank bytes the flat ring sends in one step: n-1 (chunk +
    scale) payloads per bucket in the reduce phase and n-1 more in the
    allgather. ``sizes`` maps param name -> element count. The tests
    hold it equal to what :func:`ppermute` counts."""
    if ndata <= 1:
        return 0
    w = _wire_itemsize(dtype)
    scale_bytes = 4 if dtype == "int8" else 0
    total = 0
    for bucket in buckets:
        chunk = sum(sizes[nm] // ndata for nm in bucket)
        total += 2 * (ndata - 1) * (chunk * w + scale_bytes)
    return total


def modeled_wire_bytes_levels(sizes: dict, buckets: tuple, ndata: int, *,
                              intra_degree: int, dtype: str = "int8"
                              ) -> dict:
    """Per-rank, per-level bytes the hierarchical ring sends in one step:
    ``{"intra": ..., "inter": ..., "total": ...}``. Per bucket with chunk
    = sum(sizes)/n, K = intra_degree, M = n/K: the intra reduce sends
    (K-1) (M, chunk) float32 planes; the inter reduce and the inter
    gather (M-1) (chunk wire bytes + scale) each; the intra gather (K-1)
    (M chunks of wire bytes + M scales)."""
    if ndata <= 1:
        return {"intra": 0, "inter": 0, "total": 0}
    K = max(1, int(intra_degree))
    if ndata % K:
        raise ValueError(
            f"intra_degree {K} does not divide ndata {ndata}"
        )
    M = ndata // K
    w = _wire_itemsize(dtype)
    scale_bytes = 4 if dtype == "int8" else 0
    intra = inter = 0
    for bucket in buckets:
        chunk = sum(sizes[nm] // ndata for nm in bucket)
        intra += (K - 1) * M * chunk * 4
        inter += 2 * (M - 1) * (chunk * w + scale_bytes)
        intra += (K - 1) * (M * chunk * w + M * scale_bytes)
    return {
        "intra": int(intra),
        "inter": int(inter),
        "total": int(intra + inter),
    }


def reference_wire_bytes(sizes: dict, ndata: int) -> int:
    """Per-rank bytes of a bandwidth-optimal float32 ring all-reduce of
    the same gradients: 2(n-1)/n * 4E for E elements (reduce-scatter +
    allgather), the reference path's collective."""
    if ndata <= 1:
        return 0
    total_elems = sum(sizes.values())
    return int(2 * (ndata - 1) * total_elems * 4 / ndata)
