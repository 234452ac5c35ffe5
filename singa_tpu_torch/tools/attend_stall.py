"""Fused-paged-attention gate: reference vs kernel decode ticks plus a
modeled attention-bytes comparison.

The PyTorch counterpart of ``singa_tpu/tools/attend_stall.py``: the same
flags, defaults, thresholds and JSON keys. It measures the serving
engine's hot path two ways on the SAME weights, workload and pool
geometry:

  wall clock   interleaved best-of-trials decode-tick timing on two
               fully-occupied engines, ``attend_impl`` ``reference``
               (gather + ``cache_attend``) against ``fused`` (the CUDA
               paged-attention kernel, ``ops/paged_attention.py``): the
               end-to-end arm.
  bytes model  the attention seam's memory traffic per decode tick per
               layer. The fused side is the kernel's own model
               (``ops.paged_attention.modeled_bytes``: Q + the live K/V
               block tiles + O, with the ``live_blocks`` clamp). The
               reference side is a count of what the plain path moves
               (``reference_bytes``): the gather reads the live blocks
               and writes the dense ``(slots, H, cache_len, D)`` view of
               K and of V, the attend reads both views, and Q is read
               and O written once. The JAX tool prices the reference
               side with XLA's cost analysis; the port has no XLA, so
               ``fused_xla_bytes`` is null here.

Or-gate: fused decode tokens/sec >= ``--threshold`` (default 1.1) x
reference, OR the modeled attention-bytes drop >= ``--bytes_threshold``
(default 2.0). Token streams must be IDENTICAL between the two engines
either way: a kernel may only move bytes, never a token.

On a CUDA device the fused engine launches the kernel (the count is
``ops.paged_attention.paged_attention.launches``) or raises; with
``--device cpu`` both engines take plain PyTorch.

Usage::

  python -m singa_tpu_torch.tools.attend_stall [--concurrency 8]
      [--d_model 256] [--n_layers 2] [--n_heads 2] [--vocab 256]
      [--max_len 128] [--block_len 16] [--prefill_chunk 16]
      [--requests 8] [--max_new 16] [--trials 3] [--ticks 10]
      [--threshold 1.1] [--bytes_threshold 2.0] [--no_gate]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .collective_stall import sync


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="attend_stall", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--d_model", type=int, default=256)
    ap.add_argument("--n_layers", type=int, default=2)
    ap.add_argument("--n_heads", type=int, default=2)
    ap.add_argument("--d_ff", type=int, default=1024)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--max_len", type=int, default=128)
    ap.add_argument("--block_len", type=int, default=16)
    ap.add_argument("--kv_blocks", type=int, default=0)
    ap.add_argument("--prefill_chunk", type=int, default=16)
    ap.add_argument("--prompt_len", type=int, default=8)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max_new", type=int, default=16)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--ticks", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threshold", type=float, default=1.1,
                    help="min fused/reference decode tokens/sec (the "
                    "end-to-end or-gate arm)")
    ap.add_argument("--bytes_threshold", type=float, default=2.0,
                    help="min reference/fused modeled attention-bytes "
                    "ratio (the deterministic or-gate arm)")
    ap.add_argument("--no_gate", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' must be asked "
                    "for)")
    return ap


def _serving(args, impl):
    from ..serve import EngineConfig

    return EngineConfig(
        slots=args.concurrency,
        kv_block_len=args.block_len,
        kv_blocks=args.kv_blocks,
        max_prefill_chunk=args.prefill_chunk,
        attend_impl=impl,
    )


def _filled_engine(params, cfg, args, impl, device):
    """An engine with every slot admitted, prefilled and live: the
    full-occupancy steady state the decode-tick probe times."""
    from ..serve import Engine

    engine = Engine(params, cfg, _serving(args, impl), device=device)
    rs = np.random.RandomState(args.seed)
    plen = min(args.prompt_len, max(1, cfg.max_len // 4))
    for s in range(args.concurrency):
        pr = rs.randint(0, args.vocab, size=(plen,)).astype(np.int32)
        engine.admit(s, cfg.max_len)
        last = engine.prefill_chunk(s, pr, 0)
        engine.activate(s, last, plen, seed=s)
    return engine, plen


def reference_bytes(n_seqs: int, n_heads: int, head_dim: int,
                    block_len: int, max_blocks: int, live_blocks_total: int,
                    *, itemsize: int = 4) -> int:
    """Bytes the reference attend moves for one decode tick of one layer,
    each read or write counted once:

      gather   reads the ``live_blocks_total`` live blocks of K and of V
               (``2 * live * H * block_len * D``) and writes the dense
               views ``(slots, H, cache_len, D)`` of K and V, with
               ``cache_len = max_blocks * block_len``
               (``2 * slots * H * cache_len * D``);
      attend   reads both dense views (``2 * slots * H * cache_len * D``),
               reads Q and writes O (``2 * slots * H * D``).

    All times ``itemsize`` (float32: 4)."""
    cache_len = max_blocks * block_len
    live = 2 * live_blocks_total * n_heads * block_len * head_dim
    view = 2 * n_seqs * n_heads * cache_len * head_dim
    qo = 2 * n_seqs * n_heads * head_dim
    return (live + 2 * view + qo) * itemsize


def measure_attend_bytes(params, cfg, args, device=None):
    """Modeled memory traffic of the attention seam for ONE decode tick
    of ONE layer at the probe's cache fill. -> dict with the gated
    ``bytes_ratio`` (reference count / fused model) and the
    transparency numbers. Deterministic: arithmetic on the workload and
    the pool's geometry, no clocks."""
    from ..ops.paged_attention import live_blocks, modeled_bytes

    engine, plen = _filled_engine(params, cfg, args, "reference", device)
    s, h, d = args.concurrency, cfg.n_heads, cfg.head_dim
    bl = engine.pool.block_len
    mb = engine.pool.max_blocks_per_seq
    itemsize = engine.params["embed/tok"].element_size()
    # mid-generation cache fill: the steady state a serving pool sits at
    # (derived from the workload, not measured)
    fill = plen + args.max_new // 2
    live_total = int(s * int(live_blocks(fill, bl, mb)))
    ref = reference_bytes(s, h, d, bl, mb, live_total, itemsize=itemsize)
    fused_model = modeled_bytes(s, h, 1, d, bl, live_total,
                                itemsize=itemsize)
    return {
        "ref_bytes": float(ref),
        "fused_bytes": float(fused_model),
        "fused_xla_bytes": None,
        "bytes_ratio": round(ref / fused_model, 3)
        if fused_model else None,
        "cache_fill": int(fill),
        "live_blocks": live_total,
    }


def measure_decode_ticks(params, cfg, args, device=None):
    """Interleaved best-of-trials decode-tick wall times on two
    fully-occupied engines (reference vs fused): the end-to-end arm.
    -> dict(ref_tick_ms, fused_tick_ms, speedup, ticks)."""
    ref, plen = _filled_engine(params, cfg, args, "reference", device)
    fus, _ = _filled_engine(params, cfg, args, "fused", device)
    dev = ref.device
    # every probe tick advances pos by one; fit warm + trials windows
    ticks = max(1, min(
        args.ticks, (cfg.max_len - plen - 2) // (2 * args.trials)
    ))
    for e in (ref, fus):
        e.decode()
    sync(dev)
    best = {"ref": float("inf"), "fused": float("inf")}
    for _ in range(args.trials):
        for name, e in (("ref", ref), ("fused", fus)):
            t0 = time.perf_counter()
            for _ in range(ticks):
                e.decode()
            sync(dev)
            best[name] = min(best[name], time.perf_counter() - t0)
    return {
        "ref_tick_ms": round(best["ref"] / ticks * 1e3, 3),
        "fused_tick_ms": round(best["fused"] / ticks * 1e3, 3),
        "speedup": round(best["ref"] / best["fused"], 3)
        if best["fused"] > 0 else None,
        "ticks": ticks,
    }


def streams(params, cfg, args, impl, device=None):
    """The full serving workload (interleaved ragged admits/retires)
    under ``impl``: the token-identity oracle run. -> {rid: tokens}."""
    from ..serve import Engine, Request, Scheduler

    engine = Engine(params, cfg, _serving(args, impl), device=device)
    sched = Scheduler(engine)
    rs = np.random.RandomState(args.seed + 1)
    for i in range(args.requests):
        plen = int(rs.randint(3, max(4, args.prompt_len + 1)))
        pr = rs.randint(0, args.vocab, size=(plen,)).astype(np.int32)
        sched.submit(Request(
            rid=i, prompt=pr,
            max_new_tokens=int(rs.randint(4, args.max_new + 1)),
        ))
    sched.serve()
    return {r.rid: list(r.tokens) for r in sched.finished}


def model_config(args):
    """The probe's TransformerConfig from the flags."""
    from ..models.transformer import TransformerConfig

    return TransformerConfig(
        vocab=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=args.d_ff, max_len=args.max_len,
    )


def run(params, cfg, args, device=None) -> dict:
    """Every arm on ``params`` -> the JSON dict ``main`` prints."""
    out = {"concurrency": args.concurrency, "block_len": args.block_len}
    out.update(measure_attend_bytes(params, cfg, args, device))
    out.update(measure_decode_ticks(params, cfg, args, device))
    ref_streams = streams(params, cfg, args, "reference", device)
    fused_streams = streams(params, cfg, args, "fused", device)
    out["token_mismatches"] = sum(
        1 for rid, toks in ref_streams.items()
        if fused_streams.get(rid) != toks
    )
    out["threshold"] = args.threshold
    out["bytes_threshold"] = args.bytes_threshold
    out["pass_mode"] = (
        "end_to_end"
        if (out["speedup"] or 0) >= args.threshold
        else "bytes"
        if (out["bytes_ratio"] or 0) >= args.bytes_threshold
        else None
    )
    out["pass"] = (
        out["token_mismatches"] == 0 and out["pass_mode"] is not None
    )
    return out


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from ..device import resolve_device
    from ..models.transformer import init_lm

    dev = resolve_device(args.device)
    cfg = model_config(args)
    params = init_lm(torch.Generator().manual_seed(args.seed), cfg, dev)
    out = run(params, cfg, args, dev)
    print(json.dumps(out))
    if args.no_gate:
        return 0
    return 0 if out["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
