"""Serving-tier load harness for the PyTorch port: continuous batching
vs one-at-a-time, speculative vs one-token ticks.

The counterpart of ``singa_tpu/tools/serve_bench.py``'s core arm. It
drives a deterministic request workload (prompts from ``--seed``)
through the port's serving tier (serve/engine.py + serve/scheduler.py)
and prints one JSON line last::

  {"tokens_per_s": .., "p50_ms": .., "p99_ms": .., "speedup": ..,
   "token_mismatches": .., "device": .., "pass": .., ...}

Default arm: the measured engine at ``--concurrency`` slots against the
same stack at ``slots=1`` (one stream at a time). ``speedup`` is the
measured tokens/s over that baseline; ``--threshold`` gates it.

``--speculate_k K`` (> 0): the measured engine runs n-gram-drafted
verify ticks emitting up to K+1 tokens per slot per tick, against
one-token ticks at the same concurrency; ``speedup`` is then
speculative over one-token tokens/s, gated by ``--spec_threshold``. Use
``--workload repeat`` (prompts tiling a short motif, the drafter's home
turf).

``--workload shared_prefix`` benchmarks the PREFIX CACHE: every prompt
is one common prefix (``prompt_len - min(4, prompt_len // 4)`` tokens, a
system prompt) and a unique tail. Warm admission (cache on, seeded by
two throwaway requests of the first prompt: the second is a
whole-prompt hit, so the COW path is warm too) runs against cold
admission (cache off, every prompt prefilled whole) on the same engine
shape. Or-gate (``--prefix_threshold``, default 1.5): warm tokens/s at
least that multiple of cold, OR prefill chunks executed down at least
2x (a counter, so it holds whatever the host's timing). Streams must
equal the cold run's either way. ``--prefix_cache`` turns the cache on
in the other arms too.

Baselines always attend through ``reference`` (gather +
``cache_attend``), so the stream check (``token_mismatches`` must be 0)
doubles as a fused-vs-reference check when ``--kernels fused``.

Runs on the GPU by default; ``--device cpu`` runs the plain PyTorch
versions on the CPU (times are then the CPU's, and ``device`` says so).

Usage::

  python -m singa_tpu_torch.tools.serve_bench [--concurrency 8]
      [--requests 16] [--d_model 256] [--n_layers 2] [--n_heads 4]
      [--vocab 256] [--max_len 128] [--prompt_len 8] [--max_new 48]
      [--block_len 16] [--kv_blocks 0] [--prefill_chunk 16]
      [--speculate_k K] [--workload random|repeat|shared_prefix]
      [--prefix_cache] [--prefix_threshold 1.5]
      [--kernels fused|reference] [--device cuda|cpu] [--no_gate]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models.transformer import TransformerConfig, init_lm
from ..serve import Engine, EngineConfig, Request, Scheduler


def _percentile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="serve_bench", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--concurrency", type=int, default=8,
                    help="serving slots (decode batch width)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--threshold", type=float, default=2.0,
                    help="min tokens/sec speedup over slots=1")
    ap.add_argument("--d_model", type=int, default=256)
    ap.add_argument("--n_layers", type=int, default=2)
    ap.add_argument("--n_heads", type=int, default=4)
    ap.add_argument("--d_ff", type=int, default=1024)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--max_len", type=int, default=128)
    ap.add_argument("--prompt_len", type=int, default=8)
    ap.add_argument("--max_new", type=int, default=48)
    ap.add_argument("--block_len", type=int, default=16)
    ap.add_argument("--kv_blocks", type=int, default=0)
    ap.add_argument("--prefill_chunk", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--speculate_k", type=int, default=0,
                    help="> 0: benchmark speculative decode at this draft "
                    "width against the one-token tick")
    ap.add_argument("--spec_threshold", type=float, default=1.3,
                    help="min speculative tokens/sec over the one-token "
                    "tick")
    ap.add_argument("--workload", default="random",
                    choices=("random", "repeat", "shared_prefix"),
                    help="prompt shape: 'repeat' tiles a short motif, the "
                    "n-gram drafter's home turf; 'shared_prefix' is one "
                    "common prefix and a unique tail, the prefix cache's "
                    "gate")
    ap.add_argument("--prefix_cache", action="store_true",
                    help="prefix cache on in the measured engine (implied "
                    "by --workload shared_prefix)")
    ap.add_argument("--prefix_threshold", type=float, default=1.5,
                    help="min warm tokens/sec over cold on shared_prefix "
                    "(or-gated with a >= 2x drop in prefill chunks)")
    ap.add_argument("--kernels", default="fused",
                    choices=("fused", "reference"),
                    help="attention on the measured engine: 'fused' = the "
                    "CUDA paged-attention kernel (its plain version on the "
                    "CPU), 'reference' = gather + cache_attend")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' must be asked "
                    "for)")
    ap.add_argument("--no_gate", action="store_true",
                    help="report only; never fail on the threshold")
    return ap


def _token_mismatches(ref_sched, sched) -> int:
    """Streams that differ between a reference run and the measured run,
    matched by rid (a rid missing from either side counts)."""
    got = {r.rid: r.tokens for r in sched.finished}
    return sum(
        1 for r in ref_sched.finished if got.get(r.rid) != r.tokens
    )


def _workload(args) -> list[np.ndarray]:
    """Deterministic prompts of ``--prompt_len`` tokens; ``repeat``
    tiles a per-request 4-token motif; ``shared_prefix`` draws one common
    prefix first (only for that workload, so the others' prompts stay
    as they were) and a unique tail per request."""
    rs = np.random.RandomState(args.seed)
    prompts = []
    if args.workload == "shared_prefix":
        tail = max(1, min(4, args.prompt_len // 4))
        prefix = rs.randint(0, args.vocab, size=(args.prompt_len - tail,))
    for _ in range(args.requests):
        if args.workload == "repeat":
            motif = rs.randint(0, args.vocab, size=(4,))
            pr = np.tile(motif, args.prompt_len // 4 + 1)[:args.prompt_len]
        elif args.workload == "shared_prefix":
            pr = np.concatenate(
                [prefix, rs.randint(0, args.vocab, size=(tail,))])
        else:
            pr = rs.randint(0, args.vocab, size=(args.prompt_len,))
        prompts.append(pr.astype(np.int32))
    return prompts


def run_continuous(params, cfg, prompts, args, slots, device, spec_k=0,
                   kernels="reference", prefix_cache=False):
    """The serving stack at ``slots`` concurrency (slots=1 is the
    one-at-a-time baseline), warmed with a throwaway request (kernel
    build, allocator and library start-up stay out of the timed run).
    With ``prefix_cache`` a second throwaway of the same prompt is a
    whole-prompt hit (the COW path runs before the timed run too), and
    the first prompt's blocks stay cached: the measured requests admit
    into a warm pool. -> (scheduler, elapsed_s)."""
    engine = Engine(
        params, cfg,
        EngineConfig(
            slots=slots,
            kv_block_len=args.block_len,
            kv_blocks=args.kv_blocks,
            max_prefill_chunk=args.prefill_chunk,
            spec_k=spec_k,
            prefix_cache=prefix_cache,
            attend_impl=kernels,
        ),
        device=device,
    )
    sched = Scheduler(engine)
    for rid in ((-1, -2) if prefix_cache else (-1,)):
        sched.submit(Request(rid=rid, prompt=np.asarray(prompts[0]),
                             max_new_tokens=2))
        sched.serve()
    sched.reset_counters()
    engine.allocator.peak_used = engine.allocator.used_blocks
    for i, pr in enumerate(prompts):
        sched.submit(Request(rid=i, prompt=pr, max_new_tokens=args.max_new,
                             seed=args.seed + i))
    t0 = time.perf_counter()
    sched.serve()
    return sched, time.perf_counter() - t0


def _tokens_per_s(sched, seconds) -> float:
    # + the first token of each request, sampled at activation
    tokens = sched.tokens_emitted + len(sched.finished)
    return round(tokens / seconds, 1) if seconds > 0 else 0.0


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = TransformerConfig(
        vocab=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=args.d_ff, max_len=args.max_len,
    )
    params = init_lm(torch.Generator().manual_seed(args.seed), cfg, device)
    prompts = _workload(args)
    shared = args.workload == "shared_prefix"
    spec = args.speculate_k > 0 and not shared

    # the baseline: one stream at a time; one-token ticks at the same
    # concurrency under speculation; cold admission (cache off) on the
    # same engine shape for shared_prefix. Always the reference attend
    base, base_s = run_continuous(
        params, cfg, prompts, args,
        slots=args.concurrency if spec or shared else 1, device=device,
        spec_k=args.speculate_k if shared else 0,
    )
    sched, serve_s = run_continuous(
        params, cfg, prompts, args, slots=args.concurrency, device=device,
        spec_k=args.speculate_k, kernels=args.kernels,
        prefix_cache=shared or args.prefix_cache,
    )
    lat = sorted(r.latency_s * 1e3 for r in sched.finished)
    out = {
        "device": (
            torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device)
        ),
        "concurrency": args.concurrency,
        "kernels": args.kernels,
        "requests": args.requests,
        "finished": len(sched.finished),
        "tokens": sched.tokens_emitted + len(sched.finished),
        "serve_s": round(serve_s, 4),
        "tokens_per_s": _tokens_per_s(sched, serve_s),
        "p50_ms": round(_percentile(lat, 0.50), 2),
        "p99_ms": round(_percentile(lat, 0.99), 2),
        **sched.occupancy(),
        "base_tokens_per_s": _tokens_per_s(base, base_s),
        # identity is the hard bar: throughput from wrong tokens is none
        "token_mismatches": _token_mismatches(base, sched),
    }
    out["speedup"] = (
        round(out["tokens_per_s"] / out["base_tokens_per_s"], 3)
        if out["base_tokens_per_s"] else None
    )
    threshold = (args.spec_threshold if spec else args.prefix_threshold
                 if shared else args.threshold)
    if spec:
        out["spec_k"] = args.speculate_k
    elif shared:
        out["prefill_chunks_cold"] = base.prefill_chunks
        out["prefill_chunks_warm"] = sched.prefill_chunks
        out["prefill_chunk_ratio"] = (
            round(base.prefill_chunks / sched.prefill_chunks, 3)
            if sched.prefill_chunks else None
        )
    else:
        # steady-state capacity: full-occupancy decode ticks only
        steady = (sched.full_tick_tokens / sched.full_tick_s
                  if sched.full_tick_s > 0 else 0.0)
        out["steady_tokens_per_s"] = round(steady, 1)
    out["threshold"] = threshold
    if shared:
        # or-gate: end-to-end warm over cold where prefill dominates; the
        # executed-chunk drop is the deterministic arm
        out["pass_mode"] = (
            "end_to_end" if (out["speedup"] or 0) >= threshold
            else "prefill_chunks"
            if (out["prefill_chunk_ratio"] or 0) >= 2.0 else None
        )
        out["pass"] = (
            out["token_mismatches"] == 0
            and out.get("prefix_hit_rate", 0) > 0
            and out["pass_mode"] is not None
        )
    else:
        out["pass"] = (
            out["token_mismatches"] == 0
            and (out["speedup"] or 0) >= threshold
        )
    print(json.dumps(out))
    if args.no_gate:
        return 0 if out["token_mismatches"] == 0 else 1
    return 0 if out["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
