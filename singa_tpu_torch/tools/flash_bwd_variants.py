"""Time design variants of the flash kernels against the source as it
stands, on the card, in turns: the tensor-core kernels of
``csrc/flash_attention_bf16.cu`` (forward, dQ and dK/dV; the default) or
the float32 forward of ``csrc/flash_attention.cu`` (``--source
flash_attention``).

Each variant is the source with a few text substitutions. bf16
(``VARIANTS``):

  paired     causal tiles nt-1-p and p in one block (nt + 1 tile steps
             each, grid halved) instead of one tile per block, heaviest
             first
  exp2f      exp2f in place of the bare ex2.approx.ftz (``fast_exp2``)
  diag_mask  the causal mask applied on the diagonal tile only: a masked
             and an unmasked copy of the elementwise step
  fwd_groups the forward with one key group (4 warps) a block where the
             source has two (8 warps; each folds every other key tile)

float32 forward (``F32_VARIANTS``):

  one_group  one key group a block (4 warps an SM, the same tiles and
             copies) where the source has two
  wide_groups key groups of 256 threads (16 warps an SM, at most 128
             registers a thread; 4 q rows x 4 keys of scores and 4 rows x
             D/16 output columns a thread) where the source's have 128
  expf       the scores scaled first and e^(x - m) as expf (the source
             keeps raw scores and takes exp2f of one FMA with scale *
             log2(e) folded in)
  key_lanes8 8 lanes a q row where the source has 16: 4 rows x 8 keys of
             scores and 4 rows x D/8 output columns a thread (8 x 4 and
             8 x D/16 in the source); every operand load one shared
             wavefront, but more bytes loaded an FMA
  scores_unroll2, pv_unroll2  the score product's loop over D, or PV's
             over the keys, unrolled 2 times (4 in the source)
  mask_every_tile the causal mask's compare and select on every key
             tile (the source applies it on the diagonal tile only)
  bh_major   blocks numbered heaviest first within each bh (all of bh 0,
             then bh 1, ...) instead of heaviest first over every bh

Every library is built with the port's nvcc flags and its ptxas
register and spill lines printed; every variant's outputs (out and lse,
dQ, dK and dV) are held to the plain versions (chip_smoke's bar of the
type, ``FLASH_TOL``) and compared bitwise with the source's; then each
kernel is timed at each shape with chip_smoke's ``time_ms`` (CUDA
events, the L2 flushed before each launch) in the order source,
variants, variants reversed, source. One JSON line per (shape, kernel);
the first line is the card's name and power limit.

Run from the repository root (it imports ``chip_smoke``) on a machine
with the GPU::

  python -m singa_tpu_torch.tools.flash_bwd_variants [--source NAME]
      [--variants paired ...] [--shapes 2x8192x128x1 ...] [--iters 10]

A shape is B*H x S x D x causal.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import os
import subprocess
import sys

import torch

from .. import _build
from ..device import resolve_device
from ..ops import attention as ta

SOURCE = "flash_attention_bf16"
#: kernel -> its pointer arguments (inputs and outputs)
KERNELS = {"flash_fwd": 5, "flash_bwd_dq": 7, "flash_bwd_dkv": 8}
_FWD_GROUPS = "constexpr int kFwdGroups = 2;"
_DQ_TILE = ("  const int qt = nt - 1 - (int)blockIdx.x;"
            "  // heaviest causal tiles first\n")
_DKV_TILE = ("  const int kt = (int)blockIdx.x;"
             "  // causal: key tile 0 sees every q tile\n")
_PAIR_LOOP = ("  const int pb = (int)blockIdx.x;\n"
              "  for (int pass = 0;"
              " pass < (CAUSAL && pb != nt - 1 - pb ? 2 : 1); ++pass) {\n")
_DQ_END = ("  if (wn == 0)"
           " store_rows<D>(dq + base, q0 + 16 * wm, acc, scale);\n}\n")
_DKV_END = ("    store_rows<D>(dv + base, k0 + 16 * wm, dv_acc, 1.f);\n"
            "  }\n}\n")
_GRID = "kern<<<dim3(S / kTile, BH), kThreads, smem, st>>>("
_DQ_STEP = "    const int c0 = kt * kTile + 32 * wn + 2 * t;\n"
_DQ_STEP_END = ("        s[j][e] = p * (dp[j][e] - (e < 2 ? del0 : del1));\n"
                "      }\n")
_DKV_STEP = "    float ds[4][4];\n"
_DKV_STEP_END = "        ds[j][e] = p * (dpt[j][e] - dc);\n      }\n    }\n"
_MASKED = "[&](auto masked) {\n"
#: name -> [(old, new, count)] substitutions on the source
VARIANTS = {
    "paired": [
        (_DQ_TILE, _PAIR_LOOP + "  const int qt = CAUSAL && pass == 0"
                   " ? nt - 1 - pb : pb;\n", 1),
        (_DQ_END, _DQ_END[:-2] + "  __syncthreads();\n  }\n}\n", 1),
        (_DKV_TILE, _PAIR_LOOP + "  const int kt = CAUSAL && pass == 0"
                    " ? nt - 1 - pb : pb;\n", 1),
        (_DKV_END, _DKV_END[:-2] + "  __syncthreads();\n  }\n}\n", 1),
        (_GRID, "kern<<<dim3(C ? (S / kTile + 1) / 2 : S / kTile, BH), "
                "kThreads, smem, st>>>(", 2),
    ],
    "exp2f": [("ok ? fast_exp2(", "ok ? exp2f(", 2)],
    "diag_mask": [
        (_DQ_STEP, _DQ_STEP + "    auto step = " + _MASKED, 1),
        (_DQ_STEP_END, _DQ_STEP_END + "    };\n    if (CAUSAL && kt == qt)"
                       " step(std::true_type{});\n"
                       "    else step(std::false_type{});\n", 1),
        (_DKV_STEP, _DKV_STEP + "    auto step = " + _MASKED, 1),
        (_DKV_STEP_END, _DKV_STEP_END + "    };\n    if (CAUSAL && qt == kt)"
                        " step(std::true_type{});\n"
                        "    else step(std::false_type{});\n", 1),
        ("const bool ok = !CAUSAL || col",
         "const bool ok = !decltype(masked)::value || col", 2),
    ],
    "fwd_groups": [(_FWD_GROUPS, _FWD_GROUPS.replace("2", "1"), 1)],
}
_F32_ROW = "  const FwdThread th(lt);\n"
_F32_SC = ("  const float sc = scale * 1.4426950408889634f;"
           "  // e^x = 2^(x log2(e))\n")
_F32_MASK = "          s[i][j] = ok ? s[i][j] : kNegInf;\n"
#: the float32 forward's variants: name -> [(old, new, count)]
F32_VARIANTS = {
    "one_group": [("constexpr int kFwdGroups = 2;",
                   "constexpr int kFwdGroups = 1;", 1)],
    "wide_groups": [("constexpr int kFwdGroupThreads = 128;",
                     "constexpr int kFwdGroupThreads = 256;", 1)],
    "key_lanes8": [("constexpr int kFwdKeyLanes = 16;",
                    "constexpr int kFwdKeyLanes = 8;", 1)],
    "scores_unroll2": [("#pragma unroll 4\n  for (int d = 0; d < D; d += 4) {\n"
                        "    float4 av[kFwdRows]",
                        "#pragma unroll 2\n  for (int d = 0; d < D; d += 4) {\n"
                        "    float4 av[kFwdRows]", 1)],
    "pv_unroll2": [("#pragma unroll 4\n  for (int kk = 0; kk < kTile; kk += 4) {\n"
                    "    float4 pv[kFwdRows];",
                    "#pragma unroll 2\n  for (int kk = 0; kk < kTile; kk += 4) {\n"
                    "    float4 pv[kFwdRows];", 1)],
    "expf": [
        (_F32_ROW + _F32_SC, _F32_ROW, 1),
        (_F32_MASK, _F32_MASK.replace("s[i][j] :", "s[i][j] * scale :"), 1),
        ("const float alpha = exp2f((m[i] - m_new) * sc);",
         "const float alpha = expf(m[i] - m_new);", 1),
        ("ok ? exp2f(fmaf(s[i][j], sc, -m_new * sc)) : 0.f;",
         "ok ? expf(s[i][j] - m_new) : 0.f;", 1),
        ("const float a0 = exp2f((m[i] - mm) * sc),"
         " a1 = exp2f((m1 - mm) * sc);",
         "const float a0 = expf(m[i] - mm), a1 = expf(m1 - mm);", 1),
        ("lse[(size_t)bh * S + r] = m[i] * scale + logf(safe);",
         "lse[(size_t)bh * S + r] = m[i] + logf(safe);", 1),
    ],
    "mask_every_tile": [
        ("    if (CAUSAL && kt == qt) softmax(std::true_type{});\n"
         "    else softmax(std::false_type{});\n",
         "    softmax(std::integral_constant<bool, CAUSAL>{});\n", 1)],
    "bh_major": [("const int qt = nt - 1 - t / BH, bh = t % BH;",
                  "const int qt = nt - 1 - t % nt, bh = t / nt;", 1)],
}
#: source -> (its variants, the dtype of its kernels, the kernels varied)
SOURCES = {
    SOURCE: (VARIANTS, torch.bfloat16, KERNELS),
    "flash_attention": (F32_VARIANTS, torch.float32, {"flash_fwd": 5}),
}
DEFAULT_SHAPES = ("2x8192x128x1", "8x8192x128x1", "2x32768x128x1",
                  "2x8192x64x1")


def variant_source(name: str, src: str, variants=VARIANTS) -> str:
    """The source with variant ``name``'s substitutions from ``variants``
    (each must match exactly as often as listed)."""
    for old, new, count in variants[name]:
        if src.count(old) != count:
            raise ValueError(f"variant {name}: {old!r} occurs "
                             f"{src.count(old)} times, not {count}")
        src = src.replace(old, new)
    return src


def build(names, source=SOURCE):
    """nvcc for ``source`` and each of its variants, all at once ->
    ({name: entries in KERNELS order}, {name: nvcc log}); 'source' is the
    source as it stands."""
    variants, dtype, kernels = SOURCES[source]
    with open(os.path.join(_build.CSRC_DIR, f"{source}.cu")) as f:
        src = f.read()
    texts = {"source": src,
             **{n: variant_source(n, src, variants) for n in names}}
    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        digest = hashlib.sha256(text.encode()).hexdigest()[:16]
        cu = os.path.join(out_dir, f"{name}-{digest}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = cu[:-3] + ".so"
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    entries, logs = {}, {}
    for name, (lib, proc) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n"
                               f"{logs[name]}")
        dll = ctypes.CDLL(lib)
        fns = []
        for kernel, n_ptr in kernels.items():
            fn = getattr(dll, ta.kernel_source(kernel, dtype)[1])
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            fns.append(fn)
        entries[name] = tuple(fns)
    return entries, logs


def caller(fn, kernel, c):
    """A closure launching one library's ``kernel`` on chip_smoke's
    flash case ``c`` -> its outputs."""
    bh, s, d = c["q"].shape
    if kernel == "flash_fwd":
        ins = [c[n] for n in ("q", "k", "v")]
        outs = [torch.empty_like(c["q"]),
                torch.empty((bh, s), device=c["q"].device)]
    else:
        ins = [c[n] for n in ("q", "k", "v", "do", "lse", "delta")]
        outs = [torch.empty_like(c["q"])
                for _ in range(1 if kernel == "flash_bwd_dq" else 2)]

    def call():
        err = fn(*(t.data_ptr() for t in (*ins, *outs)), bh, s, d,
                 ta.KERNEL_DTYPES[c["q"].dtype],
                 int(c["causal"]), ctypes.c_float(1 / math.sqrt(d)),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{kernel}: CUDA error {err}")
        return outs

    return call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", default=SOURCE, choices=list(SOURCES))
    ap.add_argument("--variants", nargs="+")
    ap.add_argument("--shapes", nargs="+", default=list(DEFAULT_SHAPES))
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    from chip_smoke import FLASH_TOL, flash_calls, flash_case, flash_ops, \
        ptxas_report, time_ms

    variants, dtype, kernels = SOURCES[args.source]
    names = args.variants or list(variants)
    unknown = set(names) - set(variants)
    if unknown:
        ap.error(f"no variants {sorted(unknown)} of {args.source}")
    tol = FLASH_TOL[dtype]
    dev = resolve_device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip())
    entries, logs = build(names, args.source)
    ptxas_report(logs)
    order = ["source", *names, *names[::-1], "source"]
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    for shape in args.shapes:
        bh, s, d, causal = (int(x) for x in shape.split("x"))
        c = flash_case(bh, s, d, bool(causal), dtype, dev, gen)
        for i, kernel in enumerate(kernels):
            plain = flash_calls(c)[kernel][1]()
            plain = plain if isinstance(plain, tuple) else (plain,)
            calls = {n: caller(entries[n][i], kernel, c) for n in entries}
            got = {n: [t.clone() for t in call()]
                   for n, call in calls.items()}
            again = {n: [t.clone() for t in call()]
                     for n, call in calls.items()}
            torch.cuda.synchronize()
            for n, outs in got.items():
                for o, w in zip(outs, plain):
                    rel = float((o.float() - w.float()).abs().max()
                                / w.float().abs().max())
                    if not rel <= tol:
                        raise RuntimeError(f"{n} {kernel} {shape}: error "
                                           f"{rel} > {tol}")
                if not all(torch.equal(a, b) for a, b in zip(outs, again[n])):
                    raise RuntimeError(f"{n} {kernel} {shape}: two launches "
                                       "on the same inputs differ")
            ms = {}
            for n in order:
                ms.setdefault(n, []).append(
                    time_ms(calls[n], flush, args.iters))
            ops = flash_ops(kernel, c)
            print(json.dumps({
                "shape": [bh, s, d, causal], "kernel": kernel,
                "dtype": str(dtype)[6:], "ms": ms,
                "tflops": {n: ops / min(t) / 1e9 for n, t in ms.items()},
                "bitwise_equal_to_source": {
                    n: all(torch.equal(a, b)
                           for a, b in zip(outs, got["source"]))
                    for n, outs in got.items()},
            }), flush=True)
        del c
    return 0


if __name__ == "__main__":
    sys.exit(main())
