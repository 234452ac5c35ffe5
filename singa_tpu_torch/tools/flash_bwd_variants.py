"""Time design variants of the tensor-core flash kernels (forward, dQ
and dK/dV of ``csrc/flash_attention_bf16.cu``) against the source as it
stands, on the card, in turns.

Each variant is the source with a few text substitutions (``VARIANTS``):

  paired     causal tiles nt-1-p and p in one block (nt + 1 tile steps
             each, grid halved) instead of one tile per block, heaviest
             first
  exp2f      exp2f in place of the bare ex2.approx.ftz (``fast_exp2``)
  diag_mask  the causal mask applied on the diagonal tile only: a masked
             and an unmasked copy of the elementwise step
  fwd_groups the forward with one key group (4 warps) a block where the
             source has two (8 warps; each folds every other key tile)

Every library is built with the port's nvcc flags; every variant's
outputs (out and lse, dQ, dK and dV) are held to the plain versions
(chip_smoke's bf16 bar, ``FLASH_TOL``) and compared bitwise with the
source's; then each kernel
is timed at each shape with chip_smoke's ``time_ms`` (CUDA events, the
L2 flushed before each launch) in the order source, variants, variants
reversed, source. One JSON line per (shape, kernel); the first line is
the card's name and power limit.

Run from the repository root (it imports ``chip_smoke``) on a machine
with the GPU::

  python -m singa_tpu_torch.tools.flash_bwd_variants [--variants paired ...]
      [--shapes 2x8192x128x1 ...] [--iters 10]

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
DEFAULT_SHAPES = ("2x8192x128x1", "8x8192x128x1", "2x32768x128x1",
                  "2x8192x64x1")


def variant_source(name: str, src: str) -> str:
    """The source with variant ``name``'s substitutions (each must match
    exactly as often as listed)."""
    for old, new, count in VARIANTS[name]:
        if src.count(old) != count:
            raise ValueError(f"variant {name}: {old!r} occurs "
                             f"{src.count(old)} times, not {count}")
        src = src.replace(old, new)
    return src


def build(names):
    """nvcc for the source and each variant, all at once -> {name:
    (forward, dQ, dK/dV entries)}; 'source' is the source as it
    stands."""
    with open(os.path.join(_build.CSRC_DIR, f"{SOURCE}.cu")) as f:
        src = f.read()
    texts = {"source": src, **{n: variant_source(n, src) for n in names}}
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
    entries = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        dll = ctypes.CDLL(lib)
        fns = []
        for kernel, n_ptr in KERNELS.items():
            fn = getattr(dll, ta.kernel_source(kernel, torch.bfloat16)[1])
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            fns.append(fn)
        entries[name] = tuple(fns)
    return entries


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
        err = fn(*(t.data_ptr() for t in (*ins, *outs)), bh, s, d, 1,
                 int(c["causal"]), ctypes.c_float(1 / math.sqrt(d)),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{kernel}: CUDA error {err}")
        return outs

    return call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=list(VARIANTS))
    ap.add_argument("--shapes", nargs="+", default=list(DEFAULT_SHAPES))
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    from chip_smoke import FLASH_TOL, flash_calls, flash_case, flash_ops, \
        time_ms

    tol = FLASH_TOL[torch.bfloat16]
    dev = resolve_device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip())
    entries = build(args.variants)
    order = ["source", *args.variants, *args.variants[::-1], "source"]
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    for shape in args.shapes:
        bh, s, d, causal = (int(x) for x in shape.split("x"))
        c = flash_case(bh, s, d, bool(causal), torch.bfloat16, dev, gen)
        for i, kernel in enumerate(KERNELS):
            plain = flash_calls(c)[kernel][1]()
            plain = plain if isinstance(plain, tuple) else (plain,)
            calls = {n: caller(entries[n][i], kernel, c) for n in entries}
            got = {n: [t.clone() for t in call()]
                   for n, call in calls.items()}
            torch.cuda.synchronize()
            for n, outs in got.items():
                for o, w in zip(outs, plain):
                    rel = float((o.float() - w.float()).abs().max()
                                / w.float().abs().max())
                    if not rel <= tol:
                        raise RuntimeError(f"{n} {kernel} {shape}: error "
                                           f"{rel} > {tol}")
            ms = {}
            for n in order:
                ms.setdefault(n, []).append(
                    time_ms(calls[n], flush, args.iters))
            ops = flash_ops(kernel, c)
            print(json.dumps({
                "shape": [bh, s, d, causal], "kernel": kernel, "ms": ms,
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
