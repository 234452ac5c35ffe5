"""The bf16 flash backward's rounding on the tensor cores
(singa_tpu_torch/csrc/flash_attention_bf16.cu), modelled in PyTorch on
the CPU and held to the JAX package's float32 backward.

The CUDA kernels cannot run here. What they change against the JAX
kernels is where they round: their products take bf16 operands with
float32 sums, and P and dS are formed in float32 and rounded once to
bf16 before they feed dV = P^T dO, dQ = scale dS K and dK = scale dS^T Q
(the JAX kernels keep P and dS in float32). ``tensor_core_backward``
models exactly those rounding points, plus the port's bf16 forward
output (delta = rowsum(dO * O) in float32 of the bf16 O) and the bf16
outputs. Its dQ, dK and dV must lie within half the card's bf16 bar
(FLASH_TOL[bfloat16] = 2e-2 in chip_smoke.py and tests/test_torch_cuda.py,
as max |err| / max |ref|) of the JAX float32 backward on the same
bf16-valued inputs: the Pallas kernels in interpret mode at S = 256, the
dense attention's VJP at S = 1024 (where interpret mode is slow). The
same model without its roundings matches the JAX backward to float32
precision, so the bar measures the roundings and nothing else.

The kernel source itself also runs here, through a CPU emulation of its
CUDA primitives (tests/cuda_emu.h, compiled with g++): one thread per
CUDA thread, ldmatrix and mma by their fragment layouts. That checks the
code's tiling, swizzle, fragment and mask logic against the plain
version at the card's bf16 bar; speed, occupancy and the real compiler
are left to the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import ctypes
import math
import os
import re
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.ops import attention as ja
from singa_tpu_torch import _build
from singa_tpu_torch.ops import attention as ta

#: half of FLASH_TOL[bfloat16] (2e-2), relative to the output's max
BAR = 1e-2
#: the unrounded model against the JAX float32 backward: the two sum the
#: same float32 products in different orders over up to 1024 keys
F32_BAR = 1e-5


def _inputs(seed, bh, s, d):
    """q, k, v, dO as (1, bh, s, d) float32 arrays holding bf16 values:
    the kernels read bf16, so both sides get the same rounded inputs."""
    rs = np.random.RandomState(seed)
    return [
        torch.from_numpy(rs.randn(1, bh, s, d).astype(np.float32))
        .to(torch.bfloat16).float().numpy()
        for _ in range(4)
    ]


def _bf16(x):
    return x.to(torch.bfloat16).float()


def tensor_core_backward(q, k, v, do, causal, rounded=True):
    """dQ, dK, dV of flash attention over (BH, S, D) float32 rows holding
    bf16 values, rounded where the tensor-core kernels round (``rounded``)
    or nowhere. Rounded: the forward's out in bf16 (as the port's bf16
    forward writes it) and its lse in float32; delta = rowsum(dO * O) in
    float32; S = Q K^T and dP = dO V^T float32 sums of bf16 products; P and
    dS formed in float32 and rounded once to bf16; float32 sums; the
    outputs rounded to bf16."""
    causal_mask = None
    if causal:
        s = q.shape[1]
        causal_mask = torch.ones(s, s, dtype=torch.bool).tril()
    dt = torch.bfloat16 if rounded else torch.float32
    out, lse = ta.flash_fwd_plain(q.to(dt), k.to(dt), v.to(dt), causal)
    delta = (do * out.float()).sum(-1)
    scale = q.shape[-1] ** -0.5
    sc = torch.einsum("bqd,bkd->bqk", q, k) * scale
    p = torch.exp(sc - lse[..., None])
    if causal_mask is not None:
        p = torch.where(causal_mask, p, 0.0)
    dp = torch.einsum("bqd,bkd->bqk", do, v)
    ds = p * (dp - delta[..., None])
    if rounded:
        p, ds = _bf16(p), _bf16(ds)
    dq = torch.einsum("bqk,bkd->bqd", ds, k) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, q) * scale
    dv = torch.einsum("bqk,bqd->bkd", p, do)
    if rounded:
        dq, dk, dv = _bf16(dq), _bf16(dk), _bf16(dv)
    return dq, dk, dv


def jax_backward(q, k, v, do, causal):
    """The JAX package's float32 (dQ, dK, dV): its Pallas kernels in
    interpret mode at S <= 256 (128-row blocks), else the dense
    attention's VJP."""
    args = [jnp.asarray(a) for a in (q, k, v)]
    if q.shape[2] <= 256:
        def f(q, k, v):
            return ja.flash_attention(q, k, v, causal, 128, 128, True)
    else:
        def f(q, k, v):
            return ja.attention(q, k, v, causal=causal)
    _, vjp = jax.vjp(f, *args)
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("bh", [2, 3])
@pytest.mark.parametrize("s", [256, 1024])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_tensor_core_rounding_within_half_the_card_bar(bh, s, d, causal):
    q, k, v, do = _inputs(1000 * bh + s + d + int(causal), bh, s, d)
    want = jax_backward(q, k, v, do, causal)
    rows = [torch.from_numpy(a.reshape(bh, s, d)) for a in (q, k, v, do)]
    exact = tensor_core_backward(*rows, causal, rounded=False)
    model = tensor_core_backward(*rows, causal)
    for name, e, m, w in zip(("dq", "dk", "dv"), exact, model, want):
        w = w.reshape(bh, s, d)
        scale = np.abs(w).max()
        f32_err = np.abs(e.numpy() - w).max() / scale
        err = np.abs(m.numpy() - w).max() / scale
        assert f32_err <= F32_BAR, (name, f32_err)
        assert err <= BAR, (name, err)


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd_dq",
                                  "flash_bwd_dkv", "flash_bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_source_routes_each_dtype_to_its_file(name, dtype):
    """Every bf16 kernel (forward, dQ, dK/dV) comes from the tensor-core
    source and every float32 kernel (forward, the fused backward) from
    the CUDA-core one, under the C names their sources export. A name
    that a type has no kernel of (float32's dQ and dK/dV pair, bf16's
    fused backward) is refused, and no source exports it; the CUDA-core
    source exports no bf16 entry."""
    tensor_cores = dtype == torch.bfloat16
    source = "flash_attention_bf16" if tensor_cores else "flash_attention"
    symbol = f"singa_{name}" + ("_bf16" if tensor_cores else "")
    with open(os.path.join(_build.CSRC_DIR, f"{source}.cu")) as f:
        text = f.read()
    pair = name in ("flash_bwd_dq", "flash_bwd_dkv")
    if (pair and not tensor_cores) or (name == "flash_bwd" and tensor_cores):
        with pytest.raises(ValueError, match=name):
            ta.kernel_source(name, dtype)
        assert f" {symbol}(" not in text
    else:
        assert ta.kernel_source(name, dtype) == (source, symbol)
        assert f'extern "C" int {symbol}(' in text
    with open(os.path.join(_build.CSRC_DIR, "flash_attention.cu")) as f:
        assert "bf16" not in f.read().replace("flash_attention_bf16", "")


#: kernel vs plain at bf16, relative to the output's max: the card's bar
#: (FLASH_TOL[bfloat16] in chip_smoke.py and tests/test_torch_cuda.py)
EMU_TOL = 2e-2
#: the kernel sources' cp.async primitives -> their emulations, which
#: land each thread's copies at its wait (tests/cuda_emu.h); a source
#: takes the ones it defines
CP_ASYNC = {
    "cp_async16": "(unsigned dst, const void* src) "
                  "{ emu_cp_async16(dst, src); }",
    "cp_commit": "() { emu_cp_commit(); }",
    "cp_wait_one": "() { emu_cp_wait(1); }",
    "cp_wait_all": "() { emu_cp_wait(0); }",
}
#: inline-assembly primitives of the kernel source -> their emulations
EMU_PRIMITIVES = {
    **{n: CP_ASYNC[n] for n in ("cp_async16", "cp_commit", "cp_wait_all")},
    "ldsm_x4": "(unsigned addr, unsigned r[4]) "
               "{ emu_ldmatrix(addr, r, false); }",
    "ldsm_x4_t": "(unsigned addr, unsigned r[4]) "
                 "{ emu_ldmatrix(addr, r, true); }",
    "mma": "(float c[4], const unsigned a[4], unsigned b0, unsigned b1) "
           "{ emu_mma(c, a, b0, b1); }",
    "fast_exp2": "(float x) { return std::exp2(x); }",
}


def _emulated_source(src: str, primitives=EMU_PRIMITIVES) -> str:
    """The kernel source with cuda_emu.h for the CUDA headers, each
    primitive of ``primitives`` for its emulation, and each
    ``kern<<<grid, block, smem, stream>>>(args)`` for
    ``emu_launch(kern, grid, block, args)``."""
    src = src.replace("#include <cuda_bf16.h>", "")
    src = '#include "cuda_emu.h"\n' + src.replace(
        "#include <cuda_runtime.h>", "")
    src = src.replace("extern __shared__ uint4 smem[];", "")
    for name, body in primitives.items():
        m = re.search(r"__device__ __forceinline__ (\w+) " + name
                      + r"\([^)]*\) \{", src)
        assert m, f"primitive {name} not found in the kernel source"
        depth, end = 0, m.end() - 1
        while True:
            depth += {"{": 1, "}": -1}.get(src[end], 0)
            if depth == 0:
                break
            end += 1
        src = (src[:m.start()] + f"inline {m.group(1)} {name}{body}"
               + src[end + 1:])
    launches = list(re.finditer(r"kern<<<(.*?)>>>\(", src, re.S))
    assert launches, "no kernel launch found in the kernel source"
    for m in reversed(launches):
        depth, parts, cur = 0, [], ""
        for ch in m.group(1):
            depth += {"(": 1, ")": -1}.get(ch, 0)
            if ch == "," and depth == 0:
                parts.append(cur.strip())
                cur = ""
            else:
                cur += ch
        src = (src[:m.start()] + f"emu_launch(kern, {parts[0]}, {parts[1]}, "
               + src[m.end():])
    return src


def read_source(name: str) -> str:
    """The text of ``csrc/<name>.cu``."""
    with open(os.path.join(_build.CSRC_DIR, f"{name}.cu")) as f:
        return f.read()


def _source():
    return read_source("flash_attention_bf16")


#: (source, primitives) -> the library built from them in this process:
#: each test file that emulates a source builds it in its fixture, and a
#: worker that runs several such files compiles it once
_BUILT: dict = {}


def build_emulated(src: str, tmp, primitives=EMU_PRIMITIVES):
    """Kernel source ``src`` built for the CPU on cuda_emu.h in directory
    ``tmp`` (once per process) -> the loaded library."""
    key = (src, tuple(sorted(primitives.items())))
    if key not in _BUILT:
        (tmp / "kernels.cpp").write_text(_emulated_source(src, primitives))
        lib = tmp / "libkernels.so"
        subprocess.run(
            ["g++", "-std=c++20", "-O2", "-pthread", "-shared", "-fPIC",
             "-I", os.path.dirname(os.path.abspath(__file__)),
             "-o", str(lib), str(tmp / "kernels.cpp")],
            check=True, capture_output=True, text=True,
        )
        _BUILT[key] = ctypes.CDLL(str(lib))
    return _BUILT[key]


#: each flash kernel's pointer arguments (before BH, S, D, dtype, causal)
FLASH_POINTERS = {"flash_fwd": 5, "flash_bwd_dq": 7, "flash_bwd_dkv": 8}


def emulated_flash_entries(src: str, tmp):
    """The bf16 flash source ``src`` emulated -> {name: C entry point}
    for every kernel of FLASH_POINTERS."""
    dll = build_emulated(src, tmp)
    entries = {}
    for name, n_ptr in FLASH_POINTERS.items():
        fn = getattr(dll, ta.kernel_source(name, torch.bfloat16)[1])
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries



@pytest.fixture(scope="module")
def emulated_kernels(tmp_path_factory):
    """csrc/flash_attention_bf16.cu built for the CPU on cuda_emu.h."""
    return emulated_flash_entries(_source(),
                                  tmp_path_factory.mktemp("flash_bwd_emu"))


def _check_against_plain(entries, bh, s, d, causal, inputs=None,
                         forward=None):
    """Run the emulated dQ and dK/dV kernels on seeded bf16 inputs (or
    ``inputs`` = q, k, v, dO) and hold them to the plain versions at
    EMU_TOL. The kernels get ``forward`` = (out, lse) if given, the plain
    versions always the plain forward's."""
    if inputs is None:
        gen = torch.Generator().manual_seed(bh * s + d + int(causal))
        inputs = [torch.randn(bh, s, d, generator=gen).to(torch.bfloat16)
                  for _ in range(4)]
    q, k, v, do = inputs
    out, lse = ta.flash_fwd_plain(q, k, v, causal)
    delta = (do.float() * out.float()).sum(-1)
    k_out, k_lse = forward if forward is not None else (out, lse)
    k_delta = (do.float() * k_out.float()).sum(-1)
    dq, dk, dv = (torch.full_like(q, float("nan")) for _ in range(3))
    ins = [t.data_ptr() for t in (q, k, v, do, k_lse, k_delta)]
    tail = (bh, s, d, 1, int(causal), ctypes.c_float(1 / math.sqrt(d)), None)
    assert entries["flash_bwd_dq"](*ins, dq.data_ptr(), *tail) == 0
    assert entries["flash_bwd_dkv"](
        *ins, dk.data_ptr(), dv.data_ptr(), *tail) == 0
    want = (ta.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal),
            *ta.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal))
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        err = float((got.float() - w.float()).abs().max())
        assert err <= EMU_TOL * float(w.float().abs().max()), (name, err)


@pytest.mark.parametrize("bh,s,d,causal", [
    (1, 128, 64, True),      # two tiles: the diagonal and one below it
    (3, 192, 64, False),     # odd B*H, S a multiple of 64 but not 128
    (3, 192, 128, True),     # an odd tile count, the pipeline tail
    (2, 128, 128, False),
])
def test_emulated_kernels_match_plain(emulated_kernels, bh, s, d, causal):
    """The tensor-core kernels' code, run on the emulated primitives,
    against the plain versions on the same bf16 inputs."""
    _check_against_plain(emulated_kernels, bh, s, d, causal)
