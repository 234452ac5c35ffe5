"""The bf16 flash forward on the tensor cores
(singa_tpu_torch/csrc/flash_attention_bf16.cu, ``flash_fwd_bf16``) on
the CPU.

Its rounding points, modelled in PyTorch (``tensor_core_forward``): S =
Q K^T a float32 sum of bf16 products, the running max m and sum l in
float32 (l summed from the float32 P), P rounded once to bf16 to feed
P V with float32 sums, the output rounded to bf16, lse = m + log l in
float32. The JAX kernels keep P in float32, so the model is held to the
JAX package's forward (its Pallas kernel in interpret mode, as the JAX
suite runs it) on the same bf16-valued inputs: the output within half
the card's bf16 bar (FLASH_TOL[bfloat16] = 2e-2 in chip_smoke.py, as
max |err| / max |ref|), lse within 1e-5 relative. The same model
without its roundings matches the JAX forward to float32 precision, so
the bar measures the roundings and nothing else.

The kernel source itself runs through the CPU emulation of its CUDA
primitives (tests/cuda_emu.h; the helpers of test_torch_flash_bwd.py)
and is held to the plain version ``flash_fwd_plain``: output at the
card's bar and lse within LSE_TOL. The emulated forward's lse fed to the
emulated backward, which reads it, is tests/test_torch_flash_lse.py.
"""

import ctypes
import math

import numpy as np
import pytest
import torch

from singa_tpu.ops import attention as ja
from singa_tpu_torch.ops import attention as ta
from test_torch_flash_bwd import (
    BAR,
    EMU_TOL,
    F32_BAR,
    _bf16,
    _inputs,
    _source,
    emulated_flash_entries,
)

#: lse vs the JAX forward's: both are float32 m + log(l) over the same
#: float32 scores, summed in other orders (relative)
LSE_BAR = 1e-5
#: emulated kernel lse vs plain (relative to max(1, |lse|)): exp2 of the
#: scaled score against exp, and another summation order
LSE_TOL = 1e-5


def tensor_core_forward(q, k, v, causal, rounded=True):
    """(out, lse) of flash attention over (BH, S, D) float32 rows holding
    bf16 values, rounded where the tensor-core forward rounds
    (``rounded``) or nowhere."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q, k) * scale
    mask = None
    if causal:
        n = q.shape[1]
        mask = torch.ones(n, n, dtype=torch.bool).tril()
        s = torch.where(mask, s, ta.NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l = p.sum(-1, keepdim=True)
    lse = (m + torch.log(l))[..., 0]
    out = torch.einsum("bqk,bkd->bqd", _bf16(p) if rounded else p, v) / l
    return (_bf16(out) if rounded else out), lse


def jax_forward(q, k, v, causal):
    """The JAX package's float32 forward (out, lse): its Pallas kernel in
    interpret mode, 128-row blocks."""
    import jax.numpy as jnp

    out, lse = ja._flash_fwd_impl(*(jnp.asarray(a) for a in (q, k, v)),
                                  causal, 128, 128, True)
    return np.asarray(out), np.asarray(lse)[:, 0]


@pytest.mark.parametrize("bh", [2, 3])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_tensor_core_rounding_within_half_the_card_bar(bh, d, causal):
    s = 256
    q, k, v, _ = _inputs(2000 * bh + d + int(causal), bh, s, d)
    want_out, want_lse = jax_forward(q, k, v, causal)
    want_out = want_out.reshape(bh, s, d)
    rows = [torch.from_numpy(a.reshape(bh, s, d)) for a in (q, k, v)]
    exact, _ = tensor_core_forward(*rows, causal, rounded=False)
    out, lse = tensor_core_forward(*rows, causal)
    scale = np.abs(want_out).max()
    assert np.abs(exact.numpy() - want_out).max() / scale <= F32_BAR
    assert np.abs(out.numpy() - want_out).max() / scale <= BAR
    lse_err = np.abs(lse.numpy() - want_lse) / np.abs(want_lse).clip(1.0)
    assert lse_err.max() <= LSE_BAR


@pytest.fixture(scope="module")
def emulated_kernels(tmp_path_factory):
    """csrc/flash_attention_bf16.cu built for the CPU on cuda_emu.h."""
    return emulated_flash_entries(_source(),
                                  tmp_path_factory.mktemp("flash_fwd_emu"))


def emulated_forward(entries, q, k, v, causal):
    """The emulated flash_fwd_bf16 on (BH, S, D) bf16 rows -> (out,
    lse); both start as NaN, so anything left unwritten shows."""
    bh, s, d = q.shape
    out = torch.full_like(q, float("nan"))
    lse = torch.full((bh, s), float("nan"))
    assert entries["flash_fwd"](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), bh, s, d, 1, int(causal),
        ctypes.c_float(1 / math.sqrt(d)), None) == 0
    return out, lse


@pytest.mark.parametrize("s", [128, 192, 256])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_emulated_forward_matches_plain(emulated_kernels, s, d, causal):
    """The tensor-core forward's code on the emulated primitives against
    the plain version, at an odd B*H and an odd tile count (S 192: one
    key group has a tile more than the other)."""
    gen = torch.Generator().manual_seed(s + d + int(causal))
    q, k, v = [torch.randn(3, s, d, generator=gen).to(torch.bfloat16)
               for _ in range(3)]
    out, lse = emulated_forward(emulated_kernels, q, k, v, causal)
    want_out, want_lse = ta.flash_fwd_plain(q, k, v, causal)
    err = float((out.float() - want_out.float()).abs().max())
    assert err <= EMU_TOL * float(want_out.float().abs().max()), err
    lse_err = (lse - want_lse).abs() / want_lse.abs().clamp(min=1.0)
    assert float(lse_err.max()) <= LSE_TOL
