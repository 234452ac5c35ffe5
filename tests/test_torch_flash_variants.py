"""The design variants ``python -m singa_tpu_torch.tools.flash_bwd_variants``
times against the bf16 flash source and the float32 forward: each still
applies to the source as it stands and computes the same function, on
the CPU emulation of the kernel source (tests/cuda_emu.h; the helpers of
tests/test_torch_flash_bwd.py, tests/test_torch_flash_fwd.py and
tests/test_torch_flash_f32_emu.py).
"""

import pytest
import torch

from singa_tpu_torch.ops import attention as ta
from singa_tpu_torch.tools import flash_bwd_variants as fv
from test_torch_flash_bwd import (
    EMU_TOL,
    _check_against_plain,
    _source,
    emulated_flash_entries,
    read_source,
)
from test_torch_flash_f32_emu import TOL as F32_TOL
from test_torch_flash_f32_emu import emulated_forward as f32_forward
from test_torch_flash_f32_emu import _inputs, f32_library, forward_errors
from test_torch_flash_fwd import LSE_TOL, emulated_forward


@pytest.mark.parametrize("variant", sorted(fv.VARIANTS))
def test_timed_design_variants_build_and_match_plain(variant, tmp_path):
    """Each design variant that tools/flash_bwd_variants.py times against
    the source still applies to the source as it stands, and computes the
    same function: emulated at an odd causal tile count, where pairing
    leaves a middle tile alone."""
    src = fv.variant_source(variant, _source())
    assert src != _source()
    _check_against_plain(emulated_flash_entries(src, tmp_path), 3, 192, 64,
                         True)


def test_timed_forward_variant_matches_plain(tmp_path):
    """tools/flash_bwd_variants.py's forward variant (one key group a
    block where the source has two) still applies to the source and
    computes the same function."""
    src = fv.variant_source("fwd_groups", _source())
    assert src != _source()
    entries = emulated_flash_entries(src, tmp_path)
    gen = torch.Generator().manual_seed(5)
    q, k, v = [torch.randn(3, 256, 64, generator=gen).to(torch.bfloat16)
               for _ in range(3)]
    out, lse = emulated_forward(entries, q, k, v, True)
    want_out, want_lse = ta.flash_fwd_plain(q, k, v, True)
    err = float((out.float() - want_out.float()).abs().max())
    assert err <= EMU_TOL * float(want_out.float().abs().max()), err
    assert float(((lse - want_lse).abs()
                  / want_lse.abs().clamp(min=1.0)).max()) <= LSE_TOL


@pytest.mark.parametrize("variant", sorted(fv.F32_VARIANTS))
def test_timed_float32_forward_variants_match_plain(variant, tmp_path):
    """Each float32 forward variant that tools/flash_bwd_variants.py times
    (``--source flash_attention``) still applies to the source as it
    stands, and computes the same function: emulated at an odd causal
    tile count and an odd B*H, against flash_fwd_plain at the emulated
    source's bar."""
    src = read_source("flash_attention")
    text = fv.variant_source(variant, src, fv.F32_VARIANTS)
    assert text != src
    lib = f32_library(text, tmp_path)
    q, k, v, _ = _inputs(41, 3, 192, 64)
    out, lse = f32_forward(lib, q, k, v, True)
    out_err, lse_err = forward_errors(out, lse, q, k, v, True)
    assert out_err <= F32_TOL and lse_err <= F32_TOL, (out_err, lse_err)


#: the wait before the PV product's barrier, which V_kt must have passed
PLANTED_WAIT = ("    cp_wait_all();  // this thread's part of V_kt\n", "")


def test_planted_missing_wait_fails_the_emulated_forward(tmp_path):
    """The float32 forward with the wait for V_kt taken out: the
    emulation lands a thread's copies only at its next wait, after PV has
    read the stage's old bytes (the 0xff fill: NaN), so it must fail the
    check that the source passes (and passed when the emulation copied
    at issue)."""
    src = read_source("flash_attention")
    old, new = PLANTED_WAIT
    assert src.count(old) == 1
    planted = f32_library(src.replace(old, new), tmp_path)
    q, k, v, _ = _inputs(31, 1, 128, 64)
    out, lse = f32_forward(planted, q, k, v, True)
    out_err, _ = forward_errors(out, lse, q, k, v, True)
    assert not out_err <= F32_TOL, out_err
