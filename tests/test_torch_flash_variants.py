"""The design variants ``python -m singa_tpu_torch.tools.flash_bwd_variants``
times against the bf16 flash source: each still applies to the source
as it stands and computes the same function, on the CPU emulation of
the kernel source (tests/cuda_emu.h; the helpers of
tests/test_torch_flash_bwd.py and tests/test_torch_flash_fwd.py).
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
)
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
