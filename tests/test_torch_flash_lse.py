"""The bf16 flash forward's lse feeding the backward, on the CPU
emulation of the kernel source (tests/cuda_emu.h; the helpers of
tests/test_torch_flash_bwd.py and tests/test_torch_flash_fwd.py): the
backward kernels read the forward's lse, so a wrong exp base or scale
that the output check passes shows here.
"""

import pytest
import torch

from test_torch_flash_bwd import (
    _check_against_plain,
    _source,
    emulated_flash_entries,
)
from test_torch_flash_fwd import emulated_forward


@pytest.fixture(scope="module")
def emulated_kernels(tmp_path_factory):
    """csrc/flash_attention_bf16.cu built for the CPU on cuda_emu.h."""
    return emulated_flash_entries(_source(),
                                  tmp_path_factory.mktemp("flash_lse_emu"))


@pytest.mark.parametrize("s,d,causal", [(192, 64, True), (256, 128, False)])
def test_emulated_forward_lse_feeds_the_backward(emulated_kernels, s, d,
                                                 causal):
    """The backward kernels read the forward's lse (P = exp(S * scale -
    lse)): fed the emulated forward's out and lse, the emulated dQ and
    dK/dV still match the plain versions fed the plain forward's."""
    gen = torch.Generator().manual_seed(7 * s + d)
    q, k, v, do = [torch.randn(3, s, d, generator=gen).to(torch.bfloat16)
                   for _ in range(4)]
    out, lse = emulated_forward(emulated_kernels, q, k, v, causal)
    _check_against_plain(emulated_kernels, 3, s, d, causal,
                         inputs=(q, k, v, do), forward=(out, lse))
