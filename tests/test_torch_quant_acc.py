"""The ring's per-hop kernel (singa_tpu_torch/csrc/quant_acc.cu) on the
CPU.

The CUDA source runs here through the CPU emulation of its primitives
(tests/cuda_emu.h, compiled with g++; one thread per CUDA thread, the
warp shuffles, the block's shared memory and the blocks' atomicMax by
their semantics, __fmul_rn and __fadd_rn rounded one at a time). Its
output and its fused max-abs are held to ``quant_acc_plain`` bitwise:
at ragged lengths and at unaligned offsets, on both paths (groups of 4
elements, and one at a time), on the rows of a flat (n, C) bucket
tensor with a ragged C, with enough blocks that the atomicMax
merges blocks (and, on a card of 2 SMs, a grid that strides), and with
NaN, -0.0 and +-Inf among the partials or a NaN scale. Speed and the
real compiler are left to the card (chip_smoke.py,
tests/test_torch_cuda.py).
"""

import ctypes

import numpy as np
import pytest
import torch

from singa_tpu_torch.ops import quantized_collective as qc
from test_torch_flash_bwd import build_emulated, read_source


def _entry(dll):
    fn = dll.singa_quant_acc
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@pytest.fixture(scope="module")
def kernel(tmp_path_factory):
    """singa_quant_acc of csrc/quant_acc.cu on cuda_emu.h (132 SMs)."""
    return _entry(build_emulated(read_source("quant_acc"),
                                 tmp_path_factory.mktemp("quant_acc_emu"), {}))


@pytest.fixture(scope="module")
def two_sm_kernel(tmp_path_factory):
    """The same source on a card of 2 SMs: the grid's cap of 8 blocks an
    SM is reached at a few thousand elements, and threads stride."""
    dll = build_emulated(read_source("quant_acc"),
                         tmp_path_factory.mktemp("quant_acc_emu2"), {})
    dll.emu_set_sm_count(2)
    return _entry(dll)


def case(seed, m, offset=0):
    """int8 q, a float32 scale and float32 partials of ``m`` elements,
    each a view ``offset`` elements into a larger tensor (so the pointers
    lose their alignment as the offset says)."""
    rs = np.random.RandomState(seed)
    q = torch.from_numpy(rs.randint(-127, 128, m + offset).astype(np.int8))
    local = torch.from_numpy(rs.randn(m + offset).astype(np.float32))
    scale = torch.tensor(np.float32(rs.rand() * 1e-2))
    return q[offset:], scale, local[offset:]


def run(kernel, q, scale, local, *, amax=True):
    """The emulated kernel -> (out, amax or None); out and amax start as
    NaN, so anything left unwritten shows."""
    out = torch.full_like(local, float("nan"))
    mx = torch.full((), float("nan")) if amax else None
    err = kernel(q.data_ptr(), scale.data_ptr(), local.data_ptr(),
                 out.data_ptr(), None if mx is None else mx.data_ptr(),
                 local.numel(), None)
    assert err == 0
    return out, mx


def same_bits(got, want):
    """Bitwise equal, a NaN matching any NaN (its payload is the
    hardware's)."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))


def check(kernel, q, scale, local):
    """Out and amax against the plain version, and out alone without
    amax."""
    want, want_max = qc.quant_acc_plain(q, scale, local, amax=True)
    got, got_max = run(kernel, q, scale, local)
    same_bits(got, want)
    same_bits(got_max, want_max)
    same_bits(run(kernel, q, scale, local, amax=False)[0], want)
    return got_max


@pytest.mark.parametrize("offset", [0, 1, 2, 4])
@pytest.mark.parametrize("m", [1, 3, 17, 1001, 4101])
def test_matches_plain_bitwise(kernel, m, offset):
    """Ragged m (the last block part full, a scalar tail); offsets of 1
    and 2 elements leave q off its 4-byte and the partials off their
    16-byte alignment (one element at a time), 0 and 4 keep both (groups
    of 4)."""
    check(kernel, *case(m + offset, m, offset))


@pytest.mark.parametrize("c", [1001, 2048])
def test_flat_bucket_rows(kernel, c):
    """Every row of a flat (4, C) bucket tensor, as the ring passes them:
    with C = 1001 rows 1-3 start unaligned."""
    rs = np.random.RandomState(c)
    q = torch.from_numpy(rs.randint(-127, 128, (4, c)).astype(np.int8))
    local = torch.from_numpy(rs.randn(4, c).astype(np.float32))
    scale = torch.tensor(np.float32(3e-3))
    for j in range(4):
        check(kernel, q[j], scale, local[j])


@pytest.mark.parametrize("where", [0, 500, 1000])
def test_amax_merges_the_blocks(kernel, where):
    """1001 unaligned elements run one at a time over 16 blocks of 64
    threads: the largest |out|, placed in the first, a middle or the last
    block, comes back from the atomicMax whichever block holds it."""
    q, scale, local = case(where, 1001, offset=1)
    local = local.clone()
    local[where] = -40.0
    assert float(check(kernel, q, scale, local)) == float(
        (q[where].float() * scale + local[where]).abs())


@pytest.mark.parametrize("m,offset", [(67203, 0), (5000, 1)])
def test_grid_strides_on_a_small_card(two_sm_kernel, m, offset):
    """On 2 SMs the grid stops at 16 blocks of 256 threads: the groups of
    4 and the one-at-a-time path each stride over the rest."""
    check(two_sm_kernel, *case(m, m, offset))


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("special", ["nan", "-0.0", "inf", "-inf"])
def test_special_values(kernel, special, offset):
    """A NaN partial gives NaN at its place and a NaN amax; -0.0
    partials with zero bytes and a negative scale give -0.0 sums and an
    amax of +0.0; an infinite partial gives an infinite amax. Offset 0
    takes the groups of 4, offset 1 one element at a time."""
    q, scale, local = case(7, 301, offset=offset)
    q, local = q.clone(), local.clone()
    if special == "-0.0":
        q.zero_()
        local.fill_(-0.0)
        scale = -scale
    else:
        local[150] = float(special)
    mx = check(kernel, q, scale, local)
    if special == "nan":
        assert torch.isnan(mx)
    elif special == "-0.0":
        assert mx.view(torch.int32) == 0
    else:
        assert mx == float("inf")


@pytest.mark.parametrize("offset", [0, 1])
def test_nan_scale_gives_nan_everywhere(kernel, offset):
    q, _, local = case(11, 1001, offset=offset)
    nan = torch.tensor(float("nan"))
    out, mx = run(kernel, q, nan, local)
    assert torch.isnan(out).all() and torch.isnan(mx)


def test_empty_chunk_gives_zero_amax(kernel):
    """m = 0 launches nothing; amax is still written (0, as the plain
    version gives)."""
    q, scale, local = case(0, 0)
    out, mx = run(kernel, q, scale, local)
    assert out.numel() == 0 and mx.view(torch.int32) == 0
    assert qc.quant_acc_plain(q, scale, local, amax=True)[1] == 0
