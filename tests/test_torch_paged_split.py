"""The paged-attention kernel's split key range
(singa_tpu_torch/csrc/paged_attention.cu) on the CPU.

The CUDA source runs here through the CPU emulation of its primitives
(tests/cuda_emu.h, compiled with g++; one thread per CUDA thread, the
shuffles and cp.async by their semantics): its split shares, the warps'
key sub-slices, the zero-filled tail, the fixed-order merges and the
overlay's chunk folded once are held to the plain versions of
singa_tpu_torch/ops/paged_attention.py (themselves held to the JAX
package's Pallas kernel by tests/test_torch_paged_attention.py) at the
card's bar, across split counts, including more splits than live tiles,
a sequence shorter than one split, the decode row at position -1 and the
overlay's dead row (exact zeros). ``launch_geometry``, the wrapper's
split rule, is checked at the serving shapes. Speed and the real
compiler are left to the card (chip_smoke.py, tests/test_torch_cuda.py).
The prefill and overlay forms are tests/test_torch_paged_split_forms.py.
"""

import ctypes
import math

import numpy as np
import pytest
import torch

from singa_tpu_torch.ops import paged_attention as pa
from test_torch_flash_bwd import CP_ASYNC, build_emulated, read_source

#: kernel vs plain, float32: the card's bar (TOL in chip_smoke.py and
#: tests/test_torch_cuda.py); the splits fold keys in another order
TOL = 1e-4
#: the paged source's inline-assembly primitives -> their emulations
PRIMITIVES = {n: CP_ASYNC[n]
              for n in ("cp_async16", "cp_commit", "cp_wait_one")}


@pytest.fixture(scope="module")
def kernel(tmp_path_factory):
    """singa_paged_attention of csrc/paged_attention.cu on cuda_emu.h."""
    dll = build_emulated(read_source("paged_attention"),
                         tmp_path_factory.mktemp("paged_emu"), PRIMITIVES)
    fn = dll.singa_paged_attention
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def make_case(seed, *, s, nq, bl, d, max_len, pos0, valid=None, h=2):
    """Seeded float32 pools and queries; each sequence owns a shuffled
    disjoint set of blocks (block 0 is the trash block)."""
    rs = np.random.RandomState(seed)
    mb = max_len // bl
    nb = s * mb + 1

    def randn(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32))

    tables = (1 + rs.permutation(s * mb)).reshape(s, mb).astype(np.int32)
    positions = np.asarray(pos0)[:, None] + np.arange(nq)[None, :]
    case = {
        "q": randn(s, h, nq, d),
        "k_pool": randn(nb, h, bl, d),
        "v_pool": randn(nb, h, bl, d),
        "tables": torch.from_numpy(tables),
        "positions": torch.from_numpy(positions.astype(np.int32)),
    }
    if valid is not None:
        case["chunk_k"] = randn(s, h, nq, d)
        case["chunk_v"] = randn(s, h, nq, d)
        case["chunk_valid"] = torch.from_numpy(np.asarray(valid, np.int32))
    return case


def run(kernel, case, splits):
    """The emulated kernel on ``case`` at ``splits`` key-range splits,
    with the wrapper's rows per block; output and scratch start as NaN,
    so anything left unwritten shows."""
    q, kp = case["q"], case["k_pool"]
    s, h, nq, d = q.shape
    nb, _, bl, _ = kp.shape
    mb = case["tables"].shape[1]
    rows = pa.launch_geometry(s, h, nq, mb, bl, 1)[0]
    out = torch.full_like(q, float("nan"))
    part = torch.full((s * h * nq * splits * (d + 2),), float("nan"))
    overlay = "chunk_k" in case
    chunk = ([case["chunk_k"].data_ptr(), case["chunk_v"].data_ptr(),
              case["chunk_valid"].data_ptr()] if overlay else [None] * 3)
    err = kernel(q.data_ptr(), kp.data_ptr(), case["v_pool"].data_ptr(),
                 case["tables"].data_ptr(), case["positions"].data_ptr(),
                 *chunk, out.data_ptr(), part.data_ptr(), s, h, nq, d, nb,
                 bl, mb, int(overlay), rows, splits,
                 ctypes.c_float(1 / math.sqrt(d)), None)
    assert err == 0
    return out


def plain(case):
    if "chunk_k" in case:
        return pa.paged_attention_overlay_plain(**case)
    return pa.paged_attention_plain(**case)


def check(kernel, case, splits):
    got, want = run(kernel, case, splits), plain(case)
    assert torch.isfinite(got).all()
    err = float((got - want).abs().max())
    assert err <= TOL, err
    return got


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("bl,d", [(16, 64), (8, 128)])
def test_decode_splits_match_plain(kernel, splits, bl, d):
    """Decode (Q = 1: one row a block, the 4 warps on 8-key sub-slices):
    ragged fills, a sequence shorter than one split (3 keys: one live
    tile, the other splits empty), and a row at position -1 that emits
    exact zeros. At 8 splits every sequence has more splits than live
    tiles."""
    case = make_case(splits + bl + d, s=4, nq=1, bl=bl, d=d, max_len=128,
                     pos0=[70, 2, -1, 127])
    got = check(kernel, case, splits)
    assert not got[2].any()


def test_split_outputs_are_deterministic(kernel):
    """Two calls on the same inputs: bitwise equal (the merges run in a
    fixed order; no atomics)."""
    case = make_case(7, s=2, nq=1, bl=16, d=64, max_len=128, pos0=[90, 33])
    assert torch.equal(run(kernel, case, 4), run(kernel, case, 4))


@pytest.mark.parametrize("shape,rows", [
    ((8, 2, 1), 1),     # the serving decode tick: 8 slots x 2 heads
    ((1, 2, 64), 4),    # chunked prefill, 64-token chunks
    ((8, 2, 5), 4),     # the spec_k 4 verify tick
    ((3, 2, 2), 2),
])
def test_launch_geometry_fills_the_card_from_shapes(shape, rows):
    """At the serve shapes (table width 128 blocks of 16) on 132 SMs
    every call launches at least one block per SM; splits never exceed
    the table's 32-key tiles, and a call that already fills the card is
    not split."""
    s, h, nq = shape
    got_rows, splits, blocks = pa.launch_geometry(s, h, nq, 128, 16, 132)
    assert got_rows == rows
    assert blocks >= 132
    assert blocks == s * h * -(-nq // rows) * splits
    assert 1 <= splits <= 128 * 16 // 32
    assert pa.launch_geometry(s, h, nq, 2, 16, 132)[1] == 1  # one tile
    assert pa.launch_geometry(64, 8, 64, 128, 16, 132)[1] == 1
