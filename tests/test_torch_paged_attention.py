"""The port's paged attention (singa_tpu_torch/ops/paged_attention.py)
against the JAX package's Pallas kernel.

On the CPU the port's wrappers run the kernel's plain PyTorch version,
and the JAX kernel runs in the Pallas interpreter (``interpret=True``,
as the JAX suite runs it). The bar is the JAX suite's own: allclose at
1e-5, across block length, head width and cache fill, with fully
masked rows (which both emit zeros). The CUDA kernel itself is held to
the plain version on the card by tests/test_torch_cuda.py and by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.ops import paged_attention as jpa
from singa_tpu_torch.ops import paged_attention as tpa

TOL = dict(atol=1e-5, rtol=1e-5)


def make_case(seed, *, s, h, nq, bl, d, max_len, pos0, overlay=False,
              valid=None):
    """Numpy inputs: random pools/queries, disjoint shuffled tables."""
    rs = np.random.RandomState(seed)
    mb = max_len // bl
    nb = s * mb + 1
    case = {
        "q": rs.randn(s, h, nq, d).astype(np.float32),
        "k_pool": rs.randn(nb, h, bl, d).astype(np.float32),
        "v_pool": rs.randn(nb, h, bl, d).astype(np.float32),
        "tables": (1 + rs.permutation(s * mb)).reshape(s, mb).astype(
            np.int32),
        "positions": (np.asarray(pos0)[:, None]
                      + np.arange(nq)[None, :]).astype(np.int32),
    }
    if overlay:
        case["chunk_k"] = rs.randn(s, h, nq, d).astype(np.float32)
        case["chunk_v"] = rs.randn(s, h, nq, d).astype(np.float32)
        case["chunk_valid"] = np.asarray(valid, np.int32)
    return case


def run_both(case):
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    j = {k: jnp.asarray(v) for k, v in case.items()}
    if "chunk_k" in case:
        got = tpa.paged_attention_overlay(**t)
        want = jpa.paged_attention_overlay(**j, interpret=True)
    else:
        got = tpa.paged_attention(**t)
        want = jpa.paged_attention(**j, interpret=True)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize(
    "bl,d,fill,nq",
    [
        (4, 8, 3, 1),      # partial first block
        (8, 16, 17, 1),    # blocks crossed
        (8, 16, 31, 1),    # cache full to the last position
        (16, 32, 40, 4),   # wide blocks, a prefill-like chunk
        (2, 4, 9, 3),      # tiny blocks
    ],
)
def test_write_then_read_matches_jax(bl, d, fill, nq):
    s = 3
    pos0 = np.random.RandomState(fill).randint(0, fill - nq + 2, size=s)
    pos0[1] = -nq          # every position < 0: a fully masked sequence
    case = make_case(fill, s=s, h=2, nq=nq, bl=bl, d=d, max_len=64,
                     pos0=pos0)
    got, want = run_both(case)
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[1].any()


@pytest.mark.parametrize(
    "bl,d,pos0",
    [
        (8, 16, [0, 7, 21]),      # one sequence with no pool entries
        (4, 8, [3, 12, 30]),
        (16, 32, [17, 0, 40]),
    ],
)
def test_overlay_matches_jax(bl, d, pos0):
    valid = np.asarray([[1, 1, 1, 0], [1, 1, 1, 1], [1, 0, 0, 0]])
    case = make_case(bl, s=3, h=2, nq=4, bl=bl, d=d, max_len=64,
                     pos0=pos0, overlay=True, valid=valid)
    got, want = run_both(case)
    np.testing.assert_allclose(got, want, **TOL)


def test_overlay_dead_row_emits_zero_like_jax():
    """No pool entry (pos0 = 0) and no valid chunk column: the l == 0
    guard emits zeros in both packages (cache_attend would average)."""
    valid = np.asarray([[0, 0, 0], [1, 1, 0]])
    case = make_case(0, s=2, h=2, nq=3, bl=4, d=8, max_len=32,
                     pos0=[0, 5], overlay=True, valid=valid)
    got, want = run_both(case)
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[0].any()


@pytest.mark.parametrize("last", [-5, -1, 0, 7, 8, 15, 16, 200])
def test_live_blocks_matches_jax(last):
    want = int(jpa.live_blocks(jnp.int32(last), 8, 6))
    assert int(tpa.live_blocks(last, 8, 6)) == want
    assert int(tpa.live_blocks(torch.tensor([last]), 8, 6)[0]) == want
    assert int(tpa.live_blocks(np.asarray([last]), 8, 6)[0]) == want


@pytest.mark.parametrize("overlay", [False, True])
def test_modeled_bytes_matches_jax(overlay):
    for args in [(8, 2, 1, 128, 16, 220), (1, 2, 64, 64, 8, 64),
                 (3, 4, 5, 32, 4, 0)]:
        assert tpa.modeled_bytes(*args, overlay=overlay) == \
            jpa.modeled_bytes(*args, overlay=overlay)


def test_fusable_is_the_cuda_kernels_geometry():
    for bl, d in [(16, 128), (8, 64), (1, 64), (5, 128)]:
        assert tpa.fusable(bl, d) is None
    for bl, d in [(0, 128), (16, 16), (16, 32), (16, 96), (16, 256)]:
        assert isinstance(tpa.fusable(bl, d), str)


def test_index_dtypes_must_be_int32():
    case = {k: torch.from_numpy(v) for k, v in make_case(
        0, s=2, h=2, nq=1, bl=4, d=8, max_len=16, pos0=[3, 5]).items()}
    for key in ("tables", "positions"):
        bad = dict(case, **{key: case[key].long()})
        with pytest.raises(TypeError):
            tpa.paged_attention(**bad)


def test_cpu_calls_take_the_plain_version_and_count_no_launch():
    case = {k: torch.from_numpy(v) for k, v in make_case(
        1, s=2, h=2, nq=2, bl=4, d=8, max_len=16, pos0=[3, 5]).items()}
    before = tpa.paged_attention.launches
    got = tpa.paged_attention(**case)
    assert tpa.paged_attention.launches == before
    torch.testing.assert_close(got, tpa.paged_attention_plain(**case),
                               rtol=0, atol=0)
