"""The float32 flash kernels on the CPU: the kernel source
(singa_tpu_torch/csrc/flash_attention.cu: the forward ``singa_flash_fwd``
and the fused backward ``singa_flash_bwd``) through the CPU emulation of
its CUDA primitives (tests/cuda_emu.h, built with the helpers of
tests/test_torch_flash_bwd.py), and the backward's plain version
``flash_bwd_plain`` against the JAX package's float32 Pallas kernels.

The forward's code runs there with its two key groups (512 threads, each
group on its own named barrier), its cp.async copies landing only at
each thread's wait, and the merge of the groups; it is held to
``flash_fwd_plain`` (itself held to the JAX package's float32 Pallas
forward by tests/test_torch_flash.py). A copy of the source with one
wait taken out must fail the same check
(tests/test_torch_flash_variants.py).

The emulation runs the backward's code: the persistent blocks' ticket, the
downward walk over the q tiles, the five products, the shared P/dS tile,
the ordered dQ adds behind the per-(bh, q tile) counters and the
bounded poll. Its blocks run one after another, so the first claims
every work tile in ticket order and never waits; it cannot show a race
between blocks (the card's bitwise repeat in tests/test_torch_cuda.py
and chip_smoke.py does). The poll limit is lowered with
SINGA_FLASH_POLL_LIMIT so that a launch whose counters were not zeroed
fails at once.
"""

import ctypes
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.ops import attention as ja
from singa_tpu_torch.ops import attention as ta
from test_torch_flash_bwd import CP_ASYNC, build_emulated, read_source

#: inline-assembly primitives of csrc/flash_attention.cu -> emulations
PRIMITIVES = {
    **CP_ASYNC,
    "group_sync": "(int g) { emu_bar_sync(g + 1, kFwdGroupThreads); }",
    "ld_acquire": "(const int* p) { return emu_ld_acquire(p); }",
    "st_release": "(int* p, int v) { emu_st_release(p, v); }",
}
#: polls before the kernel traps, in the emulated build
POLL_LIMIT = 4096
#: emulated kernel vs plain, relative to each output's max: the same
#: float32 products summed in another order (at most 1e-6 seen)
TOL = 1e-5
#: cudaErrorLaunchFailure, what a trapped launch reports
LAUNCH_FAILURE = 719


def f32_library(src, tmp):
    """Float32 flash source ``src`` built for the CPU on cuda_emu.h in
    ``tmp``, with its forward and fused backward entries declared."""
    dll = build_emulated(f"#define SINGA_FLASH_POLL_LIMIT {POLL_LIMIT}\n"
                         + src, tmp, PRIMITIVES)
    tail = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    for name, n_ptr in (("singa_flash_fwd", 5), ("singa_flash_bwd", 10)):
        fn = getattr(dll, name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + tail
        fn.restype = ctypes.c_int
    return dll


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """csrc/flash_attention.cu built for the CPU on cuda_emu.h."""
    return f32_library(read_source("flash_attention"),
                       tmp_path_factory.mktemp("flash_f32_emu"))


def _inputs(seed, bh, s, d):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.randn(bh, s, d).astype(np.float32))
            for _ in range(4)]


def _tail(bh, s, d, causal):
    return (bh, s, d, 0, int(causal), ctypes.c_float(1 / math.sqrt(d)),
            None)


def emulated_forward(lib, q, k, v, causal):
    """One emulated forward launch (out and lse NaN first, so a row left
    unwritten shows) -> (out, lse)."""
    bh, s, d = q.shape
    out = torch.full_like(q, float("nan"))
    lse = torch.full((bh, s), float("nan"))
    assert lib.singa_flash_fwd(
        *(t.data_ptr() for t in (q, k, v, out, lse)),
        *_tail(bh, s, d, causal)) == 0
    return out, lse


def forward_errors(out, lse, q, k, v, causal):
    """(out's max error relative to its max, lse's max of |err| / max(1,
    |lse|)) against flash_fwd_plain."""
    want_out, want_lse = ta.flash_fwd_plain(q, k, v, causal)
    out_err = float((out - want_out).abs().max()) / float(
        want_out.abs().max())
    lse_err = float(((lse - want_lse).abs()
                     / want_lse.abs().clamp(min=1)).max())
    return out_err, lse_err


def emulated_backward(lib, q, k, v, do, lse, delta, causal, scratch=None):
    """One emulated launch as the wrapper makes it (dq and the scratch
    zeroed; dk and dv NaN, so a row left unwritten shows) -> (return
    code, dq, dk, dv, scratch)."""
    bh, s, d = q.shape
    dq = torch.zeros_like(q)
    dk, dv = (torch.full_like(q, float("nan")) for _ in range(2))
    if scratch is None:
        scratch = ta.flash_bwd_scratch(bh, s, "cpu")
    rc = lib.singa_flash_bwd(
        *(t.data_ptr() for t in (q, k, v, do, lse, delta, dq, dk, dv,
                                 scratch)),
        *_tail(bh, s, d, causal))
    return rc, dq, dk, dv, scratch


def _hold_to_plain(got, q, k, v, do, causal):
    """dq, dk, dv against flash_bwd_plain fed the plain forward's lse."""
    out, lse = ta.flash_fwd_plain(q, k, v, causal)
    delta = (do * out).sum(-1)
    want = ta.flash_bwd_plain(q, k, v, do, lse, delta, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = float((g - w).abs().max())
        assert err <= TOL * float(w.abs().max()), (name, err)


def _contributors(bh, s, causal):
    """What each (bh, q tile) counter ends at: the key tiles that see it."""
    nt = s // ta.KERNEL_TILE
    per_tile = [qt + 1 if causal else nt for qt in range(nt)]
    return [per_tile] * bh


def _stats(scratch):
    """(poll cycles, block cycles, blocks run, ticket) of a scratch."""
    head = scratch[:ta.BWD_SCRATCH_HEAD]
    return (*head[:6].view(torch.int64).tolist(), int(head[6]))


@pytest.mark.parametrize("bh,s,d,causal", [
    (1, 128, 64, True),      # two tiles: the diagonal and one below it
    (3, 192, 64, False),     # odd B*H, an odd tile count
    (3, 192, 128, True),
    (2, 128, 128, False),
])
def test_emulated_fused_backward_matches_plain(lib, bh, s, d, causal):
    """dQ, dK and dV of one launch against the plain version; every
    counter ends at its q tile's contributor count, and every work tile
    was claimed once (the ticket ends at tiles + blocks: each block's
    last claim finds no tile)."""
    lib.emu_set_sm_count(2)
    q, k, v, do = _inputs(s + d + int(causal), bh, s, d)
    out, lse = ta.flash_fwd_plain(q, k, v, causal)
    delta = (do * out).sum(-1)
    rc, dq, dk, dv, scratch = emulated_backward(lib, q, k, v, do, lse,
                                                delta, causal)
    assert rc == 0
    _hold_to_plain((dq, dk, dv), q, k, v, do, causal)
    nt = s // ta.KERNEL_TILE
    counters = scratch[ta.BWD_SCRATCH_HEAD:].view(bh, nt).tolist()
    assert counters == _contributors(bh, s, causal)
    _, _, blocks, ticket = _stats(scratch)
    assert (blocks, ticket) == (2, bh * nt + 2)


def test_more_blocks_than_work_tiles(lib):
    """An H100's grid (132 SMs, one block each at this shared memory) on
    2 work tiles: the blocks that find no tile leave at once, the tiles
    are done once each, and the result is the same."""
    lib.emu_set_sm_count(132)
    q, k, v, do = _inputs(11, 1, 128, 64)
    out, lse = ta.flash_fwd_plain(q, k, v, True)
    delta = (do * out).sum(-1)
    rc, dq, dk, dv, scratch = emulated_backward(lib, q, k, v, do, lse,
                                                delta, True)
    assert rc == 0
    _hold_to_plain((dq, dk, dv), q, k, v, do, True)
    assert scratch[ta.BWD_SCRATCH_HEAD:].tolist() == [1, 2]
    polled, cycles, blocks, ticket = _stats(scratch)
    assert (blocks, ticket) == (132, 2 + 132)
    assert 0 <= polled <= cycles


def test_counters_not_zeroed_fail_the_launch(lib):
    """Counters left at 1, as if the wrapper had not zeroed them: key
    tile 0 waits for 0 on each q tile, its poll runs out, and the launch
    reports a launch failure instead of hanging; a launch with zeroed
    counters after it is right again."""
    lib.emu_set_sm_count(2)
    q, k, v, do = _inputs(12, 2, 128, 64)
    out, lse = ta.flash_fwd_plain(q, k, v, False)
    delta = (do * out).sum(-1)
    stale = ta.flash_bwd_scratch(2, 128, "cpu")
    stale[ta.BWD_SCRATCH_HEAD:] = 1
    rc, *_ = emulated_backward(lib, q, k, v, do, lse, delta, False, stale)
    assert rc == LAUNCH_FAILURE
    rc, dq, dk, dv, _ = emulated_backward(lib, q, k, v, do, lse, delta,
                                          False)
    assert rc == 0
    _hold_to_plain((dq, dk, dv), q, k, v, do, False)


@pytest.mark.parametrize("bh,s,d,causal", [
    (1, 128, 64, True),      # two tiles: group 1 sees only the diagonal
    (3, 192, 64, False),     # odd B*H, an odd tile count
    (3, 192, 128, True),     # the first q tile leaves group 1 no key tile
    (2, 256, 128, False),
])
def test_emulated_forward_matches_plain(lib, bh, s, d, causal):
    """The float32 forward's code (two key groups, asynchronous K and V,
    the groups' merge), emulated, against flash_fwd_plain: out within
    TOL of its max, lse within TOL relative (clamped at 1); every row
    written."""
    q, k, v, _ = _inputs(7 * s + d + int(causal), bh, s, d)
    out, lse = emulated_forward(lib, q, k, v, causal)
    out_err, lse_err = forward_errors(out, lse, q, k, v, causal)
    assert out_err <= TOL and lse_err <= TOL, (out_err, lse_err)


@pytest.mark.parametrize("causal", [False, True])
def test_emulated_forward_lse_feeds_the_fused_backward(lib, causal):
    """The float32 forward's code, emulated, against the plain forward
    (out and lse), and its out and lse fed to the emulated fused
    backward, which reads lse in P = exp(S * scale - lse)."""
    lib.emu_set_sm_count(2)
    bh, s, d = 2, 192, 64
    q, k, v, do = _inputs(13 + int(causal), bh, s, d)
    out, lse = emulated_forward(lib, q, k, v, causal)
    out_err, lse_err = forward_errors(out, lse, q, k, v, causal)
    assert out_err <= TOL and lse_err <= TOL, (out_err, lse_err)
    rc, dq, dk, dv, _ = emulated_backward(lib, q, k, v, do, lse,
                                          (do * out).sum(-1), causal)
    assert rc == 0
    _hold_to_plain((dq, dk, dv), q, k, v, do, causal)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_pallas_f32(causal):
    """flash_bwd_plain, fed its forward's lse and delta = rowsum(dO * O),
    against the gradients through the JAX package's float32 Pallas
    kernels in interpret mode (128-row blocks, S = 256); the tolerance of
    tests/test_torch_flash.py::test_flash_grads_match_pallas_f32."""
    shape = (1, 2, 256, 64)
    rs = np.random.RandomState(20 + int(causal))
    q, k, v, g = [rs.randn(*shape).astype(np.float32) for _ in range(4)]

    def f(q, k, v):
        o = ja.flash_attention(q, k, v, causal, 128, 128, True)
        return jnp.vdot(o, jnp.asarray(g))

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                            for a in (q, k, v)))
    rows = [torch.from_numpy(a.reshape(2, 256, 64)) for a in (q, k, v, g)]
    out, lse = ta.flash_fwd_plain(*rows[:3], causal)
    delta = (rows[3] * out).sum(-1)
    got = ta.flash_bwd_plain(*rows, lse, delta, causal)
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy().reshape(shape), np.asarray(w),
                                   atol=2e-5, rtol=1e-5, err_msg=f"d{name}")
