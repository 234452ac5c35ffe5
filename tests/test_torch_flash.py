"""The port's flash attention (singa_tpu_torch/ops/attention.py) against
the JAX package's Pallas kernels, on the same numpy inputs.

On the CPU the port's wrappers run their plain PyTorch versions (the
CUDA kernels have no CPU mode; tests/test_torch_cuda.py holds the
kernels to these plain versions on the card). The JAX side runs its
Pallas kernels in interpret mode, as tests/test_attention.py does, at
S = 256 with 128-row blocks, once per case (module-scoped fixtures).

Tolerances: float32 at 1e-5 (the two packages sum the same products in
different orders); bfloat16 at 1e-2 absolute plus 1e-2 relative (one
bf16 rounding of each output, 2^-8 relative, on values of order 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.ops import attention as ja
from singa_tpu_torch.ops import attention as ta

SHAPE = (1, 2, 256, 32)
F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=1e-2, rtol=1e-2)


def _inputs(seed, shape=SHAPE):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(4)]


def _to_jax(arrs, dtype):
    return [jnp.asarray(a, dtype) for a in arrs]


def _to_torch(arrs, dtype, requires_grad=False):
    return [torch.tensor(a, dtype=dtype, requires_grad=requires_grad)
            for a in arrs]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def jax_flash():
    """causal, dtype -> the JAX Pallas (interpret) out, lse and grads of
    <flash(q, k, v), g>, computed once per case."""
    cache = {}

    def get(causal, dtype):
        key = (causal, dtype)
        if key not in cache:
            q, k, v, g = _to_jax(_inputs(int(causal)), dtype)
            out, lse = ja._flash_fwd_impl(q, k, v, causal, 128, 128, True)

            def f(q, k, v):
                o = ja.flash_attention(q, k, v, causal, 128, 128, True)
                return jnp.vdot(o.astype(jnp.float32), g.astype(jnp.float32))

            grads = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
            cache[key] = (out, lse, grads)
        return cache[key]

    return get


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block", [None, 64, 128])
def test_plain_forward_matches_pallas_f32(jax_flash, causal, block):
    """out and lse of the plain forward, whatever its q blocking."""
    want_out, want_lse, _ = jax_flash(causal, jnp.float32)
    q, k, v, _ = _to_torch(_inputs(int(causal)), torch.float32)
    b, h, s, d = q.shape
    rows = [t.reshape(b * h, s, d) for t in (q, k, v)]
    out, lse = ta.flash_fwd_plain(*rows, causal, block)
    np.testing.assert_allclose(_np(out).reshape(SHAPE), _np(want_out), **F32)
    np.testing.assert_allclose(_np(lse), _np(want_lse)[:, 0], **F32)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_grads_match_pallas_f32(jax_flash, causal):
    """The autograd.Function's forward and dQ/dK/dV (plain versions on
    the CPU) against the Pallas forward and dq/dkv kernels."""
    want_out, _, want_grads = jax_flash(causal, jnp.float32)
    q, k, v, g = _to_torch(_inputs(int(causal)), torch.float32, True)
    out = ta.flash_attention(q, k, v, causal)
    assert "FlashAttention" in type(out.grad_fn).__name__
    grads = torch.autograd.grad((out * g).sum(), (q, k, v))
    np.testing.assert_allclose(_np(out), _np(want_out), **F32)
    for got, want, name in zip(grads, want_grads, "qkv"):
        np.testing.assert_allclose(_np(got), _np(want), err_msg=f"d{name}",
                                   atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bf16_matches_pallas(jax_flash, causal):
    """bf16 in, f32 accumulation, bf16 out: out, lse and grads."""
    want_out, want_lse, want_grads = jax_flash(causal, jnp.bfloat16)
    q, k, v, g = _to_torch(_inputs(int(causal)), torch.bfloat16, True)
    out = ta.flash_attention(q, k, v, causal)
    assert out.dtype == torch.bfloat16
    grads = torch.autograd.grad((out.float() * g.float()).sum(), (q, k, v))
    np.testing.assert_allclose(_np(out), _np(want_out), **BF16)
    b, h, s, d = q.shape
    _, lse = ta.flash_fwd_plain(
        *(t.detach().reshape(b * h, s, d) for t in (q, k, v)), causal
    )
    np.testing.assert_allclose(_np(lse), _np(want_lse)[:, 0], **BF16)
    for got, want, name in zip(grads, want_grads, "qkv"):
        assert got.dtype == torch.bfloat16
        scale = np.abs(_np(want)).max()
        np.testing.assert_allclose(_np(got) / scale, _np(want) / scale,
                                   err_msg=f"d{name}", **BF16)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_kernels_match_dense_vjp(causal):
    """flash_bwd_dq_plain / flash_bwd_dkv_plain at a block smaller than
    S against the dense attention's autograd, fed the forward's lse and
    delta = rowsum(dO * O) as the kernels are."""
    q, k, v, g = _to_torch(_inputs(7, (2, 128, 64)), torch.float32, True)
    out, lse = ta.flash_fwd_plain(q.detach(), k.detach(), v.detach(),
                                  causal, 64)
    delta = (g * out).sum(-1)
    dq = ta.flash_bwd_dq_plain(q, k, v, g, lse, delta, causal, 64)
    dk, dv = ta.flash_bwd_dkv_plain(q, k, v, g, lse, delta, causal, 64)
    dense = ta.attention(q[None], k[None], v[None], causal=causal)[0]
    want = torch.autograd.grad((dense * g).sum(), (q, k, v))
    for got, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(_np(got), _np(w), atol=2e-5, rtol=1e-5)


def test_block_primitives_match_jax():
    """block_attn_init/update/finish folded over two causal blocks."""
    rs = np.random.RandomState(3)
    q = rs.randn(2, 16, 8).astype(np.float32)
    kv = rs.randn(2, 32, 8).astype(np.float32)
    results = []
    for mod, conv in ((ja, jnp.asarray), (ta, torch.from_numpy)):
        out, m, l = mod.block_attn_init(conv(q))
        for k0 in (0, 16):
            blk = conv(np.ascontiguousarray(kv[:, k0:k0 + 16]))
            out, m, l = mod.block_attn_update(
                conv(q), blk, blk, out, m, l, q_offset=8, k_offset=k0,
                causal=True,
            )
        results.append([_np(x) for x in (mod.block_attn_finish(out, m, l),
                                         m, l)])
    for got, want in zip(*results[::-1]):
        np.testing.assert_allclose(got, want, **F32)


def test_block_rules_match_jax():
    for s in range(64, 4097, 64):
        assert ta._auto_block(s) == ja._auto_block(s)
    for off in range(0, 1024, 64):
        for bq, bk in ((128, 128), (64, 128), (512, 256)):
            assert ta._causal_nlive(off, bq, bk) == int(
                ja._causal_nlive(off, bq, bk))
            assert ta._causal_first(off, bq) == int(
                ja._causal_first(off, bq))


@pytest.mark.parametrize("sq,sk,blocks,kernel", [
    (256, 256, (None, None), True),
    (128, 128, (None, None), True),
    (192, 192, (None, None), False),   # 192 % 128: dense
    (256, 128, (None, None), False),   # Sq != Sk: dense
    (256, 256, (64, 64), False),       # blocks not multiples of 128
    (512, 512, (256, 128), True),
    (384, 384, (256, 128), False),     # 384 % 256: dense
])
def test_routing_follows_the_jax_package(sq, sk, blocks, kernel):
    """_use_kernel decides as the JAX package's does on hardware, at the
    auto blocks (None) or given ones; flash_attention, which always asks
    at the auto blocks, takes the kernel path exactly there, else dense
    attention."""
    q = torch.randn(1, 1, sq, 32, requires_grad=True)
    k = torch.randn(1, 1, sk, 32)
    bq = blocks[0] or ta._auto_block(sq)
    bk = blocks[1] or ta._auto_block(sk)
    assert ta._use_kernel(q, k, bq, bk) == kernel
    assert ja._use_kernel(q, k, bq, bk, False) == kernel
    if blocks == (None, None):
        out = ta.flash_attention(q, k, k, True)
        assert ("FlashAttention" in type(out.grad_fn).__name__) == kernel


@pytest.mark.parametrize("mb,flash", [("512", False), ("0", True)])
def test_auto_attention_reads_the_footprint_rule_per_call(monkeypatch, mb,
                                                          flash):
    """1 x 2 x 256^2 x 8 B = 1.05 MB of scores: dense under the default
    512 MB, flash once SINGA_TPU_DENSE_ATTN_MB is below it."""
    monkeypatch.setenv("SINGA_TPU_DENSE_ATTN_MB", mb)
    q = torch.randn(1, 2, 256, 32, requires_grad=True)
    out = ta.auto_attention(q, q, q, causal=True)
    assert ("FlashAttention" in type(out.grad_fn).__name__) == flash
    np.testing.assert_allclose(
        _np(out), _np(ta.attention(q, q, q, causal=True)), **F32)


def test_wrappers_dispatch_by_device_and_count_only_launches():
    q, k, v, g = _to_torch(_inputs(5, (2, 128, 64)), torch.float32)
    wrappers = (ta.flash_fwd, ta.flash_bwd, ta.flash_bwd_dq,
                ta.flash_bwd_dkv)
    before = [fn.launches for fn in wrappers]
    out, lse = ta.flash_fwd(q, k, v, True)
    delta = (g * out).sum(-1)
    dq = ta.flash_bwd_dq(q, k, v, g, lse, delta, True)
    dk, dv = ta.flash_bwd_dkv(q, k, v, g, lse, delta, True)
    fused = ta.flash_bwd(q, k, v, g, lse, delta, True)
    for a, b in zip(fused, (dq, dk, dv)):
        assert torch.equal(a, b)
    assert [fn.launches for fn in wrappers] == before
    meta = [t.to("meta") for t in (q, k, v, g)]
    # meta rows (the lint shape pass) get their outputs' shapes, and
    # nothing is launched or counted
    m_out, m_lse = ta.flash_fwd(*meta[:3], True)
    assert (m_out.device.type, m_out.shape, m_out.dtype) == (
        "meta", q.shape, q.dtype)
    assert (m_lse.device.type, m_lse.shape, m_lse.dtype) == (
        "meta", lse.shape, torch.float32)
    assert [fn.launches for fn in wrappers] == before
    with pytest.raises(ValueError, match="no path"):
        ta.flash_bwd(*meta, lse.to("meta"), delta.to("meta"), True)
    with pytest.raises(ValueError, match="do not match"):
        ta.flash_fwd(q, k[:, :64], v, True)
    with pytest.raises(ValueError, match="lse/delta"):
        ta.flash_bwd_dq(q, k, v, g, lse.double(), delta, True)
    with pytest.raises(ValueError, match="lse/delta"):
        ta.flash_bwd(q, k, v, g, lse, delta[:, :64], True)


@pytest.mark.parametrize("s,d,dtype,ok", [
    (8192, 128, torch.bfloat16, True),
    (256, 64, torch.float32, True),
    (256, 32, torch.float32, False),
    (200, 64, torch.float32, False),
    (256, 64, torch.float16, False),
])
def test_fusable_names_what_the_kernels_take(s, d, dtype, ok):
    assert (ta.fusable(s, d, dtype) is None) == ok
