"""The image nets' ops in the port (singa_tpu_torch.ops.{activations,
nn,distortion}, utils.rng) against the JAX package's, on the same numpy
inputs from a seed: forward values, and gradients through ``jax.grad``
against ``torch.autograd`` with the same random cotangent.

Tolerance: float32 per-op forward and grads within atol 2e-5, rtol
1e-5 (the two frameworks sum in other orders). Pools with exact ties
(inputs of repeated integers) are compared the same way: a backward
that picked one winner where the reference shares the gradient among
ties is off by whole cotangent values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.ops import activations as j_act
from singa_tpu.ops import distortion as j_dist
from singa_tpu.ops import nn as j_nn
from singa_tpu_torch.ops import activations as t_act
from singa_tpu_torch.ops import distortion as t_dist
from singa_tpu_torch.ops import nn as t_nn
from singa_tpu_torch.utils.rng import fold_in, on_device

ACT = dict(atol=2e-5, rtol=1e-5)


def both(jfn, tfn, *arrays, seed=1):
    """Forward and gradients of jfn (JAX) and tfn (torch) on the same
    float32 arrays, against a random cotangent -> (jax out, torch out,
    [(jax grad, torch grad)])."""
    jx = [jnp.asarray(a) for a in arrays]
    jy = jfn(*jx)
    cot = np.asarray(np.random.RandomState(seed).randn(*jy.shape),
                     dtype=np.float32)
    fin = np.asarray(np.isfinite(np.asarray(jy)))
    cot = np.asarray(np.where(fin, cot, 0), dtype=np.float32)

    def jloss(*xs):
        y = jfn(*xs)
        return jnp.sum(jnp.where(jnp.asarray(fin), y, 0.0) * cot)

    jg = jax.grad(jloss, argnums=tuple(range(len(arrays))))(*jx)
    tx = [torch.tensor(a, requires_grad=True) for a in arrays]
    ty = tfn(*tx)
    (torch.where(torch.from_numpy(fin), ty, torch.zeros_like(ty))
     * torch.from_numpy(cot)).sum().backward()
    return (np.asarray(jy), ty.detach().numpy(),
            [(np.asarray(g), t.grad.numpy()) for g, t in zip(jg, tx)])


def assert_both(jfn, tfn, *arrays, **tol):
    jy, ty, grads = both(jfn, tfn, *arrays)
    assert ty.shape == jy.shape
    np.testing.assert_allclose(ty, jy, **(tol or ACT))
    for i, (jg, tg) in enumerate(grads):
        np.testing.assert_allclose(tg, jg, err_msg=f"grad {i}",
                                   **(tol or ACT))


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["relu", "sigmoid", "stanh", "softplus",
                                  "bnll"])
def test_activation_and_grad_match_jax(name):
    rs = np.random.RandomState(0)
    # exact zeros too: relu's grad there is 0, bnll's branch point
    x = np.concatenate([rs.randn(200) * 4, np.zeros(4)]).astype(np.float32)
    assert_both(getattr(j_act, name), getattr(t_act, name), x)


def test_leaky_relu_matches_jax():
    x = np.random.RandomState(1).randn(64).astype(np.float32)
    assert_both(lambda a: j_act.relu(a, 0.1), lambda a: t_act.relu(a, 0.1),
                x)


# ---------------------------------------------------------------------------
# convolution
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["col", "oihw"])
@pytest.mark.parametrize("stride,pad", [(1, 0), (1, 2), (2, 1), (3, 0)])
def test_conv2d_both_weight_layouts_match_jax(layout, stride, pad):
    rs = np.random.RandomState(stride * 10 + pad)
    x = rs.randn(2, 3, 11, 11).astype(np.float32)
    w = (rs.randn(4, 3, 5, 5) * 0.2).astype(np.float32)
    if layout == "col":
        w = w.reshape(4, 75)
    b = rs.randn(4).astype(np.float32)
    assert_both(
        lambda x_, w_, b_: j_nn.conv2d(x_, w_, b_, stride=stride, pad=pad),
        lambda x_, w_, b_: t_nn.conv2d(x_, w_, b_, stride=stride, pad=pad),
        x, w, b,
    )


def test_conv2d_col_layout_is_oihw():
    rs = np.random.RandomState(2)
    x = torch.from_numpy(rs.randn(1, 2, 6, 6).astype(np.float32))
    w = torch.from_numpy(rs.randn(3, 2, 3, 3).astype(np.float32))
    assert torch.equal(t_nn.conv2d(x, w.reshape(3, 18)), t_nn.conv2d(x, w))


def test_conv2d_aligns_input_to_the_weight_dtype():
    x = torch.randn(1, 1, 5, 5)
    w = torch.randn(2, 9).to(torch.bfloat16)
    assert t_nn.conv2d(x, w).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [1, 2, 5, 7, 8, 13, 24, 28])
def test_pooled_size_sweep_matches_jax(size):
    for k in range(1, min(size, 5) + 1):
        for s in range(1, 5):  # s > k included
            assert t_nn.pooled_size(size, k, s) == j_nn.pooled_size(size, k, s)


def test_pooled_size_keeps_the_window_pytorch_drops():
    """H 5, k 1, s 3: windows at 0, 3 and 6; PyTorch's ceil_mode drops
    the one that starts past the input."""
    assert t_nn.pooled_size(5, 1, 3) == 3
    y = t_nn.avg_pool2d(torch.ones(1, 1, 5, 5), 1, 3)
    assert y.shape == (1, 1, 3, 3)
    assert torch.nn.functional.avg_pool2d(
        torch.ones(1, 1, 5, 5), 1, 3, ceil_mode=True).shape == (1, 1, 2, 2)


#: (H, W, kernel, stride): overhanging ceil-mode windows (8 at k3 s2, 5
#: at k2 s2, 13 at k3 s3), one window past the input (5 at k1 s3), an
#: exact fit (7 at k3 s2), LeNet's 24 at k2 s2 and a non-square case
POOL_SHAPES = [(8, 8, 3, 2), (5, 5, 2, 2), (13, 13, 3, 3), (5, 5, 1, 3),
               (7, 7, 3, 2), (24, 24, 2, 2), (9, 6, 3, 2), (6, 6, 2, 1)]


@pytest.mark.parametrize("h,w,k,s", POOL_SHAPES)
def test_max_pool_with_exact_ties_matches_jax(h, w, k, s):
    """Repeated integers: most windows hold tied maxima, each of which
    the reference's backward gives the full dy."""
    x = np.random.RandomState(h + k).randint(0, 3, (2, 3, h, w))
    assert_both(lambda a: j_nn.max_pool2d(a, k, s),
                lambda a: t_nn.max_pool2d(a, k, s), x.astype(np.float32))


@pytest.mark.parametrize("h,w,k,s", POOL_SHAPES)
def test_avg_pool_divides_overhang_by_k2_and_matches_jax(h, w, k, s):
    x = np.random.RandomState(h * 7 + s).randn(2, 3, h, w)
    assert_both(lambda a: j_nn.avg_pool2d(a, k, s),
                lambda a: t_nn.avg_pool2d(a, k, s), x.astype(np.float32))


def test_max_pool_tie_backward_shares_dy():
    """A 2x2 window of four equal values, dy 1: every position gets 1
    (PyTorch's own backward gives one of them 1)."""
    x = torch.ones(1, 1, 2, 2, requires_grad=True)
    t_nn.max_pool2d(x, 2, 2).sum().backward()
    assert torch.equal(x.grad, torch.ones(1, 1, 2, 2))
    x2 = torch.ones(1, 1, 2, 2, requires_grad=True)
    torch.nn.functional.max_pool2d(x2, 2, 2).sum().backward()
    assert x2.grad.sum() == 1


def test_avg_pool_overhang_divisor_is_k2():
    """H 3, k 2, s 2: the second window holds one in-bounds value and is
    divided by 4, not 1 (PyTorch's ceil_mode divides by the in-bounds
    count)."""
    y = t_nn.avg_pool2d(torch.ones(1, 1, 3, 3), 2, 2)
    assert y[0, 0].tolist() == [[1.0, 0.5], [0.5, 0.25]]


@pytest.mark.parametrize("ties", [False, True])
def test_max_pool_above_the_threshold_matches_jax(monkeypatch, ties):
    """Above _PHASE_POOL_MAX_ELEMS both packages take autodiff's single
    winner, the first maximal position of the window in row-major
    order: equal on ties too."""
    monkeypatch.setattr(j_nn, "_PHASE_POOL_MAX_ELEMS", 0)
    monkeypatch.setattr(t_nn, "_PHASE_POOL_MAX_ELEMS", 0)
    rs = np.random.RandomState(5)
    x = (rs.randint(0, 3, (2, 3, 8, 8)) if ties
         else rs.randn(2, 3, 8, 8)).astype(np.float32)
    assert_both(lambda a: j_nn.max_pool2d(a, 3, 2),
                lambda a: t_nn.max_pool2d(a, 3, 2), x)
    xt = torch.ones(1, 1, 2, 2, requires_grad=True)
    t_nn.max_pool2d(xt, 2, 2).sum().backward()
    assert xt.grad.flatten().tolist() == [1.0, 0.0, 0.0, 0.0]


# ---------------------------------------------------------------------------
# LRN, dropout, softmax loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("beta", [0.75, 0.5, 0.6])
@pytest.mark.parametrize("local_size", [3, 5])
def test_lrn_matches_jax(beta, local_size):
    x = np.random.RandomState(3).randn(2, 7, 5, 5).astype(np.float32)
    kw = dict(local_size=local_size, alpha=0.7, beta=beta, knorm=1.5)
    assert_both(lambda a: j_nn.lrn(a, **kw), lambda a: t_nn.lrn(a, **kw), x)


def test_dropout_p0_and_eval_are_identity():
    x = torch.randn(4, 5)
    gen = torch.Generator().manual_seed(0)
    assert t_nn.dropout(x, 0.0, True, gen) is x
    assert t_nn.dropout(x, 0.5, False, gen) is x
    jx = jnp.asarray(x.numpy())
    assert j_nn.dropout(jax.random.PRNGKey(0), jx, 0.0, True) is jx


def test_dropout_with_an_injected_draw_matches_jax(monkeypatch):
    """The same uniform draw in both packages -> the same mask, output
    and gradient."""
    rs = np.random.RandomState(4)
    x = rs.randn(6, 10).astype(np.float32)
    u = rs.rand(6, 10).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape: jnp.asarray(u))
    monkeypatch.setattr(torch, "rand",
                        lambda shape, **kw: torch.from_numpy(u))
    key, gen = jax.random.PRNGKey(0), torch.Generator().manual_seed(0)
    assert_both(lambda a: j_nn.dropout(key, a, 0.3, True),
                lambda a: t_nn.dropout(a, 0.3, True, gen), x)


def test_dropout_draws_are_seeded():
    x = torch.ones(64, 64)
    a = t_nn.dropout(x, 0.5, True, torch.Generator().manual_seed(3))
    b = t_nn.dropout(x, 0.5, True, torch.Generator().manual_seed(3))
    c = t_nn.dropout(x, 0.5, True, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert set(a.unique().tolist()) == {0.0, 2.0}
    with pytest.raises(ValueError, match="generator"):
        t_nn.dropout(x, 0.5, True, None)


@pytest.mark.parametrize("topk", [1, 3])
@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_softmax_loss_precision_and_grad_match_jax(topk, scale):
    rs = np.random.RandomState(topk)
    logits = (rs.randn(16, 10) * 3).astype(np.float32)
    labels = rs.randint(0, 10, 16)
    jl, jm = j_nn.softmax_loss(jnp.asarray(logits), jnp.asarray(labels),
                               topk=topk, scale=scale)
    tl, tm = t_nn.softmax_loss(torch.from_numpy(logits),
                               torch.from_numpy(labels), topk=topk,
                               scale=scale)
    assert float(tl) == pytest.approx(float(jl), abs=2e-5)
    assert float(tm["precision"]) == pytest.approx(float(jm["precision"]),
                                                   abs=1e-7)
    assert_both(
        lambda a: j_nn.softmax_loss(a, jnp.asarray(labels), topk=topk,
                                    scale=scale)[0],
        lambda a: t_nn.softmax_loss(a, torch.from_numpy(labels), topk=topk,
                                    scale=scale)[0],
        logits,
    )
    # the reference's hand-written gradient: (p - onehot) * scale / n
    x = torch.tensor(logits, requires_grad=True)
    t_nn.softmax_loss(x, torch.from_numpy(labels), topk=topk,
                      scale=scale)[0].backward()
    want = (torch.softmax(torch.from_numpy(logits), -1)
            - torch.nn.functional.one_hot(torch.from_numpy(labels), 10))
    np.testing.assert_allclose(x.grad.numpy(), want.numpy() * scale / 16,
                               **ACT)


def test_softmax_precision_ranks_ties_by_index_like_jax():
    logits = np.zeros((4, 10), np.float32)
    labels = np.array([0, 1, 2, 9])
    for k in (1, 3):
        _, jm = j_nn.softmax_loss(jnp.asarray(logits), jnp.asarray(labels),
                                  topk=k)
        _, tm = t_nn.softmax_loss(torch.from_numpy(logits),
                                  torch.from_numpy(labels), topk=k)
        assert float(tm["precision"]) == float(jm["precision"])


# ---------------------------------------------------------------------------
# distortion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel,sigma", [(5, 1.0), (8, 2.5), (21, 4.0)])
def test_gaussian_taps_and_smoothing_match_jax(kernel, sigma):
    jt = j_dist.gaussian_kernel1d(kernel, sigma)
    tt = t_dist.gaussian_kernel1d(kernel, sigma)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **ACT)
    f = np.random.RandomState(kernel).rand(2, 28, 28).astype(np.float32)
    np.testing.assert_allclose(
        t_dist._smooth(torch.from_numpy(f), tt).numpy(),
        np.asarray(j_dist._smooth(jnp.asarray(f), jt)), **ACT)


@pytest.mark.parametrize("knobs", [
    dict(beta=15.0), dict(gamma=20.0), dict(kernel=5, sigma=2.0, alpha=3.0),
    dict(kernel=5, sigma=2.0, alpha=3.0, beta=10.0, gamma=15.0),
])
def test_distort_sampler_matches_jax_on_injected_fields(monkeypatch, knobs):
    """Both packages get the same affine matrices and displacement
    fields; the bilinear zero-fill sampling must then agree."""
    rs = np.random.RandomState(6)
    b, h, w = 3, 12, 12
    images = rs.rand(b, h, w).astype(np.float32)
    mats = j_dist.affine_matrices(jax.random.PRNGKey(1), b,
                                  knobs.get("beta", 0.0),
                                  knobs.get("gamma", 0.0))
    mats = np.array(mats)
    dy = (rs.randn(b, h, w) * 2).astype(np.float32)
    dx = (rs.randn(b, h, w) * 2).astype(np.float32)
    monkeypatch.setattr(j_dist, "affine_matrices",
                        lambda *a: jnp.asarray(mats))
    monkeypatch.setattr(j_dist, "elastic_offsets",
                        lambda *a: (jnp.asarray(dy), jnp.asarray(dx)))
    monkeypatch.setattr(t_dist, "affine_matrices",
                        lambda *a: torch.from_numpy(mats))
    monkeypatch.setattr(t_dist, "elastic_offsets",
                        lambda *a: (torch.from_numpy(dy),
                                    torch.from_numpy(dx)))
    want = j_dist.distort(jnp.asarray(images), jax.random.PRNGKey(0), **knobs)
    got = t_dist.distort(torch.from_numpy(images),
                         torch.Generator().manual_seed(0), **knobs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ACT)


def test_distortion_draws_are_seeded_and_in_range():
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    a = t_dist.affine_matrices(gen(0), 64, 15.0, 20.0)
    assert torch.equal(a, t_dist.affine_matrices(gen(0), 64, 15.0, 20.0))
    assert not torch.equal(a, t_dist.affine_matrices(gen(1), 64, 15.0, 20.0))
    # |det| of rotate-or-shear times a +-20% rescale lies in [0.64, 1.44]
    det = torch.linalg.det(a).abs()
    assert det.min() >= 0.64 - 1e-5 and det.max() <= 1.44 + 1e-5
    dy, dx = t_dist.elastic_offsets(gen(2), (2, 28, 28), 5, 2.0, 3.0)
    assert dy.shape == (2, 28, 28) and dy.abs().max() <= 3.0
    assert not torch.equal(dy, dx)
    img = torch.rand(2, 28, 28)
    knobs = dict(kernel=5, sigma=2.0, alpha=3.0, beta=10.0, gamma=15.0)
    assert torch.equal(t_dist.distort(img, gen(5), **knobs),
                       t_dist.distort(img, gen(5), **knobs))


def test_distort_with_knobs_off_is_identity():
    img = torch.rand(2, 9, 9)
    out = t_dist.distort(img, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(out.numpy(), img.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# derived generators
# ---------------------------------------------------------------------------


def test_fold_in_is_a_function_of_seed_and_data():
    root = torch.Generator().manual_seed(7)
    draws = [torch.rand(4, generator=fold_in(root, i)) for i in range(3)]
    again = torch.rand(4, generator=fold_in(
        torch.Generator().manual_seed(7), 1))
    assert torch.equal(draws[1], again)
    assert not torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[1], draws[2])
    # reading root does not change what it derives
    torch.rand(100, generator=root)
    assert torch.equal(torch.rand(4, generator=fold_in(root, 1)), draws[1])
    assert on_device(root, "cpu") is root
