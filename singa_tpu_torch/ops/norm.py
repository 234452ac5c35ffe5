"""Batch normalization with the JAX package's hand-written backward.

Counterpart of ``singa_tpu/ops/norm.py``. Both training ops are
``torch.autograd.Function``s whose backward is the JAX package's
``_bn_bwd`` (exact: the mean/var cotangent terms included) or
``_bns_bwd`` (the sampled op's straight-through backward):

  dgamma = sum(dy * xhat),  dbeta = sum(dy)
  dx     = gamma*inv * (dy - dbeta/n - xhat * dgamma/n)
           + dmean/n + 2*dvar*(x - mean)/n

The backward groups dx per channel as k * dy + (x - mean) * coef +
const: seven passes over activation-sized tensors (x - mean, dy's sum,
dy * (x - mean) and its sum, two multiply-adds, the cast back) where
the term-by-term form makes eleven; the rounding differs from JAX's by
the association only.

Batch moments are one pass in float32 (sum and sum of squares of
``x - shift``), anchored at an optional per-channel ``shift`` (the layer
passes its running mean). Where any channel's one-pass variance is
within 10x of the cancellation noise floor (var < 1e-5 * mean_shifted^2)
a cancellation-free variance replaces it. The JAX package decides that
with ``lax.cond``; a host ``if`` on a device value here would sync every
BatchNorm and break the graph capture, so both variances are computed
and ``torch.where`` picks one: the rescue costs one more read of ``x``
every call (``torch.var`` of the shifted float32 data, a one-pass
Welford reduction, where the JAX branch makes two passes around the
one-pass mean). ``RESCUE`` turns it
off for a timing of what it costs; nothing else sets it.

Under a low-precision ``x`` the per-channel ``scale`` and ``shift`` are
rounded to ``x.dtype`` before the multiply-add, as the JAX package
does; statistics and the running-stat updates stay float32.

Synchronised over data-parallel ranks (``batch_norm_train_sync``, the
JAX package's BatchNorm under a batch sharded by GSPMD): each rank of
the process computes its per-channel partial sums, and the partials of
every rank are summed in rank order through the mesh's ``gather`` (one
gather in the forward for (s1, s2), one in the backward for (dbeta,
dgamma)); mean and variance come from the global count. The rescue is
global too (a global mean, then a global sum of squared deviations),
decided on the host from the global moments, which every process holds
to the same bits, so every process takes the same collectives. The
sampled form takes the global batch's first rows, as the JAX op does on
the sharded batch: the ranks that hold them contribute their partials.
"""

from __future__ import annotations

import functools

import torch

#: compute the cancellation-free variance and take it where the one-pass
#: one is suspect (see the module docstring)
RESCUE = True


def _axes_shape(x: torch.Tensor):
    """Reduction dims and broadcast shape for (N, C) or (N, C, H, W)."""
    if x.dim() == 2:
        return (0,), (1, -1)
    return (0, 2, 3), (1, -1, 1, 1)


def _moments(x: torch.Tensor, axes, shape, n: int, shift):
    """One-pass float32 batch moments of ``x - shift`` -> (mean, var)."""
    if shift is None:
        xf = x.float()
    else:
        # a bf16 x promotes to float32 inside the subtraction
        xf = x - shift.float().reshape(shape)
    m = xf.sum(axes) / n
    var = torch.clamp_min((xf * xf).sum(axes) / n - m * m, 0.0)
    if RESCUE:
        suspect = (var * 1e5 < m * m).any()
        var = torch.where(suspect, torch.var(xf, dim=axes, correction=0),
                          var)
    mean = m if shift is None else m + shift.float()
    return mean, var


def _normalize(x, gamma, beta, mean, var, eps, shape):
    """y = x * scale + shift, scale and shift rounded to x.dtype ->
    (y, inv)."""
    inv = torch.rsqrt(var + eps)
    scale = gamma.float() * inv
    sh = beta.float() - scale * mean
    y = x * scale.to(x.dtype).reshape(shape) + sh.to(x.dtype).reshape(shape)
    return y, inv


class _BatchNormTrain(torch.autograd.Function):
    """(x, gamma, beta, eps, shift) -> (y, mean, var), JAX's _bn_bwd."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, shift):
        axes, shape = _axes_shape(x)
        n = x.numel() // x.shape[1]
        mean, var = _moments(x, axes, shape, n, shift)
        y, inv = _normalize(x, gamma, beta, mean, var, eps, shape)
        ctx.save_for_backward(x, gamma, mean, inv)
        ctx.set_materialize_grads(False)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x, gamma, mean, inv = ctx.saved_tensors
        axes, shape = _axes_shape(x)
        n = x.numel() // x.shape[1]
        if dy is None:
            dy = torch.zeros_like(x)
        xc = x - mean.reshape(shape)
        dbeta, dgamma = _param_grads(dy, xc, inv, axes)
        # dx = k * (dy - dbeta/n - xhat * dgamma/n), k = gamma * inv, as
        # k * dy + xc * coef + const with per-channel coef and const: one
        # pass over xc and one over dy instead of one per term
        k = gamma.float() * inv
        coef = -k * inv * dgamma / n
        const = -k * dbeta / n
        # the mean/var cotangents: None when the outputs were not used
        # (the layer detaches them for the running stats)
        if dmean is not None:
            const = const + dmean / n
        if dvar is not None:
            coef = coef + 2.0 / n * dvar
        dxf = torch.addcmul(const.reshape(shape), xc, coef.reshape(shape))
        dxf.addcmul_(dy, k.reshape(shape))
        return (dxf.to(x.dtype), dgamma.to(gamma.dtype),
                dbeta.to(gamma.dtype), None, None)


def _param_grads(dy, xc, inv, axes):
    """(dbeta, dgamma) = (sum dy, sum dy * xhat) with xhat = xc * inv,
    float32, dy read in its own dtype."""
    dbeta = dy.sum(axes, dtype=torch.float32)
    dgamma = (dy * xc).sum(axes) * inv
    return dbeta, dgamma


class _BatchNormTrainSampled(torch.autograd.Function):
    """Moments from the first batch/stride rows; JAX's _bns_bwd."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, stride, shift):
        axes, shape = _axes_shape(x)
        # a contiguous prefix of the (shuffled) batch, as the JAX op takes
        xs = x[:max(1, x.shape[0] // stride)]
        n = xs.numel() // xs.shape[1]
        mean, var = _moments(xs, axes, shape, n, shift)
        y, inv = _normalize(x, gamma, beta, mean, var, eps, shape)
        ctx.save_for_backward(x, gamma, mean, inv)
        ctx.set_materialize_grads(False)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        # the stats are detached: their cotangents drop
        x, gamma, mean, inv = ctx.saved_tensors
        axes, shape = _axes_shape(x)
        if dy is None:
            return None, None, None, None, None, None
        dbeta, dgamma = _param_grads(dy, x - mean.reshape(shape), inv, axes)
        # straight-through: dx does not depend on the reductions
        dx = dy * (gamma.float() * inv).reshape(shape)
        return (dx.to(x.dtype), dgamma.to(gamma.dtype),
                dbeta.to(gamma.dtype), None, None, None)


def batch_norm_train(x, gamma, beta, eps=1e-5, shift=None):
    """-> (y, mean, var). Batch stats are float32; y stays in x.dtype.

    ``shift`` (optional, (C,)) anchors the one-pass moments: pass a
    running-mean estimate; it does not change the math and gets no
    gradient."""
    return _BatchNormTrain.apply(x, gamma, beta, eps, shift)


def batch_norm_train_sampled(x, gamma, beta, eps, stride, shift=None):
    """Subsample-stats BatchNorm (opt-in, different math): moments from
    the first ``batch // stride`` rows, treated as constants by the
    backward (dx = gamma * inv * dy; dgamma and dbeta exact over the
    whole batch). -> (y, mean, var) like :func:`batch_norm_train`."""
    return _BatchNormTrainSampled.apply(x, gamma, beta, eps, stride, shift)


def batch_norm_infer(x, gamma, beta, mean, var, eps=1e-5):
    """Normalize by running stats (the eval path): one elementwise pass,
    plain autograd."""
    _, shape = _axes_shape(x)
    y, _ = _normalize(x, gamma, beta, mean.float(), var.float(), eps, shape)
    return y


def _rank_sum(sync, parts: list, device) -> torch.Tensor:
    """This process's ranks' partials ``parts`` (one shape) summed with
    every other rank's, in rank order, on ``device``."""
    every = sync.gather([{"p": p} for p in parts], device)
    return functools.reduce(torch.add, (e["p"].to(device) for e in every))


def _shifted(x, shift, shape):
    """``x - shift`` in float32 (``x`` itself, as float32, without one)."""
    if shift is None:
        return x.float()
    return x - shift.to(x.device).float().reshape(shape)


def _sync_moments(sync, xfs: list, axes, shape, count: int, shift):
    """Global moments of the ranks' shifted rows ``xfs`` -> (mean, var)
    on the first's device: the one-pass form from summed (s1, s2), the
    rescue's global two-pass form where it is suspect."""
    dev = xfs[0].device
    tot = _rank_sum(sync, [torch.stack([xf.sum(axes), (xf * xf).sum(axes)])
                           for xf in xfs], dev)
    m = tot[0] / count
    var = torch.clamp_min(tot[1] / count - m * m, 0.0)
    if RESCUE and bool((var * 1e5 < m * m).any()):
        dev_sq = []
        for xf in xfs:
            d = xf - m.to(xf.device).reshape(shape)
            dev_sq.append((d * d).sum(axes))
        var = _rank_sum(sync, dev_sq, dev) / count
    mean = m if shift is None else m + shift.to(dev).float()
    return mean, var


class _BatchNormTrainSync(torch.autograd.Function):
    """(eps, shift, sync, count, k, *xs, *gammas, *betas) for the k ranks
    of this process -> (*ys, mean, var), the statistics over every rank
    of ``sync``; the backward sums the ranks' (dbeta, dgamma) the same
    way before forming each rank's dx, and gives each rank's gamma and
    beta its own partials."""

    @staticmethod
    def forward(ctx, eps, shift, sync, count, k, *args):
        xs, gammas, betas = args[:k], args[k:2 * k], args[2 * k:]
        axes, shape = _axes_shape(xs[0])
        xfs = [_shifted(x, shift, shape) for x in xs]
        mean, var = _sync_moments(sync, xfs, axes, shape, count, shift)
        ys = []
        for x, gamma, beta in zip(xs, gammas, betas):
            y, inv = _normalize(x, gamma, beta, mean.to(x.device),
                                var.to(x.device), eps, shape)
            ys.append(y)
        ctx.save_for_backward(*xs, *gammas, mean, torch.rsqrt(var + eps))
        ctx.sync, ctx.count, ctx.k = sync, count, k
        ctx.mark_non_differentiable(mean, var)
        ctx.set_materialize_grads(False)
        return (*ys, mean, var)

    @staticmethod
    def backward(ctx, *grads):
        k, n = ctx.k, ctx.count
        saved = ctx.saved_tensors
        xs, gammas = saved[:k], saved[k:2 * k]
        mean, inv = saved[2 * k:]
        axes, shape = _axes_shape(xs[0])
        dys = [torch.zeros_like(x) if dy is None else dy
               for x, dy in zip(xs, grads[:k])]
        xcs = [x - mean.to(x.device).reshape(shape) for x in xs]
        parts = [torch.stack([dy.sum(axes, dtype=torch.float32),
                              (dy * xc).sum(axes)])
                 for dy, xc in zip(dys, xcs)]
        tot = _rank_sum(ctx.sync, parts, xs[0].device)
        dxs, dgammas, dbetas = [], [], []
        for x, gamma, dy, xc, part in zip(xs, gammas, dys, xcs, parts):
            inv_r = inv.to(x.device)
            dbeta, dgamma = tot[0].to(x.device), tot[1].to(x.device) * inv_r
            # JAX's _bn_bwd over the global batch, grouped as in
            # _BatchNormTrain.backward
            kk = gamma.float() * inv_r
            coef = -kk * inv_r * dgamma / n
            const = -kk * dbeta / n
            dxf = torch.addcmul(const.reshape(shape), xc, coef.reshape(shape))
            dxf.addcmul_(dy, kk.reshape(shape))
            dxs.append(dxf.to(x.dtype))
            dgammas.append((part[1] * inv_r).to(gamma.dtype))
            dbetas.append(part[0].to(gamma.dtype))
        return (None, None, None, None, None, *dxs, *dgammas, *dbetas)


class _BatchNormTrainSampledSync(torch.autograd.Function):
    """(eps, shift, sync, keeps, count, k, *xs, *gammas, *betas) -> (*ys,
    mean, var): moments from the first ``keeps[j]`` rows of rank j's x
    summed over every rank of ``sync``; JAX's _bns_bwd on each rank (no
    exchange: dx does not depend on the reductions)."""

    @staticmethod
    def forward(ctx, eps, shift, sync, keeps, count, k, *args):
        xs, gammas, betas = args[:k], args[k:2 * k], args[2 * k:]
        axes, shape = _axes_shape(xs[0])
        xfs = [_shifted(x[:keep], shift, shape) for x, keep in zip(xs, keeps)]
        mean, var = _sync_moments(sync, xfs, axes, shape, count, shift)
        ys = []
        for x, gamma, beta in zip(xs, gammas, betas):
            y, _ = _normalize(x, gamma, beta, mean.to(x.device),
                              var.to(x.device), eps, shape)
            ys.append(y)
        ctx.save_for_backward(*xs, *gammas, mean, torch.rsqrt(var + eps))
        ctx.k = k
        ctx.mark_non_differentiable(mean, var)
        ctx.set_materialize_grads(False)
        return (*ys, mean, var)

    @staticmethod
    def backward(ctx, *grads):
        k = ctx.k
        saved = ctx.saved_tensors
        xs, gammas = saved[:k], saved[k:2 * k]
        mean, inv = saved[2 * k:]
        axes, shape = _axes_shape(xs[0])
        dxs, dgammas, dbetas = [], [], []
        for x, gamma, dy in zip(xs, gammas, grads[:k]):
            if dy is None:
                dy = torch.zeros_like(x)
            inv_r = inv.to(x.device)
            dbeta, dgamma = _param_grads(
                dy, x - mean.to(x.device).reshape(shape), inv_r, axes)
            dxs.append((dy * (gamma.float() * inv_r).reshape(shape))
                       .to(x.dtype))
            dgammas.append(dgamma.to(gamma.dtype))
            dbetas.append(dbeta.to(gamma.dtype))
        return (None,) * 6 + (*dxs, *dgammas, *dbetas)


def batch_norm_train_sync(xs: list, gammas: list, betas: list, eps, sync,
                          shift=None):
    """:func:`batch_norm_train` over the global batch of every rank of
    ``sync`` (the mesh), given this process's ranks' inputs and params
    -> (their ys, mean, var); the mean and var on the first input's
    device, the same bits in every process."""
    k = len(xs)
    per_rank = xs[0].numel() // xs[0].shape[1]
    out = _BatchNormTrainSync.apply(eps, shift, sync, per_rank * sync.width,
                                    k, *xs, *gammas, *betas)
    return list(out[:k]), out[k], out[k + 1]


def batch_norm_train_sampled_sync(xs: list, gammas: list, betas: list, eps,
                                  stride, sync, shift=None):
    """:func:`batch_norm_train_sampled` over the global batch: its first
    ``batch // stride`` rows (the global batch laid over the ranks in
    rank order, ``xs`` this process's) -> (ys, mean, var)."""
    k = len(xs)
    b = xs[0].shape[0]
    nkeep = max(1, b * sync.width // stride)
    keeps = [min(b, max(0, nkeep - r * b)) for r in sync.local_ranks]
    per_row = xs[0].numel() // (b * xs[0].shape[1])
    out = _BatchNormTrainSampledSync.apply(
        eps, shift, sync, keeps, nkeep * per_row, k, *xs, *gammas, *betas)
    return list(out[:k]), out[k], out[k + 1]
