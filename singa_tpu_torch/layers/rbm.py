"""Restricted Boltzmann machine layer (the contrastive-divergence path),
from ``singa_tpu/layers/rbm.py``.

In a kBackPropagation net (or at eval time) the layer is a feature
extractor: ``apply`` returns the mean-field hidden probabilities, which
lets stacked RBMs form the encoder of a deep autoencoder (pretrain with
alg kContrastiveDivergence, ``trainer/cd.py``, then kPretrained-init
the unrolled net).

Every Bernoulli draw of the Gibbs chain goes through :func:`bernoulli`,
``uniform < p`` as JAX's ``jax.random.bernoulli(key, p)`` is; the
uniforms are activation-sized and drawn on ``p``'s device, so a net
with an RBM trains eagerly (``draws_on_device``).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..config.schema import ConfigError
from ..parallel.axes import concate, rank_sum
from ..utils.rng import fold_in, on_device
from .base import Layer, Shape, feature_dim, require_one_src


def bernoulli(generator: torch.Generator, p: torch.Tensor) -> torch.Tensor:
    """A bool sample, True with probability ``p``: uniforms drawn on p's
    device from ``generator``'s seed, compared with ``p``."""
    u = torch.rand(p.shape, generator=on_device(generator, p.device),
                   device=p.device)
    return u < p


class RBMLayer(Layer):
    """kRBM: binary-binary RBM with weight (V,H), vbias (V), hbias (H)."""

    TYPE = "kRBM"
    uses_generator = True
    draws_on_device = True

    def setup(self, src_shapes: Sequence[Shape], batchsize: int) -> Shape:
        p = self.cfg.rbm_param
        if p is None or not p.num_hidden:
            raise ConfigError(
                f"layer {self.name!r}: rbm_param.num_hidden required"
            )
        src = require_one_src(self, src_shapes)
        vdim = feature_dim(src)
        self.vdim, self.hdim = vdim, p.num_hidden
        self.cd_k = max(1, p.cd_k)
        self.sample_visible = p.sample_visible
        self.wname = self._declare_param(
            0, "weight", (vdim, self.hdim),
            fan_in=vdim * self.hdim,  # the FC convention (layer.cc:178)
            neuron_axis=1,
        )
        self.vbname = self._declare_param(1, "vbias", (vdim,))
        self.hbname = self._declare_param(2, "hbias", (self.hdim,),
                                          neuron_axis=0)
        return (src[0], self.hdim)

    # ---------------- mean-field propagation ----------------

    def _flat(self, params, v: torch.Tensor) -> torch.Tensor:
        return v.reshape(v.shape[0], -1).to(params[self.wname].dtype)

    def prop_up(self, params, v: torch.Tensor) -> torch.Tensor:
        """P(h=1|v) = sigmoid(vW + hbias)."""
        return torch.sigmoid(
            self._flat(params, v) @ params[self.wname] + params[self.hbname])

    def prop_down(self, params, h: torch.Tensor) -> torch.Tensor:
        """P(v=1|h) = sigmoid(hW^T + vbias)."""
        return torch.sigmoid(h @ params[self.wname].T + params[self.vbname])

    def apply(self, params, inputs, *, training, generator=None):
        """Feature-extractor view: mean hidden probabilities."""
        return self.prop_up(params, inputs[0])

    # ---------------- contrastive divergence ----------------

    def cd_grads(self, params, v0, generator):
        """One CD-k estimate, no autograd -> (grads, metrics).

        Hidden states are sampled while driving the chain, the final
        hidden uses probabilities, the positive phase uses h0
        probabilities, and grads are descent-oriented (neg - pos)/batch,
        so the updaters (which subtract) ascend the log-likelihood. Draw
        j of the chain comes from ``fold_in(generator, j)``, as the JAX
        layer folds its key."""
        grads, metrics = self.cd_grads_ranks([params], v0, generator)
        return {n: g[0] for n, g in grads.items()}, metrics

    # ---------------- kLayerPartition: the hidden units split ----------------

    def crosses(self) -> bool:
        return self.model_split()

    def _up_ranks(self, ps: list, v):
        """P(h=1|v) from the model ranks' shards ``ps`` (weight columns,
        hbias slice): each rank's hidden units, Concate in rank order,
        the pad cut off."""
        return concate([self.prop_up(p, v) for p in ps], -1)[:, :self.hdim]

    def _down_ranks(self, ps: list, h):
        """P(v=1|h): the model ranks' partial products of their hidden
        units, summed in rank order."""
        m = ps[0][self.wname].shape[1]
        h = torch.nn.functional.pad(h, (0, m * len(ps) - self.hdim))
        return torch.sigmoid(rank_sum(
            h[:, k * m:(k + 1) * m] @ p[self.wname].T
            for k, p in enumerate(ps)) + ps[0][self.vbname])

    def apply_ranks(self, params, inputs, lanes, *, training):
        """Feature-extractor view over the model ranks' hidden units:
        each rank's units, every lane's Concate of the group's in rank
        order (``Lanes.exchange``), the pad cut off."""
        outs = [None] * len(params)
        for g in lanes.groups("model"):
            parts = lanes.exchange(g, [self.prop_up(params[j], inputs[j][0])
                                       for j in g])
            for j, whole in zip(g, parts):
                outs[j] = concate(whole, -1)[:, :self.hdim]
        return outs

    def cd_grads_ranks(self, ps: list, v0, generator):
        """``cd_grads`` with the hidden units split over the model ranks
        (``ps[k]`` rank k's shards; one rank: the whole params): the
        same chain and draws, each rank's hidden units from its shards
        -> ({param: [each rank's gradient of its piece]}, metrics). The
        padded tail of the last piece takes a zero gradient."""
        v0 = self._flat(ps[0], v0)
        batch = v0.shape[0]
        m = ps[0][self.wname].shape[1]
        h0p = self._up_ranks(ps, v0)
        hk = bernoulli(fold_in(generator, 0), h0p).to(v0.dtype)
        vkp = v0
        for k in range(self.cd_k):
            vkp = self._down_ranks(ps, hk)
            vk = (bernoulli(fold_in(generator, 2 * k + 1), vkp).to(v0.dtype)
                  if self.sample_visible else vkp)
            hkp = self._up_ranks(ps, vk)
            if k + 1 < self.cd_k:
                hk = bernoulli(fold_in(generator, 2 * k + 2),
                               hkp).to(v0.dtype)
        pad = (0, m * len(ps) - self.hdim)
        hkp, h0p = (torch.nn.functional.pad(t, pad) for t in (hkp, h0p))
        cols = [slice(k * m, (k + 1) * m) for k in range(len(ps))]
        grads = {
            self.wname: [(vkp.T @ hkp[:, c] - v0.T @ h0p[:, c]) / batch
                         for c in cols],
            self.vbname: [(vkp - v0).mean(0)],
            self.hbname: [(hkp[:, c] - h0p[:, c]).mean(0) for c in cols],
        }
        return grads, {"loss": (v0 - vkp).square().mean()}

    def recon_error(self, params, v):
        """Eval metric: one mean-field reconstruction pass."""
        v = self._flat(params, v)
        vp = self.prop_down(params, self.prop_up(params, v))
        return (v - vp).square().mean()
