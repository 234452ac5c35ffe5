"""Normalization and residual layers: kBatchNorm, kAdd, kGlobalPooling,
from ``singa_tpu/layers/norm.py``.

kBatchNorm's running statistics are buffers (``layers/base.py``
BufferSpec): updated by the layer inside the step, carried between
steps by the Trainer in place, checkpointed under ``b|`` keys. The JAX
package gets BatchNorm synchronised over the global batch from GSPMD;
the port gets it from ``apply_stateful_ranks``, which the Trainer's
lockstep forward over several ranks calls with every rank's input: the
moments and the backward's sums are taken over all ranks, and the
running stats update from the global moments.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..config.schema import ConfigError
from ..ops import norm
from ..parallel.axes import concate
from ..parallel.mesh import Mesh
from .base import Layer, Shape, require_one_src


class BatchNormLayer(Layer):
    """kBatchNorm: per-channel batch normalization (NCHW axis 1, or the
    feature axis of 2-D inputs).

    Training normalizes by batch statistics and folds them into running
    stats with Caffe's momentum convention (running = momentum *
    running + (1 - momentum) * batch, the biased batch variance);
    eval normalizes by the running stats. ``F.batch_norm``'s own
    running update is not used: it folds in the unbiased variance with
    the complementary momentum."""

    TYPE = "kBatchNorm"

    def setup(self, src_shapes: Sequence[Shape], batchsize: int) -> Shape:
        p = self.cfg.batchnorm_param
        self.momentum = p.momentum if p else 0.9
        self.eps = p.eps if p else 1e-5
        self.stats_stride = p.stats_sample_stride if p else 1
        if self.stats_stride < 1:
            raise ConfigError(
                f"layer {self.name!r}: stats_sample_stride must be >= 1"
            )
        # a stride that leaves 1-2 rows drives the per-channel variance
        # toward 0 and inv toward rsqrt(eps): silent divergence
        if self.stats_stride > 1 and batchsize // self.stats_stride < 8:
            raise ConfigError(
                f"layer {self.name!r}: stats_sample_stride "
                f"{self.stats_stride} leaves "
                f"{max(batchsize // self.stats_stride, 0)} of {batchsize} "
                "sample rows for the batch moments (need >= 8)"
            )
        src = require_one_src(self, src_shapes)
        if len(src) not in (2, 4):
            raise ConfigError(
                f"layer {self.name!r}: kBatchNorm needs (N,C,H,W) or (N,F) "
                f"input, got {src}"
            )
        c = src[1]
        self.gname = self._declare_param(0, "gamma", (c,), neuron_axis=0)
        self.bname = self._declare_param(1, "beta", (c,), neuron_axis=0)
        self.mean_buf = self._declare_buffer("running_mean", (c,), 0.0)
        self.var_buf = self._declare_buffer("running_var", (c,), 1.0)
        return src

    def apply_stateful(self, params, buffers, inputs, *, training,
                       generator=None):
        x = inputs[0]
        gamma, beta = params[self.gname], params[self.bname]
        if not training:
            return norm.batch_norm_infer(
                x, gamma, beta, buffers[self.mean_buf],
                buffers[self.var_buf], self.eps), {}
        # the running mean anchors the one-pass moments
        anchor = buffers[self.mean_buf].detach()
        if self.stats_stride > 1:
            y, mean, var = norm.batch_norm_train_sampled(
                x, gamma, beta, self.eps, self.stats_stride, shift=anchor)
        else:
            y, mean, var = norm.batch_norm_train(
                x, gamma, beta, self.eps, shift=anchor)
        # the running stats are a detached side effect
        return y, self._running(buffers, mean.detach(), var.detach())

    def _running(self, buffers, mean, var) -> dict:
        """The running-stat updates from the batch moments (Caffe's
        momentum convention)."""
        m = self.momentum
        return {self.mean_buf: m * buffers[self.mean_buf] + (1 - m) * mean,
                self.var_buf: m * buffers[self.var_buf] + (1 - m) * var}

    def _sync_train(self, xs, gammas, betas, sync, shift):
        """The training normalization of ranks' inputs ``xs`` with the
        moments over the ranks of ``sync`` -> (each rank's output, mean,
        var), sampled or not as the layer is."""
        if self.stats_stride > 1:
            return norm.batch_norm_train_sampled_sync(
                xs, gammas, betas, self.eps, self.stats_stride, sync,
                shift=shift)
        return norm.batch_norm_train_sync(xs, gammas, betas, self.eps, sync,
                                          shift=shift)

    def apply_stateful_ranks(self, params: list, buffers, inputs: list, *,
                             sync):
        """The training ``apply_stateful`` of every rank of this process
        at once, ``params[j]`` and ``inputs[j]`` rank j's, the batch
        statistics those of the global batch over the ranks of ``sync``
        (the mesh) -> (each rank's output, the running-stat updates from
        the global moments)."""
        ys, mean, var = self._sync_train(
            [x[0] for x in inputs], [p[self.gname] for p in params],
            [p[self.bname] for p in params], sync,
            buffers[self.mean_buf].detach())
        return ys, self._running(buffers, mean, var)

    def apply_stateful_lanes(self, params: list, buffers, inputs: list,
                             lanes):
        """``apply_stateful_ranks`` on a mesh with more axes than data:
        the moments of each group of lanes that differ in their data
        index only (the ranks of the other axes hold the same rows, so a
        sum over every rank would count each row once per such rank).
        Under kLayerPartition each model rank normalises its slice of the
        (zero-padded) channels with its ``gamma``/``beta`` shard, the
        slices concatenated in rank order and the pad cut off; the
        running stats take each model index's moments in that order."""
        split = self.model_split()
        chans = inputs[0][0].shape[1]
        width = lanes.mesh.widths["model"] if split else 1
        m = -(-chans // width)
        anchor = torch.nn.functional.pad(
            buffers[self.mean_buf].detach(), (0, m * width - chans))
        ys: list = [None] * len(params)
        moments: dict[int, tuple] = {}
        for g in lanes.groups("data"):
            k = lanes.coords(g[0])["model"] if split else 0
            xs = [inputs[j][0] for j in g]
            if split:
                pad = [0, 0] * (xs[0].dim() - 2) + [0, m * width - chans]
                xs = [torch.nn.functional.pad(x, pad)
                      .narrow(1, k * m, m) for x in xs]
            sync = Mesh(tuple(lanes.mesh.device(lanes.ranks[j])
                              for j in g))
            out, mean, var = self._sync_train(
                xs, [params[j][self.gname] for j in g],
                [params[j][self.bname] for j in g], sync,
                anchor.narrow(0, k * m, m))
            moments.setdefault(k, (mean, var))
            for j, y in zip(g, out):
                ys[j] = y
        if split:
            # lane j takes the model ranks' slices of its own lanes
            parts = {}
            for j in range(len(params)):
                c = lanes.coords(j)
                parts.setdefault(tuple(v for a, v in c.items()
                                       if a != "model"), {})[c["model"]] = j
            outs = [None] * len(params)
            for by_model in parts.values():
                y = concate([ys[by_model[k]] for k in sorted(by_model)],
                            1).narrow(1, 0, chans)
                for j in by_model.values():
                    outs[j] = y
            ys = outs
        return ys, self._running(buffers, *(
            torch.cat([moments[k][i] for k in sorted(moments)])[:chans]
            for i in (0, 1)))

    def apply(self, params, inputs, *, training, generator=None):
        raise RuntimeError(
            f"layer {self.name!r}: kBatchNorm is stateful; the net must "
            "call apply_stateful"
        )


class AddLayer(Layer):
    """kAdd: elementwise sum of all srclayers — the residual connection.
    Shapes must match exactly."""

    TYPE = "kAdd"
    decode_positionwise = True  # elementwise: decode reuses apply

    def setup(self, src_shapes: Sequence[Shape], batchsize: int) -> Shape:
        if len(src_shapes) < 2:
            raise ConfigError(
                f"layer {self.name!r}: kAdd needs >= 2 srclayers"
            )
        first = src_shapes[0]
        for s in src_shapes[1:]:
            if tuple(s) != tuple(first):
                raise ConfigError(
                    f"layer {self.name!r}: kAdd shape mismatch {first} vs {s}"
                )
        return first

    def apply(self, params, inputs, *, training, generator=None):
        out = inputs[0]
        for x in inputs[1:]:
            out = out + x
        return out


class GlobalPoolingLayer(Layer):
    """kGlobalPooling: mean (AVE, default) or max over the spatial dims of
    an NCHW input -> (N, C)."""

    TYPE = "kGlobalPooling"

    def setup(self, src_shapes: Sequence[Shape], batchsize: int) -> Shape:
        p = self.cfg.globalpooling_param
        self.pool = p.pool if p else "AVE"
        src = require_one_src(self, src_shapes)
        if len(src) != 4:
            raise ConfigError(
                f"layer {self.name!r}: kGlobalPooling needs NCHW input"
            )
        return (src[0], src[1])

    def apply(self, params, inputs, *, training, generator=None):
        x = inputs[0]
        if self.pool == "MAX":
            return x.amax(dim=(2, 3))
        return x.mean(dim=(2, 3))
