"""Loss layers: kSoftmaxLoss and kEuclideanLoss.

Counterpart of ``singa_tpu/layers/loss.py`` (reference:
SoftmaxLossLayer, src/worker/layer.cc:704-764). ``apply`` returns
(loss, metrics); ``Net.forward`` sums the losses and the trainer
averages the metrics like the reference's Performance class
(worker.cc:350-386).
"""

from __future__ import annotations

from typing import Sequence

from ..config.schema import ConfigError
from ..ops import nn
from .base import Layer, Shape, feature_dim


class SoftmaxLossLayer(Layer):
    """kSoftmaxLoss: softmax + cross-entropy + top-k precision, over
    (logits, label) srclayers. Refuses kLayerPartition like the
    reference (layer.h:216-221); a net-level kLayerPartition never
    reaches here (``build_net`` refuses every partition_type)."""

    TYPE = "kSoftmaxLoss"
    is_losslayer = True

    def setup(self, src_shapes: Sequence[Shape], batchsize: int) -> Shape:
        if len(src_shapes) != 2:
            raise ConfigError(
                f"layer {self.name!r}: kSoftmaxLoss needs (logits, label) "
                f"srclayers, got {len(src_shapes)}"
            )
        if self.cfg.partition_type == "kLayerPartition":
            raise ConfigError(
                f"layer {self.name!r}: kSoftmaxLoss cannot be "
                "layer-partitioned"
            )
        p = self.cfg.softmaxloss_param
        self.topk = p.topk if p else 1
        self.scale = p.scale if p else 1.0
        return src_shapes[0]

    def apply(self, params, inputs, *, training, generator=None):
        logits, labels = inputs
        return nn.softmax_loss(logits, labels, topk=self.topk,
                               scale=self.scale)


class EuclideanLossLayer(Layer):
    """kEuclideanLoss: 0.5 * mean over the batch of sum((pred -
    target)²), in float32 — the JAX package's regression loss for
    BASELINE config 4's deep autoencoder, where the target srclayer is
    the input image. Both inputs flatten to (batch, -1)."""

    TYPE = "kEuclideanLoss"
    is_losslayer = True

    def setup(self, src_shapes: Sequence[Shape], batchsize: int) -> Shape:
        if len(src_shapes) != 2:
            raise ConfigError(
                f"layer {self.name!r}: kEuclideanLoss needs (prediction, "
                f"target) srclayers, got {len(src_shapes)}"
            )
        pdim = feature_dim(src_shapes[0])
        tdim = feature_dim(src_shapes[1])
        if pdim != tdim:
            raise ConfigError(
                f"layer {self.name!r}: prediction size {pdim} != target "
                f"size {tdim}"
            )
        return src_shapes[0]

    def apply(self, params, inputs, *, training, generator=None):
        pred = inputs[0].reshape(inputs[0].shape[0], -1).float()
        target = inputs[1].reshape(inputs[1].shape[0], -1).float()
        loss = 0.5 * ((pred - target) ** 2).sum(dim=1).mean()
        return loss, {"loss": loss}
