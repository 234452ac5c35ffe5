"""Data layers: the host/device boundary.

Counterpart of the data-layer half of ``singa_tpu/layers/data.py``: at
build time a data layer opens its source to learn the sample shape
(like ShardDataLayer::Setup reading one record, reference
layer.cc:662-672), and at run time the trainer feeds its batches in.
Its ``apply`` just forwards that input. Ported: kShardData. kLMDBData
and the parser layers (kMnistImage, kRGBImage, kLabel) wait for the
slice that trains the image nets.
"""

from __future__ import annotations

from typing import Sequence

from ..config.schema import ConfigError
from ..data.pipeline import load_shard_arrays
from .base import Layer, Shape


class _ArrayDataLayer(Layer):
    """Shared data-layer shape: open the source at build time to learn the
    sample shape, hold the decoded arrays, forward the fed batch."""

    is_datalayer = True
    LOADER: staticmethod  # (path) -> (images, labels)

    def setup(self, src_shapes: Sequence[Shape], batchsize: int) -> Shape:
        p = self.cfg.data_param
        if p is None or not p.path or not p.batchsize:
            raise ConfigError(
                f"layer {self.name!r}: data_param.path and batchsize required"
            )
        self.path = p.path
        self.batchsize = p.batchsize
        self.random_skip = p.random_skip
        self.images, self.labels = type(self).LOADER(self.path)
        self.sample_shape = tuple(self.images.shape[1:])
        return (self.batchsize, *self.sample_shape)

    def apply(self, params, inputs, *, training):
        # inputs[0] is the externally-fed batch dict {"image","label"}
        return inputs[0]


class ShardDataLayer(_ArrayDataLayer):
    """kShardData (reference: layer.cc:646-673)."""

    TYPE = "kShardData"
    LOADER = staticmethod(load_shard_arrays)
