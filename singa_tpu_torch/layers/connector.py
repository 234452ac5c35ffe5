"""Connector layers: Slice, Concate, Split, BridgeSrc/BridgeDst.

Counterpart of ``singa_tpu/layers/connector.py``. In the reference
these are the partition plumbing that the graph rewriter inserts
(src/worker/neuralnet.cc:198-323, src/worker/base_layer.cc:39-191).
Here, as in the JAX package, they are explicit in-graph dataflow so
that job files that name them run: kSlice's k-th output feeds its k-th
consumer (the Slice cursor of ``Net.forward``), and on one device both
bridge halves are identities.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..config.schema import ConfigError
from .base import Layer, Shape, require_one_src


class SliceLayer(Layer):
    """kSlice (reference: base_layer.cc:114-173): split the input into
    slice_num equal parts along slice_dimension. The reference gives the
    last part the remainder (base_layer.cc:127-128); the JAX package
    requires even division, and so does this one."""

    TYPE = "kSlice"

    def setup(self, src_shapes: Sequence[Shape], batchsize: int) -> Shape:
        p = self.cfg.slice_param
        if p is None or not p.slice_num:
            raise ConfigError(f"layer {self.name!r}: slice_param required")
        self.dim, self.num = p.slice_dimension, p.slice_num
        src = require_one_src(self, src_shapes)
        if src[self.dim] % self.num:
            raise ConfigError(
                f"layer {self.name!r}: dim {self.dim} size {src[self.dim]} "
                f"not divisible by slice_num {self.num} (slices are even; "
                "pad or round the net width)"
            )
        out = list(src)
        out[self.dim] //= self.num
        return tuple(out)

    def apply(self, params, inputs, *, training, generator=None):
        return list(torch.chunk(inputs[0], self.num, dim=self.dim))


class ConcateLayer(Layer):
    """kConcate (reference: base_layer.cc:85-110)."""

    TYPE = "kConcate"

    def setup(self, src_shapes: Sequence[Shape], batchsize: int) -> Shape:
        p = self.cfg.concate_param
        if p is None:
            raise ConfigError(f"layer {self.name!r}: concate_param required")
        self.dim = p.concate_dimension
        out = list(src_shapes[0])
        out[self.dim] = sum(s[self.dim] for s in src_shapes)
        return tuple(out)

    def apply(self, params, inputs, *, training, generator=None):
        return torch.cat(inputs, dim=self.dim)


class SplitLayer(Layer):
    """kSplit (reference: base_layer.cc:175-191): fan the same blob out to
    num_splits consumers. Identity in a functional graph."""

    TYPE = "kSplit"

    def setup(self, src_shapes: Sequence[Shape], batchsize: int) -> Shape:
        return require_one_src(self, src_shapes)

    def apply(self, params, inputs, *, training, generator=None):
        return inputs[0]


class _BridgeLayer(Layer):
    """A location-crossing edge (base_layer.h:264-312): identity on one
    device."""

    def setup(self, src_shapes: Sequence[Shape], batchsize: int) -> Shape:
        return require_one_src(self, src_shapes)

    def apply(self, params, inputs, *, training, generator=None):
        return inputs[0]


class BridgeSrcLayer(_BridgeLayer):
    TYPE = "kBridgeSrc"


class BridgeDstLayer(_BridgeLayer):
    TYPE = "kBridgeDst"
