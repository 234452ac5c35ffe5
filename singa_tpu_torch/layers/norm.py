"""Residual addition: kAdd, from ``singa_tpu/layers/norm.py``.

kBatchNorm (with its custom backward) and kGlobalPooling wait for the
slice that trains ResNet-50 (ROADMAP).
"""

from __future__ import annotations

from typing import Sequence

from ..config.schema import ConfigError
from .base import Layer, Shape


class AddLayer(Layer):
    """kAdd: elementwise sum of all srclayers — the residual connection.
    Shapes must match exactly."""

    TYPE = "kAdd"

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
