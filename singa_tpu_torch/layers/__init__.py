"""Layer registry.

Counterpart of ``singa_tpu/layers/__init__.py``: a string-keyed factory
mirroring the reference's Factory<Layer> (src/worker/neuralnet.cc:13-33).
It registers the types the port has: the conf-driven transformer LM's
vocabulary, the image nets' (neuron, loss, parser and connector
layers), kShardData, kRBM, and ResNet's kBatchNorm, kAdd and
kGlobalPooling. A type the JAX package has and the port does
not yet raises a ConfigError that says so; nothing is skipped.
"""

from __future__ import annotations

from ..config.schema import ConfigError, LayerConfig
from .base import Layer
from .connector import (
    BridgeDstLayer,
    BridgeSrcLayer,
    ConcateLayer,
    SliceLayer,
    SplitLayer,
)
from .data import LabelLayer, MnistImageLayer, RGBImageLayer, ShardDataLayer
from .loss import EuclideanLossLayer, SoftmaxLossLayer
from .neuron import (
    ConvolutionLayer,
    DropoutLayer,
    InnerProductLayer,
    LRNLayer,
    PoolingLayer,
    ReLULayer,
    SigmoidLayer,
    TanhLayer,
)
from .norm import AddLayer, BatchNormLayer, GlobalPoolingLayer
from .rbm import RBMLayer
from .sequence import (
    AttentionLayer,
    DenseLayer,
    EmbeddingLayer,
    LayerNormLayer,
    LMLossLayer,
    SequenceDataLayer,
)

_REGISTRY: dict[str, type[Layer]] = {}

#: the JAX package's layer types that this package does not port yet
#: (ROADMAP.md, queue 1)
NOT_PORTED = frozenset({"kLMDBData", "kMoE"})


def register_layer(cls: type[Layer]) -> type[Layer]:
    if not cls.TYPE:
        raise ValueError(f"{cls.__name__} has no TYPE")
    _REGISTRY[cls.TYPE] = cls
    return cls


def create_layer(cfg: LayerConfig) -> Layer:
    try:
        cls = _REGISTRY[cfg.type]
    except KeyError:
        if cfg.type in NOT_PORTED:
            raise ConfigError(
                f"layer {cfg.name!r}: type {cfg.type!r} is not ported to "
                "singa_tpu_torch yet (ported: "
                f"{sorted(_REGISTRY)})"
            ) from None
        raise ConfigError(
            f"unknown layer type {cfg.type!r} (registered: {sorted(_REGISTRY)})"
        ) from None
    return cls(cfg)


def registered_types() -> list[str]:
    return sorted(_REGISTRY)


for _cls in (
    AddLayer,
    BatchNormLayer,
    GlobalPoolingLayer,
    RBMLayer,
    SequenceDataLayer,
    EmbeddingLayer,
    LayerNormLayer,
    AttentionLayer,
    DenseLayer,
    LMLossLayer,
    ShardDataLayer,
    MnistImageLayer,
    RGBImageLayer,
    LabelLayer,
    ConvolutionLayer,
    InnerProductLayer,
    ReLULayer,
    TanhLayer,
    SigmoidLayer,
    DropoutLayer,
    LRNLayer,
    PoolingLayer,
    SoftmaxLossLayer,
    EuclideanLossLayer,
    SliceLayer,
    ConcateLayer,
    SplitLayer,
    BridgeSrcLayer,
    BridgeDstLayer,
):
    register_layer(_cls)

__all__ = [
    "Layer",
    "NOT_PORTED",
    "create_layer",
    "register_layer",
    "registered_types",
]
