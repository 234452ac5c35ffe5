"""Layer registry.

Counterpart of ``singa_tpu/layers/__init__.py``: a string-keyed factory
mirroring the reference's Factory<Layer> (src/worker/neuralnet.cc:13-33).
It registers every layer type of the JAX package: the conf-driven
transformer LM's vocabulary with kMoE, the image nets' (neuron, loss,
parser and connector layers), kShardData and kLMDBData, kRBM, and
ResNet's kBatchNorm, kAdd and kGlobalPooling. Any other type raises a
ConfigError that lists the registered ones.
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
from .data import (
    LabelLayer,
    LMDBDataLayer,
    MnistImageLayer,
    RGBImageLayer,
    ShardDataLayer,
)
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
    MoELayer,
    SequenceDataLayer,
)

_REGISTRY: dict[str, type[Layer]] = {}


def register_layer(cls: type[Layer]) -> type[Layer]:
    if not cls.TYPE:
        raise ValueError(f"{cls.__name__} has no TYPE")
    _REGISTRY[cls.TYPE] = cls
    return cls


def create_layer(cfg: LayerConfig, net_partition: str = "kNone") -> Layer:
    try:
        cls = _REGISTRY[cfg.type]
    except KeyError:
        raise ConfigError(
            f"unknown layer type {cfg.type!r} (registered: {sorted(_REGISTRY)})"
        ) from None
    return cls(cfg, net_partition)


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
    MoELayer,
    ShardDataLayer,
    LMDBDataLayer,
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
    "create_layer",
    "register_layer",
    "registered_types",
]
