"""Layer abstraction.

Counterpart of ``singa_tpu/layers/base.py``. A layer is static metadata
plus a forward function: ``setup`` runs shape inference and declares
param specs once at graph-build time; ``apply`` runs eagerly in
PyTorch, and autograd provides the backward (the reference's
ComputeGradient, include/worker/base_layer.h:38-258).

``apply`` takes the layer's own ``generator`` (the JAX side's
``rng``: ``Net.forward`` derives one per layer from the step's, see
``utils/rng.py``, for the layers that set ``uses_generator``).

Buffers (:class:`BufferSpec`) are non-trainable per-layer state, such
as batch-norm running stats: a layer that declares them runs through
``apply_stateful``, which returns its updates beside its output.

``decode_positionwise`` marks the layers whose ``apply`` works on any
suffix of a sequence unchanged, so the conf-net KV-cache decode
(``serve/conf_decode.py``) reuses it; kEmbedding and kAttention carry
a ``decode_step`` instead.

Partition metadata (the reference's partition_dimension,
base_layer.h:121-128): ``partition_type`` (the layer's own, else the
net's) and ``partition_dim``; each param's ``neuron_axis`` and
``expert_axis`` say which dim kLayerPartition and the expert axis
split. ``mesh`` is bound by the Trainer (``Net.bind_mesh``). A layer
whose work crosses ranks on that mesh (``crosses``) runs every rank in
one call, ``apply_ranks``: ring attention over the seq axis, kMoE over
the expert axis, kLayerPartition's Slice/Concate over the model axis.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from ..config.schema import ConfigError, LayerConfig
from ..params import ParamSpec

Shape = tuple[int, ...]


class BufferSpec:
    """Non-trainable per-layer state (e.g. batch-norm running stats):
    initialized to a fill value, updated by the layer's own rule inside
    the step (never by the updater), checkpointed alongside params."""

    __slots__ = ("name", "shape", "init")

    def __init__(self, name: str, shape: Shape, init: float):
        self.name = name
        self.shape = tuple(shape)
        self.init = init


class Layer:
    """Base class; subclasses set TYPE and override setup/apply."""

    TYPE: str = ""
    #: partition_dimension(): 0 = batch (kDataPartition), 1 = neuron
    #: (kLayerPartition), -1 = unpartitionable (base_layer.h:121-128)
    PARTITION_DIM_FOR = {"kDataPartition": 0, "kLayerPartition": 1,
                         "kNone": -1}

    is_datalayer = False
    is_parserlayer = False
    is_losslayer = False
    #: ``apply`` draws from its generator in training (Net.forward
    #: derives generators for these layers only)
    uses_generator = False
    #: ``apply`` draws activation-sized values on the device in training
    #: (``utils.rng.on_device``); a captured step would replay one draw,
    #: so the Trainer dispatches such a net eagerly
    draws_on_device = False
    #: ``apply`` returns (out, aux): Net.forward adds ``aux_weight *
    #: aux`` to the total loss (kMoE's load balancing)
    has_aux_loss = False
    #: position-wise over a (B, S, ...) sequence dim: ``apply`` on a
    #: Q-token suffix equals the full-sequence apply restricted to those
    #: positions, so the incremental decode (serve/conf_decode.py) can
    #: reuse ``apply`` unchanged. Layers with cross-position state
    #: implement ``decode_step`` instead (kAttention caches K/V,
    #: kEmbedding needs absolute positions).
    decode_positionwise = False

    def __init__(self, cfg: LayerConfig, net_partition: str = "kNone"):
        self.cfg = cfg
        self.name = cfg.name
        self.srclayers: list[str] = list(cfg.srclayers)
        self.partition_type = cfg.partition_type or net_partition
        self.out_shape: Shape | None = None
        self._param_specs: dict[str, ParamSpec] = {}
        self._buffer_specs: dict[str, BufferSpec] = {}
        #: the mesh, bound by the Trainer (Net.bind_mesh); None = one rank
        self.mesh = None

    # ---------------- build time ----------------

    def setup(self, src_shapes: Sequence[Shape], batchsize: int) -> Shape:
        """Infer the output shape and declare params; returns out_shape."""
        raise NotImplementedError

    def validate(self, src_layers: Sequence["Layer"]) -> None:
        """Optional cross-layer check, called by Net.setup with the
        actual source layer objects after this layer's setup."""

    def param_specs(self) -> dict[str, ParamSpec]:
        """Qualified-name -> spec, declared during setup."""
        return self._param_specs

    def _declare_param(
        self,
        idx: int,
        default_name: str,
        shape: Shape,
        fan_in: int = 0,
        neuron_axis: int | None = None,
        expert_axis: int | None = None,
    ) -> str:
        """Register param ``<layer>/<name>`` from cfg.param[idx] (if given)."""
        cfg = self.cfg.param[idx] if idx < len(self.cfg.param) else None
        pname = (cfg.name if cfg and cfg.name else default_name)
        qualified = f"{self.name}/{pname}"
        share = list(self.cfg.share_param)
        owner = share[idx] if idx < len(share) else None
        self._param_specs[qualified] = ParamSpec.from_config(
            cfg,
            qualified,
            tuple(shape),
            fan_in=fan_in,
            owner=owner,
            neuron_axis=neuron_axis,
            expert_axis=expert_axis,
        )
        return qualified

    def buffer_specs(self) -> dict[str, BufferSpec]:
        return self._buffer_specs

    def _declare_buffer(
        self, default_name: str, shape: Shape, init: float = 0.0
    ) -> str:
        """Register buffer ``<layer>/<name>`` (checkpoint key ``b|...``)."""
        qualified = f"{self.name}/{default_name}"
        self._buffer_specs[qualified] = BufferSpec(qualified, shape, init)
        return qualified

    @property
    def has_buffers(self) -> bool:
        return bool(self._buffer_specs)

    @property
    def partition_dim(self) -> int:
        return self.PARTITION_DIM_FOR[self.partition_type or "kNone"]

    def model_split(self) -> bool:
        """kLayerPartition on the bound mesh's model axis wider than 1,
        with a param that splits: this layer's compute is Slice/Concate
        over the model ranks."""
        return (self.mesh is not None and self.partition_dim == 1
                and self.mesh.widths["model"] > 1
                and any(s.neuron_axis is not None
                        for s in self._param_specs.values()))

    # ---------------- run time ----------------

    def apply(
        self,
        params: dict[str, torch.Tensor],
        inputs: list[Any],
        *,
        training: bool,
        generator: torch.Generator | None = None,
    ) -> Any:
        """Forward on tensors; autograd differentiates it."""
        raise NotImplementedError

    def apply_stateful(
        self,
        params: dict[str, torch.Tensor],
        buffers: dict[str, torch.Tensor],
        inputs: list[Any],
        *,
        training: bool,
        generator: torch.Generator | None = None,
    ) -> tuple[Any, dict[str, torch.Tensor]]:
        """Forward for layers with buffers: returns (out, buffer updates).
        Only called when ``has_buffers``."""
        raise NotImplementedError

    def crosses(self) -> bool:
        """Whether this layer's work on the bound mesh crosses ranks, so
        that ``Net`` runs it through ``apply_ranks``."""
        return False

    def apply_ranks(self, params: list, inputs: list, lanes, *,
                    training: bool) -> list:
        """Every lane's output in one call (``lanes``: the ranks, their
        coordinates and groups, ``parallel.axes.Lanes``); ``params[j]``
        and ``inputs[j]`` are lane j's. Called when ``crosses``."""
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name!r}, out={self.out_shape})"


def feature_dim(shape: Shape) -> int:
    """Product of the non-batch dims — the reference's flatten-to-(batch,
    vdim) convention used by FC/RBM/loss layers (layer.cc:171-176)."""
    out = 1
    for d in shape[1:]:
        out *= d
    return out


def require_one_src(layer: Layer, src_shapes: Sequence[Shape]) -> Shape:
    if len(src_shapes) != 1:
        raise ConfigError(
            f"layer {layer.name!r} ({layer.TYPE}) expects exactly one "
            f"srclayer, got {len(src_shapes)}"
        )
    return src_shapes[0]
