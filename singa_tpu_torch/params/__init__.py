"""Parameter specs and initialization.

Counterpart of ``singa_tpu/params/__init__.py``: the metadata the
reference attached to each Param (init method + hyperparams, per-param
learning-rate / weight-decay multipliers, fan-in, sharing links, and
the axes kLayerPartition and the expert axis split) and the reference's init
methods with its exact scaling rules (src/utils/param.cc:61-99).

Randomness comes from an explicit ``torch.Generator`` on the CPU (the
values do not depend on the device they end up on). Parity with the
JAX package is by distribution, not bit for bit: tests that compare the
two packages carry one param set across instead
(``trainer.checkpoint.params_from_numpy``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..config.schema import ConfigError, ParamConfig


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Static metadata for one parameter tensor.

    ``fan_in`` follows the reference's per-layer conventions: for an FC
    weight the *total size* vdim*hdim (layer.cc:178), for a conv weight the
    col height channels*k*k (layer.cc:49), 0 for biases.
    """

    name: str
    shape: tuple[int, ...]
    init_method: str = "kConstant"
    value: float = 1.0
    low: float = -1.0
    high: float = 1.0
    mean: float = 0.0
    std: float = 1.0
    lr_mult: float = 1.0
    wd_mult: float = 1.0
    fan_in: int = 0
    owner: str | None = None  # share_param: alias of another param's storage
    #: the array axis holding the layer's neuron dimension, which
    #: kLayerPartition splits over the model axis (dim 1 of an FC weight,
    #: dim 0 of a conv filter or a bias); None = never model-sharded
    neuron_axis: int | None = None
    #: the array axis enumerating experts (kMoE), split over the expert
    #: axis; None = not expert-sharded
    expert_axis: int | None = None

    @classmethod
    def from_config(
        cls,
        cfg: ParamConfig | None,
        name: str,
        shape: tuple[int, ...],
        fan_in: int = 0,
        owner: str | None = None,
        neuron_axis: int | None = None,
        expert_axis: int | None = None,
    ) -> "ParamSpec":
        if cfg is None:
            return cls(name=name, shape=shape, fan_in=fan_in, owner=owner,
                       neuron_axis=neuron_axis, expert_axis=expert_axis)
        return cls(
            name=name,
            shape=shape,
            init_method=cfg.init_method,
            value=cfg.value,
            low=cfg.low,
            high=cfg.high,
            mean=cfg.mean,
            std=cfg.std,
            lr_mult=cfg.learning_rate_multiplier,
            wd_mult=cfg.weight_decay_multiplier,
            fan_in=fan_in,
            owner=owner,
            neuron_axis=neuron_axis,
            expert_axis=expert_axis,
        )


def _uniform(gen, shape, low, high):
    return torch.rand(shape, generator=gen, dtype=torch.float32) * (
        high - low
    ) + low


def _normal(gen, shape, mean, std):
    return mean + std * torch.randn(shape, generator=gen, dtype=torch.float32)


def init_param(gen: torch.Generator, spec: ParamSpec) -> torch.Tensor:
    """Materialize one parameter per its init method, on the CPU.

    Mirrors Param::Init (reference: src/utils/param.cc:61-99) including the
    quirky scaling rules: every random method multiplies by ``value`` when
    nonzero, and the SqrtFanIn family divides that scale by the respective
    sqrt term."""
    shape = spec.shape
    m = spec.init_method
    if m == "kConstant":
        return torch.full(shape, spec.value, dtype=torch.float32)
    if m == "kUniform":
        x = _uniform(gen, shape, spec.low, spec.high)
        return x * spec.value if spec.value else x
    if m == "kUniformSqrtFanIn":
        if spec.fan_in <= 0:
            raise ConfigError(
                f"param {spec.name!r}: kUniformSqrtFanIn needs fan_in>0"
            )
        x = _uniform(gen, shape, spec.low, spec.high)
        if spec.value:
            x = x * (spec.value / math.sqrt(spec.fan_in / 3.0))
        return x
    if m == "kUniformSqrtFanInOut":
        x = _uniform(gen, shape, spec.low, spec.high)
        if spec.value:
            x = x * (spec.value / math.sqrt(shape[0] + shape[1]))
        return x
    if m == "kGaussain":  # [sic] reference spelling
        x = _normal(gen, shape, spec.mean, spec.std)
        return x * spec.value if spec.value else x
    if m == "kGaussainSqrtFanIn":
        x = _normal(gen, shape, spec.mean, spec.std)
        if spec.value:
            x = x * (spec.value / math.sqrt(shape[0]))
        return x
    if m == "kPretrained":
        # filled by the checkpoint restore path (trainer/checkpoint.py)
        # from ModelConfig.checkpoint before training
        return torch.zeros(shape, dtype=torch.float32)
    raise ConfigError(f"param {spec.name!r}: unknown init method {m!r}")


def init_params(
    gen: torch.Generator, specs: dict[str, ParamSpec], device=None
) -> dict[str, torch.Tensor]:
    """Materialize a name-keyed param dict on ``device`` (default: the
    CPU). Owners draw from ``gen`` in sorted name order; shared params
    (spec.owner set) are not materialized: they resolve through their
    owner's tensor (``Net.resolve_params``), mirroring Param::ShareData
    (reference: include/utils/param.h:55-73)."""
    owners = {n: s for n, s in specs.items() if s.owner is None}
    out = {
        name: init_param(gen, spec).to(device)
        for name, spec in sorted(owners.items())
    }
    for name, spec in specs.items():
        if spec.owner is not None:
            if spec.owner not in out:
                raise ConfigError(
                    f"param {name!r} shares unknown owner {spec.owner!r}"
                )
            if specs[spec.owner].shape != spec.shape:
                raise ConfigError(
                    f"param {name!r} shares {spec.owner!r} with mismatched shape"
                )
    return out
