"""Updaters (optimizers) and learning-rate schedules.

Counterpart of ``singa_tpu/optim/__init__.py``: the reference's updater
math (src/utils/updater.cc:11-182) as pure transforms over name-keyed
tensor dicts: 5 updaters (SGD/Nesterov/AdaGrad/RMSProp/AdaDelta) x 6 LR
schedules (kFixed/kLinear/kExponential/kInverse_t/kInverse/kStep).
``apply`` maps (step, params, grads, state) -> (params, state) and
returns new tensors (nothing is updated in place), like the JAX
package. The slot names are the JAX package's, so checkpoints of either
package resume in the other.

Faithfulness notes (as in the JAX package):
- weight decay is *folded into the gradient* (grad += wd*data) before the
  momentum/adaptive logic, with one per-updater quirk: AdaGrad and RMSProp
  accumulate the *pre-decay* gradient into history, AdaDelta the post-decay
  one (updater.cc:117-128 vs :168-181).
- slots start at zero, which equals the reference's zeroing at step 0.
- AdaDelta ignores the learning rate entirely (updater.cc:164-182).
- NesterovUpdater::Init never reads proto.momentum (a reference bug: the
  member is uninitialized C++); cfg.momentum is read here.
- learning rates are computed in float32, as the JAX package does; a
  schedule's pow is rounded once from float64 (``_pow``), so a device
  step gives the host's bits.
"""

from __future__ import annotations

import torch

from ..config.schema import ConfigError, UpdaterConfig
from ..params import ParamSpec

Params = dict[str, torch.Tensor]
State = dict[str, dict[str, torch.Tensor]]


def _pow(base, exponent) -> torch.Tensor:
    """``base ** exponent`` rounded once to float32: taken in float64,
    whose pow is within 2 ulps on the card and on the CPU, so the
    float32 result is the same bits on both (a float32 pow differs by an
    ulp between the two libraries)."""
    return torch.pow(base.double(), exponent.double()).float()


def learning_rate(cfg: UpdaterConfig, step) -> torch.Tensor:
    """GetLearningRate (reference: src/utils/updater.cc:11-51) -> a
    float32 scalar tensor on ``step``'s device (the CPU for an int).

    A device ``step`` keeps the schedule on the device, so a captured
    step (``utils/graphs.py``) reads its own step counter; it gives the
    same bits as the int step on the host. Constants are made with
    ``torch.full`` on that device (a fill, which a graph can capture,
    where ``torch.tensor`` would copy from the host), and every divisor
    is such a tensor: the card divides by a Python number as a product
    with its reciprocal, an ulp away from the CPU's division."""
    f32 = torch.float32
    step = torch.as_tensor(step)
    dev = step.device
    step = step.to(f32)

    def const(v) -> torch.Tensor:
        return torch.full((), v, dtype=f32, device=dev)

    base = const(cfg.base_learning_rate or 0.0)
    method = cfg.learning_rate_change_method
    if method == "kFixed":
        return base
    if method == "kLinear":
        r = step / const(cfg.learning_rate_change_frequency)
        return (1.0 - r) * base + r * cfg.final_learning_rate
    if method == "kExponential":
        # reference CHECKs base == 2*final; honor the contract
        if cfg.base_learning_rate != 2 * cfg.final_learning_rate:
            raise ConfigError("kExponential: base_learning_rate must be 2*final")
        return base / _pow(
            const(2.0), step / const(cfg.learning_rate_change_frequency))
    if method == "kInverse_t":
        if cfg.base_learning_rate != 2 * cfg.final_learning_rate:
            raise ConfigError("kInverse_t: base_learning_rate must be 2*final")
        return base / (1.0 + step / const(cfg.final_learning_rate))
    if method == "kInverse":
        return base * _pow(1.0 + cfg.gamma * step, const(-cfg.pow))
    if method == "kStep":
        # integer division step/freq, per the reference's explicit comment
        freq = const(cfg.learning_rate_change_frequency)
        return base * _pow(const(cfg.gamma), torch.floor(step / freq))
    raise ConfigError(f"unknown LR schedule {method!r}")


class Updater:
    """Base: selects slots + math per UpdaterConfig.type."""

    SLOTS: tuple[str, ...] = ()

    def __init__(self, cfg: UpdaterConfig):
        if cfg.base_learning_rate is None or cfg.base_learning_rate <= 0:
            if type(self) is not AdaDeltaUpdater:
                raise ConfigError("updater requires base_learning_rate > 0")
        self.cfg = cfg
        self._lrs: dict[float, object] = {}

    def init_state(self, params: Params) -> State:
        return {
            name: {slot: torch.zeros_like(p) for slot in self.SLOTS}
            for name, p in params.items()
        }

    @torch.no_grad()
    def apply(
        self,
        step,
        params: Params,
        grads: Params,
        state: State,
        specs: dict[str, ParamSpec],
        grad_scale: float = 1.0,
    ) -> tuple[Params, State]:
        new_p: Params = {}
        new_s: State = {}
        #: lr_mult -> the step's learning rate, computed once per apply
        self._lrs = {}
        for name, p in params.items():
            spec = specs.get(name)
            lr_mult = spec.lr_mult if spec else 1.0
            wd_mult = spec.wd_mult if spec else 1.0
            np_, ns_ = self._update(
                step, p, grads[name], state[name], lr_mult, wd_mult, grad_scale
            )
            new_p[name] = np_
            new_s[name] = ns_
        return new_p, new_s

    def _lr(self, step, lr_mult: float):
        """float32 arithmetic, as the JAX package's. An int ``step``
        gives a Python float (the tensors below take the float32 value
        as a scalar); a device step tensor gives a float32 scalar tensor
        on that device, the same bits, which a captured graph reads at
        every replay."""
        lr = self._lrs.get(lr_mult)
        if lr is None:
            lr = learning_rate(self.cfg, step) * lr_mult
            if not isinstance(step, torch.Tensor):
                lr = float(lr)
            self._lrs[lr_mult] = lr
        return lr

    def _wd(self, wd_mult: float) -> float:
        return self.cfg.weight_decay * wd_mult

    def _update(self, step, data, grad, slots, lr_mult, wd_mult, gscale):
        raise NotImplementedError


class SGDUpdater(Updater):
    """SGD with momentum + L2 (reference: updater.cc:54-79)."""

    SLOTS = ("history",)

    def _update(self, step, data, grad, slots, lr_mult, wd_mult, gscale):
        lr = self._lr(step, lr_mult)
        wd = self._wd(wd_mult)
        if wd > 0:
            grad = grad + data * wd
        if self.cfg.momentum > 0:
            history = slots["history"] * self.cfg.momentum + lr * grad
            return data - history, {"history": history}
        return data - lr * grad, {"history": slots["history"]}


class NesterovUpdater(Updater):
    """Nesterov momentum (reference: updater.cc:82-105)."""

    SLOTS = ("history",)

    def _update(self, step, data, grad, slots, lr_mult, wd_mult, gscale):
        lr = self._lr(step, lr_mult)
        wd = self._wd(wd_mult)
        m = self.cfg.momentum
        if wd > 0:
            grad = grad + data * wd
        tmp = slots["history"]
        history = tmp * m + lr * grad
        update = history * (1.0 + m) - tmp * m
        return data - update, {"history": history}


class AdaGradUpdater(Updater):
    """AdaGrad (reference: updater.cc:107-128). History accumulates the
    *pre-weight-decay* gradient; the applied gradient includes decay."""

    SLOTS = ("history",)

    def _update(self, step, data, grad, slots, lr_mult, wd_mult, gscale):
        history = slots["history"] + torch.square(grad * gscale)
        lr = self._lr(step, lr_mult)
        wd = self._wd(wd_mult)
        if wd > 0:
            grad = grad + data * wd
        data = data - lr * grad / torch.sqrt(history + self.cfg.delta)
        return data, {"history": history}


class RMSPropUpdater(Updater):
    """RMSProp (reference: updater.cc:131-153); same decay quirk as AdaGrad."""

    SLOTS = ("history",)

    def _update(self, step, data, grad, slots, lr_mult, wd_mult, gscale):
        rho = self.cfg.rho
        history = (
            slots["history"] * rho + (1.0 - rho) * torch.square(grad * gscale)
        )
        lr = self._lr(step, lr_mult)
        wd = self._wd(wd_mult)
        if wd > 0:
            grad = grad + data * wd
        data = data - lr * grad / torch.sqrt(history + self.cfg.delta)
        return data, {"history": history}


class AdaDeltaUpdater(Updater):
    """AdaDelta (reference: updater.cc:156-182). No learning rate; decay is
    applied to the gradient *before* the history accumulation."""

    SLOTS = ("history", "update")

    def _update(self, step, data, grad, slots, lr_mult, wd_mult, gscale):
        rho = self.cfg.rho
        delta = self.cfg.delta
        wd = self._wd(wd_mult)
        if wd > 0:
            grad = grad + data * wd
        history = (
            slots["history"] * rho + (1.0 - rho) * torch.square(grad * gscale)
        )
        tmp = (
            grad * torch.sqrt(slots["update"] + delta)
            / torch.sqrt(history + delta)
        )
        update = rho * slots["update"] + (1.0 - rho) * torch.square(tmp)
        return data - tmp, {"history": history, "update": update}


_UPDATERS = {
    "kSGD": SGDUpdater,
    "kNesterov": NesterovUpdater,
    "kAdaGrad": AdaGradUpdater,
    "kRMSProp": RMSPropUpdater,
    "kAdaDelta": AdaDeltaUpdater,
}


def make_updater(cfg: UpdaterConfig) -> Updater:
    """Select the updater by UpdaterProto.type (reference: model.proto:308-315)."""
    try:
        cls = _UPDATERS[cfg.type]
    except KeyError:
        raise ConfigError(f"unknown updater type {cfg.type!r}") from None
    return cls(cfg)
