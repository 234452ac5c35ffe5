"""Divergence guard: the bad-step verdict on the device, the policy on the
host. The PyTorch counterpart of ``singa_tpu/resilience/guard.py``.

The verdict is computed inside each engine's step: one finiteness test
over the step's own health signals (the Trainer: the loss and the global
squared grad-norm; the replica engine: every replica's; the CD engine:
the CD grads and every RBM's metrics). It is a 0-d bool tensor on the
device. Every engine's step tail takes the verdict and the LR-scaled
grads from ``guard_grads``, writes ``where(ok, new, old)`` into its
stored params, slots and buffers in place (``apply_verdict``), then
steps the counters and zeroes a bad step's metrics through
``guard_finish``, so the policy lives here alone and a guarded step
reads nothing on the host: on the card it replays as part of the
step's CUDA graph, and it does exactly as many host syncs as an
unguarded one (none per step).

Policies (ResilienceConfig.guard_policy):

  kSkip      a bad step's param, slot and buffer updates are dropped on
             the device and the bad-step counters increment; training
             continues on the pre-step state.
  kRollback  kSkip, plus: when ``guard_rollback_after`` consecutive
             steps are bad, the host (reading the counter only at a
             step-boundary cadence, ``resilience/context.py``) restores
             the last complete checkpoint into the live tensors and
             backs the effective LR off by ``guard_lr_backoff``; the
             accumulated scale multiplies the gradients inside the step,
             so the backoff needs no new graph and no host sync.

The counters are 0-d device tensors under reserved keys of the
Trainer's buffers (``__guard_consec__``, ``__guard_bad__``,
``__guard_lr_scale__``, the JAX package's names and dtypes), so they
checkpoint and restore with the rest of the training state, and a save
crosses between the two packages with them.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten


class GuardGaveUp(RuntimeError):
    """kRollback rolled back repeatedly without getting past the step
    that tripped it: the divergence is deterministic (a NaN baked into
    the data stream), so replaying the same checkpoint and stream
    positions can never succeed. Raised instead of looping; the
    supervisor does not restart after it."""


#: reserved buffer keys (layer buffers are namespaced by layer name)
GUARD_CONSEC = "__guard_consec__"  # consecutive bad steps (int32)
GUARD_BAD = "__guard_bad__"  # total bad steps this run (int32)
GUARD_LR = "__guard_lr_scale__"  # accumulated LR backoff (float32)
GUARD_KEYS = (GUARD_CONSEC, GUARD_BAD, GUARD_LR)


@dataclasses.dataclass(frozen=True)
class GuardSpec:
    """The trainer-facing slice of ResilienceConfig's guard fields."""

    policy: str  # "kSkip" | "kRollback"
    rollback_after: int
    lr_backoff: float

    @staticmethod
    def from_config(res_cfg) -> "GuardSpec | None":
        """-> GuardSpec, or None when no guard is configured."""
        if res_cfg is None or res_cfg.guard_policy == "kNone":
            return None
        return GuardSpec(
            policy=res_cfg.guard_policy,
            rollback_after=max(1, res_cfg.guard_rollback_after),
            lr_backoff=res_cfg.guard_lr_backoff,
        )


def init_guard_buffers(device) -> dict[str, torch.Tensor]:
    """Fresh counters for a guarded run, 0-d tensors on ``device``."""
    return {
        GUARD_CONSEC: torch.zeros((), dtype=torch.int32, device=device),
        GUARD_BAD: torch.zeros((), dtype=torch.int32, device=device),
        GUARD_LR: torch.ones((), dtype=torch.float32, device=device),
    }


def grad_norm_sq(grads) -> torch.Tensor:
    """Global squared grad-norm in float32: a NaN or Inf in any gradient
    poisons it, which is the point, and so does a sum of squares past
    float32's range, as in the JAX package. ``grads`` is a dict of
    tensors or an iterable of them. One multi-tensor norm (each tensor's
    in float32, read where it lies: no copy of the grads), then the
    squares of those norms summed."""
    vals = list(grads.values() if isinstance(grads, dict) else grads)
    if not vals:
        return torch.zeros((), dtype=torch.float32)
    dev = vals[0].device
    norms = torch.stack([n.to(dev) for n in torch._foreach_norm(
        vals, 2, dtype=torch.float32)])
    return torch.sum(norms * norms)


def guard_grads(counters: dict, loss, grads, gnorm=None):
    """The head of every engine's guarded step tail -> (ok, grads).
    ``ok``: the verdict, a 0-d bool tensor on the device, the loss and
    the grads' global squared norm finite. ``grads``: the same tree
    (a dict of tensors, or lists and dicts of such: each device's copy,
    each rank's shards, each param's pieces) with the accumulated LR
    backoff folded in, one multi-tensor multiply per device (scale 1.0
    is a bitwise no-op). The norm is taken over every leaf unless the
    caller gives it as ``gnorm`` (a tree that holds copies, or a norm
    summed over ranks)."""
    leaves, spec = tree_flatten(grads)
    if gnorm is None:
        gnorm = grad_norm_sq(leaves)
    ok = torch.isfinite(loss) & torch.isfinite(gnorm)
    lr = counters[GUARD_LR]
    by_dev: dict = {}
    for i, g in enumerate(leaves):
        by_dev.setdefault(g.device, []).append(i)
    out = list(leaves)
    for dev, idx in by_dev.items():
        scaled = torch._foreach_mul([leaves[i] for i in idx], lr.to(dev))
        for i, g in zip(idx, scaled):
            out[i] = g
    return ok, tree_unflatten(out, spec)


def guard_finish(ok: torch.Tensor, counters: dict, metrics: dict) -> dict:
    """The end of every engine's guarded step tail, after the update went
    in through ``apply_verdict``: the counters stepped in place, and the
    metrics ({layer: {metric: scalar}}) zeroed when the step was bad."""
    step_guard_buffers(ok, counters)
    return zero_if_bad(ok, metrics)


@torch.no_grad()
def apply_verdict(ok: torch.Tensor, new: torch.Tensor,
                  stored: torch.Tensor) -> None:
    """``stored := where(ok, new, stored)`` in place (one kernel, as the
    plain copy): the stored tensor keeps its address (a captured graph
    reads it there)."""
    torch.where(ok, new.to(stored.dtype), stored, out=stored)


def zero_if_bad(ok: torch.Tensor, metrics: dict) -> dict:
    """A bad step's metrics zeroed ({layer: {metric: scalar}}): a NaN
    must not pollute the display window's running sums."""
    return {
        layer: {k: torch.where(ok, torch.as_tensor(v),
                               torch.zeros_like(torch.as_tensor(v)))
                for k, v in ms.items()}
        for layer, ms in metrics.items()
    }


@torch.no_grad()
def step_guard_buffers(ok: torch.Tensor, counters: dict) -> None:
    """Step the counters in place after a step with verdict ``ok``."""
    consec = counters[GUARD_CONSEC]
    consec.copy_(torch.where(ok, torch.zeros_like(consec), consec + 1))
    counters[GUARD_BAD].add_((~ok).to(torch.int32))


def split_guard_buffers(buffers: dict) -> tuple[dict, dict]:
    """-> (layer buffers, guard counters)."""
    layer = {k: v for k, v in buffers.items() if k not in GUARD_KEYS}
    g = {k: buffers[k] for k in GUARD_KEYS if k in buffers}
    return layer, g
