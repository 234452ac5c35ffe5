"""Derived random generators: the port's counterpart of
``jax.random.fold_in``.

The JAX package threads one key through a step and folds in the step
number, then the layer index (``singa_tpu/graph/builder.py:228``). Here
a step's draws come from ``torch.Generator`` objects derived the same
way, from seeds alone: :func:`fold_in` seeds a new CPU generator from a
generator's seed and an integer, so a draw depends on (seed, step,
layer index) and on nothing drawn before it. The two packages' streams
differ (another generator); parity tests inject the draws.

Small draws (a crop offset, per-sample flags) stay on the CPU
generator, so the CPU and the card see the same values; a draw the
size of an activation (a dropout mask) is made on the tensor's device
by :func:`on_device`, from the same seed.
"""

from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fold_in(gen: torch.Generator, data: int) -> torch.Generator:
    """A new CPU generator whose seed mixes ``gen``'s seed with ``data``
    (``gen``'s state is neither read nor advanced)."""
    seed = _splitmix64(gen.initial_seed() ^ _splitmix64(int(data)))
    return torch.Generator().manual_seed(seed >> 1)


def on_device(gen: torch.Generator, device: torch.device) -> torch.Generator:
    """``gen`` itself if it lives on ``device``, else a generator there
    seeded with ``gen``'s seed. A meta tensor's draw has no values, so
    ``gen`` serves it as it is (the lint shape pass, which runs the
    forward on the meta device: ``lint/shape_rules.py``)."""
    if torch.device(device) == gen.device or torch.device(
            device).type == "meta":
        return gen
    return torch.Generator(device=device).manual_seed(gen.initial_seed())
