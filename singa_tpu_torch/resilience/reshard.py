"""Serving restore of a saved param tree, the npz half of
``singa_tpu/resilience/reshard.py``'s ``load_serving_params``: what a
fleet host's ``checkpoint:`` overlay and the rollout controller's
staging call. The sharded format and its box-intersection resharding
are not ported (ROADMAP.md): a sharded checkpoint directory raises by
name."""

from __future__ import annotations

import os

import numpy as np
import torch


class ReshardError(ValueError):
    """A save cannot be restored onto this serving host."""


def load_serving_params(path: str, init_params: dict) -> tuple[dict, dict]:
    """Overlay a trained save's params onto ``init_params`` (the port's
    ``init_lm`` tree) by flat name -> ``(params, info)``.

    - a checkpoint FOLDER resolves through its LATEST marker (newest
      complete save wins, torn tails skipped: ``retention``);
    - an npz checkpoint (either package's format) overlays by name:
      names the model lacks are ignored, absent names keep their init,
      and a shape mismatch raises;
    - a sharded checkpoint directory (``manifest.json``) raises.

    Restored values are tensors on each init param's device and dtype.
    Raises ``ReshardError`` on an absent or unhostable save: a serving
    host must never boot on silently wrong weights."""
    if os.path.isdir(path):
        if os.path.exists(os.path.join(path, "manifest.json")):
            raise ReshardError(
                f"checkpoint {path!r} is a sharded save: the sharded "
                "format is not ported (ROADMAP.md); save an npz")
        from .retention import resolve_latest

        resolved = resolve_latest(path)
        if resolved is None:
            raise ReshardError(
                f"checkpoint folder {path!r} holds no complete save")
        return load_serving_params(resolved, init_params)

    from ..trainer.checkpoint import load_checkpoint

    step, ck_params, _, _ = load_checkpoint(path)
    out = dict(init_params)
    restored = 0
    for name, arr in ck_params.items():
        if name not in out:
            continue
        live = out[name]
        if tuple(arr.shape) != tuple(live.shape):
            raise ReshardError(
                f"checkpoint {path!r}: param {name!r} shape "
                f"{tuple(arr.shape)} != model shape {tuple(live.shape)}")
        out[name] = torch.from_numpy(np.array(arr)).to(
            device=live.device, dtype=live.dtype)
        restored += 1
    return out, {
        "path": path,
        "step": int(step),
        "format": "npz",
        "saved_nprocs": 1,
        "restored": restored,
        "resharded": 0,
    }
