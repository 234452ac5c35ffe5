"""Training engine: the single-device synchronous Trainer and the npz
checkpoint format shared with the JAX package."""

from .checkpoint import (
    CheckpointError,
    load_checkpoint,
    params_from_numpy,
    restore_into,
    save_checkpoint,
)
from .trainer import Trainer

__all__ = [
    "Trainer",
    "CheckpointError",
    "load_checkpoint",
    "params_from_numpy",
    "restore_into",
    "save_checkpoint",
]
