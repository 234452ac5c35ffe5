"""Training engine: the synchronous Trainer, the contrastive-divergence
CDTrainer, and the npz and sharded checkpoint formats shared with the
JAX package (``checkpoint``, ``sharded_ckpt``)."""

from .cd import CDTrainer, unroll_autoencoder
from .checkpoint import (
    CheckpointError,
    load_checkpoint,
    params_from_numpy,
    restore_into,
    save_checkpoint,
)
from .trainer import Trainer


def make_trainer(model_cfg, cluster_cfg=None, **kwargs):
    """The engine for a job, as the JAX package's ``make_trainer`` picks
    it: ModelProto.alg kContrastiveDivergence -> CDTrainer, else the
    synchronous Trainer. The JAX package's replica engine (``nservers``
    on an asynchronous cluster) is not ported: the Trainer refuses
    ``nservers`` by name."""
    if model_cfg.alg == "kContrastiveDivergence":
        return CDTrainer(model_cfg, cluster_cfg, **kwargs)
    return Trainer(model_cfg, cluster_cfg, **kwargs)


__all__ = [
    "Trainer",
    "CDTrainer",
    "make_trainer",
    "unroll_autoencoder",
    "CheckpointError",
    "load_checkpoint",
    "params_from_numpy",
    "restore_into",
    "save_checkpoint",
]
