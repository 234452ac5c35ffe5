"""Training engine: the synchronous Trainer, the contrastive-divergence
CDTrainer, the replica engine's ReplicaTrainer, and the npz and sharded
checkpoint formats shared with the JAX package (``checkpoint``,
``sharded_ckpt``)."""

from .cd import CDTrainer, unroll_autoencoder
from .checkpoint import (
    CheckpointError,
    load_checkpoint,
    params_from_numpy,
    restore_into,
    save_checkpoint,
)
from .replica import ReplicaTrainer
from .trainer import Trainer


def make_trainer(model_cfg, cluster_cfg=None, **kwargs):
    """The engine for a job, as the JAX package's ``make_trainer`` picks
    it: ModelProto.alg kContrastiveDivergence -> CDTrainer; else a
    cluster with ``nservers > 0`` that is not ``synchronous`` (and an
    updater) -> ReplicaTrainer, worker-group replicas under the
    updater's ``param_type`` protocol (Elastic or RandomSync); else the
    synchronous Trainer."""
    if model_cfg.alg == "kContrastiveDivergence":
        return CDTrainer(model_cfg, cluster_cfg, **kwargs)
    if (
        cluster_cfg is not None
        and cluster_cfg.nservers > 0
        and not cluster_cfg.synchronous
        and model_cfg.updater is not None
    ):
        return ReplicaTrainer(model_cfg, cluster_cfg, **kwargs)
    return Trainer(model_cfg, cluster_cfg, **kwargs)


__all__ = [
    "Trainer",
    "CDTrainer",
    "ReplicaTrainer",
    "make_trainer",
    "unroll_autoencoder",
    "CheckpointError",
    "load_checkpoint",
    "params_from_numpy",
    "restore_into",
    "save_checkpoint",
]
