"""Distribution layer: the data-parallel mesh and the gradient
collectives.

Counterpart of ``singa_tpu/parallel``, data axis only: a mesh maps each
data-parallel rank to a torch device (several ranks may share one), and
``collectives`` holds the ``grad_comm`` seam (the reference quantized
reduction, error-feedback residuals, reverse-topo buckets);
``shardings`` gives zero_update's per-param update dim. The ring itself
lives in ``ops/quantized_collective.py``.
"""

from .collectives import (
    GradCommSpec,
    apply_grad_comm_tag,
    init_residuals,
    is_residual_key,
    reduce_gradients,
    residual_key,
    reverse_topo_buckets,
)
from .mesh import DATA_AXIS, Mesh, build_mesh, mesh_from_cluster

__all__ = [
    "DATA_AXIS",
    "GradCommSpec",
    "Mesh",
    "apply_grad_comm_tag",
    "build_mesh",
    "init_residuals",
    "is_residual_key",
    "mesh_from_cluster",
    "reduce_gradients",
    "residual_key",
    "reverse_topo_buckets",
]
