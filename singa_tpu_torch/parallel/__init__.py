"""Distribution layer: the mesh and the exchanges over its axes.

Counterpart of ``singa_tpu/parallel``: a mesh maps each rank to a torch
device (several ranks may share one) and to its coordinates on the
data, pipe, expert, seq and model axes; ``axes`` holds the lanes of the
lockstep walk; ``ring`` (ring attention), ``moe`` (kMoE's dense and
expert-parallel forms) and ``pipeline`` (the GPipe schedule) run over
the seq, expert and pipe axes; ``shardings`` says which rank holds
which piece of the batch and the params (and zero_update's update dim);
``collectives`` holds the ``grad_comm`` seam (the reference quantized
reduction, error-feedback residuals, reverse-topo buckets);
``consistency`` the replica engine's protocols (Elastic, RandomSync).
The int8 ring itself lives in ``ops/quantized_collective.py``.
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
from .mesh import (
    DATA_AXIS,
    FULL_AXES,
    MODEL_AXIS,
    Mesh,
    build_full_mesh,
    build_mesh,
    mesh_from_cluster,
)

__all__ = [
    "DATA_AXIS",
    "FULL_AXES",
    "GradCommSpec",
    "MODEL_AXIS",
    "Mesh",
    "apply_grad_comm_tag",
    "build_full_mesh",
    "build_mesh",
    "init_residuals",
    "is_residual_key",
    "mesh_from_cluster",
    "reduce_gradients",
    "residual_key",
    "reverse_topo_buckets",
]
