"""A net with buffers on an axes mesh, and the ``grad_comm`` reference
seam there (singa_tpu_torch/layers/norm.py ``apply_stateful_lanes``,
singa_tpu_torch/trainer/trainer.py ``_axes_seam``).

BatchNorm replicated over a model axis takes its moments over the ranks
that split the batch: the data ranks of one model index (the model ranks
hold the same rows). tests/test_torch_norm.py's conv + kBatchNorm net on
data 2 x model 2 is held to the JAX Trainer on the same mesh (GSPMD's
global-batch moments): losses within 1e-4 over 4 steps, the running
stats within 1e-5. A planted fault (each rank's moments over its own
rows) must move the losses past the bar 100 times.

The ``grad_comm`` seam on these meshes is tests/
test_torch_axes_seam.py's.
"""

import numpy as np

from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.layers import norm as t_norm
from singa_tpu_torch.parallel import build_mesh
from singa_tpu_torch.trainer import Trainer, params_from_numpy
from test_torch_axes_seq import LOSS_TOL, close
from test_torch_axes_seq import one_torch_thread  # noqa: F401 (autouse)
from test_torch_norm import bn_text, shards  # noqa: F401 (fixture)

STATS_TOL = 1e-5
DM = {"data": 2, "model": 2}


def bn_losses(tr, steps=4):
    out = []
    for s in range(steps):
        tr.train_one_batch(s)
        out.append(float(tr.perf.avg()["loss"]["loss"]))
        tr.perf.reset()
    return out


def bn_runs(shards, text):
    from singa_tpu.config import parse_model_config as j_parse
    from singa_tpu.trainer import Trainer as JTrainer
    from test_torch_moe_routing import jax_mesh

    jt = JTrainer(j_parse(text), mesh=jax_mesh(DM), seed=0,
                  log=lambda s: None, prefetch=False)
    params = {n: np.asarray(v) for n, v in jt.params.items()}
    jl = bn_losses(jt)
    tr = Trainer(t_parse(text), mesh=build_mesh(2, 2, ["cpu"] * 4), seed=0,
                 log=lambda s: None)
    tr.params = params_from_numpy(tr.train_net, params)
    return jl, {k: np.asarray(v) for k, v in jt.buffers.items()}, tr


def test_batchnorm_on_data_x_model_matches_jax(shards):
    jl, jb, tr = bn_runs(shards, bn_text(shards))
    assert tr.mesh_shape == DM and tr._layout["bn/gamma"] is None
    close(bn_losses(tr), jl, LOSS_TOL)
    for k in ("bn/running_mean", "bn/running_var", "bn2/running_mean",
              "bn2/running_var"):
        close(tr.buffers[k], jb[k], STATS_TOL)


def _local_moments(self, params, buffers, inputs, lanes):
    """The planted fault: each rank's moments over its own rows."""
    outs, updates = [], {}
    for p, x in zip(params, inputs):
        y, updates = self.apply_stateful(p, buffers, x, training=True)
        outs.append(y)
    return outs, updates


def test_per_rank_moments_exceed_the_bar(shards, monkeypatch):
    monkeypatch.setattr(t_norm.BatchNormLayer, "apply_stateful_lanes",
                        _local_moments)
    jl, _, tr = bn_runs(shards, bn_text(shards))
    diff = float(np.max(np.abs(np.asarray(bn_losses(tr)) - jl)))
    assert diff > 100 * LOSS_TOL, diff
