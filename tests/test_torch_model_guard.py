"""The divergence guard over replicas of model lanes: the replica
engine on 2 replicas x 2 model ranks (kLayerPartition) against the JAX
ReplicaTrainer on the same mesh of the suite's virtual CPU devices,
tests/test_torch_resilience_engines.py's drills: one verdict over every
lane, and a rollback that restores every lane's pieces from the npz
save.
"""

import jax
import numpy as np
import pytest

from singa_tpu.parallel import build_mesh as j_mesh
from singa_tpu.resilience import FaultPlan as JPlan
from singa_tpu.resilience import ResilienceContext as JCtx
from singa_tpu.trainer import ReplicaTrainer as JReplica
from singa_tpu_torch.resilience import FaultPlan, ResilienceContext
from singa_tpu_torch.trainer import ReplicaTrainer, params_from_numpy
from test_torch_launch import one_torch_thread  # noqa: F401
from test_torch_resilience_engines import TOL, guarded, replica_confs
from test_torch_resilience_engines import mlp_shards  # noqa: F401


@pytest.mark.parametrize("policy", ["skip", "rollback"])
def test_guard_over_model_lanes_matches_jax(policy, mlp_shards, tmp_path):
    """test_torch_resilience_engines' replica drills on 2 replicas x 2
    model ranks (kLayerPartition) in both packages: one verdict over
    every lane (nanloss@5 under kSkip; nanloss@6 under kRollback after 1,
    the rollback restoring the lanes' pieces from the npz save at step
    4): the same counters and rollbacks, the replicas and the center
    within 1e-4 of the JAX engine's."""
    if policy == "skip":
        args = (10, 0, "guard_policy: kSkip", "nanloss@5")
    else:
        args = (12, 4, "guard_policy: kRollback guard_rollback_after: 1 "
                "guard_lr_backoff: 0.5", "nanloss@6")
    (jcfg, jcl), (tcfg, tcl) = replica_confs(mlp_shards, tmp_path, *args[:3])
    for cfg, cl in ((jcfg, jcl), (tcfg, tcl)):
        cfg.neuralnet.partition_type = "kLayerPartition"
        cl.nworkers, cl.nprocs_per_group = 4, 2
    jt = JReplica(jcfg, jcl, seed=3, log=lambda s: None, prefetch=False,
                  mesh=j_mesh(2, 2, jax.devices()[:4]))
    tt = ReplicaTrainer(tcfg, tcl, seed=3, log=lambda s: None,
                        device="cpu", prefetch=False)
    assert tt.mesh_shape == {"data": 2, "model": 2}
    tt.params = params_from_numpy(tt.train_net, {
        n: np.asarray(jt._unpad_one(n, v)) for n, v in jt.params.items()},
        replicas=2)
    jctx = guarded(JCtx, JPlan, jt, jcfg, args[3])
    tctx = guarded(ResilienceContext, FaultPlan, tt, tcfg, args[3])
    assert tt.guard_counters() == jt.guard_counters()
    assert tctx.rollbacks or tt.guard_counters()["bad_steps"] == 1
    assert tctx.rollbacks == jctx.rollbacks == (policy == "rollback")
    for n, v in tt.params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jt.params[n]),
                                   atol=TOL, err_msg=n)
        np.testing.assert_allclose(tt.center[n].numpy(),
                                   np.asarray(jt.center[n]), atol=TOL)
