"""The guard seam of the port's other engines against the JAX package's,
on the CPU: the replica engine (one verdict over every replica, the
counters shared, a rollback restoring the replicas and the ``.server``
sidecar) and the CD engine (the CD grads and every RBM's metrics), as
tests/test_resilience.py holds the JAX engines; then the port's q8 ring
(a bad rank voids the step on every rank, its residuals rolled back to
the bit) and a torn ``.server`` sidecar that never becomes LATEST.

Both packages start from the same params (the JAX trainer's, loaded into
the port) and, for CD, the same table of uniforms.
"""

import os

import jax
import numpy as np
import pytest
import torch

from singa_tpu.config import parse_model_config as j_parse
from singa_tpu.config.schema import ClusterConfig as JCluster
from singa_tpu.parallel import build_mesh as j_mesh
from singa_tpu.resilience import FaultPlan as JPlan
from singa_tpu.resilience import ResilienceContext as JCtx
from singa_tpu.trainer import ReplicaTrainer as JReplica
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.config.schema import ClusterConfig
from singa_tpu_torch.data import loader as t_loader
from singa_tpu_torch.parallel import apply_grad_comm_tag, build_mesh
from singa_tpu_torch.resilience import FaultPlan, ResilienceContext
from singa_tpu_torch.resilience import retention
from singa_tpu_torch.resilience.guard import GUARD_KEYS
from singa_tpu_torch.trainer import (
    ReplicaTrainer,
    Trainer,
    params_from_numpy,
)
from test_resilience import MLP_CONF
from test_torch_axes_seq import lm_text
from test_torch_launch import one_torch_thread  # noqa: F401
from test_torch_rbm import (  # noqa: F401
    RBM_CONF,
    confs,
    injected,
    np_tree,
    shards as rbm_shards,
    t_trainer,
)

TOL = 1e-4


@pytest.fixture(scope="module")
def mlp_shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("eng")
    out = {"train": str(root / "train"), "test": str(root / "test")}
    t_loader.write_records(out["train"], *t_loader.synthetic_arrays(
        256, seed=1))
    t_loader.write_records(out["test"], *t_loader.synthetic_arrays(
        64, seed=1, noise_seed=2))
    return out


def replica_confs(shards, root, steps, ckpt, resilience):
    """tests/test_resilience.py's replica job (Elastic 0.3, every 2 steps
    after 2) in both packages -> ((jax cfg, cluster), (port cfg,
    cluster))."""
    text = MLP_CONF.format(
        train_shard=shards["train"], test_shard=shards["test"],
        train_steps=steps, checkpoint_frequency=ckpt, resilience=resilience)
    out = []
    for parse, cluster, tag in ((j_parse, JCluster, "j"),
                                (t_parse, ClusterConfig, "t")):
        cfg = parse(text)
        cfg.updater.param_type = "Elastic"
        cfg.updater.moving_rate = 0.3
        cfg.updater.sync_frequency = 2
        cfg.updater.warmup_steps = 2
        cl = cluster()
        cl.workspace = str(root / tag)
        cl.nservers = 1
        cl.bandwidth = 1e9
        cl.nworkers = 2
        cl.synchronous = False
        out.append((cfg, cl))
    return out


def guarded(ctx_cls, plan_cls, tr, cfg, faults):
    ctx = ctx_cls(cfg.resilience, plan_cls.parse(faults), log=lambda s: None)
    ctx.bind(tr)
    try:
        tr.run()
    finally:
        ctx.stop()
    return ctx


@pytest.mark.parametrize("policy", ["skip", "rollback"])
def test_replica_guard_matches_jax(policy, mlp_shards, tmp_path):
    """tests/test_resilience.py's replica drills (nanloss@5 under kSkip;
    nanloss@6 under kRollback after 1 with saves every 4) in both
    packages: the same counters and rollbacks, the replicas and the
    center within 1e-4."""
    if policy == "skip":
        args = (10, 0, "guard_policy: kSkip", "nanloss@5")
    else:
        args = (12, 4, "guard_policy: kRollback guard_rollback_after: 1 "
                "guard_lr_backoff: 0.5", "nanloss@6")
    (jcfg, jcl), (tcfg, tcl) = replica_confs(mlp_shards, tmp_path, *args[:3])
    jt = JReplica(jcfg, jcl, seed=3, log=lambda s: None, prefetch=False,
                  mesh=j_mesh(2, 1, jax.devices()[:2]))
    tt = ReplicaTrainer(tcfg, tcl, seed=3, log=lambda s: None,
                        device="cpu", prefetch=False)
    tt.params = params_from_numpy(tt.train_net, np_tree(jt.params),
                                  replicas=2)
    jctx = guarded(JCtx, JPlan, jt, jcfg, args[3])
    tctx = guarded(ResilienceContext, FaultPlan, tt, tcfg, args[3])
    assert tt.guard_counters() == jt.guard_counters()
    assert tctx.rollbacks == jctx.rollbacks == (policy == "rollback")
    assert tt._bootstrapped and tt.center is not None
    for n, v in tt.params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jt.params[n]),
                                   atol=TOL, err_msg=n)
        np.testing.assert_allclose(tt.center[n].numpy(),
                                   np.asarray(jt.center[n]), atol=TOL)


@pytest.mark.parametrize("policy", ["skip", "rollback"])
def test_cd_guard_matches_jax(policy, rbm_shards, injected, tmp_path):
    """nanloss@3 on the CD engine (kSkip; kRollback after 1 with saves
    every 2): the same counters and rollbacks, the RBMs within 1e-4."""
    jcfg, tcfg = confs(RBM_CONF, rbm_shards)
    for cfg, parse in ((jcfg, j_parse), (tcfg, t_parse)):
        res = parse("resilience { guard_policy: kSkip }").resilience
        if policy == "rollback":
            res.guard_policy = "kRollback"
            res.guard_rollback_after = 1
            res.guard_lr_backoff = 0.5
            cfg.checkpoint_frequency = 2
        cfg.resilience = res
        cfg.train_steps = 6
    jcl, tcl = JCluster(), ClusterConfig()
    jcl.workspace, tcl.workspace = str(tmp_path / "j"), str(tmp_path / "t")
    from singa_tpu.trainer import make_trainer as j_make

    jt = j_make(jcfg, jcl, mesh=j_mesh(1, 1, jax.devices()[:1]), seed=0,
                log=lambda s: None, prefetch=False)
    tt = t_trainer(tcfg, cluster_cfg=tcl)
    tt.params = params_from_numpy(tt.train_net, np_tree(jt.params))
    jctx = guarded(JCtx, JPlan, jt, jcfg, "nanloss@3")
    tctx = guarded(ResilienceContext, FaultPlan, tt, tcfg, "nanloss@3")
    assert tt.guard_counters() == jt.guard_counters()
    assert tctx.rollbacks == jctx.rollbacks == (policy == "rollback")
    if policy == "skip":
        assert tt.guard_counters()["bad_steps"] == 1
    for n, v in tt.params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jt.params[n]),
                                   atol=TOL, err_msg=n)


def _bytes(tr) -> dict:
    out = {("p", n): v.numpy().tobytes() for n, v in tr.params.items()}
    out.update({("s", n, s): v.numpy().tobytes()
                for n, slots in tr.state.items() for s, v in slots.items()})
    out.update({("b", n): v.numpy().tobytes()
                for n, v in tr.buffers.items() if n not in GUARD_KEYS})
    return out


def test_ring_guard_rolls_every_rank_back(tmp_path):
    """The q8wire ring on 2 CPU ranks under kSkip, a poison token (its
    table row NaN) in rank 1's slice of step 2: the step leaves every
    param, slot and ring residual byte as it was, bad_steps 1, and the
    other steps move them."""
    toks, labels = t_loader.synthetic_token_arrays(32, seq_len=16, vocab=64)
    toks = np.minimum(toks, 62)
    toks[2 * 8 + 5, 3] = 63  # batch 8: rank 1 reads rows 4-7 of step 2
    shard = str(tmp_path / "tok")
    t_loader.write_records(shard, toks, labels)
    cfg = t_parse(lm_text(shard) + "resilience { guard_policy: kSkip }\n")
    apply_grad_comm_tag(cfg, "q8wire")
    cfg.grad_comm.buckets = 2
    tr = Trainer(cfg, mesh=build_mesh(2, 1, ["cpu"] * 2), seed=0,
                 log=lambda s: None, prefetch=False)
    with torch.no_grad():
        tr.params["embed/tok"][63] = float("nan")
    snaps = []
    for step in range(4):
        snaps.append(_bytes(tr))
        tr.train_one_batch(step)
    snaps.append(_bytes(tr))
    res = [k for k in snaps[0] if k[0] == "b" and "__gradres__" in k[1]]
    assert res
    assert snaps[3] == snaps[2]
    assert all(snaps[3][k] != snaps[4][k] for k in res)
    assert snaps[2] != snaps[1]
    assert tr.guard_counters()["bad_steps"] == 1


def test_torn_sidecar_never_becomes_latest(mlp_shards, tmp_path):
    """A sharded replica save whose ``.server`` sidecar tore (the 1st
    save) fails validation: LATEST never names it."""
    _, (tcfg, tcl) = replica_confs(mlp_shards, tmp_path, 8, 4, "")
    tcfg.checkpoint_format = "sharded"
    log = []
    tt = ReplicaTrainer(tcfg, tcl, seed=3, log=log.append, device="cpu",
                        prefetch=False)
    ctx = ResilienceContext(tcfg.resilience, FaultPlan.parse(
        "torn_sidecar@1"), log=log.append)
    ctx.bind(tt)
    try:
        tt.run()
    finally:
        ctx.stop()
    ck = os.path.join(tcl.workspace, "checkpoints")
    assert any("step_4.ckpt failed validation" in s for s in log)
    with open(os.path.join(ck, "LATEST")) as f:
        assert f.read().strip() == "step_8.ckpt"
    assert not retention.validate_checkpoint(os.path.join(ck, "step_4.ckpt"))
