"""The replica engine beside the seq, expert and pipe axes
(singa_tpu_torch/trainer/replica.py: each replica the lane of every rank
of its data index, its params laid as the JAX engine lays them,
``P(data, *spec)``: an expert-split param split over the lane's expert
ranks, the others whole on every rank; each lane rank's piece of its
replica's batch split over seq).

Elastic rounds on 2 replicas of the axes LM, 8 steps with a round every
2 from step 1, are held to the JAX ReplicaTrainer on the same mesh,
every replica's params and the center within 1e-4: data 2 x seq 2 (ring
attention) and data 2 x expert 2 (kMoE, psum). Data 2 x pipe 2 is held
to the JAX engine's unstaged run on data 2 (the JAX staged pipeline is
wrong on this image). Each round is held to the Elastic formula in
float64 on the host, from the replicas and center before it, within
ROUND_ULPS float32 ulps per element, each at the largest operand of its
round. A planted fault (each lane's pieces joined in reversed rank
order) must move the params past the bar 100 times (tests/test_torch_replica_axes_ep.py holds the expert
case and the fault).
"""

import jax
import numpy as np
import pytest
import torch

from singa_tpu.config import parse_model_config as j_parse
from singa_tpu.trainer import ReplicaTrainer as JReplica
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.parallel import build_full_mesh
from singa_tpu_torch.trainer import ReplicaTrainer, params_from_numpy
from singa_tpu_torch.trainer import replica as t_replica
from test_torch_axes_seq import (
    lm_text,
    one_torch_thread,  # noqa: F401 (autouse)
    shard,  # noqa: F401 (fixture)
)
from test_torch_moe_routing import jax_mesh, width_of

JAX_TOL = 1e-4
#: chip_smoke's REPLICA_ROUND_TOL, 6e-8, is 8 float32 ulps at 0.1 (the
#: mlp's values); the LM's values reach ~2, so a round is held to 8 ulps
#: per element, each at the largest operand of its round (the replicas'
#: and center's values before and after it; at the formula's own value a
#: round that cancels reads hundreds of ulps)
ROUND_ULPS = 8
PARAM = ('updater { type: kSGD momentum: 0.9 base_learning_rate: 0.05\n'
         '           param_type: "Param" }')
ELASTIC = ('updater { type: kSGD momentum: 0.9 base_learning_rate: 0.05\n'
           '           param_type: "Elastic" sync_frequency: 2 '
           'moving_rate: 0.3 warmup_steps: 1 }')
MESHES = {
    "seq": ({"data": 2, "seq": 2}, None, dict(mode="ring")),
    "expert": ({"data": 2, "expert": 2}, None, dict(moe="psum")),
    "pipe": ({"data": 2, "pipe": 2}, {"data": 2}, dict(stages=True)),
}


def text_of(shard, kw) -> str:
    return lm_text(shard, **kw).replace(PARAM, ELASTIC).replace(
        "train_steps: 4", "train_steps: 8")


def formula(reps: dict, center: dict, alpha: float):
    """One Elastic round in float64: replica by replica in order."""
    reps = {n: v.copy() for n, v in reps.items()}
    center = {n: v.copy() for n, v in center.items()}
    for n, c in center.items():
        for i in range(reps[n].shape[0]):
            diff = alpha * (reps[n][i] - c)
            c += diff
            reps[n][i] -= diff
    return reps, center


def host64(tree) -> dict:
    return {n: v.detach().double().numpy() for n, v in tree.items()}


def run(shard, axis):
    """-> (the JAX engine, the port's, the port's round errors)."""
    widths, jwidths, kw = MESHES[axis]
    text = text_of(shard, kw)
    jt = JReplica(j_parse(text), mesh=jax_mesh(jwidths or widths), seed=0,
                  log=lambda s: None, prefetch=False)
    init = {n: np.asarray(v) for n, v in jt._unpad_stored(jt.params).items()}
    jt.run()
    tr = ReplicaTrainer(t_parse(text), mesh=build_full_mesh(
        widths, ["cpu"] * width_of(widths)), seed=0, log=lambda s: None)
    tr.params = params_from_numpy(tr.train_net, init, replicas=2)
    errs = []
    inner = tr._sync_round

    def checked():
        reps, center = host64(tr.params), host64(tr.center)
        want = formula(reps, center, tr.moving_rate)
        inner()
        # per element, the ulp of the largest operand of its round
        ulp = {n: np.spacing(np.maximum.reduce([
            np.abs(reps[n]).max(0), np.abs(c), np.abs(want[0][n]).max(0),
            np.abs(want[1][n])]).astype(np.float32))
            for n, c in center.items()}
        for got, ref in ((host64(tr.params), want[0]),
                         (host64(tr.center), want[1])):
            errs.append(max(float((np.abs(got[n] - ref[n]) / ulp[n]).max())
                            for n in ref))

    tr._sync_round = checked
    tr.run()
    return jt, tr, errs


def deviation(jt, tr) -> float:
    jp = jt._unpad_stored(jt.params)
    out = max(float(np.abs(tr._unpad_one(n, v).numpy()
                           - np.asarray(jp[n])).max())
              for n, v in tr.params.items())
    return max(out, max(float(np.abs(
        tr._unpad_one(n, v).numpy()
        - np.asarray(jt._unpad_one(n, jt.center[n]))).max())
        for n, v in tr.center.items()))


@pytest.mark.parametrize("axis", ["seq", "pipe"])
def test_elastic_replicas_beside_the_axis_match_jax(shard, axis):
    jt, tr, errs = run(shard, axis)
    check_run(axis, jt, tr, errs)


def check_run(axis, jt, tr, errs):
    """2 replicas of a lane each, every round within ROUND_ULPS of its
    formula, the replicas and center within JAX_TOL of the JAX engine's."""
    widths = MESHES[axis][0]
    assert tr.nreplicas == 2 and len(tr._lane(1)) == width_of(widths) // 2
    assert len(errs) >= 4 and max(errs) <= ROUND_ULPS, errs
    assert deviation(jt, tr) <= JAX_TOL
