"""The replica engine beside an expert axis: tests/
test_torch_replica_axes.py's Elastic run on data 2 x expert 2 (kMoE,
psum; each replica's ``moe/up`` and ``moe/down`` split over its lane's
expert ranks) held to the JAX ReplicaTrainer within 1e-4 and each round
to its float64 formula, and the planted fault (each lane's pieces joined
in reversed rank order, the expert pieces swapped) past the bar 100
times.
"""

from singa_tpu_torch.trainer import replica as t_replica
from test_torch_axes_seq import one_torch_thread, shard  # noqa: F401
from test_torch_replica_axes import JAX_TOL, check_run, deviation, run


def test_elastic_replicas_beside_the_expert_axis_match_jax(shard):
    jt, tr, errs = run(shard, "expert")
    assert tr._layout["moe/up"] == (0, "expert")
    assert tr._reps[1]["params"]["moe/up"].shape[0] == 2
    check_run("expert", jt, tr, errs)


def test_reversed_lane_join_exceeds_the_bar(shard, monkeypatch):
    good = t_replica.ReplicaTrainer._join
    monkeypatch.setattr(t_replica.ReplicaTrainer, "_join",
                        lambda self, name, parts: good(self, name,
                                                       parts[::-1]))
    jt, tr, _ = run(shard, "expert")
    assert deviation(jt, tr) > 100 * JAX_TOL
