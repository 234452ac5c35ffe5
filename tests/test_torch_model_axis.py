"""The model axis beside the port's data-axis features: the replica
engine on a data x model mesh, zero_update and sharded saves there, and
whole model groups across processes (the mesh's admission), against the
JAX package on the suite's virtual CPU devices and against the port's
own data-only runs.

- Replicas x kLayerPartition (the JAX package's TestReplicaComposition,
  tests/test_consistency.py:400-470): the port's ReplicaTrainer on 4
  replicas x 2 model ranks from the JAX 4 x 2 trainer's stacked params,
  Elastic and RandomSync at ratio 1 and 0.3, 12 steps: every replica and
  the center within 1e-4 of the JAX engine, and within the JAX test's
  bar (rtol 2e-4, atol 1e-5) of the port's own 4 x 1 run.
- RandomSync's coordinates over the stored (padded) shapes, bitwise the
  JAX draw; the padded tail stays zero.
- zero_update on 2 x 2 equal to the replicated update to the bit, its
  layout the JAX ``zero_update_shardings``'s.
- A model group per process and one that spans whole processes are
  laid out under a process group, a process holding parts of two groups
  refused by name; ``main`` reaches replicas of model lanes from a
  cluster conf.

The saves on a data x model mesh are tests/test_torch_model_ckpt.py's.
"""

import os
import warnings

import jax
import numpy as np
import pytest

from singa_tpu.config import parse_model_config as j_parse
from singa_tpu.graph.builder import build_net as j_build_net
from singa_tpu.parallel import build_mesh as j_mesh
from singa_tpu.parallel.consistency import (
    sample_sync_indices as j_sample,
)
from singa_tpu.parallel.shardings import param_shardings as j_param_sh
from singa_tpu.parallel.shardings import zero_update_shardings as j_zero_sh
from singa_tpu.trainer import ReplicaTrainer as JReplica
from singa_tpu_torch.config import ConfigError
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.main import main as t_main
from singa_tpu_torch.parallel import build_mesh
from singa_tpu_torch.parallel import consistency as t_cons
from singa_tpu_torch.parallel import mesh as t_mesh
from singa_tpu_torch.parallel import build_full_mesh
from singa_tpu_torch.trainer import ReplicaTrainer, Trainer, params_from_numpy
from singa_tpu_torch.trainer import replica as t_replica
from test_torch_launch import one_torch_thread  # noqa: F401
from test_torch_replica import conf_text
from test_torch_replica import shards  # noqa: F401
from test_torch_zero import losses, same
from test_zero_update import MLP_CONF as ZERO_MLP

JAX_TOL = 1e-4
#: the JAX TestReplicaComposition bar
RTOL, ATOL = 2e-4, 1e-5
PARTITION = 'neuralnet {\n  partition_type: "kLayerPartition"'


def tp(text: str) -> str:
    return text.replace("neuralnet {", PARTITION, 1)


def replica_text(shards, protocol, *, out1=64):
    text = tp(conf_text(shards, protocol, steps=12))
    return text.replace("num_output: 64", f"num_output: {out1}")


def t_replica_run(text, ndata, nmodel, init, ratio=None):
    tr = ReplicaTrainer(t_parse(text), mesh=build_mesh(
        ndata, nmodel, ["cpu"] * (ndata * nmodel)), seed=0,
        log=lambda s: None)
    tr.params = params_from_numpy(tr.train_net, init, replicas=ndata)
    if ratio is not None:
        tr.sample_ratio = ratio
    tr.run()
    return tr


def logical(tr, tree) -> dict:
    return {n: tr._unpad_one(n, v) for n, v in tree.items()}


@pytest.mark.parametrize("protocol,ratio", [
    ("Elastic", None), ("RandomSync", None), ("RandomSync", 0.3)])
def test_replicas_of_model_lanes_match_jax_and_the_data_only_run(
        shards, protocol, ratio):
    text = replica_text(shards, protocol)
    jt = JReplica(j_parse(text), mesh=j_mesh(4, 2, jax.devices()[:8]),
                  seed=0, log=lambda s: None, prefetch=False)
    init = {n: np.asarray(v) for n, v in jt._unpad_stored(jt.params).items()}
    if ratio is not None:
        jt.sample_ratio = ratio
    jt.run()
    t42 = t_replica_run(text, 4, 2, init, ratio)
    t41 = t_replica_run(text, 4, 1, init, ratio)
    assert t42._reps[1]["params"]["fc1/weight"].shape == (784, 32)
    assert t42.mesh_shape == {"data": 4, "model": 2}
    jp = jt._unpad_stored(jt.params)
    for n, v in logical(t42, t42.params).items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jp[n]), rtol=0,
                                   atol=JAX_TOL, err_msg=n)
        np.testing.assert_allclose(v.numpy(), t41.params[n].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=n)
    for n, v in logical(t42, t42.center).items():
        np.testing.assert_allclose(v.numpy(), np.asarray(
            jt._unpad_one(n, jt.center[n])), rtol=0, atol=JAX_TOL, err_msg=n)
        np.testing.assert_allclose(v.numpy(), t41.center[n].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=n)


def test_random_sync_samples_the_stored_coordinates(shards, monkeypatch):
    """fc1's 63 outputs pad to 64 over 2 model ranks: below full
    coverage the round draws over the stored (784, 64) and (64,), bitwise
    the JAX draw given those shapes, and the padded column stays zero in
    every replica, the center and the snapshots."""
    text = replica_text(shards, "RandomSync", out1=63)
    seen = []

    def recording(rng, shapes, nreplicas, ratio):
        state = rng.get_state()
        out = t_cons.sample_sync_indices(rng, shapes, nreplicas, ratio)
        twin = np.random.RandomState()
        twin.set_state(state)
        want = j_sample(twin, shapes, nreplicas, ratio)
        assert all(np.array_equal(out[n], want[n]) for n in want)
        seen.append(shapes)
        return out

    monkeypatch.setattr(t_replica, "sample_sync_indices", recording)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tr = ReplicaTrainer(t_parse(text), mesh=build_mesh(
            4, 2, ["cpu"] * 8), seed=0, log=lambda s: None)
    tr.sample_ratio = 0.3
    tr.run()
    assert seen and seen[0]["fc1/weight"] == (784, 64)
    assert seen[0]["fc1/bias"] == (64,)
    for tree in (tr.params, tr.snapshot, {
            n: v[None] for n, v in tr.center.items()}):
        assert tree["fc1/weight"].shape[1:] == (784, 64)
        assert not tree["fc1/weight"][..., 63].any()
        assert not tree["fc1/bias"][..., 63].any()
    assert logical(tr, tr.params)["fc1/weight"].shape == (4, 784, 63)


def zero_text(shard, zero: bool, fmt="npz") -> str:
    return tp(ZERO_MLP.format(
        shard=shard, zero=str(zero).lower(), train_steps=6,
        checkpoint_frequency=0, checkpoint_format=fmt, extra=""))


@pytest.fixture(scope="module")
def img(tmp_path_factory):
    from singa_tpu_torch.data import loader as t_loader

    path = str(tmp_path_factory.mktemp("tp_img") / "shard")
    t_loader.write_records(path, *t_loader.synthetic_arrays(96, seed=4))
    return path


def test_zero_on_data_x_model_equals_replicated_and_the_jax_layout(img):
    """2 x 2: the zero layout is the JAX zero_update_shardings' data dim
    (dim 0 of the model-split weights; the model-split biases keep a
    replicated update, with the JAX warning), and zero gives the
    replicated run's losses, params and slots to the bit."""
    jcfg = j_parse(zero_text(img, True))
    net = j_build_net(jcfg, "kTrain")
    jm = j_mesh(2, 2, jax.devices()[:4])
    net.bind_mesh(jm)
    jz = j_zero_sh(jm, net, j_param_sh(jm, net))
    want = {n: next((d for d, a in enumerate(sh.spec) if a == "data"), None)
            for n, sh in jz.items()}
    with pytest.warns(UserWarning, match="fc1/bias"):
        tz = Trainer(t_parse(zero_text(img, True)), mesh=build_mesh(
            2, 2, ["cpu"] * 4), seed=3, log=lambda s: None)
    tr = Trainer(t_parse(zero_text(img, False)), mesh=build_mesh(
        2, 2, ["cpu"] * 4), seed=3, log=lambda s: None)
    assert tz.update_mode == "zero" and tz._zero_dims == want
    assert tz._zero_slots[3]["fc1/weight"]["history"].shape == (392, 16)
    assert losses(tz, 4) == losses(tr, 4)
    assert same(tz.params, tr.params)
    assert same(*({(n, k): v for n, slots in t.state.items()
                   for k, v in slots.items()} for t in (tz, tr)))


def test_whole_model_groups_span_processes(monkeypatch):
    """Under a process group the model axis is laid over processes:
    process 1 of 2 holds ranks 2-3, the second model group of a 2 x 2
    mesh, or the second half of the one model group of 1 x 4 (its parts
    cross the processes); a process that would hold parts of two model
    groups is refused by name."""
    monkeypatch.setattr(t_mesh, "_processes", lambda: (2, 1))
    m = build_full_mesh({"data": 2, "model": 2}, ["cpu"] * 2)
    assert list(m.local_ranks) == [2, 3] and m.widths["model"] == 2
    assert {m.coords(r)["data"] for r in m.local_ranks} == {1}
    assert m.spanning_groups() == []
    m = build_full_mesh({"data": 1, "model": 4}, ["cpu"] * 2)
    assert list(m.local_ranks) == [2, 3]
    assert [m.coords(r)["model"] for r in m.local_ranks] == [2, 3]
    assert m.spanning_groups() == [(0, 1)]
    monkeypatch.setattr(t_mesh, "_processes", lambda: (4, 1))
    with pytest.raises(ConfigError, match="model axis width 4 .* across 4 "
                       "processes of 3 ranks: a process would hold parts "
                       "of two model groups"):
        build_full_mesh({"data": 3, "model": 4}, ["cpu"] * 3)


def test_main_trains_replicas_of_model_lanes(shards, tmp_path, capsys):
    """A cluster conf with nprocs_per_group 2 and nservers on an
    asynchronous cluster: main's engine is the ReplicaTrainer over 2
    replicas x 2 model ranks, and its npz save holds the logical
    stacked arrays."""
    conf = tmp_path / "job.conf"
    conf.write_text(tp(conf_text(shards, steps=4, ckfreq=4)))
    cluster = tmp_path / "cluster.conf"
    cluster.write_text(f'nworkers: 4\nnprocs_per_group: 2\nnservers: 1\n'
                       f'workspace: "{tmp_path / "ws"}"\n')
    assert t_main(["-model_conf", str(conf), "-cluster_conf", str(cluster),
                   "-device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "dispatch: eager (the replica engine: 2 replica(s)" in out
    with np.load(tmp_path / "ws" / "checkpoints" / "step_4.npz") as z:
        assert z["p|fc1/weight"].shape == (2, 784, 64)
    assert os.path.exists(tmp_path / "ws" / "checkpoints"
                          / "step_4.npz.server")
