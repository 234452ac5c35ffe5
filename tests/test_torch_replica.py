"""The port's replica engine (singa_tpu_torch/trainer/replica.py) against
the JAX package's ReplicaTrainer on 4 replicas (the suite's virtual CPU
devices for the JAX side, 4 CPU ranks for the port), on
tests/test_consistency.py's MLP job and sync settings.

Each JAX replica initializes from its own key fold, which the port
cannot draw, so both start from the same stacked params: the JAX
trainer's, loaded into the port by ``params_from_numpy(...,
replicas=4)``. Both read the same shards in the same order (replica i
the i-th of 4 consecutive batches). The bars: losses
within 1e-4 over 12 steps, the center (and every replica) within 1e-5.
The RandomSync ratio is pinned on both engines before the first round
(no cluster, so SyncConfig leaves it), or at 1 by ``bandwidth: 1e9``.

Checkpoints: npz and sharded saves with the ``.server`` sidecar cross
both ways (a save of one package resumed by the other reproduces the
saver's own continued trajectory), an Elastic sidecar resumes a
RandomSync job (its snapshots refreshed from the restored replicas),
and a sharded save whose sidecar marker is torn or missing does not
validate.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from singa_tpu.config import parse_cluster_config as j_cluster
from singa_tpu.config import parse_model_config as j_parse
from singa_tpu.config.schema import ConfigError as JConfigError
from singa_tpu.parallel import build_mesh as j_mesh
from singa_tpu.resilience import retention as j_retention
from singa_tpu.trainer import ReplicaTrainer as JReplica
from singa_tpu.trainer import Trainer as JTrainer
from singa_tpu.trainer import make_trainer as j_make
from singa_tpu_torch.config import parse_cluster_config as t_cluster
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.config.schema import ConfigError
from singa_tpu_torch.data import loader as t_loader
from singa_tpu_torch.data.device_prefetch import BurstFeeder, InputFeedError
from singa_tpu_torch.main import main as t_main
from singa_tpu_torch.parallel import build_mesh
from singa_tpu_torch.resilience import retention as t_retention
from singa_tpu_torch.trainer import (
    ReplicaTrainer,
    Trainer,
    make_trainer,
    params_from_numpy,
)
from test_torch_launch import one_torch_thread  # noqa: F401
from test_trainer import MLP_CONF

R = 4
LOSS_TOL = 1e-4
PARAM_TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BN_LAYERS = """
  layer { name: "bn" type: "kBatchNorm" srclayers: "fc1"
    param { name: "gamma" init_method: kConstant value: 1 }
    param { name: "beta" init_method: kConstant value: 0 } }
  layer { name: "tanh1" type: "kTanh" srclayers: "bn" }
"""


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("replica")
    out = {"train": str(root / "train"), "test": str(root / "test")}
    t_loader.write_records(out["train"], *t_loader.synthetic_arrays(640,
                                                                    seed=1))
    t_loader.write_records(out["test"], *t_loader.synthetic_arrays(
        128, seed=1, noise_seed=2))
    return out


def conf_text(shards, protocol="Elastic", *, steps=12, freq=2, warmup=4,
              moving_rate=None, ckfreq=0, extra="", bn=False):
    """The MLP job with the replica protocol settings (JAX
    test_consistency's ``_set_sync``), ``extra`` lines appended."""
    txt = MLP_CONF.format(train_shard=shards["train"],
                          test_shard=shards["test"], train_steps=steps,
                          batchsize=64, lr=0.1, test_frequency=0,
                          checkpoint_frequency=ckfreq)
    if moving_rate is None:
        moving_rate = 0.3 if protocol == "Elastic" else 0.0
    sync = (f'param_type: "{protocol}" moving_rate: {moving_rate} '
            f"sync_frequency: {freq} warmup_steps: {warmup}\n")
    txt = txt.replace("type: kSGD\n", "type: kSGD\n  " + sync)
    if bn:
        old = '  layer {{ name: "tanh1" type: "kTanh" srclayers: "fc1" }}\n'
        old = old.replace("{{", "{").replace("}}", "}")
        assert old in txt
        txt = txt.replace(old, BN_LAYERS)
    return txt + extra


def cluster_text(tmp_path, name="ws", nworkers=R):
    return (f'nworkers: {nworkers} nservers: 1 bandwidth: 1e9 '
            f'workspace: "{tmp_path / name}"')


def jax_trainer(text, cluster=None):
    return JReplica(j_parse(text), None if cluster is None else
                    j_cluster(cluster), mesh=j_mesh(R, 1, jax.devices()[:R]),
                    seed=0, log=lambda s: None, prefetch=False)


def port_trainer(text, cluster=None, init=None, **kw):
    tr = ReplicaTrainer(t_parse(text), None if cluster is None else
                        t_cluster(cluster),
                        mesh=build_mesh(R, 1, ["cpu"] * R), seed=0,
                        log=lambda s: None, **kw)
    if init is not None:
        tr.params = params_from_numpy(tr.train_net, init, replicas=R)
    return tr


def stacked(tree) -> dict:
    return {n: np.asarray(v) for n, v in tree.items()}


def pair(text, ratio=None, cluster=None):
    """The JAX trainer and the port's from its stacked params."""
    jt = jax_trainer(text, cluster)
    tt = port_trainer(text, cluster, init=stacked(jt.params))
    if ratio is not None:
        jt.sample_ratio = tt.sample_ratio = ratio
    return jt, tt


def step_loss(tr, step):
    tr.train_one_batch(step)
    loss = tr.perf.avg()["loss"]["loss"]
    tr.perf.reset()
    return loss


def assert_state_close(jt, tt, tol=PARAM_TOL):
    for name, want in stacked(jt.params).items():
        np.testing.assert_allclose(tt.params[name].numpy(), want, rtol=0,
                                   atol=tol, err_msg=name)
    for name, want in stacked(jt.center).items():
        np.testing.assert_allclose(tt.center[name].numpy(), want, rtol=0,
                                   atol=tol, err_msg=f"center {name}")


def test_bootstrap_publishes_replica0(shards):
    jt, tt = pair(conf_text(shards, steps=5))
    w = tt.params["fc1/weight"]
    assert (w[0] - w[1]).abs().max() > 0  # the replicas start apart
    assert tt.center is None and not tt._bootstrapped
    for s in range(4):
        assert abs(step_loss(jt, s) - step_loss(tt, s)) < LOSS_TOL
    # step 3 crossed the warmup: every replica is the center, bitwise
    assert tt._bootstrapped
    for name, c in tt.center.items():
        for r in range(R):
            assert torch.equal(tt.params[name][r], c), name
    assert_state_close(jt, tt)


@pytest.mark.parametrize("protocol,ratio,bn", [
    ("Elastic", None, False),
    ("RandomSync", 1.0, False),
    ("RandomSync", 0.3, False),
    ("Elastic", None, True),
], ids=["elastic", "random_full", "random_partial", "elastic_bn"])
def test_protocols_match_jax(shards, protocol, ratio, bn):
    """12 steps (4 warmup, a round every 2): losses within 1e-4 at every
    step, the replicas and the center within 1e-5 after; the BatchNorm
    net's per-replica running stats too. At 0.3 both packages sample the
    same coordinates (the params' sorted order, one seeded stream)."""
    jt, tt = pair(conf_text(shards, protocol, bn=bn), ratio)
    for s in range(12):
        jl, tl = step_loss(jt, s), step_loss(tt, s)
        assert abs(jl - tl) < LOSS_TOL, (s, jl, tl)
    assert_state_close(jt, tt)
    if protocol == "RandomSync":
        for name, want in stacked(jt.snapshot).items():
            np.testing.assert_allclose(tt.snapshot[name].numpy(), want,
                                       rtol=0, atol=PARAM_TOL)
        assert tt.sample_ratio == ratio
    if bn:
        for name, want in stacked(jt.buffers).items():
            got = tt.buffers[name].numpy()
            assert got.shape == (R,) + want.shape[1:]
            np.testing.assert_allclose(got, want, rtol=0, atol=PARAM_TOL)


def test_snapshot_is_a_copy(shards):
    """RandomSync's snapshot owns its storage: an aliased one would make
    every delta 0 (the round a silent no-op)."""
    tt = port_trainer(conf_text(shards, "RandomSync", warmup=1))
    tt.train_one_batch(0)
    for r in range(R):
        rep = tt._reps[r]
        for n, v in rep["params"].items():
            assert v.data_ptr() != rep["snapshot"][n].data_ptr()
    before = tt.center["fc1/weight"].clone()
    for s in (1, 2):
        tt.train_one_batch(s)
    assert torch.equal(tt.center["fc1/weight"], before)
    tt.train_one_batch(3)  # the first round: 3 > warmup 1, (3 + 1) % 2 == 0
    assert not torch.equal(tt.center["fc1/weight"], before)


@pytest.mark.parametrize("freq,warmup,steps", [(4, 4, 14), (1, 4, 10),
                                               (3, 2, 11)])
def test_chunked_run_equals_per_step_run(shards, freq, warmup, steps):
    """run() advances by windows cut at the rounds; per-step
    run_one_batch calls must give the same bits. freq 1 at the warmup
    boundary: the first step after the warmup must not round (JAX
    replica.py's review-caught case)."""
    text = conf_text(shards, freq=freq, warmup=warmup, steps=steps)
    a = port_trainer(text)
    assert a._can_chunk()
    windows = []
    chunk = a.train_chunk
    a.train_chunk = lambda s0, n: (windows.append((s0, n)), chunk(s0, n))
    a.run()
    b = port_trainer(text)
    for s in range(steps):
        b.run_one_batch(s)
    # every step past the warmup rounds at freq 1: no window spans two
    assert bool(windows) == (freq > 1)
    assert all(n > 1 for _, n in windows)
    for name, v in a.params.items():
        assert torch.equal(v, b.params[name]), name
    for name, v in a.center.items():
        assert torch.equal(v, b.center[name]), name
    # the JAX per-step trajectory on the same params
    jt = jax_trainer(text)
    c = port_trainer(text, init=stacked(jt.params))
    c.run()
    for s in range(steps):
        jt.run_one_batch(s)
    assert_state_close(jt, c)


def test_chunk_windows_end_at_rounds(shards):
    tt = port_trainer(conf_text(shards, freq=4, warmup=4, steps=20))
    assert tt._chunk_len(0) == 1
    for s in range(6):
        tt.train_one_batch(s)
    assert tt._bootstrapped
    # rounds fire where (s + 1) % 4 == 0 and s > 4
    assert tt._chunk_len(6) == 2
    assert tt._chunk_len(8) == 4
    assert tt._chunk_len(9) == 3


def test_eval_on_replica0_matches_jax(shards):
    jt, tt = pair(conf_text(shards, steps=8))
    for s in range(6):
        jt.train_one_batch(s)
        tt.train_one_batch(s)
    # the replicas differ again after two local steps past the bootstrap
    w = tt.params["fc1/weight"]
    assert (w[0] - w[1]).abs().max() > 0
    want = jt.evaluate(jt.test_net, 4, "test", 6)
    got = tt.evaluate(tt.test_net, 4, "test", 6)
    for k, v in want["loss"].items():
        assert abs(got["loss"][k] - v) < LOSS_TOL, k
    # and it is replica 0's: a one-rank Trainer holding replica 0's params
    one = Trainer(t_parse(conf_text(shards, steps=8)), device="cpu",
                  seed=0, log=lambda s: None)
    one.params = {n: v[0] for n, v in tt.params.items()}
    ref = one.evaluate(one.test_net, 4, "test", 6)
    assert got == ref


@pytest.mark.parametrize("case", ["zero_update", "grad_comm", "param_type",
                                  "no_updater"])
def test_refusals_carry_the_jax_messages(shards, case):
    text = conf_text(shards)
    if case == "zero_update":
        text += "zero_update: true\n"
    elif case == "grad_comm":
        text += "grad_comm { mode: quantized }\n"
    elif case == "param_type":
        text = text.replace('param_type: "Elastic"', 'param_type: "Bogus"')
    with pytest.raises(JConfigError) as want:
        jc = j_parse(text)
        if case == "no_updater":
            jc.updater = None
        JReplica(jc, mesh=j_mesh(R, 1, jax.devices()[:R]),
                 log=lambda s: None, prefetch=False)
    with pytest.raises(ConfigError) as got:
        tc = t_parse(text)
        if case == "no_updater":
            tc.updater = None
        ReplicaTrainer(tc, mesh=build_mesh(R, 1, ["cpu"] * R),
                       log=lambda s: None)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", ["resilience", "model_axis"])
def test_refusals_by_name(shards, case):
    text = conf_text(shards)
    mesh = build_mesh(R, 1, ["cpu"] * R)
    if case == "resilience":
        # the guard seam is ported: a resilience block builds; the conf
        # knob the engine still refuses is the serving fleet's
        tr = ReplicaTrainer(t_parse(text + "resilience { guard_policy: "
                                    "kSkip }\n"), mesh=mesh,
                            log=lambda s: None)
        assert tr._guard is not None and tr.guard_counters()[
            "bad_steps"] == 0
        text += "fleet { }\n"
        match = "not ported to singa_tpu_torch yet: fleet"
    else:
        text = text.replace("neuralnet {",
                            'neuralnet {\n  partition_type: "kLayerPartition"')
        mesh = build_mesh(2, 2, ["cpu"] * 4)
        match = "ReplicaTrainer runs the data axis only"
    with pytest.raises(ConfigError, match=match):
        ReplicaTrainer(t_parse(text), mesh=mesh, log=lambda s: None)


def test_make_trainer_routes_as_the_jax_package(shards, tmp_path):
    text = conf_text(shards, steps=2)
    clusters = {
        "async": 'nworkers: 4 nservers: 2 workspace: "%s"',
        "sync": 'nworkers: 4 nservers: 2 synchronous: true workspace: "%s"',
        "no_servers": 'nworkers: 4 workspace: "%s"',
    }
    for name, c in clusters.items():
        c = c % (tmp_path / name)
        want = type(j_make(j_parse(text), j_cluster(c), mesh=j_mesh(
            R, 1, jax.devices()[:R]), log=lambda s: None, prefetch=False))
        got = type(make_trainer(t_parse(text), t_cluster(c),
                                device="cpu", log=lambda s: None))
        assert got.__name__ == want.__name__, name
    assert want is JTrainer and got is Trainer


def test_main_trains_mlp_conf_on_cluster_elastic(shards, tmp_path):
    """``main -model_conf mlp.conf -cluster_conf cluster_elastic.conf``
    reaches the ReplicaTrainer: the confs as shipped but for the data
    paths, the workspace, narrowed widths, a cut schedule and 2 worker
    groups (the shipped cluster has one)."""
    with open(os.path.join(REPO, "examples/mnist/mlp.conf")) as f:
        text = f.read()
    with open(os.path.join(REPO, "examples/mnist/cluster_elastic.conf")) as f:
        cluster = f.read()
    for old, new in (('path: "train_shard"', f'path: "{shards["train"]}"'),
                     ('path: "test_shard"', f'path: "{shards["test"]}"'),
                     ("train_steps: 60000", "train_steps: 12"),
                     ("test_frequency: 30", "test_frequency: 6"),
                     ("test_steps: 10", "test_steps: 1"),
                     ("display_frequency: 30", "display_frequency: 6"),
                     ("batchsize: 1000", "batchsize: 32"),
                     ("random_skip: 5000", "random_skip: 50"),
                     ("warmup_steps: 60", "warmup_steps: 4"),
                     ("sync_frequency: 8", "sync_frequency: 2"),
                     ("num_output: 2500", "num_output: 48"),
                     ("num_output: 2000", "num_output: 40"),
                     ("num_output: 1500", "num_output: 32"),
                     ("num_output: 1000", "num_output: 24"),
                     ("num_output: 500", "num_output: 16")):
        assert old in text, old
        text = text.replace(old, new)
    for old, new in (('workspace: "examples/mnist/ws"',
                      f'workspace: "{tmp_path / "ws"}"'),
                     ("nworkers: 1", "nworkers: 2")):
        assert old in cluster, old
        cluster = cluster.replace(old, new)
    (tmp_path / "job.conf").write_text(text)
    (tmp_path / "cluster.conf").write_text(cluster)
    assert t_main(["-model_conf", str(tmp_path / "job.conf"),
                   "-cluster_conf", str(tmp_path / "cluster.conf"),
                   "-device", "cpu"]) == 0
    ck = tmp_path / "ws" / "checkpoints" / "step_12.npz"
    with np.load(ck) as z:
        assert z["p|fc1/weight"].shape == (2, 784, 48)
    with np.load(str(ck) + ".server") as z:
        assert z["p|fc1/weight"].shape == (784, 48)
        assert float(z["p|__sample_ratio__"]) == 1.0


def _ckpt_runs(shards, tmp_path, fmt, saver, protocol="RandomSync"):
    """The saver (``"port"`` or ``"jax"``) runs 12 steps with a save at
    8, from the JAX trainer's initial params; -> (the saver, the step-8
    save's path)."""
    extra = 'checkpoint_format: "sharded"\n' if fmt == "sharded" else ""
    text = conf_text(shards, protocol, ckfreq=8, extra=extra)
    cluster = cluster_text(tmp_path, f"{saver}_{fmt}")
    jt = jax_trainer(text, cluster)
    if saver == "port":
        tr = port_trainer(text, cluster, init=stacked(jt.params))
    else:
        tr = jt
    tr.run()
    path = os.path.join(str(tmp_path / f"{saver}_{fmt}"), "checkpoints",
                        "step_8." + ("ckpt" if fmt == "sharded" else "npz"))
    assert os.path.exists(path) and os.path.exists(path + ".server")
    return tr, path, text


@pytest.mark.parametrize("fmt", ["npz", "sharded"])
@pytest.mark.parametrize("saver", ["port", "jax"])
def test_saves_cross_both_packages(shards, tmp_path, fmt, saver):
    """A RandomSync save at step 8 (replicas, slots, streams, and the
    sidecar's center, ratio and snapshots) resumed by the other package
    continues to the saver's own step-12 state."""
    tr, path, text = _ckpt_runs(shards, tmp_path, fmt, saver)
    if fmt == "sharded":
        with open(os.path.join(path, "manifest.json")) as f:
            assert json.load(f)["sidecar"] is True
        assert t_retention.validate_checkpoint(path)
        assert j_retention.validate_checkpoint(path)
    cfg = (j_parse if saver == "port" else t_parse)(text)
    cfg.checkpoint = path
    if saver == "port":
        other = JReplica(cfg, mesh=j_mesh(R, 1, jax.devices()[:R]), seed=0,
                         log=lambda s: None, prefetch=False)
    else:
        other = ReplicaTrainer(cfg, mesh=build_mesh(R, 1, ["cpu"] * R),
                               seed=0, log=lambda s: None)
    assert other.start_step == 8 and other._bootstrapped
    assert other.sample_ratio == 1.0
    for s in range(8, 12):
        other.train_one_batch(s)
    jt, tt = (other, tr) if saver == "port" else (tr, other)
    assert_state_close(jt, tt)
    for name, want in stacked(jt.snapshot).items():
        np.testing.assert_allclose(tt.snapshot[name].numpy(), want, rtol=0,
                                   atol=PARAM_TOL)


def test_elastic_sidecar_resumes_random_sync(shards, tmp_path):
    """An Elastic save has no snapshots: a RandomSync job resumed from it
    takes its replicas as snapshots (param.cc:203-207), in both
    packages, which then agree over 4 more steps."""
    _, path, _ = _ckpt_runs(shards, tmp_path, "npz", "port", "Elastic")
    text = conf_text(shards, "RandomSync")
    tc, jc = t_parse(text), j_parse(text)
    tc.checkpoint = jc.checkpoint = path
    tt = ReplicaTrainer(tc, mesh=build_mesh(R, 1, ["cpu"] * R), seed=0,
                        log=lambda s: None)
    jt = JReplica(jc, mesh=j_mesh(R, 1, jax.devices()[:R]), seed=0,
                  log=lambda s: None, prefetch=False)
    assert tt._bootstrapped
    for name, v in tt.params.items():
        assert torch.equal(tt.snapshot[name], v)
    with np.load(path + ".server") as z:
        for name, v in tt.center.items():
            assert np.array_equal(v.numpy(), z["p|" + name])
    for s in range(8, 12):
        assert abs(step_loss(jt, s) - step_loss(tt, s)) < LOSS_TOL
    assert_state_close(jt, tt)


def test_sidecar_marker_torn_or_missing_is_not_resumable(shards, tmp_path):
    tr, path, _ = _ckpt_runs(shards, tmp_path, "sharded", "port")
    marker = os.path.join(path, "commit_server.json")
    assert t_retention.validate_checkpoint(path)
    with open(marker) as f:
        good = f.read()
    with open(marker, "w") as f:
        f.write(good[: len(good) // 2])  # torn marker
    assert not t_retention.validate_checkpoint(path)
    assert not j_retention.validate_checkpoint(path)
    os.unlink(marker)  # the process died between sidecar and marker
    assert not t_retention.validate_checkpoint(path)
    with open(marker, "w") as f:
        f.write(good)
    assert t_retention.validate_checkpoint(path)
    with open(path + ".server", "ab") as f:
        f.write(b"\0")  # the sidecar torn after its marker
    assert not t_retention.validate_checkpoint(path)
    assert t_retention.resolve_latest(os.path.dirname(path)) != path


@pytest.mark.parametrize("fmt", ["npz", "sharded"])
def test_resume_names_another_replica_count(shards, tmp_path, fmt):
    _, path, text = _ckpt_runs(shards, tmp_path, fmt, "port", "Elastic")
    cfg = t_parse(text)
    cfg.checkpoint = path
    with pytest.raises(ValueError, match="different replica count"):
        ReplicaTrainer(cfg, mesh=build_mesh(2, 1, ["cpu"] * 2),
                       log=lambda s: None)


def test_params_from_numpy_takes_stacked_rows(shards):
    tt = port_trainer(conf_text(shards))
    arrays = {n: np.random.RandomState(0).randn(R, *v.shape[1:]).astype(
        np.float32) for n, v in tt.params.items()}
    tt.params = params_from_numpy(tt.train_net, arrays, replicas=R)
    for n, v in arrays.items():
        for r in range(R):
            assert np.array_equal(tt._reps[r]["params"][n].numpy(), v[r])
    with pytest.raises(ValueError, match="net declares"):
        params_from_numpy(tt.train_net, arrays, replicas=R + 1)
    with pytest.raises(ValueError, match="replicas"):
        tt.params = {n: v[:2] for n, v in arrays.items()}


def test_debug_string_shows_the_replica_spread(shards):
    tt = port_trainer(conf_text(shards))
    for s in range(6):
        tt.train_one_batch(s)
    text = tt.debug_string(5)
    assert "debug (replica 0): " in text and "fc1 " in text
    spread = text.splitlines()[-1]
    assert spread.startswith("replica spread: fc1/bias ")
    assert float(spread.split("fc1/weight ")[1].split(",")[0]) > 0


def test_burst_feeder_eval_draws_exactly_its_batches(shards):
    """Uncached eval streams ride the BurstFeeder under prefetch: the
    metrics and the stream position of the direct path."""
    text = conf_text(shards)
    fed = Trainer(t_parse(text), device="cpu", seed=0, log=lambda s: None,
                  prefetch=True, device_cache=False)
    direct = Trainer(t_parse(text), device="cpu", seed=0,
                     log=lambda s: None, prefetch=False, device_cache=False)
    made = []
    real = fed._assemble_host_batch
    fed._assemble_host_batch = lambda net: (made.append(1), real(net))[1]
    got = fed.evaluate(fed.test_net, 3, "test", 0)
    want = direct.evaluate(direct.test_net, 3, "test", 0)
    assert got == want and len(made) == 3
    (a,), (b,) = (tr._pipelines[id(tr.test_net)].values()
                  for tr in (fed, direct))
    assert a._consumed == b._consumed == 3 and a.position == b.position
    count = iter(range(10))
    feeder = BurstFeeder(lambda: next(count), 2)
    assert [feeder.next(), feeder.next()] == [0, 1]
    with pytest.raises(InputFeedError, match="ended early"):
        feeder.next()
    assert next(count) == 2  # nothing was drawn past the burst
