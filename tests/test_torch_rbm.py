"""RBM pretraining by contrastive divergence in the port against the
JAX package: ``layers/rbm.py`` (kRBM) and ``trainer/cd.py``
(CDTrainer, unroll_autoencoder), on examples/mnist/rbm.conf narrowed as
the nets tests narrow the autoencoder (hidden widths / 10, at least 8;
batch 16) over synthetic MNIST-shaped shards.

The Gibbs chain's Bernoulli draws come from another generator in each
package, so both take the same table of uniforms keyed by shape:
``jax.random.bernoulli`` and the port's ``layers.rbm.bernoulli`` are
monkeypatched to ``uniform < p`` over it, as tests/test_torch_nets_ops.py
injects dropout's draw.
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import params as j_params
from singa_tpu.config import load_model_config as j_load
from singa_tpu.graph.builder import build_net as j_build_net
from singa_tpu.parallel import build_mesh
from singa_tpu.trainer import make_trainer as j_make_trainer
from singa_tpu.trainer.cd import unroll_autoencoder as j_unroll
from singa_tpu.trainer.checkpoint import save_checkpoint as j_save
from singa_tpu_torch.config import load_model_config as t_load
from singa_tpu_torch.config import parse_cluster_config as t_cluster
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.config.schema import ConfigError
from singa_tpu_torch.data import loader as t_loader
from singa_tpu_torch.graph.builder import build_net as t_build_net
from singa_tpu_torch.layers import rbm as t_rbm
from singa_tpu_torch.trainer import (
    CDTrainer,
    ReplicaTrainer,
    Trainer,
    make_trainer,
    params_from_numpy,
    save_checkpoint,
    unroll_autoencoder,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
RBM_CONF = REPO / "examples" / "mnist" / "rbm.conf"
AE_CONF = REPO / "examples" / "mnist" / "autoencoder.conf"
PAIRS = [("rbm1", "dec1"), ("rbm2", "dec2"), ("rbm3", "dec3"),
         ("rbm4", "dec4")]
RBMS = [r for r, _ in PAIRS]


def table(shape) -> np.ndarray:
    """The injected uniforms for a draw of ``shape``, float32 in [0, 1)."""
    shape = tuple(int(d) for d in shape)
    seed = 7919 * sum(shape) + len(shape)
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.fixture
def injected(monkeypatch):
    """Both packages' Bernoulli draws from ``table``."""
    monkeypatch.setattr(
        jax.random, "bernoulli",
        lambda key, p: jnp.asarray(table(p.shape)) < p)
    monkeypatch.setattr(
        t_rbm, "bernoulli",
        lambda gen, p: torch.from_numpy(table(p.shape)).to(p.device) < p)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("rbm")
    out = {"train": str(root / "train"), "test": str(root / "test")}
    t_loader.write_records(out["train"], *t_loader.synthetic_arrays(64))
    t_loader.write_records(out["test"],
                           *t_loader.synthetic_arrays(32, noise_seed=1))
    return out


def narrow(cfg, shards, batch=16):
    """Narrow one package's rbm.conf or autoencoder.conf in place."""
    cfg.checkpoint = None
    for layer in cfg.neuralnet.layer:
        if layer.type == "kShardData":
            test = "kTrain" in (layer.exclude or [])
            layer.data_param.path = shards["test" if test else "train"]
            layer.data_param.batchsize = batch
            layer.data_param.random_skip = 0
        for p in (layer.rbm_param, layer.inner_product_param):
            if p is None:
                continue
            attr = "num_hidden" if p is layer.rbm_param else "num_output"
            if getattr(p, attr) != 784:
                setattr(p, attr, max(8, getattr(p, attr) // 10))
    return cfg


def confs(path, shards):
    return narrow(j_load(str(path)), shards), narrow(t_load(str(path)),
                                                      shards)


def np_tree(tree):
    return {n: np.asarray(v) for n, v in tree.items()}


def j_trainer(cfg):
    return j_make_trainer(cfg, mesh=build_mesh(1, 1, jax.devices()[:1]),
                          seed=0, log=lambda s: None, prefetch=False)


def t_trainer(cfg, **kw):
    return make_trainer(cfg, seed=0, log=lambda s: None, device="cpu", **kw)


def step_metrics(tr, step):
    tr.train_one_batch(step)
    avg = tr.perf.avg()
    tr.perf.reset()
    return {name: m["loss"] for name, m in avg.items()}


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sample_visible", [False, True])
@pytest.mark.parametrize("cd_k", [1, 2])
def test_cd_grads_and_recon_error_match_jax(shards, injected, cd_k,
                                            sample_visible):
    """One RBM's CD-k grads and reconstruction errors on the same
    params, batch and uniforms: within 1e-5 at float32."""
    jcfg, tcfg = confs(RBM_CONF, shards)
    for cfg in (jcfg, tcfg):
        for layer in cfg.neuralnet.layer:
            if layer.rbm_param is not None:
                layer.rbm_param.cd_k = cd_k
                layer.rbm_param.sample_visible = sample_visible
    jnet, tnet = j_build_net(jcfg), t_build_net(tcfg)
    jp = j_params.init_params(jax.random.PRNGKey(0), jnet.param_specs())
    tp = params_from_numpy(tnet, np_tree(jp))
    v0 = np.random.RandomState(cd_k).rand(16, 1, 28, 28).astype(np.float32)
    jl, tl = jnet.name2layer["rbm1"], tnet.name2layer["rbm1"]
    jg, jm = jl.cd_grads(jp, jnp.asarray(v0), jax.random.PRNGKey(1))
    tg, tm = tl.cd_grads(tp, torch.from_numpy(v0),
                         torch.Generator().manual_seed(1))
    assert set(tg) == set(jg) == {"rbm1/weight", "rbm1/vbias", "rbm1/hbias"}
    for name in jg:
        np.testing.assert_allclose(tg[name].numpy(), np.asarray(jg[name]),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), abs=1e-5)
    assert float(tl.recon_error(tp, torch.from_numpy(v0))) == pytest.approx(
        float(jl.recon_error(jp, jnp.asarray(v0))), abs=1e-5)
    # the feature view: mean-field hidden probabilities
    np.testing.assert_allclose(
        tl.apply(tp, [torch.from_numpy(v0)], training=False).numpy(),
        np.asarray(jl.apply(jp, [jnp.asarray(v0)], training=False)),
        atol=1e-5, rtol=1e-5)


def test_bernoulli_draws_are_seeded_on_the_tensors_device():
    p = torch.full((64, 64), 0.5)
    a = t_rbm.bernoulli(torch.Generator().manual_seed(3), p)
    b = t_rbm.bernoulli(torch.Generator().manual_seed(3), p)
    c = t_rbm.bernoulli(torch.Generator().manual_seed(4), p)
    assert a.dtype == torch.bool and a.device == p.device
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert 0.4 < a.float().mean().item() < 0.6


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def test_cd_trainer_matches_jax_over_five_steps(shards, injected):
    """5 CD steps of the narrowed rbm.conf from the same params on the
    same batches and uniforms: every RBM's reconstruction error within
    1e-4, then the test phase's; the step stays eager by rule."""
    jcfg, tcfg = confs(RBM_CONF, shards)
    jt, tt = j_trainer(jcfg), t_trainer(tcfg)
    assert isinstance(tt, CDTrainer)
    assert tt.dispatch_mode == "eager"
    assert "draws on the device" in tt.dispatch_reason
    tt.params = params_from_numpy(tt.train_net, np_tree(jt.params))
    for step in range(5):
        jm, tm = step_metrics(jt, step), step_metrics(tt, step)
        assert set(tm) == set(jm) == set(RBMS)
        for name in RBMS:
            assert tm[name] == pytest.approx(jm[name], abs=1e-4), (step, name)
    for name in tt.params:
        np.testing.assert_allclose(tt.params[name].numpy(),
                                   np.asarray(jt.params[name]),
                                   atol=1e-4, err_msg=name)
    jev = jt.evaluate(jt.test_net, 2, "test", 5)
    tev = tt.evaluate(tt.test_net, 2, "test", 5)
    for name in RBMS:
        assert tev[name]["loss"] == pytest.approx(jev[name]["loss"],
                                                  abs=1e-4)


def test_cd_trains_only_the_rbm_params_and_recon_error_falls(shards):
    """Real draws (no injection): the reconstruction errors fall and two
    trainers from one seed give the same bits."""
    _, tcfg = confs(RBM_CONF, shards)
    a, b = t_trainer(tcfg), t_trainer(confs(RBM_CONF, shards)[1])
    first = step_metrics(a, 0)
    assert step_metrics(b, 0) == first
    for step in range(1, 30):
        last = step_metrics(a, step)
    for name in RBMS:
        assert np.isfinite(last[name]) and last[name] < first[name], name


def test_unrolled_checkpoints_load_across_packages(shards, injected,
                                                   tmp_path):
    """A pretrained stack from either package, unrolled by either
    package's unroll_autoencoder, gives the same checkpoint, which the
    other package loads as autoencoder.conf's kPretrained init."""
    jcfg, tcfg = confs(RBM_CONF, shards)
    jt, tt = j_trainer(jcfg), t_trainer(tcfg)
    for step in range(2):
        jt.train_one_batch(step)
        tt.train_one_batch(step)
    j_save(str(tmp_path / "j_stack.npz"), 2, jt.params, jt.state)
    save_checkpoint(str(tmp_path / "t_stack.npz"), 2, tt.params, tt.state)
    for src in ("j_stack", "t_stack"):
        jout = j_unroll(str(tmp_path / f"{src}.npz"),
                        str(tmp_path / f"{src}_j.npz"), PAIRS)
        tout = unroll_autoencoder(str(tmp_path / f"{src}.npz"),
                                  str(tmp_path / f"{src}_t.npz"), PAIRS)
        with np.load(jout) as zj, np.load(tout) as zt:
            assert set(zj.files) == set(zt.files)
            assert int(zt["__step__"]) == 0
            for key in zj.files:
                np.testing.assert_array_equal(zt[key], zj[key])
    # the port's unroll as the JAX autoencoder's init, and the reverse
    for loader, trainer, path, stack in (
            (j_load, j_trainer, "t_stack_t.npz", tt.params),
            (t_load, t_trainer, "j_stack_j.npz", jt.params)):
        cfg = narrow(loader(str(AE_CONF)), shards)
        cfg.checkpoint = str(tmp_path / path)
        ae = trainer(cfg)
        got = np_tree(ae.params)
        for rbm, dec in PAIRS:
            w = np.asarray(stack[f"{rbm}/weight"])
            np.testing.assert_array_equal(got[f"{rbm}/weight"], w)
            np.testing.assert_array_equal(got[f"{dec}/weight"], w.T)
            np.testing.assert_array_equal(
                got[f"{rbm}/bias"], np.asarray(stack[f"{rbm}/hbias"]))
            np.testing.assert_array_equal(
                got[f"{dec}/bias"], np.asarray(stack[f"{rbm}/vbias"]))
    with pytest.raises(ConfigError, match="no RBM params for 'rbm9'"):
        unroll_autoencoder(str(tmp_path / "t_stack.npz"),
                           str(tmp_path / "bad.npz"), [("rbm9", "dec9")])


def test_sigmoid_grad_stays_finite_where_jax_overflows():
    """The unrolled stack drives decoder pre-activations below -88.7,
    where the JAX package's 1 / (1 + exp(-x)) differentiates to NaN; the
    port's sigmoid (torch.sigmoid) keeps the gradient finite and agrees
    with JAX's elsewhere."""
    from singa_tpu.ops.activations import sigmoid as j_sigmoid
    from singa_tpu_torch.ops.activations import sigmoid as t_sigmoid

    x = np.array([-97.0, -30.0, -1.5, 0.0, 2.0, 97.0], np.float32)
    jg = np.asarray(jax.grad(lambda a: j_sigmoid(a).sum())(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    t_sigmoid(xt).sum().backward()
    assert np.isnan(jg[0]) and np.isfinite(xt.grad.numpy()).all()
    np.testing.assert_allclose(xt.grad.numpy()[1:], jg[1:], atol=1e-7,
                               rtol=1e-6)
    np.testing.assert_allclose(t_sigmoid(xt).detach().numpy(),
                               np.asarray(j_sigmoid(jnp.asarray(x))),
                               atol=1e-7, rtol=1e-6)


# ---------------------------------------------------------------------------
# what CD refuses, as the JAX package does
# ---------------------------------------------------------------------------


def _rbm_text(shards, extra_layers="", head=""):
    txt = RBM_CONF.read_text()
    for old, new in (('path: "examples/mnist/train_shard"',
                      f'path: "{shards["train"]}"'),
                     ('path: "examples/mnist/test_shard"',
                      f'path: "{shards["test"]}"'),
                     ("batchsize: 100", "batchsize: 16")):
        assert old in txt, old
        txt = txt.replace(old, new)
    txt = txt.replace("alg: kContrastiveDivergence",
                      "alg: kContrastiveDivergence\n" + head)
    return txt[:txt.rindex("}")] + extra_layers + "}\n"


@pytest.mark.parametrize("case,match", [
    ("no_rbm", "requires at least one kRBM layer"),
    ("loss", "unsupervised: remove loss layers"),
    ("buffers", "does not support stateful layers"),
    ("ring", "does not support kernels"),
])
def test_cd_keeps_the_jax_refusals(shards, case, match):
    if case == "no_rbm":
        txt = _rbm_text(shards)
        start = txt.index('  layer {\n    name: "rbm1"')
        txt = txt[:start] + txt[txt.rindex("}"):]
    elif case == "loss":
        txt = _rbm_text(shards, '''
  layer { name: "label" type: "kLabel" srclayers: "data" }
  layer { name: "ip" type: "kInnerProduct" srclayers: "rbm4"
          inner_product_param { num_output: 10 } }
  layer { name: "loss" type: "kSoftmaxLoss" srclayers: "ip"
          srclayers: "label" }
''')
    elif case == "buffers":
        txt = _rbm_text(shards, '''
  layer { name: "bn" type: "kBatchNorm" srclayers: "rbm4" }
''')
    else:
        txt = _rbm_text(shards, head="grad_comm { mode: quantized }\n"
                        "kernels { grad_allreduce: quantized_ring }")
    with pytest.raises(ConfigError, match=match):
        t_trainer(t_parse(txt))


def test_make_trainer_picks_the_engine_and_still_refuses_nservers(shards,
                                                                  tmp_path):
    _, tcfg = confs(RBM_CONF, shards)
    assert type(t_trainer(tcfg)) is CDTrainer
    _, ae = confs(AE_CONF, shards)
    for layer in ae.neuralnet.layer:
        for p in layer.param:
            if p.init_method == "kPretrained":
                p.init_method, p.std = "kGaussain", 0.1
    assert type(t_trainer(ae)) is Trainer
    # nservers on an asynchronous cluster: the replica engine, as the JAX
    # make_trainer picks it (the name predates its port); CD goes first
    cluster = t_cluster(f'workspace: "{tmp_path}" nservers: 1 '
                            "synchronous: false")
    assert type(make_trainer(ae, cluster, device="cpu",
                             log=lambda s: None)) is ReplicaTrainer
    assert type(make_trainer(tcfg, cluster, device="cpu",
                             log=lambda s: None)) is CDTrainer


def test_main_runs_rbm_conf_through_make_trainer(shards, tmp_path):
    """``main -model_conf`` on a narrowed rbm.conf: the CD engine, its
    per-RBM reconstruction errors on the display line and the test
    phase's."""
    txt = _rbm_text(shards)
    for old, new in (("train_steps: 6000", "train_steps: 4"),
                     ("display_frequency: 100", "display_frequency: 2"),
                     ("test_frequency: 1000", "test_frequency: 2"),
                     ("test_steps: 10", "test_steps: 1"),
                     ("num_hidden: 1000", "num_hidden: 64"),
                     ("num_hidden: 500", "num_hidden: 32")):
        assert old in txt, old
        txt = txt.replace(old, new)
    conf = tmp_path / "rbm.conf"
    conf.write_text(txt)
    res = subprocess.run(
        [sys.executable, "-m", "singa_tpu_torch.main", "-model_conf",
         str(conf), "-device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=str(REPO),
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert res.returncode == 0, res.stderr
    assert "dispatch: eager" in res.stdout
    train = [l for l in res.stdout.splitlines() if ": train " in l]
    test = [l for l in res.stdout.splitlines() if ": test " in l]
    assert [l.split(":")[0] for l in train] == ["step 0", "step 2"]
    assert test and all(f"{r} [loss" in train[-1] for r in RBMS), res.stdout
