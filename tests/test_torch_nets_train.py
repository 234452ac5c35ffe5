"""The reference's MNIST and CIFAR nets, whole, in the port against the
JAX package: examples/mnist/mlp.conf (the flagship MLP),
examples/mnist/conv.conf (LeNet), examples/cifar10/alexnet.conf and
examples/mnist/autoencoder.conf.

Each conf is narrowed as ``__graft_entry__._flagship_cfg`` narrows the
MLP: hidden widths and filter counts scaled down, batch 8-16, synthetic
shards (``synthetic_arrays`` for MNIST, ``structured_rgb`` with a
``compute_mean`` mean file for CIFAR), ``random_skip`` 0. The
autoencoder's kPretrained params (filled from an RBM-stack checkpoint
in the real job) are drawn kGaussain instead, and its checkpoint is
dropped.

Compared, on the JAX init's params (``params_from_numpy``): every
layer's activation and every param's gradient (atol 2e-5, rtol 1e-5),
the test phase's loss and precision, and 5 Trainer steps (losses
within 1e-4). kRGBImage's random crop and mirror draw from different
generators in the two packages, so the Trainer comparison runs both
parsers on their eval path (the centre crop); the draws themselves are
tested in tests/test_torch_nets_layers.py.
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
from singa_tpu.layers import data as j_data
from singa_tpu.parallel import build_mesh
from singa_tpu.trainer import Trainer as JTrainer
from singa_tpu_torch.config import load_model_config as t_load
from singa_tpu_torch.data import loader as t_loader
from singa_tpu_torch.graph.builder import build_net as t_build_net
from singa_tpu_torch.layers import data as t_data
from singa_tpu_torch.trainer import Trainer, params_from_numpy

REPO = pathlib.Path(__file__).resolve().parent.parent
ACT = dict(atol=2e-5, rtol=1e-5)

#: name -> (conf, dataset, batch)
NETS = {
    "mlp": ("examples/mnist/mlp.conf", "mnist", 16),
    "lenet": ("examples/mnist/conv.conf", "mnist", 16),
    "alexnet": ("examples/cifar10/alexnet.conf", "cifar", 8),
    "autoencoder": ("examples/mnist/autoencoder.conf", "mnist", 16),
}


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("nets")
    out = {"mnist": str(root / "mnist"), "cifar": str(root / "cifar"),
           "mean": str(root / "mean.npy")}
    t_loader.write_records(out["mnist"], *t_loader.synthetic_arrays(64))
    t_loader.write_records(out["cifar"], *t_loader.structured_rgb(64))
    t_loader.compute_mean(out["cifar"], out["mean"])
    return out


def narrow(cfg, name, shards):
    """Narrow one package's ModelConfig of net ``name`` in place."""
    _, data, batch = NETS[name]
    cfg.checkpoint = None
    for layer in cfg.neuralnet.layer:
        if layer.type == "kShardData":
            layer.data_param.path = shards[data]
            layer.data_param.batchsize = batch
            layer.data_param.random_skip = 0
        if layer.rgbimage_param is not None:
            layer.rgbimage_param.meanfile = shards["mean"]
        ip = layer.inner_product_param
        if ip is not None and ip.num_output not in (10, 784):
            ip.num_output = max(8, ip.num_output // 10)
        conv = layer.convolution_param
        if conv is not None:
            conv.num_filters = max(4, conv.num_filters // 4)
        for p in layer.param:
            if p.init_method == "kPretrained":
                p.init_method, p.std = "kGaussain", 0.1
    return cfg


def confs(name, shards):
    path = str(REPO / NETS[name][0])
    return narrow(j_load(path), name, shards), narrow(t_load(path), name,
                                                      shards)


def np_params(tree):
    return {n: np.asarray(v) for n, v in tree.items()}


def feed(net, torch_side):
    """The first batch of each data layer, for one package."""
    out = {}
    for dl in net.datalayers:
        images = dl.images[:dl.batchsize]
        labels = dl.labels[:dl.batchsize]
        out[dl.name] = (
            {"image": torch.from_numpy(images),
             "label": torch.from_numpy(labels)} if torch_side else
            {"image": jnp.asarray(images), "label": jnp.asarray(labels)})
    return out


@pytest.fixture(scope="module", params=list(NETS))
def both_nets(request, shards):
    """One forward + backward of a narrowed net through both packages on
    the JAX init's params -> (name, JAX (loss, acts, grads), port's)."""
    name = request.param
    jcfg, tcfg = confs(name, shards)
    jnet, tnet = j_build_net(jcfg), t_build_net(tcfg)
    jp = j_params.init_params(jax.random.PRNGKey(0), jnet.param_specs())
    jbatch = feed(jnet, False)
    (jloss, (_, jacts)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: (lambda r: (r[0], (r[1], r[2])))(
            jnet.forward(p, jbatch, training=True, return_acts=True)),
        has_aux=True))(jp)
    tp = {n: v.requires_grad_(True) for n, v in
          params_from_numpy(tnet, np_params(jp)).items()}
    tloss, _, tacts = tnet.forward(tp, feed(tnet, True), training=True,
                                   return_acts=True)
    tloss.backward()
    return (name, (float(jloss), jacts, np_params(jgrads)),
            (tloss.item(), tacts, {n: v.grad.numpy() for n, v in tp.items()}),
            tnet)


def test_every_layer_forward_matches_jax(both_nets):
    name, (jl, jacts, _), (tl, tacts, _), tnet = both_nets
    for layer in tnet.layers:
        got, want = tacts[layer.name], jacts[layer.name]
        if layer.is_datalayer:
            continue
        np.testing.assert_allclose(
            got.detach().numpy(), np.asarray(want),
            err_msg=f"{name}/{layer.name}", **ACT)
    assert tl == pytest.approx(jl, abs=2e-5, rel=1e-5)


def test_every_param_grad_matches_jax(both_nets):
    name, (_, _, jg), (_, _, tg), _ = both_nets
    assert set(tg) == set(jg)
    for n in tg:
        np.testing.assert_allclose(tg[n], jg[n], err_msg=f"{name}/{n}",
                                   **ACT)


def test_nets_use_the_slice_layer_types(both_nets):
    name, _, _, tnet = both_nets
    types = {l.TYPE for l in tnet.layers}
    want = {
        "mlp": {"kMnistImage", "kLabel", "kInnerProduct", "kTanh",
                "kSoftmaxLoss"},
        "lenet": {"kConvolution", "kPooling", "kReLU"},
        "alexnet": {"kRGBImage", "kLRN", "kPooling"},
        "autoencoder": {"kSigmoid", "kEuclideanLoss"},
    }[name]
    assert want <= types
    if name == "alexnet":
        assert {l.pool for l in tnet.layers if l.TYPE == "kPooling"} == \
            {"MAX", "AVE"}


def j_trainer(cfg):
    return JTrainer(cfg, mesh=build_mesh(1, 1, jax.devices()[:1]), seed=0,
                    log=lambda s: None, prefetch=False)


def t_trainer(cfg):
    return Trainer(cfg, seed=0, log=lambda s: None, device="cpu")


def step_loss(tr, step):
    tr.train_one_batch(step)
    loss = tr.perf.avg()["loss"]["loss"]
    tr.perf.reset()
    return loss


@pytest.fixture
def rgb_eval_crop(monkeypatch):
    """Both packages' kRGBImage take the centre crop and no mirror in
    training too (their generators differ)."""
    jorig, torig = j_data.RGBImageLayer.apply, t_data.RGBImageLayer.apply
    monkeypatch.setattr(
        j_data.RGBImageLayer, "apply",
        lambda self, p, i, *, training, rng=None: jorig(
            self, p, i, training=training, rng=None))
    monkeypatch.setattr(
        t_data.RGBImageLayer, "apply",
        lambda self, p, i, *, training, generator=None: torig(
            self, p, i, training=training, generator=None))


@pytest.mark.parametrize("name", list(NETS))
def test_trainer_matches_jax_trainer_over_five_steps(name, shards,
                                                     rgb_eval_crop):
    """5 steps of each narrowed conf from the same params on the same
    batches: losses within 1e-4, then the test phase's metrics
    (kSoftmaxLoss's loss and precision; kEuclideanLoss's loss)."""
    jcfg, tcfg = confs(name, shards)
    jt, tt = j_trainer(jcfg), t_trainer(tcfg)
    tt.params = params_from_numpy(tt.train_net, np_params(jt.params))
    losses = [(step_loss(jt, s), step_loss(tt, s)) for s in range(5)]
    for j, t in losses:
        assert abs(j - t) <= 1e-4, losses
    assert np.isfinite(losses).all()
    jm = jt.evaluate(jt.test_net, 2, "test", 5)
    tm = tt.evaluate(tt.test_net, 2, "test", 5)
    assert set(tm["loss"]) == set(jm["loss"])
    for k in jm["loss"]:
        assert tm["loss"][k] == pytest.approx(jm["loss"][k], abs=1e-4)


def test_elastic_param_type_is_ignored_on_a_sync_cluster(shards):
    """mlp.conf's updater asks for the Elastic protocol; the synchronous
    Trainer ignores param_type, as the JAX Trainer does."""
    _, tcfg = confs("mlp", shards)
    assert tcfg.updater.param_type == "Elastic"
    tt = t_trainer(tcfg)
    assert np.isfinite(step_loss(tt, 0))


def test_main_trains_mlp_conf_from_loader_shards(tmp_path):
    """The CLI path: ``data.loader synthetic`` writes the shards, then
    ``main -model_conf -device cpu`` trains a narrowed copy of
    mlp.conf, logging the test phase's precision."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    for split, n in (("train", "64"), ("test", "32")):
        subprocess.run(
            [sys.executable, "-m", "singa_tpu_torch.data.loader",
             "synthetic", "--output", str(tmp_path / split), "--n", n],
            check=True, env=env, capture_output=True, timeout=120)
    txt = (REPO / "examples" / "mnist" / "mlp.conf").read_text()
    for old, new in (('path: "train_shard"', f'path: "{tmp_path}/train"'),
                     ('path: "test_shard"', f'path: "{tmp_path}/test"'),
                     ("batchsize: 1000", "batchsize: 16"),
                     ("train_steps: 60000", "train_steps: 4"),
                     ("test_frequency: 30", "test_frequency: 2"),
                     ("test_steps: 10", "test_steps: 2"),
                     ("display_frequency: 30", "display_frequency: 2"),
                     ("num_output: 2500", "num_output: 64"),
                     ("num_output: 2000", "num_output: 32")):
        assert old in txt, old
        txt = txt.replace(old, new)
    conf = tmp_path / "mlp.conf"
    conf.write_text(txt)
    res = subprocess.run(
        [sys.executable, "-m", "singa_tpu_torch.main", "-model_conf",
         str(conf), "-device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300,
        cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr
    assert "step 2: test loss" in res.stdout and "precision" in res.stdout
    assert "step 2: train loss" in res.stdout
