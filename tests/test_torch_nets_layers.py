"""The image nets' layers in the port (singa_tpu_torch.layers.{neuron,
loss,data,connector}) and their plumbing (the registry, Net.forward's
Slice cursor and per-layer generators, the Trainer's step generator,
the loader's image sources) against the JAX package.

Small job confs are built in both packages from the same text and run
on the same shard: each layer's activation within atol 2e-5, rtol 1e-5
(float32). The random draws differ between the packages' generators,
so parity runs take the eval path (kRGBImage's centre crop) or inject
the uniform draw (kDropout); the port's own draws are tested for
determinism under a seed, for independence between layers and steps,
and for their semantics (one crop offset a batch, a per-sample
mirror).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.config import parse_model_config as j_parse
from singa_tpu.data import loader as j_loader
from singa_tpu.graph.builder import build_net as j_build_net
from singa_tpu_torch.config import ConfigError
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.data import loader as t_loader
from singa_tpu_torch.graph.builder import build_net as t_build_net
from singa_tpu_torch.layers import registered_types
from singa_tpu_torch.parallel import build_mesh
from singa_tpu_torch.trainer import ReplicaTrainer, Trainer
from singa_tpu_torch.utils.rng import fold_in

ACT = dict(atol=2e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("layers")
    out = {k: str(root / k) for k in ("mnist", "mnist_c1", "cifar")}
    t_loader.write_records(out["mnist"], *t_loader.synthetic_arrays(16))
    t_loader.write_records(out["mnist_c1"],
                           *t_loader.synthetic_arrays(16, channels=1))
    t_loader.write_records(out["cifar"],
                           *t_loader.structured_rgb(16, seed=3))
    out["mean"] = str(root / "mean.npy")
    t_loader.compute_mean(out["cifar"], out["mean"])
    return out


def net_text(path, body, batch=4):
    return f"""neuralnet {{
  layer {{ name: "data" type: "kShardData"
          data_param {{ path: "{path}" batchsize: {batch} }} }}
  {body}
}}"""


def both_acts(text, *, training=False, generator=None):
    """Build ``text`` in both packages, feed the shard's first batch, run
    one forward (the JAX side on params drawn by the JAX init, shared
    with the port) -> (JAX acts, port acts, port net)."""
    from singa_tpu import params as j_params
    from singa_tpu_torch.trainer import params_from_numpy

    jnet, tnet = j_build_net(j_parse(text)), t_build_net(t_parse(text))
    jp = j_params.init_params(jax.random.PRNGKey(0), jnet.param_specs())
    tp = params_from_numpy(tnet, {n: np.asarray(v) for n, v in jp.items()})
    dl = tnet.datalayers[0]
    images, labels = dl.images[:dl.batchsize], dl.labels[:dl.batchsize]
    _, _, jacts = jnet.forward(
        jp, {"data": {"image": jnp.asarray(images),
                      "label": jnp.asarray(labels)}},
        training=training, return_acts=True,
        rng=jax.random.PRNGKey(0) if generator is not None else None)
    _, _, tacts = tnet.forward(
        tp, {"data": {"image": torch.from_numpy(images),
                      "label": torch.from_numpy(labels)}},
        training=training, generator=generator, return_acts=True)
    return jacts, tacts, tnet


def assert_acts(jacts, tacts, names):
    for name in names:
        np.testing.assert_allclose(
            tacts[name].detach().numpy(), np.asarray(jacts[name]),
            err_msg=name, **ACT)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def test_not_ported_is_exactly_the_rest():
    """Nothing is left: every TYPE the JAX package registers (each layer
    class of singa_tpu/layers) is registered in the port."""
    import inspect

    import singa_tpu.layers as j_layers
    from singa_tpu.layers.base import Layer as JLayer

    j_types = {
        cls.TYPE for mod in (j_layers, *vars(j_layers).values())
        if inspect.ismodule(mod) and mod.__name__.startswith(
            "singa_tpu.layers")
        for cls in vars(mod).values()
        if inspect.isclass(cls) and issubclass(cls, JLayer) and cls.TYPE
    }
    assert "kLMDBData" in j_types and "kMoE" in j_types
    assert j_types <= set(registered_types())


def test_unported_type_and_partitioning_still_raise(shards):
    """An unknown type raises by name. A partition_type builds with the
    reference's partition_dim (kDataPartition splits nothing but the
    batch). kLayerPartition on a model axis splits a conv's filters and
    trains (tests/test_torch_axes_layers.py holds it to the JAX
    package); it raises, naming the layer, where the engine has no split
    form for the type (kBatchNorm in the replica engine's lanes)."""
    with pytest.raises(ConfigError, match="unknown layer type 'kBogus'"):
        t_build_net(t_parse(net_text(shards["mnist"], '''
  layer { name: "bogus" type: "kBogus" srclayers: "data" }''')))
    net = t_build_net(t_parse(net_text(shards["mnist"], '''
  layer { name: "mnist" type: "kMnistImage" srclayers: "data"
          partition_type: kDataPartition }''')))
    assert net.name2layer["mnist"].partition_dim == 0
    text = "updater { base_learning_rate: 0.1 }\n" + net_text(
        shards["mnist"], '''
  layer { name: "mnist" type: "kMnistImage" srclayers: "data" }
  layer { name: "conv" type: "kConvolution" srclayers: "mnist"
          partition_type: kLayerPartition
          convolution_param { num_filters: 2 kernel: 3 } }
  layer { name: "fc" type: "kInnerProduct" srclayers: "conv"
          inner_product_param { num_output: 10 } }
  layer { name: "label" type: "kLabel" srclayers: "data" }
  layer { name: "loss" type: "kSoftmaxLoss" srclayers: "fc"
          srclayers: "label" }''')
    tr = Trainer(t_parse(text), mesh=build_mesh(1, 2, ["cpu"] * 2),
                 log=lambda s: None)
    assert tr._layout["conv/weight"] == (0, "model")
    tr.train_one_batch(0)
    assert np.isfinite(tr.perf.avg()["loss"]["loss"])
    bn = text.replace('base_learning_rate: 0.1',
                      'base_learning_rate: 0.1 param_type: "Elastic"').replace(
        'layer { name: "fc" type: "kInnerProduct" srclayers: "conv"',
        'layer { name: "bn" type: "kBatchNorm" srclayers: "conv"\n'
        '          partition_type: kLayerPartition }\n'
        '  layer { name: "fc" type: "kInnerProduct" srclayers: "bn"')
    with pytest.raises(ConfigError, match="'bn' \\(kBatchNorm\\): "
                       "kLayerPartition"):
        ReplicaTrainer(t_parse(bn), mesh=build_mesh(1, 2, ["cpu"] * 2),
                       log=lambda s: None)


# ---------------------------------------------------------------------------
# parsers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shard", ["mnist", "mnist_c1"])
@pytest.mark.parametrize("resize", [0, 14, 20, 40])
def test_mnist_image_matches_jax(shards, shard, resize):
    """norm_a/norm_b, the C=1 squeeze, and the bilinear resize that
    antialiases when it shrinks (14, 20) and not when it grows (40)."""
    jacts, tacts, tnet = both_acts(net_text(shards[shard], f'''
  layer {{ name: "mnist" type: "kMnistImage" srclayers: "data"
          mnist_param {{ norm_a: 127.5 norm_b: 1 resize: {resize} }} }}
  layer {{ name: "label" type: "kLabel" srclayers: "data" }}'''))
    size = resize or 28
    assert tuple(tacts["mnist"].shape) == (4, size, size)
    assert tnet.name2layer["mnist"].out_shape == (4, size, size)
    assert_acts(jacts, tacts, ["mnist"])
    assert tacts["label"].tolist() == np.asarray(jacts["label"]).tolist()


def test_mnist_distortion_runs_in_training_only(shards):
    body = '''
  layer { name: "mnist" type: "kMnistImage" srclayers: "data"
          mnist_param { norm_a: 255 kernel: 5 sigma: 2 alpha: 3 beta: 10
                        gamma: 10 } }'''
    net = t_build_net(t_parse(net_text(shards["mnist"], body)))
    dl = net.datalayers[0]
    batch = {"data": {"image": torch.from_numpy(dl.images[:4]),
                      "label": torch.from_numpy(dl.labels[:4])}}
    run = lambda **kw: net.forward({}, batch, return_acts=True,  # noqa
                                   **kw)[2]["mnist"]
    plain = torch.from_numpy(dl.images[:4]) / 255
    assert torch.equal(run(training=False), plain)
    g = lambda: torch.Generator().manual_seed(9)  # noqa: E731
    assert torch.equal(run(training=True), plain)  # no generator
    a, b = run(training=True, generator=g()), run(training=True,
                                                  generator=g())
    assert torch.equal(a, b) and not torch.equal(a, plain)


def test_rgb_image_eval_path_matches_jax(shards):
    """Mean subtracted at full size, the centre crop, the scale."""
    jacts, tacts, tnet = both_acts(net_text(shards["cifar"], f'''
  layer {{ name: "rgb" type: "kRGBImage" srclayers: "data"
          rgbimage_param {{ meanfile: "{shards['mean']}" mirror: true
                            cropsize: 27 scale: 0.5 }} }}'''))
    assert tuple(tacts["rgb"].shape) == (4, 3, 27, 27)
    assert_acts(jacts, tacts, ["rgb"])


def test_rgb_image_training_draws(shards):
    """Training: one crop offset for the batch, each sample mirrored or
    not, drawn from the layer's generator (the same twice under one
    seed, other draws under others); eval takes the centre."""
    text = net_text(shards["cifar"], f'''
  layer {{ name: "rgb" type: "kRGBImage" srclayers: "data"
          rgbimage_param {{ meanfile: "{shards['mean']}" mirror: true
                            cropsize: 24 }} }}''', batch=16)
    net = t_build_net(t_parse(text))
    dl = net.datalayers[0]
    images = torch.from_numpy(dl.images[:16])
    batch = {"data": {"image": images,
                      "label": torch.from_numpy(dl.labels[:16])}}
    full = images - torch.from_numpy(np.load(shards["mean"]))

    def crop(seed):
        return net.forward({}, batch, training=True, return_acts=True,
                           generator=torch.Generator().manual_seed(seed)
                           )[2]["rgb"]

    outs = [crop(s) for s in range(4)]
    assert torch.equal(outs[0], crop(0))
    offsets = set()
    for out in outs:
        found = [(h, w) for h in range(9) for w in range(9)
                 if all(torch.equal(out[i], c) or
                        torch.equal(out[i], c.flip(-1))
                        for i, c in enumerate(full[:, :, h:h + 24,
                                                   w:w + 24]))]
        assert found, "not a crop of the mean-subtracted batch"
        h, w = found[0]
        window = full[:, :, h:h + 24, w:w + 24]
        flipped = [not torch.equal(out[i], window[i]) for i in range(16)]
        assert 0 < sum(flipped) < 16
        offsets.add((h, w))
    assert len(offsets) > 1
    centre = net.forward({}, batch, training=False, return_acts=True)[2]
    assert torch.equal(centre["rgb"], full[:, :, 4:28, 4:28])


def test_rgb_meanfile_shape_is_checked(shards, tmp_path):
    bad = tmp_path / "bad.npy"
    np.save(bad, np.zeros((3, 28, 28), np.float32))
    with pytest.raises(ConfigError, match="meanfile shape"):
        t_build_net(t_parse(net_text(shards["cifar"], f'''
  layer {{ name: "rgb" type: "kRGBImage" srclayers: "data"
          rgbimage_param {{ meanfile: "{bad}" }} }}''')))


# ---------------------------------------------------------------------------
# neuron and loss layers outside the four confs' forward checks
# ---------------------------------------------------------------------------


CONNECTORS = '''
  layer { name: "mnist" type: "kMnistImage" srclayers: "data"
          mnist_param { norm_a: 255 } }
  layer { name: "label" type: "kLabel" srclayers: "data" }
  layer { name: "fc" type: "kInnerProduct" srclayers: "mnist"
          inner_product_param { num_output: 8 }
          param { name: "weight" init_method: kUniform low: -0.1 high: 0.1 }
          param { name: "bias" init_method: kUniform low: -0.1 high: 0.1 } }
  layer { name: "slice" type: "kSlice" srclayers: "fc"
          slice_param { slice_dimension: 1 slice_num: 2 } }
  layer { name: "a" type: "kInnerProduct" srclayers: "slice"
          inner_product_param { num_output: 6 }
          param { name: "weight" init_method: kUniform low: -1 high: 1 } }
  layer { name: "b" type: "kInnerProduct" srclayers: "slice"
          inner_product_param { num_output: 3 }
          param { name: "weight" init_method: kUniform low: -1 high: 1 } }
  layer { name: "cat" type: "kConcate" srclayers: "a" srclayers: "b"
          concate_param { concate_dimension: 1 } }
  layer { name: "split" type: "kSplit" srclayers: "cat"
          split_param { num_splits: 1 } }
  layer { name: "bsrc" type: "kBridgeSrc" srclayers: "split" }
  layer { name: "bdst" type: "kBridgeDst" srclayers: "bsrc" }
  layer { name: "relu" type: "kReLU" srclayers: "bdst"
          relu_param { negative_slope: 0.1 } }
  layer { name: "sig" type: "kSigmoid" srclayers: "relu" }
  layer { name: "tanh" type: "kTanh" srclayers: "sig" }
  layer { name: "loss" type: "kSoftmaxLoss" srclayers: "tanh"
          srclayers: "label" softmaxloss_param { topk: 3 scale: 2 } }
'''


def test_connectors_route_like_jax(shards):
    """kSlice's k-th part feeds its k-th consumer (a takes the first 4
    columns of fc, b the last 4), then kConcate, kSplit and the bridges;
    the loss at topk 3 and scale 2."""
    jacts, tacts, tnet = both_acts(net_text(shards["mnist"], CONNECTORS))
    assert tnet.name2layer["a"].vdim == 4 and tnet.name2layer["b"].vdim == 4
    assert tuple(tacts["cat"].shape) == (4, 9)
    assert_acts(jacts, tacts, ["fc", "a", "b", "cat", "split", "bsrc",
                               "bdst", "relu", "sig", "tanh", "loss"])


def test_slice_refuses_uneven_parts(shards):
    with pytest.raises(ConfigError, match="not divisible"):
        t_build_net(t_parse(net_text(shards["mnist"], '''
  layer { name: "mnist" type: "kMnistImage" srclayers: "data" }
  layer { name: "slice" type: "kSlice" srclayers: "mnist"
          slice_param { slice_dimension: 1 slice_num: 3 } }''')))


def test_layer_setup_checks_match_jax(shards):
    """Each conf the JAX package refuses at setup, the port refuses too."""
    bad = [
        '''layer { name: "mnist" type: "kMnistImage" srclayers: "data" }
  layer { name: "lrn" type: "kLRN" srclayers: "mnist"
          lrn_param { local_size: 4 } }''',
        '''layer { name: "mnist" type: "kMnistImage" srclayers: "data" }
  layer { name: "loss" type: "kSoftmaxLoss" srclayers: "mnist" }''',
        '''layer { name: "mnist" type: "kMnistImage" srclayers: "data" }
  layer { name: "fc" type: "kInnerProduct" srclayers: "mnist"
          inner_product_param { num_output: 10 } }
  layer { name: "loss" type: "kEuclideanLoss" srclayers: "fc"
          srclayers: "mnist" }''',
        '''layer { name: "mnist" type: "kMnistImage" srclayers: "data" }
  layer { name: "conv" type: "kConvolution" srclayers: "mnist"
          convolution_param { num_filters: 2 } }''',
        '''layer { name: "mnist" type: "kMnistImage" srclayers: "data" }
  layer { name: "pool" type: "kPooling" srclayers: "mnist" }''',
    ]
    for body in bad:
        text = net_text(shards["mnist"], body)
        with pytest.raises(Exception):
            j_build_net(j_parse(text))
        with pytest.raises(ConfigError):
            t_build_net(t_parse(text))


DROPOUT = '''
  layer { name: "mnist" type: "kMnistImage" srclayers: "data"
          mnist_param { norm_a: 255 } }
  layer { name: "label" type: "kLabel" srclayers: "data" }
  layer { name: "fc" type: "kInnerProduct" srclayers: "mnist"
          inner_product_param { num_output: 64 }
          param { name: "weight" init_method: kUniform low: -0.1 high: 0.1 }
          param { name: "bias" init_method: kUniform low: 0.1 high: 0.2 } }
  layer { name: "drop1" type: "kDropout" srclayers: "fc"
          dropout_param { dropout_ratio: 0.4 } }
  layer { name: "drop2" type: "kDropout" srclayers: "fc"
          dropout_param { dropout_ratio: 0.4 } }
  layer { name: "sum" type: "kConcate" srclayers: "drop1"
          srclayers: "drop2" concate_param { concate_dimension: 1 } }
  layer { name: "loss" type: "kSoftmaxLoss" srclayers: "sum"
          srclayers: "label" }
'''


def test_dropout_layer_with_an_injected_draw_matches_jax(shards,
                                                         monkeypatch):
    u = np.random.RandomState(0).rand(4, 64).astype(np.float32)
    j_uniform, t_rand = jax.random.uniform, torch.rand
    # the masks' draws (4, 64) only; the JAX init draws through too
    monkeypatch.setattr(
        jax.random, "uniform", lambda key, shape, *a, **kw:
        jnp.asarray(u) if tuple(shape) == u.shape and not a and not kw
        else j_uniform(key, shape, *a, **kw))
    monkeypatch.setattr(
        torch, "rand", lambda shape, **kw:
        torch.from_numpy(u) if tuple(shape) == u.shape
        else t_rand(shape, **kw))
    jacts, tacts, _ = both_acts(
        net_text(shards["mnist"], DROPOUT), training=True,
        generator=torch.Generator().manual_seed(0))
    assert_acts(jacts, tacts, ["drop1", "drop2", "loss"])
    # eval: identity in both
    jacts, tacts, _ = both_acts(net_text(shards["mnist"], DROPOUT))
    assert torch.equal(tacts["drop1"], tacts["fc"])
    assert_acts(jacts, tacts, ["drop1", "loss"])


def test_layer_generators_are_seeded_and_independent(shards):
    """Net.forward derives each layer's generator from the step's and
    the layer's index: the same step generator gives the same masks,
    the two dropout layers draw different ones, and another step
    generator draws others."""
    net = t_build_net(t_parse(net_text(shards["mnist"], DROPOUT)))
    from singa_tpu_torch.params import init_params

    params = init_params(torch.Generator().manual_seed(0), net.param_specs())
    dl = net.datalayers[0]
    batch = {"data": {"image": torch.from_numpy(dl.images[:4]),
                      "label": torch.from_numpy(dl.labels[:4])}}

    def masks(seed):
        acts = net.forward(params, batch, training=True, return_acts=True,
                           generator=torch.Generator().manual_seed(seed))[2]
        return acts["drop1"] == 0, acts["drop2"] == 0

    a1, a2 = masks(1)
    b1, b2 = masks(1)
    c1, _ = masks(2)
    assert torch.equal(a1, b1) and torch.equal(a2, b2)
    assert not torch.equal(a1, a2)
    assert not torch.equal(a1, c1)
    with pytest.raises(ValueError, match="generator"):
        net.forward(params, batch, training=True)


def test_trainer_steps_draw_per_seed_and_step(shards):
    """The Trainer hands each step its own generator from (seed, step):
    two Trainers of one seed give equal losses, another seed others, and
    the masks of two steps differ."""
    text = net_text(shards["mnist"], DROPOUT) + '''
updater { type: kSGD base_learning_rate: 0.1 }'''

    def losses(seed):
        tr = Trainer(t_parse(text), seed=seed, log=lambda s: None,
                     device="cpu")
        out = []
        for s in range(3):
            tr.train_one_batch(s)
            out.append(tr.perf.avg()["loss"]["loss"])
            tr.perf.reset()
        return out, tr

    a, tr = losses(0)
    b, _ = losses(0)
    c, _ = losses(1)
    assert a == b and a != c
    g = [torch.rand(8, generator=fold_in(fold_in(tr._step_gen, s), 0))
         for s in (0, 1)]
    assert not torch.equal(*g)


# ---------------------------------------------------------------------------
# the loader's image sources
# ---------------------------------------------------------------------------


def test_idx_and_cifar_readers_match_jax(tmp_path):
    rs = np.random.RandomState(0)
    imgs = rs.randint(0, 256, (5, 28, 28)).astype(np.uint8)
    labels = rs.randint(0, 10, 5).astype(np.uint8)
    (tmp_path / "img").write_bytes(
        np.array([2051, 5, 28, 28], ">u4").tobytes() + imgs.tobytes())
    (tmp_path / "lab").write_bytes(
        np.array([2049, 5], ">u4").tobytes() + labels.tobytes())
    for mod in (t_loader, j_loader):
        np.testing.assert_array_equal(
            mod.read_idx_images(str(tmp_path / "img")), imgs)
        np.testing.assert_array_equal(
            mod.read_idx_labels(str(tmp_path / "lab")), labels)
    (tmp_path / "bad").write_bytes(
        np.array([2049, 5, 28, 28], ">u4").tobytes() + imgs.tobytes())
    with pytest.raises(ValueError, match="magic"):
        t_loader.read_idx_images(str(tmp_path / "bad"))
    rows = rs.randint(0, 256, (3, 3073)).astype(np.uint8)
    rows.tofile(tmp_path / "b.bin")
    got = t_loader.read_cifar_bins([str(tmp_path / "b.bin")])
    want = j_loader.read_cifar_bins([str(tmp_path / "b.bin")])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("args", [
    ["synthetic", "--n", "20", "--channels", "3", "--size", "32"],
    ["synthetic", "--n", "12", "--seed", "4"],
])
def test_loader_cli_writes_the_jax_loaders_shards(tmp_path, args):
    """The same subcommand in both packages writes the same bytes; the
    mean file too."""
    a, b = tmp_path / "a", tmp_path / "b"
    assert t_loader.main([*args, "--output", str(a)]) == 0
    assert j_loader.main([*args, "--output", str(b)]) == 0
    assert (a / "shard.dat").read_bytes() == (b / "shard.dat").read_bytes()
    t_loader.main(["compute-mean", "--input", str(a), "--output",
                   str(tmp_path / "ma.npy")])
    j_loader.main(["compute-mean", "--input", str(b), "--output",
                   str(tmp_path / "mb.npy")])
    np.testing.assert_array_equal(np.load(tmp_path / "ma.npy"),
                                  np.load(tmp_path / "mb.npy"))


def test_loader_mnist_subcommand_roundtrips(tmp_path):
    rs = np.random.RandomState(1)
    imgs = rs.randint(0, 256, (6, 28, 28)).astype(np.uint8)
    labels = rs.randint(0, 10, 6).astype(np.uint8)
    (tmp_path / "img").write_bytes(
        np.array([2051, 6, 28, 28], ">u4").tobytes() + imgs.tobytes())
    (tmp_path / "lab").write_bytes(
        np.array([2049, 6], ">u4").tobytes() + labels.tobytes())
    out = tmp_path / "shard"
    assert t_loader.main(["mnist", "--image-file", str(tmp_path / "img"),
                          "--label-file", str(tmp_path / "lab"),
                          "--output", str(out)]) == 0
    from singa_tpu_torch.data.pipeline import load_shard_arrays

    got, got_labels = load_shard_arrays(str(out))
    np.testing.assert_array_equal(got, imgs.astype(np.float32))
    np.testing.assert_array_equal(got_labels, labels)
    with pytest.raises(SystemExit):
        t_loader.main(["digits", "--output", str(tmp_path / "d")])
