"""ResNet in the port against the JAX package: ``models/resnet.py``'s
conf text, and the generated confs training through both Trainers at
float32 (``resnet_conf(compute_dtype="float32")``, 4 classes) over
ImageNet-shaped synthetic records (``imagenet_shaped_arrays``).

The Trainer comparison takes each of 3 steps from the JAX Trainer's
state (params, updater slots and running stats copied into the port
first): free-running, the conf's learning rate of 0.1 at batch 8 takes
the depth-18 loss from 1.39 to 4.91 in 3 steps, and the two packages'
float32 rounding (XLA on the CPU sums BatchNorm's one-pass moments
sequentially, the port pairwise) grows 20x a step, to 3e-4 at step 2.
Depth 50 runs at size 64: at size 32 its last stage is 1 x 1, its
BatchNorms normalize over the 4 values of the batch, and the two
packages' step-0 losses already differ by 1e-3 relative (measured).
Both kRGBImage parsers take the centre crop and no mirror (their
generators differ).
"""

import jax
import numpy as np
import pytest
import torch

from singa_tpu.config import parse_model_config as j_parse
from singa_tpu.layers import data as j_data
from singa_tpu.models.resnet import resnet_conf as j_resnet_conf
from singa_tpu.parallel import build_mesh
from singa_tpu.trainer import Trainer as JTrainer
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.data import loader as t_loader
from singa_tpu_torch.layers import data as t_data
from singa_tpu_torch.models import resnet as t_resnet
from singa_tpu_torch.trainer import Trainer, params_from_numpy


@pytest.mark.parametrize("kw", [
    dict(depth=18),
    dict(depth=34, classes=10, batchsize=32, size=64),
    dict(depth=50),
    dict(depth=50, train_shard="a", test_shard="b", train_steps=7,
         meanfile="m.npy", compute_dtype="float32"),
])
def test_resnet_conf_text_equals_jax(kw):
    assert t_resnet.resnet_conf(**kw) == j_resnet_conf(**kw)


def test_resnet_cli_writes_the_example_conf(tmp_path, capsys):
    out = tmp_path / "r50.conf"
    assert t_resnet.main(["--depth", "50", "--output", str(out)]) == 0
    example = (t_resnet.__file__.rsplit("singa_tpu_torch", 1)[0]
               + "examples/imagenet/resnet50.conf")
    assert out.read_text() == open(example).read()
    with pytest.raises(ValueError, match="depth must be one of"):
        t_resnet.resnet_conf(depth=20)


@pytest.fixture
def rgb_eval_crop(monkeypatch):
    jorig, torig = j_data.RGBImageLayer.apply, t_data.RGBImageLayer.apply
    monkeypatch.setattr(
        j_data.RGBImageLayer, "apply",
        lambda self, p, i, *, training, rng=None: jorig(
            self, p, i, training=training, rng=None))
    monkeypatch.setattr(
        t_data.RGBImageLayer, "apply",
        lambda self, p, i, *, training, generator=None: torig(
            self, p, i, training=training, generator=None))


def np_tree(tree):
    return {n: np.array(v) for n, v in tree.items()}


def step_loss(tr, step):
    tr.train_one_batch(step)
    loss = tr.perf.avg()["loss"]["loss"]
    tr.perf.reset()
    return loss


@pytest.mark.parametrize("depth,batch,size,stats_tol", [
    (18, 8, 32, 1e-5),
    # 4.3e-4 measured: the stats of depth 50's last stages, normalized
    # over 16 values, carry the float32 rounding of 50 layers
    (50, 4, 64, 1e-3),
])
def test_resnet_steps_match_the_jax_trainer(tmp_path, rgb_eval_crop,
                                            depth, batch, size, stats_tol):
    """3 steps, each from the JAX Trainer's state: losses within 1e-4
    relative, running stats within ``stats_tol`` relative (of max(1,
    |stat|)), the post-step buffers the same set."""
    shard = str(tmp_path / "shard")
    t_loader.write_records(shard, *t_loader.imagenet_shaped_arrays(
        16, classes=4, size=size))
    text = t_resnet.resnet_conf(
        depth, classes=4, batchsize=batch, size=size, train_shard=shard,
        test_shard=shard, train_steps=3, compute_dtype="float32",
    ).replace("random_skip: 5000", "random_skip: 0")
    jt = JTrainer(j_parse(text), mesh=build_mesh(1, 1, jax.devices()[:1]),
                  seed=0, log=lambda s: None, prefetch=False)
    tt = Trainer(t_parse(text), seed=0, log=lambda s: None, device="cpu")
    assert len(tt.buffers) == 2 * sum(
        l.TYPE == "kBatchNorm" for l in tt.train_net.layers)
    for step in range(3):
        tt.params = params_from_numpy(tt.train_net, np_tree(jt.params))
        tt.state = {n: {k: torch.from_numpy(v) for k, v in
                        np_tree(slots).items()}
                    for n, slots in jt.state.items()}
        tt._store_buffers({k: torch.from_numpy(v)
                           for k, v in np_tree(jt.buffers).items()})
        want, got = step_loss(jt, step), step_loss(tt, step)
        assert abs(got - want) <= 1e-4 * abs(want), (step, got, want)
        jb, tb = np_tree(jt.buffers), np_tree(tt.buffers)
        assert set(tb) == set(jb)
        for k in jb:
            np.testing.assert_allclose(
                tb[k] / np.maximum(1, np.abs(jb[k])),
                jb[k] / np.maximum(1, np.abs(jb[k])),
                atol=stats_tol, rtol=0, err_msg=f"step {step} {k}")
