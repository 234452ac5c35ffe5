"""Saves on a data x model mesh across both packages, bitwise.

- The Trainer's sharded format with kLayerPartition and zero_update
  (the JAX package's tests/test_sharded_ckpt.py and tests/test_reshard.py
  on a model axis): a JAX 2 x 4 save (its padded storage: fc2's 10
  outputs stored as 12) restored by the port on 2 x 4, 4 x 2, 8 x 1 and
  1 x 1, and a port 2 x 4 save (each model piece a box cut to the
  logical shape, zero's data chunks inside the pieces) restored by the
  JAX Trainer on the same meshes: every param and slot the saved one.
- The replica engine's saves on 4 replicas x 2 model ranks, npz (the
  logical shapes) and sharded (the stored ones, as the JAX replica
  engine's resume demands), with the ``.server`` sidecar at the logical
  shapes: a port save resumed by the JAX ReplicaTrainer and a JAX save
  resumed by the port, every replica, slot, the center and the
  snapshots the saved ones.
"""

import warnings

import jax
import numpy as np
import pytest

from singa_tpu.config import parse_cluster_config as j_cluster
from singa_tpu.config import parse_model_config as j_parse
from singa_tpu.parallel import build_mesh as j_mesh
from singa_tpu.trainer import ReplicaTrainer as JReplica
from singa_tpu.trainer import Trainer as JTrainer
from singa_tpu_torch.config import parse_cluster_config as t_cluster
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.parallel import build_mesh
from singa_tpu_torch.trainer import ReplicaTrainer, Trainer
from singa_tpu_torch.trainer import sharded_ckpt as t_sc
from test_torch_launch import one_torch_thread  # noqa: F401
from test_torch_model_axis import img, replica_text, zero_text  # noqa: F401
from test_torch_replica import shards  # noqa: F401


def jax_trainer(text, ndata, nmodel, ckpt=None, workspace=None):
    cfg = j_parse(text)
    if ckpt:
        cfg.checkpoint = ckpt
    return JTrainer(cfg, j_cluster(f'workspace: "{workspace}"')
                    if workspace else None,
                    mesh=j_mesh(ndata, nmodel, jax.devices()[:ndata * nmodel]),
                    seed=3, log=lambda s: None, prefetch=False)


def port_trainer(text, ndata, nmodel, ckpt=None, workspace=None):
    cfg = t_parse(text)
    if ckpt:
        cfg.checkpoint = ckpt
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return Trainer(cfg, t_cluster(f'workspace: "{workspace}"')
                       if workspace else None,
                       mesh=build_mesh(ndata, nmodel,
                                       ["cpu"] * (ndata * nmodel)),
                       seed=3, log=lambda s: None)


def logical_arrays(tr) -> dict:
    """A trainer's params and whole slots at their logical shapes, by
    checkpoint key, on the host."""
    out = {f"p|{n}": np.asarray(tr._unpad_one(n, v))
           for n, v in tr.params.items()}
    out.update({f"s|{n}|{s}": np.asarray(tr._unpad_one(n, v))
                for n, slots in tr.state.items() for s, v in slots.items()})
    return out


@pytest.fixture(scope="module")
def saves(img, tmp_path_factory):
    """A JAX and a port sharded save of the 2 x 4 zero trainer after 2
    steps (fc2's 10 outputs pad to 12 over 4 model ranks) -> {package:
    (path, its logical arrays)}."""
    text = zero_text(img, True, "sharded")
    out = {}
    for pkg, make in (("jax", jax_trainer), ("port", port_trainer)):
        ws = tmp_path_factory.mktemp(f"tp_{pkg}")
        tr = make(text, 2, 4, workspace=ws)
        for s in range(2):
            tr.train_one_batch(s)
        out[pkg] = (tr.save(2), logical_arrays(tr))
    return text, out


@pytest.mark.parametrize("mesh", [(2, 4), (4, 2), (8, 1), (1, 1)])
@pytest.mark.parametrize("saver", ["jax", "port"])
def test_sharded_saves_cross_packages_on_any_mesh(saves, saver, mesh):
    text, out = saves
    path, want = out[saver]
    make = port_trainer if saver == "jax" else jax_trainer
    back = make(text, *mesh, ckpt=path)
    got = logical_arrays(back)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if saver == "port" and mesh == (2, 4):
        with t_sc.ShardedCheckpoint(path) as ck:
            info = ck.manifest["arrays"]
            assert info["p|fc2/weight"] == {
                "shape": [32, 10], "dtype": "float32",
                "spec": [None, "model"]}
            assert info["s|fc1/weight|history"]["spec"] == ["data", "model"]
            boxes = sorted(box.tolist() for _, _, box in ck.pieces(
                "p|fc2/weight"))
        # the last model piece's padded tail is cut off at the save
        assert boxes == [[[0, 32], [0, 3]], [[0, 32], [3, 6]],
                         [[0, 32], [6, 9]], [[0, 32], [9, 10]]]


def replica_trainer(pkg, text, fmt, workspace=None, ckpt=None):
    """A 4 x 2 replica engine of either package under RandomSync
    (snapshots in the sidecar; the bootstrap's SyncConfig sets the ratio
    where a cluster is given), saving every 5 steps in ``fmt``."""
    text = text.replace("checkpoint_frequency: 0",
                        "checkpoint_frequency: 5")
    text += f'checkpoint_format: "{fmt}"\n'
    if ckpt:
        text += f'checkpoint: "{ckpt}"\n'
    cluster = f'workspace: "{workspace}"' if workspace else None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if pkg == "jax":
            tr = JReplica(j_parse(text), cluster and j_cluster(cluster),
                          mesh=j_mesh(4, 2, jax.devices()[:8]), seed=0,
                          log=lambda s: None, prefetch=False)
        else:
            tr = ReplicaTrainer(t_parse(text), cluster and t_cluster(cluster),
                                mesh=build_mesh(4, 2, ["cpu"] * 8), seed=0,
                                log=lambda s: None)
    return tr


def replica_arrays(tr) -> dict:
    """Every replica's params and slots, the center and the snapshots at
    their logical shapes, on the host."""
    # both packages' _unpad_one cut the trailing dims: a stacked array's
    # leading replica axis stays
    out = {f"p|{n}": np.asarray(tr._unpad_one(n, v))
           for n, v in tr.params.items()}
    out.update({f"s|{n}|{s}": np.asarray(tr._unpad_one(n, v))
                for n, slots in tr.state.items() for s, v in slots.items()})
    out.update({f"c|{n}": np.asarray(tr._unpad_one(n, v))
                for n, v in tr.center.items()})
    out.update({f"r|{n}": np.asarray(tr._unpad_one(n, v))
                for n, v in (tr.snapshot or {}).items()})
    return out


@pytest.mark.parametrize("fmt", ["npz", "sharded"])
@pytest.mark.parametrize("saver", ["jax", "port"])
def test_replica_saves_cross_packages_on_a_model_axis(shards, tmp_path,
                                                      saver, fmt):
    """fc1's 63 outputs pad to 64 over the 2 model ranks; the save at
    step 5 (after the bootstrap at 4) resumed by the other package holds
    the saver's replicas, slots, center, ratio and snapshots."""
    text = replica_text(shards, "RandomSync", out1=63)
    ta = replica_trainer(saver, text, fmt, workspace=tmp_path / "a")
    ta.cfg.train_steps = 5
    ta.run()
    ext = "npz" if fmt == "npz" else "ckpt"
    path = str(tmp_path / "a" / "checkpoints" / f"step_5.{ext}")
    other = "port" if saver == "jax" else "jax"
    tb = replica_trainer(other, text, fmt, ckpt=path)
    assert tb.start_step == 5
    assert np.float32(tb.sample_ratio) == np.float32(ta.sample_ratio)
    want, got = replica_arrays(ta), replica_arrays(tb)
    assert got.keys() == want.keys() and "r|fc1/weight" in got
    assert got["p|fc1/weight"].shape == (4, 784, 63)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("engine,case", [
    ("trainer", "wider"), ("trainer", "tail"), ("replica_npz", "wider"),
    ("replica_sharded", "wider"), ("replica_sharded", "tail")])
def test_a_wider_models_save_is_refused(img, shards, tmp_path, engine,
                                        case):
    """A save is restored at the model's own widths or from the padded
    storage of an uneven split of them, and nothing else: a wider
    layer's save (fc1 twice as wide) raises, and so does a save whose
    extra column has the padded length but is not a zero tail (fc2 12
    wide into 11 over 2 model ranks, the replicas' fc1 64 into 63)."""
    if engine == "trainer":
        text = zero_text(img, False, "sharded")
        widths = (("num_output: 32", "num_output: 64") if case == "wider"
                  else ("num_output: 10", "num_output: 12"))
        target = (text if case == "wider"
                  else text.replace("num_output: 10", "num_output: 11"))
        path = port_trainer(text.replace(*widths), 2, 2,
                            workspace=tmp_path).save(0)
        with pytest.raises(ValueError, match="checkpoint .* shape"):
            port_trainer(target, 2, 2, ckpt=path)
        return
    fmt = engine.split("_")[1]
    out1 = 128 if case == "wider" else 64
    path = replica_trainer("port", replica_text(shards, "Elastic",
                                                out1=out1), fmt,
                           workspace=tmp_path).save(0)
    with pytest.raises(ValueError, match="checkpoint .* shape"):
        replica_trainer("port", replica_text(
            shards, "Elastic", out1=64 if case == "wider" else 63), fmt,
            ckpt=path)
