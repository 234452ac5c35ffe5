"""LMDB in the port (singa_tpu_torch/data/lmdbio.py, the native walker
native/lmdbcodec.cc, the loader's split and LMDB interop, kLMDBData)
against the JAX package's, on data made with numpy from a seed.

Bars: databases, shards and split outputs byte-identical to the JAX
package's; each package reads the other's database; the native walker,
the Python reader and the JAX loader decode to equal arrays; a
truncated Datum raises in both port codecs; kLMDBData in a narrowed
examples/mnist/mlp.conf gives the port's kShardData losses to the bit
and the JAX Trainer's within 1e-4 over 5 steps.
"""

import os
import pathlib

import jax
import numpy as np
import pytest

from singa_tpu.config import load_model_config as j_load
from singa_tpu.data import lmdbio as j_lmdbio
from singa_tpu.data import loader as j_loader
from singa_tpu.data import pipeline as j_pipeline
from singa_tpu.parallel import build_mesh
from singa_tpu.trainer import Trainer as JTrainer
from singa_tpu_torch import native
from singa_tpu_torch.config import load_model_config as t_load
from singa_tpu_torch.data import lmdbio as t_lmdbio
from singa_tpu_torch.data import loader as t_loader
from singa_tpu_torch.data import pipeline as t_pipeline
from singa_tpu_torch.data.records import Datum, encode_datum
from singa_tpu_torch.data.shard import shard_path
from singa_tpu_torch.graph.builder import build_net as t_build_net
from singa_tpu_torch.trainer import Trainer, params_from_numpy

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def lib():
    """The LMDB codec, built here if needed (g++ is in this image)."""
    return native.get_lmdb_lib()


def datums(kind, n, seed=0):
    """(key, Datum bytes) pairs: MNIST-shaped uint8 (many leaves and
    branch pages), CIFAR-shaped uint8 (values on overflow pages) or
    float_data."""
    rs = np.random.RandomState(seed)
    c, h, w = {"mnist": (1, 28, 28), "cifar": (3, 32, 32),
               "float": (2, 3, 4)}[kind]
    out = []
    for i in range(n):
        label = int(rs.randint(10))
        if kind == "float":
            d = Datum(channels=c, height=h, width=w, label=label,
                      float_data=list(map(float, rs.randn(c * h * w)
                                          .astype(np.float32))))
        else:
            d = Datum(channels=c, height=h, width=w, label=label,
                      data=rs.randint(0, 256, c * h * w).astype(
                          np.uint8).tobytes())
        out.append((f"{i:08d}".encode(), encode_datum(d)))
    return out


KINDS = {"mnist": 400, "cifar": 30, "float": 50}


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """One database per kind, written by each package."""
    root = tmp_path_factory.mktemp("lmdb")
    out = {}
    for kind, n in KINDS.items():
        items = datums(kind, n)
        t_path, j_path = str(root / f"t_{kind}"), str(root / f"j_{kind}")
        assert t_lmdbio.write_lmdb(t_path, items) == n
        assert j_lmdbio.write_lmdb(j_path, items) == n
        out[kind] = (t_path, j_path, items)
    return out


def data_bytes(path):
    with open(os.path.join(path, "data.mdb"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_write_lmdb_is_byte_identical_to_jax(dbs, kind):
    t_path, j_path, _ = dbs[kind]
    assert data_bytes(t_path) == data_bytes(j_path)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_each_package_reads_the_others_database(dbs, kind):
    t_path, j_path, items = dbs[kind]
    with t_lmdbio.LMDBReader(j_path) as r:
        assert list(r) == items
    with j_lmdbio.LMDBReader(t_path) as r:
        assert list(r) == items


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_native_walker_equals_the_python_reader_and_jax(lib, dbs, kind):
    t_path, _, _ = dbs[kind]
    before = t_pipeline.served["lmdb/native"]
    got = t_pipeline.load_lmdb_arrays(t_path)
    assert t_pipeline.served["lmdb/native"] == before + 1
    py = t_pipeline.python_lmdb_arrays(t_path)
    ref = j_pipeline.load_lmdb_arrays(t_path)
    for a, b, c in zip(got, py, ref):
        assert a.dtype == b.dtype == c.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert got[0].shape[0] == KINDS[kind] and got[0].ndim == 4


def test_truncated_datum_raises_in_both_codecs(lib, tmp_path):
    items = datums("mnist", 3)
    items[1] = (items[1][0], items[1][1][:-5])
    path = str(tmp_path / "bad")
    t_lmdbio.write_lmdb(path, items)
    for load in (t_pipeline.load_lmdb_arrays, t_pipeline.python_lmdb_arrays):
        with pytest.raises(ValueError):
            load(path)


def test_mixed_geometry_goes_to_the_python_reader(lib, tmp_path):
    items = datums("mnist", 2) + [
        (b"00000009", encode_datum(Datum(channels=1, height=2, width=2,
                                         data=bytes(4))))]
    path = str(tmp_path / "mixed")
    t_lmdbio.write_lmdb(path, items)
    assert native.load_lmdb_dataset(t_lmdbio.lmdb_data_path(path)) is None
    with pytest.raises(ValueError, match="mixed geometry"):
        t_pipeline.load_lmdb_arrays(path)


# ---------------------------------------------------------------------------
# the loader's split and LMDB interop
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("interop") / "mnist")
    t_loader.write_records(path, *t_loader.synthetic_arrays(64, seed=5))
    return path


def shard_bytes(folder):
    with open(shard_path(folder), "rb") as f:
        return f.read()


@pytest.mark.parametrize("mode,n", [("equal", 3), ("head", 10)])
def test_split_is_byte_identical_to_jax(shard, tmp_path, mode, n):
    t_loader.main(["split", "--input", shard, "--prefix",
                   str(tmp_path / "t"), "--n", str(n), "--mode", mode])
    j_loader.split_shard(shard, str(tmp_path / "j"), n, mode)
    parts = n if mode == "equal" else 2
    for i in range(parts):
        assert shard_bytes(str(tmp_path / f"t-{i}")) == \
            shard_bytes(str(tmp_path / f"j-{i}")), i
    assert not (tmp_path / f"t-{parts}").exists()


def test_split_refuses_too_many_parts(shard, tmp_path):
    with pytest.raises(ValueError):
        t_loader.split_shard(shard, str(tmp_path / "t"), 64, "equal")
    with pytest.raises(ValueError):
        t_loader.split_shard(shard, str(tmp_path / "t"), 64, "head")


def test_shard2lmdb_and_back_are_byte_identical_to_jax(lib, shard,
                                                      tmp_path):
    t_loader.main(["shard2lmdb", "--input", shard, "--output",
                   str(tmp_path / "tl")])
    j_loader.shard_to_lmdb(shard, str(tmp_path / "jl"))
    assert data_bytes(str(tmp_path / "tl")) == \
        data_bytes(str(tmp_path / "jl"))
    t_loader.main(["lmdb2shard", "--input", str(tmp_path / "tl"),
                   "--output", str(tmp_path / "ts")])
    j_loader.lmdb_to_shard(str(tmp_path / "jl"), str(tmp_path / "js"))
    assert shard_bytes(str(tmp_path / "ts")) == \
        shard_bytes(str(tmp_path / "js"))
    # the round trip keeps every record: C=1 images, the same pixels
    images, labels = t_pipeline.load_shard_arrays(shard)
    back, back_labels = t_pipeline.load_shard_arrays(str(tmp_path / "ts"))
    np.testing.assert_array_equal(back[:, 0], images)
    np.testing.assert_array_equal(back_labels, labels)
    lm, lm_labels = t_pipeline.load_lmdb_arrays(str(tmp_path / "tl"))
    np.testing.assert_array_equal(lm, back)
    np.testing.assert_array_equal(lm_labels, labels)


# ---------------------------------------------------------------------------
# kLMDBData
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mnist_sources(tmp_path_factory, shard):
    root = tmp_path_factory.mktemp("klmdb")
    db = str(root / "db")
    t_loader.shard_to_lmdb(shard, db)
    return {"kShardData": shard, "kLMDBData": db}


def narrow(cfg, dtype, path):
    """examples/mnist/mlp.conf with its data layers of type ``dtype``
    on ``path``, batch 16, hidden widths / 10."""
    cfg.checkpoint = None
    for layer in cfg.neuralnet.layer:
        if layer.type == "kShardData":
            layer.type = dtype
            layer.data_param.path = path
            layer.data_param.batchsize = 16
            layer.data_param.random_skip = 0
        ip = layer.inner_product_param
        if ip is not None and ip.num_output != 10:
            ip.num_output = max(8, ip.num_output // 10)
    return cfg


def step_loss(tr, step):
    tr.train_one_batch(step)
    loss = tr.perf.avg()["loss"]["loss"]
    tr.perf.reset()
    return loss


def test_klmdbdata_builds_with_c1_records(lib, mnist_sources):
    conf = str(REPO / "examples" / "mnist" / "mlp.conf")
    net = t_build_net(narrow(t_load(conf), "kLMDBData",
                             mnist_sources["kLMDBData"]))
    data = net.datalayers[0]
    assert data.TYPE == "kLMDBData" and data.sample_shape == (1, 28, 28)
    assert net.name2layer["mnist"].out_shape == (16, 28, 28)


def test_klmdbdata_trains_like_kshard_and_the_jax_trainer(lib,
                                                          mnist_sources):
    """5 steps from the JAX init's params: the port's kLMDBData losses
    equal its kShardData losses to the bit (the same pixels, the C=1
    dim squeezed by kMnistImage), and the JAX Trainer's (kLMDBData)
    within 1e-4."""
    conf = str(REPO / "examples" / "mnist" / "mlp.conf")
    path = mnist_sources["kLMDBData"]
    jt = JTrainer(narrow(j_load(conf), "kLMDBData", path),
                  mesh=build_mesh(1, 1, jax.devices()[:1]), seed=0,
                  log=lambda s: None, prefetch=False)
    init = {n: np.asarray(v) for n, v in jt.params.items()}
    ports = {}
    for dtype, src in mnist_sources.items():
        tt = Trainer(narrow(t_load(conf), dtype, src), seed=0,
                     log=lambda s: None, device="cpu")
        tt.params = params_from_numpy(tt.train_net, init)
        ports[dtype] = [step_loss(tt, s) for s in range(5)]
    want = [step_loss(jt, s) for s in range(5)]
    assert ports["kLMDBData"] == ports["kShardData"]
    for j, t in zip(want, ports["kLMDBData"]):
        assert abs(j - t) <= 1e-4, (want, ports)
    assert np.isfinite(want).all()
