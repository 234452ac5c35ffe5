"""The port's native shard codec (singa_tpu_torch/native/shardcodec.cc
and native/__init__.py) against the port's Python codec and the JAX
package's loaders, on shards made with numpy from a seed.

Bars: decoded arrays equal (values, shapes and dtypes); written files
byte-identical; malformed records raise ``ValueError`` in both port
codecs (the JAX package's library accepts one of them, so it is no
oracle there); a failed build raises; two processes building the
library into one empty directory at once both load it (the atomic
build). The library builds with g++ inside the fixtures and tests that
need it, never at import.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from singa_tpu.data import loader as j_loader
from singa_tpu.data import pipeline as j_pipeline
from singa_tpu_torch import native
from singa_tpu_torch.data import loader as t_loader
from singa_tpu_torch.data import pipeline as t_pipeline
from singa_tpu_torch.data.records import ImageRecord, encode_record
from singa_tpu_torch.data.shard import ShardError, ShardWriter, shard_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lib():
    """The shard codec, built here if needed (g++ is in this image)."""
    return native.get_lib()


def shard_of(folder, records):
    """Write (key, ImageRecord or raw bytes) pairs with the Python
    writer -> folder."""
    with ShardWriter(folder) as w:
        for key, rec in records:
            w.insert(key, rec if isinstance(rec, bytes)
                     else encode_record(rec))
        w.flush()
    return folder


SOURCES = {
    "mnist": lambda: t_loader.synthetic_arrays(300, seed=1),
    "cifar": lambda: t_loader.synthetic_arrays(40, size=32, channels=3),
    "tokens": lambda: t_loader.synthetic_token_arrays(20, seq_len=64,
                                                      vocab=256),
}


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_native_decode_equals_python_and_jax(lib, tmp_path, source):
    images, labels = SOURCES[source]()
    folder = str(tmp_path / "s")
    t_loader.write_records(folder, images, labels)
    served = dict(t_pipeline.served)
    got = t_pipeline.load_shard_arrays(folder)
    assert t_pipeline.served["shard/native"] == served.get(
        "shard/native", 0) + 1
    py = t_pipeline.python_shard_arrays(folder)
    ref = j_pipeline.load_shard_arrays(folder)
    for a, b, c in zip(got, py, ref):
        assert a.dtype == b.dtype == c.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert got[0].shape == (len(images), *images.shape[1:])
    np.testing.assert_array_equal(got[0], images.astype(np.float32))


def test_float_and_shapeless_records_decode_alike(lib, tmp_path):
    """float ``data`` payloads, and records without a shape (flat, as the
    Python codec's reshape(-1))."""
    rs = np.random.RandomState(2)
    vals = rs.randn(5, 6).astype(np.float32)
    for name, shape in (("f", [2, 3]), ("flat", [])):
        folder = shard_of(str(tmp_path / name), [
            (f"{i:08d}", ImageRecord(shape=shape, label=i,
                                     data=list(map(float, v))))
            for i, v in enumerate(vals)])
        got = t_pipeline.load_shard_arrays(folder)
        want = t_pipeline.python_shard_arrays(folder)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert got[0].shape == (5, *(shape or [6]))


@pytest.mark.parametrize("append", [False, True])
def test_write_records_is_byte_identical_to_jax(lib, tmp_path, append):
    """A fresh shard goes through the native encoder, an append through
    the Python writer: both write the JAX package's bytes."""
    images, labels = t_loader.synthetic_arrays(50, seed=3)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    n = 30 if append else 50
    assert t_loader.write_records(a, images[:n], labels[:n]) == n
    assert j_loader.write_records(b, images[:n], labels[:n]) == n
    if append:
        assert t_loader.write_records(a, images, labels) == 20
        assert j_loader.write_records(b, images, labels) == 20
    with open(shard_path(a), "rb") as fa, open(shard_path(b), "rb") as fb:
        assert fa.read() == fb.read()


def test_native_writer_equals_the_python_writer(lib, tmp_path):
    images, labels = t_loader.synthetic_arrays(20, size=32, channels=3)
    path = str(tmp_path / "n.dat")
    assert native.write_records(path, images, labels) == 20
    folder = shard_of(str(tmp_path / "p"), [
        (f"{i:08d}", ImageRecord(shape=list(img.shape), label=int(lab),
                                 pixel=img.tobytes()))
        for i, (img, lab) in enumerate(zip(images, labels))])
    with open(path, "rb") as f1, open(shard_path(folder), "rb") as f2:
        assert f1.read() == f2.read()


def _image_bytes(payload: bytes) -> bytes:
    """Record{type 0, image = payload} on the wire."""
    return bytes([0x08, 0x00, 0x12, len(payload)]) + payload


def malformed_records():
    good = encode_record(ImageRecord(shape=[2, 2], label=1,
                                     pixel=bytes(range(4))))
    # packed shape field of 2 bytes whose last varint (0x82) carries on
    # past the field's end and swallows the 0x00 after it: the JAX
    # package's library reads shape [2, 2] and accepts the record
    packed = _image_bytes(bytes([0x0A, 0x02, 0x02, 0x82, 0x00, 0x10, 0x01,
                                 0x1A, 0x04, 1, 2, 3, 4]))
    truncated = good[:-2]  # the pixel field declares 4 bytes, 2 remain
    return {"packed_crosses_field_end": packed, "truncated": truncated}, good


@pytest.mark.parametrize("case", ["packed_crosses_field_end", "truncated"])
@pytest.mark.parametrize("position", ["first", "later"])
def test_malformed_records_raise_in_both_codecs(lib, tmp_path, case,
                                                position):
    bad, good = malformed_records()
    recs = [bad[case], good] if position == "first" else [good, bad[case]]
    folder = shard_of(str(tmp_path / "m"),
                      [(f"{i:08d}", r) for i, r in enumerate(recs)])
    with pytest.raises(ValueError, match="malformed"):
        native.load_dataset(shard_path(folder))
    for load in (t_pipeline.load_shard_arrays,
                 t_pipeline.python_shard_arrays):
        with pytest.raises(ValueError):
            load(folder)


def test_mixed_geometry_goes_to_the_python_codec(lib, tmp_path):
    """Records of another shape (same payload size, or another) are the
    one case the native codec hands on: None, and the Python codec
    raises its error."""
    for i, shapes in enumerate(([[4, 4], [2, 8]], [[2, 2], [3, 3]])):
        folder = shard_of(str(tmp_path / f"mix{i}"), [
            (f"{j:08d}", ImageRecord(shape=s, label=0,
                                     pixel=bytes(int(np.prod(s)))))
            for j, s in enumerate(shapes)])
        assert native.load_dataset(shard_path(folder)) is None
        with pytest.raises(ValueError):
            t_pipeline.load_shard_arrays(folder)


def test_missing_and_empty_shards(lib, tmp_path):
    with pytest.raises(ShardError):
        t_pipeline.load_shard_arrays(str(tmp_path / "nowhere"))
    empty = shard_of(str(tmp_path / "empty"), [])
    with pytest.raises(ValueError, match="no records"):
        t_pipeline.load_shard_arrays(empty)
    with pytest.raises(FileNotFoundError):
        native.load_dataset(str(tmp_path / "nowhere" / "shard.dat"))


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                        monkeypatch):
    """No quiet fallback: a source that does not compile raises, and
    nothing is left in the build directory."""
    src = tmp_path / "src"
    src.mkdir()
    shutil.copy(os.path.join(os.path.dirname(native.__file__),
                             "shardcodec.cc"), src / "shardcodec.cc")
    with open(src / "shardcodec.cc", "a") as f:
        f.write("\nthis is not C++;\n")
    monkeypatch.setattr(native, "_DIR", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.get_lib.__wrapped__()
    assert os.listdir(tmp_path / "build") == []


CHILD = """
import sys
sys.path.insert(0, sys.argv[1])
from singa_tpu_torch import native
native.BUILD_DIR = sys.argv[2]
native.get_lib()
native.get_lmdb_lib()
print(len(native.load_dataset(sys.argv[3])[1]))
"""


def test_two_processes_build_into_one_clean_directory(lib, tmp_path):
    """Both load the library they raced to build; no temporary file is
    left, and exactly one library per source is there."""
    images, labels = t_loader.synthetic_arrays(10)
    folder = str(tmp_path / "s")
    t_loader.write_records(folder, images, labels)
    build = str(tmp_path / "build")
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, REPO, build, shard_path(folder)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "10"
    built = sorted(os.listdir(build))
    assert len(built) == 2 and all(f.endswith(".so") for f in built), built
    assert built[0].startswith("liblmdbcodec-")
    assert built[1].startswith("libshardcodec-")


def test_libraries_build_under_the_port_only(lib):
    """The build directory is singa_tpu_torch/_build, named by hash."""
    path = native.lib_path("shardcodec")
    assert os.path.dirname(path) == os.path.join(REPO, "singa_tpu_torch",
                                                 "_build")
    assert os.path.exists(path)
