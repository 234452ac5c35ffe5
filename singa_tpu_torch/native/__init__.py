"""Native (C++) shard and LMDB codecs, loaded with ctypes.

The port's copy of ``singa_tpu/native``. The reference keeps its whole
data layer in C++ (src/utils/shard.cc, the protobuf Record codec,
tools/data_loader/); ``shardcodec.cc`` scans shard files, decodes and
encodes proto2 Records and materializes whole datasets without Python
in the per-record loop, and ``lmdbcodec.cc`` walks a Caffe LMDB's
B+tree and decodes its Datums the same way.

Each library builds at first use with g++ into ``singa_tpu_torch/_build/``
(listed in ``.gitignore``), named by a hash of its source like the CUDA
libraries of ``_build.py``, and written to a temporary file that
``os.replace`` moves into place: a process that loads the library while
another builds it sees all of it or none. Nothing is built at import.

Unlike the original, nothing falls back quietly:

- a failed build or ``dlopen`` raises, with the compiler's output;
- a malformed record raises ``ValueError`` (``records.RecordError`` for
  a shard, ``lmdbio.LMDBError`` for a database), as the Python codec
  does;
- ``None`` means one thing: the shard or database holds records of
  mixed geometry, which the native path cannot pack into one array and
  hands to the Python codec (it batches them or raises the descriptive
  error). The C code says so with its own return code (-5).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np

from .._build import BUILD_DIR
from ..data.lmdbio import LMDBError
from ..data.records import RecordError

_DIR = os.path.dirname(os.path.abspath(__file__))
GXX_FLAGS = ["-O2", "-shared", "-fPIC"]

#: the C codes (see shardcodec.cc's header); -5 is the mixed-geometry
#: hand-off, not an error
OPEN_FAILED, EMPTY, MALFORMED, GEOMETRY, MIXED = -1, -2, -3, -4, -5


def lib_path(name: str) -> str:
    """Where the library of ``native/<name>.cc`` goes: its name carries a
    hash of the source, so an edited source never loads a stale one."""
    with open(os.path.join(_DIR, f"{name}.cc"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build(name: str) -> str:
    """Compile ``native/<name>.cc`` unless built -> the library's path.
    Raises ``RuntimeError`` with g++'s output if the build fails."""
    out = lib_path(name)
    if os.path.exists(out):
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(
            f"g++ not found on PATH: the native codec native/{name}.cc "
            "builds with it")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [gxx, *GXX_FLAGS, "-o", tmp, os.path.join(_DIR, f"{name}.cc")],
        capture_output=True, text=True, timeout=300,
    )
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"g++ failed for native/{name}.cc:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


@functools.cache
def get_lib() -> ctypes.CDLL:
    """The shard codec (built here if needed)."""
    lib = ctypes.CDLL(build("shardcodec"))
    lib.sc_load_dataset_alloc.restype = ctypes.c_int64
    lib.sc_load_dataset_alloc.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.sc_free.restype = None
    lib.sc_free.argtypes = [ctypes.c_void_p]
    lib.sc_write_records.restype = ctypes.c_int64
    lib.sc_write_records.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
        ctypes.c_int64,
        ctypes.c_int32,
    ]
    return lib


@functools.cache
def get_lmdb_lib() -> ctypes.CDLL:
    """The LMDB codec (built here if needed)."""
    lib = ctypes.CDLL(build("lmdbcodec"))
    lib.lc_load_dataset.restype = ctypes.c_int64
    lib.lc_load_dataset.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.lc_free_result.restype = None
    lib.lc_free_result.argtypes = [ctypes.c_void_p]
    return lib


def _raise(rc: int, what: str, malformed: type[ValueError]) -> None:
    """A C error code -> the exception the Python codec would raise."""
    if rc == OPEN_FAILED:
        if not os.path.exists(what):
            raise FileNotFoundError(f"{what!r} does not exist")
        raise OSError(f"{what!r}: cannot be read (or out of memory)")
    if rc == EMPTY:
        raise malformed(f"{what!r} holds no records")
    if rc == MALFORMED:
        raise malformed(f"{what!r}: malformed record")
    if rc == GEOMETRY:
        raise malformed(
            f"{what!r}: record geometry the native codec cannot hold (a "
            "non-positive dim, too many dims, or an unsupported database "
            "feature)")
    raise RuntimeError(f"{what!r}: native codec error {rc}")


def load_dataset(path: str) -> tuple[np.ndarray, np.ndarray] | None:
    """Decode every record of a shard.dat file in native code.

    -> (images float32 (N, *shape), labels int32 (N,)); None when the
    records' geometry is mixed (the Python codec's case). Any other
    failure raises."""
    lib = get_lib()
    pixels_p = ctypes.POINTER(ctypes.c_float)()
    labels_p = ctypes.POINTER(ctypes.c_int32)()
    shape_buf = (ctypes.c_int32 * 8)()
    ndim = ctypes.c_int32(0)
    count = lib.sc_load_dataset_alloc(
        path.encode(), ctypes.byref(pixels_p), ctypes.byref(labels_p),
        shape_buf, 8, ctypes.byref(ndim),
    )
    if count == MIXED:
        return None
    if count <= 0:
        _raise(count if count < 0 else EMPTY, path, RecordError)
    try:
        shape = tuple(shape_buf[i] for i in range(ndim.value))
        sample = int(np.prod(shape))
        images = np.ctypeslib.as_array(pixels_p, (int(count), sample)).copy()
        labels = np.ctypeslib.as_array(labels_p, (int(count),)).copy()
    finally:
        lib.sc_free(pixels_p)
        lib.sc_free(labels_p)
    return images.reshape((int(count), *shape)), labels


def load_lmdb_dataset(path: str) -> tuple[np.ndarray, np.ndarray] | None:
    """Walk and decode a whole Caffe LMDB (``path`` is its data.mdb) in
    native code: the reference's liblmdb/libprotobuf path,
    layer.cc:237-328. -> (images float32 (N, C, H, W), labels int32
    (N,)); None when the records' geometry is mixed. Any other failure
    raises."""
    lib = get_lmdb_lib()
    handle = ctypes.c_void_p()
    pixels_p = ctypes.POINTER(ctypes.c_float)()
    labels_p = ctypes.POINTER(ctypes.c_int32)()
    shape_buf = (ctypes.c_int32 * 3)()
    count = lib.lc_load_dataset(
        path.encode(), ctypes.byref(handle), ctypes.byref(pixels_p),
        ctypes.byref(labels_p), shape_buf,
    )
    if count == MIXED:
        return None
    if count <= 0:
        _raise(count if count < 0 else EMPTY, path, LMDBError)
    try:
        shape = tuple(shape_buf[i] for i in range(3))
        sample = int(np.prod(shape))
        images = np.ctypeslib.as_array(pixels_p, (int(count), sample)).copy()
        labels = np.ctypeslib.as_array(labels_p, (int(count),)).copy()
    finally:
        lib.lc_free_result(handle)
    return images.reshape((int(count), *shape)), labels


def write_records(path: str, images: np.ndarray, labels: np.ndarray) -> int:
    """Encode uint8 image records into a new shard.dat file, keys
    ``%08d`` from 0; byte-identical to the Python writer. -> records
    written."""
    images = np.ascontiguousarray(images, dtype=np.uint8)
    labels = np.ascontiguousarray(labels, dtype=np.int32)
    shape = (ctypes.c_int32 * (images.ndim - 1))(*images.shape[1:])
    n = get_lib().sc_write_records(
        path.encode(),
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(images),
        shape,
        images.ndim - 1,
        0,  # start index
        0,  # create, not append
    )
    if n == OPEN_FAILED:
        raise OSError(f"{path!r}: cannot be written")
    if n < 0:
        _raise(n, path, RecordError)
    return int(n)
