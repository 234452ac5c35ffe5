"""Host-side input pipeline: shard or LMDB -> batched numpy arrays.

Counterpart of ``singa_tpu/data/pipeline.py``: :func:`load_shard_arrays`
and :func:`load_lmdb_arrays` decode through the native C++ codecs first
(``singa_tpu_torch/native``), as the original does, and
:class:`BatchPipeline` has the methods the device-resident dataset and
the multi-step chunks drive (``advance``, ``next_indices``,
``steps_per_epoch``).

The native codecs hand a dataset to the Python codec
(:func:`python_shard_arrays`, :func:`python_lmdb_arrays`) in one case
only, mixed per-record geometry; a failed build or a malformed record
raises. :data:`served` counts which codec served each load
(``"shard/native"``, ``"shard/python"``, ``"lmdb/native"``,
``"lmdb/python"``), so a caller can check that the native path ran.

Replaces the reference's DataLayer machinery
(ShardDataLayer::ComputeFeature, src/worker/layer.cc:646-673): it
delivers raw record batches with the reference's sequencing semantics
(sequential reads with wraparound, one-time random_skip).
"""

from __future__ import annotations

import collections
import os

import numpy as np

from .records import decode_record
from .shard import ShardError, ShardReader, shard_path

#: loads served, by "<format>/<codec>"
served: collections.Counter = collections.Counter()


def load_shard_arrays(folder: str) -> tuple[np.ndarray, np.ndarray]:
    """Decode every record in a shard into (images, labels) arrays.

    Images come back as float32 with the record's own shape appended after
    the batch dim; uint8 ``pixel`` payloads are widened (the reference's
    cast-to-uint8-then-float dance, layer.cc:390-400). The native codec
    decodes uniform-geometry shards; a shard of mixed geometry goes to
    the Python codec."""
    from .. import native

    path = shard_path(folder)
    if not os.path.exists(path):
        raise ShardError(f"no shard.dat under {folder!r}")
    fast = native.load_dataset(path)
    if fast is None:
        return python_shard_arrays(folder)
    served["shard/native"] += 1
    return fast


def python_shard_arrays(folder: str) -> tuple[np.ndarray, np.ndarray]:
    """:func:`load_shard_arrays` on the Python codec: its mixed-geometry
    case, and the reference the native codec is held to."""
    images: list[np.ndarray] = []
    labels: list[int] = []
    with ShardReader(folder) as reader:
        for _, val in reader:
            rec = decode_record(val)
            shape = tuple(rec.shape) if rec.shape else (-1,)
            if rec.pixel:
                img = np.frombuffer(rec.pixel, dtype=np.uint8).astype(
                    np.float32
                )
            else:
                img = np.asarray(rec.data, dtype=np.float32)
            images.append(img.reshape(shape))
            labels.append(rec.label)
    if not images:
        raise ValueError(f"shard {folder!r} holds no records")
    served["shard/python"] += 1
    return np.stack(images), np.asarray(labels, dtype=np.int32)


def load_lmdb_arrays(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Decode every Datum in a Caffe LMDB into (images, labels) arrays,
    the in-memory equivalent of LMDBDataLayer's cursor loop + conversion
    (reference layer.cc:237-328).

    Uniform-geometry databases decode through the native C++ walker (like
    the reference's liblmdb path); a database of mixed geometry goes to
    the pure-Python B+tree reader, which cannot batch it either and
    raises a clear error."""
    from .. import native
    from .lmdbio import lmdb_data_path

    fast = native.load_lmdb_dataset(lmdb_data_path(path))
    if fast is None:
        return python_lmdb_arrays(path)
    served["lmdb/native"] += 1
    return fast


def python_lmdb_arrays(path: str) -> tuple[np.ndarray, np.ndarray]:
    """:func:`load_lmdb_arrays` on the Python reader: its mixed-geometry
    case, and the reference the native walker is held to."""
    from .lmdbio import LMDBReader
    from .records import datum_to_image_record, decode_datum

    images: list[np.ndarray] = []
    labels: list[int] = []
    first_shape: tuple | None = None
    with LMDBReader(path) as reader:
        for key, val in reader:
            rec = datum_to_image_record(decode_datum(val))
            shape = tuple(rec.shape) if any(rec.shape) else (-1,)
            if rec.pixel:
                img = np.frombuffer(rec.pixel, dtype=np.uint8).astype(
                    np.float32
                )
            else:
                img = np.asarray(rec.data, dtype=np.float32)
            img = img.reshape(shape)
            # compare post-reshape shapes so shapeless records (which all
            # normalize to (-1,)) still trip on differing lengths
            if first_shape is None:
                first_shape = img.shape
            elif img.shape != first_shape:
                raise ValueError(
                    f"LMDB {path!r}: record {key!r} has shape {img.shape}, "
                    f"others {first_shape} — mixed geometry cannot be "
                    "batched; re-export at a uniform size"
                )
            images.append(img)
            labels.append(rec.label)
    if not images:
        raise ValueError(f"LMDB {path!r} holds no records")
    served["lmdb/python"] += 1
    return np.stack(images), np.asarray(labels, dtype=np.int32)


class BatchPipeline:
    """Batched sequential iteration with wraparound.

    Mirrors ShardDataLayer semantics: records are consumed in file order,
    wrapping at the end; ``random_skip`` skips ``rand() % random_skip``
    records once at startup (layer.cc:646-656). Single-threaded, so
    ``seek`` works at any point in a run.
    """

    def __init__(
        self,
        images: np.ndarray,
        labels: np.ndarray,
        batchsize: int,
        *,
        random_skip: int = 0,
        seed: int | None = None,
    ):
        if len(images) != len(labels):
            raise ValueError("images/labels length mismatch")
        self.images = images
        self.labels = labels
        self.batchsize = batchsize
        self.n = len(images)
        self._pos = 0  # cursor (record index of the next unread batch)
        if random_skip:
            rng = np.random.RandomState(seed)
            self._pos = int(rng.randint(0, random_skip)) % self.n
        # CONSUMED bookkeeping: position derives from batches handed out,
        # relative to the post-skip start
        self._start = self._pos
        self._consumed = 0

    @property
    def position(self) -> int:
        """Stream position (record index of the next batch). Checkpoints
        persist this; seek() restores it. The one-time random_skip draw
        is baked into it, so resume needs no separate RNG state."""
        return int((self._start + self._consumed * self.batchsize) % self.n)

    def seek(self, pos: int) -> None:
        """Reposition the stream (checkpoint resume, the chunk stager's
        window-boundary re-sync)."""
        self._pos = int(pos) % self.n
        self._start = self._pos
        self._consumed = 0

    def advance(self, nsteps: int) -> None:
        """Skip ``nsteps`` batches: the device-side chunk consumed them
        through on-device index math (Trainer.train_chunk)."""
        self._pos = int((self._pos + nsteps * self.batchsize) % self.n)
        self._consumed += nsteps

    def _next_indices(self) -> np.ndarray:
        idx = (self._pos + np.arange(self.batchsize)) % self.n
        self._pos = int((self._pos + self.batchsize) % self.n)
        return idx

    def next_indices(self) -> np.ndarray:
        """Advance the stream and return the batch's record indices
        without materializing arrays (device-cached datasets gather on
        the device)."""
        idx = self._next_indices()
        self._consumed += 1
        return idx

    def next_batch(self) -> tuple[np.ndarray, np.ndarray]:
        idx = self._next_indices()
        self._consumed += 1
        return self.images[idx], self.labels[idx]

    def steps_per_epoch(self) -> int:
        return max(1, self.n // self.batchsize)
