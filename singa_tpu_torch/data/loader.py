"""Dataset -> shard converter CLI: the port's part of
``singa_tpu/data/loader.py``.

Ported: :func:`write_records` (the native C++ encoder first for a fresh
shard, as in the original; appends take the Python writer, whose key
set deduplicates against the existing records), the MNIST idx and
CIFAR-10 binary readers, the mean file, the synthetic image and token
sources, the shard split (the reference's Split/SplitN, ``equal`` and
``head``) and the LMDB interop (``shard2lmdb``/``lmdb2shard``, for
kLMDBData confs), and their subcommands; and an ImageNet-shaped
synthetic source of the port's own (``imagenet-shaped``, for
examples/imagenet/resnet50.conf). Left out: ``digits`` (it needs
sklearn, which the GPU machine lacks; ``synthetic`` is the learnable
stand-in) and ``imagenet`` (PIL).

Shards are opened in append mode so a crashed run resumes where it
stopped (the reference's data_loader.cc:12-14,122), and MNIST idx files
are parsed with the same big-endian magic/meta layout
(data_source.cc:25-95). Keys are zero-padded record indices.

Mean files: ``compute-mean`` writes a per-pixel mean.npy over a shard,
the counterpart of the reference's binaryproto image mean
(data_source.cc:129-137); rgbimage_param.meanfile points at it.

Usage:
  python -m singa_tpu_torch.data.loader mnist --image-file f --label-file f --output DIR
  python -m singa_tpu_torch.data.loader cifar --bin-files f1 f2 ... --output DIR
  python -m singa_tpu_torch.data.loader synthetic --output DIR --n 1000 [--classes 10] [--size 28] [--channels 3]
  python -m singa_tpu_torch.data.loader imagenet-shaped --output DIR --n 2560 [--seed 0]
  python -m singa_tpu_torch.data.loader compute-mean --input DIR --output mean.npy
  python -m singa_tpu_torch.data.loader text --input corpus.txt --output DIR [--seq-len 256]
  python -m singa_tpu_torch.data.loader tokens --output DIR --n 1000 [--seq-len 128] [--vocab 64]
  python -m singa_tpu_torch.data.loader split --input DIR --prefix P --n N [--mode equal|head]
  python -m singa_tpu_torch.data.loader shard2lmdb --input DIR --output DIR
  python -m singa_tpu_torch.data.loader lmdb2shard --input DIR --output DIR
"""

from __future__ import annotations

import argparse
import os
import struct
import sys

import numpy as np

from .records import ImageRecord, encode_record
from .shard import ShardReader, ShardWriter, shard_path


def _key(i: int) -> str:
    return f"{i:08d}"


def write_records(
    folder: str, images: np.ndarray, labels: np.ndarray, append: bool = True
) -> int:
    """Write uint8 images (or token sequences) + labels as Records;
    returns #inserted.

    A fresh shard is encoded by the native codec (the same bytes as the
    Python writer); an append goes through the Python writer, whose key
    set deduplicates against the existing records, matching the
    reference loader's resume semantics."""
    from .. import native

    images = np.asarray(images, dtype=np.uint8)
    os.makedirs(folder, exist_ok=True)
    if not (append and os.path.exists(shard_path(folder))):
        return native.write_records(shard_path(folder), images, labels)
    n = 0
    with ShardWriter(folder, append=append) as w:
        for i, (img, label) in enumerate(zip(images, labels)):
            rec = ImageRecord(
                shape=list(img.shape), label=int(label), pixel=img.tobytes()
            )
            if w.insert(_key(i), encode_record(rec)):
                n += 1
        w.flush()
    return n


# ---------------------------- sources ----------------------------


def read_idx_images(path: str) -> np.ndarray:
    """Parse an MNIST idx3-ubyte image file (data_source.cc:31-54)."""
    with open(path, "rb") as f:
        magic, num, h, w = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"{path}: bad image magic {magic} (want 2051)")
        buf = f.read(num * h * w)
    return np.frombuffer(buf, dtype=np.uint8).reshape(num, h, w)


def read_idx_labels(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        magic, num = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"{path}: bad label magic {magic} (want 2049)")
        buf = f.read(num)
    return np.frombuffer(buf, dtype=np.uint8)


def read_cifar_bins(paths: list[str]) -> tuple[np.ndarray, np.ndarray]:
    """Parse CIFAR-10 binary batch files: each record is 1 label byte
    followed by 3072 bytes (3 channels x 32x32, channel-major — already
    the (C,H,W) layout our RGB records use)."""
    rec = 1 + 3 * 32 * 32
    images, labels = [], []
    for path in paths:
        buf = np.fromfile(path, dtype=np.uint8)
        if buf.size % rec:
            raise ValueError(
                f"{path}: size {buf.size} is not a multiple of {rec}"
            )
        rows = buf.reshape(-1, rec)
        labels.append(rows[:, 0])
        images.append(rows[:, 1:].reshape(-1, 3, 32, 32))
    return np.concatenate(images), np.concatenate(labels)


def compute_mean(folder: str, out_path: str) -> np.ndarray:
    """Per-pixel float32 mean over every record in a shard, saved as .npy
    (the reference's mean binaryproto, data_source.cc:129-137)."""
    from .pipeline import load_shard_arrays

    images, _ = load_shard_arrays(folder)
    mean = images.astype(np.float64).mean(axis=0).astype(np.float32)
    np.save(out_path, mean)
    return mean


def synthetic_arrays(
    n: int,
    classes: int = 10,
    size: int = 28,
    seed: int = 0,
    noise_seed: int | None = None,
    channels: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Gaussian class-template blobs: learnable, deterministic, no IO.

    ``seed`` fixes the class templates, ``noise_seed`` the per-sample noise —
    pass different noise seeds to get disjoint train/test splits of the same
    classification problem. ``channels`` > 0 makes (C,H,W) RGB-style
    records (CIFAR-shaped with channels=3, size=32).
    """
    rng = np.random.RandomState(seed)
    shape = (channels, size, size) if channels else (size, size)
    templates = rng.rand(classes, *shape) * 160.0
    labels = (np.arange(n) % classes).astype(np.uint8)
    nrng = rng if noise_seed is None else np.random.RandomState(noise_seed)
    noise = nrng.rand(n, *shape) * 95.0
    images = (templates[labels] + noise).clip(0, 255).astype(np.uint8)
    return images, labels


def structured_rgb(
    n: int,
    classes: int = 10,
    seed: int = 0,
    noise_seed: int | None = None,
    class_amplitude: float | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Spatially-structured synthetic RGB: kron-upsampled 8x8 class
    templates (CIFAR-shaped 3x32x32). Weight-shared convs cannot
    discriminate the iid-noise templates of synthetic_arrays (each pixel
    independent), so conv-net convergence runs need low-frequency class
    structure. ``noise_seed`` works like synthetic_arrays'.

    ``class_amplitude`` (r5) controls class overlap: None keeps the
    legacy fully-independent templates (amplitude 160, trivially
    separable — fine for short smoke oracles but the 70k-step AlexNet
    run saturates at 100%, a ceiling-pinned metric that cannot detect a
    regression). A float A builds templates as shared_base + U(0, A)
    per-class delta against the U(0, 95) pixel noise, so the task has a
    real Bayes error: pairwise template separation is A*sqrt(3072/6) ~
    22.6*A against sample noise sigma 27.4 along the discriminant —
    A ~ 6 targets ~90% optimal accuracy for 10 classes (BASELINE.md r5
    records the measured landing point of the full AlexNet run)."""
    rng = np.random.RandomState(seed)
    if class_amplitude is None:
        small = rng.rand(classes, 3, 8, 8) * 160
    else:
        a = float(class_amplitude)
        base = rng.rand(1, 3, 8, 8) * (160.0 - a)
        small = base + rng.rand(classes, 3, 8, 8) * a
    templates = np.kron(small, np.ones((1, 1, 4, 4)))
    labels = (np.arange(n) % classes).astype(np.uint8)
    nrng = rng if noise_seed is None else np.random.RandomState(noise_seed)
    noise = nrng.rand(n, 3, 32, 32) * 95
    return (templates[labels] + noise).clip(0, 255).astype(np.uint8), labels


def imagenet_shaped_arrays(
    n: int,
    classes: int = 1000,
    size: int = 256,
    seed: int = 0,
    noise_seed: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """ImageNet-shaped synthetic records: (n, 3, size, size) uint8 and
    labels over ``classes``, each record made from the seeds alone.

    Record i's label and noise come from ``RandomState([noise_seed, i])``
    (``noise_seed`` defaults to ``seed``), its class's template from
    ``RandomState([seed, classes + label])``: a 3 x 8 x 8 block of
    values in [0, 160) upsampled to the record's size, plus uniform
    integer noise in [0, 95]. No class table is held (at 1000 classes
    and 256 x 256 it would be 1.5 GB of float64)."""
    if size % 8:
        raise ValueError(f"size must be a multiple of 8, got {size}")
    images = np.empty((n, 3, size, size), np.uint8)
    labels = np.empty(n, np.int64)
    nseed = seed if noise_seed is None else noise_seed
    up = size // 8
    for i in range(n):
        rs = np.random.RandomState([nseed, i])
        label = int(rs.randint(classes))
        small = np.random.RandomState([seed, classes + label]).randint(
            0, 160, (3, 8, 8))
        template = small.repeat(up, axis=1).repeat(up, axis=2)
        images[i] = template + rs.randint(0, 96, (3, size, size))
        labels[i] = label
    return images, labels


def text_token_arrays(
    path: str, seq_len: int, stride: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Byte-level LM dataset from any text/binary file: overlapping
    fixed-length windows of raw bytes (vocab 256). Labels are unused (the
    kLMLoss target is the sequence itself)."""
    with open(path, "rb") as f:
        raw = np.frombuffer(f.read(), dtype=np.uint8)
    if len(raw) < seq_len + 1:
        raise ValueError(f"{path}: shorter than one {seq_len}-byte window")
    stride = stride or seq_len
    # inclusive stop: the window starting at len-seq_len is valid (kLMLoss
    # targets are within-window)
    starts = np.arange(0, len(raw) - seq_len + 1, stride)
    tokens = np.stack([raw[s : s + seq_len] for s in starts])
    return tokens, np.zeros(len(tokens), dtype=np.uint8)


def synthetic_token_arrays(
    n: int, seq_len: int = 128, vocab: int = 64, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Learnable synthetic sequences: a fixed random Markov chain over
    ``vocab`` symbols (deterministic given seed) — next-token accuracy
    well above chance is reachable, so LM convergence tests mean
    something."""
    if not 2 <= vocab <= 256:
        raise ValueError(
            f"vocab must be in [2, 256] (uint8 token records), got {vocab}"
        )
    rng = np.random.RandomState(seed)
    # each symbol strongly prefers one successor (80%), else uniform
    succ = rng.randint(0, vocab, size=vocab)
    seqs = np.empty((n, seq_len), dtype=np.uint8)
    state = rng.randint(0, vocab, size=n)
    for t in range(seq_len):
        seqs[:, t] = state
        follow = rng.rand(n) < 0.8
        state = np.where(follow, succ[state], rng.randint(0, vocab, size=n))
    return seqs, np.zeros(n, dtype=np.uint8)


# ---------------------------- split (reference Split/SplitN) -----------


def split_shard(input_dir: str, prefix: str, n: int, mode: str = "equal"):
    """Split a shard into ``<prefix>-<i>`` shards: ``equal`` makes ``n``
    parts (the first takes the remainder), ``head`` puts the first ``n``
    records into ``-0`` and the rest into ``-1``."""
    with ShardReader(input_dir) as reader:
        tuples = list(reader)
    total = len(tuples)
    if mode == "equal":
        if n >= total:
            raise ValueError("too many sub-shards")
        sizes = [total // n + (total % n if i == 0 else 0) for i in range(n)]
        pos = 0
        for i, sz in enumerate(sizes):
            with ShardWriter(f"{prefix}-{i}", append=True) as w:
                for k, v in tuples[pos : pos + sz]:
                    w.insert(k, v)
                w.flush()
            pos += sz
    else:  # head: first n records into -0, rest into -1
        if n >= total:
            raise ValueError("sub shard must be smaller than original")
        for i, chunk in enumerate((tuples[:n], tuples[n:])):
            with ShardWriter(f"{prefix}-{i}", append=True) as w:
                for k, v in chunk:
                    w.insert(k, v)
                w.flush()


# ------------------- LMDB interop (reference kLMDBData) -------------------


def shard_to_lmdb(input_dir: str, output_dir: str) -> int:
    """Re-encode a shard as a Caffe-style LMDB of Datum messages, keyed
    like Caffe's convert tools (%08d). Lets kLMDBData configs run against
    data produced by this loader."""
    from .lmdbio import LMDBError, write_lmdb
    from .records import Datum, decode_record, encode_datum

    def datums():
        with ShardReader(input_dir) as reader:
            for key, val in reader:
                rec = decode_record(val)
                shape = list(rec.shape) + [1] * (3 - len(rec.shape))
                if len(rec.shape) == 2:  # (H,W) grayscale -> C=1
                    shape = [1, rec.shape[0], rec.shape[1]]
                d = Datum(
                    channels=shape[0], height=shape[1], width=shape[2],
                    data=rec.pixel, label=rec.label, float_data=rec.data,
                )
                # latin-1 mirrors lmdb_to_shard's decode: keys are raw bytes
                yield (key.encode("latin-1") if isinstance(key, str)
                       else key, encode_datum(d))

    try:
        # loader-written shards insert zero-padded ascending keys, so the
        # streaming O(page)-memory path normally wins
        return write_lmdb(output_dir, datums(), assume_sorted=True)
    except LMDBError as e:
        if "out of order" not in str(e):
            raise
        return write_lmdb(output_dir, datums())


def lmdb_to_shard(input_dir: str, output_dir: str) -> int:
    """Convert a Caffe LMDB into a shard."""
    from .lmdbio import LMDBReader
    from .records import datum_to_image_record, decode_datum

    n = 0
    with LMDBReader(input_dir) as reader, ShardWriter(
        output_dir, append=True
    ) as w:
        for key, val in reader:
            rec = datum_to_image_record(decode_datum(val))
            if w.insert(key.decode("latin-1"), encode_record(rec)):
                n += 1
        w.flush()
    return n


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="singa_tpu_torch.data.loader")
    sub = ap.add_subparsers(dest="source", required=True)

    p = sub.add_parser("mnist")
    p.add_argument("--image-file", required=True)
    p.add_argument("--label-file", required=True)
    p.add_argument("--output", required=True)

    p = sub.add_parser("cifar")
    p.add_argument("--bin-files", nargs="+", required=True)
    p.add_argument("--output", required=True)

    p = sub.add_parser("synthetic")
    p.add_argument("--output", required=True)
    p.add_argument("--n", type=int, default=1000)
    p.add_argument("--classes", type=int, default=10)
    p.add_argument("--size", type=int, default=28)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--channels", type=int, default=0)

    p = sub.add_parser("imagenet-shaped")
    p.add_argument("--output", required=True)
    p.add_argument("--n", type=int, default=2560)
    p.add_argument("--classes", type=int, default=1000)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--noise-seed", type=int, default=None)

    p = sub.add_parser("compute-mean")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)

    p = sub.add_parser("text")
    p.add_argument("--input", required=True, help="any text/binary file")
    p.add_argument("--output", required=True)
    p.add_argument("--seq-len", type=int, default=256)
    p.add_argument("--stride", type=int, default=0,
                   help="window stride (default seq-len, non-overlapping)")

    p = sub.add_parser("tokens")
    p.add_argument("--output", required=True)
    p.add_argument("--n", type=int, default=1000)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--vocab", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)

    p = sub.add_parser("shard2lmdb")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)

    p = sub.add_parser("lmdb2shard")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)

    p = sub.add_parser("split")
    p.add_argument("--input", required=True)
    p.add_argument("--prefix", required=True)
    p.add_argument("--n", type=int, required=True)
    p.add_argument("--mode", choices=("equal", "head"), default="equal")

    args = ap.parse_args(argv)
    if args.source == "mnist":
        images = read_idx_images(args.image_file)
        labels = read_idx_labels(args.label_file)
        if len(images) != len(labels):
            raise ValueError("image/label count mismatch")
        n = write_records(args.output, images, labels)
    elif args.source == "cifar":
        n = write_records(args.output, *read_cifar_bins(args.bin_files))
    elif args.source == "synthetic":
        n = write_records(
            args.output,
            *synthetic_arrays(
                args.n, args.classes, args.size, args.seed,
                channels=args.channels,
            ),
        )
    elif args.source == "imagenet-shaped":
        n = write_records(
            args.output,
            *imagenet_shaped_arrays(args.n, args.classes, args.size,
                                    args.seed, args.noise_seed),
        )
    elif args.source == "compute-mean":
        mean = compute_mean(args.input, args.output)
        print(f"mean {tuple(mean.shape)} -> {args.output}")
        return 0
    elif args.source == "text":
        n = write_records(
            args.output, *text_token_arrays(args.input, args.seq_len,
                                            args.stride)
        )
    elif args.source == "tokens":
        n = write_records(
            args.output,
            *synthetic_token_arrays(args.n, args.seq_len, args.vocab,
                                    args.seed),
        )
    elif args.source == "shard2lmdb":
        n = shard_to_lmdb(args.input, args.output)
        print(f"wrote {n} datums into {os.path.join(args.output, 'data.mdb')}")
        return 0
    elif args.source == "lmdb2shard":
        n = lmdb_to_shard(args.input, args.output)
    else:
        split_shard(args.input, args.prefix, args.n, args.mode)
        print(f"split {args.input} -> {args.prefix}-*")
        return 0
    print(f"inserted {n} records into {os.path.join(args.output, 'shard.dat')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
