"""Token datasets -> shard converter CLI: the training slice's part of
``singa_tpu/data/loader.py``.

Ported: :func:`write_records` (on the Python shard writer; the
original tries its native C++ encoder first, which writes the same
bytes), :func:`text_token_arrays`, :func:`synthetic_token_arrays` and
the ``text`` and ``tokens`` subcommands. The image sources (mnist,
cifar, digits, synthetic, imagenet), the mean file, the shard split and
the LMDB interop wait for the slices that train on them.

Shards are opened in append mode so a crashed run resumes where it
stopped (the reference's data_loader.cc:12-14,122). Keys are
zero-padded record indices.

Usage:
  python -m singa_tpu_torch.data.loader text --input corpus.txt --output DIR [--seq-len 256]
  python -m singa_tpu_torch.data.loader tokens --output DIR --n 1000 [--seq-len 128] [--vocab 64]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .records import ImageRecord, encode_record
from .shard import ShardWriter


def _key(i: int) -> str:
    return f"{i:08d}"


def write_records(
    folder: str, images: np.ndarray, labels: np.ndarray, append: bool = True
) -> int:
    """Write uint8 images (one token sequence each) + labels as Records;
    returns #inserted. The writer's key set deduplicates against
    existing records, matching the reference loader's resume semantics."""
    images = np.asarray(images, dtype=np.uint8)
    os.makedirs(folder, exist_ok=True)
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


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="singa_tpu_torch.data.loader")
    sub = ap.add_subparsers(dest="source", required=True)

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

    args = ap.parse_args(argv)
    if args.source == "text":
        n = write_records(
            args.output, *text_token_arrays(args.input, args.seq_len,
                                            args.stride)
        )
    else:
        n = write_records(
            args.output,
            *synthetic_token_arrays(args.n, args.seq_len, args.vocab,
                                    args.seed),
        )
    print(f"inserted {n} records into {os.path.join(args.output, 'shard.dat')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
