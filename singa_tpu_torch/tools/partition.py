"""Partition dataset records across worker groups (the PyTorch
counterpart of ``singa_tpu/tools/partition.py``, on the port's shard
reader and writer: the same shards, byte for byte).

The reference's script/load_data.py slices a record-id list into
per-group shares (integer division, remainder dropped), then within a
group either *replicates* the share to every worker (data-parallel
groups read the same records) or splits it per worker
(load_data.py:partition). The ssh/scp distribution plumbing becomes
plain local directory writes here: the "workers" are per-host input
pipelines reading their own shard directory.

Usage:
  python -m singa_tpu_torch.tools.partition --input SHARD --output-prefix P \
      --nworkers 8 --group-size 2 [--replicate]
produces P-w0 .. P-w7 shard dirs (or rid.txt lists with --rid-list).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Sequence, TypeVar

T = TypeVar("T")


def partition_records(
    records: Sequence[T],
    nworkers: int,
    group_size: int,
    replicate: bool = False,
) -> list[list[T]]:
    """Return per-worker record lists with the reference's slicing.

    load_data.py semantics: ngroups = nworkers // group_size; each group
    gets records[g*n : (g+1)*n] with n = len(records) // ngroups; within a
    group the share is replicated to all members or split evenly
    (remainders truncate, exactly like the reference's integer division).
    """
    if group_size <= 0 or nworkers <= 0 or nworkers % group_size:
        raise ValueError(
            f"nworkers ({nworkers}) must be a positive multiple of "
            f"group_size ({group_size})"
        )
    ngroups = nworkers // group_size
    per_group = len(records) // ngroups
    out: list[list[T]] = []
    for g in range(ngroups):
        share = list(records[g * per_group : (g + 1) * per_group])
        if replicate:
            out.extend([share] * group_size)
        else:
            per_worker = per_group // group_size
            out.extend(
                share[k * per_worker : (k + 1) * per_worker]
                for k in range(group_size)
            )
    return out


def main(argv: list[str] | None = None) -> int:
    from ..data.shard import ShardReader, ShardWriter

    ap = argparse.ArgumentParser(prog="singa_tpu_torch.tools.partition")
    ap.add_argument("--input", required=True,
                    help="shard dir, or a rid.txt with --rid-list")
    ap.add_argument("--output-prefix", required=True)
    ap.add_argument("--nworkers", type=int, required=True)
    ap.add_argument("--group-size", type=int, default=1)
    ap.add_argument("--replicate", action="store_true",
                    help="every worker in a group gets the group's share")
    ap.add_argument("--rid-list", action="store_true",
                    help="partition a text record list instead of a shard")
    args = ap.parse_args(argv)

    if args.rid_list:
        with open(args.input) as f:
            records = [ln for ln in f.read().splitlines() if ln.strip()]
        shares = partition_records(
            records, args.nworkers, args.group_size, args.replicate
        )
        for w, share in enumerate(shares):
            path = f"{args.output_prefix}-w{w}.txt"
            with open(path, "w") as f:
                f.write("\n".join(share) + ("\n" if share else ""))
            print(f"worker {w}: {len(share)} records -> {path}")
        return 0

    with ShardReader(args.input) as reader:
        records = list(reader)
    shares = partition_records(
        records, args.nworkers, args.group_size, args.replicate
    )
    for w, share in enumerate(shares):
        folder = f"{args.output_prefix}-w{w}"
        os.makedirs(folder, exist_ok=True)
        with ShardWriter(folder, append=True) as wr:
            for k, v in share:
                wr.insert(k, v)
            wr.flush()
        print(f"worker {w}: {len(share)} records -> {folder}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
