"""Coordination helpers of ``singa_tpu/resilience/coord.py``: the atomic
publish under the mailbox transport's message and status files, this
process's rank for rank-qualified fault terms, and the commit markers of
sharded saves (``commit_<k>.json``: the CRC32 and size of process k's
shard file, written after the shard; the replica engine's ``.server``
sidecar beside a sharded save and its ``commit_server.json`` marker,
written after the sidecar), and the preemption barrier, an OR over the
processes of a ``torch.distributed`` group."""

from __future__ import annotations

import json
import os
import zlib


def atomic_write_bytes(path: str, data: bytes) -> str:
    """Publish ``data`` at ``path`` atomically (pid-suffixed tmp +
    rename): a reader sees the file absent or complete, never torn. The
    fleet mailbox's messages and statuses land through it, file for
    file as the JAX package's do."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return path


def process_index() -> int:
    """This process's rank: ``torch.distributed``'s when a process group
    is up, else 0 (a fleet host is one process; its role comes from
    ``-procsID``, not from here)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def process_count() -> int:
    """The processes of the job: ``torch.distributed``'s world when a
    process group is up, else 1."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def preemption_barrier(requested: bool) -> bool:
    """Cross-process OR of this process's preemption flag.

    Called at step or chunk boundaries (every process calls it at the
    same boundaries: the cadence loop is deterministic), so the
    allgather doubles as the consistent cut: when it returns True in one
    process it returns True in all of them, and every process drains at
    that step. One process short-circuits to its own flag."""
    if process_count() <= 1:
        return bool(requested)
    import torch
    import torch.distributed as dist

    flag = torch.tensor([int(bool(requested))], dtype=torch.int32)
    if dist.get_backend() == "nccl":
        flag = flag.cuda()
    flags = [torch.empty_like(flag) for _ in range(process_count())]
    dist.all_gather(flags, flag)
    return bool(torch.cat(flags).any())


#: manifest field value declaring "this save carries commit markers"
COMMIT_VERSION = 2
#: format tag inside each marker file
COMMIT_FORMAT = "singa-tpu-commit-v2"


def commit_marker_path(path: str, proc: int) -> str:
    """``commit_k.json`` inside sharded checkpoint dir ``path``."""
    return os.path.join(path, f"commit_{proc}.json")


def shard_digest(shard_file: str) -> dict:
    """{"size", "crc32"} over the shard file's full byte stream."""
    crc = 0
    size = 0
    with open(shard_file, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            size += len(chunk)
    return {"size": size, "crc32": crc & 0xFFFFFFFF}


def write_commit(path: str, proc: int) -> str:
    """Publish process ``proc``'s commit marker for the shard it just
    wrote. Atomic tmp + rename: a marker is absent or complete."""
    marker = {
        "format": COMMIT_FORMAT,
        "proc": int(proc),
        **shard_digest(os.path.join(path, f"proc_{proc}.npz")),
    }
    return atomic_write_bytes(
        commit_marker_path(path, proc),
        json.dumps(marker).encode("utf-8"),
    )


def _marker_matches(marker_path: str, data_path: str, check) -> bool:
    """True iff the marker at ``marker_path`` parses, passes ``check``
    and holds the size and CRC32 of ``data_path``'s bytes."""
    try:
        with open(marker_path, encoding="utf-8") as f:
            marker = json.load(f)
    except (OSError, ValueError):
        return False
    if marker.get("format") != COMMIT_FORMAT or not check(marker):
        return False
    try:
        digest = shard_digest(data_path)
    except OSError:
        return False
    try:
        return (
            int(marker["size"]) == digest["size"]
            and int(marker["crc32"]) == digest["crc32"]
        )
    except (KeyError, TypeError, ValueError):
        return False


def commit_ok(path: str, proc: int) -> bool:
    """True iff process ``proc``'s commit marker exists, parses, and
    matches its shard's bytes (size + CRC32): a tear of the marker or of
    the shard after it fails here."""
    return _marker_matches(
        commit_marker_path(path, proc),
        os.path.join(path, f"proc_{proc}.npz"),
        lambda m: int(m.get("proc", -1)) == int(proc),
    )


def sidecar_path(path: str) -> str:
    """The replica engine's ``.server`` sidecar beside checkpoint
    ``path`` (the center and the protocol's snapshot,
    ``trainer/replica.py``)."""
    return path + ".server"


def sidecar_marker_path(path: str) -> str:
    """``commit_server.json`` inside sharded checkpoint dir ``path``: the
    sidecar's commit marker. Inside the dir, it goes with the save."""
    return os.path.join(path, "commit_server.json")


def write_sidecar_commit(path: str) -> str:
    """Publish the commit marker of the ``.server`` sidecar just written
    beside sharded dir ``path``: its size and CRC32, atomically. Written
    after the sidecar, by the one process that writes it (process 0): a
    present marker vouches for a whole sidecar."""
    marker = {
        "format": COMMIT_FORMAT,
        "sidecar": True,
        **shard_digest(sidecar_path(path)),
    }
    return atomic_write_bytes(
        sidecar_marker_path(path),
        json.dumps(marker).encode("utf-8"),
    )


def sidecar_commit_ok(path: str) -> bool:
    """True iff sharded dir ``path``'s ``.server`` sidecar matches its
    ``commit_server.json`` marker: a torn sidecar, a torn marker or a
    process that died between the two fail here."""
    return _marker_matches(
        sidecar_marker_path(path), sidecar_path(path),
        lambda m: bool(m.get("sidecar")),
    )
