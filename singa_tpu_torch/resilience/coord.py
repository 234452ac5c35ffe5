"""Coordination helpers of ``singa_tpu/resilience/coord.py`` that the
serving fleet uses: the atomic publish under the mailbox transport's
message and status files, and this process's rank for rank-qualified
fault terms. The preemption barrier and the commit markers of sharded
saves are not ported."""

from __future__ import annotations

import os


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
