"""Checkpoint LATEST resolution, the restore half of
``singa_tpu/resilience/retention.py``: which save in a checkpoint folder
to trust. The port's Trainer writes ``step_<N>.npz`` in the JAX
package's format (trainer/checkpoint.py), so a folder either package
wrote resolves the same way here.

``resolve_latest`` follows the ``LATEST`` marker when its target
validates, else scans ``step_*`` entries newest first and returns the
first complete one. An npz save is complete when it is an intact zip
archive (every member CRC-checked) holding the step key. A sharded save
(``step_<N>.ckpt`` directory) is not ported (ROADMAP.md): it never
validates here, so it is skipped, and ``reshard.load_serving_params``
raises on one by name.
"""

from __future__ import annotations

import os
import re
import zipfile

LATEST_MARKER = "LATEST"

_STEP_RE = re.compile(r"^step_(\d+)\.(npz|ckpt)$")


def validate_checkpoint(path: str) -> bool:
    """True iff ``path`` is a complete npz save: an intact zip holding
    the ``__step__`` entry."""
    if not os.path.isfile(path):
        return False
    try:
        with zipfile.ZipFile(path) as z:
            if z.testzip() is not None:
                return False
            return any(n.startswith("__step__") for n in z.namelist())
    except (OSError, zipfile.BadZipFile, ValueError):
        return False


def list_checkpoints(folder: str) -> list[str]:
    """``step_*`` entries under ``folder``, newest step first."""
    try:
        names = os.listdir(folder)
    except OSError:
        return []
    found = []
    for name in names:
        m = _STEP_RE.match(name)
        if m:
            found.append((int(m.group(1)), os.path.join(folder, name)))
    return [p for _, p in sorted(found, reverse=True)]


def resolve_latest(folder: str | None) -> str | None:
    """The newest complete checkpoint under ``folder``: the LATEST
    target when it validates, else the newest ``step_*`` entry that
    does; None when nothing trustworthy exists."""
    if not folder or not os.path.isdir(folder):
        return None
    marker = os.path.join(folder, LATEST_MARKER)
    try:
        with open(marker, "r", encoding="utf-8") as f:
            name = f.read().strip()
    except OSError:
        name = ""
    if name:
        target = os.path.join(folder, os.path.basename(name))
        if validate_checkpoint(target):
            return target
    for path in list_checkpoints(folder):
        if validate_checkpoint(path):
            return path
    return None
