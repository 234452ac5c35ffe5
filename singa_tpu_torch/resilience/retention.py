"""Checkpoint LATEST resolution, the restore half of
``singa_tpu/resilience/retention.py``: which save in a checkpoint folder
to trust. The port's Trainer writes ``step_<N>.npz`` or, with
``checkpoint_format: "sharded"``, ``step_<N>.ckpt`` directories, both in
the JAX package's formats, so a folder either package wrote resolves
the same way here.

``resolve_latest`` follows the ``LATEST`` marker when its target
validates, else scans ``step_*`` entries newest first and returns the
first complete one. An npz save is complete when it is an intact zip
archive (every member CRC-checked) holding the step key. A sharded save
is complete when its manifest parses and every ``proc_k`` shard it
promises is there: under the commit protocol (the manifest's
``commit``) each with its ``commit_k.json`` marker matching the shard's
CRC32 and size, else an intact zip. A save whose marker is missing is
never resumable. ``remove_stale_shards`` is the sharded save's clean-up
of a larger job's leftovers.
"""

from __future__ import annotations

import json
import os
import re
import zipfile

from . import coord

LATEST_MARKER = "LATEST"

_STEP_RE = re.compile(r"^step_(\d+)\.(npz|ckpt)$")
_PROC_RE = re.compile(r"^proc_(\d+)\.npz$")
_COMMIT_RE = re.compile(r"^commit_(\d+)\.json$")


def _sharded_valid(path: str) -> bool:
    """Manifest parses, every promised proc shard is an intact zip, and,
    for saves under the commit protocol, every per-proc commit marker
    matches its shard's bytes; a manifest that promises the replica
    engine's ``.server`` sidecar also needs its marker to match."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return False
    if manifest.get("format") != "singa-tpu-sharded-v1":
        return False
    if manifest.get("sidecar") and not coord.sidecar_commit_ok(path):
        return False
    nprocs = int(manifest.get("nprocs", 1))
    committed = manifest.get("commit") == coord.COMMIT_VERSION
    for k in range(nprocs):
        if committed:
            if not coord.commit_ok(path, k):
                return False
            continue
        shard = os.path.join(path, f"proc_{k}.npz")
        try:
            with zipfile.ZipFile(shard) as z:
                if z.testzip() is not None:
                    return False
        except (OSError, zipfile.BadZipFile, ValueError):
            return False
    return True


def validate_checkpoint(path: str) -> bool:
    """True iff ``path`` is a complete save: a sharded directory as
    ``_sharded_valid`` has it, or an intact npz zip holding the
    ``__step__`` entry."""
    if os.path.isdir(path):
        return _sharded_valid(path)
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


def remove_stale_shards(path: str, nprocs: int) -> list[str]:
    """Remove ``proc_k.npz`` / ``commit_k.json`` (and torn ``.tmp``)
    files in a sharded checkpoint dir for k >= ``nprocs``: leftovers of a
    larger job that the loader would never read. Files for k < nprocs
    are never touched."""
    removed = []
    try:
        names = os.listdir(path)
    except OSError:
        return removed
    for fname in names:
        base = fname[:-4] if fname.endswith(".tmp") else fname
        m = _PROC_RE.match(base) or _COMMIT_RE.match(base)
        if m and int(m.group(1)) >= nprocs:
            full = os.path.join(path, fname)
            try:
                os.unlink(full)
                removed.append(full)
            except OSError:
                pass
    return removed
