"""Checkpoint retention: keep-last-N, a LATEST marker, torn-save defense.
The PyTorch counterpart of ``singa_tpu/resilience/retention.py``, the
same code: the port's Trainer writes ``step_<N>.npz`` files or, with
``checkpoint_format: "sharded"``, ``step_<N>.ckpt`` directories, both in
the JAX package's formats, so a folder either package wrote is judged
the same way here.

  - ``mark_latest`` records the newest *validated* checkpoint in a
    ``LATEST`` marker file, written atomically (tmp + rename). The caller
    validates before marking, so LATEST never names a torn save.
  - ``resolve_latest`` follows LATEST when its target validates, else
    scans every ``step_*`` entry newest first and returns the first
    complete one.
  - ``validate_checkpoint``: an npz save is an intact zip archive (every
    member CRC-checked) holding the step key; a sharded save has a
    parseable manifest and every ``proc_k`` shard it promises, under the
    commit protocol (the manifest's ``commit``) each with its
    ``commit_k.json`` marker matching the shard's CRC32 and size, and the
    replica engine's ``.server`` sidecar when the manifest promises it.
    Positive verdicts are cached by the files' (mtime, size).
  - ``apply_retention`` removes all but the newest N complete saves
    (never the one LATEST names), with their ``.server`` sidecars.
  - ``remove_stale_shards`` / ``gc_stale_shards`` remove the ``proc_k``
    files a larger job left in a sharded directory.

No imports from the trainer package: the supervisor calls this before a
trainer exists, and the trainer's save hook calls it after each write.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import zipfile

from . import coord

LATEST_MARKER = "LATEST"

_STEP_RE = re.compile(r"^step_(\d+)\.(npz|ckpt)$")
_PROC_RE = re.compile(r"^proc_(\d+)\.npz$")
_COMMIT_RE = re.compile(r"^commit_(\d+)\.json$")


def checkpoint_step(path: str) -> int | None:
    """The step number encoded in a checkpoint basename, or None."""
    m = _STEP_RE.match(os.path.basename(path))
    return int(m.group(1)) if m else None


def _npz_valid(path: str) -> bool:
    """Intact zip archive holding the ``__step__`` entry. ``testzip``
    CRC-checks every member, so a truncated or bit-flipped save fails
    even though np.load's lazy zip layer might open it. (The replica
    ``.server`` sidecar is only commit-verified for SHARDED saves —
    ``_sharded_valid`` + the manifest's ``sidecar`` promise; the npz
    format has no commit machinery to ride.)"""
    try:
        with zipfile.ZipFile(path) as z:
            if z.testzip() is not None:
                return False
            return any(n.startswith("__step__") for n in z.namelist())
    except (OSError, zipfile.BadZipFile, ValueError):
        return False


def _sharded_valid(path: str) -> bool:
    """Manifest parses, every promised proc shard is an intact zip, and
    — for saves written under the two-phase commit protocol — every
    per-proc commit marker matches its shard's bytes. A save missing
    even one peer's commit (rank died between shard and marker, or the
    marker itself was torn) is NOT a checkpoint. A manifest that
    promises a replica ``.server`` sidecar (``"sidecar": true``,
    trainer/replica.py) additionally needs the sidecar file AND its
    ``commit_server.json`` marker to match — a rank that died between
    shard commit and sidecar, or tore the sidecar afterwards, must not
    leave a resumable-looking save whose protocol state is garbage."""
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
            # the marker's whole-file size+CRC32 subsumes the zip
            # member walk for tear detection — one read per shard on
            # process 0's promotion path, not two
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


#: validation cache: path -> fingerprint of the last content this module
#: fully CRC-validated. The per-save retention pass re-walks EVERY kept
#: checkpoint through validate_checkpoint; without the cache that walk
#: (zipfile.testzip CRC over every member of every archive) grows with
#: keep_last and bounds the async writer's throughput. A fingerprint is
#: (mtime_ns, size) per constituent file, so any rewrite/tear/truncation
#: forces a real re-validation.
_VALIDATED: dict[str, tuple] = {}
_VALIDATED_CAP = 256


def validation_cache_clear() -> None:
    """Drop every cached validation verdict (tests; paranoia)."""
    _VALIDATED.clear()


def _fingerprint(path: str) -> tuple | None:
    """Stat-level identity of a checkpoint's bytes, or None when it
    cannot be stat'ed (never cache what cannot be re-checked)."""
    try:
        if os.path.isdir(path):
            names = ["manifest.json"] + sorted(
                f
                for f in os.listdir(path)
                if _PROC_RE.match(f)
                or _COMMIT_RE.match(f)
                or f == "commit_server.json"
            )
            fp = []
            for name in names:
                st = os.stat(os.path.join(path, name))
                fp.append((name, st.st_mtime_ns, st.st_size))
            # the replica .server sidecar lives BESIDE the dir; a tear
            # of it must invalidate the cached verdict too
            try:
                st = os.stat(path + ".server")
                fp.append((".server", st.st_mtime_ns, st.st_size))
            except OSError:
                pass
            return tuple(fp)
        st = os.stat(path)
        return (st.st_mtime_ns, st.st_size)
    except OSError:
        return None


def _forget_validated(path: str) -> None:
    _VALIDATED.pop(path, None)


def validate_checkpoint(path: str) -> bool:
    """True iff ``path`` is a complete, readable checkpoint.

    Positive verdicts are cached by content fingerprint: a checkpoint
    this process already CRC-validated is only re-walked when its files'
    (mtime, size) changed. Negative verdicts are never cached — a save
    that looks torn may simply still be in flight."""
    fp = _fingerprint(path)
    if fp is not None and _VALIDATED.get(path) == fp:
        return True
    if os.path.isdir(path):
        ok = _sharded_valid(path)
    else:
        ok = os.path.isfile(path) and _npz_valid(path)
    if ok and fp is not None:
        # the fingerprint was taken BEFORE the walk: if a concurrent
        # writer changed the file mid-validation, the stale fingerprint
        # mismatches next time and forces a re-check — the safe side
        if len(_VALIDATED) >= _VALIDATED_CAP:
            for stale in [p for p in _VALIDATED if not os.path.exists(p)]:
                _VALIDATED.pop(stale, None)
            if len(_VALIDATED) >= _VALIDATED_CAP:
                _VALIDATED.clear()  # pathological churn; correctness first
        _VALIDATED[path] = fp
    return ok


def list_checkpoints(folder: str) -> list[str]:
    """``step_*`` entries under ``folder``, newest step first (no
    validation — callers validate the ones they intend to trust)."""
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


def mark_latest(folder: str, path: str) -> None:
    """Atomically point ``folder/LATEST`` at ``path`` (a checkpoint in
    ``folder``). Callers must have validated ``path`` first — the marker
    is the trust anchor a restarted job follows blindly."""
    marker = os.path.join(folder, LATEST_MARKER)
    tmp = marker + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(os.path.basename(path) + "\n")
    os.replace(tmp, marker)


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


def apply_retention(folder: str, keep_last: int, *,
                    current_nprocs: int | None = None) -> list[str]:
    """Delete all but the newest ``keep_last`` complete checkpoints
    (invalid ones are deleted regardless — they can never be restored
    — except the newest entry, which may still be mid-write by a
    concurrent saver). The LATEST target always survives. Returns the
    deleted paths. ``keep_last <= 0`` keeps everything.

    With ``current_nprocs`` given (the live job's process count), the
    keep budget PREFERS saves written by the current topology: a
    sharded save from a since-resized job restores only through the
    reshard path, so when trimming, stale-topology saves evict first —
    newest current-topology saves fill the budget, then the newest
    stale ones take whatever budget remains. npz saves are
    topology-agnostic (host-assembled, restorable anywhere) and always
    count as current. ``None`` keeps the pure newest-first order."""
    if keep_last <= 0:
        return []
    marker = os.path.join(folder, LATEST_MARKER)
    pinned = ""
    try:
        with open(marker, "r", encoding="utf-8") as f:
            pinned = f.read().strip()
    except OSError:
        pass
    entries = [
        (path, validate_checkpoint(path))
        for path in list_checkpoints(folder)
    ]
    keep_set: set[str] | None = None
    if current_nprocs is not None:
        from .reshard import checkpoint_nprocs

        def stale(path: str) -> bool:
            nprocs = checkpoint_nprocs(path)
            return nprocs is not None and nprocs != current_nprocs

        ranked = [p for p, valid in entries if valid and not stale(p)]
        ranked += [p for p, valid in entries if valid and stale(p)]
        keep_set = set(ranked[:keep_last])
    deleted: list[str] = []
    kept = 0
    for i, (path, valid) in enumerate(entries):
        if keep_set is None:
            keep = valid and kept < keep_last
        else:
            keep = path in keep_set
        keep = keep or bool(
            pinned and os.path.basename(path) == pinned
        )
        if not valid and i == 0:
            keep = True  # newest entry may be a concurrent in-flight save
        if keep:
            kept += int(valid)
            continue
        try:
            if os.path.isdir(path):
                shutil.rmtree(path)
            else:
                os.unlink(path)
            deleted.append(path)
            _forget_validated(path)
        except OSError:
            pass
        # the replica engine writes a `<ckpt>.server` sidecar (center +
        # protocol snapshot, trainer/replica.py) the size of the whole
        # server tree — it must not outlive its checkpoint
        sidecar = path + ".server"
        if os.path.isfile(sidecar):
            try:
                os.unlink(sidecar)
                deleted.append(sidecar)
            except OSError:
                pass
    return deleted


def remove_stale_shards(path: str, nprocs: int) -> list[str]:
    """Remove ``proc_k.npz`` / ``commit_k.json`` (and torn ``.tmp``)
    files in a sharded checkpoint dir for k >= ``nprocs`` — leftovers
    from a previously larger job that the loader would silently never
    read (and whose stale commit markers would vouch for shards that no
    longer belong to the save). The ONE copy of this delete loop:
    ``save_sharded`` calls it with the live process count before
    writing its manifest, ``gc_stale_shards`` with the manifest's own
    count for already-written dirs. Files for k < nprocs are never
    touched (a peer process may be mid-write)."""
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


def gc_stale_shards(path: str) -> list[str]:
    """``remove_stale_shards`` driven by the manifest's own nprocs —
    cleans dirs written before save_sharded grew its at-save GC.
    Returns the removed paths; no-op for npz checkpoints."""
    if not os.path.isdir(path):
        return []
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            nprocs = int(json.load(f).get("nprocs", 1))
    except (OSError, ValueError):
        return []
    return remove_stale_shards(path, nprocs)
