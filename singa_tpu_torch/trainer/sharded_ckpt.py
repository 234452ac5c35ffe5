"""Sharded checkpointing: the JAX package's per-process shard format.

Counterpart of ``singa_tpu/trainer/sharded_ckpt.py``, on the same disk
layout, so a save written by either package restores in the other:

  <dir>/manifest.json      step, stream positions, per-array metadata
                           (shape, dtype, and the PartitionSpec as JSON:
                           ``[]`` replicated, ``[None] * d + ["data"]``
                           sharded over the data axis along dim d)
  <dir>/proc_<k>.npz       process k's shards, one entry
                           ``<key>##<flat device index>`` per (array,
                           device) with its global index box under
                           ``<key>##<flat device index>##idx`` ((ndim, 2)
                           int64 [start, stop) per dim)
  <dir>/commit_<k>.json    process k's commit marker: the CRC32 and size
                           of its shard file, written after the shard
                           (``resilience/coord.py``); a save whose marker
                           is missing or stale is never resumable
                           (``resilience/retention.py``)

Keys are the npz checkpoint's: ``p|<param>``, ``s|<param>|<slot>``,
``b|<buffer>``.

Process k of the job writes ``proc_k.npz``: one entry per rank of its
own for an array laid over the data axis (:class:`RankShards`: the zero
update's slots, the ring's residuals), its flat device index being the
global rank, and process 0 alone one entry, from its first rank, for a
replicated array, as the JAX package saves replica 0 only. Files are
written to ``.tmp`` and renamed; once every process's commit marker has
landed (a barrier of the process group; on the async writer thread,
which issues no collective, process 0's await of the markers before
LATEST names the save stands for it), process 0 removes the shard
and marker files of a larger job that wrote the same directory before
and writes the manifest, with ``"nprocs"`` the process count, last.

Reading is ``ShardedCheckpoint`` (manifest plus lazily loaded pieces);
placing an entry onto the live mesh, each target box assembled from the
saved boxes it intersects, is ``resilience/reshard.py``'s
``Resharder``.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..parallel.shardings import spec_json

_SEP = "##"  # key ## flat-device-index [## idx]
_P = "p|"
_S = "s|"
_B = "b|"

FORMAT = "singa-tpu-sharded-v1"


@dataclasses.dataclass(frozen=True)
class RankShards:
    """An array laid over the data axis: ``parts[i]`` is rank
    ``first + i``'s slice along ``dim`` (``torch.chunk`` order; equal
    lengths) of ``width`` ranks (0: ``len(parts)``, every rank's)."""

    parts: tuple
    dim: int
    first: int = 0
    width: int = 0

    @property
    def shape(self) -> tuple[int, ...]:
        shape = list(self.parts[0].shape)
        shape[self.dim] *= self.width or len(self.parts)
        return tuple(shape)


def _flatten(params, state, buffers) -> dict:
    flat = {_P + n: a for n, a in params.items()}
    for n, slots in (state or {}).items():
        for s, a in slots.items():
            flat[f"{_S}{n}|{s}"] = a
    flat.update({_B + n: a for n, a in (buffers or {}).items()})
    return flat


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _np_dtype_name(arr) -> str:
    if isinstance(arr, torch.Tensor):
        return str(torch.empty(0, dtype=arr.dtype).numpy().dtype)
    return str(np.asarray(arr).dtype)


def _full_box(shape) -> np.ndarray:
    box = [[0, int(d)] for d in shape] or [[0, 1]]
    return np.asarray(box, dtype=np.int64)


def save_sharded(
    path: str,
    step: int,
    params: dict,
    state: dict | None = None,
    buffers: dict | None = None,
    streams: dict[str, int] | None = None,
    *,
    proc: int = 0,
    nprocs: int = 1,
    manifest_extra: dict | None = None,
    barrier: bool = True,
) -> str:
    """Write process ``proc``'s shard and commit marker of one save of
    ``nprocs`` processes, and, in process 0, the manifest. Every value
    is a tensor or numpy array (replicated: written once, by process
    0) or a :class:`RankShards` (one entry per rank of this process).
    Every process of the group calls it at the same step.
    ``manifest_extra`` merges extra promises into the manifest: the
    replica engine's ``{"sidecar": True}``, which makes retention demand
    its ``.server`` sidecar and the sidecar's commit marker.

    Across processes two barriers of the process group order the save:
    every marker before the manifest, the manifest before any process
    goes on. ``barrier=False`` leaves them out, for a caller that must
    issue no collective (the async writer thread, beside a step loop
    that issues its own): the save is then ordered as the JAX package
    orders it, by process 0 awaiting every commit marker before LATEST
    names the save (``coord.await_commits``); nothing reads it before."""
    from ..resilience.coord import COMMIT_VERSION, write_commit
    from ..resilience.retention import remove_stale_shards

    flat = _flatten(params, state, buffers)
    os.makedirs(path, exist_ok=True)
    entries: dict[str, np.ndarray] = {}
    meta: dict[str, dict] = {}
    for key, arr in flat.items():
        if isinstance(arr, RankShards):
            shape = arr.shape
            meta[key] = {"shape": list(shape),
                         "dtype": _np_dtype_name(arr.parts[0]),
                         "spec": spec_json(arr.dim)}
            for r, part in enumerate(arr.parts, start=arr.first):
                box = _full_box(shape)
                c = part.shape[arr.dim]
                box[arr.dim] = [r * c, (r + 1) * c]
                entries[f"{key}{_SEP}{r}"] = _host(part)
                entries[f"{key}{_SEP}{r}{_SEP}idx"] = box
            continue
        meta[key] = {"shape": list(arr.shape),
                     "dtype": _np_dtype_name(arr), "spec": spec_json(None)}
        if proc:
            continue
        entries[f"{key}{_SEP}0"] = _host(arr)
        entries[f"{key}{_SEP}0{_SEP}idx"] = _full_box(arr.shape)

    shard_file = os.path.join(path, f"proc_{proc}.npz")
    with open(shard_file + ".tmp", "wb") as f:
        np.savez(f, **entries)
    os.replace(shard_file + ".tmp", shard_file)
    # the marker after the shard: a present marker always describes a
    # fully written shard
    write_commit(path, proc)
    if nprocs > 1 and barrier:
        import torch.distributed as dist

        # every process's marker has landed before the manifest names it
        dist.barrier()
    if proc == 0:
        # a re-save into a directory a larger job wrote must not leave
        # its proc_k files behind: the manifest names nprocs of them
        remove_stale_shards(path, nprocs)
        manifest = {
            "format": FORMAT,
            "step": int(step),
            "streams": dict(streams or {}),
            "nprocs": int(nprocs),
            "commit": COMMIT_VERSION,
            "arrays": meta,
            **(manifest_extra or {}),
        }
        mpath = os.path.join(path, "manifest.json")
        with open(mpath + ".tmp", "w") as f:
            json.dump(manifest, f)
        os.replace(mpath + ".tmp", mpath)
    if nprocs > 1 and barrier:
        # no process reads the save before its manifest is there
        dist.barrier()
    return path


def is_sharded_checkpoint(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(
        os.path.join(path, "manifest.json")
    )


class ShardedCheckpoint:
    """Reader: manifest + lazy shard-file access (the JAX package's)."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, "manifest.json")) as f:
            self.manifest = json.load(f)
        if self.manifest.get("format") != FORMAT:
            raise ValueError(f"{path!r}: not a singa-tpu sharded checkpoint")
        self.step: int = self.manifest["step"]
        self.streams: dict[str, int] = self.manifest.get("streams", {})
        # exactly the manifest's proc files, all present: a torn
        # multi-process save must fail here, not zero-fill on assembly
        nprocs = int(self.manifest.get("nprocs", 1))
        wanted = [f"proc_{k}.npz" for k in range(nprocs)]
        missing = [
            f for f in wanted if not os.path.exists(os.path.join(path, f))
        ]
        if missing:
            raise ValueError(
                f"{path!r}: incomplete sharded checkpoint — missing "
                f"{missing} (manifest expects {nprocs} processes)"
            )
        self._files = [np.load(os.path.join(path, f)) for f in wanted]
        # key -> [(file, entry, box)]
        self._index: dict[str, list] = {}
        for z in self._files:
            for entry in z.files:
                parts = entry.split(_SEP)
                if parts[-1] == "idx":
                    continue
                key = parts[0]
                self._index.setdefault(key, []).append(
                    (z, entry, z[f"{entry}{_SEP}idx"])
                )

    def keys(self) -> list[str]:
        return sorted(self.manifest["arrays"])

    def pieces(self, key: str) -> list:
        """[(npz file, entry name, index box)] for every saved shard of
        ``key``, across all proc files (the resharder's raw feed)."""
        return self._index.get(key, [])

    def assemble(self, key: str) -> np.ndarray:
        """Host-assembled global array (the slow path, and the tests')."""
        info = self.manifest["arrays"][key]
        out = np.zeros(tuple(info["shape"]), dtype=np.dtype(info["dtype"]))
        for z, entry, box in self._index.get(key, []):
            if out.ndim == 0:
                out = z[entry].reshape(())
                continue
            sl = tuple(slice(int(a), int(b)) for a, b in box[: out.ndim])
            out[sl] = z[entry]
        return out

    def close(self) -> None:
        for z in self._files:
            z.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def param_key(name: str) -> str:
    return _P + name


def state_key(name: str, slot: str) -> str:
    return f"{_S}{name}|{slot}"


def buffer_key(name: str) -> str:
    return _B + name
