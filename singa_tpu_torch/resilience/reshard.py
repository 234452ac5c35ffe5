"""Elastic restore: place a sharded checkpoint onto any data x model
mesh, and the serving restore of a saved param tree.

Counterpart of ``singa_tpu/resilience/reshard.py``. A sharded save
(``trainer/sharded_ckpt.py``) records, per array, its global shape, its
PartitionSpec and each saved shard's global index box, whichever package
and whichever mesh wrote it. ``Resharder.place_boxes`` puts any boxes
of one entry onto the live mesh's ranks (the whole array, a model
piece, a zero chunk inside one, a padded tail past the saved shape,
which reads zeros). Each target rank's box is assembled on the host
from the saved pieces it intersects and nothing more, so the largest
host buffer is one target shard, never the whole array unless the
target holds it whole. Where the saved layout is the live one (the same
width and spec, as a same-topology resume always has) each box is
exactly one saved piece. ``resharded_keys`` records
the entries whose target boxes differ from the saved ones (4 ranks ->
2, 2 -> 4, a JAX save's virtual devices, a sharded slot restored into a
replicated update).

Restored values are the saved ones to the bit: re-slicing moves bytes,
never math. ``hostable`` and ``check_manifest`` are the admission check
(a spec naming an axis the target lacks, or a dim with fewer elements
than the target width wants shards, is refused with ``ReshardError``
before anything is placed); ``checkpoint_nprocs`` reads a save's
process count.

``load_serving_params`` is what a fleet host's ``checkpoint:`` overlay
and the rollout controller's staging call: a checkpoint folder (through
its LATEST marker), an npz save or a sharded one onto the serving
host's param tree.
"""

from __future__ import annotations

import os

import numpy as np
import torch


class ReshardError(ValueError):
    """The target mesh cannot host this checkpoint's arrays."""


# ---------------------------------------------------------------------------
# admission: can this mesh host that manifest?
# ---------------------------------------------------------------------------


def _spec_dim_axes(entry) -> list[str]:
    """Mesh axis names one PartitionSpec dim entry pins (JSON form:
    None, a name, or a list of names)."""
    if entry is None:
        return []
    if isinstance(entry, (list, tuple)):
        return [str(a) for a in entry]
    return [str(entry)]


def hostable(
    shape: tuple[int, ...] | list[int],
    spec: list | None,
    axis_widths: dict[str, int],
) -> str | None:
    """None when ``axis_widths`` can host a re-scatter of an entry saved
    with ``spec`` at global ``shape``; else the reason: the spec names a
    mesh axis the target lacks, or a dim holds fewer elements than the
    named axes' target width wants shards."""
    if spec is None:
        return None  # host value / replicated: any mesh hosts it
    for d, (dim, entry) in enumerate(zip(tuple(shape), spec)):
        axes = _spec_dim_axes(entry)
        if not axes:
            continue
        unknown = [a for a in axes if a not in axis_widths]
        if unknown:
            return (
                f"dim {d} is sharded over mesh axis(es) "
                f"{', '.join(map(repr, unknown))} that the target mesh "
                f"lacks (axes: {sorted(axis_widths)})"
            )
        width = 1
        for a in axes:
            width *= max(1, int(axis_widths[a]))
        if width > 1 and dim < width:
            return (
                f"dim {d} has {dim} element(s) but the target width of "
                f"axis(es) {'*'.join(axes)} is {width} — more shards "
                "than elements, beyond even the pad/replicate fallback"
            )
    return None


def check_manifest(
    manifest: dict, axis_widths: dict[str, int]
) -> dict[str, str]:
    """{entry key: reason} for every manifest array the target mesh
    cannot host (empty dict = the whole checkpoint reshard-restores)."""
    problems: dict[str, str] = {}
    for key, info in manifest.get("arrays", {}).items():
        reason = hostable(
            tuple(info.get("shape", ())), info.get("spec"), axis_widths
        )
        if reason is not None:
            problems[key] = reason
    return problems


def checkpoint_nprocs(path: str) -> int | None:
    """The process count a sharded checkpoint dir was written by (its
    manifest's ``nprocs``); None for npz checkpoints / unreadable
    manifests."""
    import json

    try:
        with open(os.path.join(path, "manifest.json")) as f:
            return int(json.load(f).get("nprocs", 1))
    except (OSError, ValueError, TypeError):
        return None


# ---------------------------------------------------------------------------
# the resharder
# ---------------------------------------------------------------------------


def _assemble_box(
    target_box: np.ndarray,
    pieces: list,
    shape: tuple[int, ...],
    dtype,
    load,
) -> np.ndarray:
    """Assemble ONE target shard box from the intersecting saved pieces:
    the largest host buffer this allocates is one target shard.
    ``pieces`` is [(index, saved box)]; piece bytes are pulled through
    ``load(index)`` only once the boxes overlap."""
    if not shape:  # scalar: any piece IS the value
        for i, _ in pieces:
            return np.asarray(load(i), dtype=dtype).reshape(())
        return np.zeros((), dtype=dtype)
    ndim = len(shape)
    tb = np.asarray(target_box[:ndim], dtype=np.int64)
    out = np.zeros(tuple(int(b - a) for a, b in tb), dtype=dtype)
    for i, sbox in pieces:
        sb = np.asarray(sbox[:ndim], dtype=np.int64)
        lo = np.maximum(tb[:, 0], sb[:, 0])
        hi = np.minimum(tb[:, 1], sb[:, 1])
        if np.any(lo >= hi):
            continue  # no overlap: the piece's bytes are never read
        dst = tuple(
            slice(int(a - t0), int(b - t0))
            for a, b, t0 in zip(lo, hi, tb[:, 0])
        )
        src = tuple(
            slice(int(a - s0), int(b - s0))
            for a, b, s0 in zip(lo, hi, sb[:, 0])
        )
        out[dst] = np.asarray(load(i)[src], dtype=dtype)
    return out


class Resharder:
    """Restore a ``ShardedCheckpoint`` onto the live mesh's ranks.

    ``axis_widths`` (the target mesh's {axis: width}) arms the admission
    check: construction raises ``ReshardError`` listing every entry the
    mesh cannot host. ``place_boxes`` restores entry by entry, each
    target box from the saved boxes it intersects."""

    def __init__(self, ckpt, axis_widths: dict[str, int] | None = None):
        self.ckpt = ckpt
        #: entries whose target boxes differ from the saved ones
        self.resharded_keys: list[str] = []
        if axis_widths is not None:
            problems = check_manifest(ckpt.manifest, axis_widths)
            if problems:
                lines = "; ".join(
                    f"{k}: {r}" for k, r in sorted(problems.items())
                )
                raise ReshardError(
                    f"checkpoint {ckpt.path!r} cannot be resharded onto "
                    f"a mesh with axis widths {axis_widths}: {lines}"
                )

    @property
    def saved_nprocs(self) -> int:
        return int(self.ckpt.manifest.get("nprocs", 1))

    def place_boxes(self, key: str, boxes, devices,
                    dtype: torch.dtype | None = None) -> list:
        """Manifest entry ``key``'s global index boxes ``boxes`` ((ndim,
        2) [start, stop) each; a box may reach past the saved shape,
        into a padded tail, which reads zeros) on ``devices``, one
        tensor per box, cast to ``dtype`` when given. Equal boxes on one
        device share one tensor. A None device (a rank of another
        process) gets None and nothing is assembled for it."""
        ck = self.ckpt
        info = ck.manifest["arrays"][key]
        shape = tuple(info["shape"])
        np_dtype = np.dtype(info["dtype"])
        raw = ck.pieces(key)  # [(npz file, entry name, box)]
        loaded: dict[int, np.ndarray] = {}

        def load(i: int) -> np.ndarray:
            if i not in loaded:
                z, entry, _ = raw[i]
                loaded[i] = z[entry]
            return loaded[i]

        ndim = max(1, len(shape))

        def box_key(box) -> bytes:
            return np.asarray(box[:ndim], dtype=np.int64).tobytes()

        saved_boxes = [
            (i, np.asarray(box)) for i, (_, _, box) in enumerate(raw)
        ]
        saved_keys = {box_key(box) for _, box in saved_boxes}
        if any(box_key(tbox) not in saved_keys for tbox in boxes):
            self.resharded_keys.append(key)
        host: dict[bytes, np.ndarray] = {}
        placed: dict[tuple, torch.Tensor] = {}
        out = []
        for tbox, dev in zip(boxes, devices):
            if dev is None:
                out.append(None)
                continue
            kb = box_key(tbox)
            if (kb, dev) not in placed:
                if kb not in host:
                    host[kb] = _assemble_box(np.asarray(tbox), saved_boxes,
                                             shape, np_dtype, load)
                placed[kb, dev] = torch.from_numpy(host[kb]).to(
                    device=dev, dtype=dtype)
            out.append(placed[kb, dev])
        return out

    def summary(self) -> str | None:
        """One line naming what was re-sliced; None when every entry
        kept its saved boxes."""
        if not self.resharded_keys:
            return None
        n = len(self.resharded_keys)
        preview = ", ".join(sorted(self.resharded_keys)[:4])
        more = "" if n <= 4 else f", +{n - 4} more"
        return (
            f"resharded {n} entr{'y' if n == 1 else 'ies'} from the "
            f"{self.saved_nprocs}-process layout ({preview}{more})"
        )


# ---------------------------------------------------------------------------
# in-process serving restore
# ---------------------------------------------------------------------------


def load_serving_params(path: str, init_params: dict) -> tuple[dict, dict]:
    """Overlay a trained save's params onto ``init_params`` (the port's
    ``init_lm`` tree) by flat name -> ``(params, info)``.

    - a checkpoint FOLDER resolves through its LATEST marker (newest
      complete save wins, torn tails skipped: ``retention``);
    - an npz checkpoint (either package's format) overlays by name:
      names the model lacks are ignored, absent names keep their init,
      and a shape mismatch raises;
    - a sharded checkpoint directory restores the same way through
      ``Resharder.place_boxes`` onto each init param's device, whatever
      the number of processes, devices or ranks that wrote it.

    Restored values are tensors on each init param's device and dtype.
    Raises ``ReshardError`` on an absent or unhostable save: a serving
    host must never boot on silently wrong weights."""
    if os.path.isdir(path) and not os.path.exists(
            os.path.join(path, "manifest.json")):
        from .retention import resolve_latest

        resolved = resolve_latest(path)
        if resolved is None:
            raise ReshardError(
                f"checkpoint folder {path!r} holds no complete save")
        return load_serving_params(resolved, init_params)

    out = dict(init_params)
    restored = 0
    if os.path.isdir(path):
        from ..trainer.sharded_ckpt import ShardedCheckpoint, param_key

        with ShardedCheckpoint(path) as ck:
            rs = Resharder(ck)
            saved = set(ck.keys())
            for name, live in init_params.items():
                key = param_key(name)
                if key not in saved:
                    continue
                shape = tuple(ck.manifest["arrays"][key]["shape"])
                if shape != tuple(live.shape):
                    raise ReshardError(
                        f"checkpoint {path!r}: param {name!r} shape "
                        f"{shape} != model shape {tuple(live.shape)}")
                (out[name],) = rs.place_boxes(
                    key, [[[0, d] for d in shape] or [[0, 1]]],
                    [live.device], dtype=live.dtype)
                restored += 1
            info = {
                "path": path,
                "step": int(ck.step),
                "format": "sharded",
                "saved_nprocs": rs.saved_nprocs,
                "restored": restored,
                "resharded": len(rs.resharded_keys),
            }
        return out, info

    from ..trainer.checkpoint import load_checkpoint

    step, ck_params, _, _ = load_checkpoint(path)
    for name, arr in ck_params.items():
        if name not in out:
            continue
        live = out[name]
        if tuple(arr.shape) != tuple(live.shape):
            raise ReshardError(
                f"checkpoint {path!r}: param {name!r} shape "
                f"{tuple(arr.shape)} != model shape {tuple(live.shape)}")
        out[name] = torch.from_numpy(np.array(arr)).to(
            device=live.device, dtype=live.dtype)
        restored += 1
    return out, {
        "path": path,
        "step": int(step),
        "format": "npz",
        "saved_nprocs": 1,
        "restored": restored,
        "resharded": 0,
    }
