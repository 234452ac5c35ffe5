"""Paged-KV block migration: one sequence's serving state as ONE bulk
message between engines, the PyTorch counterpart of
``singa_tpu/serve/fleet/migrate.py``.

An export gathers the sequence's blocks from the pool through its block
table (``Engine.export_slot``), the frame carries ``(blocks, lanes,
emitted tokens, digest chain)`` in one npz container plus a JSON
metadata record, and an import scatters the bytes into the peer pool's
fresh blocks (``Engine.import_slot``). Copying pool bytes and the lanes
exactly copies the stream's future: an imported sequence continues
bitwise what the exporter would have produced.

Frames cross packages. The format tags and the npz layout are the JAX
package's, and the rule for which tag a frame gets is what the reader
can continue exactly:

- a greedy frame of a float32 pool is ``singa-tpu-migrate-v1`` with a
  zero key in ``rng`` (greedy decode never reads it): the JAX engine
  imports it and continues the stream;
- any other frame (a temperature slot, whose stream lives in a
  ``torch.Generator`` state that ships in the ``gen_state`` entry, or
  a pool of another dtype) is ``singa-tpu-torch-migrate-v1``: the JAX
  package's ``deserialize`` rejects the tag instead of sampling from a
  zero key or casting the bytes.

This package reads both tags, and rejects a JAX frame of a temperature
slot: its threefry key cannot continue here.

The prefix-cache frames (``cache_fetch``: a prompt's digest chain;
``cache_ship``: matched blocks' K/V plus their digests) and the weight
frame (one param version with an end-to-end CRC32) are the JAX
package's byte for byte.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import zlib

import numpy as np
import torch

#: wire-format tags: the JAX package's, and this package's for frames
#: the JAX engine cannot continue (see the module docstring)
MIGRATE_FORMAT = "singa-tpu-migrate-v1"
TORCH_MIGRATE_FORMAT = "singa-tpu-torch-migrate-v1"
#: prefix-cache frames (cache_fetch request / cache_ship reply)
FETCH_FORMAT = "singa-tpu-cachefetch-v1"
SHIP_FORMAT = "singa-tpu-cacheship-v1"
#: weight frames: one bulk message per staged version
WEIGHT_FORMAT = "singa-tpu-weights-v1"


@dataclasses.dataclass
class MigratedSequence:
    """One in-flight sequence on the wire: the request's identity and
    budget bookkeeping plus the engine's exported device state
    (``payload``: trimmed per-layer K/V blocks, lanes, digest chain and,
    for a temperature slot, its generator state; ``Engine.export_slot``)."""

    rid: int
    prompt: np.ndarray
    emitted: list
    max_new_tokens: int
    temperature: float
    seed: int
    eos: int | None
    payload: dict
    #: submit-time monotonic stamp (meaningful within one process)
    enqueue_mono: float = 0.0
    #: params version the exporter's K/V bytes were written under
    version: int = 0

    @property
    def n_blocks(self) -> int:
        return int(self.payload["k"].shape[1])


def export_sequence(engine, req, slot: int) -> MigratedSequence:
    """Gather ``slot``'s serving state for request ``req`` into a
    MigratedSequence. The slot keeps serving; the caller retires it once
    the frame is handed on."""
    return MigratedSequence(
        rid=req.rid,
        prompt=np.asarray(req.prompt, np.int32),
        emitted=list(req.tokens),
        max_new_tokens=int(req.max_new_tokens),
        temperature=float(req.temperature),
        seed=int(req.seed),
        eos=req.eos,
        payload=engine.export_slot(slot),
        enqueue_mono=float(req.enqueue_mono),
        version=int(engine.params_version),
    )


def import_sequence(engine, slot: int, mseq: MigratedSequence) -> dict:
    """Install ``mseq`` into dead ``slot`` of ``engine`` (raises
    PoolExhausted with nothing touched: import backpressure). -> the
    engine's import info ({"blocks", "shared", "registered"})."""
    return engine.import_slot(slot, mseq.payload)


# ---------------------------------------------------------------------------
# wire codec
# ---------------------------------------------------------------------------


def _frame(meta: dict, **arrays) -> bytes:
    """One npz container: the JSON metadata entry and the arrays."""
    buf = io.BytesIO()
    np.savez(
        buf,
        meta=np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8),
        **arrays,
    )
    return buf.getvalue()


def _meta(z, *formats) -> dict:
    """The frame's metadata; raises ValueError on a foreign format."""
    meta = json.loads(bytes(z["meta"]).decode("utf-8"))
    if meta.get("format") not in formats:
        raise ValueError(
            f"frame format {meta.get('format')!r} is not "
            f"{' or '.join(map(repr, formats))}"
        )
    return meta


def serialize(mseq: MigratedSequence) -> bytes:
    """MigratedSequence -> one self-describing frame (see the module
    docstring for which format tag it gets)."""
    p = mseq.payload
    k = np.asarray(p["k"])
    jax_readable = float(p["temp"]) == 0.0 and k.dtype == np.float32
    meta = {
        "format": MIGRATE_FORMAT if jax_readable else TORCH_MIGRATE_FORMAT,
        "rid": mseq.rid,
        "emitted": [int(t) for t in mseq.emitted],
        "max_new_tokens": mseq.max_new_tokens,
        "temperature": mseq.temperature,
        "seed": mseq.seed,
        "eos": mseq.eos,
        # per-process perf_counter origin: another process re-stamps
        "enqueue_mono": mseq.enqueue_mono,
        "clock": os.getpid(),
        "version": int(mseq.version),
        "token": int(p["token"]),
        "pos": int(p["pos"]),
        "temp": float(p["temp"]),
        "chain": [d.hex() for d in p.get("chain") or ()],
    }
    arrays = {
        "prompt": np.asarray(mseq.prompt, np.int32),
        "k": k,
        "v": np.asarray(p["v"]),
        "rng": np.asarray(p["rng"], np.uint32),
    }
    if "gen_state" in p:
        meta["gen_device"] = p["gen_device"]
        arrays["gen_state"] = np.asarray(p["gen_state"], np.uint8)
    return _frame(meta, **arrays)


def deserialize(data: bytes) -> MigratedSequence:
    """Frame -> MigratedSequence. Raises ValueError on a foreign or
    future format, and on a JAX frame of a temperature slot (its
    threefry key cannot continue in a ``torch.Generator``)."""
    with np.load(io.BytesIO(data)) as z:
        meta = _meta(z, MIGRATE_FORMAT, TORCH_MIGRATE_FORMAT)
        if meta["format"] == MIGRATE_FORMAT and float(meta["temp"]) > 0.0:
            raise ValueError(
                f"migrate frame of rid {meta['rid']}: a temperature slot "
                "written by the JAX package (a threefry key; this "
                "package samples from a torch.Generator)"
            )
        payload = {
            "k": z["k"],
            "v": z["v"],
            "rng": z["rng"],
            "token": int(meta["token"]),
            "pos": int(meta["pos"]),
            "temp": float(meta["temp"]),
            "chain": [bytes.fromhex(h) for h in meta["chain"]],
        }
        if "gen_state" in z.files:
            payload["gen_state"] = z["gen_state"]
            payload["gen_device"] = meta["gen_device"]
        return MigratedSequence(
            rid=int(meta["rid"]),
            prompt=z["prompt"],
            emitted=list(meta["emitted"]),
            max_new_tokens=int(meta["max_new_tokens"]),
            temperature=float(meta["temperature"]),
            seed=int(meta["seed"]),
            eos=meta["eos"],
            payload=payload,
            enqueue_mono=(
                float(meta.get("enqueue_mono", 0.0))
                if meta.get("clock") == os.getpid() else 0.0
            ),
            version=int(meta.get("version", 0)),
        )


# ---------------------------------------------------------------------------
# prefix-cache frames
# ---------------------------------------------------------------------------


def serialize_fetch(rid: int, chain: list[bytes],
                    version: int = 0) -> bytes:
    """A ``cache_fetch``: the requesting engine's prompt digest chain and
    its live params ``version`` (JSON: digests are small)."""
    return json.dumps(
        {"format": FETCH_FORMAT, "rid": int(rid),
         "chain": [d.hex() for d in chain], "version": int(version)}
    ).encode("utf-8")


def deserialize_fetch(data: bytes) -> tuple[int, list[bytes], int]:
    """-> (rid, digest chain, requester's params version); raises
    ValueError on a foreign format."""
    meta = json.loads(data.decode("utf-8"))
    if meta.get("format") != FETCH_FORMAT:
        raise ValueError(
            f"cache_fetch format {meta.get('format')!r} != {FETCH_FORMAT!r}"
        )
    return (
        int(meta["rid"]),
        [bytes.fromhex(h) for h in meta["chain"]],
        int(meta.get("version", 0)),
    )


def serialize_ship(rid: int, chain: list[bytes], k, v,
                   version: int = 0) -> bytes:
    """A ``cache_ship``: the matched prefix's digests and its blocks'
    per-layer K/V (``k``/``v`` shaped (L, n, H, BL, D), from
    ``Engine.export_blocks``) as one frame; ``n`` may be 0."""
    meta = {"format": SHIP_FORMAT, "rid": int(rid),
            "chain": [d.hex() for d in chain], "version": int(version)}
    return _frame(meta, k=np.asarray(k), v=np.asarray(v))


def deserialize_ship(data: bytes) -> dict:
    """-> {"rid", "chain", "k", "v", "version"}; raises ValueError on a
    foreign format."""
    with np.load(io.BytesIO(data)) as z:
        meta = _meta(z, SHIP_FORMAT)
        return {
            "rid": int(meta["rid"]),
            "chain": [bytes.fromhex(h) for h in meta["chain"]],
            "k": z["k"],
            "v": z["v"],
            "version": int(meta.get("version", 0)),
        }


# ---------------------------------------------------------------------------
# weight frames
# ---------------------------------------------------------------------------


def _host(a) -> np.ndarray:
    """A param (tensor on any device, or array) as a contiguous numpy
    array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a))


def _crc(arrays) -> int:
    crc = 0
    for a in arrays:
        crc = zlib.crc32(a.tobytes(), crc)
    return crc & 0xFFFFFFFF


def serialize_weights(version: int, params: dict) -> bytes:
    """One param version as one frame: sorted names, every array, and a
    CRC32 over the packed bytes, so a torn or bit-flipped frame is
    rejected at ``deserialize_weights`` and never staged."""
    names = sorted(params)
    arrays = [_host(params[n]) for n in names]
    meta = {"format": WEIGHT_FORMAT, "version": int(version),
            "names": names, "crc32": _crc(arrays)}
    return _frame(meta, **{f"w{i:04d}": a for i, a in enumerate(arrays)})


def deserialize_weights(data: bytes) -> tuple[int, dict]:
    """-> (version, {name: numpy array}); raises ValueError on a foreign
    format or a CRC mismatch."""
    with np.load(io.BytesIO(data)) as z:
        meta = _meta(z, WEIGHT_FORMAT)
        names = list(meta["names"])
        arrays = [np.ascontiguousarray(z[f"w{i:04d}"])
                  for i in range(len(names))]
    crc = _crc(arrays)
    if crc != int(meta["crc32"]):
        raise ValueError(
            f"torn weight frame v{meta.get('version')}: CRC mismatch "
            f"({crc:#010x} != {int(meta['crc32']):#010x})"
        )
    return int(meta["version"]), dict(zip(names, arrays))
