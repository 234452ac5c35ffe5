"""The replica engine's consistency protocols: EASGD and RandomSync.

Counterpart of ``singa_tpu/parallel/consistency.py``. The reference
trains one model replica per worker group and reconciles the replicas
through a parameter server running one of two protocols
(src/utils/param.cc:100-256), throttled by a bandwidth-adaptive sample
ratio (src/worker/param_manager.cc:85-93) on the SyncNow cadence
(param_manager.cc:155-159). As in the JAX package the server tier
dissolves into functions over dicts of tensors whose leading axis is
the replica axis, replica order 0..R-1 being the order in which the
server handles the workers' messages. The server handled them serially
under a per-param lock (src/server/server.cc:110-143), so each round is
order-dependent exactly like the reference: replica i sees the center
already moved by replicas 0..i-1.

Protocols:

- **Elastic (EASGD)**: the worker ships its whole vector w with moving
  rate alpha; the server computes diff = alpha*(w - s), absorbs it
  (s += diff) and returns it; the worker subtracts it (w -= diff)
  (param.cc:216-256).
- **RandomSync**: the worker samples floor(ratio*n) coordinates without
  replacement (:func:`sample_sync_indices`, the JAX package's numpy
  draw, so both packages sample the same coordinates from one seed),
  ships delta = w[idx] - snapshot[idx]; the server adds each delta and
  returns its value before the update, old; the worker reconciles
  w[idx] = old + delta and refreshes its snapshot (param.cc:112-196).
  Three forms, as in the JAX package: every coordinate at ratio 1 (a
  prefix sum over the replica axis), a dense prefix sum over an (R, n)
  delta field when R*n is at most ``DENSE_PREFIX_MAX_ELEMS``, and the
  server's serial loop (:func:`_scan_random_sync`) above it. The prefix
  and the loop add the same deltas in another association, so they
  agree within float32 rounding.
- **hogwild** (UpdaterProto.hogwild) was lock-free sharing among the
  executor threads of one process. It has no counterpart: the flag is
  parsed and ignored, as in the JAX package.

Every function is functional: it returns new tensors and leaves its
inputs as they were. The Trainer copies the results back into its
replicas' tensors in place (``trainer/replica.py``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

#: partial-coverage dense-prefix budget, in elements of the (R, n) delta
#: field (float32: x4 bytes). Above it random_sync runs the serial loop,
#: whose largest transient is the (R, m) sampled field. Read once, at
#: import (``SINGA_TPU_RS_DENSE_ELEMS``), as in the JAX package.
DENSE_PREFIX_MAX_ELEMS = int(
    os.environ.get("SINGA_TPU_RS_DENSE_ELEMS", 64 * 1024 * 1024)
)


def sync_now(step: int, sync_frequency: int, warmup_steps: int) -> bool:
    """ParamManager::SyncNow (param_manager.cc:155-159): every
    ``sync_frequency`` steps once past warmup. ``step`` is the step just
    completed."""
    return (
        sync_frequency > 0
        and (step + 1) % sync_frequency == 0
        and step > warmup_steps
    )


def sync_ratio(
    compute_time_s: float,
    model_mb: float,
    nworkers: int,
    nservers: int,
    bandwidth_mbps: float,
) -> float:
    """ParamManager::SyncConfig (param_manager.cc:85-93): the
    bandwidth-adaptive RandomSync sample ratio. The cluster absorbs
    ``bandwidth * nservers`` MB/s of sync traffic, the workers produce
    ``model_mb * nworkers / compute_time`` MB/s; their ratio is the
    fraction of coordinates each round can afford, clamped to 1."""
    if compute_time_s <= 0 or model_mb <= 0:
        return 1.0
    produced = model_mb * nworkers / compute_time_s
    ratio = bandwidth_mbps * max(nservers, 1) / produced
    return float(min(ratio, 1.0))


def elastic_sync(replicas: dict, center: dict, alpha: float):
    """One EASGD round: every replica syncs with the center, in replica
    order. ``replicas`` maps each param to its (R, ...) stack, ``center``
    to the server's tensor. -> (replicas, center), new tensors.
    ElasticParam::{GenSyncMsgFromWorker, HandleSyncMsg,
    ParseSyncMsgFromPS} (param.cc:216-256): for each replica in turn,
    diff = alpha*(w - s); s += diff; w -= diff."""
    new_r, new_c = {}, {}
    for name, c in center.items():
        w = replicas[name].clone()
        for i in range(w.shape[0]):
            diff = alpha * (w[i] - c)
            c = c + diff
            w[i] = w[i] - diff
        new_r[name], new_c[name] = w, c
    return new_r, new_c


def random_sync(replicas: dict, snapshots: dict, center: dict, indices,
                full_coverage: bool = False):
    """One RandomSync round over sampled coordinates.

    ``indices`` maps each param to an integer (R, m) tensor of flat
    coordinates, unique within each row (:func:`sample_sync_indices`).
    Per replica i and param (param.cc:112-196):

        delta = w[idx] - snapshot[idx]        (GenSyncMsgFromWorker)
        old   = s[idx];  s[idx] += delta      (HandleSyncMsg)
        w[idx] = old + delta;  snapshot[idx] = w[idx]  (ParseSyncMsgFromPS)

    so each replica takes exactly the deltas of the replicas handled
    before it. At coordinate x replica i's new value is c0[x] + the sum
    of delta_j[x] over j <= i that sampled x, and the new center is c0
    plus the whole sum: a prefix sum over the replica axis, which the
    full and the dense forms compute with ``torch.cumsum``.

    ``full_coverage=True`` is ratio 1: the caller asserts that every
    replica syncs every coordinate, and ``indices`` may be None. Partial
    coverage takes the dense form while R*n is at most
    ``DENSE_PREFIX_MAX_ELEMS``, else the serial loop.

    -> (replicas, snapshots, center), new tensors."""
    new_r, new_s, new_c = {}, {}, {}
    for name, c in center.items():
        shape = replicas[name].shape
        r = shape[0]
        n = c.numel()
        w = replicas[name].reshape(r, n)
        snap = snapshots[name].reshape(r, n)
        c0 = c.reshape(-1)
        if full_coverage:
            prefix = torch.cumsum(w - snap, dim=0)
            new_vals = c0[None, :] + prefix
            new_r[name] = new_vals.reshape(shape)
            new_s[name] = new_vals.clone().reshape(shape)
            new_c[name] = (c0 + prefix[-1]).reshape(c.shape)
        elif r * n <= DENSE_PREFIX_MAX_ELEMS:
            ix = indices[name].to(w.device, torch.int64)
            delta = w.gather(1, ix) - snap.gather(1, ix)
            dense = torch.zeros_like(w).scatter_(1, ix, delta)
            prefix = torch.cumsum(dense, dim=0)
            upd = (c0[None, :] + prefix).gather(1, ix)
            new_r[name] = w.scatter(1, ix, upd).reshape(shape)
            new_s[name] = snap.scatter(1, ix, upd).reshape(shape)
            new_c[name] = (c0 + prefix[-1]).reshape(c.shape)
        else:
            wi, si, cn = _scan_random_sync(w, snap, c0, indices[name])
            new_r[name] = wi.reshape(shape)
            new_s[name] = si.reshape(shape)
            new_c[name] = cn.reshape(c.shape)
    return new_r, new_s, new_c


def _scan_random_sync(w, snap, c0, ix):
    """The server's serial loop as written: replica i's sampled deltas
    reach the center before replica i+1's message is handled (the
    per-param lock, server.cc:110-143). Its largest transient is the
    (R, m) gathered field; random_sync runs it when the dense (R, n)
    field would exceed DENSE_PREFIX_MAX_ELEMS."""
    w, snap, c = w.clone(), snap.clone(), c0.clone()
    ix = ix.to(w.device, torch.int64)
    for i in range(w.shape[0]):
        j = ix[i]
        delta = w[i, j] - snap[i, j]
        new = c[j] + delta  # the server's value before the update + own delta
        c[j] = new
        w[i, j] = new
        snap[i, j] = new
    return w, snap, c


def sample_sync_indices(
    rng: np.random.RandomState,
    shapes: dict[str, tuple],
    nreplicas: int,
    ratio: float,
) -> dict[str, np.ndarray]:
    """The host-side coordinate draw of one RandomSync round, the JAX
    package's to the bit: each replica draws its own coordinates (the
    reference seeds each worker from the wall clock, param.cc:146), m =
    floor(ratio*n) of them (param.cc:148's truncation), at least one. At
    ratio 1 every row is arange(n), drawn from nothing."""
    out: dict[str, np.ndarray] = {}
    for name, shape in shapes.items():
        n = int(np.prod(shape))
        if ratio >= 1.0:
            out[name] = np.broadcast_to(
                np.arange(n, dtype=np.int32), (nreplicas, n)
            )
            continue
        m = max(1, int(n * ratio))
        rows = [
            np.sort(rng.choice(n, size=m, replace=False))
            for _ in range(nreplicas)
        ]
        out[name] = np.stack(rows).astype(np.int32)
    return out
