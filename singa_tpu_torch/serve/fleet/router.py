"""Front-door request router, the PyTorch counterpart of
``singa_tpu/serve/fleet/router.py``: least-loaded placement with prefix
affinity over per-host occupancy feedback.

Each host publishes an occupancy snapshot (free slots, free blocks,
queue depth and, with the prefix cache on, a capped list of its cached
block digests); the router places each prompt by

  1. PREFIX AFFINITY: the prefill-capable host whose published digests
     cover the longest prefix of the prompt's full-block chain; ties
     and zero affinity fall through to
  2. LEAST-LOADED: shallowest queue, then most free slots, then most
     free blocks, then name order (total and deterministic).

A stale snapshot costs placement quality, never correctness. Every
placement emits a ``route`` event on the router's flight recorder.
``encode_request``/``decode_request`` are the request message body,
byte for byte the JAX package's: either package's host decodes the
other's front door.
"""

from __future__ import annotations

import json

import numpy as np

from ..kv_pool import PrefixCache

#: roles that accept routed prompts (run admission + prefill)
PREFILL_CAPABLE = ("prefill", "unified")
#: roles that accept migrated sequences (run the decode tick)
DECODE_CAPABLE = ("decode", "unified")
#: every serving role — the set whose statuses carry a weight version
#: (Router.versions; drained tombstones fall outside it)
ROLES_WITH_VERSION = ("prefill", "decode", "unified")

#: cap on published cached-digest lists (a snapshot is feedback, not a
#: replica of the index; 4096 16-byte digests ~ 64 KiB of hex)
MAX_PUBLISHED_DIGESTS = 4096


def load_score(status: dict) -> tuple:
    """Sort key for least-loaded placement (smaller = preferred)."""
    return (
        int(status.get("queue_depth", 0)),
        -int(status.get("free_slots", 0)),
        -int(status.get("kv_blocks_free", 0)),
        str(status.get("host", "")),
    )


def chain_coverage(chain_hex: list[str], status: dict) -> int:
    """How many leading digests of a prompt's hex chain a host's
    published snapshot covers. The router's affinity policy ranks
    prefill-capable hosts by it; a fleet host ranks ALL peers by it to
    pick a ``cache_fetch`` target (any role may hold warm history —
    decode hosts register migrated and decode-written blocks too)."""
    cached = set(status.get("cached_digests") or ())
    n = 0
    for d in chain_hex:
        if d not in cached:
            break
        n += 1
    return n


class Router:
    """Placement policy over published host statuses. The router holds
    NO host references — it reads snapshots from the transport's
    status side channel and delivers requests as one-shot ``request``
    messages, so the same object fronts an in-process drill or a
    mailbox fleet of OS processes."""

    def __init__(self, transport, *, name: str = "router",
                 block_len: int = 0, recorder=None):
        self.transport = transport
        self.name = name
        #: block geometry for affinity hashing (0 = affinity off)
        self._chain = (
            PrefixCache(block_len).chain if block_len > 0 else None
        )
        self.recorder = recorder
        self.routed = 0
        self.affinity_hits = 0

    # -- feedback -------------------------------------------------------

    def _snapshots(self, roles) -> list[dict]:
        return sorted(
            (
                s
                for s in self.transport.statuses().values()
                if s.get("role") in roles
            ),
            key=load_score,
        )

    def _affinity(self, prompt, snapshots) -> tuple[str | None, int]:
        """(host with the longest cached block-prefix of ``prompt``,
        matched block count); (None, 0) when nothing matches."""
        if self._chain is None:
            return None, 0
        chain = [d.hex() for d in self._chain(np.asarray(prompt))]
        if not chain:
            return None, 0
        best, best_n = None, 0
        for s in snapshots:  # already least-loaded-sorted: ties break
            n = chain_coverage(chain, s)
            if n > best_n:
                best, best_n = s.get("host"), n
        return best, best_n

    # -- placement ------------------------------------------------------

    def route(self, prompt, rid: int | None = None) -> str:
        """Pick the host for one prompt (raises LookupError when no
        prefill-capable host has published status yet — the fleet is
        still booting; callers retry)."""
        snaps = self._snapshots(PREFILL_CAPABLE)
        if not snaps:
            raise LookupError(
                "no prefill-capable host has published status"
            )
        host, blocks = self._affinity(prompt, snaps)
        policy = "affinity"
        if host is None:
            host, policy = snaps[0].get("host"), "least_loaded"
        else:
            self.affinity_hits += 1
        self.routed += 1
        if self.recorder is not None:
            self.recorder.event(
                "route", step=self.routed, rid=rid, host=host,
                policy=policy, affinity_blocks=int(blocks),
            )
        return host

    def submit(self, req) -> str:
        """Route one scheduler Request and deliver it as a ``request``
        message to the chosen host. -> the host name."""
        host = self.route(req.prompt, rid=req.rid)
        self.transport.send(
            host, "request", encode_request(req), src=self.name
        )
        return host

    def versions(self) -> dict[str, int]:
        """Per-host weight version off published statuses (the live
        rollout's skew view: during a canary or a paused promotion the
        fleet is legitimately mixed-version, and the migration /
        cache-ship paths degrade any cross-version frame to cold
        prefill rather than splice two models into one stream). Hosts
        that predate the rollout channel publish no version and read
        as 0 — the pre-rollout contract."""
        return {
            s["host"]: int(s.get("version", 0))
            for s in self.transport.statuses().values()
            if s.get("host") and s.get("role") in ROLES_WITH_VERSION
        }


# ---------------------------------------------------------------------------
# request wire codec (the router -> host and drain-forward message body)
# ---------------------------------------------------------------------------


def encode_request(req) -> bytes:
    import os
    import time

    return json.dumps({
        "rid": int(req.rid),
        "prompt": [int(t) for t in np.asarray(req.prompt)],
        "max_new_tokens": int(req.max_new_tokens),
        "temperature": float(req.temperature),
        "seed": int(req.seed),
        "eos": req.eos,
        # submit-time stamp so queue-inclusive latency covers the
        # routing hop. perf_counter origins are per-process, so the
        # stamp is tagged with its clock domain: a same-process
        # receiver (in-process drills, bench) keeps it, a cross-
        # process receiver re-stamps at arrival instead of mixing
        # clock origins into garbage latencies
        "enqueue_mono": float(req.enqueue_mono) or time.perf_counter(),
        "clock": os.getpid(),
    }).encode("utf-8")


def decode_request(payload: bytes):
    import os

    from ..scheduler import Request

    d = json.loads(payload.decode("utf-8"))
    req = Request(
        rid=int(d["rid"]),
        prompt=np.asarray(d["prompt"], np.int32),
        max_new_tokens=int(d["max_new_tokens"]),
        temperature=float(d.get("temperature", 0.0)),
        seed=int(d.get("seed", 0)),
        eos=d.get("eos"),
    )
    req.enqueue_mono = (
        float(d.get("enqueue_mono", 0.0))
        if d.get("clock") == os.getpid() else 0.0
    )
    return req
