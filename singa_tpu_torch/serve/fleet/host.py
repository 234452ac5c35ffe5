"""Fleet host: one engine + scheduler wearing a role in a multi-host
serving fleet; the PyTorch counterpart of
``singa_tpu/serve/fleet/host.py``, over the port's Engine and Scheduler.
The messages, statuses and frames are the JAX package's, so a port host
and a JAX host serve in one fleet (a temperature slot's frame excepted:
fleet/migrate.py).

The reference binary picked Worker or Server by process rank
(src/main.cc:49-55); a fleet host picks ``prefill``, ``decode``, or
``unified`` the same way (``role_for_rank``, fed by the ``fleet {}``
conf block and ``-procsID``):

  prefill   runs admission + chunked prefill ONLY (the scheduler's
            decode phase is gated off): once a request's prompt is
            fully prefilled and its first token sampled, the filled
            sequence is EXPORTED — paged KV blocks, lanes, digest
            chain, one bulk message (fleet/migrate.py) — to the
            least-loaded decode-capable peer. Prefill is the
            compute-bound, batch-1 half of serving; giving it its own
            hosts keeps long prompts from ever stealing a decode
            tick (the disaggregation argument).
  decode    accepts migrated sequences into free slots and runs the
            fixed-shape decode/verify tick ONLY. It executes ZERO
            prefill chunks — the deterministic role-split proof the
            serve_bench ``--fleet`` gate pins.
  unified   both halves on one host (the single-host behavior;
            also the degenerate 1-host fleet).

Token streams are IDENTICAL to a single unified host by construction:
migration copies pool bytes and lanes bitwise (fleet/migrate.py's
correctness bar), and the decode program depends only on a slot's own
lanes and table.

A SIGTERM'd host drains at a tick boundary like any training rank
(resilience/coord.py discipline) — but ``drain`` routes in-flight
sequences to a PEER over the migration path instead of only handing
them back to the launcher: decoding sequences migrate (their streams
resume mid-token to full parity), prefilling/queued requests forward
as fresh request messages (their prefill work re-runs from scratch,
the single engine's hand-back semantics), and only a fleet with no
capable peer falls back to the launcher hand-back. Either way the host
exits EXIT_RESUMABLE (75).
"""

from __future__ import annotations

import json
import time

import numpy as np

from ...comm.wire import WireError
from ...ops import paged_attention as pa
from ...resilience.faults import InjectedCrash
from ...resilience.preemption import EXIT_RESUMABLE
from ..engine import Engine, EngineConfig
from ..kv_pool import PoolExhausted
from ..scheduler import Request, Scheduler
from . import migrate
from .router import (
    DECODE_CAPABLE,
    MAX_PUBLISHED_DIGESTS,
    PREFILL_CAPABLE,
    chain_coverage,
    decode_request,
    load_score,
)

ROLES = ("unified", "prefill", "decode")

#: the well-known mailbox finished streams are reported to when a host
#: runs detached from its driver (``results_to``)
FRONTDOOR = "frontdoor"

#: rollout parity probes ride the normal request path under reserved
#: rids at/below this base (probe i -> PROBE_RID_BASE - i); their
#: finished streams report to the rollout controller over the
#: ``rollout`` channel, never to the front door
PROBE_RID_BASE = -1_000_000


def role_for_rank(fleet_cfg, rank: int) -> str:
    """The reference's rank-picks-role dispatch (main.cc:49-55:
    ``procsID < nworker_procs`` -> Worker, else Server): with ``role:
    auto``, ranks below ``prefill_hosts`` prefill and the rest decode;
    an explicit role pins every rank (the single-role fleet)."""
    if fleet_cfg.role != "auto":
        return fleet_cfg.role
    return "prefill" if rank < max(1, fleet_cfg.prefill_hosts) else "decode"


def fleet_topology(fleet_cfg, n_hosts: int) -> list[tuple[str, str]]:
    """-> [(name, role)] in rank order. Explicit ``peers`` entries ARE
    the topology (one per rank, the hostfile pattern); otherwise
    ``n_hosts`` synthetic names take their role from
    ``role_for_rank``."""
    if fleet_cfg.peers:
        return [(p.name, p.role) for p in fleet_cfg.peers]
    return [
        (f"host{k}", role_for_rank(fleet_cfg, k)) for k in range(n_hosts)
    ]


class FleetHost:
    """One serving host of a fleet: a role-gated Scheduler plus the
    migration/forwarding glue. ``peers`` maps every OTHER host's name
    to its role (the static topology); live placement reads the
    transport's status feedback and falls back to the static map while
    a peer has not published yet.

    ``latent`` names the ELASTIC slice of the topology (``fleet {
    min_hosts / max_hosts }``): peers that are declared but not
    launched yet. A latent peer gets NO static-fallback placements —
    exporting a sequence to a host that may never start would strand
    it — until it JOINS by publishing a serving status (its announce;
    the observer logs a ``fleet_join`` event and starts placing onto
    it). Leaving is the existing drain-to-peer path: the tombstone
    status takes the host out of every candidate set, and re-joining
    is just publishing a serving status again."""

    def __init__(self, name: str, role: str, engine: Engine, transport,
                 *, peers: dict[str, str] | None = None,
                 latent: set[str] | None = None, recorder=None,
                 preemption=None, results_to: str | None = None,
                 fault_plan=None, log=lambda s: None):
        if role not in ROLES:
            raise ValueError(f"fleet role must be one of {ROLES}, got "
                             f"{role!r}")
        self.name = name
        self.role = role
        self.engine = engine
        self.transport = transport
        self.peers = dict(peers or {})
        #: declared-but-not-yet-joined peers (elastic fleet): no
        #: static-fallback placements until they publish a status
        self._latent = set(latent or ()) & set(self.peers)
        self.results_to = results_to
        self.preemption = preemption
        self.log = log
        # the runtime half of netlint FLT001: a split-role host with no
        # peer for the other half can never finish (or never start) a
        # stream — reject at construction, before any request is taken.
        # LATENT peers don't count: a capable peer that may never
        # launch is not a counterpart — the live fleet must cover both
        # halves on its own
        live_roles = [
            r for n, r in self.peers.items() if n not in self._latent
        ]
        if role == "decode" and not any(
            r in PREFILL_CAPABLE for r in live_roles
        ):
            raise ValueError(
                f"decode-role host {name!r} has no prefill-capable peer "
                "among live (non-latent) hosts: nothing can ever fill "
                "its KV blocks (netlint FLT001 flags this statically)"
            )
        if role == "prefill" and not any(
            r in DECODE_CAPABLE for r in live_roles
        ):
            raise ValueError(
                f"prefill-role host {name!r} has no decode-capable peer "
                "among live (non-latent) hosts: filled sequences would "
                "have nowhere to stream (netlint FLT001 flags this "
                "statically)"
            )
        self.sched = Scheduler(
            engine, recorder=recorder, preemption=preemption,
        )
        self.sched.decode_enabled = role != "prefill"
        #: migrated sequences awaiting a free slot / blocks (import
        #: backpressure: deferred, never dropped)
        self._pending: list[tuple[migrate.MigratedSequence, str]] = []
        self._shutdown = False
        self._reported: set[int] = set()
        #: high-water mark into sched.finished (append-only), so each
        #: _flush_results pass walks only NEW results — not the whole
        #: ever-growing list every tick
        self._flushed = 0
        #: published-status change detection: the idle serve loop ticks
        #: every few ms, and rewriting an identical snapshot (possibly
        #: thousands of cached digests) through the mailbox each round
        #: is pure filesystem churn
        self._last_status: dict | None = None
        self._digest_hex: tuple[int, list[str]] = (-1, [])
        #: rotation cursor for load-score ties (_pick_peer)
        self._rr = 0
        #: peers the wire tombstoned (peer_death): excluded from every
        #: placement until the transport reports them healed — the
        #: liveness watchdog's verdict set (socket transport only; the
        #: mailbox/local wirings never raise WireError)
        self._dead: set[str] = set()
        self.migrate_in = 0
        self.migrate_out = 0
        self.blocks_in = 0
        self.blocks_out = 0
        #: counts() when the first request or migration with rid >= 0
        #: reached this host (warm-up requests carry negative rids): a
        #: report of the measured run subtracts it
        self.warm_counts: dict | None = None
        #: fleet prefix cache: requests held out of admission while a
        #: peer's cache_ship is in flight — rid -> (request, monotonic
        #: deadline, peer, first uncovered digest). Deadline expiry (or
        #: the peer's tombstone) degrades to plain prefill; a held
        #: request is never dropped and never hangs.
        self._awaiting: dict[
            int, tuple[Request, float, str, bytes]
        ] = {}
        #: one fetch attempt per request, ever — a miss after a ship
        #: (or a degrade) must not re-fetch in a loop
        self._fetch_tried: set[int] = set()
        self.cache_fetches = 0
        self.cache_fetch_timeouts = 0
        self.cache_ships_in = 0
        self.cache_ships_out = 0
        self.ship_blocks_in = 0
        self.ship_blocks_out = 0
        self.ship_bytes_in = 0
        self.ship_bytes_out = 0
        #: rollout fault hooks (resilience/faults.py): torn_weights /
        #: swap_die key on weight-ship ordinals counted PER HOST
        self._fault_plan = fault_plan
        self._ship_seen = 0
        #: in-flight parity probes (rollout controller): reserved rids
        #: still running -> finished streams collected so far, plus the
        #: controller mailbox the probe_done report goes back to
        self._probe_wait: set[int] = set()
        self._probe_streams: dict[int, list[int]] = {}
        self._probe_reply_to: str | None = None
        transport.register(name)
        # run-start provenance: which role this rank serves — the
        # cross-rank merge keys its per-host rows on this event
        self._event("fleet_role", host=name, role=role)
        self.publish_status()

    # -- plumbing -------------------------------------------------------

    def _event(self, kind: str, **payload) -> None:
        self.sched._event(kind, **payload)

    def submit(self, req: Request) -> None:
        """Direct client-side submission (the router normally delivers
        ``request`` messages instead)."""
        self.sched.submit(req)

    @property
    def busy(self) -> bool:
        return bool(
            self.sched.busy or self._pending or self._awaiting
        )

    def counts(self) -> dict:
        """What the host has run so far, with this process's
        paged-attention launches (one host a process on the main.py
        path)."""
        return {
            "ticks": self.sched.ticks,
            "prefill_chunks": self.sched.prefill_chunks,
            "decode_ticks": self.sched.decode_ticks,
            "migrate_in": self.migrate_in,
            "migrate_out": self.migrate_out,
            "paged_launches": pa.paged_attention.launches
            + pa.paged_attention_overlay.launches,
        }

    def _note_arrival(self, rid: int) -> None:
        if rid >= 0 and self.warm_counts is None:
            self.warm_counts = self.counts()

    def _peer_snapshots(self, roles, exclude: str | None = None):
        """Published statuses of capable peers, least-loaded first;
        peers that have never published ride at the end on their
        static-topology role (boot window) — EXCEPT latent (elastic,
        not-yet-launched) peers, which join the candidate set only once
        they have announced themselves by publishing. A peer whose
        PUBLISHED role fell out of ``roles`` is excluded outright —
        that is how a drained host's tombstone (role "drained") takes
        it out of every placement decision."""
        published = {
            s.get("host"): s
            for s in self.transport.statuses().values()
            if s.get("host") in self.peers
        }
        self._note_joins(published)
        out = [
            s for h, s in published.items()
            if s.get("role") in roles and h != exclude
            and h not in self._dead
        ]
        out.sort(key=load_score)
        out.extend(
            {"host": n, "role": r}
            for n, r in sorted(self.peers.items())
            if r in roles and n not in published and n != exclude
            and n not in self._latent and n not in self._dead
        )
        return out

    def _note_joins(self, published: dict) -> None:
        """A latent peer that published a serving status has JOINED the
        fleet: admit it to placement and record the scale event (once
        per join — a later tombstone re-latents it, so a re-join is
        observable too)."""
        for h, s in published.items():
            role = s.get("role")
            if h in self._dead:
                # a tombstoned peer's LAST status lingers in the store;
                # only the wire healing it (_note_peer_deaths) may
                # re-admit it, never its stale snapshot
                continue
            if h in self._latent and role in ROLES:
                self._latent.discard(h)
                self._event("fleet_join", host=h, role=role)
                self.log(f"fleet host {self.name}: peer {h!r} joined "
                         f"as {role}")
            elif h not in self._latent and role == "drained" and (
                h in self.peers
            ):
                # a drained peer is latent again: placements stop (the
                # tombstone already guarantees that) AND a future
                # serving status counts as a fresh join event
                self._latent.add(h)
                self._event("fleet_leave", host=h)
                self.log(f"fleet host {self.name}: peer {h!r} left "
                         "(drained)")

    def _mark_dead(self, peer: str, reason: str) -> None:
        """The loud tombstone: a peer whose wire exhausted a send's
        retry budget leaves every candidate set NOW (waiting on it
        would strand sequences behind a dead endpoint). It re-latents
        too — if it ever heals, its next serving status is a fresh
        ``fleet_join``, the elastic rejoin path."""
        if peer in self._dead or peer not in self.peers:
            return
        self._dead.add(peer)
        self._latent.add(peer)
        self._event("peer_death", peer=peer, via="wire", reason=reason)
        self.log(
            f"fleet host {self.name}: peer {peer!r} unreachable "
            f"({reason}) — tombstoned"
        )

    def _note_peer_deaths(self) -> None:
        """Reconcile with the transport's liveness view each tick
        (socket transport's ``dead_peers``; the mailbox/local wirings
        have no liveness view and skip). New suspects tombstone; a
        healed peer (successful send or fresh status) drops its
        tombstone and waits in ``_latent`` for its join announce."""
        dead_fn = getattr(self.transport, "dead_peers", None)
        if dead_fn is None:
            return
        now_dead = {p for p in dead_fn() if p in self.peers}
        for p in sorted(now_dead - self._dead):
            self._mark_dead(p, "wire liveness")
        for p in self._dead - now_dead:
            self._dead.discard(p)

    def _export_with_failover(self, slot: int, req) -> str | None:
        """Export to the least-loaded decode-capable peer, tombstoning
        any whose wire fails and re-placing until one takes it or no
        candidate remains. The send happens BEFORE the slot retires
        (_export_to), so a failed attempt leaves the sequence intact
        in its slot — nothing is ever half-exported."""
        tried: set[str] = set()
        while True:
            dst = self._pick_peer(DECODE_CAPABLE, exclude=self.name)
            if dst is None or dst in tried:
                return None
            try:
                self._export_to(slot, req, dst)
                return dst
            except WireError as e:
                tried.add(dst)
                self._mark_dead(dst, str(e))

    def _send_with_failover(self, roles, kind: str,
                            payload: bytes) -> str | None:
        """One self-contained message to the least-loaded capable peer,
        with the same tombstone-and-re-place discipline."""
        tried: set[str] = set()
        while True:
            dst = self._pick_peer(roles, exclude=self.name)
            if dst is None or dst in tried:
                return None
            try:
                self.transport.send(dst, kind, payload, src=self.name)
                return dst
            except WireError as e:
                tried.add(dst)
                self._mark_dead(dst, str(e))

    def _marooned(self) -> bool:
        """A split-role host whose EVERY declared counterpart is
        tombstoned can neither finish nor start a stream — the verdict
        is a loud drain (hand-back accounting) + EXIT_RESUMABLE, never
        a silent idle loop behind a dead wire."""
        if self.role == "unified" or not self._dead:
            return False
        need = DECODE_CAPABLE if self.role == "prefill" else PREFILL_CAPABLE
        capable = {n for n, r in self.peers.items() if r in need}
        return bool(capable) and capable <= self._dead

    def _pick_peer(self, roles, exclude: str | None = None) -> str | None:
        """Least-loaded target, rotating among score TIES: published
        statuses refresh only when a peer ticks, so two exports in one
        round would otherwise both pile onto the same stale-idlest
        peer (and a cold fleet would never spread at all)."""
        snaps = self._peer_snapshots(roles, exclude=exclude)
        if not snaps:
            return None
        best = load_score(snaps[0])[:3]  # name excluded: ties rotate
        ties = [s for s in snaps if load_score(s)[:3] == best]
        pick = ties[self._rr % len(ties)]["host"]
        self._rr += 1
        return pick

    # -- the tick -------------------------------------------------------

    def tick(self) -> int:
        """One fleet round: drain the inbox (requests queue, migrations
        go pending), install pending imports into free slots, run the
        role-gated scheduler tick, export filled sequences (prefill
        role), publish fresh status. -> tokens emitted."""
        self._recv()
        self._note_peer_deaths()
        self._expire_fetches()
        self._maybe_fetch()
        self._import_pending()
        emitted = self.sched.tick()
        if self.role == "prefill":
            self._export_ready()
        self._flush_probes()
        self._flush_results()
        self.publish_status()
        return emitted

    def _recv(self) -> None:
        for msg in self.transport.recv(self.name):
            if msg.kind == "request":
                req = decode_request(msg.payload)
                self._note_arrival(req.rid)
                try:
                    self.sched.submit(req)
                except ValueError as e:
                    # single-host submit raises to ITS caller (the
                    # client holding the Request); here the caller is
                    # a wire peer, and one inadmissible request must
                    # not take the host down — reject it back to the
                    # front door instead
                    self._event("reject", rid=req.rid, reason=str(e))
                    self.log(f"fleet host {self.name}: rejected "
                             f"request {req.rid}: {e}")
                    if self.results_to is not None:
                        try:
                            self.transport.send(
                                self.results_to, "result",
                                json.dumps({
                                    "rid": req.rid, "tokens": [],
                                    "host": self.name, "error": str(e),
                                }).encode("utf-8"),
                                src=self.name,
                            )
                        except WireError:
                            pass  # front door gone too; verdict logged
            elif msg.kind == "migrate":
                mseq = migrate.deserialize(msg.payload)
                self._note_arrival(mseq.rid)
                self._pending.append((mseq, msg.src))
            elif msg.kind == "cache_fetch":
                self._serve_fetch(msg)
            elif msg.kind == "cache_ship":
                self._install_ship(msg)
            elif msg.kind == "weight_ship":
                self._handle_weight_ship(msg)
            elif msg.kind == "rollout":
                self._handle_rollout(msg)
            elif msg.kind == "shutdown":
                self._shutdown = True

    def _import_pending(self) -> None:
        """Install migrated sequences into free slots (FIFO). A full
        pool/slot set defers the rest to the next tick — admission
        backpressure at fleet grain, requests wait and are never
        dropped."""
        while self._pending:
            free = [
                s for s in range(self.engine.serving.slots)
                if s not in self.sched._slot_req
            ]
            if not free:
                break
            mseq, src = self._pending[0]
            slot = free[0]
            if mseq.version != self.engine.params_version:
                # version skew (mid-rollout fleet): the migrated KV was
                # written by DIFFERENT weights — scattering it into our
                # pool would poison the prefix cache and splice two
                # models into one stream. Degrade to a cold re-prefill
                # from the original prompt under OUR weights: emitted
                # tokens only ever deliver at finish (_flush_results),
                # so the client still sees exactly one consistent
                # stream. Never a drop, never a poisoned pool.
                self._pending.pop(0)
                req = Request(
                    rid=mseq.rid,
                    prompt=np.asarray(mseq.prompt, np.int32),
                    max_new_tokens=mseq.max_new_tokens,
                    temperature=mseq.temperature,
                    seed=mseq.seed,
                    eos=None if mseq.eos is None else int(mseq.eos),
                )
                self.migrate_in += 1
                self._event(
                    "migrate_in", rid=req.rid, src=src, slot=-1,
                    blocks=0, shared=0, registered=0, tokens_done=0,
                    skew=True, frame_version=mseq.version,
                    live_version=self.engine.params_version,
                )
                self.sched.submit(req)
                continue
            try:
                info = migrate.import_sequence(self.engine, slot, mseq)
            except PoolExhausted:
                self._event(
                    "backpressure", queued=len(self._pending),
                    free_blocks=self.engine.allocator.free_blocks,
                    site="migrate_in",
                )
                break
            self._pending.pop(0)
            now = time.perf_counter()
            req = Request(
                rid=mseq.rid,
                prompt=np.asarray(mseq.prompt, np.int32),
                max_new_tokens=mseq.max_new_tokens,
                temperature=mseq.temperature,
                seed=mseq.seed,
                eos=None if mseq.eos is None else int(mseq.eos),
            )
            req.status = "decoding"
            req.slot = slot
            req.tokens = list(mseq.emitted)
            req._prefilled = len(req.prompt)
            # queue-inclusive latency survives migration inside one
            # clock domain; a cross-host import re-stamps at arrival
            req.enqueue_mono = mseq.enqueue_mono or now
            req.admit_mono = req.enqueue_mono
            req.admit_wall = time.time()
            req.first_token_mono = now
            self.sched._slot_req[slot] = req
            self.migrate_in += 1
            self.blocks_in += mseq.n_blocks
            self._event(
                "migrate_in", rid=req.rid, src=src, slot=slot,
                blocks=mseq.n_blocks, shared=info["shared"],
                registered=info["registered"],
                tokens_done=len(req.tokens),
            )

    # -- fleet prefix cache (cache_fetch / cache_ship) ------------------

    def _maybe_fetch(self) -> None:
        """For each NEW queued request whose prompt chain a peer's
        published digests cover deeper than our own cache, send ONE
        ``cache_fetch`` and hold the request out of admission until
        the ship lands (or the deadline passes — degrade to plain
        prefill, never a hang). One attempt per request, ever. Any
        peer role qualifies as a source: decode hosts hold migrated
        and decode-registered history too."""
        cache = self.engine.allocator.cache
        if (
            cache is None
            or not self.engine.serving.prefix_lru
            or not self.peers
            or not self.sched._queue
        ):
            return
        snaps = [
            s for s in self.transport.statuses().values()
            if s.get("host") in self.peers
            and s.get("host") not in self._dead
            and s.get("role") in ROLES
            and s.get("cached_digests")
        ]
        if not snaps:
            return
        timeout = self.engine.serving.prefix_fetch_timeout_s
        inflight = {head for _, _, _, head in self._awaiting.values()}
        for req in list(self.sched._queue):
            if req.rid in self._fetch_tried:
                continue
            chain = cache.chain(req.prompt)
            if not chain:
                self._fetch_tried.add(req.rid)
                continue
            local = len(cache.match_chain(chain))
            if local >= len(chain):
                self._fetch_tried.add(req.rid)
                continue
            if chain[local] in inflight:
                # a ship covering this request's first uncovered block
                # is already in flight (the shared-prefix workload:
                # every queued request misses on the SAME prefix) — do
                # not multiply the wire traffic, but DO hold the
                # request: admitted now it would prefill cold and
                # register the very blocks the ship carries, wasting
                # both. The landing ship releases every held request
                # it covers (or the deadline degrades them)
                self._fetch_tried.add(req.rid)
                kept = [r for r in self.sched._queue if r is not req]
                self.sched._queue.clear()
                self.sched._queue.extend(kept)
                self._awaiting[req.rid] = (
                    req, time.monotonic() + timeout, "", chain[local],
                )
                continue
            self._fetch_tried.add(req.rid)
            hex_chain = [d.hex() for d in chain]
            best, best_n = None, local
            for s in snaps:
                n = chain_coverage(hex_chain, s)
                if n > best_n:
                    best, best_n = s.get("host"), n
            if best is None:
                continue
            try:
                self.transport.send(
                    best, "cache_fetch",
                    migrate.serialize_fetch(
                        req.rid, chain,
                        version=self.engine.params_version,
                    ),
                    src=self.name,
                )
            except WireError as e:
                self._mark_dead(best, str(e))
                continue
            # hold the request aside (identity filter: Request's
            # dataclass == would compare prompt arrays); it re-enters
            # via submit() when the ship lands or the deadline passes
            kept = [r for r in self.sched._queue if r is not req]
            self.sched._queue.clear()
            self.sched._queue.extend(kept)
            self._awaiting[req.rid] = (
                req, time.monotonic() + timeout, best, chain[local],
            )
            inflight.add(chain[local])
            self.cache_fetches += 1
            self._event(
                "cache_fetch", rid=req.rid, peer=best,
                blocks=len(chain), local_blocks=local,
                peer_blocks=best_n,
            )

    def _expire_fetches(self) -> None:
        """Degrade every held request whose ship deadline passed (or
        whose source peer died) to plain prefill — backpressure on the
        fetch path must never strand a request."""
        if not self._awaiting:
            return
        now = time.monotonic()
        for rid in list(self._awaiting):
            req, deadline, peer, _head = self._awaiting[rid]
            if now < deadline and peer not in self._dead:
                continue
            del self._awaiting[rid]
            self.cache_fetch_timeouts += 1
            self._event("cache_fetch_timeout", rid=rid, peer=peer)
            self.sched.submit(req)

    def _serve_fetch(self, msg) -> None:
        """Answer a peer's ``cache_fetch`` with ONE ``cache_ship``
        bulk frame: our longest cached prefix of its digest chain,
        blocks retained across the compiled gather so a concurrent
        admission cannot reclaim them mid-read. An empty match still
        ships (zero blocks): the requester degrades immediately
        instead of waiting out its deadline on our stale
        advertisement."""
        try:
            rid, chain, version = migrate.deserialize_fetch(msg.payload)
        except ValueError as e:
            self.log(f"fleet host {self.name}: bad cache_fetch from "
                     f"{msg.src!r}: {e}")
            return
        cache = self.engine.allocator.cache
        blocks: list[int] = []
        if version != self.engine.params_version:
            # version skew (mid-rollout fleet): our cached KV was
            # written by weights the requester is not running — answer
            # with the EXISTING empty ship so it degrades to plain
            # prefill immediately instead of installing poison (or
            # waiting out its deadline)
            self._event(
                "cache_fetch", rid=rid, peer=msg.src, dir="serve",
                skew=True, frame_version=version,
                live_version=self.engine.params_version,
            )
        elif cache is not None:
            blocks = cache.match_chain(chain)[
                : self.engine.pool.max_blocks_per_seq
            ]
        if blocks:
            self.engine.allocator.retain(blocks)
            try:
                k, v = self.engine.export_blocks(blocks)
            finally:
                self.engine.allocator.release(blocks)
        else:
            shape = (
                self.engine.cfg.n_layers, 0, self.engine.cfg.n_heads,
                self.engine.pool.block_len, self.engine.cfg.head_dim,
            )
            k = np.zeros(shape, np.float32)
            v = np.zeros(shape, np.float32)
        data = migrate.serialize_ship(
            rid, chain[: len(blocks)], k, v,
            version=self.engine.params_version,
        )
        try:
            self.transport.send(msg.src, "cache_ship", data,
                                src=self.name)
        except WireError as e:
            self._mark_dead(msg.src, str(e))
            return
        self.cache_ships_out += 1
        self.ship_blocks_out += len(blocks)
        self.ship_bytes_out += len(data)
        self._event(
            "cache_ship", rid=rid, peer=msg.src, dir="out",
            blocks=len(blocks), bytes=len(data),
        )

    def _install_ship(self, msg) -> None:
        """Install a peer's ``cache_ship`` into our pool (scatter +
        register + LRU-park, engine.install_prefix) and release the
        held request back into admission — where it now hits locally,
        sharing the installed blocks exactly like home-grown ones. A
        backpressured (or empty, or duplicate) ship still releases
        the request: worst case is plain prefill."""
        waiting = None
        try:
            ship = migrate.deserialize_ship(msg.payload)
        except ValueError as e:
            self.log(f"fleet host {self.name}: bad cache_ship from "
                     f"{msg.src!r}: {e}")
            return
        waiting = self._awaiting.pop(ship["rid"], None)
        installed = shared = 0
        skew = ship["version"] != self.engine.params_version
        if skew:
            # version skew: the shipped KV was written under different
            # weights (the sender flipped — or we did — between fetch
            # and ship). Installing it would poison the pool; skip the
            # scatter but STILL release every held request below, so
            # worst case stays plain prefill
            ship = dict(ship, chain=[])
        if ship["chain"]:
            try:
                info = self.engine.install_prefix(
                    ship["chain"], ship["k"], ship["v"]
                )
                installed = info["installed"]
                shared = info["shared"]
            except PoolExhausted:
                self._event(
                    "backpressure",
                    queued=len(self.sched._queue),
                    free_blocks=self.engine.allocator.free_blocks,
                    site="cache_ship",
                )
        self.cache_ships_in += 1
        self.ship_blocks_in += installed
        self.ship_bytes_in += len(msg.payload)
        self._event(
            "cache_ship", rid=ship["rid"], peer=msg.src, dir="in",
            blocks=installed, shared=shared, bytes=len(msg.payload),
            cached_tokens=int(
                (installed + shared) * self.engine.pool.block_len
            ),
            skew=skew,
        )
        # release the ship's own request AND every piggybacked hold
        # whose first uncovered block the installed chain covers — they
        # re-enter admission and hit the freshly registered blocks
        covered = set(ship["chain"])
        for rid in list(self._awaiting):
            held, _deadline, _peer, head = self._awaiting[rid]
            if head in covered:
                del self._awaiting[rid]
                self.sched.submit(held)
        if waiting is not None:
            self.sched.submit(waiting[0])

    # -- live weight rollout (serve/rollout.py) -------------------------

    def _rollout_ack(self, dst: str, cmd: str, **fields) -> None:
        """One control reply to the rollout controller (kind
        ``rollout``). A dead controller is a tombstone like any other
        peer — the rollout pauses on ITS timeout, the host keeps
        serving."""
        body = {"cmd": cmd, "host": self.name}
        body.update(fields)
        try:
            self.transport.send(
                dst, "rollout", json.dumps(body).encode("utf-8"),
                src=self.name,
            )
        except WireError as e:
            self._mark_dead(dst, str(e))

    def _handle_weight_ship(self, msg) -> None:
        """Stage a shipped next-version param tree alongside the live
        one (engine.stage_params). Serving is untouched either way: a
        torn frame (CRC/format reject) nacks back to the controller —
        which retries, then quarantines the version — while the live
        weights keep answering every stream."""
        self._ship_seen += 1
        payload = msg.payload
        if self._fault_plan is not None:
            if self._fault_plan.fire("swap_die", at=self._ship_seen):
                # host death mid-stage: propagates out of the serve
                # loop; peers tombstone it (liveness), streams fail
                # over, and the controller's stage-ack timeout turns
                # the rollout verdict into "paused"
                raise InjectedCrash(
                    f"fleet host {self.name}: swap_die at weight_ship "
                    f"{self._ship_seen}"
                )
            if self._fault_plan.fire("torn_weights", at=self._ship_seen):
                # tear the bulk frame in half: the codec's CRC (or the
                # npz container itself) must reject it downstream
                payload = payload[: max(1, len(payload) // 2)]
        try:
            version, tree = migrate.deserialize_weights(payload)
        except Exception as e:  # torn frame: format/CRC/zip all land here
            self._event(
                "weight_ship", dir="in", ok=False,
                bytes=len(payload), error=str(e)[:200],
            )
            self.log(f"fleet host {self.name}: rejected weight_ship "
                     f"from {msg.src!r}: {e}")
            self._rollout_ack(msg.src, "stage_ack", ok=False,
                             error="torn")
            return
        try:
            staged_bytes = self.engine.stage_params(tree, version)
        except ValueError as e:
            self._event(
                "rollout_stage", version=version, ok=False,
                error=str(e)[:200],
            )
            self._rollout_ack(msg.src, "stage_ack", ok=False,
                             version=version, error=str(e)[:200])
            return
        self._event(
            "weight_ship", dir="in", ok=True, version=version,
            bytes=len(msg.payload),
        )
        self._event(
            "rollout_stage", version=version, ok=True,
            staged_bytes=staged_bytes,
        )
        self._rollout_ack(msg.src, "stage_ack", ok=True, version=version)

    def _handle_rollout(self, msg) -> None:
        """Rollout control plane: flip / rollback / unstage / probe.
        The handler runs in _recv, BETWEEN scheduler ticks — applying a
        flip here IS the atomic tick boundary: no stream ever decodes
        one token under each version within a tick."""
        try:
            body = json.loads(msg.payload.decode("utf-8"))
        except ValueError as e:
            self.log(f"fleet host {self.name}: bad rollout frame from "
                     f"{msg.src!r}: {e}")
            return
        cmd = body.get("cmd")
        if cmd == "flip":
            try:
                res = self.engine.flip_params()
            except ValueError as e:
                self._rollout_ack(msg.src, "flip_ack", ok=False,
                                 error=str(e)[:200])
                return
            self._event(
                "rollout_flip", version=res["version"],
                prev_version=res["prev_version"], tick=self.sched.ticks,
                purged_blocks=res["purged_blocks"],
            )
            self.log(f"fleet host {self.name}: flipped to weights "
                     f"v{res['version']} at tick {self.sched.ticks} "
                     f"(purged {res['purged_blocks']} cached blocks)")
            self._rollout_ack(msg.src, "flip_ack", ok=True,
                             version=res["version"],
                             tick=self.sched.ticks)
        elif cmd == "rollback":
            if self.engine._prev is not None:
                res = self.engine.rollback_params()
                self._event(
                    "rollout_flip", version=res["version"],
                    rollback=True,
                    aborted_version=res["aborted_version"],
                    tick=self.sched.ticks,
                    purged_blocks=res["purged_blocks"],
                )
                self.log(f"fleet host {self.name}: rolled back to "
                         f"weights v{res['version']} (aborted "
                         f"v{res['aborted_version']})")
            else:
                # never flipped here: just drop anything staged
                self.engine.unstage()
            self._rollout_ack(msg.src, "rollback_ack", ok=True,
                             version=self.engine.params_version)
        elif cmd == "unstage":
            self.engine.unstage()
            self._rollout_ack(msg.src, "unstage_ack", ok=True,
                             version=self.engine.params_version)
        elif cmd == "probe":
            self._start_probes(msg.src, body)
        else:
            self.log(f"fleet host {self.name}: unknown rollout cmd "
                     f"{cmd!r} from {msg.src!r}")

    def _start_probes(self, src: str, body: dict) -> None:
        """Submit the controller's parity probes through the REAL
        serving path (scheduler admission, post-flip cold prefill —
        the cache was purged at the flip, so probes exercise the new
        weights end to end). Reserved rids keep them out of the front
        door; _flush_probes reports the finished streams back."""
        prompts = body.get("prompts") or []
        max_new = int(body.get("max_new", 8))
        temperature = float(body.get("temperature", 0.0))
        seeds = body.get("seeds") or [0] * len(prompts)
        self._probe_wait = set()
        self._probe_streams = {}
        self._probe_reply_to = src
        for i, prompt in enumerate(prompts):
            rid = PROBE_RID_BASE - i
            req = Request(
                rid=rid, prompt=np.asarray(prompt, np.int32),
                max_new_tokens=max_new, temperature=temperature,
                seed=int(seeds[i]),
            )
            try:
                self.sched.submit(req)
            except ValueError as e:
                self._rollout_ack(src, "probe_done", ok=False,
                                 error=str(e)[:200])
                self._probe_wait = set()
                self._probe_reply_to = None
                return
            self._probe_wait.add(rid)
        if not self._probe_wait:
            self._rollout_ack(src, "probe_done", ok=True, streams={})
            self._probe_reply_to = None

    def _flush_probes(self) -> None:
        """Collect finished probe streams; when the whole batch is
        done, report it to the controller in one ``probe_done``."""
        if not self._probe_wait:
            return
        for req in self.sched.finished:
            if req.rid in self._probe_wait:
                self._probe_wait.discard(req.rid)
                self._probe_streams[req.rid] = [int(t) for t in req.tokens]
        if self._probe_wait:
            return
        dst = self._probe_reply_to
        streams = {str(r): t for r, t in self._probe_streams.items()}
        self._probe_streams = {}
        self._probe_reply_to = None
        if dst is not None:
            self._rollout_ack(dst, "probe_done", ok=True,
                             streams=streams)

    def _export_ready(self) -> None:
        """Ship every filled (decoding-status) sequence to a decode
        peer. With no peer reachable the sequence WAITS in its slot —
        the decode gate keeps it frozen, nothing is lost."""
        for slot in sorted(self.sched._slot_req):
            req = self.sched._slot_req[slot]
            if req.status != "decoding":
                continue
            if self._export_with_failover(slot, req) is None:
                break

    def _export_to(self, slot: int, req: Request, dst: str) -> None:
        mseq = migrate.export_sequence(self.engine, req, slot)
        data = migrate.serialize(mseq)
        self.transport.send(dst, "migrate", data, src=self.name)
        # the slot frees for the next admission; registered prefix
        # blocks park on OUR LRU too — the same prompt now serves
        # prefix hits on both hosts
        self.engine.retire(slot)
        del self.sched._slot_req[slot]
        self.migrate_out += 1
        self.blocks_out += mseq.n_blocks
        self._event(
            "migrate_out", rid=req.rid, dst=dst, slot=slot,
            blocks=mseq.n_blocks, bytes=len(data),
            tokens_done=len(req.tokens),
        )

    def _flush_results(self) -> None:
        if self.results_to is None:
            return
        # finished is append-only; an external clear (bench warmup
        # resets) can only shrink it, so clamp and rescan from there
        self._flushed = min(self._flushed, len(self.sched.finished))
        new, self._flushed = (
            self.sched.finished[self._flushed:],
            len(self.sched.finished),
        )
        for idx, req in enumerate(new):
            if req.rid in self._reported:
                continue
            if req.rid <= PROBE_RID_BASE:
                # rollout parity probes report over the rollout channel
                # (_flush_probes), never to the front door
                continue
            self._reported.add(req.rid)
            try:
                self.transport.send(
                    self.results_to, "result",
                    json.dumps({
                        "rid": req.rid,
                        "tokens": [int(t) for t in req.tokens],
                        "host": self.name,
                    }).encode("utf-8"),
                    src=self.name,
                )
            except WireError:
                # the front door is unreachable: rewind so this result
                # and everything after it retry next tick — a finished
                # stream is never silently unreported
                self._reported.discard(req.rid)
                self._flushed -= len(new) - idx
                break

    # -- status feedback ------------------------------------------------

    def status(self) -> dict:
        s = {
            "host": self.name,
            "role": self.role,
            "free_slots": self.engine.serving.slots
            - len(self.sched._slot_req),
            "kv_blocks_free": self.engine.allocator.free_blocks,
            "queue_depth": len(self.sched._queue) + len(self._pending)
            + len(self._awaiting),
            "live": len(self.sched._slot_req),
            # weight version feedback: the rollout controller (and the
            # router's skew view) read fleet versions off statuses
            "version": self.engine.params_version,
        }
        if self.engine.staged_version is not None:
            s["staged_version"] = self.engine.staged_version
        cache = self.engine.allocator.cache
        if cache is not None:
            # hexing thousands of digests every tick is the hot-path
            # cost here — re-derive only when the index changed
            if self._digest_hex[0] != cache.version:
                self._digest_hex = (cache.version, [
                    d.hex() for d in cache.digests(MAX_PUBLISHED_DIGESTS)
                ])
            s["cached_digests"] = self._digest_hex[1]
        return s

    def publish_status(self) -> None:
        s = self.status()
        if s != self._last_status:
            self._last_status = s
            self.transport.publish(self.name, s)

    # -- drain-to-peer --------------------------------------------------

    def drain(self, reason: str, *, grace_s: float = 0.0) -> dict:
        """Preemption drain, fleet edition: decoding sequences MIGRATE
        to a decode-capable peer (their streams resume mid-token, to
        full parity), prefilling and queued requests FORWARD to a
        prefill-capable peer as fresh requests (prefill re-runs from
        scratch, the single engine's hand-back semantics), and only with no
        capable peer does a request fall back to the launcher
        hand-back. ``grace_s`` > 0 keeps reading the inbox for that
        long AFTER the tombstone publishes, re-forwarding stragglers —
        on a cross-process transport a peer that read our
        pre-tombstone status may have a migrate message (the ONLY copy
        of its sequence) already in flight; single-threaded in-process
        drills have no concurrent senders and keep the default 0. The
        caller exits EXIT_RESUMABLE (75)."""
        # absorb anything already delivered to our inbox: a migrate
        # message a peer sent before seeing the tombstone must re-enter
        # the fleet through the forwarding below, not rot unread
        self._recv()
        self._event(
            "drain", reason=reason,
            in_flight=len(self.sched._slot_req),
            queued=len(self.sched._queue) + len(self._pending),
        )
        migrated, forwarded, handed_back = [], [], []
        for slot in sorted(self.sched._slot_req):
            req = self.sched._slot_req[slot]
            if req.status == "decoding":
                dst = self._export_with_failover(slot, req)
                if dst is not None:
                    self._event(
                        "evict", rid=req.rid, slot=slot, state="migrated",
                        tokens_done=len(req.tokens), dst=dst,
                    )
                    migrated.append(
                        {"rid": req.rid, "dst": dst,
                         "tokens_done": len(req.tokens)}
                    )
                    continue
            from .router import encode_request

            self.engine.retire(slot)
            del self.sched._slot_req[slot]
            req.status = "evicted"
            dst = self._send_with_failover(
                PREFILL_CAPABLE, "request", encode_request(req)
            )
            state = "forwarded" if dst is not None else "in_flight"
            self._event(
                "evict", rid=req.rid, slot=slot, state=state,
                tokens_done=len(req.tokens), prefilled=req._prefilled,
            )
            if dst is not None:
                forwarded.append({"rid": req.rid, "dst": dst})
            else:
                handed_back.append(
                    {"rid": req.rid, "tokens_done": len(req.tokens)}
                )
        # pending (not-yet-installed) imports re-enter the fleet as
        # fresh requests: their KV was never scattered here, so the
        # hand-back semantics (re-prefill from scratch) are the honest
        # ones — the partial output was already delivered at export
        pending_reqs = [
            Request(
                rid=m.rid,
                prompt=np.asarray(m.prompt, np.int32),
                max_new_tokens=m.max_new_tokens,
                temperature=m.temperature,
                seed=m.seed,
                eos=None if m.eos is None else int(m.eos),
            )
            for m, _ in self._pending
        ]
        self._pending.clear()
        # requests held for an in-flight cache_ship forward like any
        # queued request — the warm blocks were an optimization, the
        # request itself must leave with the drain
        awaiting_reqs = [v[0] for v in self._awaiting.values()]
        self._awaiting.clear()
        for req in list(self.sched._queue) + pending_reqs + awaiting_reqs:
            from .router import encode_request

            dst = self._send_with_failover(
                PREFILL_CAPABLE, "request", encode_request(req)
            )
            if dst is not None:
                forwarded.append({"rid": req.rid, "dst": dst})
            else:
                handed_back.append({"rid": req.rid, "tokens_done": 0})
        self.sched._queue.clear()
        # the tombstone: a published role no placement accepts takes
        # this host out of every peer's candidate set (its static
        # topology entry stops mattering once it has published)
        self.transport.publish(
            self.name, {**self.status(), "role": "drained"},
        )
        if grace_s > 0:
            deadline = time.monotonic() + grace_s
            while True:
                for msg in self.transport.recv(self.name):
                    self._reroute_straggler(
                        msg, migrated, forwarded, handed_back,
                    )
                if time.monotonic() >= deadline:
                    break
                time.sleep(0.01)
        if self.sched.recorder is not None:
            self.sched.recorder.flush()
        return {
            "reason": reason,
            "migrated": migrated,
            "forwarded": forwarded,
            "handed_back": handed_back,
            "finished": [r.rid for r in self.sched.finished],
        }

    def _reroute_straggler(self, msg, migrated, forwarded,
                           handed_back) -> None:
        """Re-forward one inbox message that arrived mid-drain. The
        payloads are self-contained, so a straggler moves to a capable
        peer as the SAME raw bytes under a fresh envelope — a migrate
        keeps its mid-stream device state (deserialized only for
        accounting), a request keeps its stamp semantics."""
        if msg.kind == "migrate":
            mseq = migrate.deserialize(msg.payload)
            dst = self._send_with_failover(
                DECODE_CAPABLE, "migrate", msg.payload
            )
            if dst is not None:
                self._event(
                    "migrate_out", rid=mseq.rid, dst=dst, slot=-1,
                    blocks=mseq.n_blocks, bytes=len(msg.payload),
                    tokens_done=len(mseq.emitted), rerouted=True,
                )
                migrated.append(
                    {"rid": mseq.rid, "dst": dst,
                     "tokens_done": len(mseq.emitted)}
                )
            else:
                handed_back.append(
                    {"rid": mseq.rid,
                     "tokens_done": len(mseq.emitted)}
                )
        elif msg.kind == "request":
            req = decode_request(msg.payload)
            dst = self._send_with_failover(
                PREFILL_CAPABLE, "request", msg.payload
            )
            if dst is not None:
                forwarded.append({"rid": req.rid, "dst": dst})
            else:
                handed_back.append({"rid": req.rid, "tokens_done": 0})

    # -- detached serve loop (the OS-process / main.py path) ------------

    def serve_forever(self, *, idle_sleep: float = 0.002,
                      max_idle_s: float | None = None,
                      drain_grace_s: float = 0.5):
        """Tick until a shutdown message arrives and the host runs dry
        (or a preemption drains it, or ``max_idle_s`` of continuous
        idleness passes — the watchdog for a driver that died). The
        preemption check runs FIRST each round, the serve-loop
        discipline scheduler.serve follows. -> (exit code, drain
        accounting | None)."""
        idle_since = None
        while True:
            if self.preemption is not None and self.preemption.requested:
                acct = self.drain(
                    self.preemption.reason or "preempted",
                    grace_s=drain_grace_s,
                )
                return EXIT_RESUMABLE, acct
            emitted = self.tick()
            if self._marooned():
                # the wire tombstoned EVERY counterpart this split-role
                # host has: serving cannot proceed — drain loudly
                # (hand-back accounting, no capable peer left to take
                # the work) and exit resumable, never idle silently
                acct = self.drain(
                    "wire: no capable peer reachable",
                    grace_s=drain_grace_s,
                )
                return EXIT_RESUMABLE, acct
            if self.busy or emitted:
                idle_since = None
                continue
            if self._shutdown:
                self._flush_results()
                return 0, None
            now = time.monotonic()
            idle_since = idle_since if idle_since is not None else now
            if max_idle_s is not None and now - idle_since > max_idle_s:
                self.log(f"fleet host {self.name}: idle past "
                         f"{max_idle_s:g}s, exiting")
                return 0, None
            time.sleep(idle_sleep)


# ---------------------------------------------------------------------------
# conf-driven entry (main.py plumbing)
# ---------------------------------------------------------------------------


def lm_config_from_conf(model_cfg):
    """Engine geometry from the conf net's declared dims: the
    kEmbedding layer's vocab/width/window, the kAttention layers'
    head count and depth. The fleet serves the code-API LM at that
    geometry with seed-initialized weights (every rank inits the same
    params from the same seed, the mp drills' discipline); the conf's
    ``checkpoint`` field overlays trained weights on top —
    ``run_from_conf`` threads it through
    ``resilience.reshard.load_serving_params``, so an npz save of
    either package restores onto this serving host."""
    from ...models.transformer import TransformerConfig

    net = model_cfg.neuralnet
    if net is None:
        raise ValueError("fleet conf has no neuralnet block")
    emb = next(
        (l.embedding_param for l in net.layer
         if l.embedding_param is not None), None,
    )
    heads = [
        l.attention_param.num_heads for l in net.layer
        if l.attention_param is not None
    ]
    if emb is None or not heads:
        raise ValueError(
            "fleet conf needs a kEmbedding layer (vocab_size, "
            "embedding_dim, max_len) and at least one kAttention layer"
        )
    if not emb.max_len:
        raise ValueError(
            "fleet conf's kEmbedding must declare max_len (the serving "
            "window cannot come from a data layer that never runs here)"
        )
    d = emb.embedding_dim
    return TransformerConfig(
        vocab=emb.vocab_size, d_model=d, n_heads=heads[0],
        n_layers=len(heads), d_ff=4 * d, max_len=emb.max_len,
    )


def _build_transport(fleet, root: str, recorder, faults: str | None,
                     log=print):
    """The transport seam's factory: ``fleet { transport }`` picks the
    filesystem mailbox (deterministic CI drills; default) or the real
    socket wire (comm/wire.py — the production path). Socket fleets
    dial peers by their conf addresses (+ the wire block's
    frontdoor_address for the results endpoint) and may carry a
    ``-faults`` wire-fault plan; missing addresses reject here, before
    any host serves (netlint WIR001 flags them statically)."""
    if getattr(fleet, "transport", "mailbox") != "socket":
        from .transport import Mailbox

        return Mailbox(root)
    from ...comm.faults import WIRE_KINDS, WireFaults
    from ...comm.wire import SocketTransport
    from ...config.schema import WireConfig
    from ...resilience.faults import FaultPlan

    wire = fleet.wire if fleet.wire is not None else WireConfig()
    addresses = {p.name: p.address for p in fleet.peers if p.address}
    missing = [p.name for p in fleet.peers if not p.address]
    if not fleet.peers or missing:
        raise ValueError(
            "fleet transport: socket needs an address on every peers "
            f"entry; missing on {missing or '(no peers declared)'} "
            "(netlint WIR001 flags this statically)"
        )
    if wire.frontdoor_address:
        addresses[FRONTDOOR] = wire.frontdoor_address
    wf = None
    plan = FaultPlan.parse(faults)
    if any(s.kind in WIRE_KINDS for s in plan.specs):
        wf = WireFaults(plan)
        log(f"wire-fault plan armed: {plan}")
    return SocketTransport(
        addresses,
        connect_timeout_s=wire.connect_timeout_s,
        send_timeout_s=wire.send_timeout_s,
        max_retries=wire.max_retries,
        backoff_s=wire.backoff_s,
        backoff_cap_s=wire.backoff_cap_s,
        liveness_timeout_s=wire.liveness_timeout_s,
        recorder=recorder,
        faults=wf,
    )


def run_from_conf(model_cfg, cluster_cfg, *, procs_id: int = 0,
                  seed: int = 0, faults: str | None = None,
                  device=None, log=print) -> int:
    """The ``fleet {}`` dispatch target of ``singa_tpu_torch.main``:
    build this rank's engine on ``device`` (None = cuda; raises without
    a card), take the role ``role_for_rank`` assigns, wire the
    transport the conf picks (mailbox or socket), and serve until
    shutdown / SIGTERM (exit 75 after a drain-to-peer). The weights are
    ``init_lm`` drawn from a ``torch.Generator`` seeded with ``seed``,
    then the conf's ``checkpoint`` overlaid by name
    (``resilience.reshard.load_serving_params``): every rank inits the
    same params from the same seed. A JAX host draws other values from
    the same seed, so a mixed fleet shares weights through an npz
    ``checkpoint``. ``faults`` carries the ``-faults`` plan (wire_* and
    torn_weights/swap_die terms)."""
    import torch

    from ...device import resolve_device
    from ...models.transformer import init_lm
    from ...obs.recorder import FlightRecorder
    from ...resilience.preemption import PreemptionHandler

    fleet = model_cfg.fleet
    n_hosts = len(fleet.peers) or (
        cluster_cfg.nworkers if cluster_cfg is not None
        and cluster_cfg.nworkers else 1
    )
    # elastic sizing: the topology declares up to max_hosts ranks, only
    # [0, min_hosts) must be live at launch — the rest are latent until
    # they join by publishing status (a later `-procsID k` launch).
    # Explicit peers entries ARE the topology (rank order, names and
    # roles): max_hosts cannot invent hosts beyond them — reject the
    # contradiction instead of silently serving a smaller fleet than
    # the conf appears to declare
    if fleet.peers:
        if fleet.max_hosts and fleet.max_hosts > len(fleet.peers):
            raise ValueError(
                f"fleet max_hosts {fleet.max_hosts} exceeds the "
                f"{len(fleet.peers)} declared peers entries — peers "
                "name the whole topology, max_hosts cannot invent "
                "hosts (netlint FLT001 flags this statically)"
            )
    elif fleet.max_hosts:
        # max_hosts is a CAP, not a hint: a cluster conf declaring
        # MORE workers than the fleet's maximum is a contradiction —
        # silently synthesizing nworkers hosts would let latent ranks
        # beyond the cap join and serve
        if n_hosts > fleet.max_hosts:
            raise ValueError(
                f"cluster declares {n_hosts} workers but fleet "
                f"max_hosts is {fleet.max_hosts} — the fleet cannot "
                "exceed its declared maximum; raise max_hosts or "
                "lower nworkers"
            )
        n_hosts = fleet.max_hosts
    min_hosts = fleet.min_hosts or n_hosts
    if not 0 < min_hosts <= n_hosts:
        raise ValueError(
            f"fleet min_hosts {fleet.min_hosts} / max_hosts "
            f"{fleet.max_hosts} do not describe a fleet: need "
            f"0 < min_hosts <= {n_hosts} (netlint FLT001 flags this "
            "statically)"
        )
    topo = fleet_topology(fleet, n_hosts)
    if not 0 <= procs_id < len(topo):
        raise ValueError(
            f"-procsID {procs_id} out of range for a {len(topo)}-host "
            "fleet"
        )
    latent = {n for k, (n, _) in enumerate(topo) if k >= min_hosts}
    name, role = topo[procs_id]
    workspace = (
        cluster_cfg.workspace if cluster_cfg is not None else "."
    )
    root = fleet.mailbox or f"{workspace}/fleet"
    cfg = lm_config_from_conf(model_cfg)
    dev = resolve_device(device)
    params = init_lm(torch.Generator().manual_seed(seed), cfg, dev)
    restored = None
    if model_cfg.checkpoint:
        from ...resilience.reshard import load_serving_params

        params, restored = load_serving_params(model_cfg.checkpoint, params)
        log(f"fleet host rank {procs_id}: restored "
            f"{restored['restored']} params from {restored['path']!r} "
            f"(step {restored['step']}, {restored['format']})")
    serving = EngineConfig.from_conf(
        model_cfg.serving, getattr(model_cfg, "kernels", None)
    )
    engine = Engine(params, cfg, serving, device=dev)
    recorder = FlightRecorder(
        f"{workspace}/events", rank=procs_id, run_id="fleet",
    )
    if restored is not None:
        recorder.event(
            "weights_restored", step=restored["step"],
            path=restored["path"], format=restored["format"],
            restored=restored["restored"],
            resharded=restored["resharded"],
            saved_nprocs=restored["saved_nprocs"] or 0,
        )
    handler = PreemptionHandler()
    handler.install()
    transport = _build_transport(fleet, root, recorder, faults, log=log)
    # rollout faults (torn_weights@K / swap_die@K) fire at the host's
    # weight-ship seam — parsed separately from the wire plan (the
    # transport's WireFaults instance only consumes wire_* kinds)
    host_plan = None
    if faults:
        from ...resilience.faults import FaultPlan

        parsed = FaultPlan.parse(faults)
        if any(s.kind in ("torn_weights", "swap_die")
               for s in parsed.specs):
            parsed.recorder = recorder
            host_plan = parsed
            log(f"rollout-fault plan armed: {parsed}")
    log(f"fleet host {name!r} (rank {procs_id}): role {role}, device "
        f"{engine.device.type}, transport "
        f"{getattr(fleet, 'transport', 'mailbox')} ({root})")
    host = FleetHost(
        name, role, engine, transport,
        peers={n: r for n, r in topo if n != name},
        latent=latent - {name},
        recorder=recorder, preemption=handler,
        results_to=FRONTDOOR, fault_plan=host_plan, log=log,
    )
    rc, acct = host.serve_forever()
    if acct is not None:
        log("FLEET DRAIN: " + json.dumps(acct))
    # the host's own account of the measured run (from the first request
    # or migration past the warm-up): its role proof (a decode host runs
    # no prefill chunk) and its paged-attention launches
    counts = host.counts()
    warm = host.warm_counts or dict.fromkeys(counts, 0)
    log("FLEET HOST: " + json.dumps({
        "host": name, "role": role, "device": engine.device.type,
        "exit": rc, **{k: v - warm[k] for k, v in counts.items()},
        "warm": warm,
    }))
    close = getattr(transport, "close", None)
    if close is not None:
        close()
    recorder.event("run_stop", step=host.sched.ticks, exit_code=rc)
    recorder.close()
    return rc
