"""Continuous batching: admit/retire request streams at each decode tick.

The PyTorch counterpart of ``singa_tpu/serve/scheduler.py``, the control
plane over one :class:`Engine`:

  - a FIFO request queue; at each tick, queued prompts are admitted
    into free slots while the block pool can cover their whole
    ``prompt + budget`` (all-or-nothing, so a live stream can never
    strand mid-generation); an allocation that does not fit applies
    ADMISSION backpressure: the request waits for a retirement, it is
    never dropped;
  - admitted prompts prefill in fixed chunks, one chunk per request per
    tick, so a long prompt shares the loop with live decode instead of
    stalling it; with the prefix cache on, admission first points the
    sequence's table at the pool's longest cached prefix of its prompt,
    the chunk loop starts at the first uncovered token, and the prompt
    is registered for later hits once its last chunk lands;
  - every live slot advances one token per tick through the engine's
    decode program; EOS or an exhausted budget retires the slot (blocks
    freed for the next admission);
  - with speculation on (``spec_k`` > 0), each tick drafts up to k
    tokens per live greedy slot (serve/speculate.py), runs the engine's
    verify program once, and fans every accepted token out to its
    request; EOS or budget hit INSIDE an accepted run retires at exactly
    the token sequential decode would have stopped at. Temperature slots
    ride the same tick with zero drafts.

The flight recorder and the preemption handler of the JAX package are
optional hooks here (``recorder``, ``preemption``; None by default):
given objects with the same ``event``/``record_span``/``flush`` and
``requested``/``reason`` surface, the scheduler reports lifecycle
events and drains at a tick boundary exactly as the JAX one does.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np

from .engine import Engine
from .kv_pool import PoolExhausted
from .speculate import make_drafter


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle bookkeeping."""

    rid: int
    prompt: np.ndarray            # (P,) int32
    max_new_tokens: int
    temperature: float = 0.0
    seed: int = 0
    eos: int | None = None

    # runtime (owned by the scheduler)
    status: str = "queued"        # queued|prefill|decoding|done|evicted
    slot: int | None = None
    tokens: list = dataclasses.field(default_factory=list)
    enqueue_mono: float = 0.0
    admit_wall: float = 0.0
    admit_mono: float = 0.0
    first_token_mono: float = 0.0
    finish_mono: float = 0.0
    _prefilled: int = 0

    @property
    def latency_s(self) -> float:
        """Admit -> finish wall seconds (0 until finished)."""
        return max(0.0, self.finish_mono - self.admit_mono)


class Scheduler:
    """Continuous-batching loop over one Engine."""

    def __init__(self, engine: Engine, *, recorder=None, preemption=None,
                 drafter=None):
        self.engine = engine
        self.recorder = recorder
        self.preemption = preemption
        #: speculative decode: k > 0 routes every decode tick through the
        #: engine's verify program; ``drafter`` replaces the n-gram drafter
        #: (e.g. speculate.NullDrafter forces zero acceptance)
        self.spec_k = engine.serving.spec_k
        if drafter is not None:
            self.drafter = drafter
        else:
            self.drafter = (make_drafter(engine.serving.spec_drafter)
                            if self.spec_k > 0 else None)
        #: role gate for a fleet's prefill/decode split: False = ticks
        #: run admission and chunked prefill only, and decoding requests
        #: wait to be migrated to a decode peer
        self.decode_enabled = True
        # the allocator's lifecycle events (lru_evict, lru_reclaim) ride
        # the scheduler's event path
        engine.allocator.on_event = self._event
        self._queue: collections.deque[Request] = collections.deque()
        self._slot_req: dict[int, Request] = {}
        self.finished: list[Request] = []
        self.reset_counters()
        self._event(
            "kernel_select", site="serve.paged_attention",
            impl=engine.serving.attend_impl,
        )

    def reset_counters(self) -> None:
        """Zero every accumulated statistic (ticks, token/draft counts,
        occupancy, backpressure, finished list), e.g. after a warm-up
        request. Live/queued requests are untouched."""
        self.finished.clear()
        self.ticks = 0
        #: ticks that ran a decode/verify program (>= 1 slot decoding)
        self.decode_ticks = 0
        self.tokens_emitted = 0
        self.spec_drafted = self.spec_accepted = 0
        self.prefill_chunks = 0
        #: prefix-cache accounting (all zero with the cache off); partial
        #: hits COW-extended a registered tail, decode blocks registered
        #: at retirement under ``prefix_decode_blocks``
        self.prefix_lookups = self.prefix_hits = 0
        self.blocks_shared = self.cow_copies = 0
        self.partial_hits = self.tail_tokens_shared = 0
        self.decode_blocks_registered = 0
        self.prefill_chunks_saved = 0
        self.engine.allocator.reset_stats()
        self.backpressure_ticks = 0
        #: sum over ticks of live (decoding) slots: occupancy reporting
        self._live_ticks = 0
        #: wall seconds / tokens over FULL-occupancy decode ticks only:
        #: the steady-state capacity number
        self.full_tick_s, self.full_tick_tokens = 0.0, 0

    # -- client side ----------------------------------------------------

    def submit(self, req: Request) -> None:
        total = len(req.prompt) + req.max_new_tokens
        if total > self.engine.cfg.max_len:
            raise ValueError(
                f"request {req.rid}: prompt {len(req.prompt)} + budget "
                f"{req.max_new_tokens} exceeds max_len "
                f"{self.engine.cfg.max_len}"
            )
        req.prompt = np.asarray(req.prompt, np.int32)
        req.enqueue_mono = req.enqueue_mono or time.perf_counter()
        req.status = "queued"
        self._queue.append(req)

    @property
    def busy(self) -> bool:
        return bool(self._queue or self._slot_req)

    def _event(self, kind: str, **payload) -> None:
        if self.recorder is not None:
            self.recorder.event(kind, step=self.ticks, **payload)

    # -- the tick -------------------------------------------------------

    def _admit_some(self) -> None:
        free = [
            s for s in range(self.engine.serving.slots)
            if s not in self._slot_req
        ]
        stalled = False
        while self._queue and free:
            req = self._queue[0]
            try:
                adm = self.engine.admit(
                    free[0], len(req.prompt) + req.max_new_tokens,
                    prompt=req.prompt,
                )
            except PoolExhausted:
                stalled = True
                break
            self._queue.popleft()
            slot = free.pop(0)
            self._slot_req[slot] = req
            req.slot = slot
            req.status = "prefill"
            # prefill starts at the first token the prefix cache did not
            # cover; a handed-back (drained) request restarts from there
            req._prefilled = adm.prefill_from
            req.tokens = []
            req.admit_wall = time.time()
            req.admit_mono = time.perf_counter()
            self._event(
                "request_admit", rid=req.rid, slot=slot,
                prompt_len=int(len(req.prompt)), blocks=len(adm.blocks),
                queued_s=round(req.admit_mono - req.enqueue_mono, 6),
            )
            self._count_prefix(req, slot, adm)
        if stalled:
            self.backpressure_ticks += 1
            self._event(
                "backpressure",
                queued=len(self._queue),
                free_blocks=self.engine.allocator.free_blocks,
            )

    def _count_prefix(self, req: Request, slot: int, adm) -> None:
        """The prefix-cache counters and events of one admission."""
        if self.engine.allocator.cache is not None:
            self.prefix_lookups += 1
        if adm.cached_tokens:
            c = self.engine.serving.max_prefill_chunk
            plen = len(req.prompt)
            saved = -(-plen // c) - -(-(plen - adm.prefill_from) // c)
            # blocks read through another owner's bytes (a COW'd block is
            # private)
            shared = (adm.cached_tokens // self.engine.pool.block_len
                      - (1 if adm.cow_copied else 0))
            self.prefix_hits += 1
            self.blocks_shared += shared
            self.prefill_chunks_saved += saved
            self._event(
                "prefix_hit", rid=req.rid, slot=slot,
                cached_tokens=int(adm.cached_tokens),
                blocks_shared=int(shared), chunks_saved=int(saved),
            )
        if adm.tail_tokens:
            self.partial_hits += 1
            self.tail_tokens_shared += adm.tail_tokens
            self._event(
                "partial_hit", rid=req.rid, slot=slot,
                cached_tokens=int(adm.cached_tokens),
                tail_tokens=int(adm.tail_tokens),
            )
        if adm.cow_copied:
            self.cow_copies += 1
            self._event("cow_copy", rid=req.rid, slot=slot)

    def _prefill_some(self) -> None:
        # one chunk per prefilling request per tick: decode never waits
        # behind more than slots * one chunk of prompt work
        for slot in sorted(self._slot_req):
            req = self._slot_req[slot]
            if req.status != "prefill":
                continue
            n = min(
                self.engine.serving.max_prefill_chunk,
                len(req.prompt) - req._prefilled,
            )
            last = self.engine.prefill_chunk(
                slot, req.prompt[req._prefilled:req._prefilled + n],
                req._prefilled,
            )
            req._prefilled += n
            self.prefill_chunks += 1
            self._event(
                "prefill", rid=req.rid, slot=slot, tokens=int(n),
                done=int(req._prefilled), of=int(len(req.prompt)),
            )
            if req._prefilled >= len(req.prompt):
                # every prompt position is prefill-written: index the
                # fully covered blocks for later hits
                self.engine.register_prefix(slot, req.prompt)
                first = self.engine.activate(
                    slot, last, len(req.prompt), req.seed,
                    temperature=req.temperature,
                )
                req.tokens.append(first)
                req.status = "decoding"
                req.first_token_mono = time.perf_counter()
                self._check_done(slot, req, first)

    def _check_done(self, slot: int, req: Request, tok: int) -> bool:
        eos = req.eos is not None and tok == req.eos
        if eos or len(req.tokens) >= req.max_new_tokens:
            self._finish(slot, req, "eos" if eos else "budget")
            return True
        return False

    def _finish(self, slot: int, req: Request, reason: str) -> None:
        if (self.engine.serving.prefix_decode_blocks
                and self.engine.allocator.cache is not None and req.tokens):
            # multi-turn reuse: index the conversation's full blocks,
            # decode-written ones included, before release parks them
            n = self.engine.register_history(
                slot, np.concatenate([np.asarray(req.prompt, np.int32),
                                      np.asarray(req.tokens, np.int32)]),
            )
            if n:
                self.decode_blocks_registered += n
                self._event("decode_register", rid=req.rid, slot=slot,
                            blocks=int(n))
        self.engine.retire(slot)
        del self._slot_req[slot]
        req.status = "done"
        req.finish_mono = time.perf_counter()
        self.finished.append(req)
        self._event(
            "retire", rid=req.rid, slot=slot, reason=reason,
            tokens=int(len(req.tokens)),
            latency_s=round(req.latency_s, 6),
        )
        if self.recorder is not None:
            self.recorder.record_span(
                "request", req.admit_wall, req.latency_s,
                track="requests", steps=len(req.tokens),
            )

    def _draft_for(self, req: Request) -> list[int]:
        """Draft tokens for one decoding request: greedy slots only,
        clamped so the accepted run can never overshoot the budget (at
        most ``budget_remaining`` tokens emit per tick, the last being
        the bonus) nor write past the request's allocated blocks."""
        if req.temperature > 0.0:
            return []
        budget_rem = req.max_new_tokens - len(req.tokens)
        n = min(self.spec_k, budget_rem - 1)
        if n <= 0:
            return []
        ctx = list(req.prompt) + req.tokens
        return list(self.drafter.draft(ctx, n))[:n]

    def tick(self) -> int:
        """One scheduling round: admit fills freed slots, prefill
        advances one chunk each, then every live slot decodes (one token,
        or up to spec_k + 1 through the verify program; skipped when
        ``decode_enabled`` is False). -> tokens emitted."""
        self._admit_some()
        self._prefill_some()
        emitted_n = self._decode_some() if self.decode_enabled else 0
        self.ticks += 1
        return emitted_n

    def _decode_some(self) -> int:
        """The decode phase of one tick: every decoding slot advances
        through the decode (or verify) program, accepted runs fan out to
        their requests, EOS/budget retires inline. -> tokens emitted."""
        decoding = {
            s: r for s, r in self._slot_req.items() if r.status == "decoding"
        }
        if not decoding:
            return 0
        emitted_n = accepted_n = drafted_n = 0
        t0w, t0 = time.time(), time.perf_counter()
        if self.spec_k > 0:
            slots = self.engine.serving.slots
            drafts = np.zeros((slots, self.spec_k), np.int32)
            nd = np.zeros((slots,), np.int32)
            for slot, req in decoding.items():
                d = self._draft_for(req)
                drafts[slot, :len(d)] = d
                nd[slot] = len(d)
            drafted_n = int(nd.sum())
            self.spec_drafted += drafted_n
            self._event(
                "spec_draft", drafted=drafted_n, live=len(decoding),
            )
            emitted_dev, accepted_dev = self.engine.verify(drafts, nd)
            emitted = emitted_dev.cpu().numpy()
            accepted_n = int(accepted_dev.sum())
            self.spec_accepted += accepted_n
        else:
            emitted = self.engine.decode().cpu().numpy()[:, None]
        dur = time.perf_counter() - t0
        for slot, req in sorted(decoding.items()):
            # fan the slot's accepted run out token by token: EOS or
            # budget INSIDE the run stops exactly where sequential decode
            # would have; the tail is discarded
            for tok in emitted[slot]:
                if tok < 0:
                    break
                req.tokens.append(int(tok))
                emitted_n += 1
                if self._check_done(slot, req, int(tok)):
                    break
        self._live_ticks += len(decoding)
        self.decode_ticks += 1
        self.tokens_emitted += emitted_n
        if len(decoding) == self.engine.serving.slots:
            self.full_tick_s += dur
            self.full_tick_tokens += emitted_n
        if self.recorder is not None:
            self.recorder.record_span(
                "decode_tick", t0w, dur, track="serving", steps=emitted_n,
            )
        if self.spec_k > 0:
            self._event(
                "spec_accept", accepted=accepted_n, emitted=emitted_n,
                drafted=drafted_n,
            )
        self._event(
            "decode_tick", live=len(decoding), emitted=emitted_n,
            blocks_used=self.engine.allocator.used_blocks,
        )
        return emitted_n

    # -- loops ----------------------------------------------------------

    def serve(self, max_ticks: int = 10 ** 9):
        """Tick until idle (or ``max_ticks``). With a preemption hook,
        a requested preemption observed at a tick boundary turns into a
        drain (the accounting dict is returned); None means the queue
        ran dry normally."""
        while self.busy and self.ticks < max_ticks:
            if self.preemption is not None and self.preemption.requested:
                return self.drain(self.preemption.reason or "preempted")
            self.tick()
        return None

    def drain(self, reason: str) -> dict:
        """Preemption drain: hand every in-flight sequence back (partial
        output recorded, blocks freed, request re-queued at the front)
        and report the accounting a launcher needs."""
        self._event(
            "drain", reason=reason,
            in_flight=len(self._slot_req), queued=len(self._queue),
        )
        handed_back = []
        for slot in sorted(self._slot_req):
            req = self._slot_req[slot]
            self.engine.retire(slot)
            req.status = "evicted"
            self._event(
                "evict", rid=req.rid, slot=slot, state="in_flight",
                tokens_done=int(len(req.tokens)),
                prefilled=int(req._prefilled),
            )
            handed_back.append(req)
        for req in reversed(handed_back):
            self._queue.appendleft(req)
        self._slot_req.clear()
        if self.recorder is not None:
            self.recorder.flush()
        return {
            "reason": reason,
            "handed_back": [
                {"rid": r.rid, "tokens_done": len(r.tokens)}
                for r in handed_back
            ],
            "queued": [r.rid for r in self._queue],
            "finished": [r.rid for r in self.finished],
        }

    # -- reporting ------------------------------------------------------

    def occupancy(self) -> dict:
        ticks = max(1, self.ticks)
        out = {
            "slot_occupancy": round(
                self._live_ticks / (ticks * self.engine.serving.slots), 4
            ),
            "kv_blocks_peak": self.engine.allocator.peak_used,
            "kv_blocks_total": self.engine.pool.n_blocks - 1,
            "backpressure_ticks": self.backpressure_ticks,
            "free_slots": self.engine.serving.slots - len(self._slot_req),
            "kv_blocks_free": self.engine.allocator.free_blocks,
            "queue_depth": len(self._queue),
            "prefill_chunks": self.prefill_chunks,
            "decode_ticks": self.decode_ticks,
        }
        if self.spec_k > 0:
            out["spec_drafted"] = self.spec_drafted
            out["spec_accepted"] = self.spec_accepted
            out["acceptance_rate"] = round(
                self.spec_accepted / max(1, self.spec_drafted), 4
            )
            out["tokens_per_tick"] = round(
                self.tokens_emitted / max(1, self.decode_ticks), 4
            )
        alloc = self.engine.allocator
        if alloc.cache is not None:
            out["prefix_hits"] = self.prefix_hits
            out["prefix_hit_rate"] = round(
                self.prefix_hits / max(1, self.prefix_lookups), 4
            )
            out["blocks_shared"] = self.blocks_shared
            out["cow_copies"] = self.cow_copies
            out["partial_hits"] = self.partial_hits
            out["tail_tokens_shared"] = self.tail_tokens_shared
            out["decode_blocks_registered"] = self.decode_blocks_registered
            out["prefill_chunks_saved"] = self.prefill_chunks_saved
            out["lru_evictions"] = alloc.lru_evictions
            out["lru_reclaims"] = alloc.lru_reclaims
            out["kv_blocks_cached"] = alloc.cached_blocks
        return out
