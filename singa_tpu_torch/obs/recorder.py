"""FlightRecorder: the buffered JSONL event log, the PyTorch
counterpart of ``singa_tpu/obs/recorder.py`` (the same records, the
same file layout).

Each process appends JSONL records to ``<events_dir>/rank_k.jsonl``:
one record per lifecycle event the fleet's host, router, scheduler,
wire and rollout controller emit (``fleet_role``, ``route``,
``migrate_out``/``migrate_in``, ``cache_fetch``/``cache_ship``,
``drain``, ``wire_*``, ``rollout_*``, ...), plus (span mode) one record
per timed phase.

  1. ``event()``/``record_span()`` never touch the device and never do
     I/O: they append a plain dict to an in-memory buffer under a lock.
     Payload values must already be host scalars: ``flush``'s
     ``json.dumps`` has no fallback encoder, so a tensor smuggled into
     a payload fails loudly instead of syncing the card.
  2. ``flush()`` is the only writer, called at lifecycle edges (drain,
     stop).
  3. Everything is thread-safe: the socket transport's reader threads
     record into the same buffer.

The scheduler records a span per finished request and decode tick
(``record_span``).

Records carry both clocks: ``ts`` (wall, ``time.time()``) for merging
processes and ``mono`` (``time.perf_counter()``) for durations within
one.
"""

from __future__ import annotations

import json
import os
import threading
import time


class FlightRecorder:
    """Per-rank buffered JSONL event log + span sink."""

    def __init__(
        self,
        events_dir: str,
        *,
        rank: int = 0,
        run_id: str = "",
        trace_spans: bool = True,
        log=print,
    ):
        self.events_dir = events_dir
        self.path = os.path.join(events_dir, f"rank_{rank}.jsonl")
        self.rank = int(rank)
        self.run_id = run_id
        self.trace_spans = bool(trace_spans)
        self.log = log
        self._lock = threading.Lock()
        self._buf: list[dict] = []
        #: last step a caller stamped (events without an explicit step
        #: inherit it — e.g. the async writer publishing step k's save
        #: while the loop is at k+j)
        self.step: int | None = None
        #: counters tests pin the zero-syscall contract with
        self.recorded = 0
        self.flushes = 0
        self.writes = 0  # file opens — must equal flushes with content

    # ------------------------------------------------------------------
    # recording (no I/O, no device access)
    # ------------------------------------------------------------------

    def event(self, kind: str, step: int | None = None, **payload) -> None:
        """Append one lifecycle event to the buffer. Payload values must
        be host-side JSON scalars/containers (see module docstring)."""
        rec = {
            "ts": time.time(),
            "mono": time.perf_counter(),
            "rank": self.rank,
            "run": self.run_id,
            "step": self.step if step is None else int(step),
            "kind": kind,
        }
        if payload:
            rec["data"] = payload
        with self._lock:
            self._buf.append(rec)
            self.recorded += 1

    def record_span(
        self,
        name: str,
        t0_wall: float,
        dur: float,
        *,
        track: str = "phases",
        steps: int | None = None,
    ) -> None:
        """One completed span (a Chrome-trace 'X' event after merge).
        ``t0_wall`` is the wall-clock start, ``dur`` seconds. No-op when
        span recording is off — the event log stays lifecycle-only."""
        if not self.trace_spans:
            return
        rec = {
            "ts": t0_wall,
            "mono": time.perf_counter(),
            "rank": self.rank,
            "run": self.run_id,
            "step": self.step,
            "kind": "span",
            "name": name,
            "track": track,
            "dur": dur,
        }
        if steps is not None:
            rec["steps"] = int(steps)
        with self._lock:
            self._buf.append(rec)
            self.recorded += 1

    # ------------------------------------------------------------------
    # flushing (the only I/O)
    # ------------------------------------------------------------------

    def flush(self) -> None:
        """Append the buffered records to the rank's JSONL file — called
        at display cadence and lifecycle edges, never per step. A failed
        write is logged and the records dropped: telemetry must never
        turn a flaky shared FS into a training crash."""
        with self._lock:
            buf, self._buf = self._buf, []
            self.flushes += 1
        if not buf:
            return
        lines = []
        for rec in buf:
            try:
                # no default= fallback: a device array (or any
                # non-host value) in a payload must fail HERE, loudly,
                # not silently sync the device at flush time
                lines.append(json.dumps(rec))
            except TypeError as e:
                self.log(
                    f"TELEMETRY: dropping unserializable "
                    f"{rec.get('kind')!r} event: {e}"
                )
        if not lines:
            # every buffered record was dropped: writing would leave a
            # bare blank line that breaks strict JSONL readers
            return
        try:
            os.makedirs(self.events_dir, exist_ok=True)
            with open(self.path, "a", encoding="utf-8") as f:
                f.write("\n".join(lines) + "\n")
            self.writes += 1
        except OSError as e:
            self.log(f"TELEMETRY: could not write {self.path}: {e}")

    def close(self) -> None:
        self.flush()
