"""FlightRecorder: the buffered JSONL event log, the PyTorch
counterpart of ``singa_tpu/obs/recorder.py`` (the same code, records and
file layout).

Each process appends JSONL records to ``<events_dir>/rank_k.jsonl``: one
record per lifecycle event (the trainer's ``run_start``/``run_stop``,
display-cadence ``step`` records, ``ckpt_save``/``ckpt_written``/
``ckpt_latest``, ``guard_rollback``, ``fault``, ``drain``,
``watchdog_stall``, the supervisor's ``crash``/``restart``; the fleet's
host, router, wire and rollout events), plus (span mode) one record per
timed phase occurrence: the Trainer's ``Timers`` hand every phase to
``phase_span`` and the async checkpoint writer wraps each write in
``span``.

  1. ``event()``/``record_span()`` never touch the device and never do
     I/O: they append a plain dict to an in-memory buffer under a lock.
     Payload values must already be host scalars: ``flush``'s
     ``json.dumps`` has no fallback encoder, so a tensor smuggled into
     a payload fails loudly instead of syncing the card.
  2. ``flush()`` is the only writer, called at display-cadence
     boundaries and at lifecycle edges (drain, restart, stop).
  3. Everything is thread-safe: the async writer, the feeder threads,
     the watchdog and the fleet's reader threads record into the same
     buffer.

Records carry both clocks: ``ts`` (wall, ``time.time()``) for merging
processes and ``mono`` (``time.perf_counter()``) for durations within
one.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import threading
import time


def config_hash(model_cfg) -> str:
    """Deterministic 12-hex digest of a ModelConfig — the run identity
    every rank derives independently (no coordination needed: all ranks
    parse the same config text)."""
    try:
        blob = json.dumps(model_cfg.to_dict(), sort_keys=True, default=str)
    except Exception:
        blob = repr(model_cfg)
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


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

    @contextlib.contextmanager
    def span(self, name: str, *, track: str = "phases",
             steps: int | None = None):
        """Context-manager form of ``record_span`` (feeder/stager/writer
        threads wrap their unit of work in one)."""
        if not self.trace_spans:
            yield
            return
        t0w = time.time()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record_span(
                name, t0w, time.perf_counter() - t0,
                track=track, steps=steps,
            )

    def phase_span(
        self, name: str, t0_wall: float, dur: float, steps: int | None = None
    ) -> None:
        """The ``Timers`` span-sink signature (utils/timers.py): every
        timed phase occurrence becomes a span on the 'phases' track."""
        self.record_span(name, t0_wall, dur, track="phases", steps=steps)

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


def recorder_for_job(model_cfg, cluster_cfg, log=print) -> FlightRecorder | None:
    """Build the job's recorder, or None when telemetry has nowhere to
    write (no workspace) or was explicitly disabled. Always-on by
    default: a missing ``telemetry`` config block means enabled."""
    tel = getattr(model_cfg, "telemetry", None)
    if tel is not None and not tel.enabled:
        return None
    if cluster_cfg is None or not cluster_cfg.workspace:
        return None
    from ..resilience.coord import process_index

    subfolder = tel.events_subfolder if tel is not None else "events"
    trace_spans = tel.trace_spans if tel is not None else True
    return FlightRecorder(
        os.path.join(cluster_cfg.workspace, subfolder),
        rank=process_index(),
        run_id=config_hash(model_cfg),
        trace_spans=trace_spans,
        log=log,
    )
