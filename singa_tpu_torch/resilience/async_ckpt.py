"""Zero-stall checkpointing: a two-stage snapshot -> write pipeline, the
PyTorch counterpart of ``singa_tpu/resilience/async_ckpt.py``.

The synchronous save (``Trainer.save``) copies every param and slot to
the host, serializes and CRCs it on the step path: with a large model
the write is the step time. Here checkpoint I/O leaves the step path:

  stage 1 — snapshot (main thread, at the step boundary, on the
      compute stream): the Trainer copies params, slots and buffers
      device to device into one of two preallocated snapshot buffers
      (``Trainer._snapshot``). The next step (or graph replay) writes
      the live tensors, never the snapshot. Then, on a side stream that
      waits for those copies, it copies the snapshot into pinned host
      memory and records a CUDA event; the step loop goes on at once.
  stage 2 — write (the one writer thread): wait on the snapshot's event
      (``Event.synchronize``, no device work is issued from the
      thread), serialize through the sync save's discipline (tmp file +
      atomic rename, trainer/checkpoint.py or sharded_ckpt.py), then the
      context's ``checkpoint_written`` seam: CRC validation and the
      atomic ``LATEST`` of resilience/retention.py.

Memory: snapshots are double-buffered. The queue holds at most one
pending snapshot while one write is in flight; a third ``submit``
blocks until the writer frees a slot: backpressure, never unbounded
growth (a job whose write cadence outruns its disk degrades to the
synchronous stall). The Trainer owns two snapshot buffers and takes
the one the writer is not reading.

Ordering and crash safety:

  - one FIFO queue + one writer thread: checkpoints reach ``LATEST`` in
    step order, always.
  - the writer marks ``LATEST`` only after the file validates, so a
    crash mid-write (the ``async_torn_write@K`` fault tears the K-th
    write and kills its publication) leaves ``LATEST`` on the previous
    complete save.
  - ``flush()`` blocks until everything submitted is on disk: the
    preemption drain calls it before exiting 75, the supervisor before
    resolving ``LATEST`` for a restart, the guard before a rollback.

A write failure (disk full, permission) is logged loudly, remembered,
and raised by the next ``flush()``/``submit()``: the step loop learns
of it at the next checkpoint boundary.
"""

from __future__ import annotations

import contextlib
import queue
import threading

from .faults import FaultPlan, tear_file


class AsyncWriteError(RuntimeError):
    """A background checkpoint write failed; raised at the next
    submit/flush so the step loop cannot silently outrun a dead disk."""


#: queue slots for snapshots awaiting the writer: 1 pending + 1 in
#: flight = the double buffer. submit() blocks when both are taken.
_PENDING_SLOTS = 1


class AsyncCheckpointer:
    """The stage-2 writer: one thread, FIFO, double-buffered."""

    def __init__(self, plan: FaultPlan | None = None, log=print):
        self.plan = plan if plan is not None else FaultPlan()
        self.log = log
        #: flight recorder (obs/recorder.py): each background write
        #: becomes a span on its own 'ckpt_writer' track, so a merged
        #: trace shows the write pipeline overlapping the step stream.
        #: None = telemetry off. The recorder is thread-safe.
        self.recorder = None
        self._q: queue.Queue = queue.Queue(maxsize=_PENDING_SLOTS)
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._error: BaseException | None = None
        #: 1-based count of async writes reaching the writer
        #: (``async_torn_write@K`` keys on it, like corrupt_ckpt's save
        #: ordinal — and like it, shared across restart attempts)
        self.write_ordinal = 0
        self.submitted = 0
        #: writes fully published (file on disk + checkpoint_written ran)
        self.published = 0
        #: torn or failed writes (consumed from the queue, unpublished)
        self._consumed_abnormal = 0
        #: high-water mark of snapshots alive at once (tests pin the
        #: double-buffer bound with it)
        self.max_in_flight = 0

    # ------------------------------------------------------------------
    # main-thread API
    # ------------------------------------------------------------------

    def submit(self, step: int, path: str, write_fn, on_written=None) -> None:
        """Queue one snapshot for background serialization.

        ``write_fn()`` must serialize the snapshot to ``path`` with the
        tmp+rename discipline; ``on_written(path, step)`` runs after a
        successful write (validation/LATEST/retention — the context's
        ``checkpoint_written`` seam). Blocks while the double buffer is
        full (backpressure). Raises AsyncWriteError if a previous write
        failed."""
        self._raise_pending()
        self._ensure_thread()
        self._q.put((step, path, write_fn, on_written))
        self.submitted += 1
        self.max_in_flight = max(self.max_in_flight, self.in_flight())

    def in_flight(self) -> int:
        """Snapshots submitted but not yet written (or torn/failed)."""
        return self.submitted - self.published - self._consumed_abnormal

    def flush(self, raise_errors: bool = True) -> None:
        """Block until every submitted snapshot is fully written and
        published. The SIGTERM drain's durability barrier.

        ``raise_errors=False`` (the restart/teardown paths) CONSUMES any
        pending write error instead of re-raising it: the writer already
        logged it loudly, and a stale failure from a crashed attempt
        must not resurface as a spurious "death" of a later, healthy
        attempt."""
        if self._thread is not None:
            self._q.join()
        if raise_errors:
            self._raise_pending()
        else:
            with self._lock:
                self._error = None

    def stop(self) -> None:
        """Flush (swallowing errors — stop runs in ``finally`` paths)
        and shut the writer thread down."""
        t = self._thread
        if t is None:
            return
        self.flush(raise_errors=False)
        self._q.put(None)
        t.join()
        self._thread = None

    # ------------------------------------------------------------------
    # writer thread
    # ------------------------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name="async-ckpt-writer", daemon=True
            )
            self._thread.start()

    def _raise_pending(self) -> None:
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise AsyncWriteError(
                f"background checkpoint write failed: "
                f"{type(err).__name__}: {err}"
            ) from err

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, path, write_fn, on_written = item
            rec = self.recorder
            span = (
                rec.span("write_checkpoint", track="ckpt_writer")
                if rec is not None
                else contextlib.nullcontext()
            )
            try:
                with span:
                    write_fn()
                self.write_ordinal += 1
                spec = self.plan.fire("async_torn_write", self.write_ordinal)
                if spec is not None:
                    # simulate the writer dying mid-publish: the file is
                    # torn and checkpoint_written (validation + LATEST)
                    # never runs — LATEST must keep naming the previous
                    # complete save
                    tear_file(path)
                    self._consumed_abnormal += 1
                    self.log(
                        f"FAULT: async_torn_write@{self.write_ordinal} — "
                        f"writer died mid-publish of {path} (torn file "
                        "left behind, LATEST untouched)"
                    )
                else:
                    if on_written is not None:
                        on_written(path, step)
                    self.published += 1
            except BaseException as e:  # surface on the main thread
                with self._lock:
                    self._error = e
                self._consumed_abnormal += 1
                self.log(
                    f"ERROR: async checkpoint write of {path} failed — "
                    f"{type(e).__name__}: {e}"
                )
            finally:
                self._q.task_done()
