"""Device-side input prefetch: the other half of the Prefetching protocol.

Counterpart of ``singa_tpu/data/device_prefetch.py``. The reference
overlaps input with compute through the double-buffered
``ParserLayer::Prefetching`` protocol (include/worker/base_layer.h:
510-537): while batch k trains, a thread assembles batch k+1 into the
other buffer. ``BatchPipeline`` is the host half; this module is the
device half, in two grain sizes:

  ``DeviceFeeder`` per-step double buffering. A daemon thread assembles
      batch k+1 on the host and starts its copy to the device while step
      k runs; the trainer's ``_next_batch`` becomes a buffer swap.
  ``ChunkStager`` chunk-granularity double buffering for the streaming
      chunks: while one staged block (the next N batches, stacked into
      one host-to-device copy) is consumed, the thread stages the next.
      Memory is bounded at two blocks.

The copy (:func:`to_device`): the thread fills a pinned host buffer
(``pin_memory``, from PyTorch's caching host allocator, which reuses a
buffer only after the copy that reads it has finished) and copies it
with ``non_blocking=True`` on a side stream, recording an event. The
consumer makes its stream wait on that event (:func:`ready`) before
the first use, and marks the tensor as used on its stream for the
caching allocator. On the CPU the arrays are wrapped as they are.

Stream semantics are those of the synchronous path: sequential
wraparound order, consumed positions tracked per batch handed to the
trainer (``consumed_positions``), and ``reset()`` discards all
read-ahead and joins the thread, so a restore can re-seek the streams.
A worker-thread exception surfaces on the next ``next()`` / ``take()``
as an :class:`InputFeedError`.

``BurstFeeder`` is the per-step feeder bounded to exactly n batches:
the eval cadences of uncached streams ride it (``Trainer._eval_batches``),
and it stops after the n-th batch, so the stream positions end where the
synchronous path leaves them.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch


class InputFeedError(RuntimeError):
    """A background input-feeder thread failed; re-raised on the step
    path so the trainer cannot silently train on missing data."""


def to_device(arr: np.ndarray, device: torch.device,
              stream=None) -> torch.Tensor:
    """A host array on ``device``. On a GPU: pinned, copied without
    blocking on ``stream`` (the caller's side stream), and tagged with
    the copy's event (``ready`` waits on it); on the CPU: the array
    itself."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t
    with torch.cuda.stream(stream):
        out = t.pin_memory().to(device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(stream)
    out._copy_event = ev
    return out


def ready(t: torch.Tensor) -> torch.Tensor:
    """Make the current stream wait for ``t``'s copy (a no-op on the CPU
    or for a tensor already waited on) and tell the caching allocator
    that the current stream uses it."""
    ev = getattr(t, "_copy_event", None)
    if ev is not None:
        cur = torch.cuda.current_stream(t.device)
        cur.wait_event(ev)
        t.record_stream(cur)
        t._copy_event = None
    return t


class _Prefetcher:
    """Shared thread scaffolding: slot-bounded production, FIFO handoff,
    error surfacing, and a drain-and-join ``reset``."""

    #: items staged but not consumed at once (the double buffer's
    #: read-ahead side; the consumer's item in use is the other half)
    _SLOTS = 1

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self._slots = threading.Semaphore(self._SLOTS)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # -- producer side -------------------------------------------------

    def _produce(self):
        """One item, or None to end the stream. Runs on the thread."""
        raise NotImplementedError

    def _run(self) -> None:
        while True:
            self._slots.acquire()
            if self._stop.is_set():
                return
            try:
                item = self._produce()
            except BaseException as e:
                self._error = e
                self._q.put(None)  # wake a blocked consumer
                return
            if item is None:
                # end of stream: a consumer that asks for one item too
                # many fails loudly instead of hanging
                self._q.put(None)
                return
            self._q.put(item)

    def _start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name=type(self).__name__, daemon=True
        )
        self._thread.start()

    # -- consumer side -------------------------------------------------

    def _get(self):
        item = self._q.get()
        self._slots.release()
        if item is None:
            err = self._error
            # park the dead thread now: a caller that catches the error
            # and retries restarts production, never blocks on an empty
            # queue
            self.reset()
            if err is not None:
                raise InputFeedError(
                    f"background input feeder failed: "
                    f"{type(err).__name__}: {err}"
                ) from err
            raise InputFeedError("input feeder ended early")
        return item

    def reset(self) -> None:
        """Discard every read-ahead item and join the thread. After this
        the caller may re-seek the underlying streams; production
        restarts on the next request."""
        t = self._thread
        if t is not None:
            self._stop.set()
            self._slots.release()  # unblock a producer waiting for a slot
            while t.is_alive():
                try:  # unblock a producer mid-put, then let it exit
                    self._q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.02)
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread = None
        self._stop = threading.Event()
        self._slots = threading.Semaphore(self._SLOTS)
        self._error = None


class DeviceFeeder(_Prefetcher):
    """Per-step double-buffered device feeder.

    ``assemble()`` runs on the feeder thread: it consumes one batch from
    the pipelines, starts its copy to the device (:func:`to_device`) and
    returns the batch dict. ``positions()`` (same thread, right after)
    snapshots the stream positions after that batch; the value travels
    with the batch, so ``consumed_positions`` reflects exactly the
    batches the trainer has taken, never the thread's read-ahead.
    """

    _SLOTS = 1  # one batch staged ahead + the one the step consumes

    def __init__(self, assemble, positions):
        super().__init__()
        self._assemble = assemble
        self._positions = positions
        #: stream positions after the last batch handed to the trainer
        #: (checkpoints persist these, not the pipelines' read-ahead)
        self.consumed_positions: dict[str, int] = {}

    def _produce(self):
        batch = self._assemble()
        return batch, dict(self._positions())

    def next(self) -> dict:
        """The buffer swap: return the next batch (its copy started on
        the thread; wait with :func:`ready`) and kick assembly of the
        one after."""
        if self._thread is None:
            self._start()
        batch, pos = self._get()
        self.consumed_positions = pos
        return batch

    def reset(self) -> None:
        super().reset()
        self.consumed_positions = {}


class BurstFeeder(_Prefetcher):
    """A device feeder bounded to exactly ``n`` batches (an eval or
    validation cadence): batch k+1 is assembled and its copy started on
    the thread while batch k is used, and production stops after the
    n-th, so the thread never consumes records past the burst and the
    stream positions land where the synchronous path leaves them."""

    _SLOTS = 1

    def __init__(self, assemble, n: int):
        super().__init__()
        self._assemble = assemble
        self._left = int(n)

    def _produce(self):
        if self._left <= 0:
            return None
        self._left -= 1
        # a 1-tuple: the end-of-stream marker is None, and a batch must
        # never be taken for it
        return (self._assemble(),)

    def next(self):
        """The next batch of the burst (its copy started on the thread;
        wait with :func:`ready`)."""
        if self._thread is None:
            self._start()
        return self._get()[0]


class ChunkStager(_Prefetcher):
    """Chunk-granularity double buffering for streaming chunks.

    The stager owns a private wraparound cursor per stream (initialized
    from the pipelines at start) and follows the trainer's deterministic
    chunk schedule: block k covers ``schedule(step_k)`` steps from where
    block k-1 ended. ``take(step0, nsteps)`` hands the staged block over
    (stacked ``(nsteps * batches_per_step * batchsize, ...)`` arrays,
    their copy to the device started) with the stream positions after
    it, and unblocks staging of the next block. A schedule mismatch
    raises instead of silently feeding wrong records.
    """

    _SLOTS = 1  # one block staged ahead + the one the chunk consumes

    def __init__(self, sources, batches_per_step, schedule, cursors, put):
        """``sources``: {layer: (images, labels, batchsize)} host arrays;
        ``schedule(step) -> nsteps`` (0 ends the stream);
        ``cursors() -> {layer: record position}`` read at start;
        ``put(np_array, layer, kind) -> device tensor`` starts a staged
        array's copy (``kind`` is "image" or "label")."""
        super().__init__()
        #: {layer: (images, labels, batchsize)}: what is staged
        self.sources = sources
        self._bps = batches_per_step
        self._schedule = schedule
        self._cursors = cursors
        self._put = put
        self._step: int | None = None
        self._pos: dict[str, int] = {}

    def _produce(self):
        nsteps = int(self._schedule(self._step))
        if nsteps <= 0:
            return None
        block: dict = {}
        positions: dict[str, int] = {}
        for name, (images, labels, bs) in self.sources.items():
            n = len(images)
            span = nsteps * self._bps * bs
            idx = (self._pos[name] + np.arange(span)) % n
            block[name] = {
                "image": self._put(images[idx], name, "image"),
                "label": self._put(labels[idx], name, "label"),
            }
            self._pos[name] = int((self._pos[name] + span) % n)
            positions[name] = self._pos[name]
        step0, self._step = self._step, self._step + nsteps
        return step0, nsteps, block, positions

    def take(self, step0: int, nsteps: int):
        """-> (block, positions_after) for the window
        ``[step0, step0 + nsteps)``."""
        if self._thread is None:
            self._step = int(step0)
            self._pos = {k: int(v) for k, v in self._cursors().items()}
            self._start()
        s, n, block, positions = self._get()
        if (s, n) != (step0, nsteps):
            # discard the whole read-ahead before raising: a caller that
            # survives the error restarts from fresh cursors
            self.reset()
            raise InputFeedError(
                f"chunk stager staged window ({s}, {n}) but the trainer "
                f"asked for ({step0}, {nsteps}): schedule drift"
            )
        return block, positions
