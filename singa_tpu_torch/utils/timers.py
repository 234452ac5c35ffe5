"""Per-phase wall-clock timers (TimerInfo parity).

The reference's Executor keeps millisecond accumulators per phase —
tForward_/tBackward_/tSyncData_/tSyncParam_ — and prints them with the
metrics each display interval (include/worker/worker.h:91-114). One jitted
XLA program fuses forward/backward/update, so the TPU-native phases are:

  train  — device step time (dispatch..ready, measured at sync points)
  data   — host batch assembly + transfer
  eval   — test/validation passes

Use ``jax.profiler`` traces when per-op attribution is needed; these
counters are the always-on cheap layer, like the reference's.
"""

from __future__ import annotations

import contextlib
import time


class Timers:
    def __init__(self, span_sink=None):
        #: span-recording mode (singa_tpu/obs/): when set, every phase
        #: occurrence ALSO calls ``span_sink(name, t0_wall, dur, steps)``
        #: — the flight recorder buffers it as a Chrome-trace span. The
        #: sink must do no I/O and no device work (obs/recorder.py's
        #: contract); ``reset()`` leaves it attached.
        self.span_sink = span_sink
        self.reset()

    def reset(self) -> None:
        self._acc: dict[str, float] = {}
        self._n: dict[str, int] = {}
        self._steps: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, steps: int = 1):
        """Time one occurrence of ``name``. ``steps`` is how many train
        steps the occurrence covers (chunked dispatch windows pass the
        window length) — feeds the per-STEP means and the span export;
        accumulators are otherwise unchanged."""
        sink = self.span_sink
        t0w = time.time() if sink is not None else 0.0
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._acc[name] = self._acc.get(name, 0.0) + dt
            self._n[name] = self._n.get(name, 0) + 1
            self._steps[name] = self._steps.get(name, 0) + max(1, steps)
            if sink is not None:
                sink(name, t0w, dt, steps)

    def total(self, name: str) -> float:
        return self._acc.get(name, 0.0)

    def phases(self) -> list[str]:
        """Names of every phase that has accumulated time."""
        return sorted(self._acc)

    def mean_ms(self, name: str) -> float:
        n = self._n.get(name, 0)
        return (self._acc.get(name, 0.0) / n * 1000.0) if n else 0.0

    def steps(self, name: str) -> int:
        """Train steps covered by ``name``'s occurrences (chunk windows
        count their whole window — see ``phase(steps=)``)."""
        return self._steps.get(name, 0)

    def share(self, name: str, *others: str) -> float:
        """``name``'s fraction of the time accumulated across ``name`` +
        ``others`` (the display line's input-stall percentage). 0.0 when
        nothing has accumulated."""
        total = sum(self.total(p) for p in (name, *others))
        return self.total(name) / total if total > 0 else 0.0

    def to_string(self) -> str:
        """"train 12.3ms, data 0.8ms" — the TimerInfo display line."""
        return ", ".join(
            f"{k} {self.mean_ms(k):.2f}ms/it" for k in sorted(self._acc)
        ) or "no timing"
