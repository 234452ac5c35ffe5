"""Preemption handling: SIGTERM/SIGINT -> drain -> resumable exit, the
PyTorch counterpart of ``singa_tpu/resilience/preemption.py``.

Cluster preemptions arrive as SIGTERM with a short grace window. The
handler only sets a flag; the serve loop checks it at a tick boundary,
drains whatever is in flight (a fleet host migrates it to a peer) and
exits with a distinct "resumable" status (EXIT_RESUMABLE, EX_TEMPFAIL's
75) so the launcher can tell "re-run me" from a real failure. Nothing
asynchronous touches serving state, and no CUDA call runs in the
handler.
"""

from __future__ import annotations

import signal
import threading


#: drained on SIGTERM/SIGINT — safe to relaunch
#: (BSD sysexits EX_TEMPFAIL: "transient failure, retry")
EXIT_RESUMABLE = 75


class PreemptionHandler:
    """Flag-only signal handler for SIGTERM/SIGINT.

    ``install()`` swaps the handlers in (restoring the previous ones on
    ``uninstall()``); ``trigger()`` is the synthetic path fault injection
    uses: same flag, no real signal, fully deterministic. Installation
    degrades gracefully off the main thread (signal.signal raises there):
    the synthetic path still works, real signals keep their previous
    behavior.
    """

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self._event = threading.Event()
        self._prev: dict[int, object] = {}
        self.reason: str | None = None

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def trigger(self, reason: str) -> None:
        self.reason = reason
        self._event.set()

    def _handle(self, signum, frame) -> None:
        del frame
        self.trigger(f"signal {signal.Signals(signum).name}")

    def install(self) -> bool:
        """-> True when real signal handlers are in place."""
        try:
            for sig in self.SIGNALS:
                self._prev[sig] = signal.signal(sig, self._handle)
            return True
        except ValueError:  # not the main thread
            self._prev.clear()
            return False

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):
                pass
        self._prev.clear()
