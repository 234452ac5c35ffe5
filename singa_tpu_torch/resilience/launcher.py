"""Launcher-side restart budget + the elastic gang-relaunch loop, the
PyTorch counterpart of ``singa_tpu/resilience/launcher.py`` (the same
code; the elastic launcher tool that drives it is not ported).

The in-process supervisor (supervisor.py) already breaks crash loops
WITHIN one process lifetime — but its circuit breaker deliberately does
not count resumable exits (75): a preemption drain or a peer-death
watchdog exit is supposed to be relaunched. That leaves a hole at the
LAUNCHER: a deterministic drain/death cycle (a host that always gets
preempted at step K, a node whose peer always dies) makes every gang
attempt exit 75, and a launcher that blindly relaunches resumable
statuses loops forever, burning the reservation.

``RestartBudget`` closes it: at most ``max_restarts_per_window``
relaunches per rolling ``restart_window_s`` seconds (the
``resilience {}`` conf knobs), after which the launcher gives up
loudly. It is deliberately DISTINCT from the in-process breaker —
the breaker keys on training progress, the budget keys on wall clock,
because a relaunch cycle that makes progress every time can still be
pathological if it churns the fleet every few seconds.

``supervise_gang`` is the relaunch loop itself, factored process-free
(it drives any ``run_gang()`` callable) so the budget policy is
testable without OS processes; a launcher wires it to real
``python -m singa_tpu_torch.main`` ranks, and may relaunch at another
process count than the drained gang ran with: the reshard-on-restore
path (resilience/reshard.py) makes that a no-op for the training
state.
"""

from __future__ import annotations

import time

from .preemption import EXIT_FAILED, EXIT_OK, EXIT_RESUMABLE


class RestartBudget:
    """At most ``max_per_window`` spends per rolling ``window_s``
    seconds. ``max_per_window <= 0`` = unbudgeted (every spend
    granted). ``clock`` is injectable for tests (monotonic seconds)."""

    def __init__(
        self,
        max_per_window: int,
        window_s: float,
        *,
        clock=time.monotonic,
    ):
        self.max_per_window = int(max_per_window)
        self.window_s = float(window_s)
        self._clock = clock
        self._spent: list[float] = []  # spend timestamps, oldest first

    @classmethod
    def from_config(cls, res_cfg) -> "RestartBudget":
        """Budget from a ``ResilienceConfig`` (None = unbudgeted)."""
        if res_cfg is None:
            return cls(0, 0.0)
        return cls(
            getattr(res_cfg, "max_restarts_per_window", 0),
            getattr(res_cfg, "restart_window_s", 3600.0),
        )

    def _prune(self, now: float) -> None:
        cutoff = now - self.window_s
        while self._spent and self._spent[0] <= cutoff:
            self._spent.pop(0)

    @property
    def used(self) -> int:
        """Spends still inside the rolling window."""
        self._prune(self._clock())
        return len(self._spent)

    def spend(self) -> bool:
        """Take one restart from the budget; False = budget exhausted
        (the caller must give up instead of relaunching)."""
        now = self._clock()
        self._prune(now)
        if self.max_per_window > 0 and len(self._spent) >= self.max_per_window:
            return False
        self._spent.append(now)
        return True


def gang_verdict(exit_codes: list[int]) -> str:
    """Classify one gang attempt's exit codes:

    ``ok``         every rank exited 0 — the job is done.
    ``resumable``  at least one rank DELIBERATELY exited resumable
                   (75: a drain or a watchdog peer-death exit), and
                   every other non-zero exit is either 75 too or a
                   SIGNAL death (negative Popen returncode: SIGKILL'd
                   by the OOM killer, preempted before the handler
                   ran). A signal-killed rank never got to exit 75
                   itself, but its peers' watchdogs vouched for the
                   gang with their own 75s and its state is in the
                   committed checkpoint — the relaunch case. With NO
                   75 in the gang there is no such vouching: an
                   all-signal-death gang (a deterministic native
                   SIGSEGV, say) is ``fatal`` — under the default
                   unbudgeted config it would otherwise respawn
                   forever, unseen by the in-process breaker too (the
                   process died before Python could count anything).
    ``fatal``      anything else: a positive non-resumable status (a
                   crash the in-process supervisor refused to retry,
                   a usage error) or signal deaths with no resumable
                   witness. Relaunching would replay it — give up and
                   surface it.
    """
    if all(rc == EXIT_OK for rc in exit_codes):
        return "ok"
    if EXIT_RESUMABLE in exit_codes and all(
        rc in (EXIT_OK, EXIT_RESUMABLE) or rc < 0 for rc in exit_codes
    ):
        return "resumable"
    return "fatal"


def supervise_gang(
    run_gang,
    budget: RestartBudget,
    *,
    log=print,
    on_relaunch=None,
) -> int:
    """Drive ``run_gang()`` (-> list of per-rank exit codes) to
    completion under the restart budget. Resumable gangs relaunch while
    the budget grants; an exhausted budget or a fatal rank gives up
    loudly with the gang's worst status. ``on_relaunch(attempt)`` runs
    before each relaunch — the elastic hook (resize the gang, pick a
    new nprocs) lives there."""
    attempt = 0
    while True:
        attempt += 1
        codes = list(run_gang())
        verdict = gang_verdict(codes)
        if verdict == "ok":
            if attempt > 1:
                log(f"launcher: gang complete (attempt {attempt})")
            return EXIT_OK
        if verdict == "fatal":
            bad = [
                rc for rc in codes
                if rc != EXIT_OK and rc != EXIT_RESUMABLE
            ]
            log(
                f"launcher: GIVING UP — rank exit status(es) {bad} are "
                "not resumable (a crash the in-process supervisor "
                "refused to retry, or signal deaths with no resumable "
                "witness); not relaunching"
            )
            positive = [rc for rc in bad if rc > 0]
            return max(positive) if positive else EXIT_FAILED
        if not budget.spend():
            log(
                "launcher: GIVING UP — restart budget exhausted "
                f"({budget.max_per_window} relaunch(es) per "
                f"{budget.window_s:g}s window); a drain/death cycle "
                "this hot needs an operator, not another relaunch"
            )
            return EXIT_RESUMABLE
        log(
            f"launcher: gang exited resumable (attempt {attempt}, "
            f"budget {budget.used}/{budget.max_per_window or 'inf'} "
            "in window) — relaunching"
        )
        if on_relaunch is not None:
            on_relaunch(attempt)
