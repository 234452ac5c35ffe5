"""Step-wall-clock watchdog + peer-liveness heartbeats, the PyTorch
counterpart of ``singa_tpu/resilience/watchdog.py`` (the same code). The
watch thread reads only the host's clock, files and Python frames: it
makes no CUDA call, so a step stuck on the card cannot stall it.

A multi-host collective that loses a peer does not crash — it hangs, and
the job burns its reservation in silence. Two defenses live here:

**Stall diagnostics** (single- and multi-host): a host-side daemon
thread fed a heartbeat at every step/chunk boundary; when the gap since
the last beat exceeds the configured timeout it dumps diagnostics (the
stalled step number, the elapsed time, and every thread's Python stack)
through the job log, once per stall. It never kills anything — a
transient straggler must not become a guaranteed restart.

**Peer liveness** (multi-host): each rank's watchdog thread touches a
per-rank heartbeat file (``<workspace>/heartbeats/rank_k.hb``) every
poll — file freshness means "process alive", deliberately NOT "step
advancing", so a peer grinding through a slow compile never reads as
dead. When (a) our OWN step has been stalled longer than the peer
deadline — we are stuck, almost certainly in a collective — and (b) a
peer's heartbeat file is stale past the same deadline, the peer process
is presumed dead and this rank exits with the RESUMABLE status (75): a
forever-hung collective becomes a loud, launcher-restartable event. A
rank that exits deliberately (trained to completion, or a coordinated
preemption drain) publishes a ``rank_k.done`` sentinel first, so its
now-frozen heartbeat is never mistaken for a death.

Staleness is judged by TWO signals, either of which proves life: the
file's mtime, and a monotonic beat counter written into the file body.
The counter exists for workspaces on object-store/NFS mounts whose
mtimes are coarse (second granularity), cached, or clock-skewed across
hosts — there a perfectly healthy peer's mtime can read stale for
longer than a tight deadline, and mtime alone would false-positive
``peer_death`` and kill a live job. A counter that ADVANCES between our
polls restarts the peer's staleness clock locally (observer-side
monotonic time, no cross-host clock comparison at all); a frozen
counter leaves the verdict to the mtime-vs-arming math exactly as
before, so bodiless heartbeat files from older runs still work.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback

from .preemption import EXIT_RESUMABLE


def heartbeat_file(directory: str, rank: int) -> str:
    return os.path.join(directory, f"rank_{rank}.hb")


def read_heartbeat_counter(path: str) -> int | None:
    """The monotonic beat counter in a heartbeat file's body, or None
    (absent file, empty/foreign body — e.g. a pre-counter run's
    touch-only file). Never raises: liveness must degrade to the mtime
    signal, not crash the watch thread."""
    try:
        with open(path, "rb") as f:
            return int(f.read(32).split(b"\n", 1)[0])
    except (OSError, ValueError):
        return None


def done_file(directory: str, rank: int) -> str:
    return os.path.join(directory, f"rank_{rank}.done")


class Watchdog:
    """Monitor thread: ``beat(step)`` at boundaries, dump on stall,
    optionally watch peer heartbeats (``enable_heartbeats``)."""

    def __init__(self, timeout: float, log=print):
        self.timeout = float(timeout)
        self.log = log
        #: flight recorder (obs/recorder.py): stall dumps and peer-death
        #: verdicts were stderr-only — as events they survive into the
        #: post-mortem trace even when nobody captured the process's
        #: stderr. None = telemetry off.
        self.recorder = None
        self._lock = threading.Lock()
        self._last_beat = time.monotonic()
        self._last_step = -1
        self._dumped_for = -2  # step already diagnosed (once per stall)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        #: stall dumps emitted (tests and post-mortems read this)
        self.stalls = 0
        #: peer-liveness state (None = disabled); see enable_heartbeats
        self._hb: dict | None = None
        #: orders mark_done's final touch+sentinel against the watch
        #: thread's periodic touches (sentinel mtime must stay >= our
        #: heartbeat mtime once we declare the exit deliberate)
        self._hb_lock = threading.Lock()
        #: peers this instance declared dead (tests read it; also keeps
        #: a non-exiting on_peer_dead callback from firing per poll)
        self.dead_peers: set[int] = set()
        #: our own monotonic beat counter (heartbeat file body)
        self._beat_seq = 0
        #: peer rank -> (last counter seen, staleness clock, last time
        #: WE looked): the observer-side staleness clock that makes
        #: peer liveness survive coarse-mtime filesystems. The
        #: last-look stamp distinguishes "counter advanced since a
        #: poll moments ago" (alive) from "counter differs from an
        #: observation made during a stall episode hours back" (no
        #: evidence either way — start fresh)
        self._peer_seen: dict[int, tuple[int, float, float]] = {}

    def enable_heartbeats(
        self,
        directory: str,
        rank: int,
        nprocs: int,
        peer_timeout: float,
        on_peer_dead=None,
    ) -> None:
        """Arm peer liveness BEFORE ``start()``: touch our own heartbeat
        file every poll, and declare a peer dead when its file is stale
        past ``peer_timeout`` seconds while our own step is stalled at
        least as long. ``on_peer_dead(rank, age)`` defaults to a loud
        resumable exit (os._exit(75)). Peers get a full ``peer_timeout``
        of grace from the moment we arm — a rank still initializing is
        not dead."""
        os.makedirs(directory, exist_ok=True)
        self._hb = {
            "dir": directory,
            "rank": int(rank),
            "nprocs": int(nprocs),
            "timeout": float(peer_timeout),
            # wall clock, because it is compared against file mtimes
            "enabled_at": time.time(),
            "on_dead": on_peer_dead or self._exit_peer_dead,
            "done": False,
        }
        # a fresh incarnation of this rank: a stale done sentinel from
        # the previous run must not mask THIS run's death to our peers
        try:
            os.unlink(done_file(directory, int(rank)))
        except OSError:
            pass
        self._touch_heartbeat()

    def mark_done(self) -> None:
        """Publish "this rank exited deliberately" (end of training, or
        a coordinated drain): peers must not read the now-frozen
        heartbeat as a death. The final heartbeat touch and the
        sentinel write happen under the same lock the watch thread's
        periodic touch takes, so sentinel mtime >= heartbeat mtime
        holds — a racing touch can never reorder past it."""
        hb = self._hb
        if hb is None:
            return
        with self._hb_lock:
            hb["done"] = True  # the watch thread stops touching
            self._touch_heartbeat()
            with open(done_file(hb["dir"], hb["rank"]), "w"):
                pass

    def start(self) -> None:
        if (self.timeout <= 0 and self._hb is None) or self._thread:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._watch, name="singa-tpu-watchdog", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def beat(self, step: int) -> None:
        with self._lock:
            self._last_beat = time.monotonic()
            self._last_step = step

    # ------------------------------------------------------------------
    # watch thread
    # ------------------------------------------------------------------

    def _poll_interval(self) -> float:
        ts = [self.timeout]
        if self._hb is not None:
            ts.append(self._hb["timeout"])
        ts = [t for t in ts if t > 0]
        t = min(ts) if ts else 1.0
        # poll fast enough to catch a stall promptly without busy-waiting
        return max(0.01, min(t / 4.0, 1.0))

    def _watch(self) -> None:
        poll = self._poll_interval()
        while not self._stop.wait(poll):
            hb = self._hb
            if hb is not None:
                with self._hb_lock:
                    if not hb["done"]:
                        self._touch_heartbeat()
            with self._lock:
                elapsed = time.monotonic() - self._last_beat
                step, dumped = self._last_step, self._dumped_for
            if hb is not None and elapsed > hb["timeout"]:
                self._check_peers(hb)
            if self.timeout <= 0 or elapsed <= self.timeout or step == dumped:
                continue
            self._dump(step, elapsed)
            with self._lock:
                self._dumped_for = step
                self.stalls += 1

    def _touch_heartbeat(self) -> None:
        hb = self._hb
        path = heartbeat_file(hb["dir"], hb["rank"])
        self._beat_seq += 1
        try:
            # mtime AND a monotonic counter in the body: coarse-mtime
            # mounts (object store / NFS) get their liveness from the
            # advancing counter. Published atomically (tmp + rename,
            # the coord-plane primitive): a truncate-then-write here
            # would hand a racing reader an EMPTY body — and on exactly
            # the coarse-mtime mounts the counter exists for, "fall
            # back to mtime" IS the false-positive death verdict.
            from .coord import atomic_write_bytes

            atomic_write_bytes(
                path, f"{self._beat_seq}\n".encode("ascii")
            )
            os.utime(path, None)
        except OSError:
            pass  # a flaky shared FS must not kill the watchdog thread

    @staticmethod
    def _mtime(path: str) -> float | None:
        try:
            return os.stat(path).st_mtime
        except OSError:
            return None

    def _check_peers(self, hb: dict) -> None:
        """Our own step is stalled past the peer deadline — are we stuck
        because a peer process died mid-collective?"""
        now = time.time()
        now_mono = time.monotonic()
        for k in range(hb["nprocs"]):
            if k == hb["rank"] or k in self.dead_peers:
                continue
            peer_path = heartbeat_file(hb["dir"], k)
            hb_m = self._mtime(peer_path)
            # grace from arming: a peer that has not beaten yet is
            # (still) initializing, not dead
            age = now - max(hb_m or 0.0, hb["enabled_at"])
            if age <= hb["timeout"]:
                continue
            # second signal: the body's beat counter. An mtime stale
            # past the deadline on a coarse-mtime mount says nothing if
            # the counter is still advancing — restart the staleness
            # clock from OUR OWN monotonic observation of the change
            # (no cross-host clock enters the verdict). The FIRST
            # observation is backdated to two polls short of the
            # deadline: a live peer gets two polls to demonstrate an
            # advancing counter, while a genuinely dead peer's verdict
            # lands ~two polls after the mtime deadline — not a whole
            # extra timeout of silent hang.
            seq = read_heartbeat_counter(peer_path)
            if seq is not None:
                last = self._peer_seen.get(k)
                if last is None or now_mono - last[2] > hb["timeout"]:
                    # first look — or our last look predates this
                    # stall episode (_check_peers only runs while WE
                    # are stalled), so a differing counter would say
                    # nothing about the peer's recent liveness. Start
                    # a fresh clock, backdated to two polls short of
                    # the deadline: the peer beats at the same
                    # ~timeout/4 cadence we poll at, so a live one
                    # gets two observation gaps to demonstrate an
                    # advancing counter while a dead one's verdict
                    # lands ~two polls later — not a whole extra
                    # timeout of silent hang
                    grace = 2.0 * self._poll_interval()
                    self._peer_seen[k] = (
                        seq, now_mono - hb["timeout"] + grace, now_mono
                    )
                    continue
                if last[0] != seq:
                    self._peer_seen[k] = (seq, now_mono, now_mono)
                    continue  # advanced since our last look: alive
                self._peer_seen[k] = (seq, last[1], now_mono)
                if now_mono - last[1] <= hb["timeout"]:
                    continue  # changed recently enough: alive
            done_m = self._mtime(done_file(hb["dir"], k))
            deliberate = (
                done_m is not None
                and (hb_m is None or done_m >= hb_m)
                # a sentinel older than OUR arming (minus one deadline
                # of clock slack) is a PREVIOUS incarnation's clean
                # exit — a peer that died in THIS run before arming
                # (it clears its own sentinel at enable_heartbeats)
                # must not be masked by it
                and done_m >= hb["enabled_at"] - hb["timeout"]
            )
            if deliberate:
                continue  # deliberate exit (trained / coordinated drain)
            self.dead_peers.add(k)
            if self.recorder is not None:
                # recorded (and flushed) BEFORE the verdict callback:
                # the default callback is os._exit(75), which would
                # otherwise take the buffered verdict down with it
                self.recorder.event(
                    "peer_death", peer=k, stale_s=round(age, 3),
                    deadline_s=hb["timeout"],
                )
                self.recorder.flush()
            hb["on_dead"](k, age)

    def _exit_peer_dead(self, rank: int, age: float) -> None:
        hb = self._hb
        self.log(
            f"WATCHDOG: peer rank {rank} heartbeat stale {age:.1f}s "
            f"(deadline {hb['timeout']:.1f}s) while this rank's step is "
            "stalled — peer presumed dead mid-collective; exiting "
            f"resumable ({EXIT_RESUMABLE}) so the launcher can restart "
            "every rank from the last complete checkpoint"
        )
        sys.stdout.flush()
        sys.stderr.flush()
        # the hung collective can never complete once the peer is gone;
        # os._exit is the only exit that does not need the main thread
        os._exit(EXIT_RESUMABLE)

    def _dump(self, step: int, elapsed: float) -> None:
        lines = [
            f"WATCHDOG: step {step} has run {elapsed:.1f}s "
            f"(timeout {self.timeout:.1f}s) — possible hung collective "
            "or straggler; thread stacks follow"
        ]
        names = {t.ident: t.name for t in threading.enumerate()}
        for ident, frame in sys._current_frames().items():
            if names.get(ident) == "singa-tpu-watchdog":
                continue
            lines.append(f"--- thread {names.get(ident, ident)} ---")
            lines.append("".join(traceback.format_stack(frame)).rstrip())
        self.log("\n".join(lines))
        if self.recorder is not None:
            # the full dump rides the event (bounded — a pathological
            # thread count must not bloat the log past usefulness);
            # flushed now because a stalled run may never reach its
            # next display boundary
            self.recorder.event(
                "watchdog_stall", step=step,
                elapsed_s=round(elapsed, 3), timeout_s=self.timeout,
                stacks="\n".join(lines[1:])[:16384],
            )
            self.recorder.flush()
