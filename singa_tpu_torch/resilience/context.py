"""ResilienceContext: the object the trainer's step-boundary seams call,
the PyTorch counterpart of ``singa_tpu/resilience/context.py``.

One context lives for a whole supervised job (across restart attempts —
that is what makes the fault plan fire-once and the watchdog/preemption
state coherent). The trainer holds it as ``trainer.resilience`` and
calls exactly four seams, all host-side, all outside the step (and its
CUDA graph):

  before_step(trainer, step)    watchdog heartbeat; crash/sigterm/
                                slowstep fault injection; preemption
                                drain (save + PreemptionDrained)
  after_step(trainer, step)     guard rollback policy (counter read at
                                most once per rollback window — never
                                per step); returns the possibly
                                rolled-back step to continue from
  inject_batch_faults(...)      nanloss poisoning of one step's batch
                                (the poisoned step runs eager on it)
  checkpoint_written(...)       corrupt_ckpt fault; validation; LATEST
                                marking; keep-last-N retention

A trainer with ``resilience = None`` (the default) skips all of it.
"""

from __future__ import annotations

import os
import time

import torch

from ..config.schema import ResilienceConfig
from . import coord, retention
from .async_ckpt import AsyncCheckpointer
from .faults import FaultPlan, InjectedCrash, tear_file
from .guard import GuardGaveUp
from .preemption import PreemptionDrained, PreemptionHandler
from .watchdog import Watchdog


class ResilienceContext:
    def __init__(
        self,
        res_cfg: ResilienceConfig | None = None,
        plan: FaultPlan | None = None,
        log=print,
        recorder=None,
    ):
        self.cfg = res_cfg if res_cfg is not None else ResilienceConfig()
        self.plan = plan if plan is not None else FaultPlan()
        self.log = log
        #: flight recorder (obs/recorder.py); None = telemetry off. The
        #: plan shares it so every fault firing is an event regardless
        #: of which seam fired it.
        self.recorder = recorder
        self.plan.recorder = recorder
        #: profile@K trigger state (torch.profiler bracket)
        self._profiling = False
        self._profiler = None
        self._profile_start = 0
        self._profile_stop_at: int | None = None
        self._profile_dir: str | None = None
        self.preemption = PreemptionHandler()
        self.watchdog = Watchdog(self.cfg.watchdog_timeout, log)
        #: zero-stall checkpoint pipeline (resilience/async_ckpt.py);
        #: None = the synchronous save path. ONE writer across restart
        #: attempts, like the fault plan — ordinals stay coherent.
        self.async_ckpt = (
            AsyncCheckpointer(plan=self.plan, log=log)
            if self.cfg.async_checkpoint
            else None
        )
        #: guard rollbacks performed (surfaced in the display line)
        self.rollbacks = 0
        #: <workspace>/checkpoints, once a trainer with a workspace binds
        self.ckpt_dir: str | None = None
        #: 1-based ordinal of checkpoint saves (corrupt_ckpt@K keys on it)
        self.save_ordinal = 0
        self._last_guard_check = -(10**9)
        #: rollback livelock defense: consecutive rollbacks that never
        #: got past the step that tripped the previous one
        self._stuck_rollbacks = 0
        self._rollback_high_step = -1
        #: process count, refreshed at bind (the process group is up)
        self._nprocs = 1

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    @property
    def per_step(self) -> bool:
        """Fault plans need exact step boundaries: the trainer disables
        multi-step chunking for the whole drill (fired or not — a drill
        run stays deterministic over chunk throughput)."""
        return bool(self.plan)

    @property
    def coordinated_exit(self) -> bool:
        """True when this rank's drain is guaranteed to be cluster-wide
        (single process, or the coordinated drain is on) — i.e. when a
        drained exit may publish the 'deliberate exit' sentinel without
        stranding peers in a collective."""
        return self._nprocs <= 1 or bool(self.cfg.coordinate_preemption)

    def bind(self, trainer) -> None:
        """Attach to a (possibly restarted) trainer instance."""
        trainer.resilience = self
        self.ckpt_dir = trainer._checkpoint_dir()
        self._nprocs = coord.process_count()
        if self.recorder is not None:
            # one recorder spans restart attempts, like the fault plan;
            # each trainer incarnation re-wires its timers' span sink
            trainer.attach_telemetry(self.recorder)
            self.watchdog.recorder = self.recorder
            if self.async_ckpt is not None:
                self.async_ckpt.recorder = self.recorder
        #: where profile@K traces land (resolved at bind: needs the
        #: trainer's cluster workspace + telemetry block)
        self._profile_dir = None
        if trainer.cluster is not None and trainer.cluster.workspace:
            tel = getattr(trainer.cfg, "telemetry", None)
            sub = tel.profile_subfolder if tel is not None else "xprof"
            self._profile_dir = os.path.join(
                trainer.cluster.workspace, sub
            )
        # peer-liveness heartbeats (watchdog.py): each rank's watchdog
        # thread touches <workspace>/heartbeats/rank_k.hb while the
        # process lives; a peer file stale past heartbeat_timeout_s
        # while OUR step is stalled turns a forever-hung collective
        # into a loud resumable exit
        if (
            self.cfg.heartbeat_timeout_s > 0
            and self._nprocs > 1
            and trainer.cluster is not None
            and trainer.cluster.workspace
        ):
            self.watchdog.enable_heartbeats(
                os.path.join(trainer.cluster.workspace, "heartbeats"),
                rank=coord.process_index(),
                nprocs=self._nprocs,
                peer_timeout=self.cfg.heartbeat_timeout_s,
            )
        self.watchdog.beat(trainer.start_step)
        self.watchdog.start()

    def mark_done(self) -> None:
        """A deliberate exit (training complete, or a coordinated
        drain): publish the done sentinel so peers' liveness watchdogs
        never read our frozen heartbeat as a death."""
        self.watchdog.mark_done()

    def stop(self) -> None:
        # a profile bracket the run never reached the end of (early
        # drain, crash, train_steps inside the window) still writes its
        # trace out instead of vanishing with the process
        self._stop_profile(None)
        self.watchdog.stop()
        if self.async_ckpt is not None:
            self.async_ckpt.stop()

    def flush_async(self, raise_errors: bool = True) -> None:
        """Durability barrier: block until every submitted async
        checkpoint write is on disk and published. No-op when the
        synchronous path is in use."""
        if self.async_ckpt is not None:
            self.async_ckpt.flush(raise_errors=raise_errors)

    # ------------------------------------------------------------------
    # step-boundary seams
    # ------------------------------------------------------------------

    def before_step(self, trainer, step: int) -> None:
        self.watchdog.beat(step)
        if self.recorder is not None:
            self.recorder.step = step  # cheap attribute stamp, no I/O
        # profile@K[:steps=N] trigger (obs): stop first — a bracket
        # ending at THIS boundary must close before a new one opens —
        # then start, so the torch.profiler trace covers exactly the
        # steps [K, K+N) that run after this seam
        if self._profile_stop_at is not None and step >= self._profile_stop_at:
            self._stop_profile(step)
        spec = self.plan.fire("profile", step)
        if spec is not None:
            self._start_profile(step, spec)
        spec = self.plan.fire("slowstep", step)
        if spec is not None:
            dur = 1.0 if spec.value is None else spec.value
            self.log(f"FAULT: slowstep@{step} — stalling {dur:g}s")
            time.sleep(dur)
        spec = self.plan.fire("sigterm", step)
        if spec is not None:
            self.log(f"FAULT: sigterm@{step} — synthetic SIGTERM")
            self.preemption.trigger(f"injected sigterm@{step}")
        spec = self.plan.fire("crash", step)
        if spec is not None:
            self.log(f"FAULT: crash@{step} — raising InjectedCrash")
            raise InjectedCrash(f"injected crash@{step}")
        local = self.preemption.requested
        requested = local
        if self.cfg.coordinate_preemption and self._nprocs > 1:
            # coordinated drain (resilience/coord.py): fold every
            # host's flag into a cross-host OR at this boundary — one
            # tiny allgather riding the loop's existing sync cadence —
            # so any host's SIGTERM drains EVERY host at THIS step
            requested = coord.preemption_barrier(requested)
            if requested and self.recorder is not None:
                # the barrier outcome, per rank: `local` tells a
                # post-mortem which host was actually signalled and
                # which learned of it through the OR
                self.recorder.event(
                    "drain_barrier", step=step,
                    local=bool(local), cluster=True,
                )
            if requested and not self.preemption.requested:
                self.preemption.trigger(
                    "coordinated drain (a peer host was preempted)"
                )
        if requested:
            self._drain(trainer, step)

    def _drain(self, trainer, step: int) -> None:
        """Write the final checkpoint and leave with resumable status.
        Called at a step boundary, so nothing is in flight — the current
        step/chunk has fully drained."""
        # close any open profiler bracket first: the trace must land on
        # disk before the process exits 75
        self._stop_profile(step)
        path = None
        if self.cfg.preemption_checkpoint:
            path = trainer.save(step)
            # the final checkpoint must be DURABLE before exit 75 — the
            # launcher may relaunch the moment the process dies
            self.flush_async()
        where = (
            f", final checkpoint {path}"
            if path
            else ", no workspace configured — state not checkpointed"
        )
        self.log(
            f"PREEMPTION: {self.preemption.reason} — drained at "
            f"step {step}{where}; exiting resumable"
        )
        if self.recorder is not None:
            self.recorder.event(
                "drain", step=step,
                reason=self.preemption.reason, checkpoint=path,
            )
            # the process is about to exit — the drain record must not
            # die in the buffer
            self.recorder.flush()
        raise PreemptionDrained(step, path)

    def after_step(self, trainer, step: int) -> int:
        """Guard rollback policy. The counter read is a host sync, so it
        runs at most once per rollback window (and once at the end of
        the run), never per step."""
        self.watchdog.beat(step)
        g = trainer._guard
        if g is None or g.policy != "kRollback":
            return step
        due = step - self._last_guard_check >= g.rollback_after
        if not due and step < trainer.cfg.train_steps:
            return step
        self._last_guard_check = step
        consec = trainer.guard_counters()["consecutive_bad"]
        if consec < g.rollback_after:
            return step
        return self._rollback(trainer, step, consec)

    def _rollback(self, trainer, step: int, consec: int) -> int:
        g = trainer._guard
        # livelock defense: a rollback restores params, stream
        # positions, AND the per-step RNG folds exactly — a
        # deterministic divergence (NaN baked into the data) replays
        # identically no matter how far the LR backs off. Rolling back
        # again without ever getting PAST the previous trigger step can
        # therefore never converge; give up loudly instead of burning
        # the reservation in silence.
        if step > self._rollback_high_step:
            self._stuck_rollbacks = 1
        else:
            self._stuck_rollbacks += 1
        self._rollback_high_step = max(self._rollback_high_step, step)
        limit = max(2, self.cfg.max_restarts)
        if self._stuck_rollbacks > limit:
            raise GuardGaveUp(
                f"{self._stuck_rollbacks} rollbacks without progress "
                f"past step {self._rollback_high_step} — the divergence "
                "replays deterministically; refusing to livelock"
            )
        new_scale = trainer.guard_counters()["lr_scale"] * g.lr_backoff
        # land any in-flight async write first: the rollback should
        # restore the NEWEST complete checkpoint, not race its publish
        self.flush_async(raise_errors=False)
        path = retention.resolve_latest(self.ckpt_dir)
        if self._nprocs > 1:
            # every process rolls back at this same step (the verdict is
            # global): all take process 0's LATEST, which its own save
            # path has already published, never a stale read of their own
            path = coord.broadcast_from_0(path)
        if path is None:
            self.log(
                f"GUARD: {consec} consecutive bad steps at step {step} "
                "but no checkpoint to roll back to — resetting the "
                f"counter and backing the LR scale off to {new_scale:g}"
            )
            if self.recorder is not None:
                self.recorder.event(
                    "guard_rollback", step=step, consecutive_bad=consec,
                    checkpoint=None, lr_scale=new_scale,
                )
            trainer.set_guard_state(consec=0, lr_scale=new_scale)
            return step
        self.log(
            f"GUARD: {consec} consecutive bad steps at step {step} — "
            f"rolling back to {path}, LR scale -> {new_scale:g}"
        )
        rolled = trainer.rollback_to(path)
        self.rollbacks += 1
        if self.recorder is not None:
            # verdict detail: what tripped (consecutive non-finite
            # steps), where training rewound to, the compounded backoff
            self.recorder.event(
                "guard_rollback", step=step, consecutive_bad=consec,
                checkpoint=path, resumed_step=rolled, lr_scale=new_scale,
                rollbacks=self.rollbacks,
            )
            self.recorder.flush()
        trainer.set_guard_state(consec=0, lr_scale=new_scale)
        # re-arm the window from the rollback point so the next check
        # happens a full window after training resumes
        self._last_guard_check = rolled
        return rolled

    def inject_batch_faults(self, trainer, step: int, batch):
        """nanloss@step: poison the step's batch, its images NaN (labels
        keep their values). ``batch`` is the batch (the engine's layout:
        ``{layer: {"image", "label"}}``, or the replica engine's list of
        them over the ranks, None for other processes' ranks) or a
        zero-argument function that draws it, called only when the fault
        fires; then None comes back when nothing fired. A token feed
        (kSequenceData) cannot hold NaN: it takes id 0, what the JAX
        package's int cast of its NaN images gives."""
        if self.plan.fire("nanloss", step) is None:
            return None if callable(batch) else batch
        self.log(f"FAULT: nanloss@{step} — poisoning the step's batch")
        if callable(batch):
            batch = batch()
        tokens = {l.name for l in trainer.train_net.datalayers
                  if getattr(l, "TYPE", "") == "kSequenceData"}

        def poison(b):
            if b is None:
                return None
            out = {}
            for name, feed in b.items():
                img = feed["image"]
                if name in tokens:
                    bad = torch.zeros_like(img)
                else:
                    bad = torch.full(img.shape, float("nan"),
                                     dtype=torch.float32, device=img.device)
                out[name] = {"image": bad, "label": feed["label"]}
            return out

        if isinstance(batch, list):
            return [poison(b) for b in batch]
        return poison(batch)

    # ------------------------------------------------------------------
    # profiler trigger (profile@K[:steps=N] — obs plane)
    # ------------------------------------------------------------------

    def _start_profile(self, step: int, spec) -> None:
        """Open a ``torch.profiler`` bracket over steps [step, step+N).
        Rides the fault-plan plumbing, so it is fire-once, rank-
        targetable, and forces the per-step boundaries that make the
        bracket exact. Degrades to a logged no-op when the profiler (or
        a workspace to write into) is unavailable."""
        if self._profiling:
            self.log(
                f"PROFILE: trigger at step {step} ignored — a trace is "
                "already running"
            )
            return
        if not self._profile_dir:
            self.log(
                f"PROFILE: trigger at step {step} ignored — no "
                "workspace configured for the trace directory"
            )
            return
        nsteps = spec.steps if spec.steps is not None else 1
        try:
            from torch.profiler import ProfilerActivity, profile

            os.makedirs(self._profile_dir, exist_ok=True)
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=acts)
            self._profiler.start()
        except Exception as e:  # profiler availability is host-dependent
            self.log(
                f"PROFILE: could not start torch.profiler trace "
                f"({type(e).__name__}: {e}) — continuing unprofiled"
            )
            return
        self._profiling = True
        self._profile_stop_at = step + nsteps
        self._profile_start = step
        self.log(
            f"PROFILE: tracing steps [{step}, {step + nsteps}) -> "
            f"{self._profile_dir}"
        )
        if self.recorder is not None:
            self.recorder.event(
                "profile_start", step=step,
                stop_at=step + nsteps, dir=self._profile_dir,
            )

    def _stop_profile(self, step: int | None) -> None:
        """Close the open bracket (if any) and write its Chrome trace,
        ``trace_step<K>.json``; ``step=None`` marks a lifecycle close
        (drain / run end) rather than the scheduled boundary."""
        self._profile_stop_at = None
        if not self._profiling:
            return
        self._profiling = False
        try:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._profiler.stop()
            self._profiler.export_chrome_trace(os.path.join(
                self._profile_dir, f"trace_step{self._profile_start}.json"))
        except Exception as e:
            self.log(
                f"PROFILE: stop failed ({type(e).__name__}: {e})"
            )
            return
        finally:
            self._profiler = None
        where = f"at step {step}" if step is not None else "at shutdown"
        self.log(f"PROFILE: trace stopped {where} -> {self._profile_dir}")
        if self.recorder is not None:
            self.recorder.event(
                "profile_stop", step=step, dir=self._profile_dir,
            )

    # ------------------------------------------------------------------
    # checkpoint hook
    # ------------------------------------------------------------------

    def checkpoint_written(self, trainer, path: str, step: int) -> None:
        del trainer
        self.save_ordinal += 1
        spec = self.plan.fire("corrupt_ckpt", self.save_ordinal)
        if spec is not None:
            tear_file(path)
            self.log(
                f"FAULT: corrupt_ckpt@{self.save_ordinal} — tore {path}"
            )
        spec = self.plan.fire("torn_sidecar", self.save_ordinal)
        if spec is not None:
            # the replica .server sidecar beside the save (written just
            # before this hook): tear IT, not the shards — validation
            # must reject the whole save on the sidecar alone
            tear_file(path + ".server")
            self.log(
                f"FAULT: torn_sidecar@{self.save_ordinal} — tore "
                f"{path}.server"
            )
        rec = self.recorder
        if rec is not None:
            # every rank records its own write (async path: from the
            # writer thread — the recorder is thread-safe); for sharded
            # saves the rank's commit marker (phase 1 of the two-phase
            # commit) is already on disk at this point
            payload = {"path": path, "ordinal": self.save_ordinal}
            if os.path.isdir(path):
                payload["commit_marker"] = os.path.exists(
                    coord.commit_marker_path(path, coord.process_index())
                )
            rec.event("ckpt_written", step=step, **payload)
        # validation, LATEST, and retention are process 0's job alone:
        # every process racing rmtree/marker writes on the same dir
        # would be chaos. For sharded saves, promotion is the second
        # phase of the commit protocol (resilience/coord.py): wait for
        # every rank's CRC'd commit_k marker, verify each against its
        # shard, and on a missed deadline judge the save TORN — never
        # early, never with whatever shards happen to exist.
        if coord.process_index() != 0:
            return
        committed = True
        if os.path.isdir(path):
            committed = coord.await_commits(
                path, timeout=self.cfg.commit_timeout_s, log=self.log
            )
            if rec is not None:
                rec.event(
                    "ckpt_commit", step=step, path=path,
                    ok=bool(committed),
                )
        folder = os.path.dirname(path)
        if committed and retention.validate_checkpoint(path):
            retention.mark_latest(folder, path)
            if rec is not None:
                rec.event("ckpt_latest", step=step, path=path)
        else:
            self.log(
                f"WARNING: checkpoint {path} failed validation — "
                "LATEST keeps pointing at the previous complete save"
            )
            if rec is not None:
                rec.event("ckpt_invalid", step=step, path=path)
        if self.cfg.keep_last > 0:
            for gone in retention.apply_retention(folder, self.cfg.keep_last):
                self.log(f"retention: removed {gone}")

