"""The supervised train loop: crash -> restore newest checkpoint -> retry.
The PyTorch counterpart of ``singa_tpu/resilience/supervisor.py``.

``run()`` owns the whole training lifetime the way the reference's
parameter-server tier owned model state (src/main.cc:49-55 — a restarted
worker group could rejoin and refetch): with no server tier, the
supervisor is the trainer-side replacement. Per attempt it locates the
newest *complete* checkpoint (resilience/retention.py — the LATEST
marker, falling back over torn saves), points the model config at it,
rebuilds the trainer, and runs. Failures restart with bounded
exponential backoff; a crash-loop circuit breaker gives up loudly after
``max_restarts`` consecutive failures that each made less than
``restart_window_steps`` steps of progress. SIGTERM/SIGINT surface as
``PreemptionDrained`` (state already checkpointed) and exit with the
distinct resumable status code so launchers can tell "relaunch me" from
"debug me".

Jobs with no ``resilience`` config block and no fault plan take a
transparent single-attempt path — exactly the pre-supervisor behavior.
Every training job of ``python -m singa_tpu_torch.main`` comes through
here. A failed attempt's trainer is closed (its feeder threads parked,
its captured CUDA graphs and tensors dropped) before the next attempt
builds its own.
"""

from __future__ import annotations

import gc
import os
import time

from ..config.schema import ModelConfig, ResilienceConfig
from . import retention
from .context import ResilienceContext
from .faults import FaultPlan
from .guard import GuardGaveUp
from .preemption import (
    EXIT_OK,
    EXIT_RESUMABLE,
    PreemptionDrained,
)


def _banner(trainer, model_cfg: ModelConfig) -> None:
    trainer.log(
        f"training {model_cfg.name!r}: steps "
        f"[{trainer.start_step}, {model_cfg.train_steps}), "
        f"batch {trainer.train_net.batchsize}, mesh {dict(trainer.mesh.shape)}"
    )


def _release(trainer) -> None:
    """Close a failed attempt's trainer and return its device memory."""
    if trainer is not None:
        trainer.close()
    gc.collect()
    import torch

    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _record_start(rec, trainer, model_cfg, attempt: int, resumed) -> None:
    """The run_start event: run identity (run id = config hash), where
    this attempt begins, and the topology a post-mortem needs."""
    from .coord import process_count

    rec.event(
        "run_start",
        step=trainer.start_step,
        attempt=attempt,
        name=model_cfg.name,
        train_steps=model_cfg.train_steps,
        batch=trainer.train_net.batchsize,
        mesh={k: int(v) for k, v in dict(trainer.mesh.shape).items()},
        nprocs=process_count(),
        pid=os.getpid(),
        resumed_from=resumed,
    )
    rec.flush()


def run(
    model_cfg: ModelConfig,
    cluster_cfg=None,
    *,
    seed: int = 0,
    faults: str | FaultPlan | None = None,
    log=print,
    trainer_factory=None,
    on_complete=None,
    **trainer_kwargs,
) -> int:
    """Train ``model_cfg`` to completion under supervision; returns the
    process exit code (EXIT_OK / EXIT_RESUMABLE). A crash the circuit
    breaker refuses to retry propagates — loudly — to the caller.
    ``on_complete(trainer)`` runs after a complete run, before the
    return (``main``'s per-process report reads the trainer there)."""
    if trainer_factory is None:
        from ..trainer import make_trainer as trainer_factory
    plan = (
        faults if isinstance(faults, FaultPlan) else FaultPlan.parse(faults)
    )
    trainer_kwargs.setdefault("log", log)

    # flight recorder (singa_tpu/obs/): always-on when the job has a
    # workspace to write into; one recorder spans every restart attempt
    # so the per-rank event log is the whole job's story
    from ..obs.recorder import recorder_for_job

    rec = recorder_for_job(model_cfg, cluster_cfg, log=log)

    res = model_cfg.resilience
    if res is None and not plan:
        # unsupervised jobs keep their exact pre-supervisor behavior
        trainer = trainer_factory(
            model_cfg, cluster_cfg, seed=seed, **trainer_kwargs
        )
        _banner(trainer, model_cfg)
        if rec is None:
            trainer.run()
            if on_complete is not None:
                on_complete(trainer)
            return EXIT_OK
        trainer.attach_telemetry(rec)
        _record_start(rec, trainer, model_cfg, attempt=1, resumed=None)
        try:
            trainer.run()
            if on_complete is not None:
                on_complete(trainer)
            rec.event(
                "run_stop", step=model_cfg.train_steps,
                status="ok", exit_code=EXIT_OK,
            )
            return EXIT_OK
        except BaseException as e:
            rec.event(
                "run_stop", status="crashed",
                error=f"{type(e).__name__}: {e}",
            )
            raise
        finally:
            rec.close()

    if res is None:
        res = ResilienceConfig()
    ctx = ResilienceContext(res, plan, log=log, recorder=rec)
    if not ctx.preemption.install():
        log(
            "resilience: cannot install signal handlers (not the main "
            "thread) — synthetic/injected preemption only"
        )
    ckpt_dir = None
    if cluster_cfg is not None and cluster_cfg.workspace:
        ckpt_dir = os.path.join(cluster_cfg.workspace, "checkpoints")
    configured_ckpt = model_cfg.checkpoint
    failures = 0  # consecutive low-progress failures (the breaker's count)
    attempt = 0
    try:
        while True:
            attempt += 1
            # land any async write the crashed attempt left in flight:
            # the restart must resume from the newest save that actually
            # finished publishing, not race the writer for it (no-op on
            # the synchronous path; errors already logged by the writer)
            ctx.flush_async(raise_errors=False)
            # auto-resume: the newest complete checkpoint beats the
            # config's warm-start path; a torn/corrupt newest save falls
            # back to the one before it (retention.resolve_latest)
            latest = retention.resolve_latest(ckpt_dir)
            model_cfg.checkpoint = latest or configured_ckpt
            # elastic restore: a sharded save written by a DIFFERENT
            # world size is not an error — the trainer reshards it onto
            # this topology (resilience/reshard.py). Announce it here,
            # before the rebuild, so a post-mortem can see the N->M
            # transition even if the restore itself then fails
            if model_cfg.checkpoint:
                from .coord import process_count
                from .reshard import checkpoint_nprocs

                saved_np = checkpoint_nprocs(model_cfg.checkpoint)
                if saved_np is not None and saved_np != process_count():
                    log(
                        f"supervisor: elastic restore — "
                        f"{model_cfg.checkpoint} was written by "
                        f"{saved_np} process(es), this job runs "
                        f"{process_count()}; resharding on load"
                    )
                    if rec is not None:
                        rec.event(
                            "reshard",
                            checkpoint=model_cfg.checkpoint,
                            saved_nprocs=saved_np,
                            nprocs=process_count(),
                            attempt=attempt,
                        )
            trainer = None
            try:
                trainer = trainer_factory(
                    model_cfg, cluster_cfg, seed=seed, **trainer_kwargs
                )
                ctx.bind(trainer)
                _banner(trainer, model_cfg)
                if rec is not None:
                    _record_start(
                        rec, trainer, model_cfg,
                        attempt=attempt, resumed=latest,
                    )
                trainer.run()
                # the end-of-run checkpoint must be durable before the
                # job reports success (raises if the write failed)
                ctx.flush_async()
                log(
                    f"supervisor: training complete at step "
                    f"{model_cfg.train_steps} (attempt {attempt})"
                )
                if on_complete is not None:
                    on_complete(trainer)
                # deliberate exit: peers must not read our now-frozen
                # heartbeat as a death (watchdog.py done sentinel)
                ctx.mark_done()
                if rec is not None:
                    rec.event(
                        "run_stop", step=model_cfg.train_steps,
                        status="ok", exit_code=EXIT_OK, attempt=attempt,
                    )
                return EXIT_OK
            except PreemptionDrained as e:
                log(
                    f"supervisor: preempted at step {e.step} — "
                    f"exiting resumable (status {EXIT_RESUMABLE})"
                )
                if ctx.coordinated_exit:
                    # every rank drained at this same step (or there is
                    # only one) — a deliberate exit, not a death
                    ctx.mark_done()
                if rec is not None:
                    # the exit-75 record post-mortems key on: this rank
                    # left deliberately, resumable, at this step
                    rec.event(
                        "run_stop", step=e.step, status="preempted",
                        exit_code=EXIT_RESUMABLE, attempt=attempt,
                        checkpoint=e.checkpoint,
                    )
                return EXIT_RESUMABLE
            except GuardGaveUp as e:
                # a deterministic divergence replays identically after
                # every restore — restarting would loop forever (each
                # attempt makes nominal step progress before tripping,
                # so the breaker alone would keep re-arming)
                log(
                    f"supervisor: GIVING UP — divergence guard declared "
                    f"the failure unrecoverable ({e}); not restarting"
                )
                if rec is not None:
                    rec.event(
                        "run_stop", status="guard_gave_up",
                        attempt=attempt, error=str(e),
                    )
                raise
            except Exception as e:  # the supervisor survives ANY crash
                start = trainer.start_step if trainer is not None else 0
                done = (
                    getattr(trainer, "completed_steps", start)
                    if trainer is not None
                    else start
                )
                progress = max(0, done - start)
                window = max(1, res.restart_window_steps)
                if progress >= window:
                    failures = 0  # real progress re-arms the breaker
                failures += 1
                log(
                    f"supervisor: attempt {attempt} died at step {done} "
                    f"({type(e).__name__}: {e}); {progress} step(s) of "
                    "progress since restore"
                )
                if rec is not None:
                    rec.event(
                        "crash", step=done, attempt=attempt,
                        error=f"{type(e).__name__}: {e}",
                        progress=progress,
                    )
                from .coord import process_count

                if process_count() > 1:
                    # a single rank restarting in-process would rejoin
                    # peers whose collectives are steps ahead — they
                    # can never re-align. Exit resumable instead: the
                    # cluster launcher restarts EVERY rank from the
                    # newest complete checkpoint (our peers' liveness
                    # watchdogs turn their hung collectives into the
                    # same resumable exit). NOT mark_done: peers must
                    # see this exit as the death it is.
                    log(
                        "supervisor: multi-process job — skipping "
                        "in-process restart (peers' collectives would "
                        f"desync); exiting resumable ({EXIT_RESUMABLE}) "
                        "so the launcher restarts all ranks together"
                    )
                    if rec is not None:
                        rec.event(
                            "run_stop", step=done, status="crashed",
                            exit_code=EXIT_RESUMABLE, attempt=attempt,
                        )
                    return EXIT_RESUMABLE
                if failures > res.max_restarts:
                    log(
                        "supervisor: GIVING UP — "
                        f"{failures} failure(s), each with fewer than "
                        f"{window} step(s) of progress "
                        f"(max_restarts {res.max_restarts}); re-raising"
                    )
                    if rec is not None:
                        rec.event(
                            "run_stop", step=done, status="gave_up",
                            attempt=attempt, failures=failures,
                        )
                    raise
                delay = min(
                    res.backoff_max,
                    res.backoff_base * (2 ** (failures - 1)),
                )
                log(
                    f"supervisor: restart {failures}/{res.max_restarts} "
                    f"in {delay:g}s"
                )
                if rec is not None:
                    # restart with cause and backoff — flushed now: the
                    # next attempt may die before its display cadence
                    rec.event(
                        "restart", step=done, attempt=attempt,
                        failures=failures, backoff_s=delay,
                        cause=f"{type(e).__name__}: {e}",
                    )
                    rec.flush()
                # release the failed attempt before the next one builds:
                # its feeder threads, graphs and device tensors
                _release(trainer)
                trainer = None
                if delay > 0:
                    time.sleep(delay)
    finally:
        ctx.stop()
        ctx.preemption.uninstall()
        model_cfg.checkpoint = configured_ckpt
        if rec is not None:
            rec.close()
