"""Fault-tolerance runtime, the PyTorch counterpart of
``singa_tpu/resilience``: supervised auto-resume, preemption-safe
checkpointing, a divergence guard, and deterministic fault injection.

  supervisor.py   the supervised train loop (crash -> restore newest
                  complete checkpoint -> bounded-backoff retry ->
                  crash-loop circuit breaker); every training job of
                  ``python -m singa_tpu_torch.main`` runs through it
  retention.py    keep-last-N + atomic LATEST marker + torn-save defense
  preemption.py   SIGTERM/SIGINT -> drain -> final checkpoint ->
                  resumable exit code (EXIT_RESUMABLE, 75); a flag-only
                  handler, no CUDA call inside it
  guard.py        the loss/grad-norm finiteness verdict on the device,
                  inside the step (and its CUDA graph), with skip /
                  rollback-with-LR-backoff policies; no per-step host
                  sync
  async_ckpt.py   zero-stall checkpointing: a device-to-device snapshot
                  into a double buffer at the step boundary, its copy to
                  pinned host memory on a side stream, and a background
                  writer publishing through retention's atomic LATEST
                  (``async_checkpoint: true``)
  coord.py        the cross-process plane: the coordinated preemption
                  drain, the sharded saves' commit markers and process
                  0's wait for them, the atomic publish
  watchdog.py     step-wall-clock watchdog (stack dumps) + per-rank
                  heartbeat files with a peer-liveness deadline
  reshard.py      restore of a sharded save written by N processes onto
                  M ranks, and the serving restore
  launcher.py     the launcher-side restart budget and the gang-relaunch
                  loop (``supervise_gang``)
  faults.py       the deterministic fault plan (``crash@7,...``, with an
                  optional ``:rank=K`` target), training and fleet kinds
  context.py      ResilienceContext: what the trainer's step-boundary
                  seams call

Config: the ``resilience { ... }`` block; CLI: ``-faults`` /
``SINGA_TPU_FAULTS``. ``supervisor`` is imported lazily (it pulls in the
trainer package): ``from singa_tpu_torch.resilience import supervisor``.
"""

from . import coord  # noqa: F401
from .async_ckpt import AsyncCheckpointer, AsyncWriteError  # noqa: F401
from .context import ResilienceContext  # noqa: F401
from .faults import (  # noqa: F401
    FaultPlan,
    FaultPlanError,
    FaultSpec,
    InjectedCrash,
    tear_file,
)
from .guard import (  # noqa: F401
    GUARD_BAD,
    GUARD_CONSEC,
    GUARD_KEYS,
    GUARD_LR,
    GuardGaveUp,
    GuardSpec,
    init_guard_buffers,
)
from .launcher import (  # noqa: F401
    RestartBudget,
    gang_verdict,
    supervise_gang,
)
from .preemption import (  # noqa: F401
    EXIT_FAILED,
    EXIT_OK,
    EXIT_RESUMABLE,
    PreemptionDrained,
    PreemptionHandler,
)
from .reshard import (  # noqa: F401
    Resharder,
    ReshardError,
    check_manifest,
    checkpoint_nprocs,
    hostable,
)
from .retention import (  # noqa: F401
    LATEST_MARKER,
    apply_retention,
    gc_stale_shards,
    mark_latest,
    resolve_latest,
    validate_checkpoint,
)
from .watchdog import Watchdog  # noqa: F401
