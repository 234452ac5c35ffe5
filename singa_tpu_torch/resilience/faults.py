"""Deterministic fault injection, the PyTorch counterpart of
``singa_tpu/resilience/faults.py``: the same plan grammar, parsed the
same way.

A fault plan is a comma-separated list of ``kind@at`` terms (optionally
``kind@at=value``, optionally qualified with ``:rank=K``, ``:steps=N``,
``:ms=N`` or ``:peer=H``), from the ``-faults`` flag of
``python -m singa_tpu_torch.main`` (or ``SINGA_TPU_FAULTS``). Every
kind of the JAX package parses and fires, so one plan string drills both
packages. The training kinds fire at the Trainer's step-boundary seams
(``resilience/context.py``), never inside the step, so a drilled run's
steps are the same as a clean run's:

  crash@7          raise InjectedCrash at the step-7 boundary (before the
                   step runs): the supervisor's auto-resume
  sigterm@12       a synthetic SIGTERM at the step-12 boundary: the
                   preemption drain and the resumable exit (75)
  nanloss@5        poison step 5's batch: its images NaN (a token feed
                   takes id 0, the JAX package's cast of NaN), its labels
                   kept; the step runs eager on the fed batch, and the
                   divergence guard judges it
  corrupt_ckpt@1   tear the 1st checkpoint written (a 1-based ordinal,
                   between the save and the LATEST mark)
  torn_sidecar@1   tear the replica engine's ``.server`` sidecar of the
                   1st checkpoint written
  slowstep@9=0.5   sleep 0.5 s at the step-9 boundary: the watchdog
  async_torn_write@1  tear the 1st asynchronous write and kill its
                   publication (``resilience/async_ckpt.py``): LATEST
                   must keep naming the previous complete save
  profile@20:steps=5  not a fault: bracket steps 20..25 with
                   ``torch.profiler`` into <workspace>/<profile_subfolder>

and the serving fleet's:

  torn_weights@K   the K-th ``weight_ship`` a fleet host receives is
                   torn in half before decoding: the frame's CRC must
                   reject it and the rollout controller retries, then
                   quarantines the version (serve/rollout.py)
  swap_die@K       the host dies (InjectedCrash) at its K-th
                   ``weight_ship``: the rollout pauses
  wire_drop@K, wire_delay@K:ms=N, wire_dup@K, wire_torn@K,
  wire_partition@K[=S][:peer=H]
                   the socket transport's faults, keyed on the K-th
                   message send of this process (comm/faults.py)

Every fault fires once per plan object: the supervisor owns one plan
across its restart attempts, so ``crash@7`` does not fire again when the
resumed run passes step 7. A ``:rank=K`` term fires only in process K
(``coord.process_index``) and is not consumed elsewhere; a multi-process
job gives every process the same plan string (a plan forces per-step
boundaries, which every process must share).
"""

from __future__ import annotations

import dataclasses
import os


from .coord import process_index as _process_index


class FaultPlanError(ValueError):
    """The -faults string does not match the plan grammar."""


class InjectedCrash(RuntimeError):
    """The failure a ``crash@N`` fault raises at its step boundary."""


KINDS = (
    "crash",
    "sigterm",
    "nanloss",
    "corrupt_ckpt",
    "torn_sidecar",
    "slowstep",
    "async_torn_write",
    "profile",
    # live-rollout faults (serve/rollout.py): keyed on weight-ship
    # ORDINALS — `at` is the K-th weight_ship this HOST receives
    # (scope with :rank=K in multi-process drills). torn_weights tears
    # the staged artifact so the CRC rejects it (retry then quarantine,
    # serving uninterrupted); swap_die kills the host mid-stage
    # (tombstone -> failover per the wire path, rollout pauses)
    "torn_weights",
    "swap_die",
    # wire faults (comm/faults.py): keyed on message-send ORDINALS,
    # not steps — `at` is the K-th transport send this process makes.
    # ``wire_delay@K:ms=N`` stalls N ms; ``:peer=H`` scopes a term to
    # sends addressed to H (or names a partition's victim)
    "wire_drop",
    "wire_delay",
    "wire_dup",
    "wire_torn",
    "wire_partition",
)

#: kinds triggered by step number at the pre-step boundary seam
STEP_KINDS = ("crash", "sigterm", "slowstep", "profile")


def tear_file(path: str) -> None:
    """Simulate a torn write: truncate ``path`` to half its bytes (the
    proc_0 shard, for sharded checkpoint dirs): the tear the JAX
    package's corrupt_ckpt and async_torn_write faults make, for drills
    against ``retention.resolve_latest``."""
    target = path
    if os.path.isdir(path):
        target = os.path.join(path, "proc_0.npz")
    try:
        size = os.path.getsize(target)
        with open(target, "r+b") as f:
            f.truncate(max(1, size // 2))
    except OSError:
        pass


@dataclasses.dataclass
class FaultSpec:
    """One ``kind@at[=value][:ms=N][:steps=N][:peer=H][:rank=K]`` term;
    ``fired`` flips on injection. ``rank=None`` means every process;
    ``steps`` is the profile trigger's bracket length, ``ms`` the
    wire_delay stall, ``peer`` a wire term's target host (None
    elsewhere)."""

    kind: str
    at: int
    value: float | None = None
    rank: int | None = None
    steps: int | None = None
    ms: int | None = None
    peer: str | None = None
    fired: bool = False

    def __str__(self) -> str:
        v = "" if self.value is None else f"={self.value:g}"
        m = "" if self.ms is None else f":ms={self.ms}"
        s = "" if self.steps is None else f":steps={self.steps}"
        p = "" if self.peer is None else f":peer={self.peer}"
        r = "" if self.rank is None else f":rank={self.rank}"
        return f"{self.kind}@{self.at}{v}{m}{s}{p}{r}"


class FaultPlan:
    """A parsed, once-each fault schedule shared across restart attempts."""

    def __init__(self, specs: list[FaultSpec] | None = None):
        self.specs = list(specs or [])
        #: flight recorder (obs/recorder.py): a fleet host wires it so
        #: every firing becomes a telemetry event
        self.recorder = None

    @classmethod
    def parse(cls, text: str | None) -> "FaultPlan":
        specs: list[FaultSpec] = []
        for term in (text or "").split(","):
            term = term.strip()
            if not term:
                continue
            # qualifiers split off first: values are plain floats, so
            # every ':' starts a ":key=val" qualifier (rank=K, steps=N)
            body, *quals = term.split(":")
            rank = None
            steps = None
            ms = None
            peer = None
            for qual in quals:
                qkey, qsep, qval = qual.partition("=")
                if qkey not in ("rank", "steps", "ms", "peer") or not qsep:
                    raise FaultPlanError(
                        f"fault term {term!r}: unknown qualifier "
                        f"{qual!r} (expected ':rank=K', ':steps=N', "
                        "':ms=N' or ':peer=H')"
                    )
                if qkey == "peer":
                    if not qval:
                        raise FaultPlanError(
                            f"fault term {term!r}: empty peer name"
                        )
                    peer = qval
                    continue
                try:
                    qint = int(qval)
                except ValueError:
                    raise FaultPlanError(
                        f"fault term {term!r}: {qkey} {qval!r} is not "
                        "an integer"
                    ) from None
                if qkey == "rank":
                    if qint < 0:
                        raise FaultPlanError(
                            f"fault term {term!r}: negative rank"
                        )
                    rank = qint
                elif qkey == "ms":
                    if qint < 0:
                        raise FaultPlanError(
                            f"fault term {term!r}: negative ms"
                        )
                    ms = qint
                else:
                    if qint < 1:
                        raise FaultPlanError(
                            f"fault term {term!r}: steps must be >= 1"
                        )
                    steps = qint
            head, sep, val = body.partition("=")
            kind, sep2, at = head.partition("@")
            if not sep2:
                raise FaultPlanError(
                    f"fault term {term!r}: expected kind@step"
                )
            if kind not in KINDS:
                raise FaultPlanError(
                    f"fault term {term!r}: unknown kind {kind!r} "
                    f"(known: {', '.join(KINDS)})"
                )
            try:
                at_n = int(at)
            except ValueError:
                raise FaultPlanError(
                    f"fault term {term!r}: step {at!r} is not an integer"
                ) from None
            if at_n < 0:
                raise FaultPlanError(f"fault term {term!r}: negative step")
            value = None
            if sep:
                try:
                    value = float(val)
                except ValueError:
                    raise FaultPlanError(
                        f"fault term {term!r}: value {val!r} is not a number"
                    ) from None
            if steps is not None and kind != "profile":
                raise FaultPlanError(
                    f"fault term {term!r}: ':steps=N' only applies to "
                    "profile triggers"
                )
            if ms is not None and kind != "wire_delay":
                raise FaultPlanError(
                    f"fault term {term!r}: ':ms=N' only applies to "
                    "wire_delay terms"
                )
            if peer is not None and not kind.startswith("wire_"):
                raise FaultPlanError(
                    f"fault term {term!r}: ':peer=H' only applies to "
                    "wire_* terms"
                )
            specs.append(FaultSpec(kind, at_n, value, rank, steps, ms, peer))
        return cls(specs)

    def __bool__(self) -> bool:
        return bool(self.specs)

    def fire(self, kind: str, at: int, *, peer: str | None = None
             ) -> FaultSpec | None:
        """The unfired ``kind@at`` spec, marked fired — or None.

        Rank-qualified specs only fire on their target process; on any
        other rank they stay unfired (the qualifier scopes the fault,
        it must not be consumed by the ranks it skips). ``peer``-
        qualified wire specs likewise fire only when the caller's
        ``peer`` (the send's destination) matches."""
        for spec in self.specs:
            if spec.kind != kind or spec.at != at or spec.fired:
                continue
            if spec.rank is not None and spec.rank != _process_index():
                continue
            if (
                spec.peer is not None and peer is not None
                and spec.peer != peer
            ):
                continue
            spec.fired = True
            # profile is documented as NOT a fault — it gets its own
            # profile_start/profile_stop events (context.py), and must
            # not inflate a trace summary's fired-fault count
            if self.recorder is not None and kind != "profile":
                # corrupt_ckpt/async_torn_write key on save ORDINALS,
                # not steps — those events inherit the last stamped step
                step_keyed = kind in STEP_KINDS or kind == "nanloss"
                self.recorder.event(
                    "fault",
                    step=at if step_keyed else None,
                    fault=str(spec),
                    fault_kind=kind,
                    at=at,
                )
            return spec
        return None

    def unfired(self) -> list[FaultSpec]:
        return [s for s in self.specs if not s.fired]

    def __str__(self) -> str:
        return ",".join(str(s) for s in self.specs) or "<empty>"
