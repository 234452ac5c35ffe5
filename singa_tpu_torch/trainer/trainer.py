"""The training engine, single-device synchronous path.

Counterpart of ``singa_tpu/trainer/trainer.py``: the reference's
worker-side stack (Worker::Start/Run/RunOneBatch,
src/worker/worker.cc:14-106,187-213, and Executor::TrainOneBatch,
:304-316) as an eager PyTorch step driven by the same cadence loop.
A step is one forward over the float32 master params cast to the
compute dtype (so autograd returns float32 grads), ``backward``, and
the updater's elementwise update.

Cadence semantics match the reference's predicates exactly
(include/worker/worker.h:118-158): XNow(step) = freq > 0 and
step >= after and (step - after) % freq == 0; tests/validation run
*before* the train step of the step they trigger on (worker.cc:190-200).

What this slice leaves out, and refuses with a ConfigError that names
it rather than ignoring: a mesh (a cluster with more than one worker or
any parallel axis), ``zero_update``, ``grad_comm``, ``kernels``,
``ring``, ``resilience``, ``fleet``, ``pipeline_microbatches``, the
sharded checkpoint format, and the contrastive-divergence and replica
engines. Also left out: the device-resident dataset, scan chunks, input
prefetch and telemetry (the step here is one dispatch per batch).
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from ..config.schema import ClusterConfig, ConfigError, ModelConfig
from ..data.pipeline import BatchPipeline
from ..device import resolve_device
from ..graph.builder import Net, active_phases, build_net
from ..optim import make_updater
from ..params import init_params
from ..utils import Performance, Timers
from .checkpoint import load_stream_positions, restore_into, save_checkpoint

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _now(step: int, freq: int, after: int) -> bool:
    """The reference's {Display,Test,Validate}Now predicate (worker.h:118-158)."""
    return freq > 0 and step >= after and (step - after) % freq == 0


def unsupported(model_cfg: ModelConfig,
                cluster_cfg: ClusterConfig | None) -> list[str]:
    """The conf knobs this engine does not port yet, by name."""
    out = []
    for knob in ("grad_comm", "kernels", "ring", "resilience", "fleet"):
        if getattr(model_cfg, knob, None) is not None:
            out.append(knob)
    if model_cfg.zero_update:
        out.append("zero_update")
    if model_cfg.pipeline_microbatches:
        out.append("pipeline_microbatches")
    if model_cfg.checkpoint_format != "npz":
        out.append(f"checkpoint_format {model_cfg.checkpoint_format!r}")
    if model_cfg.alg != "kBackPropagation":
        out.append(f"alg {model_cfg.alg!r}")
    if cluster_cfg is not None:
        if (cluster_cfg.nworkers or 1) > 1:
            out.append(f"cluster nworkers {cluster_cfg.nworkers}")
        if cluster_cfg.nservers:
            out.append(f"cluster nservers {cluster_cfg.nservers}")
        for axis in ("nprocs_per_group", "nseq_per_group",
                     "nexperts_per_group", "npipes_per_group"):
            if getattr(cluster_cfg, axis) > 1:
                out.append(f"cluster {axis} {getattr(cluster_cfg, axis)}")
    return out


class Trainer:
    """Builds nets, owns params/updater state, runs the cadence loop on
    one device (``device=None`` is the GPU; pass ``"cpu"`` for the
    CPU)."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        cluster_cfg: ClusterConfig | None = None,
        *,
        seed: int = 0,
        log: Callable[[str], None] = print,
        device=None,
    ):
        self.device = resolve_device(device)
        missing = unsupported(model_cfg, cluster_cfg)
        if missing:
            raise ConfigError(
                "not ported to singa_tpu_torch yet (single-device "
                f"synchronous training only): {', '.join(missing)}"
            )
        self.cfg = model_cfg
        self.cluster = cluster_cfg
        self.log = log
        self.perf = Performance()
        self.timers = Timers()

        # --- nets (SetupNeuralNet x3, phase-filtered; worker.cc:16-27) ---
        phases = active_phases(model_cfg)
        self.train_net = build_net(model_cfg, "kTrain")
        self.test_net: Net | None = (
            build_net(model_cfg, "kTest") if "kTest" in phases else None
        )
        self.val_net: Net | None = (
            build_net(model_cfg, "kValidation")
            if "kValidation" in phases
            else None
        )

        # --- params + updater (ParamManager ctor + InitParams) ---
        self.specs = self.train_net.param_specs()
        if model_cfg.updater is None:
            raise ConfigError("model config has no updater block")
        self.updater = make_updater(model_cfg.updater)
        self._init_gen = torch.Generator().manual_seed(seed)

        self.start_step = model_cfg.step
        self._materialize_params()

        # --- input pipelines (the Prefetching protocol's host half) ---
        self._pipelines: dict[int, dict[str, BatchPipeline]] = {}
        for net in self._nets():
            self._pipelines[id(net)] = {
                l.name: BatchPipeline(
                    l.images,
                    l.labels,
                    l.batchsize,
                    random_skip=l.random_skip if net is self.train_net else 0,
                    seed=seed,
                )
                for l in net.datalayers
            }
        self._seek_resumed_streams()
        #: last step boundary reached
        self.completed_steps = self.start_step

        if model_cfg.checkpoint_frequency and self._checkpoint_dir() is None:
            self.log(
                "WARNING: checkpoint_frequency is set but no cluster "
                "workspace is configured — no snapshots will be written "
                "(pass -cluster_conf with a workspace field)"
            )

        # --- mixed precision (ModelProto.compute_dtype) ---
        self._compute_dtype = None
        if model_cfg.compute_dtype:
            dt = _DTYPES.get(model_cfg.compute_dtype)
            if dt is None:
                raise ConfigError(
                    f"unknown compute_dtype {model_cfg.compute_dtype!r}"
                )
            if dt != torch.float32:
                self._compute_dtype = dt

        self._batch_size = self.train_net.batchsize
        #: tokens consumed per train step (LM configs), for the display
        #: line's tok/s
        self.tokens_per_step = sum(
            l.batchsize * int(np.prod(l.sample_shape))
            for l in self.train_net.datalayers
            if getattr(l, "TYPE", "") == "kSequenceData"
        )

    def _nets(self) -> list[Net]:
        return [n for n in (self.train_net, self.test_net, self.val_net)
                if n is not None]

    # ------------------------------------------------------------------
    # params
    # ------------------------------------------------------------------

    def _materialize_params(self) -> None:
        """Initialize params + updater slots on the device and overlay
        the resume checkpoint (fills Worker::Resume, worker.cc:65-67)."""
        params = init_params(self._init_gen, self.specs, self.device)
        state = self.updater.init_state(params)
        buffers: dict = {}
        self._resume_streams: dict[str, int] = {}
        if self.cfg.checkpoint:
            ck_step, params, state, buffers = restore_into(
                self.cfg.checkpoint, params, state, buffers
            )
            self._resume_streams = load_stream_positions(self.cfg.checkpoint)
            self.start_step = max(self.start_step, ck_step)
            self.log(
                f"resumed from {self.cfg.checkpoint} at step {self.start_step}"
            )
        self.params = params
        self.state = state
        self.buffers = buffers

    def _seek_resumed_streams(self) -> None:
        for net in self._nets():
            for name, pipe in self._pipelines.get(id(net), {}).items():
                pos = self._resume_streams.get(f"{net.phase}|{name}")
                if pos is not None:
                    pipe.seek(pos)

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------

    def _cast_compute(self, tree):
        """Cast float tensors to the compute dtype (params keep float32
        masters: the cast is part of the autograd graph, so the grads
        come back float32). The batch is cast too, as in the JAX
        package: token ids pass through bf16, exact for ids <= 256."""
        if self._compute_dtype is None:
            return tree
        if isinstance(tree, dict):
            return {k: self._cast_compute(v) for k, v in tree.items()}
        if isinstance(tree, torch.Tensor) and tree.is_floating_point():
            return tree.to(self._compute_dtype)
        return tree

    def _step_core(self, step: int, batch: dict) -> dict:
        """One forward + backward + update; -> the step's metrics."""
        names = list(self.params)
        leaves = {n: self.params[n].detach().requires_grad_(True)
                  for n in names}
        loss, metrics = self.train_net.forward(
            self._cast_compute(leaves), self._cast_compute(batch),
            training=True,
        )
        loss.backward()
        grads = {
            n: (leaves[n].grad if leaves[n].grad is not None
                else torch.zeros_like(leaves[n]))
            for n in names
        }
        self.params, self.state = self.updater.apply(
            step, self.params, grads, self.state, self.specs
        )
        return metrics

    def _next_batch(self, net: Net) -> dict:
        """Host batch assembly + transfer for ``net``'s data layers."""
        out = {}
        for name, pipe in self._pipelines[id(net)].items():
            images, labels = pipe.next_batch()
            out[name] = {
                "image": torch.from_numpy(images).to(self.device),
                "label": torch.from_numpy(labels).to(self.device),
            }
        return out

    def train_one_batch(self, step: int) -> None:
        """TrainOneBatch (worker.cc:304-316): one forward+backward+update."""
        with self.timers.phase("data"):
            batch = self._next_batch(self.train_net)
        with self.timers.phase("train"):
            metrics = self._step_core(step, batch)
        self.perf.update(metrics)

    # ------------------------------------------------------------------
    # eval
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _eval_batch_metrics(self, net: Net, batch: dict) -> dict:
        """One eval batch -> {losslayer: metrics}."""
        _, metrics = net.forward(
            self._cast_compute(self.params), self._cast_compute(batch),
            training=False,
        )
        return metrics

    def evaluate(self, net: Net, nsteps: int, phase: str, step: int) -> dict:
        """Test/Validate (worker.cc:318-348): nsteps batches, averaged."""
        perf = Performance()
        with self.timers.phase("eval", steps=nsteps):
            for _ in range(nsteps):
                perf.update(
                    self._eval_batch_metrics(net, self._next_batch(net))
                )
        avg = perf.avg()
        self.log(f"step {step}: {phase} {perf.to_string(avg)}")
        return avg

    # ------------------------------------------------------------------
    # cadence loop
    # ------------------------------------------------------------------

    def _pre_events(self, step: int) -> None:
        """Validation/test run BEFORE the train step of their trigger step
        (worker.cc:190-200)."""
        cfg = self.cfg
        if self.val_net is not None and _now(
            step, cfg.validation_frequency, cfg.validation_after_steps
        ):
            self.evaluate(
                self.val_net, cfg.validation_steps, "validation", step
            )
        if self.test_net is not None and _now(
            step, cfg.test_frequency, cfg.test_after_steps
        ):
            self.evaluate(self.test_net, cfg.test_steps, "test", step)

    def _post_events(self, step: int) -> None:
        """Display/checkpoint run AFTER the train step."""
        cfg = self.cfg
        if _now(step, cfg.display_frequency, cfg.display_after_steps):
            sps = steps_s = 0.0
            t = self.timers.total("train") + self.timers.total("data")
            if t > 0:
                sps = self.perf.count * self._batch_size / t
                steps_s = self.perf.count / t
            rate = f"{sps:.0f} samples/s, {steps_s:.1f} steps/s"
            if self.tokens_per_step and steps_s > 0:
                rate += f", {steps_s * self.tokens_per_step:.0f} tok/s"
            avg = self.perf.avg()
            self.log(
                f"step {step}: train {self.perf.to_string(avg)} "
                f"[{self.timers.to_string()}; {rate}]"
            )
            self.perf.reset()
            self.timers.reset()
        # snapshot labels carry the RESUME step (steps completed)
        done = step + 1
        if (
            _now(done, cfg.checkpoint_frequency, cfg.checkpoint_after_steps)
            and done > self.start_step
            and done < cfg.train_steps  # run() writes the final snapshot
        ):
            self.save(done)

    def run_one_batch(self, step: int) -> None:
        """RunOneBatch (worker.cc:187-213): cadences around the train step."""
        self._pre_events(step)
        self.train_one_batch(step)
        self._post_events(step)

    def run(self) -> None:
        """Worker::Run (worker.cc:98-106): the step-at-a-time loop."""
        step = self.start_step
        self.completed_steps = step
        while step < self.cfg.train_steps:
            self.run_one_batch(step)
            step += 1
            self.completed_steps = step
        if self._checkpoint_dir() is not None:
            self.save(self.cfg.train_steps)

    # ------------------------------------------------------------------
    # checkpoint
    # ------------------------------------------------------------------

    def _checkpoint_dir(self) -> str | None:
        if self.cluster is not None and self.cluster.workspace:
            return os.path.join(self.cluster.workspace, "checkpoints")
        return None

    def _stream_positions(self) -> dict[str, int]:
        return {
            f"{net.phase}|{name}": pipe.position
            for net in self._nets()
            for name, pipe in self._pipelines[id(net)].items()
        }

    def save(self, step: int) -> str | None:
        """npz snapshot into ``<workspace>/checkpoints/step_<step>.npz``."""
        folder = self._checkpoint_dir()
        if folder is None:
            return None
        path = os.path.join(folder, f"step_{step}.npz")
        with self.timers.phase("ckpt"):
            save_checkpoint(path, step, self.params, self.state,
                            self.buffers, streams=self._stream_positions())
        self.log(f"step {step}: checkpoint -> {path}")
        return path
