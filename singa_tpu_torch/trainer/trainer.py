"""The training engine: synchronous data-parallel training.

Counterpart of ``singa_tpu/trainer/trainer.py``: the reference's
worker-side stack (Worker::Start/Run/RunOneBatch,
src/worker/worker.cc:14-106,187-213, and Executor::TrainOneBatch,
:304-316) as an eager PyTorch step driven by the same cadence loop.

The data axis is a :class:`~singa_tpu_torch.parallel.Mesh`, rank ->
device (one rank on one device by default; ``mesh=`` or a cluster with
``nworkers`` gives more, and ranks may share a card). Each rank runs
one forward over the float32 master params cast to the compute dtype
(so autograd returns float32 grads) and ``backward`` on its contiguous
slice of the batch, and divides its grads by the width n. Then one of
three reductions:

  exact      the ranks' grads are summed (the JAX package's GSPMD psum);
  reference  ``grad_comm { mode: quantized }``: the sum goes through the
             quantize/dequantize seam with error feedback
             (``parallel.collectives.reduce_gradients``);
  ring       ``kernels { grad_allreduce: quantized_ring | q8_hier }``:
             the int8 ring of ``ops/quantized_collective.py`` reduces
             the per-rank grads, every reduce hop through the
             ``quant_acc`` kernel on the card.

The reduced grads are the same bits for every rank, so the updater's
elementwise update runs once per distinct device (params and updater
state exist once per device). Loss and metrics are averaged over the
ranks. Error-feedback residuals live in ``buffers`` under
``__gradres__/<param>`` as whole arrays, chunk r (along the ring's chunk
dim) belonging to rank r: the layout and ``b|`` checkpoint keys of the
JAX Trainer.

Random draws (dropout masks, crops, mirrors, distortion) come from a
generator per step, derived from the Trainer's seed and the step
(``utils.rng.fold_in``), then per rank and per layer (``Net.forward``):
a step's draws do not depend on the steps before it, as the JAX
Trainer's ``fold_in(step_key, step)`` does not. Eval passes none.

Cadence semantics match the reference's predicates exactly
(include/worker/worker.h:118-158): XNow(step) = freq > 0 and
step >= after and (step - after) % freq == 0; tests/validation run
*before* the train step of the step they trigger on (worker.cc:190-200).

What the port leaves out, and refuses with a ConfigError that names
it rather than ignoring: any parallel axis but the data axis,
``zero_update``, the named-axes ``ring { intra_axis/inter_axis }``,
``kernels`` fields other than ``grad_allreduce`` and ``interpret``,
``resilience``, ``fleet``, ``pipeline_microbatches``, the sharded
checkpoint format, and the contrastive-divergence and replica engines.
Also left out: the device-resident dataset, scan chunks, input prefetch
and telemetry (the step here is one dispatch per batch per rank).
"""

from __future__ import annotations

import functools
import os
from typing import Callable

import numpy as np
import torch

from ..config.schema import ClusterConfig, ConfigError, ModelConfig
from ..data.pipeline import BatchPipeline
from ..device import resolve_device
from ..graph.builder import Net, active_phases, build_net
from ..ops import quantized_collective as qc
from ..optim import make_updater
from ..parallel import (
    GradCommSpec,
    build_mesh,
    init_residuals,
    mesh_from_cluster,
    reduce_gradients,
    residual_key,
    reverse_topo_buckets,
)
from ..params import init_params
from ..utils import Performance, Timers
from ..utils.rng import fold_in
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
    for knob in ("resilience", "fleet"):
        if getattr(model_cfg, knob, None) is not None:
            out.append(knob)
    kernels = model_cfg.kernels
    if kernels is not None and kernels.paged_attention != "reference":
        out.append(f"kernels paged_attention {kernels.paged_attention!r}")
    ring = model_cfg.ring
    if ring is not None and (ring.intra_axis or ring.inter_axis):
        out.append("ring { intra_axis/inter_axis } (the named-axes form)")
    if model_cfg.zero_update:
        out.append("zero_update")
    if model_cfg.pipeline_microbatches:
        out.append("pipeline_microbatches")
    if model_cfg.checkpoint_format != "npz":
        out.append(f"checkpoint_format {model_cfg.checkpoint_format!r}")
    if model_cfg.alg != "kBackPropagation":
        out.append(f"alg {model_cfg.alg!r}")
    if cluster_cfg is not None:
        if cluster_cfg.nservers:
            out.append(f"cluster nservers {cluster_cfg.nservers}")
        for axis in ("nprocs_per_group", "nseq_per_group",
                     "nexperts_per_group", "npipes_per_group"):
            if getattr(cluster_cfg, axis) > 1:
                out.append(f"cluster {axis} {getattr(cluster_cfg, axis)}")
    return out


class Trainer:
    """Builds nets, owns params/updater state, runs the cadence loop
    over the ranks of a data-parallel mesh. Without ``mesh``: one rank on
    ``device`` (``None`` is the GPU; pass ``"cpu"`` for the CPU), or, for
    a cluster with ``nworkers``, one rank per worker group over the
    visible GPUs (over ``device`` repeated when one is given)."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        cluster_cfg: ClusterConfig | None = None,
        *,
        mesh=None,
        seed: int = 0,
        log: Callable[[str], None] = print,
        device=None,
    ):
        dev = resolve_device(device) if mesh is None else None
        missing = unsupported(model_cfg, cluster_cfg)
        if missing:
            raise ConfigError(
                "not ported to singa_tpu_torch yet (synchronous "
                f"data-parallel training only): {', '.join(missing)}"
            )
        if mesh is None and (cluster_cfg is None or not cluster_cfg.nworkers):
            mesh = build_mesh(1, 1, [dev])
        elif mesh is None:
            mesh = mesh_from_cluster(
                cluster_cfg,
                None if device is None else [dev] * cluster_cfg.nworkers,
            )
        self.mesh = mesh
        #: where params, state and buffers live (rank 0's device)
        self.device = mesh.devices[0]
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
        #: the root of every step's generator (the JAX Trainer's step key)
        self._step_gen = fold_in(torch.Generator().manual_seed(seed), 1)

        # --- gradient collectives (grad_comm + kernels.grad_allreduce) ---
        self._comm = GradCommSpec.from_config(
            model_cfg.grad_comm, model_cfg.kernels, model_cfg.ring
        )
        #: the ring's chunk dim per param (0 for every param: the update
        #: is replicated) and q8_hier's (K, M); None off the ring
        self._ring_chunk_dims: dict[str, int] | None = None
        self._ring_hier: tuple[int, int] | None = None
        ndata = len(mesh.devices)
        if self._comm is not None and self._comm.ring:
            self._setup_ring_collective()
        elif self.train_net.batchsize % ndata:
            raise ConfigError(
                f"data-parallel training needs the data-axis width "
                f"({ndata}: the mesh's ranks, or the cluster's nworkers "
                f"worker groups) to divide the batch "
                f"({self.train_net.batchsize}): each rank takes a "
                "contiguous slice of it"
            )

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
        """Initialize params + updater slots on every device of the mesh
        and the error-feedback residuals, and overlay the resume
        checkpoint (fills Worker::Resume, worker.cc:65-67)."""
        params = init_params(self._init_gen, self.specs, self.device)
        state = self.updater.init_state(params)
        buffers = init_residuals(params, self._comm)
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
        #: device -> {"params", "state"}: one copy per distinct device
        self._replicas: dict[torch.device, dict] = {
            dev: {} for dev in self.mesh.devices
        }
        self.params = params
        self.state = state
        self.buffers = buffers

    @property
    def params(self) -> dict:
        """The params (rank 0's device's copy; every device holds the
        same values). Assigning them sets every device's copy."""
        return self._replicas[self.device]["params"]

    @params.setter
    def params(self, value: dict) -> None:
        for dev, rep in self._replicas.items():
            rep["params"] = {n: v.to(dev) for n, v in value.items()}

    @property
    def state(self) -> dict:
        """The updater slots (rank 0's device's copy), like ``params``."""
        return self._replicas[self.device]["state"]

    @state.setter
    def state(self, value: dict) -> None:
        for dev, rep in self._replicas.items():
            rep["state"] = {
                n: {s: v.to(dev) for s, v in slots.items()}
                for n, slots in value.items()
            }

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

    def _rank_batch(self, batch: dict, r: int) -> dict:
        """Rank r's contiguous slice of the global batch, on its device
        (the JAX package's batch sharding over the data axis)."""
        n = len(self.mesh.devices)
        dev = self.mesh.devices[r]
        out = {}
        for name, feed in batch.items():
            out[name] = {}
            for k, v in feed.items():
                b = v.shape[0] // n
                out[name][k] = v[r * b:(r + 1) * b].to(dev)
        return out

    def _step_core(self, step: int, batch: dict) -> dict:
        """One forward + backward per rank, the reduction, the update on
        every device; -> the step's metrics, averaged over the ranks."""
        n = len(self.mesh.devices)
        names = list(self.params)
        grads, metrics = [], []
        step_gen = fold_in(self._step_gen, step)
        for r, dev in enumerate(self.mesh.devices):
            params = self._replicas[dev]["params"]
            leaves = {nm: params[nm].detach().requires_grad_(True)
                      for nm in names}
            loss, m = self.train_net.forward(
                self._cast_compute(leaves),
                self._cast_compute(self._rank_batch(batch, r)),
                training=True,
                generator=fold_in(step_gen, r),
            )
            loss.backward()
            # each rank's loss is its local batch mean: / n makes the sum
            # over ranks the global mean gradient
            grads.append({
                nm: (leaves[nm].grad if leaves[nm].grad is not None
                     else torch.zeros_like(leaves[nm])) / n
                for nm in names
            })
            metrics.append(m)
        if self._ring_chunk_dims is not None:
            reduced, res = self._ring_reduce(grads, self.buffers)
            # the reduced grads are the same bits on every rank: take the
            # first rank on each device
            by_dev = {dev: reduced[self.mesh.devices.index(dev)]
                      for dev in self._replicas}
        else:
            summed = {nm: functools.reduce(
                torch.add, (g[nm].to(self.device) for g in grads))
                for nm in names}
            res = {}
            if self._comm is not None:
                summed, res = reduce_gradients(
                    summed, self.buffers, self._comm, self._buckets(names)
                )
            by_dev = {dev: {nm: g.to(dev) for nm, g in summed.items()}
                      for dev in self._replicas}
        self.buffers = {**self.buffers, **res}
        for dev, rep in self._replicas.items():
            rep["params"], rep["state"] = self.updater.apply(
                step, rep["params"], by_dev[dev], rep["state"], self.specs
            )
        return {
            layer: {k: functools.reduce(torch.add, (
                torch.as_tensor(m[layer][k], device=self.device)
                for m in metrics)) / n for k in ms}
            for layer, ms in metrics[0].items()
        }

    # ------------------------------------------------------------------
    # gradient collectives (grad_comm, kernels.grad_allreduce)
    # ------------------------------------------------------------------

    @property
    def comm_mode(self) -> str:
        """``quantized`` (a scaled int8/bf16 wire cast with error
        feedback) or ``exact`` (float32)."""
        return ("quantized" if self._comm is not None and self._comm.quantized
                else "exact")

    @property
    def comm_dtype(self) -> str:
        """Wire dtype of the quantized reduction ("" when exact)."""
        if self._comm is not None and self._comm.quantized:
            return self._comm.dtype
        return ""

    @property
    def grad_wire_impl(self) -> str:
        """``reference``, ``quantized_ring`` or ``q8_hier`` ("" with no
        grad_comm machinery)."""
        return "" if self._comm is None else self._comm.wire_impl

    def _buckets(self, names) -> tuple:
        return reverse_topo_buckets(
            self.train_net, frozenset(names), self._comm.buckets, self.specs
        )

    def _setup_ring_collective(self) -> None:
        """Resolve the ring's geometry and refuse what it cannot run, with
        the JAX Trainer's messages (the JAX package's zero_update branch
        has no counterpart: the port refuses zero_update by name)."""
        impl = self._comm.wire_impl
        if self._comm.hier:
            geom = qc.hier_ring_geometry(self.mesh.shape, self._comm)
            if isinstance(geom, str):
                raise ConfigError(
                    f"kernels {{ grad_allreduce: q8_hier }} cannot "
                    f"run: {geom}"
                )
            self._ring_hier = geom[2:]
        ndata = len(self.mesh.devices)
        bs = self.train_net.batchsize
        if bs % ndata:
            raise ConfigError(
                f"{impl} needs the data-reduction width ({ndata}) to "
                f"divide the batch ({bs}): each shard computes its own "
                "local partial gradients"
            )
        shapes = {n: s.shape for n, s in self.specs.items()
                  if s.owner is None}
        chunk_dims = {n: 0 for n in shapes}
        reason = qc.ring_reducible(shapes, ndata, chunk_dims)
        if reason is not None:
            raise ConfigError(
                f"kernels.grad_allreduce {impl} cannot run: {reason}"
            )
        if not self._comm.interpret:
            reason = qc.ring_fusable(shapes, ndata, chunk_dims,
                                     interpret=False)
            if reason is not None:
                raise ConfigError(
                    f"kernels.grad_allreduce {impl} with "
                    f"interpret off cannot run: {reason}"
                )
        self._ring_chunk_dims = chunk_dims

    def _ring_reduce(self, grads: list, buffers: dict):
        """Per-rank local partials (already divided by n) through the
        ring -> (per-rank reduced grads, residual updates as whole
        arrays on rank 0's device). Rank r adds and banks chunk r of each
        residual."""
        n = len(grads)
        dims = self._ring_chunk_dims
        res = [{} for _ in range(n)]
        if self._comm.wants_residuals:
            for nm in grads[0]:
                key = residual_key(nm)
                for r, part in enumerate(buffers[key].chunk(n, dim=dims[nm])):
                    res[r][key] = part.to(self.mesh.devices[r])
        out, new_res = qc.ring_reduce_gradients(
            grads, res, self._buckets(grads[0]),
            chunk_dims=dims,
            dtype=self._comm.dtype,
            error_feedback=self._comm.error_feedback,
            residual_key=residual_key,
            hier=self._ring_hier,
        )
        whole = {
            key: torch.cat([nr[key].to(self.device) for nr in new_res],
                           dim=dims[nm])
            for nm in grads[0] if (key := residual_key(nm)) in new_res[0]
        }
        return out, whole

    def _ring_reduce_probe(self, grads: dict, res: dict):
        """The ring reduction alone, no forward: every rank takes
        ``grads`` (whole arrays) as its local partial, divided by n, so
        the reduction gives ``grads`` back; ``res`` holds whole residual
        arrays. -> (per-rank reduced grads, new residuals). The JAX
        Trainer's probe returns the reduced grads once, replicated; here
        every rank's copy comes back, so a caller can hold them equal."""
        n = len(self.mesh.devices)
        local = [{nm: g.to(dev) / n for nm, g in grads.items()}
                 for dev in self.mesh.devices]
        return self._ring_reduce(local, res)

    def wire_bytes_model(self) -> dict | None:
        """Per-rank bytes one step sends across the data axis, as
        ``{"reference": .., "quantized_ring": .., "ndata": ..}``: the
        float32 ring all-reduce of the same grads against the int8 ring's
        payloads (None with no grad_comm machinery). Under ``q8_hier``
        the dict also carries ``intra``, ``inter``, ``intra_degree`` and
        the same-width ``flat_ring``, and ``quantized_ring`` is the
        hierarchical total."""
        if self._comm is None:
            return None
        n = len(self.mesh.devices)
        sizes = {nm: int(np.prod(s.shape, dtype=np.int64))
                 for nm, s in self.specs.items()}
        buckets = self._buckets(sizes)
        out = {
            "reference": qc.reference_wire_bytes(sizes, n),
            "quantized_ring": qc.modeled_wire_bytes(
                sizes, buckets, n, dtype=self._comm.dtype),
            "ndata": n,
        }
        if self._ring_hier is not None:
            k = self._ring_hier[0]
            out["flat_ring"] = out["quantized_ring"]
            levels = qc.modeled_wire_bytes_levels(
                sizes, buckets, n, intra_degree=k, dtype=self._comm.dtype)
            out["quantized_ring"] = levels["total"]
            out["intra"] = levels["intra"]
            out["inter"] = levels["inter"]
            out["intra_degree"] = k
        return out

    def modeled_wire_bytes_per_step(self) -> int:
        """Per-rank bytes the active reduction sends per step (0 with no
        machinery or one rank)."""
        model = self.wire_bytes_model()
        if model is None:
            return 0
        return model["quantized_ring" if self._comm.ring else "reference"]

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
