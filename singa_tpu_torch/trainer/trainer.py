"""The training engine: synchronous data-parallel training.

Counterpart of ``singa_tpu/trainer/trainer.py``: the reference's
worker-side stack (Worker::Start/Run/RunOneBatch,
src/worker/worker.cc:14-106,187-213, and Executor::TrainOneBatch,
:304-316) driven by the same cadence loop.

The data axis is a :class:`~singa_tpu_torch.parallel.Mesh`, rank ->
device (one rank on one device by default; ``mesh=`` or a cluster with
``nworkers`` gives more, and ranks may share a card). Each rank runs
one forward over the float32 master params cast to the compute dtype
(so autograd returns float32 grads) and ``backward`` on its contiguous
slice of the batch, and divides its grads by the width n. A net with
buffers (kBatchNorm) on more than one rank runs the ranks in lockstep
instead (``Net.forward_ranks``: each layer for every rank before the
next, BatchNorm's moments and its backward's sums taken over all
ranks, the JAX package's BatchNorm over the global batch) and one
backward over the ranks' losses, each divided by n. Then one of three
reductions:

  exact      the ranks' grads are summed in rank order (the JAX
             package's GSPMD psum);
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
ranks.

Several processes (``parallel/launch.py``, the mesh laid over them
process-major): each process runs its own ranks and reads the whole
global stream, keeping its ranks' rows. The exact sum and the q8 seam
gather every rank's partials to every process (``Mesh.gather``) and
sum them in rank order, so a run of P processes gives the bits of one
process over the same ranks; the ring sends its rows between processes
point to point; a zero update's fresh shards are gathered for the
stitch. Under the ring each process's residual buffers hold its own
ranks' chunks (the others' are gathered for an npz save), and under
zero its ranks' slot shards (``state`` gathers them: a collective, as
every save is). Process 0 writes an npz save; a sharded save is written
by every process, its ranks' boxes in ``proc_<k>.npz``.

``zero_update`` (the JAX package's ZeRO-style update layout,
``parallel/shardings.py``): each param whose dim the width n divides is
updated as n rank shards along that dim. Rank r's updater slots exist
only as its shard, on its device; in the eager tail each rank updates
its param shard from its shard of the summed grads (under the ring: the
ring's own scatter output, its allgather skipped) and its slots, and
the fresh shards are copied back into every device's params, in place.
The updaters are elementwise and the grads are summed in the same order
either way, so zero gives the replicated update's params to the bit.
Multi-rank steps are eager (the dispatch rule); with one rank there is
nothing to shard and the graphed step is unchanged.

Error-feedback residuals live in ``buffers`` under ``__gradres__/<param>``
as whole arrays, chunk r (along the ring's chunk dim) belonging to rank
r: the layout and ``b|`` checkpoint keys of the JAX Trainer. Stateful
layers' buffers (kBatchNorm's running stats, ``<layer>/running_mean``)
live beside them, float32 whatever the compute dtype; every step
updates them in place, so a captured step or eval reads the live
values. On several ranks they update from the global moments, the same
bits on every rank.

Host dispatch (the JAX package's jitted step, scan chunks and
device-resident dataset):

- **The device cache.** When every net's dataset fits
  ``SINGA_TPU_DEVICE_CACHE_MB`` (default 512) it is uploaded once
  (byte-valued data as uint8, cast back after the gather) and batches
  are gathered on the device (``feeder_mode`` ``cached``). Otherwise,
  with ``prefetch`` on, a thread stages the next N batches as one block
  (``stream``, ``data/device_prefetch.py``'s ChunkStager) or the next
  batch (``prefetch``, its DeviceFeeder) while the card runs; ``sync``
  assembles on the step path.
- **Dispatch** (``dispatch_mode``). ``graph``: one rank's step is a
  body over static tensors (params, updater slots, a step counter,
  stream positions, the cached dataset or a static batch block, metric
  sums) that gathers its batch with the JAX index math, runs forward,
  backward and update, copies the new params and slots into the static
  tensors and advances its counter; on the card it is captured once as
  a CUDA graph (``utils/graphs.py``) and a chunk of N steps is N
  replays with no host work between them, on the CPU it is called per
  step. ``eager``, decided at construction by rule and logged once with
  the rule (``dispatch: eager (<reason>)``): more than one rank (or the
  quantized ring on one), a layer that draws on the device (kDropout,
  kMnistImage's distortion), ``debug``, or ``graphs=False``; the step is
  then the per-rank eager forward and backward, one step per call.
- **Chunks.** ``run()`` advances by windows of up to ``SINGA_TPU_CHUNK``
  (64) steps, cut at every cadence event, as the JAX ``run`` does; a
  chunk's metrics are summed on the device and read at display.

Random draws (dropout masks, crops, mirrors, distortion) come from a
generator per step, derived from the Trainer's seed and the step
(``utils.rng.fold_in``), then per rank and per layer (``Net.forward``):
a step's draws do not depend on the steps before it, as the JAX
Trainer's ``fold_in(step_key, step)`` does not. Eval passes none. A
graphed step draws kRGBImage's crops and mirrors for its whole chunk on
the host from the same generators and uploads them with the stream
positions, in one copy.

Cadence semantics match the reference's predicates exactly
(include/worker/worker.h:118-158): XNow(step) = freq > 0 and
step >= after and (step - after) % freq == 0; tests/validation run
*before* the train step of the step they trigger on (worker.cc:190-200).

Checkpoints: ``checkpoint_format`` "npz" (``checkpoint.py``) or
"sharded" (``sharded_ckpt.py``, ``step_<N>.ckpt`` directories in the
JAX package's format: zero slots and ring residuals saved as rank
shards); a sharded resume assembles each rank's box of each array from
the saved boxes it intersects (``resilience/reshard.py``), so a save of
n ranks (or of the JAX package's devices) resumes on m.

The other mesh axes (``parallel/mesh.py``: pipe, expert, seq and model,
from the cluster's ``nprocs_per_group`` split, on one process) run every
rank in lockstep (``_step_axes``): one walk of the net over all ranks
(``Net.forward_ranks`` with lanes), where ring attention, kMoE's
expert forms, kLayerPartition's Slice/Concate and the GPipe stages read
the other ranks' tensors, then one backward over the ranks' losses,
each divided by the rank count, so that their sum is the global batch's
loss whatever work the ranks repeat. A piece of a param (the whole of a
replicated one, one shard of a split one) takes the sum, in rank order,
of the gradients of every rank that holds it, and the update runs on
that piece. kLayerPartition's indivisible dims are stored padded
(``parallel/shardings.py``): ``params`` and ``state`` hold the stored
arrays, an npz save the logical ones. q8_hier's named axes (``ring {
intra_axis / inter_axis }``) reduce over the product of two axes whose
ranks each take a batch slice: the Trainer runs them as a data axis in
the ring's order (``_named_ring_view``), int8 on the inter hops.

Resilience (``resilience/``): the supervisor attaches a
``ResilienceContext`` (``self.resilience``) and the flight recorder
(``attach_telemetry``), and ``run`` calls the context at every step
boundary (``before_step``/``after_step``), ``save`` at every write
(``checkpoint_written``). With a ``guard_policy`` the step computes the
divergence guard's verdict on the device (the loss and the global
grad-norm finite) and writes ``where(ok, new, old)`` into the stored
params, slots and buffers, in the eager tail and in the graphed body
alike, so a captured step replays it with no host read; the counters are
0-d tensors in ``buffers`` under the JAX package's reserved keys, and the
accumulated LR backoff multiplies the grads. On several ranks one
verdict covers the whole step (every rank's loss and the reduced grads;
the ring's residuals roll back with it). ``rollback_to`` restores a
checkpoint into the live tensors (a captured graph replays the restored
values), and with ``async_checkpoint`` a save is a device snapshot into
one of two preallocated buffers plus a copy to pinned host memory on a
side stream, written by the context's writer thread. A fault plan makes
every step a chunk of one; a ``nanloss`` step runs eager on its
poisoned, directly fed batch.

What the port leaves out, and refuses with a ConfigError that names
it rather than ignoring: ``fleet`` (``main`` dispatches it to the
serving host); the int8 ring with a net with buffers; on a mesh
with more axes than data: any axis but data across processes, two of
the seq, expert and pipe axes together (or with a model axis, but pipe
with model), ``zero_update``, ``grad_comm``, sharded saves and a net
with buffers. ``kernels {
paged_attention }`` is the serving engine's knob and trains unchanged,
as in the JAX package. A cluster's ``nservers`` is ignored here, as the
JAX Trainer ignores it; on an asynchronous cluster ``make_trainer``
picks the replica engine instead (``trainer/replica.py``'s
ReplicaTrainer), and the contrastive-divergence engine is
``trainer/cd.py``'s CDTrainer. Uncached eval streams ride a bounded
BurstFeeder when ``prefetch`` is on (``_eval_batches``).
Also left out: graphs over more than one rank.
"""

from __future__ import annotations

import functools
import hashlib
import os
import threading
import types
from typing import Callable

import numpy as np
import torch

from ..config.schema import ClusterConfig, ConfigError, ModelConfig
from ..data.device_prefetch import ready, to_device
from ..data.pipeline import BatchPipeline
from ..device import resolve_device
from ..graph.builder import Net, active_phases, build_net
from ..layers.data import RGBImageLayer, StagedDraw
from ..ops import quantized_collective as qc
from ..optim import make_updater
from ..graph.pipeline_plan import plan_stages
from ..parallel import (
    GradCommSpec,
    Mesh,
    build_mesh,
    init_residuals,
    mesh_from_cluster,
    reduce_gradients,
    residual_key,
    reverse_topo_buckets,
)
from ..parallel.axes import Lanes, rank_sum
from ..parallel.shardings import (
    batch_shardings,
    param_paddings,
    param_shardings,
    shard_feed,
    zero_update_shardings,
)
from ..params import init_params
from ..resilience.guard import (
    GUARD_CONSEC,
    GUARD_KEYS,
    GUARD_LR,
    GuardSpec,
    apply_verdict,
    grad_norm_sq,
    guard_finish,
    guard_grads,
    init_guard_buffers,
)
from ..utils import Performance, Timers
from ..utils.graphs import Graphed
from ..utils.rng import fold_in
from .checkpoint import load_stream_positions, restore_into, save_checkpoint
from .sharded_ckpt import RankShards, is_sharded_checkpoint, save_sharded

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _now(step: int, freq: int, after: int) -> bool:
    """The reference's {Display,Test,Validate}Now predicate (worker.h:118-158)."""
    return freq > 0 and step >= after and (step - after) % freq == 0


def unsupported(model_cfg: ModelConfig,
                cluster_cfg: ClusterConfig | None) -> list[str]:
    """The conf knobs this engine does not port yet, by name."""
    del cluster_cfg
    return [knob for knob in ("fleet",)
            if getattr(model_cfg, knob, None) is not None]


def _refuse(missing: list[str]) -> None:
    if missing:
        raise ConfigError(
            f"not ported to singa_tpu_torch yet: {', '.join(missing)}"
        )


#: the inner-axis combinations the lockstep step runs (any with the data
#: axis): one of seq, expert, model or pipe, or pipe with model
AXIS_SETS = ({"seq"}, {"expert"}, {"model"}, {"pipe"}, {"pipe", "model"})
#: the layer types a seq axis runs: each is position-wise or has its
#: seq form (kEmbedding's positions, ring attention, kLMLoss's shift)
SEQ_LAYERS = {"kSequenceData", "kEmbedding", "kLayerNorm", "kAttention",
              "kDense", "kAdd", "kLMLoss"}


class Trainer:
    """Builds nets, owns params/updater state, runs the cadence loop
    over the ranks of a data-parallel mesh. Without ``mesh``: one rank on
    ``device`` (``None`` is the GPU; pass ``"cpu"`` for the CPU), or, for
    a cluster with ``nworkers``, one rank per worker group over the
    visible GPUs (over ``device`` repeated when one is given; under a
    process group this process's share of the worker groups).

    ``prefetch`` (default: the conf's ``prefetch``), ``device_cache``
    (default: by the budget) and ``stream_chunks`` (default:
    ``SINGA_TPU_STREAM_CHUNK``, on) choose ``feeder_mode`` as in the JAX
    Trainer; ``graphs=False`` forces the eager dispatch."""

    #: subclasses whose step does not thread buffers (the CD trainer)
    #: refuse a net with stateful layers
    _supports_buffers = True
    #: subclasses whose step cannot run the quantized ring refuse it
    _supports_ring_collective = True
    #: the replica engine keeps its own update layout and gradient sync
    #: math: it refuses zero_update and grad_comm (the JAX Trainer's
    #: messages)
    _supports_zero_update = True
    _supports_grad_comm = True
    #: whether the ranks split the batch (the data axis) or each takes a
    #: whole batch of its own (the replica engine's worker groups)
    _splits_batch = True

    def __init__(
        self,
        model_cfg: ModelConfig,
        cluster_cfg: ClusterConfig | None = None,
        *,
        mesh=None,
        seed: int = 0,
        log: Callable[[str], None] = print,
        device=None,
        prefetch: bool | None = None,
        device_cache: bool | None = None,
        stream_chunks: bool | None = None,
        graphs: bool | None = None,
    ):
        dev = resolve_device(device) if mesh is None else None
        _refuse(unsupported(model_cfg, cluster_cfg))
        if mesh is None and (cluster_cfg is None or not cluster_cfg.nworkers):
            mesh = build_mesh(1, 1, [dev])
        elif mesh is None:
            mesh = mesh_from_cluster(
                cluster_cfg,
                None if device is None else [dev] * cluster_cfg.nworkers,
            )
        #: the mesh's axes as the cluster laid them (``mesh.shape``)
        self.mesh_shape = dict(mesh.shape)
        self._comm = GradCommSpec.from_config(
            model_cfg.grad_comm, model_cfg.kernels, model_cfg.ring
        )
        if self._comm is not None and not self._supports_grad_comm:
            raise ConfigError(
                f"{type(self).__name__} does not support grad_comm mode "
                f"{self._comm.mode!r} (the replica protocol owns its own "
                "gradient sync math)"
            )
        if self._comm is not None and self._comm.hier and (
                self._comm.intra_axis or self._comm.inter_axis):
            mesh = self._named_ring_view(mesh)
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

        # --- buffers (stateful layers, e.g. batch-norm running stats) ---
        buffer_names = sorted(self.train_net.buffer_specs())
        if buffer_names and not self._supports_buffers:
            raise ConfigError(
                f"{type(self).__name__} does not support stateful layers "
                f"(buffers: {buffer_names})"
            )

        # --- params + updater (ParamManager ctor + InitParams) ---
        self.specs = self.train_net.param_specs()
        if model_cfg.updater is None:
            raise ConfigError("model config has no updater block")
        self.updater = make_updater(model_cfg.updater)
        self._init_gen = torch.Generator().manual_seed(seed)
        #: the root of every step's generator (the JAX Trainer's step key)
        self._step_gen = fold_in(torch.Generator().manual_seed(seed), 1)
        #: the resilience context the supervisor attaches (None: inert)
        self.resilience = None
        #: the flight recorder (``attach_telemetry``; None: inert)
        self.telemetry = None
        #: the divergence guard (None: unguarded)
        self._guard = GuardSpec.from_config(model_cfg.resilience)
        #: the async saves' two snapshot buffers (``_snapshot``)
        self._snaps = [None, None]
        self._snap_next = 0

        # --- ZeRO-style update sharding (zero_update): the dim each
        # param's update is cut along over the ranks, None = replicated
        # (parallel/shardings.py); the ring below takes it as its chunk
        # dim. None off zero ---
        self._zero_dims: dict[str, int | None] | None = None
        if model_cfg.zero_update:
            if not self._supports_zero_update:
                raise ConfigError(
                    f"{type(self).__name__} does not support zero_update "
                    "(the replica protocol owns its own update layout)"
                )
            self._zero_dims = zero_update_shardings(
                mesh, self.train_net, warn=True)

        # --- the other mesh axes: which param splits over which axis, the
        # padded storage of uneven kLayerPartition splits, the stages ---
        #: param -> (dim, mesh axis) it splits over, or None
        self._layout: dict[str, tuple | None] = {}
        #: param -> np.pad-style widths of its stored array
        self._pad: dict[str, tuple] = {}
        if mesh.has_axes:
            self._setup_axes()

        # --- gradient collectives (grad_comm + kernels.grad_allreduce) ---
        #: the ring's chunk dim per param (the zero dim of a zero-sharded
        #: param, else 0), whether its reduced chunks are allgathered
        #: (False for zero-sharded params) and q8_hier's (K, M); None off
        #: the ring
        self._ring_chunk_dims: dict[str, int] | None = None
        self._ring_gather: dict[str, bool] | None = None
        self._ring_hier: tuple[int, int] | None = None
        ndata = mesh.widths["data"]
        if self._comm is not None and self._comm.ring:
            self._setup_ring_collective()
        elif self._splits_batch and self.train_net.batchsize % ndata:
            raise ConfigError(
                f"data-parallel training needs the data-axis width "
                f"({ndata}: the mesh's ranks, or the cluster's nworkers "
                f"worker groups) to divide the batch "
                f"({self.train_net.batchsize}): each rank takes a "
                "contiguous slice of it"
            )

        #: the graph state of the train step and of each eval net
        #: (built at first use; see _graph)
        self._g = None
        self._eval_g: dict[int, types.SimpleNamespace] = {}
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

        # --- dispatch: graph or eager, by rule, decided once ---
        self._dispatch, reason = self._dispatch_rule(graphs)
        self.log(f"dispatch: {self._dispatch}"
                 + (f" ({reason})" if reason else ""))
        #: why the dispatch is eager ("" when graphed)
        self.dispatch_reason = reason

        # --- device-resident dataset (the JAX Trainer's fast path) ---
        if prefetch is None:
            prefetch = model_cfg.prefetch
        self._prefetch_input = bool(prefetch)
        #: net id -> layer -> {"image", "label"} on the device
        self._dev_data: dict[int, dict[str, dict]] = {}
        #: (net id, layer) -> decoded dtype of uint8-compacted device data
        self._cache_cast: dict[tuple[int, str], torch.dtype] = {}
        self._cached = self._maybe_cache_datasets(device_cache)

        # --- double-buffered input (data/device_prefetch.py) ---
        if stream_chunks is None:
            stream_chunks = os.environ.get(
                "SINGA_TPU_STREAM_CHUNK", "1"
            ).lower() not in ("0", "off", "false")
        self._stream_chunks = bool(stream_chunks)
        self._feeder = None
        self._stager = None
        #: the side stream the feeders' host-to-device copies run on
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        #: train-stream positions of the batches the trainer consumed
        #: (the device feeder reads ahead; checkpoints must not skip
        #: what the step loop never saw)
        self._feeder_positions: dict[str, int] = {}
        if self.feeder_mode != "stream":
            # only the chunk stager consumes the over-budget compaction
            self.__dict__.pop("_compact_train", None)

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
    # the other mesh axes
    # ------------------------------------------------------------------

    def _named_ring_view(self, mesh: Mesh) -> Mesh:
        """q8_hier's named form reduces over the product of two mesh axes
        whose ranks each take a slice of the batch (the JAX ring step's
        composite batch spec): -> a data-only mesh of those ranks in the
        ring's order, rank g·K + p the one at index g of the inter axis
        and p of the intra axis. The geometry's refusals are the JAX
        Trainer's."""
        geom = qc.hier_ring_geometry(mesh.shape, self._comm)
        if isinstance(geom, str):
            raise ConfigError(
                f"kernels {{ grad_allreduce: q8_hier }} cannot run: {geom}"
            )
        intra, inter, k, m = geom
        order = [mesh.rank(**{inter: g, intra: p})
                 for g in range(m) for p in range(k)]
        return Mesh(tuple(mesh.devices[r] for r in order))

    def _setup_axes(self) -> None:
        """A mesh with a pipe, expert, seq or model axis: refuse what the
        lockstep step does not run (by name), bind the mesh, lay out the
        params (and their padding) and plan the pipeline stages."""
        mesh, cfg, net = self.mesh, self.cfg, self.train_net
        if type(self)._step_core is not Trainer._step_core:
            raise ConfigError(
                f"{type(self).__name__} runs the data axis only (its step "
                "is not the lockstep walk of the other mesh axes)"
            )
        widths = mesh.widths
        axes = {a for a, w in widths.items() if a != "data" and w > 1}
        named = ", ".join(f"{a} {widths[a]}" for a in sorted(axes))
        if axes not in AXIS_SETS:
            raise ConfigError(
                f"mesh axes {named} together: singa_tpu_torch runs one of "
                "the seq, expert, model and pipe axes, or pipe with model, "
                "beside the data axis"
            )
        for knob, on in (("zero_update", cfg.zero_update),
                         # the rings refuse a composed mesh themselves,
                         # with the JAX Trainer's messages
                         ("grad_comm", self._comm is not None
                          and not self._comm.ring),
                         ('checkpoint_format: "sharded"',
                          cfg.checkpoint_format == "sharded"),
                         ("a net with buffers",
                          bool(net.buffer_specs()))):
            if on:
                raise ConfigError(
                    f"{knob} on the {named} mesh axes is not ported to "
                    "singa_tpu_torch yet"
                )
        if "seq" in axes:
            for layer in net.layers:
                if layer.TYPE not in SEQ_LAYERS:
                    raise ConfigError(
                        f"layer {layer.name!r} ({layer.TYPE}) on the seq "
                        "axis: singa_tpu_torch's seq axis runs "
                        f"{', '.join(sorted(SEQ_LAYERS))}"
                    )
        for n in self._nets():
            n.bind_mesh(mesh)
        self._layout = param_shardings(mesh, net)
        self._pad = param_paddings(mesh, net)
        for layer in net.layers:
            if layer.model_split() and not layer.crosses():
                raise ConfigError(
                    f"layer {layer.name!r} ({layer.TYPE}): kLayerPartition "
                    "on the model axis runs kDense, kInnerProduct and "
                    "kAttention in singa_tpu_torch"
                )
        logical = {nm: self.specs[nm].shape for nm in self._pad}
        for n in self._nets():
            n.param_logical = logical
        local = net.batchsize // max(1, widths["data"])
        if widths["pipe"] > 1:
            net.pipeline_plan = plan_stages(net, widths["pipe"],
                                            cfg.pipeline_microbatches)
            if net.pipeline_plan and local % net.pipeline_plan.nmicro:
                raise ConfigError(
                    f"pipeline: batch {local} not divisible by "
                    f"{net.pipeline_plan.nmicro} microbatches"
                )
        for layer in net.datalayers:
            if (widths["seq"] > 1 and layer.TYPE == "kSequenceData"
                    and layer.sample_shape[0] % widths["seq"]):
                raise ConfigError(
                    f"sequence length {layer.sample_shape[0]} of "
                    f"{layer.name!r} is not divisible by the seq axis "
                    f"width {widths['seq']}"
                )

    def _pad_one(self, name: str, v):
        """Logical -> stored: zero-pad the dims ``_pad`` marks (a value
        already stored passes unchanged)."""
        w = self._pad.get(name)
        if not w or tuple(v.shape) != tuple(self.specs[name].shape):
            return v
        return torch.nn.functional.pad(
            v, [x for lo_hi in reversed(w) for x in lo_hi])

    def _unpad_one(self, name: str, v):
        """Stored -> logical."""
        if name not in self._pad:
            return v
        return v[tuple(slice(0, n) for n in self.specs[name].shape)]

    def _axes_batch(self, batch: dict, r: int, shardings: dict) -> dict:
        """Rank r's piece of the global batch on its device: its data
        index's rows, and its seq index's positions of kSequenceData's
        tokens (``parallel/shardings.py``)."""
        dev = self.mesh.device(r)
        return {name: {k: shard_feed(v, shardings[name][k], self.mesh,
                                     r).to(dev)
                       for k, v in feed.items()}
                for name, feed in batch.items()}

    def _piece_of(self, r: int, name: str) -> int:
        """Which piece of a param rank r holds: its index on the axis the
        param splits over (0 for a replicated param)."""
        lay = self._layout.get(name)
        return 0 if lay is None else self.mesh.coords(r)[lay[1]]

    def _piece(self, name: str, tensor, i: int):
        """Piece i of a stored param (or slot): its shard along the split
        dim, or the whole of a replicated one (a view either way)."""
        lay = self._layout.get(name)
        if lay is None:
            return tensor
        return tensor.chunk(self.mesh.widths[lay[1]], dim=lay[0])[i]

    def _step_axes(self, step: int, batch: dict) -> dict:
        """The lockstep step of a mesh with more axes than data: every
        rank's leaves (its pieces of the params), one walk of the net
        over all ranks, one backward over the ranks' losses each divided
        by the rank count, each piece's gradient summed over the ranks
        that hold it in rank order, the update on each piece."""
        mesh = self.mesh
        n = mesh.width
        ranks = list(mesh.local_ranks)
        names = list(self.params)
        step_gen = fold_in(self._step_gen, step)
        leaves = [{nm: self._piece(nm, self._replicas[mesh.device(r)]
                                   ["params"][nm], self._piece_of(r, nm))
                   .detach().requires_grad_(True) for nm in names}
                  for r in ranks]
        shardings = batch_shardings(mesh, self.train_net)
        losses, metrics, _ = self.train_net.forward_ranks(
            [self._cast_compute(lv) for lv in leaves],
            [self._cast_compute(self._axes_batch(batch, r, shardings))
             for r in ranks],
            generators=[fold_in(step_gen, r) for r in ranks],
            buffers=self.buffers, lanes=Lanes(mesh, tuple(ranks)))
        torch.autograd.backward([loss / n for loss in losses])
        grads = self._axes_reduce(ranks, leaves)
        out = {layer: {k: rank_sum(torch.as_tensor(m[layer][k])
                                   for m in metrics) / n for k in ms}
               for layer, ms in metrics[0].items()}
        ok = None
        if self._guard is not None:
            ok, grads = guard_grads(
                self._guard_buffers(),
                rank_sum(l.detach().float().to(self.device) for l in losses),
                grads)
        self._axes_update(step, grads, ok)
        if ok is not None:
            out = guard_finish(ok, self._guard_buffers(), out)
        return out

    def _axes_reduce(self, ranks: list, leaves: list) -> dict:
        """{param: [each piece's gradient]}: piece i's, the sum in rank
        order of the gradients of the ranks that hold it (every rank for
        a replicated param, the ranks of index i on the split axis for a
        split one), on the first device. The one exchange of the lockstep
        step outside the layers."""
        grads = {}
        for nm in leaves[0]:
            lay = self._layout.get(nm)
            pieces = 1 if lay is None else self.mesh.widths[lay[1]]
            grads[nm] = [rank_sum(
                (lv[nm].grad if lv[nm].grad is not None
                 else torch.zeros_like(lv[nm])).to(self.device)
                for r, lv in zip(ranks, leaves)
                if self._piece_of(r, nm) == i)
                for i in range(pieces)]
        return grads

    def _axes_update(self, step, grads: dict, ok=None) -> None:
        """The update of every piece on every device's stored arrays, in
        place: a replicated param's whole, a split param's shards one by
        one (views of the stored arrays and slots)."""
        for dev, rep in self._replicas.items():
            for nm, pieces in grads.items():
                for i, g in enumerate(pieces):
                    p = self._piece(nm, rep["params"][nm], i)
                    slots = {k: self._piece(nm, v, i)
                             for k, v in rep["state"][nm].items()}
                    new_p, new_s = self.updater.apply(
                        step, {nm: p}, {nm: g.to(dev)}, {nm: slots},
                        self.specs)
                    with torch.no_grad():
                        _put(p, new_p[nm], ok)
                        for k, v in new_s[nm].items():
                            _put(slots[k], v, ok)

    # ------------------------------------------------------------------
    # params
    # ------------------------------------------------------------------

    def _materialize_params(self) -> None:
        """Initialize params + updater slots on every device of the mesh
        (zero-sharded slots as rank shards) and the error-feedback
        residuals, and overlay the resume checkpoint (fills
        Worker::Resume, worker.cc:65-67): an npz save by name, a sharded
        one through ``_restore_sharded``."""
        params = init_params(self._init_gen, self.specs, self.device)
        state = self.updater.init_state(params)
        buffers = {**self.train_net.init_buffers(self.device),
                   **init_residuals(params, self._comm)}
        if self._guard is not None:
            # the counters ride the buffers: they checkpoint and restore
            # with the rest of the training state
            buffers.update(init_guard_buffers(self.device))
        self._resume_streams: dict[str, int] = {}
        sharded = bool(self.cfg.checkpoint) and is_sharded_checkpoint(
            self.cfg.checkpoint)
        if self.cfg.checkpoint and not sharded:
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
        #: rank r -> {zero-sharded param: {slot: rank r's shard}} on
        #: rank r's device (empty dicts off zero; None for the ranks of
        #: other processes)
        self._zero_slots: list[dict | None] = [
            {} if self.mesh.is_local(r) else None
            for r in range(self.mesh.width)]
        self.params = params
        self.state = state
        self.buffers = buffers
        if sharded:
            self._restore_sharded()

    def _zero_names(self) -> list[str]:
        """The params whose update is sharded over the ranks."""
        if self._zero_dims is None or self.mesh.width == 1:
            return []
        return [n for n, d in self._zero_dims.items() if d is not None]

    def _restore_sharded(self) -> None:
        """Overlay a sharded checkpoint (``step_<N>.ckpt``) onto the
        initialized params, slots and buffers. Each entry is placed by
        the Resharder, each rank's box from the saved boxes it
        intersects; zero-sharded slots land as their rank shards. Entries
        absent from the checkpoint keep their init; a shape mismatch
        raises. The stream positions are global consumed-batch counts,
        the same on any rank count."""
        from ..resilience.reshard import Resharder
        from .sharded_ckpt import (
            ShardedCheckpoint,
            buffer_key,
            param_key,
            state_key,
        )

        from ..resilience.coord import process_count

        path = self.cfg.checkpoint
        mesh = self.mesh
        # rank -> device; None for the ranks of other processes
        devices = [mesh.device(r) if mesh.is_local(r) else None
                   for r in range(mesh.width)]
        with ShardedCheckpoint(path) as ck:
            # admission first: a mesh that cannot host the manifest's
            # specs raises before anything is placed
            rs = Resharder(ck, dict(self.mesh.shape))
            have = set(ck.keys())

            def place(key, init, dim=None):
                saved = tuple(ck.manifest["arrays"][key]["shape"])
                if saved != tuple(init.shape):
                    raise ValueError(
                        f"checkpoint {path!r}: {key!r} shape {saved} != "
                        f"model shape {tuple(init.shape)}")
                if dim is None:
                    return rs.place(key, [self.device],
                                    dtype=init.dtype)[0]
                return rs.place(key, devices, dim, dtype=init.dtype)

            params = {n: place(param_key(n), v)
                      if param_key(n) in have else v
                      for n, v in self.params.items()}
            zero = set(self._zero_names())
            state = {n: dict(slots) for n, slots in self.state.items()}
            for n, slots in state.items():
                for s, v in slots.items():
                    key = state_key(n, s)
                    if key not in have:
                        continue
                    if n in zero:
                        parts = place(key, v, self._zero_dims[n])
                        with torch.no_grad():
                            for r in mesh.local_ranks:
                                self._zero_slots[r][n][s].copy_(parts[r])
                    else:
                        slots[s] = place(key, v)
            self.params = params
            self.state = {n: slots for n, slots in state.items()
                          if n not in zero}
            self.buffers = {n: place(buffer_key(n), v)
                            if buffer_key(n) in have else v
                            for n, v in self.buffers.items()}
            self._resume_streams = dict(ck.streams)
            self.start_step = max(self.start_step, ck.step)
            if rs.saved_nprocs != process_count():
                self.log(f"elastic restore: checkpoint written by "
                         f"{rs.saved_nprocs} process(es), resuming on "
                         f"{process_count()}")
            note = rs.summary()
            if note is not None:
                self.log(f"elastic restore: {note} onto "
                         f"{len(devices)} rank(s)")
        self.log(f"resumed sharded from {path} at step {self.start_step}")

    @staticmethod
    def _assign(cur: dict | None, value: dict, dev) -> dict:
        """``value`` (name -> tensor) as tensors the Trainer owns on
        ``dev``: copied into ``cur``'s tensors when it holds the same
        names, shapes and dtypes (a captured step reads them at fixed
        addresses), else fresh copies."""
        if cur is not None and cur.keys() == value.keys() and all(
                cur[n].shape == v.shape and cur[n].dtype == v.dtype
                for n, v in value.items()):
            with torch.no_grad():
                for n, v in value.items():
                    cur[n].copy_(v)
            return cur
        return {n: v.to(dev, copy=True) for n, v in value.items()}

    @property
    def params(self) -> dict:
        """The params (rank 0's device's copy; every device holds the
        same values). Assigning them copies into every device's copy."""
        return self._replicas[self.device]["params"]

    @params.setter
    def params(self, value: dict) -> None:
        value = {n: self._pad_one(n, v) for n, v in value.items()}
        for dev, rep in self._replicas.items():
            cur = rep.get("params")
            rep["params"] = self._assign(cur, value, dev)
            if rep["params"] is not cur:
                self._drop_graphs()

    @property
    def state(self) -> dict:
        """The updater slots (rank 0's device's copy), like ``params``.
        Under zero the sharded params' slots come back whole, their rank
        shards concatenated on rank 0's device (a copy, not the live
        tensors); across processes the other processes' shards are
        gathered, a collective every process must join."""
        rep = self._replicas[self.device]["state"]
        zero = self._zero_names()
        if not zero:
            return rep
        mesh = self.mesh
        shards = mesh.gather([
            {(nm, s): v for nm in zero
             for s, v in self._zero_slots[r][nm].items()}
            for r in mesh.local_ranks], self.device)
        out = dict(rep)
        for nm in zero:
            out[nm] = {
                s: torch.cat([shards[r][nm, s].to(self.device)
                              for r in range(mesh.width)],
                             dim=self._zero_dims[nm])
                for s in self._zero_slots[mesh.local_ranks[0]][nm]
            }
        return {nm: out[nm] for nm in self.params if nm in out}

    @state.setter
    def state(self, value: dict) -> None:
        """Copy ``value`` (whole slots) into every device's slots; under
        zero a sharded param's slots go to the ranks as their shards."""
        zero = set(self._zero_names())
        value = {n: {s: self._pad_one(n, v) for s, v in slots.items()}
                 for n, slots in value.items()}
        for dev, rep in self._replicas.items():
            cur = rep.get("state", {})
            new = {}
            for n, slots in value.items():
                if n in zero:
                    continue
                new[n] = self._assign(cur.get(n), slots, dev)
                if new[n] is not cur.get(n):
                    self._drop_graphs()
            rep["state"] = new
        ranks = self.mesh.width
        for r in self.mesh.local_ranks:
            dev = self.mesh.device(r)
            for n in zero & value.keys():
                d = self._zero_dims[n]
                parts = {s: v.chunk(ranks, dim=d)[r].contiguous()
                         for s, v in value[n].items()}
                self._zero_slots[r][n] = self._assign(
                    self._zero_slots[r].get(n), parts, dev)

    @property
    def update_mode(self) -> str:
        """How the weight update is laid out across the data axis:
        ``replicated`` (every rank applies the full update, the
        reference's ParamSync semantics) or ``zero`` (grads reduced to
        each rank's shard, shard-local updater, params stitched back)."""
        return "zero" if self._zero_dims is not None else "replicated"

    def opt_state_bytes_per_device(self) -> int:
        """Bytes of updater state one rank holds (this process's first):
        the footprint zero_update shrinks by the data width. Ranks that
        share a card each count their own."""
        zero = self._zero_slots[self.mesh.local_ranks[0]]
        total = 0
        for n, slots in self._replicas[self.device]["state"].items():
            for v in slots.values():
                total += v.numel() * v.element_size()
        for slots in zero.values():
            for v in slots.values():
                total += v.numel() * v.element_size()
        return total

    def _drop_graphs(self) -> None:
        """Forget every captured step: the tensors it read were replaced."""
        self._g = None
        self._eval_g = {}

    def _seek_resumed_streams(self) -> None:
        for net in self._nets():
            for name, pipe in self._pipelines.get(id(net), {}).items():
                pos = self._resume_streams.get(f"{net.phase}|{name}")
                if pos is not None:
                    pipe.seek(pos)

    # ------------------------------------------------------------------
    # the eager step
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
        """Global rank r's contiguous slice of the global batch, on its
        device (the JAX package's batch sharding over the data axis):
        every process reads the whole stream and keeps its ranks' rows,
        so the stream is the same on any process count."""
        n = self.mesh.width
        dev = self.mesh.device(r)
        out = {}
        for name, feed in batch.items():
            out[name] = {}
            for k, v in feed.items():
                b = v.shape[0] // n
                out[name][k] = v[r * b:(r + 1) * b].to(dev)
        return out

    def _step_core(self, step: int, batch: dict) -> dict:
        """One forward + backward per rank of this process (in lockstep
        over the ranks for a net with buffers on more than one rank), the
        reduction, the update on every device; -> the step's metrics,
        averaged over the ranks."""
        mesh = self.mesh
        n = mesh.width
        names = list(self.params)
        step_gen = fold_in(self._step_gen, step)
        leaves = [{nm: self._replicas[mesh.device(r)]["params"][nm].detach()
                   .requires_grad_(True) for nm in names}
                  for r in mesh.local_ranks]
        if mesh.has_axes:
            return self._step_axes(step, batch)
        if n > 1 and self.train_net.buffer_specs():
            losses, metrics, updates = self.train_net.forward_ranks(
                [self._cast_compute(lv) for lv in leaves],
                [self._cast_compute(self._rank_batch(batch, r))
                 for r in mesh.local_ranks],
                generators=[fold_in(step_gen, r) for r in mesh.local_ranks],
                buffers=self.buffers, sync=mesh)
            # each rank's loss is its local batch mean: / n makes the sum
            # over ranks the global mean, whose gradient every rank's
            # leaves take their share of through the synchronised
            # BatchNorm's backward
            torch.autograd.backward([loss / n for loss in losses])
            grads = [{nm: (lv[nm].grad if lv[nm].grad is not None
                           else torch.zeros_like(lv[nm])) for nm in names}
                     for lv in leaves]
            if self._guard is not None:
                for m, loss in zip(metrics, losses):
                    m[_GUARD_METRIC] = {"loss": loss.detach().float()}
        else:
            grads, metrics = [], []
            for r, lv in zip(mesh.local_ranks, leaves):
                # buffers go uncast; a net with stateful layers runs on
                # one rank here, so updates come from that rank alone
                loss, m, updates = self.train_net.forward(
                    self._cast_compute(lv),
                    self._cast_compute(self._rank_batch(batch, r)),
                    training=True,
                    generator=fold_in(step_gen, r),
                    buffers=self.buffers, return_buffers=True,
                )
                loss.backward()
                # each rank's loss is its local batch mean: / n makes the
                # sum over ranks the global mean gradient
                grads.append({
                    nm: (lv[nm].grad if lv[nm].grad is not None
                         else torch.zeros_like(lv[nm])) / n
                    for nm in names
                })
                if self._guard is not None:
                    m = {**m, _GUARD_METRIC: {"loss": loss.detach().float()}}
                metrics.append(m)
        return self._reduce_and_update(step, grads, metrics, updates)

    def _reduce_and_update(self, step, grads: list, metrics: list,
                           updates: dict | None = None) -> dict:
        """The eager step's tail: the local grads of this process's ranks
        (already / n) through the reduction, the update of the params
        they name on every device (zero-sharded params:
        ``_zero_update``) and the buffer ``updates`` -> the metrics,
        averaged over all ranks in rank order.

        Guarded, the verdict is taken over every rank's loss (the
        ``_GUARD_METRIC`` entry each rank's metrics carry, averaged with
        them) and the squared norm of the reduced grads (on the ring,
        each rank's, summed with the metrics), so it is the same on
        every rank and process: a bad rank voids the step everywhere,
        its params, slots, buffer updates and ring residuals alike."""
        mesh = self.mesh
        n = mesh.width
        names = list(grads[0])
        zero = [nm for nm in self._zero_names() if nm in grads[0]]
        guard = self._guard is not None
        keys = [(layer, k) for layer, ms in metrics[0].items() for k in ms]
        metrics = [{key: torch.as_tensor(m[key[0]][key[1]],
                                         device=self.device)
                    for key in keys} for m in metrics]
        if self._ring_chunk_dims is not None:
            full = [None] * n
            for r, g in zip(mesh.local_ranks, grads):
                full[r] = g
            reduced, res = self._ring_reduce(full, self.buffers)
            # the reduced grads are the same bits on every rank: take the
            # first rank on each device (a zero-sharded param's is each
            # rank's own chunk: the ring's scatter output)
            by_dev = {mesh.device(r): reduced[r]
                      for r in reversed(mesh.local_ranks)}
            shards = {r: {nm: reduced[r][nm] for nm in zero}
                      for r in mesh.local_ranks}
            if guard:
                key = (_GUARD_METRIC, "gnorm")
                keys.append(key)
                for r, m in zip(mesh.local_ranks, metrics):
                    m[key] = grad_norm_sq(reduced[r]).to(self.device)
            metrics = mesh.gather(metrics, self.device)
        else:
            if mesh.nprocs > 1:
                # every rank's partials and metrics to every process, in
                # one gather, summed below in rank order as in one process
                both = mesh.gather([
                    {**{("g", nm): g[nm] for nm in names},
                     **{("m", *key): v for key, v in m.items()}}
                    for g, m in zip(grads, metrics)], self.device)
                grads = [{nm: b["g", nm] for nm in names} for b in both]
                metrics = [{key: b[("m", *key)] for key in keys}
                           for b in both]
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
            shards = {r: {nm: summed[nm].chunk(n, dim=self._zero_dims[nm])[r]
                          .to(mesh.device(r)) for nm in zero}
                      for r in mesh.local_ranks}
        out: dict = {}
        for layer, k in keys:
            out.setdefault(layer, {})[k] = functools.reduce(
                torch.add, (m[layer, k] for m in metrics)) / n
        ok = None
        if guard:
            gm = out.pop(_GUARD_METRIC)
            # by_dev and shards hold copies: the norm is one device's
            ok, (by_dev, shards) = guard_grads(
                self._guard_buffers(), gm["loss"], (by_dev, shards),
                gnorm=gm["gnorm"] if "gnorm" in gm else grad_norm_sq(
                    by_dev[self.device]))
        self._store_buffers({**(updates or {}), **res}, ok)
        if zero:
            self._zero_update(step, shards, ok)
            names = [nm for nm in names if nm not in zero]
        for dev, rep in self._replicas.items():
            new_p, new_s = self.updater.apply(
                step, {nm: rep["params"][nm] for nm in names}, by_dev[dev],
                {nm: rep["state"][nm] for nm in names}, self.specs
            )
            # in place, as _store_update: a captured eval (or step) reads
            # the params and slots at fixed addresses
            with torch.no_grad():
                for nm, v in new_p.items():
                    _put(rep["params"][nm], v, ok)
                for nm, slots in new_s.items():
                    for s, v in slots.items():
                        _put(rep["state"][nm][s], v, ok)
        if guard:
            out = guard_finish(ok, self._guard_buffers(), out)
        return out

    def _zero_update(self, step, shards: dict, ok=None) -> None:
        """The zero update of the params ``shards[r]`` names: each rank r
        of this process updates its slice of each (a view of its
        device's replica) from ``shards[r]``, its slice of the reduced
        grads, and from its own slot shards, which take the new slots in
        place; then every rank's fresh param shards (gathered from the
        other processes) are stitched into every device's replica."""
        mesh = self.mesh
        n = mesh.width
        fresh = []
        for r in mesh.local_ranks:
            params = self._replicas[mesh.device(r)]["params"]
            slots = self._zero_slots[r]
            new_p, new_s = self.updater.apply(
                step,
                {nm: params[nm].chunk(n, dim=self._zero_dims[nm])[r]
                 for nm in shards[r]},
                shards[r], {nm: slots[nm] for nm in shards[r]}, self.specs)
            with torch.no_grad():
                for nm, new in new_s.items():
                    for s, v in new.items():
                        _put(slots[nm][s], v, ok)
            if ok is not None:
                new_p = {nm: torch.where(
                    ok.to(v.device), v,
                    params[nm].chunk(n, dim=self._zero_dims[nm])[r])
                    for nm, v in new_p.items()}
            fresh.append(new_p)
        self._stitch_zero(mesh.gather(fresh, self.device))

    @torch.no_grad()
    def _stitch_zero(self, fresh: list) -> None:
        """Copy rank r's fresh param shards ``fresh[r]`` (every rank's)
        into slice r of every device's replica, in place: the addresses
        stay fixed."""
        n = self.mesh.width
        for dev, rep in self._replicas.items():
            for nm in fresh[0]:
                parts = rep["params"][nm].chunk(n, dim=self._zero_dims[nm])
                for r, part in enumerate(parts):
                    part.copy_(fresh[r][nm])

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
        the JAX Trainer's messages. Under zero_update a zero-sharded
        param's chunk dim is its zero dim and its allgather is skipped:
        the ring's scatter output is the update layout."""
        impl = self._comm.wire_impl
        if not self._supports_ring_collective:
            raise ConfigError(
                f"{type(self).__name__} does not support kernels "
                f"{{ grad_allreduce: {impl} }} (its step does not run the "
                "per-rank backward the ring reduces)"
            )
        if self.train_net.buffer_specs():
            # the ring's per-rank backward would turn BatchNorm over the
            # global batch into per-rank statistics (the JAX Trainer
            # refuses the same)
            raise ConfigError(
                f"kernels {{ grad_allreduce: {impl} }} cannot run "
                "a net with batch-statistics buffers (kBatchNorm)"
            )
        if not self._comm.hier:
            other = {a: w for a, w in self.mesh_shape.items()
                     if a != "data" and w > 1}
            if other:
                raise ConfigError(
                    "kernels { grad_allreduce: quantized_ring } runs over "
                    f"the data axis only, but the mesh also shards {other} "
                    "— kernels { grad_allreduce: q8_hier } with a "
                    "ring { intra_axis/inter_axis } block is the "
                    "hierarchical (intra/inter-slice) two-level form "
                    "that covers composed meshes"
                )
        if self._comm.hier:
            geom = qc.hier_ring_geometry(self.mesh_shape, self._comm)
            if isinstance(geom, str):
                raise ConfigError(
                    f"kernels {{ grad_allreduce: q8_hier }} cannot "
                    f"run: {geom}"
                )
            if geom[0] != geom[1] and self._zero_dims is not None:
                raise ConfigError(
                    "kernels { grad_allreduce: q8_hier } with named "
                    "intra_axis/inter_axis does not compose with "
                    "zero_update (the update layout shards over the "
                    "data axis only) — use the factored "
                    "ring { intra_degree } form"
                )
            self._ring_hier = geom[2:]
        ndata = self.mesh.width
        bs = self.train_net.batchsize
        if bs % ndata:
            raise ConfigError(
                f"{impl} needs the data-reduction width ({ndata}) to "
                f"divide the batch ({bs}): each shard computes its own "
                "local partial gradients"
            )
        shapes = {n: s.shape for n, s in self.specs.items()
                  if s.owner is None}
        chunk_dims, gather = {}, {}
        for n in shapes:
            d_zero = (None if self._zero_dims is None or ndata == 1
                      else self._zero_dims[n])
            chunk_dims[n] = 0 if d_zero is None else d_zero
            gather[n] = d_zero is None
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
        self._ring_gather = gather

    def _ring_reduce(self, grads: list, buffers: dict):
        """Per-rank local partials (already divided by n; None for the
        ranks of other processes) through the ring -> (per-rank reduced
        grads, residual updates as whole arrays on this process's first
        device). Rank r adds and banks chunk r of each residual; the
        chunks of other processes' ranks keep their old values here."""
        n = len(grads)
        mesh = self.mesh
        dims = self._ring_chunk_dims
        names = list(next(g for g in grads if g is not None))
        res = [None] * n
        for r in mesh.local_ranks:
            res[r] = {}
            if self._comm.wants_residuals:
                for nm in names:
                    key = residual_key(nm)
                    res[r][key] = buffers[key].chunk(n, dim=dims[nm])[r].to(
                        mesh.device(r))
        out, new_res = qc.ring_reduce_gradients(
            grads, res, self._buckets(names),
            chunk_dims=dims,
            dtype=self._comm.dtype,
            error_feedback=self._comm.error_feedback,
            residual_key=residual_key,
            hier=self._ring_hier,
            gather=self._ring_gather,
        )
        mine = new_res[mesh.local_ranks[0]]
        whole = {}
        for nm in names:
            key = residual_key(nm)
            if key not in mine:
                continue
            old = buffers[key].chunk(n, dim=dims[nm])
            whole[key] = torch.cat(
                [old[r] if nr is None else nr[key].to(self.device)
                 for r, nr in enumerate(new_res)], dim=dims[nm])
        return out, whole

    def _ring_reduce_probe(self, grads: dict, res: dict):
        """The ring reduction alone, no forward: every rank takes
        ``grads`` (whole arrays) as its local partial, divided by n, so
        the reduction gives ``grads`` back; ``res`` holds whole residual
        arrays. -> (per-rank reduced grads, new residuals). The JAX
        Trainer's probe returns the reduced grads once, replicated; here
        every rank's copy comes back (None for other processes' ranks),
        so a caller can hold them equal."""
        mesh = self.mesh
        n = mesh.width
        local = [{nm: g.to(mesh.device(r)) / n for nm, g in grads.items()}
                 if mesh.is_local(r) else None for r in range(n)]
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
        n = self.mesh.width
        sizes = {nm: int(np.prod(s.shape, dtype=np.int64))
                 for nm, s in self.specs.items()}
        buckets = self._buckets(sizes)
        out = {
            "reference": qc.reference_wire_bytes(
                sizes, n, scatter_only=bool(self._zero_names())),
            "quantized_ring": qc.modeled_wire_bytes(
                sizes, buckets, n, dtype=self._comm.dtype,
                gather=self._ring_gather),
            "ndata": n,
        }
        if self._ring_hier is not None:
            k = self._ring_hier[0]
            out["flat_ring"] = out["quantized_ring"]
            levels = qc.modeled_wire_bytes_levels(
                sizes, buckets, n, intra_degree=k, dtype=self._comm.dtype,
                gather=self._ring_gather)
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

    # ------------------------------------------------------------------
    # device-resident dataset
    # ------------------------------------------------------------------

    @staticmethod
    def _compact_cache_array(images: np.ndarray):
        """-> (storage array, original dtype) for the device cache.

        Raw record pixels are byte-valued floats (uint8 widened at
        decode, data/pipeline.py); storing them as uint8 quarters the
        device memory the per-step gather reads. The round trip is
        exact: values are integers in [0, 255], and the gather casts
        back to the original dtype (so every consumer sees the host
        path's arrays). Other data stays as it is."""
        if images.dtype == np.uint8 or images.size == 0:
            return images, images.dtype
        if (
            np.issubdtype(images.dtype, np.floating)
            or np.issubdtype(images.dtype, np.integer)
        ):
            lo, hi = images.min(), images.max()
            if 0 <= lo and hi <= 255 and np.all(images == np.trunc(images)):
                return images.astype(np.uint8), images.dtype
        return images, images.dtype

    def _maybe_cache_datasets(self, enabled: bool | None) -> bool:
        """Upload every net's dataset to the device when it fits
        SINGA_TPU_DEVICE_CACHE_MB (default 512). Byte-valued data is
        stored uint8 (see _compact_cache_array). ``device_cache=False``
        wins."""
        if enabled is False:
            return False
        compact: dict[tuple[int, str], tuple[np.ndarray, np.dtype]] = {}
        total = 0
        for net in self._nets():
            for l in net.datalayers:
                arr, orig = self._compact_cache_array(np.asarray(l.images))
                compact[(id(net), l.name)] = (arr, orig)
                total += arr.nbytes + l.labels.nbytes
        if enabled is None:
            limit = float(os.environ.get("SINGA_TPU_DEVICE_CACHE_MB", "512"))
            if total > limit * 1e6:
                # over budget: the stream stager wants exactly the train
                # net's compacted arrays; hand them over
                self._compact_train = {
                    name: compact[(nid, name)]
                    for nid, name in compact
                    if nid == id(self.train_net)
                }
                return False
        if total == 0:
            return False
        for net in self._nets():
            self._dev_data[id(net)] = {}
            for l in net.datalayers:
                arr, orig = compact[(id(net), l.name)]
                if arr.dtype != orig:
                    self._cache_cast[(id(net), l.name)] = _torch_dtype(orig)
                self._dev_data[id(net)][l.name] = {
                    "image": torch.from_numpy(arr).to(self.device),
                    "label": torch.from_numpy(
                        np.asarray(l.labels)).to(self.device),
                }
        return True

    def _gather(self, net: Net, name: str, data: dict, idx) -> dict:
        """One batch of layer ``name`` from ``data`` (the cached dataset
        or a staged block) at the record indices ``idx`` (a device
        tensor), cast back to the decoded dtype after the gather."""
        img = data["image"].index_select(0, idx)
        cast = self._cache_cast.get((id(net), name))
        if cast is not None:
            img = img.to(cast)
        return {"image": img, "label": data["label"].index_select(0, idx)}

    # ------------------------------------------------------------------
    # input feeders (data/device_prefetch.py)
    # ------------------------------------------------------------------

    @property
    def feeder_mode(self) -> str:
        """How train batches reach the device:

        ``cached``    the whole dataset on the device, gathered there
        ``stream``    staged chunk blocks, double-buffered per chunk
        ``prefetch``  per-step double-buffered device feeder
        ``sync``      batch assembly + copy on the step path
        """
        if self._cached:
            return "cached"
        if self._prefetch_input and self._stream_ok():
            return "stream"
        if self._prefetch_input:
            return "prefetch"
        return "sync"

    def _stream_ok(self) -> bool:
        """Streaming chunks need a graphed step (an eager step takes one
        batch a call) and a chunk cap above 1 (SINGA_TPU_CHUNK=1 is the
        escape hatch); SINGA_TPU_STREAM_CHUNK=0 disables just this
        mode."""
        if not self._stream_chunks or self._dispatch != "graph":
            return False
        if self.resilience is not None and self.resilience.per_step:
            return False
        return self._chunk_cap() > 1

    def _reset_feeders(self) -> None:
        """Discard all feeder read-ahead and park the threads (before the
        streams are re-seeked)."""
        for f in (self._feeder, self._stager):
            if f is not None:
                f.reset()
        self._feeder_positions = {}

    def _device_feeder(self):
        """The per-step double-buffered device feeder, built at first
        use."""
        if self._feeder is None:
            from ..data.device_prefetch import DeviceFeeder

            self.__dict__.pop("_compact_train", None)
            net = self.train_net
            pipes = self._pipelines[id(net)]

            def positions():
                return {
                    f"{net.phase}|{name}": pipe.position
                    for name, pipe in pipes.items()
                }

            self._feeder = DeviceFeeder(
                lambda: self._assemble_host_batch(net), positions)
        return self._feeder

    def _chunk_stager(self):
        """The streaming-chunk block stager, built at first use.
        Byte-valued datasets stage uint8 (the device cache's compaction,
        decided once over the whole array); the gather casts back."""
        if self._stager is None:
            from ..data.device_prefetch import ChunkStager

            net = self.train_net
            pipes = self._pipelines[id(net)]
            stash = self.__dict__.pop("_compact_train", {})
            sources = {}
            for name, pipe in pipes.items():
                arr, orig = stash.get(name) or self._compact_cache_array(
                    np.asarray(pipe.images)
                )
                if arr.dtype != orig:
                    self._cache_cast[(id(net), name)] = _torch_dtype(orig)
                sources[name] = (arr, pipe.labels, pipe.batchsize)
            self._stager = ChunkStager(
                sources, 1,
                schedule=self._stream_schedule,
                cursors=lambda: {
                    name: pipe.position for name, pipe in pipes.items()
                },
                put=lambda a, name, kind: to_device(
                    a, self.device, self._copy_stream),
            )
        return self._stager

    def _stream_schedule(self, step: int) -> int:
        """The stager's window-length oracle: exactly the run() loop's
        chunk lengths (deterministic in ``step``), 0 past the end."""
        if step >= self.cfg.train_steps:
            return 0
        return self._chunk_len(step)

    def _step_via_chunk(self, step: int) -> bool:
        """Whether a length-1 window in stream mode still runs through
        train_chunk (keeping the stager's schedule unbroken)."""
        del step
        return True

    def _next_batch(self, net: Net) -> dict:
        """One batch of ``net``'s data layers on the device: a gather
        from the cached dataset, a feeder buffer swap (prefetch mode, the
        train net), or host assembly + copy on the calling thread."""
        if id(net) in self._dev_data:
            out = {}
            for name, pipe in self._pipelines[id(net)].items():
                idx = torch.from_numpy(pipe.next_indices()).to(self.device)
                out[name] = self._gather(
                    net, name, self._dev_data[id(net)][name], idx)
            return out
        if net is self.train_net and self.feeder_mode == "prefetch":
            feeder = self._device_feeder()
            batch = feeder.next()
            self._feeder_positions = dict(feeder.consumed_positions)
        else:
            batch = self._assemble_host_batch(net)
        return {name: {k: ready(v) for k, v in feed.items()}
                for name, feed in batch.items()}

    def _assemble_host_batch(self, net: Net) -> dict:
        """Host batch assembly with its copy to the device started (the
        synchronous path, and the body the device feeder runs on its
        thread)."""
        out = {}
        for name, pipe in self._pipelines[id(net)].items():
            images, labels = pipe.next_batch()
            out[name] = {
                "image": to_device(images, self.device, self._copy_stream),
                "label": to_device(labels, self.device, self._copy_stream),
            }
        return out

    # ------------------------------------------------------------------
    # dispatch: the step as a graph
    # ------------------------------------------------------------------

    def _dispatch_rule(self, graphs: bool | None) -> tuple[str, str]:
        """-> ("graph", "") or ("eager", the rule that keeps it eager).
        The divergence guard keeps the graph (its verdict is device
        work); under a fault plan a ``nanloss`` step alone runs eager, on
        its poisoned batch fed directly, and says so in the log
        (``train_one_batch``)."""
        if graphs is False:
            return "eager", "graphs=False"
        n = self.mesh.width
        if self.mesh.has_axes:
            return "eager", f"{n} ranks in lockstep over the mesh's axes"
        if n > 1:
            return "eager", (f"{n} ranks: the per-rank loop, the ring's "
                             "host bucket loop and ppermute.sent_bytes")
        if self._ring_chunk_dims is not None:
            return "eager", "the quantized ring's host bucket loop"
        for layer in self.train_net.layers:
            if layer.draws_on_device:
                return "eager", (f"layer {layer.name!r} ({layer.TYPE}) "
                                 "draws on the device")
        if self.cfg.debug:
            return "eager", "debug"
        return "graph", ""

    @property
    def dispatch_mode(self) -> str:
        """``graph`` (the step body over static tensors: a CUDA graph on
        the card, called per step on the CPU) or ``eager``."""
        return self._dispatch

    def _graph(self) -> types.SimpleNamespace:
        """The train step's static tensors and its Graphed body, built at
        first use: the step counter, the args block (step0, each data
        layer's stream position, each step's staged kRGBImage draws),
        each data layer's source (the cached dataset, or a static block
        of ``rows`` records the staged or fed batches are copied into)
        and the metric sums."""
        if self._g is not None:
            return self._g
        net, dev = self.train_net, self.device
        pipes = self._pipelines[id(net)]
        g = types.SimpleNamespace()
        g.cap = max(1, self._chunk_cap())
        g.sources = {}
        for name, pipe in pipes.items():
            bs = pipe.batchsize
            if self._cached:
                data, n = self._dev_data[id(net)][name], pipe.n
            else:
                # the staged block's rows and dtype (uint8 when the
                # stager compacts), or one fed batch
                if self.feeder_mode == "stream":
                    arr = self._chunk_stager().sources[name][0]
                    rows = bs * g.cap
                else:
                    arr, rows = pipe.images, bs
                data = {
                    "image": torch.zeros((rows, *arr.shape[1:]),
                                         dtype=_torch_dtype(arr.dtype),
                                         device=dev),
                    "label": torch.zeros(
                        rows, dtype=_torch_dtype(pipe.labels.dtype),
                        device=dev),
                }
                n = rows
            g.sources[name] = (data, bs, n, torch.arange(bs, device=dev))
        g.rgb = [(i, l) for i, l in enumerate(net.layers)
                 if isinstance(l, RGBImageLayer)
                 and (l.cropsize or l.mirror)]
        g.width = sum(l.staged_width() for _, l in g.rgb)
        g.head = 1 + len(pipes)
        g.host = np.zeros(g.head + g.cap * g.width, np.int64)
        g.args = torch.zeros(g.host.shape, dtype=torch.int64, device=dev)
        g.step = torch.zeros((), dtype=torch.int64, device=dev)
        g.sums = {}
        g.run = Graphed(self._train_body, dev)
        self._g = g
        return g

    def _write_args(self, g, step0: int, nsteps: int) -> None:
        """Stage the draws of steps [step0, step0 + nsteps) into the args
        block's host mirror ``g.host`` (its positions already filled),
        upload what the window reads in one copy, and set the step
        counter to ``step0``."""
        g.host[0] = step0
        self._stage_draws(g, g.host, step0, nsteps)
        k = g.head + nsteps * g.width
        src = torch.from_numpy(g.host[:k])
        if g.args.device.type == "cuda":
            src = src.pin_memory()
        g.args[:k].copy_(src, non_blocking=True)
        g.step.copy_(g.args[0])

    def _stage_draws(self, g, host, step0: int, nsteps: int) -> None:
        """kRGBImage's crop offsets and mirror flags for steps
        [step0, step0 + nsteps), drawn on the host from the eager path's
        generators (fold_in(seed, step, rank 0, layer)), into the args
        block's rows."""
        if not g.rgb:
            return
        rows = host[g.head:g.head + nsteps * g.width].reshape(nsteps, -1)
        for k in range(nsteps):
            rank_gen = fold_in(fold_in(self._step_gen, step0 + k), 0)
            row = []
            for i, layer in g.rgb:
                row += layer.staged_row(fold_in(rank_gen, i))
            rows[k] = row

    def _train_body(self) -> None:
        """One train step over the static tensors only: gather the batch
        at the counter's step (the JAX chunk's index math), forward,
        backward, the reduction seam, the update; then copy the new
        params and slots back, add the metrics to the sums and advance
        the counter. No host read: a CUDA graph replays it."""
        g = self._g
        i = g.step - g.args[0]
        batch = {}
        for j, (name, (data, bs, n, ar)) in enumerate(g.sources.items()):
            idx = (g.args[1 + j] + i * bs + ar) % n
            batch[name] = self._gather(self.train_net, name, data, idx)
        gen = None
        if g.rgb:
            row = g.args[g.head:].view(g.cap, g.width).index_select(
                0, i.view(1))[0]
            gen, o = {}, 0
            for li, layer in g.rgb:
                w = layer.staged_width()
                gen[li] = StagedDraw(row[o:o + 2], row[o + 2:o + w])
                o += w
        names = list(self.params)
        leaves = {nm: self.params[nm].detach().requires_grad_(True)
                  for nm in names}
        loss, metrics, updates = self.train_net.forward(
            self._cast_compute(leaves), self._cast_compute(batch),
            training=True, generator=gen,
            buffers=self.buffers, return_buffers=True,
        )
        loss.backward()
        grads = {nm: (leaves[nm].grad if leaves[nm].grad is not None
                      else torch.zeros_like(leaves[nm])) for nm in names}
        res = {}
        if self._comm is not None:
            grads, res = reduce_gradients(
                grads, self.buffers, self._comm, self._buckets(names))
        ok = None
        if self._guard is not None:
            # the verdict on the device: no host read, so a captured
            # graph replays it
            ok, grads = guard_grads(self._guard_buffers(), loss.detach(),
                                    grads)
        new_p, new_s = self.updater.apply(
            g.step, self.params, grads, self.state, self.specs)
        self._store_update(new_p, new_s, {**updates, **res}, ok)
        if ok is not None:
            metrics = guard_finish(ok, self._guard_buffers(), metrics)
        _add_sums(g.sums, metrics)
        self._advance_step()

    @torch.no_grad()
    def _store_update(self, new_p: dict, new_s: dict, res: dict,
                      ok=None) -> None:
        """Copy the update into the static params, slots and buffers
        (running stats and residuals), in place; with a guard verdict
        ``ok``, ``where(ok, new, old)``."""
        for nm, v in new_p.items():
            _put(self.params[nm], v, ok)
        for nm, slots in new_s.items():
            for s, v in slots.items():
                _put(self.state[nm][s], v, ok)
        self._store_buffers(res, ok)

    @torch.no_grad()
    def _store_buffers(self, updates: dict, ok=None) -> None:
        """Copy buffer updates into the Trainer's buffers in place: a
        captured step or eval reads them at fixed addresses. Entries
        that are the buffer itself (not updated) are skipped; with a
        guard verdict ``ok``, ``where(ok, new, old)``."""
        for k, v in updates.items():
            if v is not self.buffers[k]:
                _put(self.buffers[k], v, ok)

    def _guard_buffers(self) -> dict:
        """The live guard counters (0-d tensors on rank 0's device)."""
        return {k: self.buffers[k] for k in GUARD_KEYS}

    def _advance_step(self) -> None:
        self._g.step.add_(1)

    def _feed_block(self, g, block: dict) -> None:
        """Copy fed or staged batches (device tensors) into the static
        blocks' first rows."""
        for name, feed in block.items():
            data = g.sources[name][0]
            for k, v in feed.items():
                v = ready(v)
                data[k][:v.shape[0]].copy_(v)

    # ------------------------------------------------------------------
    # the train step and multi-step chunks
    # ------------------------------------------------------------------

    def train_one_batch(self, step: int) -> None:
        """TrainOneBatch (worker.cc:304-316): one forward+backward+update.
        Graphed: one replay of the step (one call of its body on the
        CPU) on the batch at the stream's position. A ``nanloss`` fault
        at ``step`` runs the step eager on its poisoned batch, fed
        directly (the JAX step's plain path)."""
        if self.telemetry is not None:
            self.telemetry.step = step  # an attribute stamp, no I/O
        ctx = self.resilience
        if self._dispatch != "graph":
            with self.timers.phase("data"):
                batch = self._next_batch(self.train_net)
            if ctx is not None:
                batch = ctx.inject_batch_faults(self, step, batch)
            with self.timers.phase("train"):
                metrics = self._step_core(step, batch)
            self.perf.update(metrics)
            return
        if ctx is not None and ctx.plan:
            with self.timers.phase("data"):
                batch = ctx.inject_batch_faults(
                    self, step, lambda: self._next_batch(self.train_net))
            if batch is not None:
                self.log(f"dispatch: eager for step {step} (nanloss: a "
                         "poisoned batch fed directly)")
                with self.timers.phase("train"):
                    metrics = self._step_core(step, batch)
                self.perf.update(metrics)
                return
        g = self._graph()
        pipes = self._pipelines[id(self.train_net)]
        with self.timers.phase("data"):
            if self._cached:
                pos = [pipe.position for pipe in pipes.values()]
            else:
                if self.feeder_mode == "prefetch":
                    feeder = self._device_feeder()
                    block = feeder.next()
                    self._feeder_positions = dict(feeder.consumed_positions)
                else:
                    block = self._assemble_host_batch(self.train_net)
                self._feed_block(g, block)
                pos = [0] * len(pipes)
            g.host[1:g.head] = pos
            self._write_args(g, step, 1)
        with self.timers.phase("train"):
            g.run(1)
        if self._cached:
            for pipe in pipes.values():
                pipe.advance(1)
        self.perf.update_summed(_take_sums(g.sums), 1)

    def _can_chunk(self) -> bool:
        """Chunking folds N steps into one dispatch window: it needs the
        dataset on the device (batch = index math inside the step), a
        graphed step and a chunk cap above 1."""
        if self.resilience is not None and self.resilience.per_step:
            # a fault plan needs exact per-step boundaries
            return False
        return (self._cached and self._dispatch == "graph"
                and self._chunk_cap() > 1)

    def _chunk_cap(self) -> int:
        return int(os.environ.get("SINGA_TPU_CHUNK", "64"))

    def train_chunk(self, step0: int, nsteps: int) -> None:
        """Run ``nsteps`` consecutive train steps as one window: the same
        steps as ``nsteps`` train_one_batch calls (the same wraparound
        batch indices, computed on the device from the stream positions,
        the same draws, the same updater schedule). Graphed, the
        positions and draws go up in one copy and the step is replayed
        ``nsteps`` times with no host work between; eager, it is
        ``nsteps`` train_one_batch calls."""
        if not (self._can_chunk() or self.feeder_mode == "stream"):
            for step in range(step0, step0 + nsteps):
                self.train_one_batch(step)
            return
        g = self._graph()
        pipes = self._pipelines[id(self.train_net)]
        streaming = self.feeder_mode == "stream"
        done = 0
        while done < nsteps:
            n = min(nsteps - done, g.cap)
            s0 = step0 + done
            with self.timers.phase("data", steps=n):
                if streaming:
                    block, after = self._chunk_stager().take(s0, n)
                    self._feed_block(g, block)
                    g.host[1:g.head] = 0
                else:
                    g.host[1:g.head] = [p.position for p in pipes.values()]
                self._write_args(g, s0, n)
            with self.timers.phase("train", steps=n):
                g.run(n)
            if streaming:
                # the stager owns the stream cursor; re-sync the
                # pipelines at the window boundary for checkpoints
                for name, pipe in pipes.items():
                    pipe.seek(after[name])
            else:
                for pipe in pipes.values():
                    pipe.advance(n)
            # metrics arrive summed over the window; Performance pulls
            # them to the host only at display
            self.perf.update_summed(_take_sums(g.sums), n)
            done += n

    def _next_fire(self, cur: int, freq: int, after: int) -> float:
        """Smallest s >= cur with _now(s, freq, after), or +inf."""
        if freq <= 0:
            return float("inf")
        base = max(cur, after)
        return base + (-(base - after)) % freq

    def _chunk_len(self, step: int) -> int:
        """Steps until the next cadence event bounds the chunk: val/test
        run BEFORE their trigger step (the chunk stops short of it);
        display/checkpoint run AFTER theirs (it may close the chunk)."""
        cfg = self.cfg
        n = min(cfg.train_steps - step, self._chunk_cap())
        if self.val_net is not None:
            fire = self._next_fire(
                step + 1, cfg.validation_frequency, cfg.validation_after_steps
            )
            n = min(n, fire - step)
        if self.test_net is not None:
            fire = self._next_fire(
                step + 1, cfg.test_frequency, cfg.test_after_steps
            )
            n = min(n, fire - step)
        fire = self._next_fire(
            step, cfg.display_frequency, cfg.display_after_steps
        )
        n = min(n, fire - step + 1)
        # checkpoint at step s saves "done = s+1" (see _post_events)
        fire = self._next_fire(
            step + 1, cfg.checkpoint_frequency, cfg.checkpoint_after_steps
        )
        n = min(n, fire - step)
        if self._guard is not None and self._guard.policy == "kRollback":
            # the rollback policy reads the consecutive-bad counter at
            # chunk boundaries: detection lags at most one window
            n = min(n, self._guard.rollback_after)
        return max(1, int(n))

    # ------------------------------------------------------------------
    # eval
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _eval_batch_metrics(self, net: Net, batch: dict) -> dict:
        """One eval batch -> {losslayer: metrics}, stateful layers on the
        live buffers (BatchNorm's running stats)."""
        _, metrics = net.forward(
            self._cast_compute(self.params), self._cast_compute(batch),
            training=False, buffers=self.buffers,
        )
        return metrics

    def _eval_graph(self, net: Net) -> types.SimpleNamespace:
        """A cached eval net's static tensors and Graphed body (the JAX
        eval chunk): a batch counter, each data layer's start position
        and the metric sums."""
        eg = self._eval_g.get(id(net))
        if eg is None:
            pipes = self._pipelines[id(net)]
            eg = types.SimpleNamespace()
            # the train step's args layout without draws: eval draws none
            eg.rgb, eg.width, eg.head = [], 0, 1 + len(pipes)
            eg.host = np.zeros(eg.head, np.int64)
            eg.args = torch.zeros(eg.host.shape, dtype=torch.int64,
                                  device=self.device)
            eg.step = torch.zeros((), dtype=torch.int64, device=self.device)
            eg.sums = {}
            eg.sources = {
                name: (self._dev_data[id(net)][name], pipe.batchsize, pipe.n,
                       torch.arange(pipe.batchsize, device=self.device))
                for name, pipe in pipes.items()
            }
            eg.run = Graphed(functools.partial(self._eval_body, net, eg),
                             self.device,
                             enabled=self._dispatch == "graph")
            self._eval_g[id(net)] = eg
        return eg

    @torch.no_grad()
    def _eval_body(self, net: Net, eg) -> None:
        """One eval batch over static tensors: the flat stream index
        math from the layer's start position and the batch counter."""
        i = eg.step - eg.args[0]
        batch = {}
        for j, (name, (data, bs, n, ar)) in enumerate(eg.sources.items()):
            idx = (eg.args[1 + j] + i * bs + ar) % n
            batch[name] = self._gather(net, name, data, idx)
        _add_sums(eg.sums, self._eval_batch_metrics(net, batch))
        eg.step.add_(1)

    def _eval_batches(self, net: Net, nsteps: int):
        """Yield ``nsteps`` eval batches. With ``prefetch`` on, uncached
        eval streams ride a BurstFeeder (``data/device_prefetch.py``):
        batch k+1 is assembled and copied on its thread while batch k is
        evaluated, and exactly ``nsteps`` batches are drawn, so the
        stream positions end where the direct path leaves them. Cached
        datasets and prefetch-off jobs take the direct path."""
        if self._cached or not self._prefetch_input:
            for _ in range(nsteps):
                yield self._next_batch(net)
            return
        from ..data.device_prefetch import BurstFeeder

        feeder = BurstFeeder(lambda: self._assemble_host_batch(net), nsteps)
        try:
            for _ in range(nsteps):
                yield {name: {k: ready(v) for k, v in feed.items()}
                       for name, feed in feeder.next().items()}
        finally:
            feeder.reset()

    def evaluate(self, net: Net, nsteps: int, phase: str, step: int) -> dict:
        """Test/Validate (worker.cc:318-348): nsteps batches, averaged.
        A cached net with nsteps > 1 runs as one eval chunk (replays of
        its eval graph, summed on the device); otherwise per batch."""
        perf = Performance()
        if self._can_chunk() and nsteps > 1 and id(net) in self._dev_data:
            eg = self._eval_graph(net)
            pipes = self._pipelines[id(net)]
            with self.timers.phase("eval", steps=nsteps):
                eg.host[1:] = [pipe.position for pipe in pipes.values()]
                self._write_args(eg, 0, nsteps)
                eg.run(nsteps)
            for pipe in pipes.values():
                pipe.advance(nsteps)
            perf.update_summed(_take_sums(eg.sums), nsteps)
        else:
            with self.timers.phase("eval", steps=nsteps):
                for batch in self._eval_batches(net, nsteps):
                    perf.update(self._eval_batch_metrics(net, batch))
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
            # the guard counters ride the display line: one host read,
            # at display cadence, never per step
            guard, g = "", {}
            if self._guard is not None:
                g = self.guard_counters()
                rb = getattr(self.resilience, "rollbacks", 0)
                guard = (f" guard[bad {g['bad_steps']}, rollbacks {rb}, "
                         f"lr x{g['lr_scale']:g}]")
            avg = self.perf.avg()
            self.log(
                f"step {step}: train {self.perf.to_string(avg)} "
                f"[{self.timers.to_string()}; {rate}]{guard}"
            )
            if self.telemetry is not None:
                self.telemetry.event(
                    "step", step=step,
                    metrics={l: dict(b) for l, b in avg.items()},
                    phase_ms={p: round(self.timers.mean_ms(p), 3)
                              for p in self.timers.phases()},
                    steps=self.perf.count,
                    samples_per_s=round(sps, 1),
                    steps_per_s=round(steps_s, 3),
                    **({"tokens_per_s": round(
                        steps_s * self.tokens_per_step, 1)}
                       if self.tokens_per_step else {}),
                    **({"guard": g} if g else {}),
                )
            self.perf.reset()
            self.timers.reset()
            if self.telemetry is not None:
                # the display boundary is the step loop's only flush
                self.telemetry.flush()
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
        """Worker::Run (worker.cc:98-106): the training loop. With a
        cached dataset or streaming blocks and a graphed step it advances
        by chunks (one window per cadence interval); otherwise one step
        at a time."""
        streaming = self.feeder_mode == "stream"
        chunking = self._can_chunk() or streaming
        ctx = self.resilience
        step = self.start_step
        self.completed_steps = step
        while step < self.cfg.train_steps:
            if ctx is not None:
                # the step-boundary seam: watchdog beat, fault injection,
                # the preemption drain (may raise)
                ctx.before_step(self, step)
            n = self._chunk_len(step) if chunking else 1
            self._pre_events(step)
            if n > 1 or (streaming and self._step_via_chunk(step)):
                # streaming routes length-1 windows through train_chunk
                # too: the stager's block schedule stays unbroken
                self.train_chunk(step, n)
            else:
                self.train_one_batch(step)
            self._post_events(step + n - 1)
            step += n
            if ctx is not None:
                # a guard rollback may rewind to the last checkpoint
                step = ctx.after_step(self, step)
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
        out = {
            f"{net.phase}|{name}": pipe.position
            for net in self._nets()
            for name, pipe in self._pipelines[id(net)].items()
        }
        # device-feeder mode: the pipelines run ahead of the trainer by
        # the feeder's read-ahead; checkpoint the consumed positions
        out.update(self._feeder_positions)
        return out

    def save(self, step: int) -> str | None:
        """Snapshot into ``<workspace>/checkpoints``: ``step_<step>.npz``
        (written by process 0; its whole slots and residuals are
        gathered from every process first), or with
        ``checkpoint_format: "sharded"`` the ``step_<step>.ckpt``
        directory of ``sharded_ckpt.save_sharded``, each process writing
        its ranks' shards. Every process calls it at the same step.

        Under a resilience context the context's ``checkpoint_written``
        seam follows every write (the corrupt_ckpt fault, validation,
        LATEST, retention). With ``async_checkpoint`` the step path only
        takes a snapshot (``_snapshot``) and queues its write on the
        context's writer thread."""
        folder = self._checkpoint_dir()
        if folder is None:
            return None
        ctx = self.resilience
        writer = ctx.async_ckpt if ctx is not None else None
        rec = self.telemetry
        if writer is None:
            # the ckpt phase times the save's step-path cost (sync: the
            # whole write; async: the snapshot and the submit)
            with self.timers.phase("ckpt"):
                path, write = self._prepare_save(folder, step, False)
                write()
            self.log(f"step {step}: checkpoint -> {path}")
            if rec is not None:
                rec.event("ckpt_save", step=step, path=path, mode="sync")
            if ctx is not None:
                ctx.checkpoint_written(self, path, step)
            return path
        with self.timers.phase("ckpt"):
            path, write = self._prepare_save(folder, step, True)
            writer.submit(
                step, path, write,
                on_written=lambda p, s: ctx.checkpoint_written(self, p, s),
            )
        self.log(f"step {step}: checkpoint (async) -> {path}")
        if rec is not None:
            rec.event("ckpt_save", step=step, path=path, mode="async")
        return path

    def _save_trees(self) -> tuple:
        """-> (sharded, params, state, buffers): what a save writes, in
        its format's layout (npz: the logical arrays, every process's
        slots and residuals gathered; sharded: the stored arrays, this
        process's rank shards)."""
        if self.cfg.checkpoint_format == "sharded":
            return (True, dict(self.params), self._state_layout(),
                    self._buffer_layout())
        state, buffers = self.state, self._whole_buffers()
        return (False,
                {n: self._unpad_one(n, v) for n, v in self.params.items()},
                {n: {k: self._unpad_one(n, v) for k, v in slots.items()}
                 for n, slots in state.items()},
                dict(buffers))

    def _prepare_save(self, folder: str, step: int, snapshot: bool):
        """-> (final path, zero-argument write function) of one save.
        ``snapshot=False`` writes the live tensors (the synchronous
        path: the function runs before the next step); ``snapshot=True``
        writes a snapshot (``_snapshot``), so the function may run on
        the writer thread while the step loop goes on: it waits for the
        snapshot's copy to the host and issues no device work."""
        mesh = self.mesh
        streams = self._stream_positions()
        sharded, params, state, buffers = self._save_trees()
        side = self._sidecar_tree()
        wait = release = None
        if snapshot:
            (params, state, buffers, side), wait, release = self._snapshot(
                (params, state, buffers, side))
        if sharded:
            path = os.path.join(folder, f"step_{step}.ckpt")
            extra = self._manifest_extra()

            def write_files() -> None:
                # on the writer thread no collective: the step loop
                # issues its own on the same group meanwhile
                save_sharded(path, step, params, state, buffers,
                             streams=streams, proc=mesh.proc,
                             nprocs=mesh.nprocs, manifest_extra=extra,
                             barrier=not snapshot)
        else:
            path = os.path.join(folder, f"step_{step}.npz")

            def write_files() -> None:
                if mesh.proc == 0:
                    save_checkpoint(path, step, params, state, buffers,
                                    streams=streams)

        def write() -> None:
            try:
                if wait is not None:
                    wait()
                write_files()
                self._write_sidecar(path, step, side)
            finally:
                if release is not None:
                    release()

        return path, write

    def _snapshot(self, trees):
        """The zero-stall save's stage 1 (``resilience/async_ckpt.py``):
        copy every tensor of ``trees`` (dicts of tensors or RankShards),
        device to device on the compute stream, into the next of two
        preallocated snapshot buffers, then on a side stream that waits
        for those copies, into pinned host memory, and record an event.
        -> (the same trees over the host copies, the writer's wait, the
        buffer's release). The next step writes the live tensors, never
        the snapshot; a buffer is reused only after its write released
        it (the writer queue's double buffer bounds that wait)."""
        leaves: list = []

        def collect(x):
            if isinstance(x, dict):
                for v in x.values():
                    collect(v)
            elif isinstance(x, tuple):
                for v in x:
                    collect(v)
            elif isinstance(x, RankShards):
                leaves.extend(x.parts)
            elif isinstance(x, torch.Tensor):
                leaves.append(x)

        collect(trees)
        k = self._snap_next
        self._snap_next ^= 1
        buf = self._snaps[k]
        sig = [(tuple(t.shape), t.dtype, t.device) for t in leaves]
        if buf is not None:
            buf["free"].wait()
        if buf is None or buf["sig"] != sig:
            cuda = any(t.device.type == "cuda" for t in leaves)
            dev_flat, dev = _flat_like(leaves, self.device, False)
            host_flat, host = ((dev_flat, dev) if not cuda else
                               _flat_like(leaves, "cpu", True))
            buf = {"sig": sig, "dev": dev, "host": host, "cuda": cuda,
                   "flat": (dev_flat, host_flat),
                   "free": threading.Event()}
            self._snaps[k] = buf
        buf["free"].clear()
        # one multi-tensor copy, then (on the card) one copy of the flat
        # snapshot to pinned memory: a handful of host calls, so a writer
        # thread holding the GIL delays the step loop little
        with torch.no_grad():
            torch._foreach_copy_(buf["dev"], leaves)
        done = None
        if buf["cuda"]:
            copied = torch.cuda.Event()
            copied.record()
            if getattr(self, "_ckpt_stream", None) is None:
                self._ckpt_stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self._ckpt_stream):
                self._ckpt_stream.wait_event(copied)
                buf["flat"][1].copy_(buf["flat"][0], non_blocking=True)
                done = torch.cuda.Event()
                done.record(self._ckpt_stream)
        it = iter(buf["host"])

        def rebuild(x):
            if isinstance(x, dict):
                return {n: rebuild(v) for n, v in x.items()}
            if isinstance(x, tuple):
                return tuple(rebuild(v) for v in x)
            if isinstance(x, RankShards):
                return RankShards(tuple(next(it) for _ in x.parts), x.dim,
                                  x.first, x.width)
            if isinstance(x, torch.Tensor):
                return next(it)
            return x

        out = rebuild(trees)
        return out, (done.synchronize if done is not None else None), \
            buf["free"].set

    def _sidecar_tree(self):
        """What a save writes beside its checkpoint, taken at the step
        boundary with it (the replica engine's ``.server`` state); None:
        nothing."""
        return None

    def _write_sidecar(self, path: str, step: int, tree) -> None:
        """Write ``_sidecar_tree``'s ``tree`` beside save ``path``."""
        del path, step, tree

    def _manifest_extra(self) -> dict:
        """Extra promises of a sharded save's manifest: the replica
        engine promises its ``.server`` sidecar (``{"sidecar": True}``),
        so that retention refuses a save whose sidecar tore or never
        landed."""
        return {}

    def _whole_buffers(self) -> dict:
        """The buffers with every rank's chunk of each ring residual:
        across processes the other processes' chunks are gathered (a
        collective); otherwise ``buffers`` as it is."""
        mesh = self.mesh
        n = mesh.width
        if mesh.nprocs == 1 or self._ring_chunk_dims is None:
            return self.buffers
        dims = {residual_key(nm): d
                for nm, d in self._ring_chunk_dims.items()
                if residual_key(nm) in self.buffers}
        parts = mesh.gather(
            [{key: self.buffers[key].chunk(n, dim=d)[r]
              for key, d in dims.items()} for r in mesh.local_ranks],
            self.device)
        out = dict(self.buffers)
        for key, d in dims.items():
            out[key] = torch.cat([p[key] for p in parts], dim=d)
        return out

    # ------------------------------------------------------------------
    # resilience: telemetry, rollback, guard state (resilience/context.py)
    # ------------------------------------------------------------------

    def attach_telemetry(self, rec) -> None:
        """Wire the flight recorder in: lifecycle events from the cadence
        loop and (span mode) every timed phase as a span. Buffer appends
        only: the step path gains no write and no device sync."""
        self.telemetry = rec
        if rec is not None:
            self.timers.span_sink = rec.phase_span

    def close(self) -> None:
        """Release what a run holds beyond its tensors: park the feeder
        threads and drop the captured graphs (the supervisor closes a
        failed attempt's trainer before the next one builds)."""
        self._reset_feeders()
        self._drop_graphs()

    def rollback_to(self, path: str) -> int:
        """Restore params, slots, buffers and stream positions from the
        checkpoint ``path`` into the live tensors (the guard's rollback):
        the addresses a captured step reads stay the same, so its graph
        replays the restored values. -> the checkpoint's step, where the
        cadence loop continues."""
        self.cfg.checkpoint = path
        # the checkpoint's own step, not the pre-rollback resume step
        self.start_step = 0
        self._reset_feeders()
        self._restore_live(path)
        self._seek_resumed_streams()
        self.completed_steps = self.start_step
        return self.start_step

    def _restore_live(self, path: str) -> None:
        """Overlay checkpoint ``path`` onto the live params, slots and
        buffers, in place."""
        live = self.buffers
        if is_sharded_checkpoint(path):
            self._restore_sharded()
        else:
            # an npz save holds the logical arrays; the setters pad
            ck_step, params, state, buffers = restore_into(
                path,
                {n: self._unpad_one(n, v) for n, v in self.params.items()},
                {n: {k: self._unpad_one(n, v) for k, v in slots.items()}
                 for n, slots in self.state.items()},
                self.buffers)
            self.params, self.state, self.buffers = params, state, buffers
            self._resume_streams = load_stream_positions(path)
            self.start_step = max(self.start_step, ck_step)
            self.log(f"rolled back to {path} at step {self.start_step}")
        with torch.no_grad():
            for k, v in self.buffers.items():
                if v is not live[k]:
                    live[k].copy_(v)
        self.buffers = live

    @torch.no_grad()
    def set_guard_state(self, consec: int | None = None,
                        lr_scale: float | None = None) -> None:
        """Overwrite the guard counters in place (a rollback resets the
        consecutive count and compounds the LR backoff)."""
        gb = self._guard_buffers()
        if consec is not None:
            gb[GUARD_CONSEC].fill_(int(consec))
        if lr_scale is not None:
            gb[GUARD_LR].fill_(float(lr_scale))

    def guard_counters(self) -> dict:
        """The guard counters on the host: one device read, so call it at
        a cadence boundary (display, rollback window, end of run), never
        per step. {} when unguarded."""
        if self._guard is None:
            return {}
        gb = self._guard_buffers()
        c, b, lr = torch.stack([gb[k].double() for k in GUARD_KEYS]).cpu()
        return {"consecutive_bad": int(c), "bad_steps": int(b),
                "lr_scale": float(lr)}

    def digest(self) -> str:
        """SHA-256 of the params' and the whole updater slots' bytes, by
        name: equal digests are equal values to the bit, so processes and
        runs compare by it. Under zero across processes ``state`` is a
        collective: every process calls it."""
        h = hashlib.sha256()
        state = self.state
        for nm in sorted(self.params):
            h.update(nm.encode())
            h.update(self.params[nm].detach().cpu().numpy().tobytes())
            for s in sorted(state.get(nm, {})):
                h.update(f"{nm}|{s}".encode())
                h.update(state[nm][s].detach().cpu().numpy().tobytes())
        return h.hexdigest()

    def _state_layout(self) -> dict:
        """The slots as a sharded save lays them: zero-sharded ones as
        this process's ranks' shards, the others whole (its first
        device's)."""
        mesh = self.mesh
        out = dict(self._replicas[self.device]["state"])
        local = mesh.local_ranks
        for nm in self._zero_names():
            out[nm] = {
                s: RankShards(tuple(self._zero_slots[r][nm][s]
                                    for r in local), self._zero_dims[nm],
                              local[0], mesh.width)
                for s in self._zero_slots[local[0]][nm]
            }
        return {nm: out[nm] for nm in self.params if nm in out}

    def _buffer_layout(self) -> dict:
        """The buffers as a sharded save lays them: on the ring each
        error-feedback residual as this process's ranks' chunks along
        the param's ring chunk dim (the chunk each rank banks), the JAX
        Trainer's residual layout; everything else whole."""
        mesh = self.mesh
        n = mesh.width
        local = mesh.local_ranks
        out = dict(self.buffers)
        if self._ring_chunk_dims is not None and n > 1:
            for nm, d in self._ring_chunk_dims.items():
                key = residual_key(nm)
                if key in out:
                    parts = out[key].chunk(n, dim=d)
                    out[key] = RankShards(tuple(parts[r] for r in local), d,
                                          local[0], n)
        return out


def _flat_like(tensors: list, device, pin: bool):
    """One flat byte buffer on ``device`` (pinned host memory when
    ``pin``) and views of it shaped and typed as ``tensors``, each at a
    256-byte boundary -> (buffer, views)."""
    sizes = [t.numel() * t.element_size() for t in tensors]
    offs, total = [], 0
    for n in sizes:
        offs.append(total)
        total += -(-n // 256) * 256
    flat = torch.empty(max(total, 1), dtype=torch.uint8, device=device,
                       pin_memory=pin)
    return flat, [flat[o:o + n].view(t.dtype).view(t.shape)
                  for o, n, t in zip(offs, sizes, tensors)]


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, np_dtype)).dtype


#: the metrics entry that carries each rank's loss (and on the ring its
#: reduced grads' squared norm) into the guarded eager tail
_GUARD_METRIC = "__guard__"


def _put(stored: torch.Tensor, new: torch.Tensor, ok) -> None:
    """``stored := new`` in place, or ``where(ok, new, stored)`` under a
    guard verdict ``ok`` (moved to the stored tensor's device)."""
    if ok is None:
        stored.copy_(new)
    else:
        apply_verdict(ok.to(stored.device), new, stored)


def _add_sums(sums: dict, metrics: dict) -> None:
    """Add one step's {layer: {metric: scalar}} into the static sums (the
    first call makes them)."""
    for layer, ms in metrics.items():
        bucket = sums.setdefault(layer, {})
        for k, v in ms.items():
            v = v.detach()
            if k in bucket:
                bucket[k].add_(v)
            else:
                bucket[k] = v.clone()


def _take_sums(sums: dict) -> dict:
    """A copy of the static sums, which are zeroed for the next window."""
    out = {layer: {k: v.clone() for k, v in ms.items()}
           for layer, ms in sums.items()}
    for ms in sums.values():
        for v in ms.values():
            v.zero_()
    return out
