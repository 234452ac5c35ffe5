"""The replica engine: worker-group replicas reconciled by EASGD or
RandomSync.

Counterpart of ``singa_tpu/trainer/replica.py``. The reference's cluster
runs ``ngroups`` model replicas, each training on its own data and
reconciling through the parameter-server protocol that
UpdaterProto.param_type selects ("Elastic" | "RandomSync",
src/worker/neuralnet.cc:35-44). Here each rank of the mesh's data axis
holds one replica: its own params, updater slots and buffers
(BatchNorm's running stats), on its device, at fixed addresses that
every step and protocol round update in place, even when several ranks
share one card. The protocol rounds are ``parallel/consistency.py``'s
functions over the replicas stacked in rank order.

Lifecycle, as Worker::Start (src/worker/worker.cc:14-57):

  1. every replica initializes its own params (its own generator, a
     fold of the seed and its rank: ParamManager::InitParams seeds each
     process from the wall clock, so parity is distributional);
  2. ``warmup_steps`` local-only steps, whose measured step time feeds
     SyncConfig's bandwidth-adaptive sample ratio
     (param_manager.cc:85-93);
  3. bootstrap: replica 0 publishes to the server, every other replica
     fetches (worker.cc:50-55): center := replica 0, every replica :=
     center; RandomSync snapshots each replica (a copy);
  4. the main loop: a local update every step, a protocol round every
     ``sync_frequency`` steps (SyncNow, param_manager.cc:155-159).

Each step every replica takes a whole ``batchsize`` batch of its own:
replica i the i-th of R consecutive batches of the stream, as each
worker group read its own part of the data. The step's metrics are
averaged over the replicas; eval runs on replica 0.

Several processes (``parallel/launch.py``): each process holds its own
ranks' replicas and reads the whole global stream, keeping its ranks'
batches. A protocol round gathers every replica in rank order
(``Mesh.gather``), every process runs the same serial round on the same
values, keeps the center and copies back its own replicas, so P
processes give the bits of one process over the same ranks. RandomSync's
coordinates come from one seeded numpy stream that every process draws
alike, and the sample ratio is process 0's. Eval, saves and the digest
gather what they need from the other processes (collectives: every
process calls them at the same step).

Checkpoints: the base formats with the params, slots and buffers
stacked ``(R, ...)`` (an npz save by process 0; a sharded save with each
replica's row as its rank's box), plus the ``.server`` sidecar beside
them, an npz holding the center, ``__sample_ratio__`` and the RandomSync
``__snapshot__`` stack, written by process 0 after the base save; a
sharded save's manifest promises it and its ``commit_server.json``
marker follows it. Saves cross to and from the JAX package's replica
engine in both formats.

What the port leaves out: the step and the protocol round run eager
(the JAX package's fused multi-window programs, the rounds compiled into
the chunk, wait for graphs over several ranks); the replica axis beside
a model axis (kLayerPartition), which the Trainer refuses by name;
``resilience {}`` and the guard seam, as the Trainer refuses them;
``zero_update`` and ``grad_comm``, refused with the JAX Trainer's
messages, as the JAX replica engine refuses them.
"""

from __future__ import annotations

import functools
import hashlib
import os
import time
from typing import Callable

import numpy as np
import torch

from ..config.schema import ClusterConfig, ConfigError, ModelConfig
from ..data.device_prefetch import ready, to_device
from ..graph.builder import Net
from ..params import init_params
from ..parallel.consistency import (
    elastic_sync,
    random_sync,
    sample_sync_indices,
    sync_now,
    sync_ratio,
)
from ..resilience.coord import sidecar_path, write_sidecar_commit
from ..utils.rng import fold_in
from .checkpoint import load_checkpoint, load_stream_positions, save_checkpoint
from .sharded_ckpt import (
    RankShards,
    ShardedCheckpoint,
    buffer_key,
    is_sharded_checkpoint,
    param_key,
    save_sharded,
    state_key,
)
from .trainer import Trainer, _now

PROTOCOLS = ("Elastic", "RandomSync")


class ReplicaTrainer(Trainer):
    """The Trainer with one replica per rank of the data axis (see the
    module docstring). ``params``, ``state``, ``buffers`` and
    ``snapshot`` read the replicas stacked ``(R, ...)`` in rank order on
    rank 0's device (a copy; across processes a collective) and assign
    stacked values row by row into the replicas in place; ``center`` is
    the server's params, on every process."""

    _supports_zero_update = False
    _supports_grad_comm = False
    _splits_batch = False

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
        ucfg = model_cfg.updater
        if ucfg is None:
            raise ConfigError("model config has no updater block")
        if ucfg.param_type not in PROTOCOLS:
            # the reference logs "Unkown parameter type" (neuralnet.cc:43)
            raise ConfigError(
                f"unknown param_type {ucfg.param_type!r} "
                f"(expected one of {PROTOCOLS})"
            )
        # before the base constructor: _materialize_params and _resume
        # read them
        self.protocol = ucfg.param_type
        self.sync_frequency = ucfg.sync_frequency
        self.warmup_steps = ucfg.warmup_steps
        self.moving_rate = ucfg.moving_rate
        #: SyncConfig's adaptive ratio, set at bootstrap: RandomSync's
        #: coordinate fraction, and Elastic's alpha when moving_rate is 0
        #: (the reference passes sample_ratio_ to GenSyncMsgFromWorker
        #: whenever moving_rate_ is unset, param_manager.cc:190-194)
        self.sample_ratio = 1.0
        self._warmup_time = 0.0
        self._warmup_timed = 0
        self._sync_rng = np.random.RandomState(seed ^ 0x5EED)
        super().__init__(
            model_cfg, cluster_cfg, mesh=mesh, seed=seed, log=log,
            device=device, prefetch=prefetch, device_cache=device_cache,
            stream_chunks=stream_chunks, graphs=graphs,
        )
        # each step consumes one batch per replica
        self._batch_size = self.train_net.batchsize * self.nreplicas

    # ------------------------------------------------------------------
    # the replicas
    # ------------------------------------------------------------------

    def _materialize_params(self) -> None:
        """One replica per rank of this process: params from the rank's
        own generator, fresh updater slots and buffers, on the rank's
        device. Then the resume checkpoint, with its sidecar."""
        mesh = self.mesh
        #: the replica count: the data axis's width over every process
        self.nreplicas = mesh.width
        root = fold_in(self._init_gen, 2)
        #: global rank -> {"params", "state", "buffers"[, "snapshot"]} on
        #: the rank's device; None for the ranks of other processes
        self._reps: list[dict | None] = [None] * mesh.width
        for r in mesh.local_ranks:
            dev = mesh.device(r)
            params = init_params(fold_in(root, r), self.specs, dev)
            self._reps[r] = {
                "params": params,
                "state": self.updater.init_state(params),
                "buffers": self.train_net.init_buffers(dev),
            }
        self._resume_streams: dict[str, int] = {}
        #: the server's params (on rank 0's device), set at bootstrap
        self.center: dict[str, torch.Tensor] | None = None
        #: the PS holds a published model (worker.cc:50-55)
        self._bootstrapped = False
        self._eval_view: tuple[dict, dict] | None = None
        self._last_batch: list | None = None
        if self.cfg.checkpoint:
            self._resume(self.cfg.checkpoint)

    def _local(self, kind: str) -> list[dict]:
        """This process's replicas' ``kind`` dicts ("params", "state",
        "buffers", "snapshot"), one per rank, flat: a slot is keyed
        (param, slot)."""
        out = []
        for r in self.mesh.local_ranks:
            d = self._reps[r][kind]
            if kind == "state":
                d = {(n, s): v for n, slots in d.items()
                     for s, v in slots.items()}
            out.append(d)
        return out

    def _gathered(self, kind: str) -> list[dict]:
        """Every replica's flat ``kind`` dict in rank order: this
        process's own tensors, the other processes' gathered onto rank
        0's device (a collective across processes)."""
        local = self._local(kind)
        if not local[0]:
            return [{} for _ in range(self.mesh.width)]
        return self.mesh.gather(local, self.device)

    def _stacked(self, kind: str) -> dict:
        """The replicas' flat ``kind`` dict stacked ``(R, ...)`` on rank
        0's device, in rank order (a copy)."""
        reps = self._gathered(kind)
        return {k: torch.stack([d[k].to(self.device) for d in reps])
                for k in reps[0]}

    def _assign_rows(self, kind: str, value: dict) -> None:
        """Copy row r of each stacked ``(R, ...)`` value into replica r's
        tensor, in place, for this process's ranks (flat keys)."""
        local = self._local(kind)
        value = {k: torch.as_tensor(v) for k, v in value.items()}
        for k, v in value.items():
            want = (self.nreplicas, *local[0][k].shape)
            if tuple(v.shape) != want:
                raise ValueError(
                    f"{kind} {k!r}: shape {tuple(v.shape)} != {want} "
                    f"({self.nreplicas} replicas)"
                )
        with torch.no_grad():
            for r, d in zip(self.mesh.local_ranks, local):
                for k, v in value.items():
                    d[k].copy_(v[r])

    @property
    def params(self) -> dict:
        return self._stacked("params")

    @params.setter
    def params(self, value: dict) -> None:
        self._assign_rows("params", value)

    @property
    def state(self) -> dict:
        out: dict = {}
        for (n, s), v in self._stacked("state").items():
            out.setdefault(n, {})[s] = v
        return out

    @state.setter
    def state(self, value: dict) -> None:
        self._assign_rows("state", {(n, s): v for n, slots in value.items()
                                    for s, v in slots.items()})

    @property
    def buffers(self) -> dict:
        return self._stacked("buffers")

    @buffers.setter
    def buffers(self, value: dict) -> None:
        self._assign_rows("buffers", value)

    @property
    def snapshot(self) -> dict | None:
        """The RandomSync snapshots stacked ``(R, ...)``; None before the
        bootstrap and under Elastic (EASGD ships the whole vector and
        keeps none, param.h:170-175)."""
        if "snapshot" not in self._reps[self.mesh.local_ranks[0]]:
            return None
        return self._stacked("snapshot")

    def opt_state_bytes_per_device(self) -> int:
        """Bytes of updater state one replica holds."""
        return sum(v.numel() * v.element_size()
                   for v in self._local("state")[0].values())

    @staticmethod
    def _take_snapshot(params: dict) -> dict:
        """A RandomSync snapshot of one replica's params: a genuine copy.
        A snapshot that aliased the params would make every delta 0 and
        every round a silent no-op."""
        return {n: v.detach().clone() for n, v in params.items()}

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------

    def _dispatch_rule(self, graphs: bool | None) -> tuple[str, str]:
        if graphs is False:
            return "eager", "graphs=False"
        return "eager", (f"the replica engine: {self.nreplicas} replica(s), "
                         "one eager step each")

    def _can_chunk(self) -> bool:
        """run() advances by windows that end at the protocol's rounds
        (``_chunk_len``); each step of a window is eager."""
        return self._chunk_cap() > 1

    def _step_core(self, step: int, batches: list) -> dict:
        """Each replica of this process: forward and backward on its own
        batch, its updater on its own params and slots, its buffers'
        updates, all in place. -> the step's metrics, averaged over every
        replica in rank order."""
        mesh = self.mesh
        step_gen = fold_in(self._step_gen, step)
        self._last_batch = batches
        metrics = []
        for r in mesh.local_ranks:
            rep, dev = self._reps[r], mesh.device(r)
            leaves = {n: p.detach().requires_grad_(True)
                      for n, p in rep["params"].items()}
            batch = {name: {k: v.to(dev) for k, v in feed.items()}
                     for name, feed in batches[r].items()}
            loss, m, updates = self.train_net.forward(
                self._cast_compute(leaves), self._cast_compute(batch),
                training=True, generator=fold_in(step_gen, r),
                buffers=rep["buffers"], return_buffers=True,
            )
            loss.backward()
            grads = {n: (lv.grad if lv.grad is not None
                         else torch.zeros_like(lv))
                     for n, lv in leaves.items()}
            new_p, new_s = self.updater.apply(
                step, rep["params"], grads, rep["state"], self.specs)
            with torch.no_grad():
                for n, v in new_p.items():
                    rep["params"][n].copy_(v)
                for n, slots in new_s.items():
                    for s, v in slots.items():
                        rep["state"][n][s].copy_(v)
                for k, v in updates.items():
                    if v is not rep["buffers"][k]:
                        rep["buffers"][k].copy_(v)
            metrics.append({(layer, k): torch.as_tensor(v, device=self.device)
                            for layer, ms in m.items() for k, v in ms.items()})
        metrics = mesh.gather(metrics, self.device)
        out: dict = {}
        for layer, k in metrics[0]:
            out.setdefault(layer, {})[k] = functools.reduce(
                torch.add, (m[layer, k] for m in metrics)) / self.nreplicas
        return out

    def _next_batch(self, net: Net):
        """Train batches: one per replica, in stream order (replica i the
        i-th of R consecutive batches), a list over the global ranks with
        None for other processes' ranks, whose batches are skipped on the
        stream. Other nets: the base's one batch."""
        if net is not self.train_net:
            return super()._next_batch(net)
        if self._cached:
            out = []
            for r in range(self.nreplicas):
                local = self.mesh.is_local(r)
                batch = {}
                for name, pipe in self._pipelines[id(net)].items():
                    if not local:
                        pipe.advance(1)
                        continue
                    idx = torch.from_numpy(pipe.next_indices()).to(
                        self.device)
                    batch[name] = self._gather(
                        net, name, self._dev_data[id(net)][name], idx)
                out.append(batch if local else None)
            return out
        if self.feeder_mode == "prefetch":
            feeder = self._device_feeder()
            batches = feeder.next()
            self._feeder_positions = dict(feeder.consumed_positions)
        else:
            batches = self._assemble_host_batch(net)
        return [None if b is None else
                {name: {k: ready(v) for k, v in feed.items()}
                 for name, feed in b.items()} for b in batches]

    def _assemble_host_batch(self, net: Net):
        """Host assembly of the replicas' train batches (the device
        feeder's body too), their copies started; other nets: the
        base's."""
        if net is not self.train_net:
            return super()._assemble_host_batch(net)
        out = []
        for r in range(self.nreplicas):
            local = self.mesh.is_local(r)
            batch = {}
            for name, pipe in self._pipelines[id(net)].items():
                if not local:
                    pipe.advance(1)
                    continue
                images, labels = pipe.next_batch()
                batch[name] = {
                    "image": to_device(images, self.device,
                                       self._copy_stream),
                    "label": to_device(labels, self.device,
                                       self._copy_stream),
                }
            out.append(batch if local else None)
        return out

    # ------------------------------------------------------------------
    # the cadence: warmup, bootstrap, protocol rounds
    # ------------------------------------------------------------------

    def _sync_devices(self) -> None:
        for dev in set(self.mesh.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def train_one_batch(self, step: int) -> None:
        """One step of every replica, then the cadence: a warmup step is
        timed to a device sync (SyncConfig wants real compute time; the
        first step of the run is left out: it pays one-time set-up), the
        bootstrap once ``step + 1 >= warmup_steps``, a protocol round
        where ``sync_now``."""
        t0 = time.perf_counter()
        super().train_one_batch(step)
        if step < self.warmup_steps:
            self._sync_devices()
            if step > self.start_step:
                self._warmup_time += time.perf_counter() - t0
                self._warmup_timed += 1
        if not self._bootstrapped and step + 1 >= self.warmup_steps:
            self._bootstrap()
        if self._bootstrapped and sync_now(
                step, self.sync_frequency, self.warmup_steps):
            with self.timers.phase("sync"):
                self._sync_round()

    def _chunk_len(self, step: int) -> int:
        """Warmup steps run one at a time (their time feeds SyncConfig
        and the bootstrap fires between them); afterwards a window ends
        at the next ``sync_now`` step at the latest, so its round follows
        it."""
        if step < self.warmup_steps or not self._bootstrapped:
            return 1
        n = super()._chunk_len(step)
        freq = self.sync_frequency
        if freq > 0:
            # the smallest s >= step with (s + 1) % freq == 0
            fire = step + (-(step + 1)) % freq
            n = min(n, fire - step + 1)
        return max(1, int(n))

    def train_chunk(self, step0: int, nsteps: int) -> None:
        """``nsteps`` eager steps of every replica, then the round when
        the window's last step fires (``_chunk_len`` ends windows there,
        so no step inside one fires)."""
        fires = self._bootstrapped and sync_now(
            step0 + nsteps - 1, self.sync_frequency, self.warmup_steps)
        for step in range(step0, step0 + nsteps):
            Trainer.train_one_batch(self, step)
        if fires:
            with self.timers.phase("sync"):
                self._sync_round()

    def _bootstrap(self) -> None:
        """Group 0 publishes, the others fetch (worker.cc:50-55): center
        := replica 0, every replica := center; RandomSync snapshots every
        replica. Then SyncConfig on the measured warmup step time
        (worker.cc:42-48), process 0's ratio on every process."""
        first = self._gathered("params")[0]
        self.center = {n: v.to(self.device, copy=True)
                       for n, v in first.items()}
        with torch.no_grad():
            for d in self._local("params"):
                for n, v in d.items():
                    v.copy_(self.center[n])
        if self.protocol == "RandomSync":
            for r in self.mesh.local_ranks:
                rep = self._reps[r]
                rep["snapshot"] = self._take_snapshot(rep["params"])
        needs_ratio = self.protocol == "RandomSync" or self.moving_rate <= 0
        if needs_ratio and self.cluster is not None:
            model_mb = sum(int(np.prod(s.shape))
                           for s in self.specs.values()) * 4 / (1024 * 1024)
            steps = max(self._warmup_timed, 1)
            ratio = sync_ratio(
                self._warmup_time / steps, model_mb,
                self.cluster.nworkers or self.nreplicas,
                self.cluster.nservers, self.cluster.bandwidth,
            )
            if self.mesh.nprocs > 1:
                # every process must run the same round: process 0's
                # measurement wins (as float32, the JAX broadcast's type)
                mine = torch.tensor(ratio, dtype=torch.float32,
                                    device=self.device)
                ratio = float(self.mesh.gather(
                    [{"ratio": mine} for _ in self.mesh.local_ranks],
                    self.device)[0]["ratio"])
            self.sample_ratio = ratio
            self.log(f"Sample Ratio {self.sample_ratio}")
        self._bootstrapped = True

    def _sync_round(self) -> None:
        """One protocol round over every replica in rank order: the
        replicas (and RandomSync's snapshots) stacked, the round, the
        new center kept, this process's replicas copied back in
        place."""
        reps = self._stacked("params")
        if self.protocol == "Elastic":
            alpha = (self.moving_rate if self.moving_rate > 0
                     else self.sample_ratio)
            new_r, center = elastic_sync(reps, self.center, alpha)
            new_s = None
        else:
            snaps = self._stacked("snapshot")
            if self.sample_ratio >= 1.0:
                new_r, new_s, center = random_sync(
                    reps, snaps, self.center, None, full_coverage=True)
            else:
                # the params' sorted order: the JAX package's dict order,
                # so both draw the same coordinates for each param
                shapes = {n: tuple(reps[n].shape[1:]) for n in sorted(reps)}
                indices = {
                    n: torch.from_numpy(np.ascontiguousarray(ix)).to(
                        self.device)
                    for n, ix in sample_sync_indices(
                        self._sync_rng, shapes, self.nreplicas,
                        self.sample_ratio).items()}
                new_r, new_s, center = random_sync(
                    reps, snaps, self.center, indices)
        with torch.no_grad():
            for n, v in center.items():
                self.center[n].copy_(v)
        self._assign_rows("params", new_r)
        if new_s is not None:
            self._assign_rows("snapshot", new_s)

    # ------------------------------------------------------------------
    # eval, debug
    # ------------------------------------------------------------------

    def _replica0(self) -> tuple[dict, dict]:
        """Replica 0's params and buffers: its own tensors in one process;
        across processes gathered by every process (a collective)."""
        if self.mesh.nprocs == 1:
            return self._reps[0]["params"], self._reps[0]["buffers"]
        return self._gathered("params")[0], self._gathered("buffers")[0]

    def evaluate(self, net: Net, nsteps: int, phase: str, step: int) -> dict:
        """Test/Validate on replica 0's view (each reference group tests
        its own replica; group 0's seeds the server)."""
        self._eval_view = self._replica0()
        try:
            return super().evaluate(net, nsteps, phase, step)
        finally:
            self._eval_view = None

    @torch.no_grad()
    def _eval_batch_metrics(self, net: Net, batch: dict) -> dict:
        params, buffers = self._eval_view
        _, metrics = net.forward(
            self._cast_compute(params), self._cast_compute(batch),
            training=False, buffers=buffers,
        )
        return metrics

    def _post_events(self, step: int) -> None:
        cfg = self.cfg
        show = cfg.debug and _now(step, cfg.display_frequency,
                                  cfg.display_after_steps)
        super()._post_events(step)
        if show:
            self.log(self.debug_string(step))

    @torch.no_grad()
    def debug_string(self, step: int) -> str:
        """The reference's per-layer dump (mean |activation|) of this
        process's first replica on its last batch, then the replica
        spread: each param's largest |replica - center| over every
        replica, the quantity the protocols are to bound. Across
        processes a collective."""
        r = self.mesh.local_ranks[0]
        rep, dev = self._reps[r], self.mesh.device(r)
        lines = []
        if self._last_batch is not None:
            batch = {name: {k: v.to(dev) for k, v in feed.items()}
                     for name, feed in self._last_batch[r].items()}
            _, _, acts = self.train_net.forward(
                self._cast_compute(rep["params"]), self._cast_compute(batch),
                training=True,
                generator=fold_in(fold_in(self._step_gen, step), r),
                buffers=rep["buffers"], return_acts=True,
            )
            lines.append(
                f"debug (replica {r}): " + ", ".join(
                    f"{name} {float(a.float().abs().mean()):.4g}"
                    for name, a in acts.items()
                    if isinstance(a, torch.Tensor)))
        if self.center is not None:
            reps = self.params
            lines.append("replica spread: " + ", ".join(
                f"{n} {float((reps[n] - self.center[n]).abs().max()):.4g}"
                for n in sorted(reps)))
        return "\n".join(lines)

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def _rank_shards(self, kind: str) -> dict:
        """This process's replicas' flat ``kind`` tensors as the sharded
        format's rank boxes along a leading replica axis."""
        local = self._local(kind)
        ranks = self.mesh.local_ranks
        return {k: RankShards(tuple(d[k].unsqueeze(0) for d in local), 0,
                              ranks[0], self.nreplicas)
                for k in local[0]}

    def save(self, step: int) -> str | None:
        """The base formats with the replicas stacked ``(R, ...)``, then
        the ``.server`` sidecar. Every process calls it at the same
        step."""
        folder = self._checkpoint_dir()
        if folder is None:
            return None
        mesh = self.mesh
        streams = self._stream_positions()
        with self.timers.phase("ckpt"):
            if self.cfg.checkpoint_format == "sharded":
                path = os.path.join(folder, f"step_{step}.ckpt")
                state: dict = {}
                for (n, s), v in self._rank_shards("state").items():
                    state.setdefault(n, {})[s] = v
                save_sharded(path, step, self._rank_shards("params"), state,
                             self._rank_shards("buffers"), streams=streams,
                             proc=mesh.proc, nprocs=mesh.nprocs,
                             manifest_extra=self._manifest_extra())
            else:
                path = os.path.join(folder, f"step_{step}.npz")
                params, state, buffers = self.params, self.state, self.buffers
                if mesh.proc == 0:
                    save_checkpoint(path, step, params, state, buffers,
                                    streams=streams)
            self._save_sidecar(path, step)
        self.log(f"step {step}: checkpoint -> {path}")
        return path

    def _save_sidecar(self, path: str, step: int) -> None:
        """``<path>.server``: the center, ``__sample_ratio__`` and, under
        RandomSync, the stacked snapshots as ``__snapshot__``, written by
        process 0; beside a sharded save its commit marker follows."""
        if self.center is None:
            return
        snap = self.snapshot
        if self.mesh.proc != 0:
            return
        server = {**self.center,
                  "__sample_ratio__": np.float32(self.sample_ratio)}
        save_checkpoint(sidecar_path(path), step, server,
                        {"__snapshot__": snap} if snap else None)
        if os.path.isdir(path):
            write_sidecar_commit(path)

    def _manifest_extra(self) -> dict:
        """Promise the ``.server`` sidecar: a save whose process 0 died
        between the shard commit and the sidecar (or its marker) must
        never validate as resumable."""
        if self.center is None:
            return {}
        return {**super()._manifest_extra(), "sidecar": True}

    def _resume(self, path: str) -> None:
        """Overlay a save of either format onto the replicas (stacked
        ``(R, ...)`` arrays, row r for replica r; absent entries keep
        their init; another replica count raises), then its sidecar: the
        center, the ratio, and RandomSync's snapshots (an Elastic
        sidecar has none: they are refreshed from the restored replicas,
        as a fresh RandomSyncParam::Init does, param.cc:203-207)."""
        if is_sharded_checkpoint(path):
            with ShardedCheckpoint(path) as ck:
                arrays = {k: ck.assemble(k) for k in ck.keys()}
                step, streams = ck.step, dict(ck.streams)
        else:
            step, params, state, buffers = load_checkpoint(path)
            arrays = {param_key(n): v for n, v in params.items()}
            arrays.update({state_key(n, s): v for n, slots in state.items()
                           for s, v in slots.items()})
            arrays.update({buffer_key(n): v for n, v in buffers.items()})
            streams = load_stream_positions(path)
        for kind, key_of in (("params", param_key),
                             ("state", lambda k: state_key(*k)),
                             ("buffers", buffer_key)):
            for k, v in self._local(kind)[0].items():
                arr = arrays.get(key_of(k))
                if arr is None:
                    continue
                want = (self.nreplicas, *v.shape)
                if tuple(arr.shape) != want:
                    raise ValueError(
                        f"checkpoint {path!r}: {key_of(k)!r} shape "
                        f"{arr.shape} != model shape {want} (saved with a "
                        "different replica count?)"
                    )
                with torch.no_grad():
                    for r, d in zip(self.mesh.local_ranks,
                                    self._local(kind)):
                        d[k].copy_(torch.from_numpy(np.asarray(arr[r])))
        self._resume_streams = streams
        self.start_step = max(self.start_step, step)
        server = sidecar_path(path)
        if os.path.exists(server):
            _, sv_params, sv_state, _ = load_checkpoint(server)
            ratio = sv_params.pop("__sample_ratio__", None)
            if ratio is not None:
                self.sample_ratio = float(ratio)
            for n, v in sv_params.items():
                if n in self.specs and tuple(v.shape) != tuple(
                        self.specs[n].shape):
                    raise ValueError(
                        f"{server}: center param {n!r} shape {v.shape} "
                        f"!= model shape {self.specs[n].shape}"
                    )
            self.center = {
                n: torch.from_numpy(np.asarray(v, np.float32)).to(self.device)
                for n, v in sv_params.items()}
            snap = sv_state.get("__snapshot__")
            if self.protocol == "RandomSync":
                for r in self.mesh.local_ranks:
                    rep = self._reps[r]
                    rep["snapshot"] = self._take_snapshot(rep["params"])
                if snap:
                    self._assign_rows("snapshot", snap)
            self._bootstrapped = True
        self.log(f"resumed from {path} at step {self.start_step}")

    def digest(self) -> str:
        """The base digest (params and slots, stacked) with the center
        and the RandomSync snapshots: equal digests are equal replicas
        and server state to the bit. Across processes a collective."""
        h = hashlib.sha256(super().digest().encode())
        for kind, tree in (("center", self.center),
                           ("snapshot", self.snapshot)):
            for n in sorted(tree or {}):
                h.update(f"{kind}|{n}".encode())
                h.update(tree[n].detach().cpu().numpy().tobytes())
        return h.hexdigest()
