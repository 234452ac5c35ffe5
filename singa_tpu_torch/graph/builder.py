"""Neural-net DAG builder.

Counterpart of ``singa_tpu/graph/builder.py`` (the reference's
NeuralNet::ConstructNeuralNet, src/worker/neuralnet.cc:72-110, and the
Worker's phase filtering, src/worker/worker.cc:69-95): layers are
filtered by ``exclude`` for the requested phase, topo-sorted from their
``srclayers`` edges, instantiated through the registry, and
shape-inferred in order. ``Net.forward`` runs the layers eagerly,
routes a kSlice layer's k-th output to its k-th consumer, and hands
each layer that draws a generator derived from the step's and its index
(the JAX package's ``jax.random.fold_in(rng, i)``), feeds stateful
layers their buffers and lets a ``layer_hook`` replace a layer's
compute (the contrastive-divergence trainer's Gibbs chains).
``Net.forward_ranks`` runs several ranks in lockstep, each layer for
every rank before the next: a stateful layer (kBatchNorm) sees every
rank's input at once and synchronises its statistics over the ranks,
and on a mesh with a pipe, expert, seq or model axis (``lanes``,
``parallel/axes.py``) a layer whose work crosses ranks runs them all in
one call (``Layer.apply_ranks``) and a pipeline-staged region runs as
one GPipe schedule per group of pipe ranks (``graph/pipeline_plan.py``).

``bind_mesh`` hands every layer the mesh; ``param_logical`` holds the
logical shapes of params whose stored arrays are padded for an uneven
kLayerPartition split, which ``resolve_params`` slices back.
"""

from __future__ import annotations

from typing import Any

import torch

from ..config.schema import ConfigError, LayerConfig, ModelConfig, NetConfig
from ..layers import Layer, create_layer
from ..layers.connector import SliceLayer
from ..parallel.axes import Lanes
from ..params import ParamSpec
from ..utils.rng import fold_in
from .kahn import kahn_order

PHASES = ("kTrain", "kValidation", "kTest")


def topo_sort(configs: list[LayerConfig]) -> list[LayerConfig]:
    """Kahn's algorithm over srclayers edges, stable wrt config order
    (the reference DFS-sorts in Graph::Sort, src/utils/graph.cc:80-101).
    Unknown srclayers and cycles abort the build with ConfigError."""
    by_name = {c.name: c for c in configs}
    if len(by_name) != len(configs):
        names = [c.name for c in configs]
        dupes = sorted({n for n in names if names.count(n) > 1})
        raise ConfigError(f"duplicate layer names after phase filter: {dupes}")
    for c in configs:
        for src in c.srclayers:
            if src not in by_name:
                raise ConfigError(
                    f"layer {c.name!r} references unknown srclayer {src!r}"
                )
    order, residue = kahn_order(
        [c.name for c in configs], {c.name: c.srclayers for c in configs}
    )
    if residue:
        raise ConfigError(f"cycle in layer graph involving {sorted(residue)}")
    return [by_name[n] for n in order]


class Net:
    """An ordered, shape-inferred layer DAG for one phase."""

    def __init__(self, layers: list[Layer], phase: str):
        self.phase = phase
        self.layers = layers
        #: the GPipe stages of a net on a pipe axis (set by the Trainer)
        self.pipeline_plan = None
        #: {param: logical shape} of params stored padded
        self.param_logical: dict[str, tuple] = {}
        self.name2layer = {l.name: l for l in layers}
        self.datalayers = [l for l in layers if l.is_datalayer]
        self.losslayers = [l for l in layers if l.is_losslayer]

    def setup(self) -> None:
        shapes: dict[str, tuple] = {}
        batchsize = 0
        for layer in self.layers:
            src_shapes = [shapes[s] for s in layer.srclayers]
            out = layer.setup(src_shapes, batchsize)
            layer.validate([self.name2layer[s] for s in layer.srclayers])
            if layer.is_datalayer:
                batchsize = layer.batchsize
            shapes[layer.name] = out
            layer.out_shape = out
        self.batchsize = batchsize

    def bind_mesh(self, mesh) -> None:
        """Hand every layer the mesh (its axes decide which layers cross
        ranks)."""
        for layer in self.layers:
            layer.mesh = mesh

    def param_specs(self) -> dict[str, ParamSpec]:
        specs: dict[str, ParamSpec] = {}
        for layer in self.layers:
            for name, spec in layer.param_specs().items():
                if name in specs:
                    raise ConfigError(f"duplicate param name {name!r}")
                specs[name] = spec
        return specs

    def buffer_specs(self) -> dict:
        """Non-trainable state (BufferSpec) declared by stateful layers."""
        specs = {}
        for layer in self.layers:
            specs.update(layer.buffer_specs())
        return specs

    def init_buffers(self, device=None) -> dict[str, torch.Tensor]:
        """Every buffer at its init value, float32, on ``device``."""
        return {
            name: torch.full(spec.shape, spec.init, dtype=torch.float32,
                             device=device)
            for name, spec in self.buffer_specs().items()
        }

    def resolve_params(self, params: dict) -> dict:
        """The param view every forward reads: shared params resolve
        through their owner's tensor (ParamSpec.owner), and padded
        storage is cut back to the logical shape (a rank's shard is no
        longer than it, and passes unchanged)."""
        resolved = dict(params)
        for layer in self.layers:
            for name, spec in layer.param_specs().items():
                if spec.owner is not None:
                    resolved[name] = params[spec.owner]
        for name, logical in self.param_logical.items():
            v = resolved.get(name)
            if v is not None and tuple(v.shape) != tuple(logical):
                resolved[name] = v[tuple(slice(0, n) for n in logical)]
        return resolved

    def forward(
        self,
        params: dict[str, torch.Tensor],
        batch: dict[str, Any],
        *,
        training: bool,
        generator: torch.Generator | None = None,
        buffers: dict[str, torch.Tensor] | None = None,
        return_buffers: bool = False,
        return_acts: bool = False,
        layer_hook=None,
    ):
        """Run all layers; returns (total_loss, {losslayer: metrics}).

        ``batch`` maps each data layer's name to its input dict
        ({"image": ..., "label": ...}). ``generator`` is the step's:
        layer i, if it ``uses_generator``, draws from ``fold_in(generator,
        i)``; a dict instead hands layer i its entry (the staged draws
        of a chunk, ``layers.data.StagedDraw``); without one, layers
        draw nothing (the eval path).

        ``buffers`` feeds stateful layers (batch-norm running stats);
        omitted, they use their init values. They stay float32 whatever
        the params' dtype. With ``return_buffers`` the post-step buffer
        dict is appended (before acts): the layers' updates over the
        buffers given. With ``return_acts`` the per-layer activation
        dict is appended. ``layer_hook``, if given, is called as
        hook(layer, resolved_params, inputs, layer_generator) before
        each layer; a non-None return replaces the layer's compute."""
        if buffers is None:
            buffers = (self.init_buffers(_device_of(params, batch))
                       if any(l.has_buffers for l in self.layers) else {})
        losses, metrics, acts, new_buffers = self._walk(
            [params], [batch], [generator], training=training,
            buffers=buffers, layer_hook=layer_hook)
        extra = []
        if return_buffers:
            extra.append(new_buffers)
        if return_acts:
            extra.append(acts[0])
        return (losses[0], metrics[0], *extra)

    def forward_ranks(self, params: list, batches: list, *,
                      generators: list, buffers: dict, sync=None,
                      lanes: Lanes | None = None):
        """The training forward of this process's ranks in lockstep:
        ``params[j]``, ``batches[j]`` and ``generators[j]`` are rank j's
        (as :meth:`forward` takes them), each layer runs for every rank
        before the next. A stateful layer takes every rank's input in
        one call (``apply_stateful_ranks``), its statistics taken over
        all ranks of ``sync`` (the mesh: its ``gather`` and ranks; on a
        mesh with more axes than data, ``apply_stateful_lanes`` over the
        ranks that split the batch); with ``lanes`` a layer
        that ``crosses`` them runs through ``apply_ranks`` and the
        pipeline plan's staged region through the GPipe schedule. ->
        (each rank's loss, each rank's metrics, the buffers after the
        layers' updates, the same for every rank)."""
        losses, metrics, _, new_buffers = self._walk(
            params, batches, generators, training=True, buffers=buffers,
            sync=sync, ranks=lanes)
        return losses, metrics, new_buffers

    def _walk(self, params: list, batches: list, generators: list, *,
              training: bool, buffers: dict, layer_hook=None, sync=None,
              ranks: Lanes | None = None):
        """Run every layer for each lane (a rank's params, batch and
        generator) -> (losses, metrics, acts, new buffers), a list per
        lane but the buffers. ``ranks``: the lanes' ranks on a mesh with
        more axes than data."""
        new_buffers = dict(buffers)
        lanes = range(len(params))
        resolved = [self.resolve_params(p) for p in params]
        acts: list[dict[str, Any]] = [{} for _ in lanes]
        cursors: list[dict[str, int]] = [{} for _ in lanes]
        losses = [0.0 for _ in lanes]
        metrics: list[dict] = [{} for _ in lanes]
        plan = self.pipeline_plan if ranks is not None else None
        staged = ({l.name for st in plan.stages for l in st}
                  if plan is not None else set())
        for i, layer in enumerate(self.layers):
            if layer.name in staged:
                # the staged region runs as one schedule when its first
                # layer is reached
                if layer is plan.stages[0][0]:
                    outs = self._pipeline(
                        plan, resolved, [a[plan.entry_src] for a in acts],
                        ranks, training)
                    for j in lanes:
                        acts[j][plan.exits[-1]] = outs[j]
                continue
            inputs = [self._inputs(layer, batches[j], acts[j], cursors[j])
                      for j in lanes]
            lgens = [_layer_generator(generators[j], i, layer)
                     for j in lanes]
            if ranks is not None and layer.crosses():
                outs = layer.apply_ranks(resolved, inputs, ranks,
                                         training=training)
            elif sync is not None and layer.has_buffers:
                if ranks is not None and ranks.mesh.has_axes:
                    outs, updates = layer.apply_stateful_lanes(
                        resolved, buffers, inputs, ranks)
                else:
                    outs, updates = layer.apply_stateful_ranks(
                        resolved, buffers, inputs, sync=sync)
                new_buffers.update(updates)
            else:
                outs = []
                for j in lanes:
                    out = None
                    if layer_hook is not None:
                        out = layer_hook(layer, resolved[j], inputs[j],
                                         lgens[j])
                    if out is None:
                        if layer.has_buffers:
                            out, updates = layer.apply_stateful(
                                resolved[j], buffers, inputs[j],
                                training=training, generator=lgens[j])
                            new_buffers.update(updates)
                        else:
                            out = layer.apply(resolved[j], inputs[j],
                                              training=training,
                                              generator=lgens[j])
                    outs.append(out)
            for j, out in zip(lanes, outs):
                if layer.is_losslayer:
                    loss, m = out
                    losses[j] = losses[j] + loss
                    metrics[j][layer.name] = m
                    acts[j][layer.name] = loss
                elif layer.has_aux_loss:
                    out, aux = out
                    losses[j] = losses[j] + layer.aux_weight * aux
                    acts[j][layer.name] = out
                else:
                    acts[j][layer.name] = out
        if ranks is not None and lanes and torch.is_tensor(losses[0]):
            # every exchange of the walk on the backward's path
            losses[0] = ranks.tie(losses[0])
        return losses, metrics, acts, new_buffers

    def _pipeline(self, plan, resolved: list, entry: list, lanes: Lanes,
                  training: bool) -> list:
        """The staged region for every lane: per group of lanes that
        share all coordinates but pipe and model, stage s runs on the
        group's lanes of pipe index s (their model ranks together), each
        lane's activation handed to the lane of the next stage with the
        same model index through the tick's hop (``gpipe_lanes``); the
        last stage's output goes to every pipe rank. This walk runs the
        stages it holds lanes of (all of them, or its share of a pipe
        group that spans processes). -> each lane's region output."""
        from ..parallel.pipeline import gpipe_lanes

        outs: list = [None] * len(entry)
        for group in lanes.groups("pipe", "model"):
            stage_lanes = [[j for j in group
                            if lanes.coords(j)["pipe"] == s]
                           for s in range(plan.nstages)]

            def run(s, acts_in):
                js = stage_lanes[s]
                return self._run_stage(
                    plan.stages[s], plan.exits[s], plan.entry_src
                    if s == 0 else plan.exits[s - 1],
                    [resolved[j] for j in js], acts_in, lanes.sub(js),
                    training)

            b = entry[group[0]].shape[0]
            if b % plan.nmicro:
                raise ConfigError(
                    f"pipeline: batch {b} not divisible by {plan.nmicro} "
                    "microbatches")
            mbs = {j: list(entry[j].chunk(plan.nmicro)) for j in group}
            got = gpipe_lanes(run, stage_lanes, mbs, lanes)
            for j in group:
                outs[j] = torch.cat(got[j])
        return outs

    @staticmethod
    def _run_stage(layers: list, exit_name: str, entry_name: str,
                   resolved: list, acts_in: list, lanes: Lanes,
                   training: bool) -> list:
        """One stage's layers on its lanes (activation ``acts_in[k]`` on
        lane k) -> each lane's exit activation."""
        acts = [{entry_name: a} for a in acts_in]
        for layer in layers:
            inputs = [[a[src] for src in layer.srclayers] for a in acts]
            if layer.crosses():
                outs = layer.apply_ranks(resolved, inputs, lanes,
                                         training=training)
            else:
                outs = [layer.apply(p, x, training=training)
                        for p, x in zip(resolved, inputs)]
            for a, out in zip(acts, outs):
                a[layer.name] = out
        return [a[exit_name] for a in acts]

    def _inputs(self, layer, batch: dict, acts: dict, cursor: dict) -> list:
        """A layer's inputs: its batch feed, or its source layers' outputs
        (a kSlice layer's k-th output to its k-th consumer)."""
        if layer.is_datalayer:
            return [batch[layer.name]]
        inputs = []
        for src in layer.srclayers:
            val = acts[src]
            if isinstance(self.name2layer[src], SliceLayer):
                k = cursor.get(src, 0)
                cursor[src] = k + 1
                val = val[k]
            inputs.append(val)
        return inputs


def _layer_generator(generator, i: int, layer):
    """Layer ``i``'s draws: its entry of a staged-draw dict, a generator
    folded from the step's when it draws, else None."""
    if isinstance(generator, dict):
        # staged draws of a multi-step chunk, by layer index
        return generator.get(i)
    if generator is not None and layer.uses_generator:
        return fold_in(generator, i)
    return None


def _device_of(params: dict, batch: dict):
    """The device of the first tensor among params and batch feeds."""
    for v in params.values():
        return v.device
    for feed in batch.values():
        for v in feed.values():
            return v.device
    return None


def active_phases(model_cfg: ModelConfig) -> list[str]:
    """Phases this job builds nets for: kTrain always, kTest/kValidation
    only when their step counts are set."""
    phases = ["kTrain"]
    if model_cfg.test_steps:
        phases.append("kTest")
    if model_cfg.validation_steps:
        phases.append("kValidation")
    return phases


def filter_phase(net_cfg: NetConfig, phase: str) -> list[LayerConfig]:
    """Drop layers whose ``exclude`` lists the phase (worker.cc:69-95)."""
    if phase not in PHASES:
        raise ConfigError(f"unknown phase {phase!r}")
    return [l for l in net_cfg.layer if phase not in (l.exclude or [])]


def build_net(model_cfg: ModelConfig, phase: str = "kTrain") -> Net:
    """Config -> phase-filtered, topo-sorted, shape-inferred Net."""
    if model_cfg.neuralnet is None:
        raise ConfigError("model config has no neuralnet block")
    configs = filter_phase(model_cfg.neuralnet, phase)
    if not configs:
        raise ConfigError(f"no layers left for phase {phase}")
    order = topo_sort(configs)
    net_partition = model_cfg.neuralnet.partition_type
    net = Net([create_layer(c, net_partition) for c in order], phase)
    net.setup()
    return net
