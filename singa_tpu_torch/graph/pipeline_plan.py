"""Pipeline stages of a config net, placed by ``locationid``.

Counterpart of ``singa_tpu/graph/pipeline_plan.py`` (the reference's
layer placement, base_layer.h:151-165, as a GPipe microbatch schedule):
layers sharing a locationid form a stage, and ``parallel/pipeline.py``
runs the stages over the pipe axis. Stage params are stored replicated,
as in the JAX package: every rank holds every stage's params, and stage
s reads its own from the ranks of pipe index s.

Contract (``plan_stages`` refuses the rest, with the JAX package's
messages): locationids are exactly 0..P-1 for a P-wide pipe axis;
staged layers sit contiguously in topo order, grouped by stage; each
stage consumes one external activation (stage 0 the prologue's exit,
stage s stage s - 1's exit); stages are structurally identical; staged
layers draw nothing and hold no buffers or aux loss. Layers before and
after the staged region run on every rank.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config.schema import ConfigError


@dataclasses.dataclass
class PipelinePlan:
    nstages: int
    nmicro: int
    #: per-stage layer lists, topo order inside each stage
    stages: list[list]
    #: the one external layer name every stage-0 layer may reference
    entry_src: str
    #: stage exit layer name per stage (output of the stage)
    exits: list[str]
    #: param names by stage, aligned position-for-position with stage 0
    param_names: list[list[str]]


def plan_stages(net, npipe: int, nmicro: int = 0) -> PipelinePlan | None:
    """Group ``net``'s explicitly placed layers into pipeline stages.
    None when the net places nothing (no layer sets locationid, or all
    share one id): the plain forward runs. Raises ConfigError when the
    placement breaks the contract above."""
    staged = [l for l in net.layers if l.cfg.locationid is not None]
    ids = sorted({l.cfg.locationid for l in staged})
    if len(ids) < 2:
        return None
    if ids != list(range(npipe)):
        raise ConfigError(
            f"pipeline: locationids {ids} must be exactly 0..{npipe - 1} "
            f"(the cluster's npipes_per_group)"
        )
    for l in staged:
        if l.is_datalayer or l.is_parserlayer or l.is_losslayer:
            raise ConfigError(
                f"pipeline: layer {l.name!r} ({l.TYPE}) cannot be staged"
            )
        if l.has_buffers:
            raise ConfigError(
                f"pipeline: stateful layer {l.name!r} cannot be staged"
            )
        if l.TYPE == "kDropout":
            raise ConfigError(
                f"pipeline: {l.name!r}: dropout inside stages unsupported "
                "(stage functions run without rng)"
            )
        if l.has_aux_loss:
            raise ConfigError(
                f"pipeline: {l.name!r} ({l.TYPE}) cannot be staged — its "
                "auxiliary loss has no path out of the pipeline region"
            )

    # contiguity in topo order, grouped by increasing stage id
    order = [l for l in net.layers if l.cfg.locationid is not None]
    first = next(
        i for i, l in enumerate(net.layers) if l.cfg.locationid is not None
    )
    block = net.layers[first: first + len(order)]
    if [l.name for l in block] != [l.name for l in order]:
        raise ConfigError(
            "pipeline: staged layers must be contiguous in topo order"
        )
    seen_ids = [l.cfg.locationid for l in order]
    if seen_ids != sorted(seen_ids):
        raise ConfigError(
            f"pipeline: stage ids must be non-decreasing in topo order, "
            f"got {seen_ids}"
        )
    stages = [
        [l for l in order if l.cfg.locationid == s] for s in range(npipe)
    ]

    # every stage consumes exactly one external activation
    entry_src = None
    exits: list[str] = []
    for s, layers in enumerate(stages):
        names = {l.name for l in layers}
        external = set()
        for l in layers:
            external.update(src for src in l.srclayers if src not in names)
        expected = {exits[-1]} if s else None
        if s == 0:
            if len(external) != 1:
                raise ConfigError(
                    f"pipeline: stage 0 must consume one external "
                    f"activation, got {sorted(external)}"
                )
            entry_src = external.pop()
        elif external != expected:
            raise ConfigError(
                f"pipeline: stage {s} must consume only stage {s - 1}'s "
                f"exit {sorted(expected)}, got {sorted(external)}"
            )
        # the stage exit: the unique layer no other stage member consumes
        consumed = {src for l in layers for src in l.srclayers}
        tails = [l.name for l in layers if l.name not in consumed]
        if len(tails) != 1:
            raise ConfigError(
                f"pipeline: stage {s} must have one exit layer, got {tails}"
            )
        exits.append(tails[0])

    # structural identity across stages
    sig0 = [(l.TYPE, tuple(l.out_shape)) for l in stages[0]]
    specs0 = [
        sorted((n.split("/", 1)[1], sp.shape)
               for n, sp in l.param_specs().items())
        for l in stages[0]
    ]
    param_names = []
    for s, layers in enumerate(stages):
        sig = [(l.TYPE, tuple(l.out_shape)) for l in layers]
        if sig != sig0:
            raise ConfigError(
                f"pipeline: stage {s} structure {sig} != stage 0 {sig0} "
                "(stages must be identical for stacked params)"
            )
        specs = [
            sorted((n.split("/", 1)[1], sp.shape)
                   for n, sp in l.param_specs().items())
            for l in layers
        ]
        if specs != specs0:
            raise ConfigError(
                f"pipeline: stage {s} param shapes differ from stage 0"
            )
        names = []
        for l in layers:
            names.extend(sorted(l.param_specs()))
        param_names.append(names)

    if nmicro <= 0:
        nmicro = npipe
    return PipelinePlan(
        nstages=npipe,
        nmicro=nmicro,
        stages=stages,
        entry_src=entry_src,
        exits=exits,
        param_names=param_names,
    )


def stage_fn_for(plan: PipelinePlan):
    """-> f(stage_params_one, act) applying ONE stage's layer chain, keyed
    by stage 0's param names (the stages are structurally identical, so
    stage 0's layer objects compute every stage)."""
    layers = plan.stages[0]
    entry = plan.entry_src
    exit_name = plan.exits[0]

    def fn(params_one, act):
        acts = {entry: act}
        for layer in layers:
            inputs = [acts[src] for src in layer.srclayers]
            acts[layer.name] = layer.apply(params_one, inputs,
                                           training=True)
        return acts[exit_name]

    return fn


def stack_stage_params(plan: PipelinePlan, params: dict) -> dict:
    """Per-stage params stacked into (nstages, ...) leaves keyed by
    stage 0's names."""
    return {
        name0: torch.stack([params[plan.param_names[s][pos]]
                            for s in range(plan.nstages)])
        for pos, name0 in enumerate(plan.param_names[0])
    }


def pipeline_forward_region(plan: PipelinePlan, params: dict, x):
    """The staged region on one lane: microbatch, GPipe, un-microbatch."""
    from ..parallel.pipeline import pipeline_apply

    b = x.shape[0]
    if b % plan.nmicro:
        raise ConfigError(
            f"pipeline: batch {b} not divisible by {plan.nmicro} microbatches"
        )
    xm = x.reshape(plan.nmicro, b // plan.nmicro, *x.shape[1:])
    ym = pipeline_apply(stage_fn_for(plan), stack_stage_params(plan, params),
                        xm, plan.nstages)
    return ym.reshape(b, *ym.shape[2:])
