"""netlint pass family 1b: build-based shape/dtype + param checks.

Counterpart of ``singa_tpu/lint/shape_rules.py``. These go one step
deeper than ``net_rules``: the net is actually built (layer ``setup`` =
shape inference, exactly what the worker would run) and the whole
forward pass runs on ``torch.device("meta")`` — tensors with full shapes
and dtypes but no storage, so no FLOP executes and no memory is touched,
yet every matmul dimension mismatch, dtype surprise, or broken layer
contract in the forward surfaces as a diagnostic instead of a crash
minutes into a job. A kernel wrapper given meta tensors returns its
outputs' shapes without launching anything (``ops/attention.py``
``flash_fwd``); every layer's forward, kMoE's dense routing and the
generator draws of kDropout and the parsers included, runs on meta as
it is. The draws take a CPU generator: kRGBImage's crop offsets and
mirror flags are its only host tensors, a few bytes.

Building a net opens its data sources (data layers learn their sample
shape from the first record, reference layer.cc:662-672), so when the
shards aren't present — the usual case for linting a conf checked into a
repo — the pass degrades to an INFO note rather than a false ERROR.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config.schema import ConfigError, ModelConfig
from ..graph.builder import Net, active_phases, build_net
from .core import Collector, ERROR, INFO, rule
from .net_rules import SHD001

SHP000 = rule(
    "SHP000", INFO, "shape pass skipped: data source not found"
)
SHP001 = rule("SHP001", ERROR, "net construction / shape inference failed")
SHP002 = rule(
    "SHP002", ERROR, "abstract forward on the meta device failed"
)
PRM001 = rule("PRM001", ERROR, "duplicate qualified param name")
PRM002 = rule("PRM002", ERROR, "share_param references an unknown param")
PRM003 = rule(
    "PRM003", ERROR, "shared param's shape differs from its owner's"
)
SHD002 = rule(
    "SHD002", ERROR, "param neuron/expert axis inconsistent with its shape"
)


def _collect_specs(net: Net, path: str, col: Collector) -> dict:
    """All param specs with PRM001 dupes reported (Net.param_specs
    fail-fasts on the first dupe; lint reports each)."""
    specs: dict = {}
    for layer in net.layers:
        for name, spec in layer.param_specs().items():
            if name in specs:
                col.emit(
                    PRM001,
                    f"{path} (layer {layer.name!r})",
                    f"param {name!r} already declared by another layer",
                )
            else:
                specs[name] = spec
    return specs


def _share_rules(specs: dict, path: str, col: Collector) -> bool:
    """PRM002/PRM003 over owner links; returns False when a link is so
    broken the abstract trace would KeyError."""
    ok = True
    for name, spec in specs.items():
        if spec.owner is None:
            continue
        owner = specs.get(spec.owner)
        if owner is None:
            col.emit(
                PRM002,
                f"{path} (param {name!r})",
                f"share_param owner {spec.owner!r} is not a declared "
                "param",
                fix_hint="share_param entries name the owner as "
                "'<layer>/<param>'",
            )
            ok = False
        elif tuple(owner.shape) != tuple(spec.shape):
            col.emit(
                PRM003,
                f"{path} (param {name!r})",
                f"shape {tuple(spec.shape)} != owner {spec.owner!r} "
                f"shape {tuple(owner.shape)}",
            )
    return ok


def _sharding_rules_built(
    net: Net,
    widths: dict[str, int],
    path: str,
    col: Collector,
    seen: set[str],
) -> None:
    """Precise SHD001/SHD002 from the inferred ParamSpecs — the same
    divisibility condition the Trainer's layout applies when it chooses
    pad-storage (model axis) or replicate (expert axis).
    ``seen`` dedups params across phases: geometry is phase-independent,
    but each phase can hold live layers every other phase excludes, so
    the caller runs this on every built phase."""
    nmodel = widths.get("model", 1)
    nexpert = widths.get("expert", 1)
    for layer in net.layers:
        for name, spec in layer.param_specs().items():
            if name in seen:
                continue
            seen.add(name)
            ndim = len(spec.shape)
            for label, axis, width, fallback in (
                ("neuron_axis", spec.neuron_axis, nmodel, "pads storage"),
                ("expert_axis", spec.expert_axis, nexpert, "replicates"),
            ):
                if axis is None:
                    continue
                if not 0 <= axis < ndim:
                    col.emit(
                        SHD002,
                        f"{path} (param {name!r})",
                        f"{label} {axis} out of range for shape "
                        f"{tuple(spec.shape)}",
                    )
                    continue
                if label == "neuron_axis" and layer.partition_dim != 1:
                    continue  # not kLayerPartition: stays replicated
                if width > 1 and spec.shape[axis] % width:
                    col.emit(
                        SHD001,
                        f"{path} (param {name!r})",
                        f"dim {axis} of shape {tuple(spec.shape)} not "
                        f"divisible by {label.split('_')[0]} axis "
                        f"{width}: {fallback} instead of sharding evenly",
                        fix_hint=f"size the dim as a multiple of {width}",
                    )


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=np_dtype)).dtype


def _abstract_forward(net: Net, specs: dict, phase: str) -> None:
    """Run Net.forward on meta tensors only: full shape/dtype
    propagation through every layer, zero compute, zero storage."""
    params = {
        name: _meta(spec.shape, torch.float32)
        for name, spec in specs.items()
        if spec.owner is None
    }
    batch = {}
    for dl in net.datalayers:
        batch[dl.name] = {
            "image": _meta((dl.batchsize, *dl.sample_shape),
                           _torch_dtype(dl.images.dtype)),
            "label": _meta((dl.batchsize,), _torch_dtype(dl.labels.dtype)),
        }
    with torch.no_grad():
        net.forward(params, batch, training=(phase == "kTrain"),
                    generator=torch.Generator().manual_seed(0))


def shape_pass(
    model_cfg: ModelConfig,
    path: str,
    col: Collector,
    widths: dict[str, int] | None = None,
) -> bool:
    """Build + abstractly trace every active phase.

    Returns True when at least one phase built (the caller then skips the
    config-level sharding fallback — these checks ran on real specs).
    """
    built_any = False
    shard_seen: set[str] = set()
    for phase in active_phases(model_cfg):
        try:
            net = build_net(model_cfg, phase)
        except OSError as e:
            # data layers open their sources during setup; a conf in a
            # repo usually points at shards that only exist on the
            # training host. Not an error in the conf itself.
            col.emit(
                SHP000,
                f"{path} (phase {phase})",
                f"net not built, data source unavailable: {e}",
            )
            continue
        except ConfigError as e:
            col.emit(
                SHP001, f"{path} (phase {phase})", str(e)
            )
            continue
        except Exception as e:
            # layer setup can raise arbitrary errors on degenerate
            # configs (e.g. stride 0 -> ZeroDivisionError); one bad conf
            # must not abort the diagnostics for every remaining file
            msg = str(e).strip().split("\n")[0][:300]
            col.emit(
                SHP001,
                f"{path} (phase {phase})",
                f"{type(e).__name__}: {msg}",
            )
            continue
        built_any = True
        specs = _collect_specs(net, path, col)
        links_ok = _share_rules(specs, path, col)
        if widths:
            _sharding_rules_built(net, widths, path, col, shard_seen)
        if not links_ok:
            continue
        try:
            _abstract_forward(net, specs, phase)
        except Exception as e:  # the forward surfaces arbitrary layer errors
            msg = str(e).strip().split("\n")[0][:300]
            col.emit(
                SHP002,
                f"{path} (phase {phase})",
                f"{type(e).__name__}: {msg}",
            )
    return built_any
