"""Partition semantics -> which rank holds which piece.

Counterpart of ``singa_tpu/parallel/shardings.py``. The JAX package
turns the reference's partitioning (kDataPartition splits a blob's batch
dim, kLayerPartition its neuron dim; neuralnet.cc:198-323) into GSPMD
shardings; the port turns them into the same layouts on its one
controller:

- ``batch_shardings``: every data layer's feed splits its batch dim over
  the data axis, and kSequenceData's tokens their sequence dim over the
  seq axis too (``shard_feed`` cuts a rank's piece).
- ``param_shardings``: each param of a kLayerPartition layer splits its
  ``neuron_axis`` over the model axis, and kMoE's expert weights their
  ``expert_axis`` over the expert axis; the rest are replicated.
  An indivisible neuron dim pads its STORED array to the next multiple
  (``param_paddings``; ``Net`` slices the tail off before a layer sees
  it) and warns; an indivisible expert count replicates and warns.

``zero_update_shardings`` is the ZeRO-style update layout
(``zero_update``, PAPERS.md arxiv 2004.13336) on the data axis, beside
the model axis or alone (the Trainer refuses zero beside the seq,
expert and pipe axes): the JAX package's forward sharding plus the data
axis on the first still-replicated dim the data width divides, the dim
a kLayerPartition param splits over the model axis excluded and a
padded dim counted at its stored length. It reduces to one number per
param, the dim its update is cut along over the data ranks, or None
when no dim divides evenly, in which case its update stays replicated
(announced by ``warnings.warn`` naming the param, as in the JAX
package). The rank at data index i owns slice i of that dim of its
model piece (``torch.chunk`` order: rows [i*m/n, (i+1)*m/n) of an
m-long dim), which on a data-only mesh is also the chunk the int8
ring's reduce-scatter leaves on rank i when the ring chunks that dim.
"""

from __future__ import annotations

import warnings

from .axes import split_rows
from .mesh import DATA_AXIS, MODEL_AXIS


def batch_shardings(mesh, net) -> dict:
    """{data layer: {feed key: the mesh axes its dims split over, dim by
    dim}}: batch over data; kSequenceData's tokens also their sequence
    over seq when the mesh has a seq axis."""
    nseq = mesh.widths["seq"]
    out = {}
    for layer in net.datalayers:
        img = (DATA_AXIS,)
        if nseq > 1 and layer.TYPE == "kSequenceData":
            img = (DATA_AXIS, "seq")
        out[layer.name] = {"image": img, "label": (DATA_AXIS,)}
    return out


def shard_feed(value, axes: tuple, mesh, r: int):
    """Rank ``r``'s piece of one feed array split over ``axes``."""
    c = mesh.coords(r)
    for dim, axis in enumerate(axes):
        value = split_rows(value, mesh.widths[axis], c[axis], dim)
    return value


def _param_layout(mesh, net, *, warn: bool = False):
    """-> iterator of (name, spec, (dim, axis) | None, pad): the dim a
    param splits over which mesh axis, and the extra length its STORED
    array needs on that dim so every shard is even. Expert dims never
    pad (a phantom expert would need routing masks): an indivisible
    expert count replicates."""
    nmodel = mesh.widths[MODEL_AXIS]
    nexpert = mesh.widths["expert"]
    for layer in net.layers:
        for name, spec in layer.param_specs().items():
            if (layer.partition_dim == 1 and spec.neuron_axis is not None
                    and nmodel > 1):
                d = spec.shape[spec.neuron_axis]
                pad = -d % nmodel
                if pad and warn:
                    warnings.warn(
                        f"layer {layer.name!r}: kLayerPartition dim "
                        f"{spec.neuron_axis} of param {name!r} (size {d}) "
                        f"is not divisible by the model axis ({nmodel}); "
                        f"storage pads to {d + pad}",
                        stacklevel=3,
                    )
                yield name, spec, (spec.neuron_axis, MODEL_AXIS), pad
            elif spec.expert_axis is not None and nexpert > 1:
                if spec.shape[spec.expert_axis] % nexpert:
                    if warn:
                        warnings.warn(
                            f"layer {layer.name!r}: expert dim "
                            f"{spec.expert_axis} of param {name!r} (size "
                            f"{spec.shape[spec.expert_axis]}) is not "
                            f"divisible by the expert axis ({nexpert}); "
                            "falling back to replication",
                            stacklevel=3,
                        )
                    yield name, spec, None, 0
                else:
                    yield name, spec, (spec.expert_axis, "expert"), 0
            else:
                yield name, spec, None, 0


def param_shardings(mesh, net) -> dict:
    """{param: (dim, mesh axis) it splits over, or None (replicated)},
    warning for each indivisible dim."""
    return {name: sharded
            for name, _, sharded, _ in _param_layout(mesh, net, warn=True)}


def param_paddings(mesh, net) -> dict[str, tuple]:
    """{param: np.pad-style widths} for the params whose STORED array is
    longer than the logical shape (indivisible kLayerPartition dims);
    only padded params appear."""
    out: dict[str, tuple] = {}
    for name, spec, sharded, pad in _param_layout(mesh, net):
        if pad:
            widths = [(0, 0)] * len(spec.shape)
            widths[sharded[0]] = (0, pad)
            out[name] = tuple(widths)
    return out


def zero_update_shardings(mesh, net, *, warn: bool = False
                          ) -> dict[str, int | None]:
    """{param name: the dim its update is sharded along over the data
    axis, or None (replicated update)} for every param ``net`` owns
    (shared params resolve through their owner). On a one-wide data
    axis every entry is None and nothing warns."""
    ndata = mesh.widths[DATA_AXIS]
    out: dict[str, int | None] = {}
    for name, spec, sharded, pad in _param_layout(mesh, net):
        if spec.owner is not None:
            continue
        shape = list(spec.shape)
        if pad:
            shape[sharded[0]] += pad
        dim = None
        if ndata > 1:
            dim = next(
                (d for d, size in enumerate(shape)
                 if (sharded is None or d != sharded[0])
                 and size and size % ndata == 0),
                None,
            )
        if dim is None and ndata > 1 and warn:
            warnings.warn(
                f"zero_update: no free dim of param {name!r} (stored "
                f"shape {tuple(shape)}) is divisible by the data axis "
                f"({ndata}); its update stays replicated",
                stacklevel=3,
            )
        out[name] = dim
    return out


def spec_json(dim: int | None, axes: dict[int, str] | None = None) -> list:
    """The JSON PartitionSpec a sharded checkpoint manifest records for
    an array split over the data axis along ``dim`` and over the mesh
    axes ``axes`` ({dim: axis}) along theirs: ``[]`` when replicated,
    else one entry per dim up to the last split one (None for a whole
    dim), e.g. ``[None, "data"]`` or ``["data", "model"]``."""
    placed = dict(axes or {})
    if dim is not None:
        placed[dim] = DATA_AXIS
    if not placed:
        return []
    return [placed.get(d) for d in range(max(placed) + 1)]
