"""The ZeRO-style update layout (``zero_update``), data axis only.

Counterpart of ``zero_update_shardings`` in
``singa_tpu/parallel/shardings.py`` (PAPERS.md arxiv 2004.13336). The JAX
package gives each param a NamedSharding: its forward sharding plus the
data axis on the first still-replicated dim the data width divides.
The port has the data axis alone and no model axis, so every param is
replicated in the forward and has no padded (uneven-partition) storage
to carry: the layout reduces to one number per param, the dim its update
is cut along over the ranks, or None when no dim divides evenly, in
which case its update stays replicated (announced by ``warnings.warn``
naming the param, as in the JAX package).

Rank r owns slice r of that dim (``torch.chunk`` order: rows
[r*m/n, (r+1)*m/n) of an m-long dim), which is also the chunk the int8
ring's reduce-scatter leaves on rank r when the ring chunks that dim.
"""

from __future__ import annotations

import warnings

from .mesh import DATA_AXIS


def zero_update_shardings(mesh, net, *, warn: bool = False
                          ) -> dict[str, int | None]:
    """{param name: the dim its update is sharded along over the data
    axis, or None (replicated update)} for every param ``net`` owns
    (shared params resolve through their owner). On a one-wide data
    axis every entry is None and nothing warns."""
    ndata = mesh.shape[DATA_AXIS]
    out: dict[str, int | None] = {}
    for name, spec in net.param_specs().items():
        if spec.owner is not None:
            continue
        shape = list(spec.shape)
        dim = None
        if ndata > 1:
            dim = next(
                (d for d, size in enumerate(shape)
                 if size and size % ndata == 0),
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


def spec_json(dim: int | None) -> list:
    """The JSON PartitionSpec the JAX package's sharded checkpoint
    manifest records for an array sharded over the data axis along
    ``dim``: ``[]`` when replicated, else ``[None] * dim + ["data"]``
    (the JAX package's specs drop trailing Nones)."""
    return [] if dim is None else [None] * dim + [DATA_AXIS]
