"""Shared Kahn's-algorithm core for srclayers DAGs.

Two call sites used to hand-mirror this loop (and the duplicate-edge fix
of r5 had to land in both): ``graph.builder.topo_sort`` (fail-fast — a
cycle aborts the build) and ``lint.net_rules._cycle_members``
(report-all — lint wants the residue, not an exception). This module is
the single copy; the callers keep their own error policies.

The reference DFS-sorts in Graph::Sort (src/utils/graph.cc:80-101); Kahn
with a FIFO ready queue gives the same topological guarantee while being
stable with respect to the input order, which the builder relies on for
deterministic layer ordering.
"""

from __future__ import annotations

from typing import Mapping, Sequence


def kahn_order(
    names: Sequence[str], srcs: Mapping[str, Sequence[str]]
) -> tuple[list[str], set[str]]:
    """Kahn's algorithm over ``name -> list of source names`` edges.

    Returns ``(order, residue)``: ``order`` is a topological order of the
    acyclic part, stable wrt ``names`` order (FIFO ready queue);
    ``residue`` is the set of names on (or downstream of) a cycle — empty
    iff the graph is a DAG. Edges whose source is not in ``names`` are
    ignored (callers own dangling-edge reporting: builder raises,
    NET001 diagnoses). Duplicate edges count per occurrence — a layer may
    list the same src twice (e.g. concat of a layer with itself), so every
    occurrence must be removed when the source is emitted.
    """
    nameset = set(names)
    indeg = {
        n: sum(1 for s in srcs.get(n, ()) if s in nameset) for n in names
    }
    order: list[str] = []
    ready = [n for n in names if indeg[n] == 0]
    while ready:
        cur = ready.pop(0)
        order.append(cur)
        for n in names:
            deps = srcs.get(n, ())
            if cur in deps:
                indeg[n] -= list(deps).count(cur)
                if indeg[n] == 0:
                    ready.append(n)
    residue = {n for n in names if indeg[n] > 0}
    return order, residue
