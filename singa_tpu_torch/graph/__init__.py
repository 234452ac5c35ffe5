"""Net graph: build, topo-sort, shape-infer, and run layer DAGs."""

from .builder import Net, build_net, topo_sort

__all__ = ["Net", "build_net", "topo_sort"]
