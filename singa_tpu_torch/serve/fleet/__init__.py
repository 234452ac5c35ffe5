"""Serving across engines, the PyTorch counterpart of
``singa_tpu/serve/fleet``. This slice ports ``migrate`` only: a
sequence's whole serving state (K/V blocks through its block table,
lanes, digest chain), a prefix cache's blocks, or a weight version, as
ONE bulk frame in the JAX package's format. The hosts, router and
transports come with a later slice (ROADMAP.md)."""

from .migrate import (  # noqa: F401
    MigratedSequence,
    deserialize,
    export_sequence,
    import_sequence,
    serialize,
)
