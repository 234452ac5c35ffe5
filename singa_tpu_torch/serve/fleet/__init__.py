"""Disaggregated serving fleet: router -> prefill hosts -> decode hosts;
the PyTorch counterpart of ``singa_tpu/serve/fleet``, with the same
exports.

One engine is a slot-count ceiling; a fleet is not. This package
composes the serving tier (serve/engine.py + serve/scheduler.py) into
a multi-host fleet with split roles — the serving-scale analog of the
reference's Worker/Server split (src/main.cc:49-55 picks a role by
rank) fronted by its Router tier (include/utils/router.h:16-57):

  ``migrate``    paged-KV block migration: a sequence's whole serving
                 state (K/V blocks through its block table, lanes,
                 digest chain) moves between hosts as ONE bulk
                 message — gather, wire, scatter; no RPC chatter
                 (arxiv 1805.08430). An imported sequence's token
                 stream is BITWISE the exporter's continuation.
  ``host``       the role split: prefill hosts run admission + chunked
                 prefill only and hand filled sequences to decode
                 hosts over the migration path; a SIGTERM'd host's
                 drain routes in-flight sequences to a PEER (decode
                 streams resume mid-token to full parity) instead of
                 only handing them back to the launcher.
  ``router``     the front door: least-loaded placement with
                 prefix-affinity over per-host occupancy feedback
                 (free slots / free blocks / queue depth, plus cached
                 block digests — a templated prompt routes to the
                 host already holding its prefix blocks).
  ``transport``  one-shot messages + latest-wins status, in-process
                 (deterministic drills) or filesystem mailboxes
                 (cross-OS-process, atomic tmp+rename — the commit
                 markers' discipline at message grain). The PRODUCTION
                 wiring of the same seam is ``comm.wire``'s TCP
                 ``SocketTransport`` (``fleet { transport: socket }``):
                 CRC'd frames, bounded-backoff retries, at-least-once
                 redelivery the importer dedupes, and peer-death
                 tombstones when a wire stays dead.

``tools/serve_bench.py --fleet`` is the load harness;
``python -m singa_tpu_torch.main`` with a ``fleet {}`` conf block
launches one host per ``-procsID`` (``-device cpu`` for the CPU).
"""

from .host import (  # noqa: F401
    FleetHost,
    fleet_topology,
    role_for_rank,
    run_from_conf,
)
from .migrate import (  # noqa: F401
    MigratedSequence,
    deserialize,
    export_sequence,
    import_sequence,
    serialize,
)
from .router import Router  # noqa: F401
from .transport import LocalTransport, Mailbox  # noqa: F401
