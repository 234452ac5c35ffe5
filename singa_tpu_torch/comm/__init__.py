"""comm: the real wire under the fleet's transport seam, the PyTorch
counterpart of ``singa_tpu/comm``.

The reference's entire cross-process plane was a socket transport —
ZeroMQ PUSH/PULL shipping parameters and activations between workers
and servers (src/worker/neuralnet.cc:112-323). This package is its
serving-era reproduction: a TCP transport implementing the SAME
``send/recv/publish/statuses`` API as the fleet's in-process deques and
filesystem mailboxes (serve/fleet/transport.py), so the router, the
block-migration path, and the hosts never know which wire they ride.

  ``wire``    ``SocketTransport``: length-prefixed CRC'd framing,
              per-peer connections with bounded exponential-backoff
              reconnect, send deadlines with explicit timeout
              verdicts, at-least-once redelivery with per-sender
              message ids (the importer dedupes — a re-sent migration
              is a bitwise no-op), and status publication as a real
              latest-wins push stream instead of NFS mtime polling.
  ``faults``  the wire-fault layer: ``wire_drop@K`` / ``wire_delay@K``
              / ``wire_dup@K`` / ``wire_torn@K`` / ``wire_partition@K``
              terms riding the resilience fault grammar, so CI drills
              prove every failure ends in a documented verdict —
              retry-then-redeliver, reject-back-to-front-door, or a
              loud peer-death tombstone — never a silent hang or a
              half-applied import.
"""

from .faults import SendVerdict, WIRE_KINDS, WireFaults  # noqa: F401
from .wire import (  # noqa: F401
    FrameError,
    SocketTransport,
    WireError,
    pack_frame,
    read_frame,
)
