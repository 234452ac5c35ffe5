"""Wire faults: break the socket transport on purpose, deterministically;
the PyTorch counterpart of ``singa_tpu/comm/faults.py``.

Rides the resilience fault grammar (resilience/faults.py) — the same
``kind@at`` terms, the same fire-once budget, the same recorder wiring —
but keyed on MESSAGE SEND ORDINALS instead of training steps: the K in
``wire_drop@K`` is the K-th ``send()`` call (1-based) this process
makes, counted across every destination. Status broadcasts do NOT
consume ordinals (their cadence varies with idle ticks, which would
make drills non-deterministic); a partition applies to them anyway.

  wire_drop@K              the K-th send's first attempt vanishes on
                           the wire (written nowhere): no ack, the
                           sender times out and REDELIVERS — the
                           at-least-once proof
  wire_delay@K:ms=N        the K-th send's first attempt stalls N ms
                           before the bytes move — exercises deadlines
                           without tripping them
  wire_dup@K               the K-th send's frame is written TWICE: the
                           receiver must dedupe by message id (a
                           re-delivered migration is a bitwise no-op)
                           and the sender must ignore the stale ack
  wire_torn@K              one byte of the K-th send's frame is
                           flipped: the receiver's CRC rejects it,
                           closes the connection, and the sender
                           redelivers a clean copy
  wire_partition@K[=S][:peer=H]  from the K-th send on, peer H (or the
                           K-th send's destination when no ``peer=``)
                           is unreachable for S seconds (omitted = for
                           good): sends exhaust their retry budget,
                           the peer is tombstoned (``peer_death``),
                           and traffic fails over — the loud verdict

Faults fire on the FIRST attempt of their send only; the retries that
recover from them run clean. ``:peer=H`` scopes drop/delay/dup/torn to
sends addressed to H (the ordinal is still burned only when it fires,
matching the rank qualifier's don't-consume-elsewhere discipline).
"""

from __future__ import annotations

import dataclasses
import threading
import time

#: the wire's fault vocabulary (a subset of resilience.faults.KINDS)
WIRE_KINDS = (
    "wire_drop",
    "wire_delay",
    "wire_dup",
    "wire_torn",
    "wire_partition",
)


@dataclasses.dataclass
class SendVerdict:
    """What the fault layer does to ONE send's first attempt."""

    drop: bool = False
    dup: bool = False
    torn: bool = False
    delay_s: float = 0.0

    def __bool__(self) -> bool:
        return self.drop or self.dup or self.torn or self.delay_s > 0


class WireFaults:
    """The transport's fault hook: ``on_send`` burns one ordinal and
    returns the verdict for that send; ``partitioned`` answers whether
    a peer is currently unreachable (and heals expired partitions).
    ``emit`` is set by the transport so heals become recorder events."""

    def __init__(self, plan, *, clock=time.monotonic):
        self.plan = plan
        self.clock = clock
        self.emit = lambda kind, **payload: None
        self._n = 0
        #: peer -> heal deadline (None = partitioned for good)
        self._partitions: dict[str, float | None] = {}
        self._lock = threading.Lock()

    def on_send(self, dst: str) -> SendVerdict:
        with self._lock:
            self._n += 1
            n = self._n
        v = SendVerdict()
        if self.plan.fire("wire_drop", n, peer=dst):
            v.drop = True
        if self.plan.fire("wire_dup", n, peer=dst):
            v.dup = True
        if self.plan.fire("wire_torn", n, peer=dst):
            v.torn = True
        spec = self.plan.fire("wire_delay", n, peer=dst)
        if spec is not None:
            v.delay_s = (spec.ms or 0) / 1e3
        # a partition names its victim (peer= or this send's dst); it is
        # NOT dst-filtered — the ordinal triggers it, the victim suffers
        spec = self.plan.fire("wire_partition", n)
        if spec is not None:
            victim = spec.peer or dst
            with self._lock:
                self._partitions[victim] = (
                    None if spec.value is None
                    else self.clock() + spec.value
                )
        return v

    def partitioned(self, peer: str) -> bool:
        healed = False
        with self._lock:
            if peer not in self._partitions:
                return False
            until = self._partitions[peer]
            if until is not None and self.clock() >= until:
                del self._partitions[peer]
                healed = True
        if healed:
            self.emit("wire_partition_heal", peer=peer, via="expiry")
            return False
        return True
