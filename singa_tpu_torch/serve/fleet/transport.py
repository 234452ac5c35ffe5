"""Fleet transport: one-shot messages + latest-wins status, the PyTorch
counterpart of ``singa_tpu/serve/fleet/transport.py``, file for file.

Hosts exchange self-contained one-shot messages (a migrated sequence, a
forwarded request, a shutdown) and publish latest-wins status snapshots
the router's occupancy feedback reads. Three interchangeable wirings
share one API; the third, ``comm.wire.SocketTransport`` (``fleet {
transport: socket }``), is TCP with CRC'd frames and retries. This
module holds the other two:

  ``LocalTransport``   in-process deques: a whole multi-host fleet in
      one process, deterministically, with the real wire bytes (migrate
      payloads are serialized and deserialized even in-process).

  ``Mailbox``          filesystem mailboxes under one shared root
      (``<root>/<host>/inbox/*.msg``, ``<root>/status/<host>.json``):
      the cross-OS-process wiring. Every file lands through
      ``atomic_write_bytes`` (pid-suffixed tmp + rename), so a reader
      sees a message absent or complete, never torn. The file names,
      the one-line JSON header and the status files are the JAX
      package's, so a port host and a JAX host share one root.

Message kinds (``Message.kind``): ``migrate`` (a serialized
MigratedSequence), ``request`` (a JSON generation request), ``result``
(a JSON finished stream), ``cache_fetch`` and its bulk reply
``cache_ship`` (the fleet prefix cache), ``weight_ship`` (a
next-version param tree as one CRC-guarded frame) and ``rollout`` (the
JSON control channel of the live weight rollout), ``shutdown`` (empty).
``status`` is not a message: it rides the latest-wins
``publish``/``statuses`` side channel.
"""

from __future__ import annotations

import collections
import dataclasses
import glob
import json
import os
import time

from ...resilience.coord import atomic_write_bytes

#: message kinds the fleet speaks
KINDS = (
    "migrate", "request", "result", "shutdown",
    "cache_fetch", "cache_ship", "weight_ship", "rollout",
)


@dataclasses.dataclass(frozen=True)
class Message:
    kind: str
    src: str
    payload: bytes


class LocalTransport:
    """In-process transport: per-endpoint FIFO deques + a status dict.
    Deterministic (no clocks in the order), single-threaded by
    construction — the fleet drill's tick loop is the only driver."""

    def __init__(self):
        self._inbox: dict[str, collections.deque[Message]] = {}
        self._status: dict[str, dict] = {}

    def register(self, name: str) -> None:
        self._inbox.setdefault(name, collections.deque())

    def send(self, dst: str, kind: str, payload: bytes, *,
             src: str) -> None:
        if kind not in KINDS:
            raise ValueError(f"unknown message kind {kind!r}")
        if dst not in self._inbox:
            raise KeyError(f"unknown destination {dst!r}")
        self._inbox[dst].append(Message(kind, src, payload))

    def recv(self, name: str) -> list[Message]:
        """Drain and return every queued message for ``name``."""
        box = self._inbox.get(name)
        if not box:
            return []
        out = list(box)
        box.clear()
        return out

    def publish(self, name: str, status: dict) -> None:
        self._status[name] = dict(status)

    def statuses(self) -> dict[str, dict]:
        """Latest published status per endpoint (latest wins)."""
        return {k: dict(v) for k, v in self._status.items()}


class Mailbox:
    """Filesystem transport rooted at one shared directory. Safe for
    one reader per inbox and any number of writers (atomic publish,
    unique per-sender filenames)."""

    def __init__(self, root: str):
        self.root = root
        self._seq: dict[str, int] = {}
        os.makedirs(os.path.join(root, "status"), exist_ok=True)

    def _inbox_dir(self, name: str) -> str:
        return os.path.join(self.root, name, "inbox")

    def register(self, name: str) -> None:
        os.makedirs(self._inbox_dir(name), exist_ok=True)

    def send(self, dst: str, kind: str, payload: bytes, *,
             src: str) -> None:
        if kind not in KINDS:
            raise ValueError(f"unknown message kind {kind!r}")
        os.makedirs(self._inbox_dir(dst), exist_ok=True)
        n = self._seq[src] = self._seq.get(src, 0) + 1
        header = json.dumps(
            {"kind": kind, "src": src, "seq": n}
        ).encode("utf-8")
        name = f"{time.time_ns():020d}_{src}_{n:06d}.msg"
        atomic_write_bytes(
            os.path.join(self._inbox_dir(dst), name),
            header + b"\n" + payload,
        )

    def recv(self, name: str) -> list[Message]:
        """Read-and-delete every complete message in arrival order."""
        out: list[Message] = []
        for path in sorted(
            glob.glob(os.path.join(self._inbox_dir(name), "*.msg"))
        ):
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except OSError:
                continue  # racing a writer's rename; next recv gets it
            head, _, payload = data.partition(b"\n")
            try:
                header = json.loads(head.decode("utf-8"))
            except ValueError:
                continue  # foreign file; leave it
            os.unlink(path)
            out.append(
                Message(header["kind"], header["src"], payload)
            )
        return out

    def publish(self, name: str, status: dict) -> None:
        atomic_write_bytes(
            os.path.join(self.root, "status", f"{name}.json"),
            json.dumps(status).encode("utf-8"),
        )

    def statuses(self) -> dict[str, dict]:
        out: dict[str, dict] = {}
        for path in glob.glob(os.path.join(self.root, "status", "*.json")):
            try:
                with open(path, encoding="utf-8") as f:
                    out[os.path.basename(path)[:-5]] = json.load(f)
            except (OSError, ValueError):
                continue  # torn/absent never poisons the feedback loop
        return out
