"""SocketTransport: TCP under the fleet's ``send/recv/publish/statuses``
seam (serve/fleet/transport.py), built to degrade loudly; the PyTorch
counterpart of ``singa_tpu/comm/wire.py``, the same bytes on the wire
(a port endpoint and a JAX one exchange frames).

Framing — every frame on the wire is::

    magic "STPW" | version u8 | type u8 | header_len u32 | payload_len
    u64 | header_crc u32 | payload_crc u32 | header JSON | payload

Length-prefixed so one bulk npz migration message is ONE frame (no
chunk protocol, the one-shot-transfer shape of arxiv 1805.08430), CRC'd
(zlib.crc32) so a torn or corrupted frame is REJECTED at the receiver —
the connection closes, no ack returns, and the sender redelivers. Three
frame types: ``MSG`` (a fleet message; acked), ``ACK``, and ``STATUS``
(latest-wins, never acked — a slow consumer can never back up the
feedback loop, the mailbox's discipline kept).

Delivery is AT-LEAST-ONCE with dedupe: every MSG carries a per-sender
monotonic message id; the receiver remembers recent ``(src, id)`` pairs
and acks duplicates WITHOUT re-enqueueing them, so a redelivered
migration is a bitwise no-op at the importer. The sender retries a
failed attempt (connect refused, send/ack deadline, CRC-rejected frame)
up to ``max_retries`` times behind bounded exponential backoff
(``backoff_s * 2**attempt``, capped at ``backoff_cap_s`` — no hot
reconnect loop), then raises ``WireError``: the explicit timeout
verdict. A peer that exhausted a send's budget is SUSPECT —
``dead_peers()`` reports it to the host's liveness watchdog (which
tombstones it, ``peer_death``) until a successful send or a fresh
status heals it (``wire_partition_heal``).

Endpoint addressing: ``addresses`` maps endpoint name -> ``host:port``.
``register(name)`` binds that endpoint's listener here (missing from
the map = auto-bind ``127.0.0.1:0`` and record the chosen port back, so
in-process drills need no pre-picked ports). One instance can host
EVERY endpoint of an in-process drill — messages still ride real TCP
loopback, real frames, real acks — while cross-process each process
registers only its own name.

Lifecycle events (flight recorder, thread-safe): ``wire_connect``,
``wire_send``, ``wire_retry``, ``wire_timeout``, ``wire_redeliver``,
``wire_crc_reject``, ``wire_partition_heal`` — peer + attempt + backoff
detail on each; ``wire_stats()`` counts them.
"""

from __future__ import annotations

import collections
import json
import socket
import struct
import threading
import time
import zlib

MAGIC = b"STPW"
VERSION = 1
MSG, ACK, STATUS = 1, 2, 3

#: magic, version, type, header_len, payload_len, header_crc, payload_crc
_HEAD = struct.Struct(">4sBBIQII")
MAX_HEADER = 1 << 20
MAX_PAYLOAD = 1 << 31

#: dedupe window per endpoint: remembered (src, id) pairs
DEDUPE_WINDOW = 4096


class FrameError(RuntimeError):
    """A frame could not be read: torn (EOF mid-frame), corrupted (CRC
    or header mismatch), or oversized. ``clean_eof`` marks the one
    benign case — the peer closed between frames."""

    def __init__(self, msg: str, *, clean_eof: bool = False):
        super().__init__(msg)
        self.clean_eof = clean_eof


class WireError(RuntimeError):
    """A send exhausted its retry budget: the explicit timeout verdict.
    Carries the peer and the attempt count so the host's failover path
    can tombstone and re-place without string parsing."""

    def __init__(self, msg: str, *, peer: str, attempts: int):
        super().__init__(msg)
        self.peer = peer
        self.attempts = attempts


# imported AFTER the exception classes: serve.fleet.host imports
# WireError back from this module, so by the time the fleet package
# init re-enters here the names it needs are already bound
from ..serve.fleet.transport import KINDS, Message  # noqa: E402


def pack_frame(ftype: int, header: dict, payload: bytes = b"") -> bytes:
    head = json.dumps(header).encode("utf-8")
    if len(head) > MAX_HEADER:
        raise ValueError(f"frame header {len(head)} bytes > {MAX_HEADER}")
    if len(payload) > MAX_PAYLOAD:
        raise ValueError(f"frame payload {len(payload)} bytes > {MAX_PAYLOAD}")
    return (
        _HEAD.pack(
            MAGIC, VERSION, ftype, len(head), len(payload),
            zlib.crc32(head), zlib.crc32(payload),
        )
        + head
        + payload
    )


def _read_exact(sock, n: int, *, at_boundary: bool = False) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise FrameError(
                f"EOF after {len(buf)}/{n} bytes",
                clean_eof=at_boundary and not buf,
            )
        buf.extend(chunk)
    return bytes(buf)


def read_frame(sock) -> tuple[int, dict, bytes]:
    """-> (type, header, payload); FrameError on EOF / CRC mismatch."""
    raw = _read_exact(sock, _HEAD.size, at_boundary=True)
    magic, version, ftype, hlen, plen, hcrc, pcrc = _HEAD.unpack(raw)
    if magic != MAGIC or version != VERSION:
        raise FrameError(f"bad frame magic/version {magic!r}/{version}")
    if hlen > MAX_HEADER or plen > MAX_PAYLOAD:
        raise FrameError(f"oversized frame (header {hlen}, payload {plen})")
    head = _read_exact(sock, hlen)
    payload = _read_exact(sock, plen) if plen else b""
    if zlib.crc32(head) != hcrc or zlib.crc32(payload) != pcrc:
        raise FrameError("frame CRC mismatch (torn or corrupted)")
    try:
        header = json.loads(head.decode("utf-8"))
    except ValueError as e:
        raise FrameError(f"frame header not JSON: {e}") from None
    return ftype, header, payload


def _parse_addr(addr: str) -> tuple[str, int]:
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


class SocketTransport:
    """The production wiring of the fleet transport seam (module
    docstring). Drop-in for ``LocalTransport`` / ``Mailbox``."""

    def __init__(self, addresses: dict[str, str] | None = None, *,
                 connect_timeout_s: float = 2.0,
                 send_timeout_s: float = 5.0, max_retries: int = 4,
                 backoff_s: float = 0.05, backoff_cap_s: float = 2.0,
                 liveness_timeout_s: float = 0.0, recorder=None,
                 faults=None):
        self.addresses = dict(addresses or {})
        self.connect_timeout_s = connect_timeout_s
        self.send_timeout_s = send_timeout_s
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.backoff_cap_s = backoff_cap_s
        self.liveness_timeout_s = liveness_timeout_s
        self.faults = faults
        self._lock = threading.Lock()
        self._inbox: dict[str, collections.deque[Message]] = {}
        self._status: dict[str, dict] = {}
        self._status_ns: dict[str, int] = {}
        #: per-endpoint dedupe window: (src, mid) -> seen
        self._seen: dict[str, set] = {}
        self._seen_order: dict[str, collections.deque] = {}
        self._seq: dict[str, int] = {}
        self._conns: dict[str, socket.socket] = {}
        self._listeners: dict[str, socket.socket] = {}
        self._accepted: list[socket.socket] = []
        self._threads: list[threading.Thread] = []
        #: peers whose last MSG send exhausted its retry budget
        self._suspect: set[str] = set()
        #: peers whose status broadcast failed: probe-backoff only,
        #: NEVER suspicion (a latent peer that has not launched yet is
        #: not dead — only a failed MESSAGE send may tombstone)
        self._quiet: dict[str, float] = {}
        self._last_heard: dict[str, float] = {}
        self._closed = False
        self._counters = collections.Counter()
        self._send_ms: dict[str, list[float]] = {}
        self._recorder = None
        self.recorder = recorder

    # -- recorder / fault wiring ---------------------------------------

    @property
    def recorder(self):
        return self._recorder

    @recorder.setter
    def recorder(self, rec) -> None:
        self._recorder = rec
        if self.faults is not None:
            self.faults.plan.recorder = rec
            self.faults.emit = self._event

    def _event(self, kind: str, **payload) -> None:
        self._counters[kind] += 1
        if self._recorder is not None:
            self._recorder.event(kind, **payload)

    # -- endpoint lifecycle --------------------------------------------

    def register(self, name: str) -> None:
        with self._lock:
            self._inbox.setdefault(name, collections.deque())
            self._seen.setdefault(name, set())
            self._seen_order.setdefault(name, collections.deque())
            if name in self._listeners:
                return
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        host, port = _parse_addr(self.addresses.get(name, "127.0.0.1:0"))
        srv.bind((host, port))
        srv.listen(64)
        srv.settimeout(0.2)
        # record the bound port back so in-process peers can dial an
        # auto-assigned endpoint without pre-picked ports
        self.addresses[name] = f"{host}:{srv.getsockname()[1]}"
        with self._lock:
            self._listeners[name] = srv
        t = threading.Thread(
            target=self._accept_loop, args=(srv,),
            name=f"wire-accept-{name}", daemon=True,
        )
        t.start()
        self._threads.append(t)

    def _accept_loop(self, srv) -> None:
        while not self._closed:
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._accepted.append(conn)
            t = threading.Thread(
                target=self._serve_conn, args=(conn,),
                name="wire-reader", daemon=True,
            )
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn) -> None:
        try:
            while not self._closed:
                try:
                    ftype, header, payload = read_frame(conn)
                except FrameError as e:
                    if not e.clean_eof:
                        # torn/corrupt frame: REJECT — close without
                        # acking so the sender redelivers a clean copy
                        self._event(
                            "wire_crc_reject",
                            src=None, reason=str(e),
                        )
                    return
                except OSError:
                    return
                self._handle_frame(ftype, header, payload, conn)
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _heal(self, peer: str, via: str) -> None:
        with self._lock:
            was = peer in self._suspect
            self._suspect.discard(peer)
            self._quiet.pop(peer, None)
        if was:
            self._event("wire_partition_heal", peer=peer, via=via)

    def _handle_frame(self, ftype, header, payload, conn) -> None:
        if ftype == MSG:
            src, dst, mid = header["src"], header["dst"], header["mid"]
            with self._lock:
                self._last_heard[src] = time.monotonic()
            self._heal(src, via="recv")
            key = (src, mid)
            fresh = False
            with self._lock:
                seen = self._seen.setdefault(dst, set())
                if key not in seen:
                    fresh = True
                    seen.add(key)
                    order = self._seen_order.setdefault(
                        dst, collections.deque()
                    )
                    order.append(key)
                    while len(order) > DEDUPE_WINDOW:
                        seen.discard(order.popleft())
                    # enqueue BEFORE acking: once the sender's ack
                    # arrives the message is already receivable
                    self._inbox.setdefault(
                        dst, collections.deque()
                    ).append(Message(header["kind"], src, payload))
            if not fresh:
                # the at-least-once no-op: a redelivered message still
                # acks (the sender may have missed the first ack) but
                # never re-enters the inbox
                self._event(
                    "wire_redeliver", peer=src, mid=mid,
                    msg_kind=header.get("kind"),
                )
            try:
                conn.sendall(pack_frame(ACK, {"mid": mid}))
            except OSError:
                pass  # sender gone; it will redeliver and re-ack
        elif ftype == STATUS:
            name, ns = header.get("name"), int(header.get("ns", 0))
            try:
                status = json.loads(payload.decode("utf-8"))
            except ValueError:
                return
            with self._lock:
                self._last_heard[name] = time.monotonic()
                if ns >= self._status_ns.get(name, 0):
                    self._status_ns[name] = ns
                    self._status[name] = status
            self._heal(name, via="status")
        # stray ACKs on a server conn are ignored

    # -- the send path --------------------------------------------------

    def _connect(self, dst: str, attempt: int) -> socket.socket:
        with self._lock:
            sock = self._conns.get(dst)
        if sock is not None:
            return sock
        addr = self.addresses.get(dst)
        if addr is None:
            raise KeyError(f"unknown destination {dst!r}")
        t0 = time.perf_counter()
        sock = socket.create_connection(
            _parse_addr(addr), timeout=self.connect_timeout_s
        )
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._event(
            "wire_connect", peer=dst, attempt=attempt,
            ms=round((time.perf_counter() - t0) * 1e3, 3),
        )
        with self._lock:
            self._conns[dst] = sock
        return sock

    def _drop_conn(self, dst: str) -> None:
        with self._lock:
            sock = self._conns.pop(dst, None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    @staticmethod
    def _transmit(sock, frame: bytes, verdict) -> None:
        """Write one frame, applying the fault verdict to THIS attempt
        (retries transmit clean — the verdict burned with the send)."""
        if verdict is None or not verdict:
            sock.sendall(frame)
            return
        if verdict.delay_s > 0:
            time.sleep(verdict.delay_s)
        if verdict.drop:
            return  # vanished on the wire: no bytes, no ack
        if verdict.torn:
            cut = max(_HEAD.size, (len(frame) * 3) // 4)
            torn = bytearray(frame)
            torn[min(cut, len(torn) - 1)] ^= 0xFF
            sock.sendall(bytes(torn))
            return
        sock.sendall(frame)
        if verdict.dup:
            sock.sendall(frame)

    def _await_ack(self, sock, mid: int) -> None:
        deadline = time.monotonic() + self.send_timeout_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise socket.timeout("ack deadline")
            sock.settimeout(remaining)
            ftype, header, _ = read_frame(sock)
            if ftype == ACK and header.get("mid") == mid:
                return
            # a stale ack (an earlier duplicate's) — ignore and keep
            # waiting for OURS within the same deadline

    def send(self, dst: str, kind: str, payload: bytes, *,
             src: str) -> None:
        if kind not in KINDS:
            raise ValueError(f"unknown message kind {kind!r}")
        if dst not in self.addresses:
            raise KeyError(f"unknown destination {dst!r}")
        with self._lock:
            mid = self._seq[src] = self._seq.get(src, 0) + 1
        frame = pack_frame(
            MSG, {"kind": kind, "src": src, "dst": dst, "mid": mid},
            payload,
        )
        verdict = (
            self.faults.on_send(dst) if self.faults is not None else None
        )
        t0 = time.perf_counter()
        last_err = "unreachable"
        for attempt in range(self.max_retries + 1):
            if self.faults is not None and self.faults.partitioned(dst):
                last_err = "partitioned"
            else:
                try:
                    sock = self._connect(dst, attempt)
                    self._transmit(
                        sock, frame, verdict if attempt == 0 else None
                    )
                    self._await_ack(sock, mid)
                    sock.settimeout(None)
                    self._heal(dst, via="send")
                    self._event(
                        "wire_send", peer=dst, msg_kind=kind, mid=mid,
                        bytes=len(frame), attempt=attempt,
                        ms=round((time.perf_counter() - t0) * 1e3, 3),
                    )
                    with self._lock:
                        self._send_ms.setdefault(dst, []).append(
                            (time.perf_counter() - t0) * 1e3
                        )
                    return
                except (OSError, FrameError) as e:
                    last_err = f"{type(e).__name__}: {e}"
                    self._drop_conn(dst)
            if attempt >= self.max_retries:
                break
            backoff = min(
                self.backoff_s * (2 ** attempt), self.backoff_cap_s
            )
            self._event(
                "wire_retry", peer=dst, attempt=attempt,
                backoff_s=round(backoff, 4), reason=last_err,
            )
            time.sleep(backoff)
        with self._lock:
            self._suspect.add(dst)
        self._event(
            "wire_timeout", peer=dst, msg_kind=kind, mid=mid,
            attempts=self.max_retries + 1, reason=last_err,
        )
        raise WireError(
            f"send to {dst!r} failed after {self.max_retries + 1} "
            f"attempts ({last_err})",
            peer=dst, attempts=self.max_retries + 1,
        )

    # -- recv / status ---------------------------------------------------

    def recv(self, name: str) -> list[Message]:
        """Drain and return every delivered message for ``name``."""
        with self._lock:
            box = self._inbox.get(name)
            if not box:
                return []
            out = list(box)
            box.clear()
        return out

    def publish(self, name: str, status: dict) -> None:
        """Latest-wins, push-style: store locally (covers every
        endpoint sharing this instance) and broadcast best-effort
        STATUS frames to all remote endpoints. Never raises, never
        acks, never retries — a failed broadcast marks the peer QUIET
        (probe backoff) so an idle or unlaunched peer costs one probe
        per interval, not a hot connect loop; suspicion is reserved
        for failed MESSAGE sends."""
        ns = time.time_ns()
        with self._lock:
            local = set(self._listeners)
            if ns >= self._status_ns.get(name, 0):
                self._status_ns[name] = ns
                self._status[name] = dict(status)
        frame = pack_frame(
            STATUS, {"name": name, "ns": ns},
            json.dumps(status).encode("utf-8"),
        )
        probe_after = max(0.2, self.backoff_cap_s)
        now = time.monotonic()
        for peer in sorted(self.addresses):
            if peer == name or peer in local:
                continue
            if self.faults is not None and self.faults.partitioned(peer):
                continue
            with self._lock:
                if self._quiet.get(peer, 0.0) > now:
                    continue
            try:
                sock = self._connect(peer, 0)
                sock.sendall(frame)
            except (OSError, KeyError):
                self._drop_conn(peer)
                with self._lock:
                    self._quiet[peer] = now + probe_after
        self._counters["wire_publish"] += 1

    def statuses(self) -> dict[str, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._status.items()}

    # -- liveness ---------------------------------------------------------

    def dead_peers(self) -> set[str]:
        """Peers the wire believes are gone: a send exhausted its retry
        budget (suspect), or — with ``liveness_timeout_s`` > 0 — a peer
        we HAVE heard from went silent past the timeout. The host's
        watchdog turns these into ``peer_death`` tombstones; a
        successful send or a fresh status heals them."""
        with self._lock:
            dead = set(self._suspect)
            if self.liveness_timeout_s > 0:
                now = time.monotonic()
                dead |= {
                    p for p, t in self._last_heard.items()
                    if now - t > self.liveness_timeout_s
                    and p not in self._listeners
                }
            return dead

    # -- introspection / teardown -----------------------------------------

    def wire_stats(self) -> dict:
        with self._lock:
            return {
                "connects": self._counters.get("wire_connect", 0),
                "sends": self._counters.get("wire_send", 0),
                "retries": self._counters.get("wire_retry", 0),
                "timeouts": self._counters.get("wire_timeout", 0),
                "redeliveries": self._counters.get("wire_redeliver", 0),
                "crc_rejects": self._counters.get("wire_crc_reject", 0),
                "partition_heals": self._counters.get(
                    "wire_partition_heal", 0
                ),
                "send_ms": {
                    peer: sorted(ms) for peer, ms in self._send_ms.items()
                },
            }

    def close(self) -> None:
        self._closed = True
        with self._lock:
            conns = list(self._conns.values()) + self._accepted
            self._conns.clear()
            self._accepted = []
            listeners = list(self._listeners.values())
            self._listeners.clear()
        for s in conns + listeners:
            try:
                s.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=1.0)
