"""The port's real wire (singa_tpu_torch/comm/) on the CPU: framing
(round trip, CRC, magic, clean and torn EOF, oversized lengths), the
wire-fault grammar, ``SocketTransport`` on localhost under every wire
fault, and a fleet served over TCP. These are ``tests/test_wire.py``'s
cases, case for case where one applies. Then the cross-package bar: a
JAX ``SocketTransport`` and a port one exchange messages and statuses
both ways, and ``pack_frame`` writes the same bytes in both packages.

Tolerance: streams over the wire are identical to the in-process
transport's and the unified engine's; payloads arrive bitwise.
"""

import functools
import os
import socket
import time

import numpy as np
import pytest
import torch

from singa_tpu_torch.comm import (
    FrameError,
    SocketTransport,
    WireError,
    WireFaults,
    pack_frame,
    read_frame,
)
from singa_tpu_torch.models.transformer import TransformerConfig, init_lm
from singa_tpu_torch.resilience.faults import FaultPlan
from singa_tpu_torch.serve import EngineConfig, Request, Scheduler
from singa_tpu_torch.serve import Engine as _Engine
from singa_tpu_torch.serve.fleet import FleetHost, LocalTransport, Router

#: every engine of this file runs the plain versions on the CPU
Engine = functools.partial(_Engine, device="cpu")


def tiny_cfg(**kw):
    base = dict(
        vocab=32, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_len=32
    )
    base.update(kw)
    return TransformerConfig(**base)


def tiny_params(cfg, seed=0):
    return init_lm(torch.Generator().manual_seed(seed), cfg, "cpu")


def mixed_workload(cfg, n=6, seed=0):
    rs = np.random.RandomState(seed)
    prompts = [
        rs.randint(0, cfg.vocab, size=(int(rs.randint(3, 9)),)).astype(
            np.int32
        )
        for _ in range(n)
    ]
    budgets = [int(rs.randint(4, 10)) for _ in range(n)]
    return prompts, budgets


def run_fleet_until_done(hosts, n_requests, max_rounds=2000):
    idle = 0
    for _ in range(max_rounds):
        for h in hosts:
            h.tick()
        done = sum(
            1 for h in hosts for r in h.sched.finished if r.rid >= 0
        )
        if done >= n_requests:
            return
        idle = idle + 1 if not any(h.busy for h in hosts) else 0
        assert idle < 5, "fleet stalled with requests unfinished"
    raise AssertionError("fleet did not finish in the round budget")


def fleet_streams(hosts):
    return {
        r.rid: list(r.tokens)
        for h in hosts
        for r in h.sched.finished
        if r.rid >= 0
    }


def single_host_streams(params, cfg, ec, prompts, budgets):
    eng = Engine(params, cfg, ec)
    sched = Scheduler(eng)
    for i, (p, m) in enumerate(zip(prompts, budgets)):
        sched.submit(Request(rid=i, prompt=p, max_new_tokens=m))
    sched.serve()
    return {r.rid: list(r.tokens) for r in sched.finished}


def wire(addresses=None, **kw):
    """A loopback transport with drill-speed knobs."""
    base = dict(
        connect_timeout_s=1.0, send_timeout_s=1.0, max_retries=3,
        backoff_s=0.01, backoff_cap_s=0.1,
    )
    base.update(kw)
    return SocketTransport(addresses, **base)


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------


class TestFraming:
    def test_round_trip(self):
        a, b = socket.socketpair()
        try:
            hdr = {"kind": "migrate", "src": "p0", "dst": "d0", "mid": 7}
            payload = os.urandom(1 << 16)
            a.sendall(pack_frame(1, hdr, payload))
            ftype, header, got = read_frame(b)
            assert (ftype, header, got) == (1, hdr, payload)
        finally:
            a.close()
            b.close()

    def test_crc_mismatch_rejected(self):
        a, b = socket.socketpair()
        try:
            frame = bytearray(pack_frame(1, {"mid": 1}, b"Z" * 512))
            frame[-10] ^= 0xFF  # torn payload byte
            a.sendall(bytes(frame))
            with pytest.raises(FrameError, match="CRC"):
                read_frame(b)
        finally:
            a.close()
            b.close()

    def test_bad_magic_rejected(self):
        a, b = socket.socketpair()
        try:
            frame = bytearray(pack_frame(1, {"mid": 1}, b"x"))
            frame[0] ^= 0xFF
            a.sendall(bytes(frame))
            with pytest.raises(FrameError, match="magic"):
                read_frame(b)
        finally:
            a.close()
            b.close()

    def test_eof_between_frames_is_clean(self):
        a, b = socket.socketpair()
        a.close()
        try:
            with pytest.raises(FrameError) as ei:
                read_frame(b)
            assert ei.value.clean_eof
        finally:
            b.close()

    def test_eof_mid_frame_is_torn(self):
        a, b = socket.socketpair()
        try:
            a.sendall(pack_frame(1, {"mid": 1}, b"x" * 100)[:20])
            a.close()
            with pytest.raises(FrameError) as ei:
                read_frame(b)
            assert not ei.value.clean_eof
        finally:
            b.close()

    def test_oversized_declared_lengths_rejected(self):
        with pytest.raises(ValueError):
            pack_frame(1, {"pad": "x" * (1 << 21)})


# ---------------------------------------------------------------------------
# fault grammar (resilience/faults.py wire terms)
# ---------------------------------------------------------------------------


class TestWireFaultGrammar:
    def test_wire_terms_parse(self):
        plan = FaultPlan.parse(
            "wire_drop@3,wire_delay@5:ms=40,wire_dup@7,"
            "wire_torn@9,wire_partition@2=1.5:peer=decode0"
        )
        by_kind = {s.kind: s for s in plan.specs}
        assert by_kind["wire_drop"].at == 3
        assert by_kind["wire_delay"].ms == 40
        assert by_kind["wire_dup"].at == 7
        part = by_kind["wire_partition"]
        assert part.at == 2 and part.value == 1.5
        assert part.peer == "decode0"
        # round-trips through str (the armed-plan log line)
        assert "ms=40" in str(plan) and "peer=decode0" in str(plan)

    def test_ms_only_on_delay(self):
        with pytest.raises(ValueError):
            FaultPlan.parse("wire_drop@1:ms=5")

    def test_peer_only_on_wire_kinds(self):
        with pytest.raises(ValueError):
            FaultPlan.parse("crash@1:peer=h0")

    def test_negative_ms_rejected(self):
        with pytest.raises(ValueError):
            FaultPlan.parse("wire_delay@1:ms=-1")


# ---------------------------------------------------------------------------
# transport contract + fault verdicts
# ---------------------------------------------------------------------------


class TestSocketTransport:
    def test_send_recv_publish_statuses(self):
        t = wire()
        try:
            t.register("h0")
            t.register("h1")
            t.send("h1", "request", b"payload", src="h0")
            msgs = t.recv("h1")
            assert len(msgs) == 1
            assert (msgs[0].kind, msgs[0].src, msgs[0].payload) == (
                "request", "h0", b"payload"
            )
            assert t.recv("h1") == []  # drained
            t.publish("h0", {"host": "h0", "role": "prefill"})
            t.publish("h0", {"host": "h0", "role": "drained"})
            assert t.statuses()["h0"]["role"] == "drained"  # latest wins
        finally:
            t.close()

    def test_unknown_destination_and_kind(self):
        t = wire()
        try:
            t.register("h0")
            with pytest.raises(KeyError):
                t.send("ghost", "request", b"", src="h0")
            with pytest.raises(ValueError):
                t.send("h0", "gossip", b"", src="h0")
        finally:
            t.close()

    def test_bulk_payload_bitwise(self):
        t = wire()
        try:
            t.register("a")
            t.register("b")
            blob = os.urandom(1 << 20)  # a bulk npz-sized migration
            t.send("b", "migrate", blob, src="a")
            [msg] = t.recv("b")
            assert msg.payload == blob
        finally:
            t.close()

    def test_drop_retries_then_delivers(self):
        t = wire(
            send_timeout_s=0.3,
            faults=WireFaults(FaultPlan.parse("wire_drop@1")),
        )
        try:
            t.register("a")
            t.register("b")
            t.send("b", "migrate", b"Y" * 1000, src="a")
            [msg] = t.recv("b")
            assert msg.payload == b"Y" * 1000
            s = t.wire_stats()
            assert s["retries"] >= 1 and s["sends"] == 1, s
            assert s["timeouts"] == 0
        finally:
            t.close()

    def test_torn_frame_crc_rejected_then_clean_redelivery(self):
        t = wire(
            send_timeout_s=0.3,
            faults=WireFaults(FaultPlan.parse("wire_torn@1")),
        )
        try:
            t.register("a")
            t.register("b")
            payload = os.urandom(4096)
            t.send("b", "migrate", payload, src="a")
            [msg] = t.recv("b")
            assert msg.payload == payload  # the clean copy, bitwise
            s = t.wire_stats()
            assert s["crc_rejects"] >= 1 and s["retries"] >= 1, s
        finally:
            t.close()

    def test_duplicate_deduped_at_importer(self):
        t = wire(faults=WireFaults(FaultPlan.parse("wire_dup@1")))
        try:
            t.register("a")
            t.register("b")
            t.send("b", "migrate", b"X" * 1000, src="a")
            time.sleep(0.2)  # let the duplicate frame land too
            assert len(t.recv("b")) == 1  # ONE inbox copy
            assert t.wire_stats()["redeliveries"] == 1
        finally:
            t.close()

    def test_delay_fault_slows_but_delivers(self):
        t = wire(
            send_timeout_s=2.0,
            faults=WireFaults(FaultPlan.parse("wire_delay@1:ms=150")),
        )
        try:
            t.register("a")
            t.register("b")
            t0 = time.perf_counter()
            t.send("b", "request", b"q", src="a")
            assert time.perf_counter() - t0 >= 0.14
            assert len(t.recv("b")) == 1
        finally:
            t.close()

    def test_exhausted_retries_raise_and_suspect(self):
        t = wire(
            {"ghost": "127.0.0.1:1"},
            connect_timeout_s=0.2, send_timeout_s=0.2, max_retries=2,
        )
        try:
            t.register("me")
            with pytest.raises(WireError) as ei:
                t.send("ghost", "request", b"q", src="me")
            assert ei.value.peer == "ghost"
            assert ei.value.attempts == 3  # max_retries + 1, all burned
            assert t.dead_peers() == {"ghost"}
            assert t.wire_stats()["timeouts"] == 1
        finally:
            t.close()

    def test_backoff_bounds_no_hot_loop(self):
        t = wire(
            {"ghost": "127.0.0.1:1"},
            connect_timeout_s=0.2, send_timeout_s=0.2, max_retries=3,
            backoff_s=0.05, backoff_cap_s=2.0,
        )
        try:
            t.register("me")
            t0 = time.perf_counter()
            with pytest.raises(WireError):
                t.send("ghost", "request", b"q", src="me")
            elapsed = time.perf_counter() - t0
            # 0.05 + 0.1 + 0.2 of mandatory backoff between the 4
            # attempts: anything faster is a hot reconnect loop
            assert elapsed >= 0.35, elapsed
            assert elapsed < 10.0, elapsed  # ... and it terminates
            assert t.wire_stats()["retries"] == 3
        finally:
            t.close()

    def test_timed_partition_heals(self):
        t = wire(
            send_timeout_s=0.5, max_retries=6, backoff_s=0.05,
            faults=WireFaults(
                FaultPlan.parse("wire_partition@1=0.2:peer=b")
            ),
        )
        try:
            t.register("a")
            t.register("b")
            # the retry budget rides out the 0.2s partition window
            t.send("b", "migrate", b"W" * 100, src="a")
            assert len(t.recv("b")) == 1
            s = t.wire_stats()
            assert s["partition_heals"] >= 1 and s["retries"] >= 1, s
        finally:
            t.close()

    def test_permanent_partition_is_a_loud_timeout(self):
        t = wire(
            send_timeout_s=0.2, max_retries=1,
            faults=WireFaults(
                FaultPlan.parse("wire_partition@1:peer=b")
            ),
        )
        try:
            t.register("a")
            t.register("b")
            with pytest.raises(WireError):
                t.send("b", "request", b"q", src="a")
            assert "b" in t.dead_peers()
        finally:
            t.close()


# ---------------------------------------------------------------------------
# fleet over the wire: parity, failover, marooned
# ---------------------------------------------------------------------------


def build_wire_fleet(params, cfg, topo, transport, slots=2):
    ec = EngineConfig(slots=slots, kv_block_len=8, max_prefill_chunk=4)
    return [
        FleetHost(
            name, role, Engine(params, cfg, ec), transport,
            peers={n: r for n, r in topo if n != name},
        )
        for name, role in topo
    ]


class TestWireFleet:
    def test_socket_fleet_streams_bitwise_vs_local_and_single(self):
        cfg = tiny_cfg()
        params = tiny_params(cfg)
        prompts, budgets = mixed_workload(cfg, n=5, seed=3)
        ec = EngineConfig(slots=2, kv_block_len=8, max_prefill_chunk=4)
        base = single_host_streams(params, cfg, ec, prompts, budgets)
        topo = [("prefill0", "prefill"), ("decode0", "decode")]
        streams = {}
        for arm in ("local", "socket"):
            transport = (
                LocalTransport() if arm == "local" else wire()
            )
            hosts = build_wire_fleet(params, cfg, topo, transport)
            router = Router(transport)
            for i, (p, m) in enumerate(zip(prompts, budgets)):
                router.submit(
                    Request(rid=i, prompt=p, max_new_tokens=m)
                )
            run_fleet_until_done(hosts, len(prompts))
            streams[arm] = fleet_streams(hosts)
            if arm == "socket":
                transport.close()
        assert streams["socket"] == streams["local"] == base

    def test_partition_tombstones_and_fails_over_to_peer(self):
        cfg = tiny_cfg()
        params = tiny_params(cfg)
        prompts, budgets = mixed_workload(cfg, n=4, seed=5)
        ec = EngineConfig(slots=2, kv_block_len=8, max_prefill_chunk=4)
        base = single_host_streams(params, cfg, ec, prompts, budgets)
        topo = [
            ("prefill0", "prefill"),
            ("decode0", "decode"),
            ("decode1", "decode"),
        ]
        # permanent partition of decode0, armed on the first MSG send:
        # the prefill host's first export to it burns a (fast-failed)
        # retry budget, tombstones it, and re-places on decode1
        transport = wire(
            send_timeout_s=0.2, max_retries=1,
            faults=WireFaults(
                FaultPlan.parse("wire_partition@1:peer=decode0")
            ),
        )
        try:
            hosts = build_wire_fleet(params, cfg, topo, transport)
            router = Router(transport)
            for i, (p, m) in enumerate(zip(prompts, budgets)):
                router.submit(
                    Request(rid=i, prompt=p, max_new_tokens=m)
                )
            run_fleet_until_done(hosts, len(prompts))
            assert fleet_streams(hosts) == base
            prefill = hosts[0]
            assert "decode0" in prefill._dead  # the loud tombstone
            # every stream finished on the SURVIVING decode host
            decode1 = hosts[2]
            assert {
                r.rid for r in decode1.sched.finished if r.rid >= 0
            } == set(range(len(prompts)))
            assert not [
                r for r in hosts[1].sched.finished if r.rid >= 0
            ]
        finally:
            transport.close()

    def test_marooned_prefill_drains_and_exits_resumable(self):
        from singa_tpu_torch.resilience.preemption import EXIT_RESUMABLE

        cfg = tiny_cfg()
        params = tiny_params(cfg)
        prompts, budgets = mixed_workload(cfg, n=2, seed=7)
        topo = [("prefill0", "prefill"), ("decode0", "decode")]
        transport = wire(
            send_timeout_s=0.2, max_retries=1,
            faults=WireFaults(
                FaultPlan.parse("wire_partition@1:peer=decode0")
            ),
        )
        try:
            hosts = build_wire_fleet(params, cfg, topo, transport)
            prefill = hosts[0]
            for i, (p, m) in enumerate(zip(prompts, budgets)):
                prefill.submit(
                    Request(rid=i, prompt=p, max_new_tokens=m)
                )
            # tick until the export attempt tombstones the only
            # decode peer (bounded: each failed attempt fast-fails)
            for _ in range(50):
                prefill.tick()
                if "decode0" in prefill._dead:
                    break
            assert "decode0" in prefill._dead
            # the serve loop's verdict: marooned -> loud drain with
            # hand-back accounting + exit 75, never a silent idle loop
            rc, acct = prefill.serve_forever(max_idle_s=5.0)
            assert rc == EXIT_RESUMABLE
            assert acct is not None
            assert acct["reason"].startswith("wire:")
            handed = {e["rid"] for e in acct["handed_back"]}
            assert handed == set(range(len(prompts)))
        finally:
            transport.close()


# ---------------------------------------------------------------------------
# lint: WIR001 + schema did-you-means
# ---------------------------------------------------------------------------



# ---------------------------------------------------------------------------
# across packages: one wire
# ---------------------------------------------------------------------------


def test_pack_frame_bytes_equal_the_jax_package():
    from singa_tpu.comm import wire as jwire

    from singa_tpu_torch.comm import wire as twire

    payload = np.arange(1000, dtype=np.float32).tobytes()
    header = {"kind": "migrate", "src": "p0", "dst": "d0", "mid": 7}
    for ftype in (twire.MSG, twire.ACK, twire.STATUS):
        assert pack_frame(ftype, header, payload) == jwire.pack_frame(
            ftype, header, payload)
    assert (twire.MAGIC, twire.VERSION, twire.MSG, twire.ACK,
            twire.STATUS) == (jwire.MAGIC, jwire.VERSION, jwire.MSG,
                              jwire.ACK, jwire.STATUS)


def _recv_until(t, name, n, timeout=10.0):
    got = []
    deadline = time.monotonic() + timeout
    while len(got) < n:
        assert time.monotonic() < deadline, f"{name} got {len(got)}/{n}"
        got.extend(t.recv(name))
        time.sleep(0.005)
    return got


def test_jax_and_port_socket_transports_exchange_both_ways():
    """A JAX endpoint and a port endpoint, each on its own listener:
    messages (a bulk payload among them) and statuses cross both ways
    bitwise, each acked once; a frame the JAX side reads was written by
    the port's pack_frame and the other way round."""
    from singa_tpu.comm import SocketTransport as JSocketTransport

    kw = dict(connect_timeout_s=1.0, send_timeout_s=2.0, max_retries=3,
              backoff_s=0.01, backoff_cap_s=0.1)
    jt = JSocketTransport({}, **kw)
    tt = SocketTransport({}, **kw)
    try:
        jt.register("jax0")
        tt.register("torch0")
        jt.addresses["torch0"] = tt.addresses["torch0"]
        tt.addresses["jax0"] = jt.addresses["jax0"]
        bulk = np.random.RandomState(0).bytes(1 << 20)
        tt.send("jax0", "migrate", bulk, src="torch0")
        tt.send("jax0", "request", b'{"rid": 1}', src="torch0")
        jt.send("torch0", "cache_ship", bulk[::-1], src="jax0")
        jt.send("torch0", "shutdown", b"", src="jax0")
        at_jax = _recv_until(jt, "jax0", 2)
        at_torch = _recv_until(tt, "torch0", 2)
        assert [(m.kind, m.src, m.payload) for m in at_jax] == [
            ("migrate", "torch0", bulk), ("request", "torch0",
                                          b'{"rid": 1}')]
        assert [(m.kind, m.src, m.payload) for m in at_torch] == [
            ("cache_ship", "jax0", bulk[::-1]), ("shutdown", "jax0", b"")]
        tt.publish("torch0", {"host": "torch0", "role": "decode"})
        jt.publish("jax0", {"host": "jax0", "role": "prefill"})
        deadline = time.monotonic() + 10.0
        while ("torch0" not in jt.statuses()
               or "jax0" not in tt.statuses()):
            assert time.monotonic() < deadline, "statuses never crossed"
            time.sleep(0.005)
        assert jt.statuses()["torch0"]["role"] == "decode"
        assert tt.statuses()["jax0"]["role"] == "prefill"
        for t in (jt, tt):
            s = t.wire_stats()
            assert s["sends"] == 2 and s["timeouts"] == 0
            assert s["crc_rejects"] == 0
    finally:
        jt.close()
        tt.close()


def test_port_frames_fail_the_jax_crc_when_torn():
    """A port frame with one byte flipped: the JAX reader rejects it
    (CRC), as its own torn frames are rejected."""
    from singa_tpu.comm import wire as jwire

    frame = bytearray(pack_frame(1, {"kind": "request"}, b"x" * 64))
    frame[-3] ^= 0xFF
    a, b = socket.socketpair()
    try:
        a.sendall(bytes(frame))
        with pytest.raises(jwire.FrameError, match="CRC"):
            jwire.read_frame(b)
    finally:
        a.close()
        b.close()
