"""The port's serving fleet (singa_tpu_torch/serve/fleet/) against the
port's unified engine, on the CPU: the prefill/decode role split over
LocalTransport and the Mailbox, mixed temperature lanes, a rejected
inadmissible wire request, drain to a peer with the grace sweep, a
latent peer's join and leave, the decode-only refusal, prefix reuse
across hosts, speculation and the fused path with migration,
``role_for_rank``/``fleet_topology``, and the Router's placement,
affinity, boot and events. These are ``tests/test_fleet.py``'s cases,
case for case where one applies, over the port's Engine (its jit-cache
checks have no counterpart: the port's programs are captured graphs,
held on the card by ``tests/test_torch_cuda.py``).

Tolerance: greedy and seeded temperature streams are identical to the
unified engine's (the same engine code runs both), token for token.
"""

import functools
import json

import numpy as np
import pytest
import torch

from singa_tpu_torch.models.transformer import TransformerConfig, init_lm
from singa_tpu_torch.serve import EngineConfig, Request, Scheduler
from singa_tpu_torch.serve import Engine as _Engine
from singa_tpu_torch.serve.fleet import (
    FleetHost,
    LocalTransport,
    Mailbox,
    Router,
    fleet_topology,
    migrate,
    role_for_rank,
)

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
    """Round-robin ticks until every request finished (messages sit in
    the transport for one round, so idleness only counts when
    consecutive)."""
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


def single_host_streams(params, cfg, ec, prompts, budgets, **req_kw):
    eng = Engine(params, cfg, ec)
    sched = Scheduler(eng)
    for i, (p, m) in enumerate(zip(prompts, budgets)):
        sched.submit(Request(rid=i, prompt=p, max_new_tokens=m, **{
            k: (v[i] if isinstance(v, list) else v)
            for k, v in req_kw.items()
        }))
    sched.serve()
    return {r.rid: list(r.tokens) for r in sched.finished}


def build_2host(params, cfg, ec, transport=None):
    t = transport or LocalTransport()
    pre = FleetHost("p0", "prefill", Engine(params, cfg, ec), t,
                    peers={"d0": "decode"})
    dec = FleetHost("d0", "decode", Engine(params, cfg, ec), t,
                    peers={"p0": "prefill"})
    return [pre, dec], t


class TestFleet:
    def test_streams_identical_and_roles_proven(self):
        """2-host prefill/decode fleet vs ONE unified host on ragged
        interleaved prompts: every stream identical, the decode host
        executed ZERO prefill chunks, the prefill host ran ZERO decode
        ticks, and every block is freed once the streams retire."""
        cfg = tiny_cfg()
        params = tiny_params(cfg)
        prompts, budgets = mixed_workload(cfg)
        ec = EngineConfig(slots=3, kv_block_len=8, max_prefill_chunk=4)
        base = single_host_streams(params, cfg, ec, prompts, budgets)
        hosts, t = build_2host(params, cfg, ec)
        router = Router(t)
        for i, (p, m) in enumerate(zip(prompts, budgets)):
            router.submit(Request(rid=i, prompt=p, max_new_tokens=m))
        run_fleet_until_done(hosts, len(prompts))
        assert fleet_streams(hosts) == base
        pre, dec = hosts
        assert dec.sched.prefill_chunks == 0, "role split violated"
        assert pre.sched.decode_ticks == 0, "role split violated"
        assert dec.migrate_in == len(prompts)
        assert pre.migrate_out == len(prompts)
        # blocks freed everywhere once streams retire
        assert all(h.engine.allocator.used_blocks == 0 for h in hosts)

    def test_mixed_temperature_lanes_survive_migration(self):
        """Greedy and temperature requests side by side: the fleet's
        streams (RNG lanes migrated mid-stream) equal the unified
        host's."""
        cfg = tiny_cfg()
        params = tiny_params(cfg)
        prompts, budgets = mixed_workload(cfg, n=4, seed=3)
        temps = [0.0, 0.7, 0.0, 1.1]
        ec = EngineConfig(slots=2, kv_block_len=8, max_prefill_chunk=4)
        base = single_host_streams(
            params, cfg, ec, prompts, budgets,
            temperature=temps, seed=[11 + i for i in range(4)],
        )
        hosts, t = build_2host(params, cfg, ec)
        router = Router(t)
        for i, (p, m) in enumerate(zip(prompts, budgets)):
            router.submit(Request(
                rid=i, prompt=p, max_new_tokens=m,
                temperature=temps[i], seed=11 + i,
            ))
        run_fleet_until_done(hosts, len(prompts))
        assert fleet_streams(hosts) == base

    def test_inadmissible_wire_request_rejected_not_fatal(self):
        """A routed request whose prompt + budget exceeds max_len must
        not take the host down (single-host submit raises to ITS
        caller; over the wire the caller is a peer): the host rejects
        it back to the front door with an error result and keeps
        serving everything else."""
        cfg = tiny_cfg()
        params = tiny_params(cfg)
        prompts, budgets = mixed_workload(cfg, n=3, seed=4)
        ec = EngineConfig(slots=2, kv_block_len=8, max_prefill_chunk=4)
        base = single_host_streams(params, cfg, ec, prompts, budgets)
        t = LocalTransport()
        t.register("frontdoor")
        pre = FleetHost("p0", "prefill", Engine(params, cfg, ec), t,
                        peers={"d0": "decode"}, results_to="frontdoor")
        dec = FleetHost("d0", "decode", Engine(params, cfg, ec), t,
                        peers={"p0": "prefill"}, results_to="frontdoor")
        router = Router(t)
        for i, (p, m) in enumerate(zip(prompts, budgets)):
            router.submit(Request(rid=i, prompt=p, max_new_tokens=m))
        router.submit(Request(
            rid=99, prompt=np.zeros((4,), np.int32),
            max_new_tokens=cfg.max_len,
        ))
        run_fleet_until_done([pre, dec], len(prompts))
        assert fleet_streams([pre, dec]) == base
        results = {}
        for msg in t.recv("frontdoor"):
            d = json.loads(msg.payload.decode())
            results[d["rid"]] = d
        assert "exceeds max_len" in results[99]["error"]
        assert results[99]["tokens"] == []

    def test_drain_grace_sweep_reroutes_in_flight_migrate(self):
        """A migrate message that lands in the draining host's inbox
        AFTER drain's first recv (a cross-process peer read our
        pre-tombstone status and sent — the message is the ONLY copy
        of that sequence) must be re-forwarded raw to a capable peer
        by the grace sweep, and the stream must still finish to
        parity."""
        cfg = tiny_cfg()
        params = tiny_params(cfg)
        prompts, budgets = mixed_workload(cfg, n=2, seed=7)
        ec = EngineConfig(slots=2, kv_block_len=8, max_prefill_chunk=4)
        base = single_host_streams(params, cfg, ec, prompts, budgets)

        class InFlight(LocalTransport):
            """Delivers a prepared message to d0 the moment d0's
            tombstone publishes — the tightest version of the race."""

            armed: list = []

            def publish(self, name, status):
                super().publish(name, status)
                if name == "d0" and status.get("role") == "drained":
                    while self.armed:
                        self._inbox["d0"].append(self.armed.pop())

        t = InFlight()
        topo = [("p0", "prefill"), ("d0", "decode"), ("d1", "decode")]
        hosts = [
            FleetHost(n, r, Engine(params, cfg, ec), t,
                      peers={m: s for m, s in topo if m != n})
            for n, r in topo
        ]
        p0, d0, d1 = hosts
        router = Router(t)
        for i, (p, m) in enumerate(zip(prompts, budgets)):
            router.submit(Request(rid=i, prompt=p, max_new_tokens=m))
        # tick ONLY the prefill host: both exports land in the decode
        # inboxes and stay unread — the in-flight state
        for _ in range(50):
            p0.tick()
            if p0.migrate_out == 2:
                break
        stolen = [
            m for box in (t._inbox["d0"], t._inbox["d1"])
            for m in box if m.kind == "migrate"
        ]
        for box in (t._inbox["d0"], t._inbox["d1"]):
            while box:
                box.pop()
        assert stolen, "no exported migrate in flight to steal"
        stolen_rids = {migrate.deserialize(m.payload).rid for m in stolen}
        InFlight.armed = stolen
        acct = d0.drain("test", grace_s=0.05)
        assert {m["rid"] for m in acct["migrated"]} == stolen_rids, acct
        assert all(m["dst"] == "d1" for m in acct["migrated"]), acct
        # the rerouted sequences finish on d1 to full parity
        run_fleet_until_done([p0, d1], len(prompts))
        assert fleet_streams([p0, d1]) == base

    def test_drain_to_peer_resumes_to_full_parity(self):
        """1 prefill + 2 decode hosts; one decode host's preemption
        plane fires mid-run: its decoding sequences MIGRATE to the
        surviving decode host, pending work re-enters through the
        prefill host, and every stream still equals the unified
        host's — the drained host's slots resumed on a peer."""
        cfg = tiny_cfg()
        params = tiny_params(cfg)
        prompts, budgets = mixed_workload(cfg, n=8, seed=5)
        ec = EngineConfig(slots=2, kv_block_len=8, max_prefill_chunk=4)
        base = single_host_streams(params, cfg, ec, prompts, budgets)
        t = LocalTransport()
        topo = [("p0", "prefill"), ("d0", "decode"), ("d1", "decode")]
        hosts = [
            FleetHost(n, r, Engine(params, cfg, ec), t,
                      peers={m: s for m, s in topo if m != n})
            for n, r in topo
        ]
        router = Router(t)
        for i, (p, m) in enumerate(zip(prompts, budgets)):
            router.submit(Request(rid=i, prompt=p, max_new_tokens=m))
        for _ in range(6):
            for h in hosts:
                h.tick()
        victim = hosts[1]
        acct = victim.drain("test preemption")
        assert acct["migrated"] or acct["forwarded"], \
            "nothing was in flight on the drained host?"
        assert all(
            m["dst"] == "d1" for m in acct["migrated"]
        ), "decoding sequences must migrate to the surviving decode peer"
        assert victim.engine.allocator.used_blocks == 0
        alive = [hosts[0], hosts[2]]
        idle = 0
        for _ in range(2000):
            for h in alive:
                h.tick()
            done = len(fleet_streams(hosts))
            if done >= len(prompts):
                break
            idle = idle + 1 if not any(h.busy for h in alive) else 0
            assert idle < 5, "fleet stalled after the drain"
        assert fleet_streams(hosts) == base

    def test_latent_peer_gets_no_placements_until_join(self):
        """Elastic fleet: a declared-but-unlaunched (latent) decode
        peer must receive ZERO exports — a sequence shipped to a host
        that may never start would be stranded. Every stream runs
        through the live decode host."""
        cfg = tiny_cfg()
        params = tiny_params(cfg)
        prompts, budgets = mixed_workload(cfg, n=4, seed=11)
        ec = EngineConfig(slots=3, kv_block_len=8, max_prefill_chunk=4)
        base = single_host_streams(params, cfg, ec, prompts, budgets)
        t = LocalTransport()
        peers_of = {
            "p0": {"d0": "decode", "d1": "decode"},
            "d0": {"p0": "prefill", "d1": "decode"},
        }
        p0 = FleetHost("p0", "prefill", Engine(params, cfg, ec), t,
                       peers=peers_of["p0"], latent={"d1"})
        d0 = FleetHost("d0", "decode", Engine(params, cfg, ec), t,
                       peers=peers_of["d0"], latent={"d1"})
        router = Router(t)
        for i, (p, m) in enumerate(zip(prompts, budgets)):
            router.submit(Request(rid=i, prompt=p, max_new_tokens=m))
        run_fleet_until_done([p0, d0], len(prompts))
        assert fleet_streams([p0, d0]) == base
        assert d0.migrate_in == len(prompts)  # all of it landed here
        assert p0._latent == {"d1"}  # never published, still latent

    def test_fleet_join_and_leave_streams_identical(self):
        """The elastic scale drill: a latent decode host JOINS mid-run
        (its status publish is the announce — peers log fleet_join and
        start placing onto it), then the ORIGINAL decode host LEAVES
        via drain-to-peer (tombstone -> fleet_leave, its mid-stream
        sequences migrate to the joiner) — and every token stream
        equals the fixed-topology single-host run throughout."""
        cfg = tiny_cfg()
        params = tiny_params(cfg)
        prompts, budgets = mixed_workload(cfg, n=9, seed=13)
        ec = EngineConfig(slots=2, kv_block_len=8, max_prefill_chunk=4)
        base = single_host_streams(params, cfg, ec, prompts, budgets)
        t = LocalTransport()
        topo = [("p0", "prefill"), ("d0", "decode"), ("d1", "decode")]

        def mk(name, role, latent):
            return FleetHost(
                name, role, Engine(params, cfg, ec), t,
                peers={m: r for m, r in topo if m != name},
                latent=latent - {name},
            )

        p0 = mk("p0", "prefill", {"d1"})
        d0 = mk("d0", "decode", {"d1"})
        router = Router(t)
        # phase 1: min_hosts fleet serves the first third
        for i in range(3):
            router.submit(Request(
                rid=i, prompt=prompts[i], max_new_tokens=budgets[i],
            ))
        run_fleet_until_done([p0, d0], 3)
        assert d0.migrate_in == 3 and p0._latent == {"d1"}
        # phase 2: d1 JOINS (construction registers + publishes its
        # serving status — the announce) and starts taking placements
        d1 = mk("d1", "decode", set())
        for i in range(3, 6):
            router.submit(Request(
                rid=i, prompt=prompts[i], max_new_tokens=budgets[i],
            ))
        run_fleet_until_done([p0, d0, d1], 6)
        assert p0._latent == set(), "join not observed by the prefill host"
        assert d1.migrate_in >= 1, (
            "the joined decode host took no placements"
        )
        # phase 3: scale DOWN — d0 drains mid-stream; its decoding
        # sequences migrate to the joiner, and peers re-latent it
        for i in range(6, 9):
            router.submit(Request(
                rid=i, prompt=prompts[i], max_new_tokens=budgets[i],
            ))
        for _ in range(4):
            for h in (p0, d0, d1):
                h.tick()
        acct = d0.drain("scale-down")
        assert all(m["dst"] == "d1" for m in acct["migrated"]), acct
        alive = [p0, d1]
        idle = 0
        for _ in range(2000):
            for h in alive:
                h.tick()
            if len(fleet_streams([p0, d0, d1])) >= len(prompts):
                break
            idle = idle + 1 if not any(h.busy for h in alive) else 0
            assert idle < 5, "fleet stalled after the scale-down"
        assert fleet_streams([p0, d0, d1]) == base
        # the next placement decision observes the tombstone: d0 is
        # latent again (a future status publish is a fresh join) and
        # never a candidate
        assert p0._pick_peer(("decode", "unified")) == "d1"
        assert "d0" in p0._latent, (
            "the drained host must be latent again (a future status "
            "publish is a fresh join)"
        )

    def test_decode_only_fleet_rejected(self):
        """The runtime arm netlint FLT001 mirrors: a split-role host
        with no peer for the other half refuses to construct — and a
        peer that is merely DECLARED (latent, may never launch) does
        not count as the other half."""
        cfg = tiny_cfg()
        params = tiny_params(cfg)
        ec = EngineConfig(slots=2, kv_block_len=8)
        t = LocalTransport()
        with pytest.raises(ValueError, match="no prefill-capable peer"):
            FleetHost("d0", "decode", Engine(params, cfg, ec), t,
                      peers={"d1": "decode"})
        with pytest.raises(ValueError, match="no decode-capable peer"):
            FleetHost("p0", "prefill", Engine(params, cfg, ec), t,
                      peers={"d0": "decode"}, latent={"d0"})
        with pytest.raises(ValueError, match="no decode-capable peer"):
            FleetHost("p0", "prefill", Engine(params, cfg, ec), t,
                      peers={})

    def test_prefix_cache_reuse_crosses_hosts(self):
        """Imported registered blocks serve prefix hits: after a
        migrated sequence lands, admitting the SAME prompt on the
        importer shares its blocks (zero re-prefill of the covered
        prefix) and the warm stream is bitwise the cold one. A second
        import of the same prompt SHARES the already-registered blocks
        instead of re-writing them."""
        cfg = tiny_cfg()
        params = tiny_params(cfg)
        # 16-token prompt = 2 FULL blocks at block_len 8
        prompt = np.arange(16, dtype=np.int32) % cfg.vocab
        n = 8
        ec = EngineConfig(slots=3, kv_block_len=8, max_prefill_chunk=8,
                          prefix_cache=True)
        ea = Engine(params, cfg, ec)
        ea.admit(0, len(prompt) + n, prompt=prompt)
        last = None
        for c0 in range(0, len(prompt), 8):
            last = ea.prefill_chunk(0, prompt[c0:c0 + 8], c0)
        ea.register_prefix(0, prompt)
        first = ea.activate(0, last, len(prompt), seed=0)
        req = Request(rid=0, prompt=prompt, max_new_tokens=n)
        req.tokens = [first]
        mseq = migrate.deserialize(
            migrate.serialize(migrate.export_sequence(ea, req, 0))
        )
        assert len(mseq.payload["chain"]) == 2
        eb = Engine(params, cfg, ec)
        info = migrate.import_sequence(eb, 0, mseq)
        assert info["registered"] == 2 and info["shared"] == 0
        # retire the imported stream: its registered blocks park on
        # the LRU, warm for the admissions below (the scheduler owns
        # the slots from here)
        eb.retire(0)
        # cold oracle for the same prompt (fresh uncached engine)
        cold = single_host_streams(
            params, cfg,
            EngineConfig(slots=3, kv_block_len=8, max_prefill_chunk=8),
            [prompt], [n],
        )[0]
        # admission on the importer now HITS the imported blocks
        sched = Scheduler(eb)
        sched.submit(Request(rid=1, prompt=prompt, max_new_tokens=n))
        sched.serve()
        assert sched.prefix_hits == 1 and sched.blocks_shared >= 1
        (warm,) = (r.tokens for r in sched.finished)
        assert list(warm) == cold
        # a second import of the same prompt shares, not re-scatters
        e2, req2 = self_export_engine(params, cfg, ec, prompt, n)
        info2 = migrate.import_sequence(
            eb, 2,
            migrate.deserialize(migrate.serialize(
                migrate.export_sequence(e2, req2, 0)
            )),
        )
        assert info2["shared"] == 2 and info2["registered"] == 0

    def test_speculation_composes_with_migration(self):
        """A migrated sequence keeps speculating: the decode host runs
        verify ticks (spec_k > 0), accepts drafted tokens AFTER the
        migration, and streams equal the unified host's one-token
        run."""
        cfg = tiny_cfg(max_len=64)
        params = tiny_params(cfg)
        # repeat workload: the n-gram drafter's home turf
        motif = np.asarray([7, 3, 9, 1], np.int32)
        prompts = [np.tile(motif, 3) for _ in range(4)]
        budgets = [16] * 4
        ec_plain = EngineConfig(slots=2, kv_block_len=8,
                                max_prefill_chunk=4)
        base = single_host_streams(
            params, cfg, ec_plain, prompts, budgets,
        )
        ec_spec = EngineConfig(slots=2, kv_block_len=8,
                               max_prefill_chunk=4, spec_k=3)
        hosts, t = build_2host(params, cfg, ec_spec)
        router = Router(t)
        for i, (p, m) in enumerate(zip(prompts, budgets)):
            router.submit(Request(rid=i, prompt=p, max_new_tokens=m))
        run_fleet_until_done(hosts, len(prompts))
        assert fleet_streams(hosts) == base
        dec = hosts[1]
        assert dec.sched.spec_accepted > 0, \
            "no drafts accepted post-migration"

    def test_fused_kernels_compose_with_fleet(self):
        """kernels { paged_attention: fused } on every fleet host (the
        kernel's plain version on the CPU): streams still identical to
        the unified REFERENCE host."""
        cfg = tiny_cfg()
        params = tiny_params(cfg)
        prompts, budgets = mixed_workload(cfg, n=4, seed=9)
        ec_ref = EngineConfig(slots=2, kv_block_len=8,
                              max_prefill_chunk=4)
        base = single_host_streams(params, cfg, ec_ref, prompts, budgets)
        ec_fused = EngineConfig(slots=2, kv_block_len=8,
                                max_prefill_chunk=4,
                                attend_impl="fused")
        hosts, t = build_2host(params, cfg, ec_fused)
        router = Router(t)
        for i, (p, m) in enumerate(zip(prompts, budgets)):
            router.submit(Request(rid=i, prompt=p, max_new_tokens=m))
        run_fleet_until_done(hosts, len(prompts))
        assert fleet_streams(hosts) == base

    def test_counts_past_the_warm_up_are_the_measured_run(self):
        """A warm-up request (negative rid) first: each host's counts
        from the first rid >= 0 arrival (``warm_counts``) on equal those
        of a fresh fleet that served only the measured requests, and
        the prefill host's chunks are the prompts' own."""
        cfg = tiny_cfg()
        params = tiny_params(cfg)
        prompts, budgets = mixed_workload(cfg, seed=4)
        ec = EngineConfig(slots=3, kv_block_len=8, max_prefill_chunk=4)
        measured = []
        for warm in (True, False):
            hosts, t = build_2host(params, cfg, ec)
            router = Router(t)
            if warm:
                router.submit(Request(rid=-1, prompt=prompts[0][:6],
                                      max_new_tokens=3))
                for _ in range(50):
                    for h in hosts:
                        h.tick()
                assert [r.rid for r in hosts[1].sched.finished] == [-1]
                assert all(h.warm_counts is None for h in hosts)
            for i, (p, m) in enumerate(zip(prompts, budgets)):
                router.submit(Request(rid=i, prompt=p, max_new_tokens=m))
            run_fleet_until_done(hosts, len(prompts))
            measured.append([
                {k: v - h.warm_counts[k] for k, v in h.counts().items()}
                for h in hosts])
        assert measured[0] == measured[1]
        pre, dec = measured[0]
        assert pre["prefill_chunks"] == sum(-(-len(p) // 4) for p in prompts)
        assert pre["migrate_out"] == dec["migrate_in"] == len(prompts)
        assert pre["decode_ticks"] == 0 and dec["prefill_chunks"] == 0
        assert dec["decode_ticks"] > 0


def self_export_engine(params, cfg, ec, prompt, n):
    """A throwaway exporter holding ``prompt`` fully prefilled and
    activated in slot 0. -> (engine, request)."""
    e = Engine(params, cfg, ec)
    e.admit(0, len(prompt) + n, prompt=prompt)
    last = None
    c = ec.max_prefill_chunk
    for c0 in range(0, len(prompt), c):
        last = e.prefill_chunk(0, prompt[c0:c0 + c], c0)
    e.register_prefix(0, prompt)
    first = e.activate(0, last, len(prompt), seed=0)
    req = Request(rid=99, prompt=prompt, max_new_tokens=n)
    req.tokens = [first]
    return e, req


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------


class TestRouter:
    def test_least_loaded_placement(self):
        t = LocalTransport()
        t.publish("a", {"host": "a", "role": "prefill",
                        "free_slots": 1, "kv_blocks_free": 4,
                        "queue_depth": 3})
        t.publish("b", {"host": "b", "role": "prefill",
                        "free_slots": 2, "kv_blocks_free": 8,
                        "queue_depth": 0})
        t.publish("c", {"host": "c", "role": "decode",
                        "free_slots": 8, "kv_blocks_free": 99,
                        "queue_depth": 0})
        r = Router(t)
        # b: shallowest queue among prefill-capable (c is decode-only)
        assert r.route(np.asarray([1, 2, 3], np.int32)) == "b"

    def test_boot_raises_until_status_appears(self):
        r = Router(LocalTransport())
        with pytest.raises(LookupError):
            r.route(np.asarray([1], np.int32))

    def test_prefix_affinity_routes_to_block_holder(self):
        """A prompt whose cached block-prefix lives on host H routes to
        H even when H is more loaded; an unknown prompt falls back to
        least-loaded."""
        from singa_tpu_torch.serve.kv_pool import PrefixCache

        block_len = 4
        chain = PrefixCache(block_len).chain(
            np.arange(8, dtype=np.int32)
        )
        t = LocalTransport()
        t.publish("warm", {"host": "warm", "role": "prefill",
                           "free_slots": 1, "kv_blocks_free": 2,
                           "queue_depth": 2,
                           "cached_digests": [d.hex() for d in chain]})
        t.publish("idle", {"host": "idle", "role": "prefill",
                           "free_slots": 8, "kv_blocks_free": 64,
                           "queue_depth": 0, "cached_digests": []})
        r = Router(t, block_len=block_len)
        affine = np.concatenate(
            [np.arange(8, dtype=np.int32),
             np.asarray([30, 31], np.int32)]
        )
        assert r.route(affine, rid=0) == "warm"
        assert r.affinity_hits == 1
        other = np.asarray([9, 9, 9, 9, 9], np.int32)
        assert r.route(other, rid=1) == "idle"
        assert r.routed == 2

    def test_route_events_recorded(self, tmp_path):
        from singa_tpu_torch.obs.recorder import FlightRecorder

        rec = FlightRecorder(str(tmp_path / "events"), rank=9,
                             run_id="t")
        t = LocalTransport()
        t.register("a")
        t.publish("a", {"host": "a", "role": "unified",
                        "free_slots": 1, "kv_blocks_free": 1,
                        "queue_depth": 0})
        r = Router(t, recorder=rec)
        r.submit(Request(rid=5, prompt=np.asarray([1, 2], np.int32),
                         max_new_tokens=4))
        rec.flush()
        recs = [
            json.loads(l)
            for l in open(tmp_path / "events" / "rank_9.jsonl")
        ]
        route = next(x for x in recs if x["kind"] == "route")
        assert route["data"]["rid"] == 5
        assert route["data"]["host"] == "a"
        # the request actually landed as a message
        (msg,) = t.recv("a")
        assert msg.kind == "request"


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------


class TestMailbox:
    def test_roundtrip_order_and_status(self, tmp_path):
        mb = Mailbox(str(tmp_path))
        mb.register("h")
        for i in range(5):
            mb.send("h", "request", f"m{i}".encode(), src="r")
        got = mb.recv("h")
        assert [m.payload for m in got] == [f"m{i}".encode()
                                            for i in range(5)]
        assert all(m.kind == "request" and m.src == "r" for m in got)
        assert mb.recv("h") == []  # read-and-delete
        mb.publish("h", {"host": "h", "role": "decode", "free_slots": 2})
        mb.publish("h", {"host": "h", "role": "decode", "free_slots": 1})
        assert mb.statuses()["h"]["free_slots"] == 1  # latest wins
        with pytest.raises(ValueError, match="kind"):
            mb.send("h", "bogus", b"", src="r")

    def test_torn_and_foreign_files_skipped(self, tmp_path):
        mb = Mailbox(str(tmp_path))
        mb.register("h")
        inbox = tmp_path / "h" / "inbox"
        (inbox / "zzz_foreign.msg").write_bytes(b"not json\npayload")
        mb.send("h", "shutdown", b"", src="r")
        got = mb.recv("h")
        assert len(got) == 1 and got[0].kind == "shutdown"
        # the foreign file is left in place, not deleted or fatal
        assert (inbox / "zzz_foreign.msg").exists()

    def test_fleet_runs_over_mailbox_in_process(self, tmp_path):
        """The SAME fleet wired over the filesystem transport (the
        OS-process wiring) produces the same streams — the transport
        is interchangeable by construction."""
        cfg = tiny_cfg()
        params = tiny_params(cfg)
        prompts, budgets = mixed_workload(cfg, n=4, seed=2)
        ec = EngineConfig(slots=2, kv_block_len=8, max_prefill_chunk=4)
        base = single_host_streams(params, cfg, ec, prompts, budgets)
        hosts, _ = build_2host(params, cfg, ec,
                               transport=Mailbox(str(tmp_path)))
        router = Router(Mailbox(str(tmp_path)))
        for i, (p, m) in enumerate(zip(prompts, budgets)):
            router.submit(Request(rid=i, prompt=p, max_new_tokens=m))
        run_fleet_until_done(hosts, len(prompts))
        assert fleet_streams(hosts) == base


# ---------------------------------------------------------------------------
# conf block, role-by-rank, lint
# ---------------------------------------------------------------------------


FLEET_CONF = """
name: "fleet-test"
neuralnet {
  layer { name: "embed" type: "kEmbedding"
    embedding_param { vocab_size: 32 embedding_dim: 32 max_len: 32 } }
  layer { name: "attn" type: "kAttention" srclayers: "embed"
    attention_param { num_heads: 2 } }
}
serving { slots: 2 kv_block_len: 8 max_prefill_chunk: 4 }
fleet { role: "auto" prefill_hosts: 1 }
"""


class TestFleetConf:
    def test_role_for_rank_and_topology(self):
        from singa_tpu_torch.config import parse_model_config

        cfg = parse_model_config(FLEET_CONF)
        fleet = cfg.fleet
        assert role_for_rank(fleet, 0) == "prefill"
        assert role_for_rank(fleet, 1) == "decode"
        assert fleet_topology(fleet, 3) == [
            ("host0", "prefill"), ("host1", "decode"),
            ("host2", "decode"),
        ]
        explicit = parse_model_config(FLEET_CONF.replace(
            'fleet { role: "auto" prefill_hosts: 1 }',
            'fleet { peers { name: "pf" role: "prefill" }\n'
            '        peers { name: "dc" role: "decode" } }',
        ))
        assert fleet_topology(explicit.fleet, 99) == [
            ("pf", "prefill"), ("dc", "decode"),
        ]


# ---------------------------------------------------------------------------
# serve_bench's fleet, drain and rollout arms
# ---------------------------------------------------------------------------


SMALL_BENCH = ["--device", "cpu", "--d_model", "32", "--n_heads", "2",
               "--d_ff", "64", "--vocab", "32", "--max_len", "64",
               "--requests", "6", "--max_new", "8", "--prompt_len", "8",
               "--block_len", "8", "--prefill_chunk", "4",
               "--concurrency", "2", "--no_gate"]


@pytest.mark.parametrize("extra,rc,check", [
    (["--fleet"], 0, {"token_mismatches": 0, "pass": True}),
    (["--fleet", "--transport", "mailbox"], 0, {"token_mismatches": 0}),
    (["--fleet", "--transport", "socket", "--wire_faults",
      "wire_dup@2,wire_delay@3:ms=20"], 0,
     {"token_mismatches": 0, "pass": True}),
    (["--fleet", "--fleet_hosts", "prefill,decode,decode",
      "--sigterm_host", "decode0", "--sigterm_at_tick", "6"], 75,
     {"token_mismatches": 0, "drained": True}),
    (["--fleet", "--arrival", "poisson", "--rate", "200"], 0,
     {"token_mismatches": 0}),
    (["--rollout", "promote", "--fleet_hosts", "unified,unified"], 0,
     {"verdict": "promoted", "hung": 0, "pre_flip_mismatches": 0,
      "pass": True}),
    (["--rollout", "parity_fail"], 0,
     {"verdict": "rollback", "hung": 0, "pass": True}),
    (["--sigterm_at_tick", "4"], 75, {"drained": True}),
    (["--arrival", "poisson", "--rate", "200"], 0, {"token_mismatches": 0}),
    (["--fleet", "--workload", "shared_prefix", "--prompt_len", "24",
      "--prefill_chunk", "8"], 0,
     {"token_mismatches": 0, "cache_fetch_timeouts": 0, "pass": True}),
])
def test_serve_bench_fleet_drain_and_rollout_arms(capsys, extra, rc, check):
    """serve_bench's --fleet (local, mailbox, socket with wire faults,
    the drain drill, poisson arrivals, the fleet prefix cache's
    shared_prefix drill), --rollout and single-engine drain arms at a
    tiny width: streams identical to the unified engine's (cold
    admission's for shared_prefix), the documented verdicts and exit
    codes."""
    from singa_tpu_torch.tools import serve_bench

    assert serve_bench.main(SMALL_BENCH + extra) == rc
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k, v in check.items():
        assert out[k] == v, (k, out)
    if "--wire_faults" in extra:
        assert out["wire"]["redeliveries"] >= 1
        assert out["wire"]["timeouts"] == 0
    if "shared_prefix" in extra:
        assert out["blocks_shipped"] >= 1 and out["cache_fetches"] >= 1
    elif extra[:1] == ["--fleet"] and "--sigterm_at_tick" not in extra:
        assert out["hosts"]["decode0"]["prefill_chunks"] == 0
