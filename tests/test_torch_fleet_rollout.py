"""The port's live weight rollout and fleet-wide prefix cache on the CPU:
the engine's dual-version params, the weight codec, the rollout drills
(promote, canary parity rollback, torn_weights quarantine, swap_die
pause, streams straddling the flip), version skew, the serving restore
of an npz save, and cross-host ``cache_fetch``/``cache_ship``. These are
``tests/test_rollout.py``'s and ``tests/test_fleet_prefix.py``'s cases,
case for case where one applies, over the port's Engine, FleetHost and
RolloutController. The sharded restore is
tests/test_torch_sharded_ckpt.py's; a directory that is no sharded save
raises by name here.

Tolerance: streams are identical to the oracle engine's, token for
token; restored and shipped arrays are bitwise.
"""

import functools
import io
import json
import os
import time
import zlib

import numpy as np
import pytest
import torch

from singa_tpu_torch.models.transformer import TransformerConfig, init_lm
from singa_tpu_torch.resilience.faults import FaultPlan, InjectedCrash
from singa_tpu_torch.resilience.reshard import (
    ReshardError,
    load_serving_params,
)
from singa_tpu_torch.serve import EngineConfig, Request, Scheduler
from singa_tpu_torch.serve import Engine as _Engine
from singa_tpu_torch.serve.fleet import (
    FleetHost,
    LocalTransport,
    Router,
    migrate,
)
from singa_tpu_torch.serve.rollout import (
    PROBE_SEED,
    RolloutController,
    probe_prompts,
)
from singa_tpu_torch.trainer.checkpoint import save_checkpoint

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


def mixed_workload(cfg, n=4, seed=0):
    rs = np.random.RandomState(seed)
    prompts = [
        rs.randint(0, cfg.vocab, size=(int(rs.randint(3, 9)),)).astype(
            np.int32
        )
        for _ in range(n)
    ]
    budgets = [int(rs.randint(4, 10)) for _ in range(n)]
    return prompts, budgets


def oracle_streams(params, cfg, ec, prompts, budgets, rid_base=0):
    eng = Engine(params, cfg, ec)
    sched = Scheduler(eng)
    for i, (p, m) in enumerate(zip(prompts, budgets)):
        sched.submit(Request(rid=rid_base + i, prompt=p,
                             max_new_tokens=m))
    sched.serve()
    return {r.rid: list(r.tokens) for r in sched.finished}


def fleet_streams(hosts, rid_min=0):
    return {
        r.rid: list(r.tokens)
        for h in hosts
        for r in h.sched.finished
        if r.rid >= rid_min
    }


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


class _Recorder:
    """Event sink with the recorder's .event() shape."""

    def __init__(self):
        self.events = []

    def event(self, kind, **payload):
        self.events.append((kind, payload))

    def record_span(self, *a, **kw):
        pass

    def kinds(self):
        return [k for k, _ in self.events]

    def of(self, kind):
        return [p for k, p in self.events if k == kind]


class FleetPump:
    """The controller's tick callable for in-process drills: tick every
    live host, tombstone one that dies mid-tick (the swap_die drill)."""

    def __init__(self, hosts):
        self.live = list(hosts)
        self.crashed = []

    def __call__(self):
        for h in list(self.live):
            try:
                h.tick()
            except InjectedCrash:
                self.live.remove(h)
                self.crashed.append(h)


def rollout_ec(**kw):
    base = dict(slots=4, kv_block_len=8, kv_blocks=64,
                max_prefill_chunk=4, prefix_cache=True, prefix_lru=True)
    base.update(kw)
    return EngineConfig(**base)


def build_unified2(params, cfg, ec, recorders=None, fault_plans=None):
    t = LocalTransport()
    names = ["u0", "u1"]
    hosts = [
        FleetHost(
            name, "unified", Engine(params, cfg, ec), t,
            peers={n: "unified" for n in names if n != name},
            recorder=(recorders or {}).get(name),
            fault_plan=(fault_plans or {}).get(name),
        )
        for name in names
    ]
    return hosts, t


# ---------------------------------------------------------------------------
# the engine's dual-version param slots
# ---------------------------------------------------------------------------


class TestEngineDualVersion:
    def test_stage_validate_flip_rollback(self):
        cfg = tiny_cfg()
        eng = Engine(tiny_params(cfg), cfg,
                     EngineConfig(slots=2, kv_block_len=8))
        nxt = tiny_params(cfg, seed=1)
        # validation: the staged tree must be hostable by the LIVE one
        with pytest.raises(ValueError, match="already live"):
            eng.stage_params(nxt, 0)
        broken = dict(nxt)
        dropped = sorted(broken)[0]
        del broken[dropped]
        with pytest.raises(ValueError, match="mismatch"):
            eng.stage_params(broken, 1)
        reshaped = dict(nxt)
        reshaped[dropped] = np.zeros((3, 3), np.float32)
        with pytest.raises(ValueError, match="shape"):
            eng.stage_params(reshaped, 1)
        with pytest.raises(ValueError, match="nothing staged"):
            eng.flip_params()
        # the lifecycle: stage -> flip -> rollback
        nbytes = eng.stage_params(nxt, 1)
        assert nbytes == sum(
            np.asarray(v).nbytes for v in nxt.values()
        )
        assert eng.staged_version == 1 and eng.params_version == 0
        res = eng.flip_params()
        assert res["version"] == 1 and res["prev_version"] == 0
        assert eng.params_version == 1 and eng.staged_version is None
        res = eng.rollback_params()
        assert res["version"] == 0 and res["aborted_version"] == 1
        assert eng.params_version == 0
        with pytest.raises(ValueError, match="no previous"):
            eng.rollback_params()
        # unstage drops a quarantined version without touching live
        eng.stage_params(nxt, 2)
        eng.unstage()
        assert eng.staged_version is None
        with pytest.raises(ValueError, match="nothing staged"):
            eng.flip_params()

    def test_flip_purges_cache_and_frees_lru_blocks(self):
        cfg = tiny_cfg()
        params = tiny_params(cfg)
        ec = rollout_ec(slots=2)
        eng = Engine(params, cfg, ec)
        sched = Scheduler(eng)
        prompt = np.arange(16, dtype=np.int32) % cfg.vocab
        sched.submit(Request(rid=0, prompt=prompt, max_new_tokens=4))
        sched.serve()
        alloc = eng.allocator
        assert len(alloc.cache) > 0 and alloc.cached_blocks > 0
        free_before = alloc.free_blocks
        eng.stage_params(tiny_params(cfg, seed=1), 1)
        res = eng.flip_params()
        # the whole index dropped, every LRU-parked block handed back
        # to the truly-free list — cached KV is a function of the
        # weights — and no block leaked in the move
        assert res["purged_blocks"] > 0
        assert len(alloc.cache) == 0 and alloc.cached_blocks == 0
        assert alloc.free_blocks == free_before

    def test_stale_slot_never_registers_post_flip(self):
        """A slot admitted under v0 whose prompt completes AFTER the
        flip must not index its blocks: its bytes were prefilled under
        replaced weights."""
        cfg = tiny_cfg()
        eng = Engine(tiny_params(cfg), cfg,
                     rollout_ec(slots=1, max_prefill_chunk=4))
        sched = Scheduler(eng)
        prompt = np.arange(16, dtype=np.int32) % cfg.vocab
        sched.submit(Request(rid=0, prompt=prompt, max_new_tokens=4))
        sched.tick()  # one prefill chunk under v0
        eng.stage_params(tiny_params(cfg, seed=1), 1)
        eng.flip_params()
        while sched.busy:
            sched.tick()
        assert len(sched.finished) == 1  # the stream rode through
        assert len(eng.allocator.cache) == 0


# ---------------------------------------------------------------------------
# the weights codec (one bulk weight_ship frame, CRC-guarded)
# ---------------------------------------------------------------------------


class TestWeightsCodec:
    def test_roundtrip_bitwise(self):
        cfg = tiny_cfg()
        params = tiny_params(cfg)
        frame = migrate.serialize_weights(7, params)
        version, tree = migrate.deserialize_weights(frame)
        assert version == 7
        assert sorted(tree) == sorted(params)
        for name, arr in params.items():
            want = np.asarray(arr)
            np.testing.assert_array_equal(tree[name], want)
            assert tree[name].dtype == want.dtype

    def test_torn_and_foreign_frames_rejected(self):
        frame = migrate.serialize_weights(
            1, {"w": np.arange(8, dtype=np.float32)}
        )
        # a truncated ship dies at deserialize, whatever layer notices
        with pytest.raises(Exception):
            migrate.deserialize_weights(frame[: len(frame) // 2])

        def reframe(mutate):
            with np.load(io.BytesIO(frame)) as z:
                arrays = {f: np.array(z[f]) for f in z.files}
            meta = json.loads(bytes(arrays["meta"]).decode("utf-8"))
            mutate(meta, arrays)
            arrays["meta"] = np.frombuffer(
                json.dumps(meta).encode("utf-8"), dtype=np.uint8
            )
            buf = io.BytesIO()
            np.savez(buf, **arrays)
            return buf.getvalue()

        # a bit-flipped artifact: the application-level CRC rejects it
        def flip_payload(meta, arrays):
            arrays["w0000"] = arrays["w0000"] + 1.0

        with pytest.raises(ValueError, match="torn weight"):
            migrate.deserialize_weights(reframe(flip_payload))

        # a foreign format is rejected before any staging
        def foreign(meta, arrays):
            meta["format"] = "someone-elses-weights"

        with pytest.raises(ValueError, match="format"):
            migrate.deserialize_weights(reframe(foreign))

    def test_crc_is_chained_over_arrays(self):
        a = {"a": np.arange(4, dtype=np.int32),
             "b": np.arange(4, 8, dtype=np.int32)}
        frame = migrate.serialize_weights(2, a)
        with np.load(io.BytesIO(frame)) as z:
            meta = json.loads(bytes(z["meta"]).decode("utf-8"))
        crc = 0
        for name in sorted(a):
            crc = zlib.crc32(
                np.ascontiguousarray(a[name]).tobytes(), crc
            )
        assert meta["crc32"] == crc & 0xFFFFFFFF
        assert meta["names"] == ["a", "b"]


# ---------------------------------------------------------------------------
# in-process drills: the lifecycle and every fault verdict
# ---------------------------------------------------------------------------


class TestRolloutDrills:
    def _drill(self, *, force_parity_fail=False, fault_plans=None,
               stage_timeout_s=20.0, ship_retries=2, next_seed=1):
        cfg = tiny_cfg()
        params = tiny_params(cfg)
        ec = rollout_ec()
        prompts, budgets = mixed_workload(cfg, n=4, seed=3)
        recs = {"u0": _Recorder(), "u1": _Recorder()}
        hosts, t = build_unified2(params, cfg, ec, recorders=recs,
                                  fault_plans=fault_plans)
        router = Router(t)
        for i, (p, m) in enumerate(zip(prompts, budgets)):
            router.submit(Request(rid=i, prompt=p, max_new_tokens=m))
        run_fleet_until_done(hosts, len(prompts))
        base = oracle_streams(params, cfg, ec, prompts, budgets)
        # flip identity, first half: everything retired pre-flip is
        # bitwise the oracle (nothing has flipped yet)
        assert fleet_streams(hosts) == base
        pump = FleetPump(hosts)
        ctl_rec = _Recorder()
        next_params = tiny_params(cfg, seed=next_seed)
        ctl = RolloutController(
            t, {"u0": "unified", "u1": "unified"},
            params=next_params, version=1, cfg=cfg, serving=ec,
            probes=2, probe_tokens=4, stage_timeout_s=stage_timeout_s,
            ship_retries=ship_retries, recorder=ctl_rec,
            force_parity_fail=force_parity_fail, tick=pump, device="cpu",
        )
        res = ctl.run()
        return dict(
            cfg=cfg, params=params, ec=ec, hosts=hosts, t=t,
            router=router, prompts=prompts, budgets=budgets,
            base=base, pump=pump, res=res, recs=recs,
            ctl_rec=ctl_rec, next_params=next_params,
        )

    def _serve_more(self, d, params_for_oracle, rid_base=100):
        """Post-verdict traffic: the fleet must still serve, and the
        streams must match the oracle for whichever weights WON."""
        prompts, budgets = mixed_workload(d["cfg"], n=3, seed=9)
        for i, (p, m) in enumerate(zip(prompts, budgets)):
            d["router"].submit(Request(rid=rid_base + i, prompt=p,
                                       max_new_tokens=m))
        run_fleet_until_done(
            d["pump"].live, len(d["prompts"]) + len(prompts)
        )
        got = fleet_streams(d["hosts"], rid_min=rid_base)
        want = oracle_streams(params_for_oracle, d["cfg"], d["ec"],
                              prompts, budgets, rid_base=rid_base)
        assert got == want

    def test_promote_end_to_end(self):
        d = self._drill()
        res = d["res"]
        assert res["verdict"] == "promoted", res
        assert sorted(res["flipped"]) == ["u0", "u1"]
        assert res["rollbacks"] == 0 and res["torn_ships"] == 0
        for h in d["hosts"]:
            assert h.engine.params_version == 1
            assert h.engine.staged_version is None
        # every host staged then flipped, and recorded it
        for name, rec in d["recs"].items():
            ships = rec.of("weight_ship")
            assert [s["ok"] for s in ships] == [True], name
            assert ships[0]["dir"] == "in"
            stages = rec.of("rollout_stage")
            assert stages and stages[0]["ok"] \
                and stages[0]["staged_bytes"] > 0
            flips = rec.of("rollout_flip")
            assert len(flips) == 1 and flips[0]["version"] == 1 \
                and flips[0]["prev_version"] == 0
        canary = d["ctl_rec"].of("rollout_canary")
        assert canary == [{"host": "u0", "version": 1, "parity": True,
                           "probes": 2}]
        done = d["ctl_rec"].of("rollout_done")
        assert done[-1]["verdict"] == "promoted"
        assert not d["ctl_rec"].of("rollout_abort")
        # the fleet now speaks v1: statuses say so, and new streams
        # are bitwise the NEXT weights' oracle
        self._serve_more(d, d["next_params"])
        assert d["router"].versions() == {"u0": 1, "u1": 1}
        # no probe ever leaks into the client-visible stream set
        assert all(rid >= 0 for rid in fleet_streams(d["hosts"]))

    def test_canary_parity_mismatch_rolls_back(self):
        d = self._drill(force_parity_fail=True)
        res = d["res"]
        assert res["verdict"] == "rollback", res
        # only the canary ever flipped; it was restored
        assert res["flipped"] == [] and res["rollbacks"] == 1
        for h in d["hosts"]:
            assert h.engine.params_version == 0
            assert h.engine.staged_version is None
        aborts = d["ctl_rec"].of("rollout_abort")
        assert len(aborts) == 1 and aborts[0]["reason"] == "parity"
        canary = d["ctl_rec"].of("rollout_canary")
        assert canary[-1]["parity"] is False
        # the canary recorded flip + rollback at tick boundaries
        flips = d["recs"]["u0"].of("rollout_flip")
        assert [f.get("rollback", False) for f in flips] == [
            False, True,
        ]
        assert flips[1]["aborted_version"] == 1
        # u1 never flipped (its staged copy was dropped)
        assert d["recs"]["u1"].of("rollout_flip") == []
        # zero dropped, zero hung: the fleet keeps serving CURRENT
        self._serve_more(d, d["params"])

    def test_torn_weights_quarantines_after_retries(self):
        """torn_weights@1..3 on the second host: every ship tears, the
        CRC rejects each one, retries exhaust -> ``quarantined``; the
        already-flipped canary rolls back and v0 keeps serving."""
        plan = FaultPlan.parse(
            "torn_weights@1,torn_weights@2,torn_weights@3"
        )
        d = self._drill(fault_plans={"u1": plan}, ship_retries=2)
        res = d["res"]
        assert res["verdict"] == "quarantined", res
        assert res["torn_ships"] == 3
        assert res["rollbacks"] == 1 and res["flipped"] == []
        for h in d["hosts"]:
            assert h.engine.params_version == 0
        # the torn frames were rejected at the CRC, loudly
        torn = d["recs"]["u1"].of("weight_ship")
        assert len(torn) == 3 and not any(s["ok"] for s in torn)
        aborts = d["ctl_rec"].of("rollout_abort")
        assert len(aborts) == 1 and aborts[0]["reason"] == "torn"
        done = d["ctl_rec"].of("rollout_done")
        assert done[-1]["verdict"] == "quarantined" \
            and done[-1]["torn_ships"] == 3
        self._serve_more(d, d["params"])

    def test_swap_die_pauses_rollout(self):
        """swap_die@1 on the second host: it dies mid-stage, the
        controller's stage-ack window expires -> ``paused``; the
        flipped canary STAYS flipped (the skew guards are what make
        the frozen mixed fleet safe)."""
        plan = FaultPlan.parse("swap_die@1")
        d = self._drill(fault_plans={"u1": plan}, stage_timeout_s=2.0)
        res = d["res"]
        assert res["verdict"] == "paused", res
        assert res["flipped"] == ["u0"]
        assert [h.name for h in d["pump"].crashed] == ["u1"]
        # the canary is serving the NEW version; the dead host froze
        # at the OLD one — a documented mixed-version fleet
        u0, u1 = d["hosts"]
        assert u0.engine.params_version == 1
        assert u1.engine.params_version == 0
        aborts = d["ctl_rec"].of("rollout_abort")
        assert len(aborts) == 1 and aborts[0]["reason"] == "paused"
        # pre-flip streams are intact — nothing dropped
        assert fleet_streams(d["hosts"]) == d["base"]

    def test_streams_straddling_the_flip_never_hang(self):
        """Requests admitted BEFORE the rollout and finished AFTER it:
        in-flight slots ride through the flip on their already-written
        KV — zero drops, zero hangs, and their count is exact."""
        cfg = tiny_cfg()
        params = tiny_params(cfg)
        ec = rollout_ec()
        prompts, budgets = mixed_workload(cfg, n=4, seed=5)
        hosts, t = build_unified2(params, cfg, ec)
        router = Router(t)
        for i, (p, m) in enumerate(zip(prompts, budgets)):
            router.submit(Request(rid=i, prompt=p,
                                  max_new_tokens=max(m, 8)))
        for _ in range(3):  # a few ticks: admitted, not finished
            for h in hosts:
                h.tick()
        pump = FleetPump(hosts)
        ctl = RolloutController(
            t, {"u0": "unified", "u1": "unified"},
            params=tiny_params(cfg, seed=1), version=1, cfg=cfg,
            serving=ec, probes=2, probe_tokens=4,
            stage_timeout_s=20.0, tick=pump, device="cpu",
        )
        res = ctl.run()
        assert res["verdict"] == "promoted"
        run_fleet_until_done(hosts, len(prompts))
        got = fleet_streams(hosts)
        assert sorted(got) == list(range(len(prompts)))
        assert all(len(toks) > 0 for toks in got.values())


# ---------------------------------------------------------------------------
# version skew: the mixed-version fleet is safe by construction
# ---------------------------------------------------------------------------


class TestVersionSkew:
    def test_skew_migrate_degrades_to_cold_prefill_bitwise(self):
        """Prefill host at v0, decode host flipped to v1 (same weight
        VALUES, so token parity is decidable): every migrated frame is
        version-skewed, the decode host re-prefills cold — and the
        streams are still bitwise the oracle. migrate_in events carry
        the skew verdict; the decode host provably ran prefill."""
        cfg = tiny_cfg()
        params = tiny_params(cfg)
        ec = EngineConfig(slots=3, kv_block_len=8, max_prefill_chunk=4)
        prompts, budgets = mixed_workload(cfg, n=4, seed=2)
        base = oracle_streams(params, cfg, ec, prompts, budgets)
        t = LocalTransport()
        rec = _Recorder()
        pre = FleetHost("p0", "prefill", Engine(params, cfg, ec), t,
                        peers={"d0": "decode"})
        dec = FleetHost("d0", "decode", Engine(params, cfg, ec), t,
                        peers={"p0": "prefill"}, recorder=rec)
        dec.engine.stage_params(
            {k: np.asarray(v) for k, v in params.items()}, 1
        )
        dec.engine.flip_params()
        router = Router(t)
        for i, (p, m) in enumerate(zip(prompts, budgets)):
            router.submit(Request(rid=i, prompt=p, max_new_tokens=m))
        run_fleet_until_done([pre, dec], len(prompts))
        assert fleet_streams([pre, dec]) == base
        skews = [e for e in rec.of("migrate_in") if e.get("skew")]
        assert len(skews) == len(prompts)
        assert all(
            e["frame_version"] == 0 and e["live_version"] == 1
            and e["slot"] == -1 and e["blocks"] == 0
            for e in skews
        )
        # the degrade IS a cold prefill on the decode host
        assert dec.sched.prefill_chunks > 0
        assert pre.engine.params_version == 0
        assert dec.engine.params_version == 1

    def test_skew_cache_fetch_answered_with_empty_ship(self):
        """A cache_fetch tagged v0 against a host flipped to v1 gets
        the EXISTING empty-ship answer — the requester degrades to
        plain prefill instead of installing cross-version bytes."""
        cfg = tiny_cfg()
        params = tiny_params(cfg)
        ec = rollout_ec(slots=2)
        t = LocalTransport()
        rec = _Recorder()
        host = FleetHost("u0", "unified", Engine(params, cfg, ec), t,
                         peers={}, recorder=rec)
        # warm the cache under v0, then flip to v1 with the same values
        sched = host.sched
        prompt = np.arange(16, dtype=np.int32) % cfg.vocab
        sched.submit(Request(rid=0, prompt=prompt, max_new_tokens=4))
        while sched.busy:
            host.tick()
        chain = host.engine.allocator.cache.chain(prompt)
        host.engine.stage_params(
            {k: np.asarray(v) for k, v in params.items()}, 1
        )
        host.engine.flip_params()
        t.register("probe")
        t.send("u0", "cache_fetch",
               migrate.serialize_fetch(7, chain, version=0),
               src="probe")
        host.tick()
        ships = [m for m in t.recv("probe") if m.kind == "cache_ship"]
        assert len(ships) == 1
        ship = migrate.deserialize_ship(ships[0].payload)
        assert ship["chain"] == [] and ship["version"] == 1
        skew = [e for e in rec.of("cache_fetch") if e.get("skew")]
        assert len(skew) == 1 and skew[0]["dir"] == "serve"
        assert skew[0]["frame_version"] == 0
        assert skew[0]["live_version"] == 1

    def test_fetch_and_ship_frames_carry_version_tags(self):
        chain = [b"\x01" * 16, b"\x02" * 16]
        rid, got_chain, version = migrate.deserialize_fetch(
            migrate.serialize_fetch(3, chain, version=5)
        )
        assert (rid, got_chain, version) == (3, chain, 5)
        # pre-rollout senders (no explicit tag) read as version 0
        _, _, version = migrate.deserialize_fetch(
            migrate.serialize_fetch(3, chain)
        )
        assert version == 0
        k = np.zeros((2, 1, 2, 8, 8), np.float32)
        ship = migrate.deserialize_ship(
            migrate.serialize_ship(3, chain[:1], k, k, version=5)
        )
        assert ship["version"] == 5
        ship = migrate.deserialize_ship(
            migrate.serialize_ship(3, chain[:1], k, k)
        )
        assert ship["version"] == 0


# ---------------------------------------------------------------------------



class TestLoadServingParams:
    def test_npz_overlay_and_shape_reject(self, tmp_path):
        cfg = tiny_cfg()
        init = tiny_params(cfg)
        name = sorted(init)[0]
        trained = {name: np.asarray(init[name]) + 1.0}
        path = str(tmp_path / "step_5.npz")
        save_checkpoint(path, 5, trained)
        out, info = load_serving_params(path, init)
        np.testing.assert_array_equal(
            np.asarray(out[name]), trained[name]
        )
        # absent names keep their init values
        other = sorted(init)[1]
        np.testing.assert_array_equal(
            np.asarray(out[other]), np.asarray(init[other])
        )
        assert info["format"] == "npz" and info["step"] == 5
        assert info["restored"] == 1 and info["resharded"] == 0
        # a shape mismatch is a loud reject, never a silent boot
        bad = str(tmp_path / "step_6.npz")
        save_checkpoint(bad, 6, {name: np.zeros((3, 3), np.float32)})
        with pytest.raises((ReshardError, ValueError), match="shape"):
            load_serving_params(bad, init)

    def test_retention_folder_resolves_latest(self, tmp_path):
        cfg = tiny_cfg()
        init = tiny_params(cfg)
        name = sorted(init)[0]
        folder = str(tmp_path)
        save_checkpoint(os.path.join(folder, "step_2.npz"), 2,
                        {name: np.asarray(init[name]) + 1.0})
        newest = os.path.join(folder, "step_4.npz")
        save_checkpoint(newest, 4, {name: np.asarray(init[name]) + 2.0})
        # a newer torn save that LATEST does not name is skipped
        with open(os.path.join(folder, "step_6.npz"), "wb") as f:
            f.write(b"torn")
        with open(os.path.join(folder, "LATEST"), "w") as f:
            f.write("step_4.npz\n")
        out, info = load_serving_params(folder, init)
        assert info["step"] == 4
        np.testing.assert_array_equal(
            np.asarray(out[name]), np.asarray(init[name]) + 2.0
        )
        empty = str(tmp_path / "nothing")
        os.makedirs(empty)
        with pytest.raises(ReshardError, match="no complete save"):
            load_serving_params(empty, init)

    def test_sharded_save_raises_by_name(self, tmp_path):
        """A directory whose manifest is not the sharded format's raises,
        naming the format, instead of booting on init weights (a sharded
        save restores: tests/test_torch_sharded_ckpt.py)."""
        path = tmp_path / "step_3.ckpt"
        path.mkdir()
        (path / "manifest.json").write_text("{}")
        with pytest.raises(ValueError,
                           match="not a singa-tpu sharded checkpoint"):
            load_serving_params(str(path), tiny_params(tiny_cfg()))



# ---------------------------------------------------------------------------
# probe determinism
# ---------------------------------------------------------------------------


def test_probe_prompts_deterministic_and_windowed():
    cfg = tiny_cfg()
    a = probe_prompts(cfg, 3, probe_tokens=8)
    b = probe_prompts(cfg, 3, probe_tokens=8)
    assert len(a) == 3
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == np.int32
        assert 1 <= len(x) <= cfg.max_len - 8 - 1
        assert np.all((x >= 1) & (x < cfg.vocab))
    # a tight window still yields admissible prompts
    tight = probe_prompts(tiny_cfg(max_len=8), 2, probe_tokens=6)
    assert all(len(p) == 1 for p in tight)
    assert PROBE_SEED == 0x5EED


# ---------------------------------------------------------------------------
# fleet-wide prefix cache: cross-host cache_fetch / cache_ship
# ---------------------------------------------------------------------------


class _PrefixRecorder:
    """Event sink with the recorder's .event() shape."""

    def __init__(self):
        self.events = []

    def event(self, kind, **payload):
        self.events.append((kind, payload))

    def record_span(self, *a, **kw):
        pass


def serve_seq(engine, prompts, budgets, *, slots_serial=True,
              recorder=None):
    """Serve with slots=1 semantics (FIFO, retire-before-admit) so
    every request sees the previous ones' registered blocks."""
    sched = Scheduler(engine, recorder=recorder)
    for i, (p, m) in enumerate(zip(prompts, budgets)):
        sched.submit(Request(rid=i, prompt=np.asarray(p, np.int32),
                             max_new_tokens=m))
    sched.serve()
    return sched


def streams(sched):
    return {r.rid: list(r.tokens) for r in sched.finished}


def build_unified_pair(params, cfg, ec0, ec1=None):
    t = LocalTransport()
    h0 = FleetHost("h0", "unified", Engine(params, cfg, ec0), t,
                   peers={"h1": "unified"})
    h1 = FleetHost("h1", "unified", Engine(params, cfg, ec1 or ec0), t,
                   peers={"h0": "unified"})
    return h0, h1, t


def drive(hosts, n_done, max_rounds=3000):
    idle = 0
    for _ in range(max_rounds):
        for h in hosts:
            h.tick()
        done = sum(
            1 for h in hosts for r in h.sched.finished if r.rid >= 0
        )
        if done >= n_done:
            return
        idle = idle + 1 if not any(h.busy for h in hosts) else 0
        assert idle < 5, "fleet stalled with requests unfinished"
    raise AssertionError("fleet did not finish in the round budget")


# ---------------------------------------------------------------------------
# partial-tail sharing: COW-extend identity sweep
# ---------------------------------------------------------------------------



FLEET_EC = dict(slots=2, kv_block_len=8, max_prefill_chunk=8,
                prefix_cache=True)


def test_cross_host_ship_bitwise_vs_local_hit():
    """A host that has never seen the prompt fetches its peer's
    blocks over the wire and streams BITWISE what a local hit (and a
    cold engine) produces — the tentpole identity bar."""
    cfg = tiny_cfg()
    params = tiny_params(cfg)
    prompt = (np.arange(22, dtype=np.int32) * 5) % cfg.vocab
    n = 6
    h0, h1, _ = build_unified_pair(params, cfg, EngineConfig(**FLEET_EC))
    # warm h1 only; h0 sees the prompt first through the ship
    h1.submit(Request(rid=0, prompt=prompt, max_new_tokens=n))
    drive([h0, h1], 1)
    assert h1.engine.allocator.cache.match(prompt), "h1 must be warm"
    h0.submit(Request(rid=1, prompt=prompt, max_new_tokens=n))
    drive([h0, h1], 2)
    assert h0.cache_fetches == 1
    assert h0.cache_ships_in == 1 and h1.cache_ships_out == 1
    assert h0.ship_blocks_in == 2 == h1.ship_blocks_out
    assert h0.ship_bytes_in == h1.ship_bytes_out > 0
    assert h0.cache_fetch_timeouts == 0
    assert h0.sched.prefix_hits == 1, "installed blocks must serve the hit"
    shipped = next(r for r in h0.sched.finished if r.rid == 1)
    warm_peer = next(r for r in h1.sched.finished if r.rid == 0)

    # oracles: a local hit on a third engine, and a cold engine
    local = Engine(params, cfg, EngineConfig(**FLEET_EC))
    warm_local = serve_seq(local, [prompt, prompt], [n, n])
    cold = serve_seq(
        Engine(params, cfg, EngineConfig(
            **{**FLEET_EC, "prefix_cache": False}
        )),
        [prompt], [n],
    )
    want = streams(cold)[0]
    assert list(shipped.tokens) == want
    assert list(warm_peer.tokens) == want
    assert streams(warm_local)[0] == streams(warm_local)[1] == want


def test_fetch_timeout_degrades_to_plain_prefill():
    """A peer that advertises digests but never answers: the held
    request degrades to plain prefill at the deadline — correct
    stream, counted timeout, no ship, no hang."""
    cfg = tiny_cfg()
    params = tiny_params(cfg)
    prompt = (np.arange(20, dtype=np.int32) * 3) % cfg.vocab
    n = 5
    ec_fast = EngineConfig(**FLEET_EC, prefix_fetch_timeout_s=0.02)
    h0, h1, _ = build_unified_pair(
        params, cfg, ec_fast, EngineConfig(**FLEET_EC)
    )
    h1.submit(Request(rid=0, prompt=prompt, max_new_tokens=n))
    drive([h0, h1], 1)  # h1 warm, status (digests) published
    h0.submit(Request(rid=1, prompt=prompt, max_new_tokens=n))
    # tick ONLY h0: the fetch goes out but nothing ever answers
    deadline = time.monotonic() + 10.0
    while not any(r.rid == 1 for r in h0.sched.finished):
        assert time.monotonic() < deadline, "degrade path hung"
        h0.tick()
        time.sleep(0.005)
    assert h0.cache_fetches == 1
    assert h0.cache_fetch_timeouts == 1
    assert h0.cache_ships_in == 0 and h0.sched.prefix_hits == 0
    cold = serve_seq(
        Engine(params, cfg, EngineConfig(
            **{**FLEET_EC, "prefix_cache": False}
        )),
        [prompt], [n],
    )
    got = next(r for r in h0.sched.finished if r.rid == 1)
    assert list(got.tokens) == streams(cold)[0]


def test_resent_ship_frame_is_idempotent():
    """A duplicate ``cache_ship`` frame (retry after a lost ack, a
    stale in-flight answer) installs NOTHING the second time: same
    pool, same free-block count, and the prompt still streams
    bitwise cold."""
    cfg = tiny_cfg()
    params = tiny_params(cfg)
    prompt = (np.arange(22, dtype=np.int32) * 7) % cfg.vocab
    n = 5
    h0, h1, t = build_unified_pair(params, cfg, EngineConfig(**FLEET_EC))
    h1.submit(Request(rid=0, prompt=prompt, max_new_tokens=n))
    drive([h0, h1], 1)
    # hand-build the exact frame h1 would ship, deliver it TWICE
    cache = h1.engine.allocator.cache
    chain = cache.chain(prompt)
    blocks = cache.match_chain(chain)
    assert len(blocks) == 2
    h1.engine.allocator.retain(blocks)
    k, v = h1.engine.export_blocks(blocks)
    h1.engine.allocator.release(blocks)
    data = migrate.serialize_ship(99, chain[: len(blocks)], k, v)
    for _ in range(2):
        t.send("h0", "cache_ship", data, src="h1")
    h0.tick()
    assert h0.cache_ships_in == 2
    assert h0.ship_blocks_in == 2, (
        "the duplicate frame must install zero new blocks"
    )
    free_after_dupe = h0.engine.allocator.free_blocks
    # a third delivery is still a no-op on the pool
    t.send("h0", "cache_ship", data, src="h1")
    h0.tick()
    assert h0.ship_blocks_in == 2
    assert h0.engine.allocator.free_blocks == free_after_dupe
    # and the installed-once blocks serve a bitwise-cold hit
    h0.submit(Request(rid=1, prompt=prompt, max_new_tokens=n))
    drive([h0, h1], 2)
    assert h0.sched.prefix_hits == 1 and h0.cache_fetches == 0
    cold = serve_seq(
        Engine(params, cfg, EngineConfig(
            **{**FLEET_EC, "prefix_cache": False}
        )),
        [prompt], [n],
    )
    got = next(r for r in h0.sched.finished if r.rid == 1)
    assert list(got.tokens) == streams(cold)[0]


# ---------------------------------------------------------------------------
# the OS-process drill: two real processes, real TCP, DISTINCT workspaces
# ---------------------------------------------------------------------------
