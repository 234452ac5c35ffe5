"""Migration in the port (singa_tpu_torch/serve/fleet/migrate.py and the
engine's export/import/install): a slot moved between engines
continues bitwise, greedy and temperature, and frames cross packages
where the reader can continue them exactly (a greedy float32 frame in
both directions) and are rejected where it cannot (a temperature slot:
a threefry key one way, a ``torch.Generator`` state the other).
"""

import numpy as np
import pytest
import torch

from singa_tpu.models.transformer import TransformerConfig as JCfg
from singa_tpu.serve import Engine as JEngine
from singa_tpu.serve import EngineConfig as JEngineConfig
from singa_tpu.serve import Request as JRequest
from singa_tpu.serve import Scheduler as JScheduler
from singa_tpu.serve.fleet import migrate as jm
from singa_tpu_torch.models.transformer import TransformerConfig as TCfg
from singa_tpu_torch.models.transformer import generate
from singa_tpu_torch.serve import Engine, EngineConfig, Request, Scheduler
from singa_tpu_torch.serve.fleet import migrate as tm
from singa_tpu_torch.serve.kv_pool import PoolExhausted
from test_torch_prefix import KW, jax_params, torch_params

EC = dict(slots=3, kv_block_len=8, max_prefill_chunk=4)
#: one full block (a digest chain to ship) and a partial one
PROMPT = np.asarray([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5], np.int32)
N = 10


def filled(eng, prompt, budget, slot, temperature=0.0, seed=0):
    """Admit, prefill and activate ``prompt`` in ``slot`` -> first token."""
    eng.admit(slot, len(prompt) + budget, prompt=prompt)
    last = None
    for c0 in range(0, len(prompt), 4):
        last = eng.prefill_chunk(slot, prompt[c0:c0 + 4], c0)
    return int(eng.activate(slot, last, len(prompt), seed=seed,
                            temperature=temperature))


def tokens(out, slot):
    return int(np.asarray(out)[slot])


def exporter(temperature=0.0, impl="fused", ticks=3):
    """A port engine serving PROMPT in slot 1 for ``ticks`` ticks beside
    another sequence -> (engine, request with its tokens so far)."""
    eng = Engine(torch_params(), TCfg(**KW), EngineConfig(
        **EC, prefix_cache=True, attend_impl=impl), device="cpu")
    filled(eng, np.asarray([7, 7, 2], np.int32), 20, 0)
    toks = [filled(eng, PROMPT, N, 1, temperature, seed=9)]
    for _ in range(ticks):
        toks.append(tokens(eng.decode(), 1))
    req = Request(rid=7, prompt=PROMPT, max_new_tokens=N,
                  temperature=temperature, seed=9)
    req.tokens = list(toks)
    return eng, req


def continue_slot(eng, slot, have):
    out = list(have)
    while len(out) < N:
        out.append(tokens(eng.decode(), slot))
    return out


def gathered(eng, slot, n):
    rows = eng.state["tables"][slot:slot + 1]
    return [eng._gather(p, rows)[0, :, :n]
            for p in eng._pools[0]["k"] + eng._pools[0]["v"]]


@pytest.mark.parametrize("impl", ["fused", "reference"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_migrated_slot_continues_bitwise(temperature, impl):
    """Export after a few ticks, round-trip the frame, import into
    another slot of an engine that already serves a sequence: the
    continuation equals the exporter's own, token for token, and the
    gathered cache equals the exporter's over every written position;
    a greedy stream also equals generate()."""
    ea, req = exporter(temperature, impl)
    frame = tm.serialize(tm.export_sequence(ea, req, 1))
    mseq = tm.deserialize(frame)
    assert mseq.rid == 7 and mseq.n_blocks == 3
    assert ("gen_state" in mseq.payload) == (temperature > 0)
    want = continue_slot(ea, 1, req.tokens)
    eb = Engine(torch_params(), TCfg(**KW), EngineConfig(
        **EC, prefix_cache=True, attend_impl=impl), device="cpu")
    filled(eb, np.asarray([5, 5, 5, 5, 5], np.int32), 20, 0)
    info = tm.import_sequence(eb, 2, mseq)
    assert info["shared"] == 0 and info["blocks"] != ea._slot_blocks[1]
    got = continue_slot(eb, 2, mseq.emitted)
    assert got == want
    written = len(PROMPT) + N - 1
    for a, b in zip(gathered(ea, 1, written), gathered(eb, 2, written)):
        assert torch.equal(a, b)
    if temperature == 0.0:
        oracle = generate(torch_params(), torch.from_numpy(PROMPT)[None]
                          .long(), TCfg(**KW), N)[0, len(PROMPT):]
        assert got == oracle.tolist()
    else:
        greedy = continue_slot(exporter()[0], 1, exporter()[1].tokens)
        assert got != greedy


def test_frames_round_trip():
    ea, req = exporter(0.8)
    mseq = tm.export_sequence(ea, req, 1)
    back = tm.deserialize(tm.serialize(mseq))
    for k in ("rid", "emitted", "max_new_tokens", "temperature", "seed",
              "eos", "version"):
        assert getattr(back, k) == getattr(mseq, k)
    np.testing.assert_array_equal(back.prompt, mseq.prompt)
    for k in ("k", "v", "rng", "gen_state"):
        np.testing.assert_array_equal(back.payload[k], mseq.payload[k])
    for k in ("token", "pos", "temp", "chain", "gen_device"):
        assert back.payload[k] == mseq.payload[k]
    assert back.payload["chain"] and back.payload["gen_device"] == "cpu"


def jax_exporter(temperature=0.0):
    """The JAX engine serving PROMPT in slot 1 for 3 ticks."""
    eng = JEngine(jax_params(), JCfg(**KW),
                  JEngineConfig(**EC, prefix_cache=True))
    eng.admit(1, len(PROMPT) + N, prompt=PROMPT)
    last = None
    for c0 in range(0, len(PROMPT), 4):
        last = eng.prefill_chunk(1, PROMPT[c0:c0 + 4], c0)
    toks = [eng.activate(1, last, len(PROMPT), seed=9,
                         temperature=temperature)]
    for _ in range(3):
        toks.append(tokens(eng.decode(), 1))
    req = JRequest(rid=3, prompt=PROMPT, max_new_tokens=N,
                   temperature=temperature, seed=9)
    req.tokens = list(toks)
    return eng, req


def test_jax_greedy_frame_continues_in_the_port():
    ej, req = jax_exporter()
    frame = jm.serialize(jm.export_sequence(ej, req, 1))
    want = continue_slot(ej, 1, req.tokens)
    mseq = tm.deserialize(frame)
    eb = Engine(torch_params(), TCfg(**KW), EngineConfig(**EC), device="cpu")
    tm.import_sequence(eb, 0, mseq)
    assert continue_slot(eb, 0, mseq.emitted) == want


def test_port_greedy_frame_continues_in_the_jax_engine():
    ea, req = exporter()
    frame = tm.serialize(tm.export_sequence(ea, req, 1))
    want = continue_slot(ea, 1, req.tokens)
    mseq = jm.deserialize(frame)
    ej = JEngine(jax_params(), JCfg(**KW), JEngineConfig(**EC))
    jm.import_sequence(ej, 2, mseq)
    assert continue_slot(ej, 2, mseq.emitted) == want


def test_temperature_frames_are_rejected_across_packages():
    ea, req = exporter(0.8)
    with pytest.raises(ValueError, match="format"):
        jm.deserialize(tm.serialize(tm.export_sequence(ea, req, 1)))
    ej, jreq = jax_exporter(0.8)
    with pytest.raises(ValueError, match="temperature"):
        tm.deserialize(jm.serialize(jm.export_sequence(ej, jreq, 1)))


@pytest.mark.parametrize("fault", ["no_generator", "other_device",
                                   "short_state", "dtype", "geometry"])
def test_import_refuses_what_it_cannot_continue(fault):
    ea, req = exporter(0.8)
    payload = dict(ea.export_slot(1))
    if fault == "no_generator":
        del payload["gen_state"]
    elif fault == "other_device":
        payload["gen_device"] = "cuda"
    elif fault == "short_state":
        payload["gen_state"] = payload["gen_state"][:16]
    elif fault == "dtype":
        payload["k"] = payload["k"].astype(np.float64)
    else:
        payload["v"] = payload["v"][:, :, :1]
    eb = Engine(torch_params(), TCfg(**KW),
                EngineConfig(**EC, prefix_cache=True), device="cpu")
    free = eb.allocator.free_blocks
    with pytest.raises(ValueError):
        eb.import_slot(0, payload)
    assert eb.allocator.free_blocks == free and not bool(eb.state["live"][0])


def test_import_backpressure_is_a_no_op():
    ea, req = exporter()
    payload = ea.export_slot(1)
    eb = Engine(torch_params(), TCfg(**KW), EngineConfig(
        **EC, kv_blocks=5, prefix_cache=True), device="cpu")
    eb.admit(0, 16)  # 2 of 4 blocks left; the import needs 3
    before = (list(eb.allocator._free), eb.state["tables"].clone())
    with pytest.raises(PoolExhausted):
        eb.import_slot(1, payload)
    assert list(eb.allocator._free) == before[0]
    assert torch.equal(eb.state["tables"], before[1])
    assert not bool(eb.state["live"][1])


def ship(eng, prompt):
    """A ``cache_ship`` frame of ``prompt``'s cached blocks in ``eng``."""
    cache = eng.allocator.cache
    chain = cache.chain(prompt)
    blocks = cache.match_chain(chain)
    eng.allocator.retain(blocks)
    k, v = eng.export_blocks(blocks)
    eng.allocator.release(blocks)
    return tm.serialize_ship(5, chain[: len(blocks)], k, v)


def serve(eng, prompt, n=6):
    sched = Scheduler(eng)
    sched.submit(Request(rid=0, prompt=prompt, max_new_tokens=n))
    sched.serve()
    return sched, sched.finished[0].tokens


def test_installed_prefix_serves_the_local_hits_stream():
    """export_blocks -> cache_ship -> install_prefix: the installing
    engine's first admission of the prompt hits the shipped blocks and
    streams what a local hit (and a cold engine) streams; a re-sent ship
    installs nothing."""
    prompt = (np.arange(22, dtype=np.int32) * 5) % KW["vocab"]

    def engine(cache=True):
        return Engine(torch_params(), TCfg(**KW), EngineConfig(
            slots=2, kv_block_len=8, max_prefill_chunk=8,
            prefix_cache=cache), device="cpu")

    ea = engine()
    serve(ea, prompt)
    local, local_toks = serve(ea, prompt)
    assert local.prefix_hits == 1
    frame = tm.deserialize_ship(ship(ea, prompt))
    eb = engine()
    assert eb.install_prefix(frame["chain"], frame["k"], frame["v"]) == \
        {"installed": 2, "shared": 0}
    free = eb.allocator.free_blocks
    assert eb.install_prefix(frame["chain"], frame["k"], frame["v"]) == \
        {"installed": 0, "shared": 2}
    assert eb.allocator.free_blocks == free
    sched, toks = serve(eb, prompt)
    assert sched.prefix_hits == 1 and sched.blocks_shared == 2
    assert toks == local_toks == serve(engine(False), prompt)[1]


def test_fetch_and_ship_frames_cross_packages():
    chain = [bytes([i]) * 16 for i in range(3)]
    for write, read in ((tm, jm), (jm, tm)):
        assert read.deserialize_fetch(write.serialize_fetch(4, chain, 2)) \
            == (4, chain, 2)
        k = np.random.RandomState(0).randn(2, 3, 2, 8, 16).astype(np.float32)
        got = read.deserialize_ship(write.serialize_ship(4, chain, k, -k, 2))
        assert got["chain"] == chain and got["version"] == 2
        np.testing.assert_array_equal(got["k"], k)
        np.testing.assert_array_equal(got["v"], -k)
    with pytest.raises(ValueError):
        tm.deserialize_ship(tm.serialize_fetch(4, chain).ljust(64, b"\0"))


def test_jax_ship_installs_into_the_port():
    """A JAX engine's shipped blocks warm a port engine: its hit streams
    what the JAX engine streams."""
    prompt = (np.arange(22, dtype=np.int32) * 3) % KW["vocab"]
    ej = JEngine(jax_params(), JCfg(**KW), JEngineConfig(
        slots=2, kv_block_len=8, max_prefill_chunk=8, prefix_cache=True))
    js = JScheduler(ej)
    js.submit(JRequest(rid=0, prompt=prompt, max_new_tokens=6))
    js.serve()
    cache = ej.allocator.cache
    chain = cache.chain(prompt)
    blocks = cache.match_chain(chain)
    k, v = ej.export_blocks(blocks)
    frame = tm.deserialize_ship(jm.serialize_ship(1, chain[:2], k, v))
    eb = Engine(torch_params(), TCfg(**KW), EngineConfig(
        slots=2, kv_block_len=8, max_prefill_chunk=8, prefix_cache=True),
        device="cpu")
    assert eb.install_prefix(frame["chain"], frame["k"],
                             frame["v"])["installed"] == 2
    sched, toks = serve(eb, prompt)
    assert sched.prefix_hits == 1
    assert toks == [int(t) for t in js.finished[0].tokens]


def test_import_shares_the_importers_cached_prefix():
    """An importer that already holds the prompt's first block (served
    the same prompt before) shares it instead of writing it again, and
    the continuation is still the exporter's."""
    ea, req = exporter()
    payload = ea.export_slot(1)
    want = continue_slot(ea, 1, req.tokens)
    eb = Engine(torch_params(), TCfg(**KW),
                EngineConfig(**EC, prefix_cache=True), device="cpu")
    serve(eb, PROMPT, n=2)
    info = eb.import_slot(2, payload)
    assert info["shared"] == 1 and info["registered"] == 0
    assert continue_slot(eb, 2, req.tokens) == want
