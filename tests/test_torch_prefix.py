"""The port's prefix cache (singa_tpu_torch/serve): shared block
prefixes, copy-on-write, partial tails, decode-written history and LRU
eviction, against the JAX ``Engine``/``Scheduler`` on the same weights.

Every workload runs through the JAX engine (its ``reference`` attend)
with ``prefix_cache`` on, and through the port under both
``attend_impl`` values (on the CPU ``fused`` runs the kernel's plain
version) with the cache on and off. The bars are the JAX package's:
greedy streams identical request by request, the scheduler's prefix
counters equal to the JAX scheduler's, and a warm admission's pool
bytes equal to a cold one's, bit for bit.
"""

import functools
import json

import jax
import numpy as np
import pytest
import torch

from singa_tpu.models.transformer import TransformerConfig as JCfg
from singa_tpu.models.transformer import init_lm as j_init_lm
from singa_tpu.serve import Engine as JEngine
from singa_tpu.serve import EngineConfig as JEngineConfig
from singa_tpu.serve import Request as JRequest
from singa_tpu.serve import Scheduler as JScheduler
from singa_tpu.serve import kv_pool as j_kv
from singa_tpu_torch.models.transformer import TransformerConfig as TCfg
from singa_tpu_torch.models.transformer import generate, load_jax_params
from singa_tpu_torch.serve import Engine, EngineConfig, Request, Scheduler
from singa_tpu_torch.serve import kv_pool as t_kv

KW = dict(vocab=32, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_len=32)
IMPLS = ["fused", "reference"]
#: the scheduler's prefix counters (occupancy() keys) held to JAX's
COUNTERS = ("prefix_hits", "prefix_hit_rate", "blocks_shared", "cow_copies",
            "partial_hits", "tail_tokens_shared", "decode_blocks_registered",
            "prefill_chunks", "prefill_chunks_saved", "lru_evictions",
            "lru_reclaims", "kv_blocks_cached")


@functools.cache
def jax_params(seed=0):
    return j_init_lm(jax.random.PRNGKey(seed), JCfg(**KW))


@functools.cache
def torch_params(seed=0):
    return load_jax_params(
        {k: np.asarray(v) for k, v in jax_params(seed).items()}, "cpu"
    )


def _ints(rs, n):
    return rs.randint(0, KW["vocab"], size=(n,)).astype(np.int32)


def _interleaved():
    """Ragged requests sharing one 8-token prefix, unique 3-token tails:
    admissions and retirements interleave while the prefix is shared."""
    rs = np.random.RandomState(0)
    prefix = _ints(rs, 8)
    return [[(np.concatenate([prefix, _ints(rs, 3)]), int(rs.randint(4, 9)))
             for _ in range(6)]]


def _cow():
    """A whole-prompt hit while the first owner's blocks sit on the LRU,
    then two at once (live sharing, refcount 2)."""
    p = _ints(np.random.RandomState(2), 8)
    return [[(p, 6)], [(p, 8), (p, 8)]]


def _tail(stride, fill, base_len=8):
    """The JAX tail_stride sweep: a seed prompt ending mid-block, then
    followers sharing ``tail[:j]`` (j a stride multiple) and diverging,
    ``fill`` shifting how deep past the stride point they run. With
    ``base_len`` 0 every prompt is shorter than one block."""
    rs = np.random.RandomState(7 + stride + fill)
    base, tail = _ints(rs, base_len), _ints(rs, 6)
    prompts = [np.concatenate([base, tail])]
    for j in range(stride, len(tail), stride):
        prompts.append(np.concatenate([base, tail[:j], _ints(rs, 1 + fill)]))
    return [[(p, 4)] for p in prompts]


def _decode_blocks():
    """A follow-up turn whose prompt replays the first turn's history:
    the second wave is built from the first wave's stream."""
    prompt = _ints(np.random.RandomState(11), 8)
    return [[(prompt, 9)],
            lambda streams: [(np.concatenate(
                [prompt, np.asarray(streams[0][:8], np.int32)]), 4)]]


def _lru():
    """Distinct prompts in a pool far too small to keep them: parked
    blocks are evicted lazily."""
    rs = np.random.RandomState(9)
    return [[(_ints(rs, 8), int(rs.randint(4, 9))) for _ in range(6)]]


def _spec():
    """Drafting-friendly prompts sharing a motif prefix, verify ticks."""
    motif = _ints(np.random.RandomState(3), 4)
    prefix = np.tile(motif, 2)
    return [[(np.concatenate([prefix, motif[:2]]), m) for m in (6, 7, 5, 8)]]


#: workload -> (engine knobs, waves); a wave is a list of (prompt,
#: budget), or a function of the streams so far that returns one
WORKLOADS = {
    "interleaved": (dict(slots=3, kv_block_len=4, max_prefill_chunk=4),
                    _interleaved),
    "whole_prompt_cow": (dict(slots=3, kv_block_len=4, max_prefill_chunk=4),
                         _cow),
    **{f"tail_s{s}_f{f}": (dict(slots=1, kv_block_len=8, max_prefill_chunk=8,
                                prefix_tail_stride=s),
                           functools.partial(_tail, s, f))
       for s in (2, 4) for f in (0, 1)},
    "tail_s2_sub_block": (dict(slots=1, kv_block_len=8, max_prefill_chunk=8,
                               prefix_tail_stride=2),
                          functools.partial(_tail, 2, 0, 0)),
    "decode_blocks": (dict(slots=1, kv_block_len=4, max_prefill_chunk=4,
                           prefix_decode_blocks=True), _decode_blocks),
    "lru_small_pool": (dict(slots=2, kv_block_len=8, max_prefill_chunk=8,
                            kv_blocks=5), _lru),
    "spec2": (dict(slots=3, kv_block_len=4, max_prefill_chunk=4, spec_k=2),
              _spec),
}


def run_waves(engine, sched_cls, req_cls, waves):
    """Serve each wave to completion in turn (rids count on across
    waves). -> (scheduler, {rid: tokens})."""
    sched = sched_cls(engine)
    streams, rid = {}, 0
    for wave in waves:
        if callable(wave):
            wave = wave(streams)
        for p, m in wave:
            sched.submit(req_cls(rid=rid, prompt=np.asarray(p, np.int32),
                                 max_new_tokens=m))
            rid += 1
        sched.serve()
        streams = {r.rid: list(r.tokens) for r in sched.finished}
    return sched, streams


def serve_torch(workload, impl, prefix_cache=True):
    kw, waves = WORKLOADS[workload]
    eng = Engine(torch_params(), TCfg(**KW), EngineConfig(
        **kw, prefix_cache=prefix_cache, attend_impl=impl), device="cpu")
    return run_waves(eng, Scheduler, Request, waves())


@functools.cache
def serve_jax(workload):
    kw, waves = WORKLOADS[workload]
    eng = JEngine(jax_params(), JCfg(**KW),
                  JEngineConfig(**kw, prefix_cache=True))
    sched, streams = run_waves(eng, JScheduler, JRequest, waves())
    occ = sched.occupancy()
    return streams, {k: occ[k] for k in COUNTERS}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_warm_streams_and_counters_match_jax(workload, impl):
    sched, warm = serve_torch(workload, impl)
    want, counters = serve_jax(workload)
    assert warm == want
    occ = sched.occupancy()
    assert {k: occ[k] for k in COUNTERS} == counters
    _, cold = serve_torch(workload, impl, prefix_cache=False)
    assert warm == cold
    assert sched.engine.allocator.used_blocks == 0
    if workload != "lru_small_pool":
        assert sched.prefix_hits > 0
    if workload not in ("lru_small_pool", "tail_s2_sub_block"):
        # (a sub-block prompt is one chunk with or without its hit)
        assert sched.prefill_chunks_saved > 0
    if workload == "whole_prompt_cow":
        assert sched.cow_copies == 2
    if workload.startswith("tail"):
        assert sched.partial_hits == len(want) - 1
    if workload == "decode_blocks":
        assert sched.decode_blocks_registered == 2
        assert sched.blocks_shared >= 3
    if workload == "lru_small_pool":
        assert sched.engine.allocator.lru_evictions > 0
    if workload == "spec2":
        assert sched.spec_accepted > 0


def test_interleaved_warm_streams_equal_generate():
    _, warm = serve_torch("interleaved", "fused")
    (wave,) = WORKLOADS["interleaved"][1]()
    for i, (p, m) in enumerate(wave):
        want = generate(torch_params(), torch.from_numpy(p)[None].long(),
                        TCfg(**KW), m)[0, len(p):]
        assert warm[i] == want.tolist()


def _pool_view(eng, slot, n):
    """Every layer's gathered K and V of ``slot`` over positions < n."""
    rows = eng.state["tables"][slot:slot + 1]
    return [eng._gather(pool, rows)[0, :, :n].clone()
            for pool in eng._pools[0]["k"] + eng._pools[0]["v"]]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", ["block", "tail", "whole_prompt"])
def test_warm_pool_bytes_equal_cold_bitwise(case, impl):
    """A hit sequence's pool bytes, shared blocks included, equal its own
    cold admission's over every written position. Block 4, chunk 8: the
    warm chunk starts at 12, so each position lands on another row of
    the fixed (1, 8) prefill than it did cold (12 at row 0, not 4), and
    the tail case starts mid-block (14); the whole-prompt hit re-derives
    position 11 in a COW'd block."""
    rs = np.random.RandomState(1)
    prefix = _ints(rs, 12)
    prompt = {"block": np.concatenate([prefix, _ints(rs, 5)]),
              "tail": np.concatenate([prefix, _ints(rs, 5)]),
              "whole_prompt": prefix}[case]
    # the tail case's seed ends mid-block: its last block registers the
    # 2 tokens past the prefix as a partial tail
    seed = {"block": prefix, "tail": prompt[:14],
            "whole_prompt": prefix}[case]
    n = 6

    def run(enabled):
        eng = Engine(torch_params(), TCfg(**KW), EngineConfig(
            slots=2, kv_block_len=4, max_prefill_chunk=8,
            prefix_cache=enabled, prefix_tail_stride=2,
            attend_impl=impl), device="cpu")
        for slot, p in ((0, seed), (1, prompt)):
            adm = eng.admit(slot, len(p) + n, prompt=p)
            last = None
            for c0 in range(adm.prefill_from, len(p), 8):
                last = eng.prefill_chunk(slot, p[c0:c0 + 8], c0)
            if slot == 0:
                eng.register_prefix(0, p)
                eng.retire(0)
        toks = [eng.activate(1, last, len(prompt), seed=0)]
        for _ in range(n - 1):
            toks.append(int(eng.decode()[1]))
        return adm, toks, _pool_view(eng, 1, len(prompt) + n - 1)

    warm_adm, warm_toks, warm = run(True)
    cold_adm, cold_toks, cold = run(False)
    assert warm_adm.prefill_from == {"block": 12, "tail": 14,
                                     "whole_prompt": 11}[case]
    assert warm_adm.cow_copied == (case == "whole_prompt")
    assert warm_adm.tail_tokens == (2 if case == "tail" else 0)
    assert cold_adm.cached_tokens == 0
    assert warm_toks == cold_toks
    for w, c in zip(warm, cold):
        assert torch.equal(w, c)


def test_backpressured_hit_admission_is_a_no_op():
    """An admission whose hit is cached but whose fresh blocks do not fit
    raises PoolExhausted and leaves the allocator as it was: free list,
    LRU order, refcounts, index and statistics."""
    eng = Engine(torch_params(), TCfg(**KW), EngineConfig(
        slots=2, kv_block_len=4, max_prefill_chunk=4, kv_blocks=9,
        prefix_cache=True), device="cpu")
    sched = Scheduler(eng)
    prefix = _ints(np.random.RandomState(4), 8)
    sched.submit(Request(rid=0, prompt=prefix, max_new_tokens=4))
    sched.serve()
    # a live sequence holds 6 of the 8 blocks, the prefix's 2 are parked
    eng.admit(0, 24)
    alloc = eng.allocator

    def snapshot():
        return (list(alloc._free), list(alloc._lru), dict(alloc._ref),
                dict(alloc.cache._by_digest), alloc.lru_evictions,
                alloc.lru_reclaims, eng.state["tables"].clone())

    before = snapshot()
    with pytest.raises(t_kv.PoolExhausted):
        eng.admit(1, 24, prompt=np.concatenate([prefix, prefix]))
    after = snapshot()
    assert all(a == b if not isinstance(a, torch.Tensor)
               else torch.equal(a, b) for a, b in zip(before, after))


def test_chains_are_the_same_bytes_in_both_packages():
    """Digest chains and tail digests cross packages: a frame's chain
    written by one package matches blocks registered by the other."""
    rs = np.random.RandomState(5)
    tokens = _ints(rs, 29)
    for bl, stride in ((4, 2), (8, 4), (16, 4)):
        t, j = t_kv.PrefixCache(bl, stride), j_kv.PrefixCache(bl, stride)
        assert t.chain(tokens) == j.chain(tokens)
        parent = t.chain(tokens)[-1]
        for n in range(stride, bl, stride):
            assert t._tail_digest(parent, tokens[:n].tobytes()) == \
                j._tail_digest(parent, tokens[:n].tobytes())


CONF = """
name: "serve"
serving {
  slots: 4 kv_block_len: 8 kv_blocks: 40 max_prefill_chunk: 16
  speculate { k: 3 drafter: "null" }
  prefix_cache { enabled: true lru: false tail_stride: 4
                 decode_blocks: true fetch_timeout_s: 0.5 }
}
kernels { paged_attention: "fused" }
neuralnet { }
"""


def test_engine_config_from_conf_matches_jax():
    from singa_tpu.config import parse_model_config as j_parse
    from singa_tpu_torch.config import parse_model_config as t_parse

    t, j = t_parse(CONF), j_parse(CONF)
    got = EngineConfig.from_conf(t.serving, t.kernels)
    want = JEngineConfig.from_conf(j.serving, j.kernels)
    fields = [f for f in got.__dataclass_fields__]
    assert {f: getattr(got, f) for f in fields} == \
        {f: getattr(want, f) for f in fields}
    assert got.prefix_cache and got.prefix_tail_stride == 4
    assert EngineConfig.from_conf(None).attend_impl == "fused"


def test_serve_bench_shared_prefix_smoke(capsys):
    """serve_bench --workload shared_prefix at toy size on the CPU: the
    deterministic prefill-chunk arm of the gate holds, streams equal the
    cold run's, hits and a COW recorded."""
    from singa_tpu_torch.tools.serve_bench import main as sb_main

    rc = sb_main([
        "--d_model", "32", "--n_heads", "2", "--n_layers", "1",
        "--d_ff", "64", "--vocab", "32", "--max_len", "64",
        "--prompt_len", "24", "--max_new", "6", "--block_len", "4",
        "--prefill_chunk", "4", "--requests", "6", "--concurrency", "2",
        "--workload", "shared_prefix", "--device", "cpu",
    ])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0, out
    assert out["pass"] and out["pass_mode"] is not None
    assert out["token_mismatches"] == 0
    assert out["prefix_hit_rate"] > 0
    assert out["prefill_chunk_ratio"] >= 2.0
    assert out["cow_copies"] >= 1
    assert out["prefill_chunks_cold"] > out["prefill_chunks_warm"]
    assert out["device"] == "cpu"
