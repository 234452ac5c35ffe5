"""The port's serving engine on a mesh (``Engine(mesh=...)``) against the
JAX package's tensor-parallel engine and against the port's own
unsharded engine, on the same weights.

The JAX side lays the params out with its ``lm_param_shardings`` over a
("model",) mesh of two of the suite's virtual CPU devices and its pools
with ``serving_kv_shardings``; the port runs two CPU model ranks
(``build_mesh(1, 2, ["cpu"] * 2)``), each with its own pools of its
heads, the params split by ``models/transformer.lm_param_shardings``.
The bars are the JAX package's own (tests/test_serve.py:388,
tests/test_prefix_cache.py:459): greedy streams identical, request by
request, to the JAX engine's and to the unsharded engine's, warm equal
to cold; the split forward's logits within 1e-5 of the unsplit.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from singa_tpu.models.transformer import TransformerConfig as JCfg
from singa_tpu.models.transformer import init_lm as j_init_lm
from singa_tpu.models.transformer import (
    lm_param_shardings as j_lm_param_shardings,
)
from singa_tpu.parallel.shardings import serving_kv_shardings
from singa_tpu.serve import Engine as JEngine
from singa_tpu.serve import EngineConfig as JEngineConfig
from singa_tpu.serve import Request as JRequest
from singa_tpu.serve import Scheduler as JScheduler
from singa_tpu_torch.models import transformer as tt
from singa_tpu_torch.models.transformer import TransformerConfig as TCfg
from singa_tpu_torch.models.transformer import load_jax_params
from singa_tpu_torch.parallel import build_mesh
from singa_tpu_torch.parallel.mesh import Mesh
from singa_tpu_torch.serve import Engine, EngineConfig, Request, Scheduler
from singa_tpu_torch.serve import engine as t_engine
from test_torch_launch import one_torch_thread  # noqa: F401
from test_torch_migrate import EC, PROMPT, continue_slot, filled, tokens
from test_torch_prefix import KW, WORKLOADS, jax_params, run_waves
from test_torch_prefix import serve_torch as serve_plain
from test_torch_prefix import torch_params

IMPLS = ["fused", "reference"]
LOGIT_TOL = 1e-5
#: the n_heads-3 config: the model width 2 does not divide the heads
KW3 = dict(vocab=32, d_model=24, n_heads=3, n_layers=2, d_ff=64, max_len=32)


def mesh2():
    return build_mesh(1, 2, ["cpu"] * 2)


def tp_engine(serving: dict, params=None, cfg=None, **kw):
    return Engine(torch_params() if params is None else params,
                  TCfg(**KW) if cfg is None else cfg, EngineConfig(**serving),
                  mesh=mesh2(), **kw)


def jax_tp_params(params):
    mesh = JMesh(np.array(jax.devices()[:2]), ("model",))
    sh = j_lm_param_shardings(mesh, params)
    return mesh, {k: jax.device_put(v, sh[k]) for k, v in params.items()}


@functools.cache
def serve_jax_tp(workload):
    kw, waves = WORKLOADS[workload]
    mesh, params = jax_tp_params(jax_params())
    eng = JEngine(params, JCfg(**KW), JEngineConfig(**kw, prefix_cache=True),
                  mesh=mesh)
    return run_waves(eng, JScheduler, JRequest, waves())[1]


def test_layout_is_the_jax_lm_param_shardings():
    """The split dims equal the JAX specs' model dims, at a width that
    divides every split dim and at one (3) that divides none of d_model
    32 or d_ff 64 (everything replicates)."""
    np_params = {k: np.asarray(v) for k, v in jax_params().items()}
    for width in (2, 3):
        mesh = JMesh(np.array(jax.devices()[:width]), ("model",))
        want = {k: next((d for d, a in enumerate(sh.spec) if a == "model"),
                        None)
                for k, sh in j_lm_param_shardings(mesh, np_params).items()}
        got = tt.lm_param_shardings(width, torch_params())
        assert got == want
    assert got and not any(d is not None for d in got.values())
    assert tt.lm_param_shardings(2, torch_params())["blk0/mlp/up"] == 1


@pytest.mark.parametrize("width", [2, 4])
def test_split_forward_logits_match_the_unsplit(width):
    """``lm_apply_tp`` over 2 ranks (one head each) and 4 (the heads
    replicate: each rank attends both and takes its rows of the output's
    contraction) within 1e-5 of ``lm_apply``; the split params are each
    rank's own contiguous pieces."""
    cfg = TCfg(**KW)
    params = torch_params()
    layout = tt.lm_param_shardings(width, params)
    pieces = tt.split_lm_params(params, layout, ["cpu"] * width)
    assert pieces[1]["blk0/attn/qkv"].shape == (32 // width, 96)
    assert pieces[1]["blk0/mlp/up"].is_contiguous()
    tokens_ = torch.from_numpy(np.random.RandomState(0).randint(
        0, KW["vocab"], size=(3, 17)))
    want = tt.lm_apply(params, tokens_, cfg)
    got = tt.lm_apply_tp(params, pieces, layout, tokens_, cfg)
    torch.testing.assert_close(got, want, rtol=0, atol=LOGIT_TOL)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("workload", ["interleaved", "spec2"])
def test_mesh_streams_equal_jax_tp_and_the_unsharded_engine(workload, impl):
    """Prefix cache on (shared prefixes, COW), verify ticks on spec2:
    the mesh engine's streams equal the JAX TP engine's and the port's
    unsharded engine's, request by request."""
    kw, waves = WORKLOADS[workload]
    sched, got = run_waves(
        tp_engine(dict(kw, prefix_cache=True, attend_impl=impl)),
        Scheduler, Request, waves())
    assert got == serve_jax_tp(workload)
    assert got == serve_plain(workload, impl)[1]
    assert sched.occupancy()["prefix_hits"] > 0


@pytest.mark.parametrize("workload", ["whole_prompt_cow", "lru_small_pool"])
def test_mesh_warm_equals_cold(workload):
    """The JAX package's warm-equals-cold on a TP mesh: the mesh engine
    with the prefix cache (COW copies, LRU evictions on every rank's
    pools) against the unsharded engine without it."""
    kw, waves = WORKLOADS[workload]
    _, warm = run_waves(tp_engine(dict(kw, prefix_cache=True)),
                        Scheduler, Request, waves())
    assert warm == serve_plain(workload, "fused", prefix_cache=False)[1]


def test_each_rank_runs_the_kernel_over_its_own_pools(monkeypatch):
    """Each rank's pools are contiguous tensors of its n_heads / M heads,
    the paged kernel (its plain version here) runs once per rank, layer
    and call over them, and never over a view of another rank's."""
    calls = []
    inner = t_engine.paged_attention

    def counted(q, kp, vp, *args):
        calls.append((q.shape[1], kp.data_ptr(), kp.is_contiguous()))
        return inner(q, kp, vp, *args)

    monkeypatch.setattr(t_engine, "paged_attention", counted)
    kw, waves = WORKLOADS["interleaved"]
    eng = tp_engine(dict(kw, attend_impl="fused"))
    assert [p["k"][0].shape[1] for p in eng._pools] == [1, 1]
    run_waves(eng, Scheduler, Request, waves())
    tp = list(calls)
    calls.clear()
    run_waves(Engine(torch_params(), TCfg(**KW), EngineConfig(**kw),
                     device="cpu"), Scheduler, Request, waves())
    assert len(tp) == 2 * len(calls) > 0
    own = {eng._pools[m]["k"][i].data_ptr()
           for m in range(2) for i in range(KW["n_layers"])}
    assert all(h == 1 and ptr in own and contig for h, ptr, contig in tp)


@pytest.mark.parametrize("src,dst", [("mesh", "plain"), ("plain", "mesh")])
def test_a_slot_moves_between_a_mesh_and_a_plain_engine(src, dst):
    """export_slot gathers the heads in rank order and import_slot
    splits them: a slot exported from one kind of engine reads back from
    the other bit for bit, and continues there token for token as the
    exporter's own continuation."""
    def make(kind):
        serving = dict(EC, prefix_cache=True)
        if kind == "mesh":
            return tp_engine(serving)
        return Engine(torch_params(), TCfg(**KW), EngineConfig(**serving),
                      device="cpu")

    ea = make(src)
    filled(ea, np.asarray([7, 7, 2], np.int32), 20, 0)
    have = [filled(ea, PROMPT, 10, 1)]
    for _ in range(3):
        have.append(tokens(ea.decode(), 1))
    payload = ea.export_slot(1)
    assert payload["k"].shape[2] == KW["n_heads"]
    want = continue_slot(ea, 1, have)
    eb = make(dst)
    filled(eb, np.asarray([5, 5, 5, 5, 5], np.int32), 20, 0)
    eb.import_slot(2, payload)
    back = eb.export_slot(2)
    for kv in ("k", "v"):
        np.testing.assert_array_equal(back[kv], payload[kv])
    assert continue_slot(eb, 2, have) == want


def test_indivisible_heads_replicate_with_the_jax_warning():
    """n_heads 3 over 2 model ranks: the pools replicate (every rank
    holds all 3 heads) with the JAX package's warning, and the streams
    still equal the unsharded engine's."""
    jmesh = JMesh(np.array(jax.devices()[:2]), ("model",))
    with pytest.warns(UserWarning) as jw:
        serving_kv_shardings(jmesh, 3, warn=True)
    params = load_jax_params({k: np.asarray(v) for k, v in j_init_lm(
        jax.random.PRNGKey(1), JCfg(**KW3)).items()}, "cpu")
    kw, waves = WORKLOADS["interleaved"]
    with pytest.warns(UserWarning) as tw:
        eng = tp_engine(dict(kw), params=params, cfg=TCfg(**KW3))
    assert str(tw[0].message) == str(jw[0].message)
    assert [p["k"][0].shape[1] for p in eng._pools] == [3, 3]
    assert eng._layout["blk0/attn/qkv"] == 0
    _, got = run_waves(eng, Scheduler, Request, waves())
    plain = Engine(params, TCfg(**KW3), EngineConfig(**kw), device="cpu")
    assert got == run_waves(plain, Scheduler, Request, waves())[1]


def test_a_rank_reading_another_ranks_pool_changes_the_streams():
    """Planted fault: rank 1's pools are rank 0's, so rank 1 writes and
    reads rank 0's head. The streams must leave the unsharded ones."""
    kw, waves = WORKLOADS["interleaved"]
    eng = tp_engine(dict(kw))
    eng._pools[1] = eng._pools[0]
    _, got = run_waves(eng, Scheduler, Request, waves())
    assert got != serve_plain("interleaved", "fused", prefix_cache=False)[1]


def test_a_flip_refreshes_every_ranks_pieces():
    """stage_params/flip_params on a mesh: the flipped weights reach the
    ranks' pieces in place (their addresses kept), so the streams are
    the unsharded engine's under the new weights; rollback restores."""
    kw, waves = WORKLOADS["interleaved"]
    other = load_jax_params({k: np.asarray(v) for k, v in j_init_lm(
        jax.random.PRNGKey(4), JCfg(**KW)).items()}, "cpu")
    eng = tp_engine(dict(kw))
    ptr = eng._pieces[1]["blk0/attn/out"].data_ptr()
    eng.stage_params(other, 1)
    eng.flip_params()
    assert eng._pieces[1]["blk0/attn/out"].data_ptr() == ptr
    torch.testing.assert_close(eng._pieces[1]["blk0/attn/out"],
                               other["blk0/attn/out"][16:], rtol=0, atol=0)
    _, got = run_waves(eng, Scheduler, Request, waves())
    plain = Engine(other, TCfg(**KW), EngineConfig(**kw), device="cpu")
    assert got == run_waves(plain, Scheduler, Request, waves())[1]
    eng.rollback_params()
    assert torch.equal(eng._pieces[1]["blk0/attn/out"],
                       torch_params()["blk0/attn/out"][16:])


@pytest.mark.parametrize("case", ["processes", "device"])
def test_mesh_refusals_by_name(case):
    if case == "processes":
        mesh, kw, match = Mesh((torch.device("cpu"),) * 2, 2, 0,
                               (1, 1, 1, 2)), {}, "over 2 processes"
    else:
        mesh, kw, match = mesh2(), {"device": "meta"}, "first rank is on cpu"
    with pytest.raises(ValueError, match=match):
        Engine(torch_params(), TCfg(**KW), mesh=mesh, **kw)
