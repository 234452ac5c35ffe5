"""The MoE LM served by the port (models/transformer.py with
``moe_experts``, serve/engine.py at capacity factor E) against the JAX
package's, on the same weights.

Weights come from the JAX ``init_lm`` (4 experts) through
``load_jax_params``. Bars: greedy streams identical to the JAX
Engine's, request by request, under both ``attend_impl`` values (on the
CPU ``fused`` runs the paged kernel's plain version); ``lm_apply``'s
logits within 1e-5 and the blocks' summed aux within 1e-6 of JAX's
``lm_apply(return_aux=True)``; ``generate`` identical to
the JAX ``generate``; and decode independent of what shares the batch
(the port's counterpart of tests/test_generate.py's MoE tests).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.models import transformer as jt
from singa_tpu.serve import Engine as JEngine
from singa_tpu.serve import EngineConfig as JEngineConfig
from singa_tpu.serve import Request as JRequest
from singa_tpu.serve import Scheduler as JScheduler
from singa_tpu_torch.models import transformer as tt
from singa_tpu_torch.ops.attention import attention
from singa_tpu_torch.serve import Engine, EngineConfig, Request, Scheduler

KW = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_len=48,
          moe_experts=4)
IMPLS = ["fused", "reference"]
#: workload name -> engine knobs (both packages) and request count
WORKLOADS = {
    "interleaved": dict(slots=3, n=6),
    "single_slot": dict(slots=1, n=4),
    "spec2": dict(slots=3, n=6, spec_k=2),
}


@functools.cache
def jax_params():
    return jt.init_lm(jax.random.PRNGKey(0), jt.TransformerConfig(**KW))


@functools.cache
def torch_params():
    return tt.load_jax_params(
        {k: np.asarray(v) for k, v in jax_params().items()}, "cpu")


def requests(n, seed=0, repeat=False):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        plen = int(rs.randint(3, 20))
        if repeat:
            motif = rs.randint(0, KW["vocab"], size=(3,))
            prompt = np.tile(motif, plen // 3 + 1)[:plen]
        else:
            prompt = rs.randint(0, KW["vocab"], size=(plen,))
        out.append((prompt.astype(np.int32), int(rs.randint(4, 20))))
    return out


def serve_torch(impl, *, slots, n, spec_k=0):
    eng = Engine(torch_params(), tt.TransformerConfig(**KW), EngineConfig(
        slots=slots, kv_block_len=8, max_prefill_chunk=4, spec_k=spec_k,
        attend_impl=impl,
    ), device="cpu")
    sched = Scheduler(eng)
    for i, (p, m) in enumerate(requests(n, repeat=spec_k > 0)):
        sched.submit(Request(rid=i, prompt=p, max_new_tokens=m))
    sched.serve()
    return sched, {r.rid: r.tokens for r in sched.finished}


@functools.cache
def serve_jax(workload):
    kw = WORKLOADS[workload]
    spec_k = kw.get("spec_k", 0)
    eng = JEngine(jax_params(), jt.TransformerConfig(**KW), JEngineConfig(
        slots=kw["slots"], kv_block_len=8, max_prefill_chunk=4,
        spec_k=spec_k,
    ))
    sched = JScheduler(eng)
    for i, (p, m) in enumerate(requests(kw["n"], repeat=spec_k > 0)):
        sched.submit(JRequest(rid=i, prompt=p, max_new_tokens=m))
    sched.serve()
    return {r.rid: r.tokens for r in sched.finished}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_moe_streams_match_jax(workload, impl):
    kw = WORKLOADS[workload]
    sched, got = serve_torch(impl, **kw)
    assert got == serve_jax(workload)
    assert len(got) == kw["n"]
    if kw.get("spec_k"):
        assert sched.spec_accepted > 0


def test_moe_lm_apply_matches_jax():
    """Training capacity (cf 1.25, drops at this batch) through the
    shared block body: logits within 1e-5, the summed aux within 1e-6."""
    tokens = np.random.RandomState(1).randint(0, 64, (4, 24)).astype(
        np.int32)
    jl, jaux = jt.lm_apply(jax_params(), jnp.asarray(tokens),
                           jt.TransformerConfig(**KW), return_aux=True)
    params, cfg = torch_params(), tt.TransformerConfig(**KW)
    tl = tt.lm_apply(params, torch.from_numpy(tokens), cfg)
    # the aux, summed over the shared block body as JAX's lm_apply sums it
    x = params["embed/tok"][torch.from_numpy(tokens).long()]
    x = x + params["embed/pos"][:tokens.shape[1]]
    taux = 0.0
    for i in range(cfg.n_layers):
        x, aux, _ = tt._block_apply(
            params, f"blk{i}", x,
            lambda q, k, v: (attention(q, k, v, causal=True), None), cfg)
        taux += float(aux)
    np.testing.assert_allclose(tt.lm_head(params, x).numpy(), tl.numpy(),
                               atol=0, rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=1e-5)
    assert float(taux) == pytest.approx(float(jaux), abs=1e-6)
    assert float(taux) > 0


def test_moe_generate_matches_jax():
    prompt = np.random.RandomState(2).randint(0, 64, (2, 5)).astype(np.int32)
    want = jt.generate(jax_params(), jnp.asarray(prompt),
                       jt.TransformerConfig(**KW), 10)
    got = tt.generate(torch_params(), torch.from_numpy(prompt),
                      tt.TransformerConfig(**KW), 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_moe_decode_is_batch_independent():
    """A row's tokens do not depend on what shares the batch: decode
    routes at capacity E, so no token is dropped."""
    cfg = tt.TransformerConfig(**KW)
    prompts = torch.from_numpy(
        np.random.RandomState(4).randint(0, 64, (4, 5)))
    batched = tt.generate(torch_params(), prompts, cfg, 8)
    for r in range(4):
        alone = tt.generate(torch_params(), prompts[r:r + 1], cfg, 8)
        assert torch.equal(batched[r], alone[0]), r


def test_moe_engine_stream_equals_generate():
    """One request through the engine equals the sequential oracle."""
    prompt, n_new = requests(1, seed=5)[0]
    eng = Engine(torch_params(), tt.TransformerConfig(**KW), EngineConfig(
        slots=2, kv_block_len=8, max_prefill_chunk=4), device="cpu")
    sched = Scheduler(eng)
    sched.submit(Request(rid=0, prompt=prompt, max_new_tokens=n_new))
    sched.serve()
    want = tt.generate(torch_params(), torch.from_numpy(prompt)[None],
                       tt.TransformerConfig(**KW), n_new)
    assert sched.finished[0].tokens == want[0, len(prompt):].tolist()


def test_moe_params_export_and_init():
    cfg = tt.TransformerConfig(**KW)
    back = tt.export_params(torch_params())
    for k, v in jax_params().items():
        np.testing.assert_array_equal(back[k], np.asarray(v))
    mine = tt.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        k: tuple(v.shape) for k, v in jax_params().items()}
    assert not any("/mlp/" in k for k in mine)
