"""The port's transformer LM (singa_tpu_torch/models/transformer.py)
against the JAX package's, on the same weights.

Weights are made once by the JAX ``init_lm`` and handed to the port
through ``load_jax_params``; inputs come from numpy with a seed. Both
run float32 on the CPU, so the bar is allclose at 1e-5 (the two
frameworks' matmuls sum in different orders) and identical greedy
token streams.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.models import transformer as jt
from singa_tpu_torch.models import transformer as tt

KW = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_len=48)
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def weights():
    jp = jt.init_lm(jax.random.PRNGKey(0), jt.TransformerConfig(**KW))
    np_params = {k: np.asarray(v) for k, v in jp.items()}
    return jp, tt.load_jax_params(np_params, "cpu")


@pytest.mark.parametrize("seq", [1, 7, 48])
def test_lm_apply_matches_jax(weights, seq):
    jp, tp = weights
    tokens = np.random.RandomState(seq).randint(0, 64, size=(2, seq))
    want = jax.jit(jt.lm_apply, static_argnums=2)(
        jp, jnp.asarray(tokens, jnp.int32), jt.TransformerConfig(**KW)
    )
    got = tt.lm_apply(tp, torch.from_numpy(tokens), tt.TransformerConfig(**KW))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("nq,cache", [(1, 16), (5, 24)])
def test_cache_attend_matches_jax(nq, cache):
    rs = np.random.RandomState(nq)
    q = rs.randn(2, 2, nq, 8).astype(np.float32)
    k = rs.randn(2, 2, cache, 8).astype(np.float32)
    v = rs.randn(2, 2, cache, 8).astype(np.float32)
    pos = np.stack([np.arange(nq) + 3, np.arange(nq) + cache - nq])
    want = jt.cache_attend(*map(jnp.asarray, (q, k, v)),
                           jnp.asarray(pos, jnp.int32))
    got = tt.cache_attend(*map(torch.from_numpy, (q, k, v)),
                          torch.from_numpy(pos.astype(np.int32)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_layernorm_uses_population_variance():
    """jnp.var is the population variance; torch's default is not."""
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    scale, bias = np.ones(4, np.float32), np.zeros(4, np.float32)
    want = jt._layernorm(jnp.asarray(x), jnp.asarray(scale),
                         jnp.asarray(bias))
    got = tt._layernorm(*map(torch.from_numpy, (x, scale, bias)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("plen,n,chunk", [(5, 20, None), (9, 16, 4),
                                          (1, 30, None)])
def test_generate_greedy_streams_match_jax(weights, plen, n, chunk):
    jp, tp = weights
    prompt = np.random.RandomState(plen).randint(0, 64, size=(2, plen))
    want = jax.jit(
        lambda p, t: jt.generate(p, t, jt.TransformerConfig(**KW), n,
                                 prefill_chunk=chunk)
    )(jp, jnp.asarray(prompt, jnp.int32))
    got = tt.generate(tp, torch.from_numpy(prompt),
                      tt.TransformerConfig(**KW), n, prefill_chunk=chunk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_temperature_is_deterministic_per_seed(weights):
    _, tp = weights
    cfg = tt.TransformerConfig(**KW)
    prompt = torch.tensor([[1, 2, 3]])

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return tt.generate(tp, prompt, cfg, 24, generator=g,
                           temperature=1.0).tolist()

    assert run(3) == run(3)
    assert run(3) != run(4)
    with pytest.raises(ValueError):
        tt.generate(tp, prompt, cfg, 4, temperature=1.0)


def test_params_round_trip_through_numpy(weights):
    jp, tp = weights
    back = tt.export_params(tp)
    assert set(back) == set(jp)
    for k, v in jp.items():
        np.testing.assert_array_equal(back[k], np.asarray(v))
        assert back[k].dtype == np.asarray(v).dtype


def test_init_lm_names_shapes_and_seed():
    cfg = tt.TransformerConfig(**KW)
    ref = jt.init_lm(jax.random.PRNGKey(0), jt.TransformerConfig(**KW))
    a = tt.init_lm(torch.Generator().manual_seed(7), cfg, "cpu")
    b = tt.init_lm(torch.Generator().manual_seed(7), cfg, "cpu")
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        k: tuple(v.shape) for k, v in ref.items()
    }
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("kw", [dict(moe_experts=2), dict(attn="flash")])
def test_unported_model_options_raise(kw):
    """attn="flash" still raises; moe_experts is ported, and init_lm
    gives the JAX package's names and shapes."""
    cfg = tt.TransformerConfig(**{**KW, **kw})
    if "moe_experts" in kw:
        ref = jt.init_lm(jax.random.PRNGKey(0),
                         jt.TransformerConfig(**{**KW, **kw}))
        got = tt.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: tuple(v.shape) for k, v in ref.items()}
        return
    with pytest.raises(NotImplementedError):
        tt.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
