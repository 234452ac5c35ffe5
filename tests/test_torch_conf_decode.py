"""The port's conf-net KV-cache decode (singa_tpu_torch/serve/conf_decode.py
and the layers' decode hooks) against the JAX package's NetDecoder, on
one set of numpy params.

The net is examples/lm/tinylm.conf narrowed to d_model 64 (4 heads x 16,
d_ff 128, vocab 256, 2 blocks) at float32 over 60-token sequences, so
the positional table holds 60 positions: not a multiple of the prefill
chunks 7 and 32, which exercises the cache's rounding up to a chunk
multiple. Params are drawn with numpy at scales that spread the logits
(std 1 embeddings, 1/sqrt(fan-in) matrices, a head 3x that): greedy
argmax then has no near-ties for float32 rounding to flip.

Tolerances: the last logits of every step within 1e-5 of the JAX
package's (float32, the same ops in another framework); greedy streams
identical, the bar ROADMAP's parity discipline sets.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.config import parse_model_config as j_parse
from singa_tpu.graph.builder import build_net as j_build_net
from singa_tpu.serve.conf_decode import NetDecoder as JNetDecoder
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.data import loader as t_loader
from singa_tpu_torch.graph.builder import build_net as t_build_net
from singa_tpu_torch.serve.conf_decode import NetDecoder, UnsupportedNet
from singa_tpu_torch.tools.generate import (
    generate_from_net,
    rolling_generate_from_net,
)
from singa_tpu_torch.trainer import params_from_numpy
from test_torch_zero import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
LM = REPO / "examples" / "lm"
SEQ = 60
LOGIT_TOL = 1e-5


def narrow_tinylm(shard: str) -> str:
    """examples/lm/tinylm.conf at d_model 64, d_ff 128, float32 (vocab,
    heads and depth as written)."""
    txt = (LM / "tinylm.conf").read_text()
    for old, new in (
        ("examples/lm/train_shard", shard),
        ("embedding_dim: 256", "embedding_dim: 64"),
        ("num_output: 1024", "num_output: 128"),
        ("num_output: 256 }", "num_output: 64 }"),  # the down projections
        ('compute_dtype: "bfloat16"', ""),
    ):
        assert old in txt, old
        txt = txt.replace(old, new)
    return txt


def spread_params(specs, seed=0) -> dict:
    """numpy params whose logits are well separated (module docstring)."""
    rs = np.random.RandomState(seed)
    out = {}
    for name, spec in sorted(specs.items()):
        shape = tuple(spec.shape)
        if name.endswith(("/tok", "/pos")):
            arr = rs.standard_normal(shape)
        elif name.endswith("/scale"):
            arr = 1.0 + 0.1 * rs.standard_normal(shape)
        elif len(shape) == 1:
            arr = 0.1 * rs.standard_normal(shape)
        else:
            arr = rs.standard_normal(shape) / np.sqrt(shape[0])
            if name.startswith("head/"):
                arr *= 3.0
        out[name] = arr.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    """(conf text, JAX net, JAX params, port net, port params)."""
    path = str(tmp_path_factory.mktemp("tokens") / "shard")
    t_loader.write_records(
        path, *t_loader.synthetic_token_arrays(4, seq_len=SEQ, vocab=256))
    txt = narrow_tinylm(path)
    jnet = j_build_net(j_parse(txt), "kTest")
    tnet = t_build_net(t_parse(txt), "kTest")
    arrays = spread_params(tnet.param_specs())
    jparams = {k: jnp.asarray(v) for k, v in arrays.items()}
    tparams = params_from_numpy(tnet, arrays)
    return txt, jnet, jparams, tnet, tparams


def prompt(n, seed=1):
    return [int(t) for t in np.random.RandomState(seed).randint(1, 256, n)]


def test_greedy_stream_and_every_steps_logits_match_jax(lm):
    """Greedy streams identical to the JAX NetDecoder's, and the last
    logits of every prefill chunk and decode step within LOGIT_TOL,
    teacher-forced on the JAX stream."""
    _, jnet, jparams, tnet, tparams = lm
    toks = prompt(20)
    jdec = JNetDecoder(jnet, max_prefill_chunk=7)
    tdec = NetDecoder(tnet, max_prefill_chunk=7)
    want = jdec.generate(jparams, toks, 24, 0.0, 0)
    got = tdec.generate(tparams, toks, 24, 0.0, 0)
    assert got == want
    jcaches, tcaches = jdec.init_caches(), tdec.init_caches("cpu")
    steps = [(c0, want[c0:min(c0 + 7, len(toks))])
             for c0 in range(0, len(toks), 7)]
    steps += [(p, [want[p]]) for p in range(len(toks), len(want) - 1)]
    worst = 0.0
    for pos, chunk in steps:
        q = 7 if pos < len(toks) else 1
        buf = np.zeros((1, q), np.int32)
        buf[0, :len(chunk)] = chunk
        jlast, jcaches = jdec._step(jparams, jnp.asarray(buf), jcaches,
                                    jnp.int32(pos), jnp.int32(len(chunk)))
        tlast = tdec._step_impl(tparams, torch.from_numpy(buf).long(),
                                tcaches, pos, len(chunk))
        np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast),
                                   atol=LOGIT_TOL, rtol=0)
        worst = max(worst, float(np.abs(tlast.numpy()
                                        - np.asarray(jlast)).max()))
    assert len(steps) == 3 + 23 and worst <= LOGIT_TOL


def test_chunk_sizes_give_one_stream_up_to_the_table_end(lm):
    """A prompt of max_positions - n tokens (52, a multiple of neither
    chunk) fills the table: chunk sizes 1, 7 and 32 give the same
    stream, the JAX one. With 32 the last chunk's window [32, 64) runs
    past the 60-position table, which only the rounded cache holds."""
    _, jnet, jparams, tnet, tparams = lm
    toks, n = prompt(SEQ - 8, seed=2), 8
    streams = {c: NetDecoder(tnet, max_prefill_chunk=c).generate(
        tparams, toks, n, 0.0, 0) for c in (1, 7, 32)}
    assert NetDecoder(tnet, max_prefill_chunk=32).cache_len == 64
    assert streams[1] == streams[7] == streams[32]
    assert streams[32] == JNetDecoder(jnet, max_prefill_chunk=32).generate(
        jparams, toks, n, 0.0, 0)
    assert len(streams[1]) == SEQ


def test_overflow_raises(lm):
    tnet, tparams = lm[3], lm[4]
    dec = NetDecoder(tnet, max_prefill_chunk=32)
    assert dec.max_positions == SEQ
    with pytest.raises(UnsupportedNet, match="positional table"):
        dec.generate(tparams, prompt(SEQ - 8), 9, 0.0, 0)


def test_conv_and_moe_nets_are_unsupported(tmp_path):
    """The graph checks, in the JAX package's order and words: a conv
    net stops at its first layer without a decode (the parser), a kMoE
    LM at its kMoE layer."""
    img = str(tmp_path / "img")
    t_loader.write_records(img, *t_loader.synthetic_arrays(8, seed=0))
    conv = (REPO / "examples" / "mnist" / "conv.conf").read_text()
    for field in ('"train_shard"', '"test_shard"'):
        assert field in conv, field
        conv = conv.replace(field, f'"{img}"')
    with pytest.raises(UnsupportedNet, match="kMnistImage"):
        NetDecoder(t_build_net(t_parse(conv), "kTrain"))
    tok = str(tmp_path / "tok")
    t_loader.write_records(
        tok, *t_loader.synthetic_token_arrays(4, seq_len=32, vocab=256))
    moe = (LM / "tinylm_moe.conf").read_text().replace(
        "examples/lm/train_shard", tok)
    with pytest.raises(UnsupportedNet, match="'b0_moe' \\(kMoE\\)"):
        NetDecoder(t_build_net(t_parse(moe), "kTest"))


def test_kv_path_equals_the_rolling_path(lm):
    """generate_from_net takes and reports the KV-cache path on tinylm;
    its stream equals the rolling decode's. Past the table it reports
    the rolling fallback and logs why."""
    _, _, _, tnet, tparams = lm
    toks = prompt(11, seed=3)
    info, logs = {}, []
    kv = generate_from_net(tnet, tparams, toks, 16, 0.0, 0, info=info,
                           log=logs.append)
    assert info == {"path": "kv_cache"} and not logs
    assert kv == rolling_generate_from_net(tnet, tparams, toks, 16, 0.0, 0)
    info = {}
    generate_from_net(tnet, tparams, toks, SEQ, 0.0, 0, info=info,
                      log=logs.append)
    assert info["path"] == "rolling"
    assert "falling back to rolling-buffer recompute" in logs[0]
