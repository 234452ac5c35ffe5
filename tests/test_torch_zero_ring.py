"""zero_update composed with the int8 ring (``kernels { grad_allreduce:
quantized_ring | q8_hier }``) in the port, on 4 CPU ranks.

A zero-sharded param takes its zero dim as the ring's chunk dim and
skips the allgather: the chunk rank r owns after the reduce-scatter is
its update shard, dequantized from the same bytes the ring alone would
allgather. So zero + ring must give the ring alone's losses, params,
slots and residuals to the bit, with every allgather byte of the
sharded params gone from the wire and the same quant_acc calls (the
reduce hops). The JAX package's own test of this composition fails
under jax 0.9 (it reads ``jax.core.ClosedJaxpr``; ROADMAP §3), so the
ring alone is the oracle here; the refusals are held to the JAX
Trainer's words.
"""

import jax
import pytest
import torch

from singa_tpu.config import parse_model_config as j_parse
from singa_tpu.config.schema import ConfigError as JConfigError
from singa_tpu.parallel import apply_grad_comm_tag as j_tag
from singa_tpu.parallel import build_mesh as j_mesh
from singa_tpu.trainer import Trainer as JTrainer
from singa_tpu_torch.config import ConfigError
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.ops import quantized_collective as tq
from singa_tpu_torch.parallel import apply_grad_comm_tag, is_residual_key
from singa_tpu_torch.parallel import build_mesh
from singa_tpu_torch.trainer import Trainer
from test_torch_zero import (  # noqa: F401
    lm_conf, losses, mlp_conf, one_torch_thread, same, shards)

N = 4


def t_trainer(txt, tag, n=N):
    """The port's Trainer on n CPU ranks with a grad_comm tag and 4
    buckets (bench.py's lm_d128_q8* form)."""
    cfg = t_parse(txt)
    apply_grad_comm_tag(cfg, tag)
    cfg.grad_comm.buckets = 4
    return Trainer(cfg, mesh=build_mesh(n, 1, ["cpu"] * n), seed=3,
                   log=lambda s: None)


def residuals(tr):
    return {k: v for k, v in tr.buffers.items() if is_residual_key(k)}


@pytest.fixture
def count_quant_acc(monkeypatch):
    calls = [0]
    real = tq.quant_acc

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    monkeypatch.setattr(tq, "quant_acc", counted)
    return calls


@pytest.mark.parametrize("tag", ["q8wire", "q8hier"])
def test_zero_ring_equals_the_ring_alone_to_the_bit(shards, tag,
                                                    count_quant_acc):
    """4 ranks, 3 steps: zero + ring and the ring alone give equal
    losses, params, slots and residuals, with the same quant_acc calls;
    the zero run sends exactly its model's bytes, the reduce phase's
    alone."""
    tz = t_trainer(lm_conf(shards, True), tag)
    tr = t_trainer(lm_conf(shards, False), tag)
    assert tz.update_mode == "zero" and tz.grad_wire_impl == tr.grad_wire_impl
    assert not any(tz._ring_gather.values())
    assert tz._ring_chunk_dims == tr._ring_chunk_dims
    sent, calls = [], []
    for tr_ in (tz, tr):
        tq.ppermute.sent_bytes.clear()
        count_quant_acc[0] = 0
        losses_ = losses(tr_, 3)
        sent.append(sum(tq.ppermute.sent_bytes.values()) // (3 * N))
        calls.append(count_quant_acc[0])
        tr_.run_losses = losses_
    assert tz.run_losses == tr.run_losses
    assert same(tz.params, tr.params)
    assert same(residuals(tz), residuals(tr))
    for nm in tr.state:
        assert same(tz.state[nm], tr.state[nm]), nm
    assert calls[0] == calls[1] > 0
    assert sent[0] == tz.modeled_wire_bytes_per_step()
    assert sent[1] == tr.modeled_wire_bytes_per_step()
    assert sent[0] < sent[1]


def test_allgather_is_skipped_for_zero_params_only(shards):
    """The MLP on 2 ranks with zero and the flat ring: every param is
    zero-sharded, so the ring returns each rank its own reduced chunk
    (the update shard), and nothing rides an allgather; the model
    without zero counts the allgather in."""
    tz = t_trainer(mlp_conf(shards, True), "q8wire", n=2)
    grads = {nm: torch.randn(p.shape, generator=torch.Generator()
                             .manual_seed(i))
             for i, (nm, p) in enumerate(tz.params.items())}
    res = {k: torch.zeros_like(v) for k, v in residuals(tz).items()}
    tq.ppermute.sent_bytes.clear()
    out, _ = tz._ring_reduce_probe(grads, res)
    for r in range(2):
        for nm, g in grads.items():
            d = tz._zero_dims[nm]
            assert out[r][nm].shape == g.chunk(2, dim=d)[r].shape, nm
    assert sum(tq.ppermute.sent_bytes.values()) // 2 == \
        tz.modeled_wire_bytes_per_step()
    sizes = {nm: g.numel() for nm, g in grads.items()}
    buckets = tz._buckets(sizes)
    assert tz.modeled_wire_bytes_per_step() * 2 == tq.modeled_wire_bytes(
        sizes, buckets, 2)
    model = tz.wire_bytes_model()
    assert model["reference"] * 2 == tq.reference_wire_bytes(sizes, 2)


def test_refusals_match_the_jax_trainer(shards):
    """A param whose zero dim is None (the MLP's (10,) bias on 4 ranks)
    keeps chunk dim 0, which the ring cannot cut: both packages refuse
    with one message. The named-axes q8_hier form with zero is refused
    by both Trainers with one message, on the same (data, model) mesh."""
    jcfg = j_parse(mlp_conf(shards, True))
    j_tag(jcfg, "q8wire")
    with pytest.warns(UserWarning), pytest.raises(JConfigError) as jerr:
        JTrainer(jcfg, None, mesh=j_mesh(N, 1, jax.devices()[:N]), seed=3,
                 log=lambda s: None, prefetch=False)
    with pytest.warns(UserWarning), pytest.raises(ConfigError) as terr:
        t_trainer(mlp_conf(shards, True), "q8wire")
    assert str(terr.value) == str(jerr.value)
    assert "'fc2/bias' dim 0 (10)" in str(terr.value)
    named = '\nring { intra_axis: "data" inter_axis: "model" }'
    jcfg = j_parse(lm_conf(shards, True) + named)
    j_tag(jcfg, "q8hier")
    with pytest.raises(JConfigError, match="does not compose with "
                       "zero_update") as jerr:
        JTrainer(jcfg, None, mesh=j_mesh(2, 2, jax.devices()[:4]), seed=3,
                 log=lambda s: None, prefetch=False)
    tcfg = t_parse(lm_conf(shards, True) + named)
    apply_grad_comm_tag(tcfg, "q8hier")
    with pytest.raises(ConfigError, match="intra_axis/inter_axis") as terr:
        Trainer(tcfg, mesh=build_mesh(2, 2, ["cpu"] * 4), seed=3,
                log=lambda s: None)
    assert str(terr.value) == str(jerr.value)
