"""The seq or expert axis beside a kLayerPartition model axis
(singa_tpu_torch/layers/sequence.py ``AttentionLayer._model_ranks``:
each seq shard's heads from its model ranks' ``qkv`` shards, the seq
group's attention over them, each shard's output from its model ranks'
``out`` shards).

Each mesh trains the axes LM 4 steps and is held to the JAX Trainer on
the same mesh within 1e-4: data 2 x seq 2 x model 2 with ring attention
and with the gathered flash mode, and data 2 x expert 2 x model 2 with
kMoE's psum form at a capacity factor of 1. A planted fault (Concate in
reversed rank order) must exceed the bar 100 times.
"""

import numpy as np
import pytest

from singa_tpu_torch.layers import sequence as t_seq
from test_torch_axes_seq import (
    LOSS_TOL,
    close,
    lm_text,
    losses_of,
    one_torch_thread,  # noqa: F401 (autouse)
    shard,  # noqa: F401 (fixture)
)
from test_torch_moe_routing import jax_on, port_on

SP_TP = {"data": 2, "seq": 2, "model": 2}


@pytest.mark.parametrize("widths,kw", [
    (SP_TP, dict(mode="ring")),
    (SP_TP, dict(mode="flash")),
    ({"data": 2, "expert": 2, "model": 2}, dict(moe="psum", cf=1.0)),
], ids=["seq_model_ring", "seq_model_flash", "expert_model"])
def test_model_beside_seq_or_expert_matches_jax(shard, widths, kw):
    text = lm_text(shard, part=True, **kw)
    jl, params = jax_on(text, widths)
    tr = port_on(text, widths, params)
    assert tr._layout["attn/qkv"] == (1, "model")
    close(losses_of(tr, 4), jl, LOSS_TOL)


def test_reversed_concate_beside_seq_exceeds_the_bar(shard, monkeypatch):
    text = lm_text(shard, part=True, mode="ring")
    jl, params = jax_on(text, SP_TP)
    monkeypatch.setattr(t_seq, "concate",
                        lambda parts, dim: t_seq.torch.cat(parts[::-1], dim))
    tr = port_on(text, SP_TP, params)
    diff = float(np.max(np.abs(np.asarray(losses_of(tr, 4))
                               - np.asarray(jl))))
    assert diff > 100 * LOSS_TOL, diff
