"""kMoE on a seq axis, and with the seq, expert and model axes all three
(tests/test_torch_axes_pairs.py's bar: 4 steps at a capacity factor of
1 within 1e-4 of the JAX Trainer on the same mesh): data 2 x seq 4,
where kMoE routes the global batch with each data shard's whole
sequence gathered, and seq 2 x expert 2 x model 2 with kLayerPartition
(the psum form). A planted fault (each seq rank routing its own shard)
must exceed the bar 100 times.
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
from test_torch_moe_routing import _per_rank_routing, jax_on, port_on


@pytest.mark.parametrize("widths,kw", [
    ({"data": 2, "seq": 4}, dict(moe="psum")),
    ({"seq": 2, "expert": 2, "model": 2},
     dict(mode="ring", moe="psum", part=True)),
], ids=["data_seq_moe", "seq_expert_model"])
def test_moe_on_a_seq_axis_matches_jax_on_the_same_mesh(shard, widths, kw):
    text = lm_text(shard, cf=1.0, **kw)
    jl, params = jax_on(text, widths)
    tr = port_on(text, widths, params)
    assert {a: w for a, w in tr.mesh_shape.items() if w > 1} == widths
    close(losses_of(tr, 4), jl, LOSS_TOL)


def test_per_seq_rank_routing_exceeds_the_bar(shard, monkeypatch):
    text = lm_text(shard, moe="psum", cf=1.0)
    widths = {"data": 2, "seq": 4}
    jl, params = jax_on(text, widths)
    monkeypatch.setattr(t_seq.MoELayer, "crosses", _per_rank_routing)
    tr = port_on(text, widths, params)
    diff = float(np.max(np.abs(np.asarray(losses_of(tr, 4))
                               - np.asarray(jl))))
    assert diff > 100 * LOSS_TOL, diff
