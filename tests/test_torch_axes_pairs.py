"""Two and three of the seq, expert and model axes together, and kMoE on
a seq axis (singa_tpu_torch/trainer/trainer.py ``AXIS_SETS`` and
``SEQ_LAYERS``; ``MoELayer.apply_ranks``).

On a seq axis kMoE routes what the JAX program routes: without an
expert axis the global batch, each data shard with its whole sequence
gathered (seq shards in position order); over an expert axis the psum
form's data shard with its whole sequence, or the all-to-all form's
(data x expert) shard. Each mesh trains the axes LM 4 steps at a
capacity factor of 1 (queues overflow) and is held to the JAX Trainer
on the same mesh within 1e-4: seq 2 x expert 2 (ring attention, both
dispatch forms); tests/test_torch_axes_pairs_moe.py holds data 2 x seq
4 and seq 2 x expert 2 x model 2 with kLayerPartition, and the planted
fault. The pairs with pipe that the JAX package cannot run are refused
with its reason.
"""

import pytest

from singa_tpu_torch.config import ConfigError
from test_torch_axes_seq import (
    LOSS_TOL,
    close,
    lm_text,
    losses_of,
    one_torch_thread,  # noqa: F401 (autouse)
    shard,  # noqa: F401 (fixture)
)
from test_torch_moe_routing import cluster_text, jax_on, port_on

SP_EP = {"seq": 2, "expert": 2}


@pytest.mark.parametrize("widths,kw", [
    (SP_EP, dict(mode="ring", moe="psum")),
    (SP_EP, dict(mode="ring", moe="alltoall")),
], ids=["seq_expert_psum", "seq_expert_alltoall"])
def test_the_axes_together_match_jax_on_the_same_mesh(shard, widths, kw):
    text = lm_text(shard, cf=1.0, **kw)
    jl, params = jax_on(text, widths)
    tr = port_on(text, widths, params)
    assert {a: w for a, w in tr.mesh_shape.items() if w > 1} == widths
    close(losses_of(tr, 4), jl, LOSS_TOL)


@pytest.mark.parametrize("widths,kw,why", [
    ({"seq": 2, "pipe": 2}, dict(mode="ring", stages=True),
     "The context mesh .* should match the mesh passed to shard_map"),
    ({"expert": 2, "pipe": 2}, dict(stages=True),
     "its auxiliary loss has no path out of the pipeline region"),
], ids=["seq_pipe", "expert_pipe"])
def test_pipe_pairs_jax_cannot_run_are_refused_with_its_reason(
        shard, widths, kw, why):
    from test_torch_axes_seq import cluster, port_trainer

    with pytest.raises(ConfigError, match="cannot run it either.*" + why):
        port_trainer(lm_text(shard, **kw), cluster(cluster_text(widths)),
                     {})
