"""The port's pipe axis (singa_tpu_torch/parallel/pipeline.py's GPipe
schedule, graph/pipeline_plan.py's stages) and the 3-axis mesh, against
the JAX package.

``pipeline_apply`` is held to the JAX ``pipeline_apply`` (shard_map over
the suite's virtual CPU devices) on (pipe 2) and (data 2, pipe 2):
outputs and gradients within 1e-5. The JAX Trainer's staged run gives
wrong losses on this image (tests/test_parallel_conf.py's pp and 3-axis
tests are xfails), so the staged confs are held to the JAX Trainer's
UNSTAGED single-device run of the same conf and params, the math the
schedule must equal: the pp conf on data 4 x pipe 2 and the 3-axis conf
on data 2 x pipe 2 x model 2 (kLayerPartition inside the stages, with an
FFN width the model axis does not divide), 4 steps within 1e-4. A hop
one tick late must move the losses past the bar. ``plan_stages``
refuses with the JAX package's messages, and the conf-net decode
refuses a staged net.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.config import parse_model_config as j_parse
from singa_tpu.graph.builder import build_net as j_build_net
from singa_tpu.graph.pipeline_plan import plan_stages as j_plan
from singa_tpu.parallel.pipeline import build_pp_mesh
from singa_tpu.parallel.pipeline import pipeline_apply as j_pipeline
from singa_tpu_torch.config import ConfigError
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.graph.builder import build_net as t_build_net
from singa_tpu_torch.graph.pipeline_plan import (
    pipeline_forward_region,
    plan_stages,
)
from singa_tpu_torch.parallel import pipeline as t_pipe
from singa_tpu_torch.serve.conf_decode import NetDecoder, UnsupportedNet
from test_torch_axes_seq import (
    LOSS_TOL,
    OP_TOL,
    close,
    cluster,
    jax_run,
    lm_text,
    losses_of,
    one_torch_thread,  # noqa: F401 (autouse)
    port_trainer,
    shard,  # noqa: F401 (fixture)
)

PP = "nworkers: 8\nnprocs_per_group: 2\nnpipes_per_group: 2"
THREE = "nworkers: 8\nnprocs_per_group: 4\nnpipes_per_group: 2"


def _stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _t_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


@pytest.mark.parametrize("ndata", [1, 2])
def test_pipeline_apply_matches_jax(ndata):
    rng = np.random.default_rng(ndata)
    params = {"w": (0.5 * rng.standard_normal((2, 8, 8))).astype(np.float32),
              "b": rng.standard_normal((2, 8)).astype(np.float32)}
    x = rng.standard_normal((4, 4, 8)).astype(np.float32)
    w = rng.standard_normal((4, 4, 8)).astype(np.float32)
    mesh = build_pp_mesh(ndata, 2, jax.devices()[:2 * ndata])

    def jloss(p, x):
        y = j_pipeline(_stage, p, x, mesh)
        return jnp.sum(y * w), y

    (_, jy), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, x)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    ty = t_pipe.pipeline_apply(_t_stage, tp, tx, 2)
    (ty * torch.tensor(w)).sum().backward()
    close(ty.detach(), jy, OP_TOL)
    close(tx.grad, jg[1], OP_TOL)
    for k in params:
        close(tp[k].grad, jg[0][k], OP_TOL)


def pp_text(shard, up=64):
    return lm_text(shard, stages=True, nmicro=4, batch=16, part=True,
                   up=up)


@pytest.fixture(scope="module")
def unstaged_ref(shard):
    """The JAX Trainer's unstaged single-device runs (no pipe axis: the
    plain forward), FFN width 64 and 33."""
    return {up: jax_run(pp_text(shard, up)) for up in (64, 33)}


def test_region_on_one_lane_is_the_plain_forward(shard, unstaged_ref):
    """pipeline_forward_region (the staged region on one lane) equals the
    layers run in order."""
    _, params = unstaged_ref[64]
    net = t_build_net(t_parse(pp_text(shard)))
    plan = plan_stages(net, 2, 4)
    p = {n: torch.tensor(v) for n, v in params.items()}
    x = torch.randn(8, 16, 32, generator=torch.Generator().manual_seed(0))
    acts = {"embed": x}
    for layer in net.layers:
        if layer.cfg.locationid is not None:
            acts[layer.name] = layer.apply(
                p, [acts[s] for s in layer.srclayers], training=True)
    close(pipeline_forward_region(plan, p, x), acts["b1_res2"], OP_TOL)


@pytest.mark.parametrize("text,up", [(PP, 64), (THREE, 33)],
                         ids=["pp_data4_pipe2", "data2_pipe2_model2"])
def test_staged_confs_match_jax_unstaged_single_device(shard, unstaged_ref,
                                                       text, up):
    jl, params = unstaged_ref[up]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tr = port_trainer(pp_text(shard, up), cluster(text), params)
    plan = tr.train_net.pipeline_plan
    assert (plan.nstages, plan.nmicro) == (2, 4)
    if up == 33:
        assert tr.mesh.shape == {"data": 2, "pipe": 2, "expert": 1,
                                 "seq": 1, "model": 2}
        assert any("storage pads to 34" in str(w.message) for w in caught)
    close(losses_of(tr, 4), jl, LOSS_TOL)


def test_a_hop_one_tick_late_exceeds_the_bar(shard, unstaged_ref,
                                             monkeypatch):
    jl, params = unstaged_ref[64]
    monkeypatch.setattr(t_pipe, "_hop", lambda sent, t: sent[max(t - 2, 0)])
    tr = port_trainer(pp_text(shard), cluster(PP), params)
    diff = float(np.max(np.abs(np.asarray(losses_of(tr, 2))
                               - np.asarray(jl[:2]))))
    assert diff > 100 * LOSS_TOL, diff


def _plan_error(build, parse, plan, text):
    net = build(parse(text))
    try:
        plan(net, 2, 4)
    except Exception as e:  # noqa: BLE001 (both packages' ConfigError)
        return str(e)
    return None


@pytest.mark.parametrize("old,new", [
    ('srclayers: "b0_res2"\n    srclayers: "b1_attn"',
     'srclayers: "embed"\n    srclayers: "b1_attn"'),
    ("locationid: 1 ", "locationid: 2 "),
    ('locationid: 1 name: "b1_up"', 'name: "b1_up"'),
], ids=["cross_stage_tap", "stage_ids", "contiguity"])
def test_plan_refusals_match_jax(shard, old, new):
    text = pp_text(shard)
    assert old in text
    text = text.replace(old, new)
    want = _plan_error(j_build_net, j_parse, j_plan, text)
    assert want is not None
    assert _plan_error(t_build_net, t_parse, plan_stages, text) == want


def test_microbatches_must_divide_each_data_ranks_batch(shard):
    with pytest.raises(ConfigError, match="not divisible by 3 "
                       "microbatches"):
        port_trainer(lm_text(shard, stages=True, nmicro=3, batch=16),
                     cluster(PP), jax_run(lm_text(shard, stages=True,
                                                  batch=16), 0)[1])


def test_conf_decode_refuses_a_staged_net(shard, unstaged_ref):
    tr = port_trainer(pp_text(shard), cluster(PP), unstaged_ref[64][1])
    with pytest.raises(UnsupportedNet, match="pipeline-staged"):
        NetDecoder(tr.train_net)
