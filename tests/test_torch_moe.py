"""kMoE's dense path in the port (singa_tpu_torch/parallel/moe.py,
layers/sequence.MoELayer, Net.forward's aux-loss channel) against the
JAX package's ``moe_ffn_dense``, MoELayer and Trainer.

Inputs are made with numpy from a seed and handed to both packages.

Tolerances:
- the index form (the main path) against the dense plain form (the JAX
  form, kept as the plain version): the forward to the bit, the expert
  weights' gradients to the bit, the gate's and x's gradients within
  1e-6 of their largest entry (their dot products over D sum in
  another order);
- against JAX at float32: y and aux within 1e-6, gradients (jax.grad)
  within 1e-5;
- under bf16 compute (x and the weights cast to bf16; routing and the
  experts run in float32, as JAX promotes them): aux within 1e-6, and y
  and the gradients, which are bf16 values, within one bf16 rounding
  (2^-8 relative) of JAX's;
- 5 Trainer steps of a narrowed tinylm_moe.conf within 1e-4 of the JAX
  Trainer's losses at float32, within 2^-8 relative under bf16.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.config import parse_model_config as j_parse
from singa_tpu.parallel import build_mesh
from singa_tpu.parallel import moe as jm
from singa_tpu.trainer import Trainer as JTrainer
from singa_tpu_torch.config import ConfigError
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.data import loader as t_loader
from singa_tpu_torch.graph.builder import build_net as t_build_net
from singa_tpu_torch.parallel import moe as tm
from singa_tpu_torch.trainer import Trainer, params_from_numpy

REPO = pathlib.Path(__file__).resolve().parent.parent
CONF = REPO / "examples" / "lm" / "tinylm_moe.conf"
B, S, D, E, F = 4, 16, 32, 4, 64
BF16_RTOL = 2.0 ** -8


def inputs(seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, S, D).astype(np.float32)
    p = {
        "gate": (rs.randn(D, E) * 0.5).astype(np.float32),
        "up": (rs.randn(E, D, F) / np.sqrt(D)).astype(np.float32),
        "down": (rs.randn(E, F, D) / np.sqrt(F)).astype(np.float32),
    }
    dy = rs.randn(B, S, D).astype(np.float32)
    return x, p, dy


def torch_run(fn, x, p, dy, cf, dtype=torch.float32):
    """fn's (y, aux) and the grads of sum(y * dy) + aux w.r.t. float32
    x and params, cast to ``dtype`` inside (as the Net casts params)."""
    tx = torch.tensor(x, requires_grad=True)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    y, aux = fn(tx.to(dtype), {k: v.to(dtype) for k, v in tp.items()}, cf)
    ((y.float() * torch.from_numpy(dy)).sum() + aux).backward()
    return (y.detach().float().numpy(), aux.detach().numpy(),
            {"x": tx.grad.numpy(), **{k: v.grad.numpy() for k, v in
                                     tp.items()}})


def jax_run(x, p, dy, cf, dtype=jnp.float32):
    def f(x, p):
        y, aux = jm.moe_ffn_dense(
            x.astype(dtype), {k: v.astype(dtype) for k, v in p.items()}, cf)
        return (y.astype(jnp.float32) * dy).sum() + aux, (y, aux)

    (_, (y, aux)), (gx, gp) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    return (np.asarray(y.astype(jnp.float32)), np.asarray(aux),
            {"x": np.asarray(gx), **{k: np.asarray(v) for k, v in
                                    gp.items()}})


def drops(x, p, cf):
    """Tokens dropped to the residual at capacity factor cf."""
    x2d = torch.from_numpy(x).reshape(-1, D)
    _, onehot, _, pos = tm._probs_and_choice(x2d, torch.from_numpy(
        p["gate"]))
    return int((pos >= tm.capacity_of(len(x2d), E, cf)).sum())


@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_index_form_equals_the_dense_plain_form(cf):
    x, p, dy = inputs()
    assert (drops(x, p, cf) > 0) == (cf == 0.5)
    y, aux, g = torch_run(tm.moe_ffn_dense, x, p, dy, cf)
    y0, aux0, g0 = torch_run(tm.moe_ffn_dense_plain, x, p, dy, cf)
    np.testing.assert_array_equal(y, y0)
    np.testing.assert_array_equal(aux, aux0)
    for k in ("up", "down"):
        np.testing.assert_array_equal(g[k], g0[k], err_msg=k)
    for k in ("x", "gate"):
        np.testing.assert_allclose(
            g[k], g0[k], atol=1e-6 * np.abs(g0[k]).max(), rtol=0,
            err_msg=k)


def test_dropping_the_capacity_mask_breaks_that_equality(monkeypatch):
    """A planted fault: the index form without the capacity mask (the
    over-capacity tokens spill into the next expert's places, clamped
    into the buffer) no longer equals the plain form."""
    x, p, dy = inputs()
    monkeypatch.setattr(
        tm, "_slots", lambda expert, pos, c, e: (
            expert * c + pos.long()).clamp(max=e * c))
    y, _, _ = torch_run(tm.moe_ffn_dense, x, p, dy, 0.5)
    y0, _, _ = torch_run(tm.moe_ffn_dense_plain, x, p, dy, 0.5)
    assert np.abs(y - y0).max() > 1e-3


@pytest.mark.parametrize("form", ["index", "plain"])
@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_matches_jax_moe_ffn_dense_at_float32(form, cf):
    fn = tm.moe_ffn_dense if form == "index" else tm.moe_ffn_dense_plain
    x, p, dy = inputs(1)
    y, aux, g = torch_run(fn, x, p, dy, cf)
    jy, jaux, jg = jax_run(x, p, dy, cf)
    np.testing.assert_allclose(y, jy, atol=1e-6, rtol=0)
    np.testing.assert_allclose(aux, jaux, atol=1e-6, rtol=0)
    for k in g:
        np.testing.assert_allclose(g[k], jg[k], atol=1e-5, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("form", ["index", "plain"])
@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_matches_jax_moe_ffn_dense_under_bf16_compute(form, cf):
    fn = tm.moe_ffn_dense if form == "index" else tm.moe_ffn_dense_plain
    x, p, dy = inputs(2)
    y, aux, g = torch_run(fn, x, p, dy, cf, torch.bfloat16)
    jy, jaux, jg = jax_run(x, p, dy, cf, jnp.bfloat16)
    np.testing.assert_allclose(aux, jaux, atol=1e-6, rtol=0)
    np.testing.assert_allclose(y, jy, atol=1e-6, rtol=BF16_RTOL)
    for k in g:
        np.testing.assert_allclose(
            g[k], jg[k], atol=1e-6 + BF16_RTOL * np.abs(jg[k]).max(),
            rtol=0, err_msg=k)


def test_experts_run_in_float32_under_bf16():
    """The experts must not run in bf16: y under bf16 compute equals the
    float32 computation on the bf16-rounded inputs, rounded once."""
    x, p, dy = inputs(3)
    xb = torch.from_numpy(x).bfloat16()
    pb = {k: torch.from_numpy(v).bfloat16() for k, v in p.items()}
    y, _ = tm.moe_ffn_dense(xb, pb, 1.25)
    y32, _ = tm.moe_ffn_dense(xb.float(), {k: v.float() for k, v in
                                           pb.items()}, 1.25)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, y32.bfloat16())


def test_no_host_sync_ops_in_the_index_form():
    """The index form stays graph-capturable: static shapes, and no
    nonzero(), masked indexing or reads back to the host."""
    import inspect

    src = inspect.getsource(tm.moe_ffn_dense) + inspect.getsource(
        tm._probs_and_choice) + inspect.getsource(tm._slots)
    for bad in (".item(", "nonzero", ".tolist(", "masked_select",
                ".cpu()", "int(t"):
        assert bad not in src, bad


# ---------------------------------------------------------------------------
# the layer and the slice as a whole
# ---------------------------------------------------------------------------


def narrow_conf(shard: str, dtype: str = "") -> str:
    """tinylm_moe.conf at d_model 32, 2 heads, 4 experts, d_ff 64, batch
    4, float32 unless ``dtype`` (vocab and depth as written)."""
    txt = CONF.read_text()
    for old, new in (
        ("examples/lm/train_shard", shard),
        ("batchsize: 64", "batchsize: 4"),
        ("embedding_dim: 256", "embedding_dim: 32"),
        ("num_heads: 4", "num_heads: 2"),
        ("num_experts: 8 d_ff: 1024", "num_experts: 4 d_ff: 64"),
        ('compute_dtype: "bfloat16"',
         f'compute_dtype: "{dtype}"' if dtype else ""),
    ):
        assert old in txt, old
        txt = txt.replace(old, new)
    return txt


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("moe_tokens") / "shard")
    t_loader.write_records(
        path, *t_loader.synthetic_token_arrays(16, seq_len=64, vocab=256))
    return path


def step_loss(tr, step):
    tr.train_one_batch(step)
    loss = tr.perf.avg()["loss"]["loss"]
    tr.perf.reset()
    return loss


def test_moe_layer_declares_the_jax_params(shard):
    from singa_tpu.graph.builder import build_net as j_build_net

    jnet = j_build_net(j_parse(narrow_conf(shard)))
    tnet = t_build_net(t_parse(narrow_conf(shard)))
    jspecs, tspecs = jnet.param_specs(), tnet.param_specs()
    assert list(tspecs) == list(jspecs)
    for n, spec in tspecs.items():
        assert spec.shape == jspecs[n].shape, n
        assert spec.fan_in == jspecs[n].fan_in, n
    moe = tnet.name2layer["b0_moe"]
    assert moe.has_aux_loss and moe.aux_weight == pytest.approx(0.01)


def test_net_forward_adds_the_aux_loss(shard):
    """Net.forward's total loss is kLMLoss's plus aux_weight x each
    kMoE's aux, as in the JAX Net."""
    tnet = t_build_net(t_parse(narrow_conf(shard)))
    from singa_tpu_torch.params import init_params

    params = init_params(torch.Generator().manual_seed(0),
                         tnet.param_specs())
    dl = tnet.datalayers[0]
    batch = {dl.name: {"image": torch.from_numpy(dl.images[:4]),
                       "label": torch.from_numpy(dl.labels[:4])}}
    total, metrics, acts = tnet.forward(params, batch, training=True,
                                        return_acts=True)
    auxes = []
    for name in ("b0_moe", "b1_moe"):
        layer = tnet.name2layer[name]
        _, aux = layer.apply(tnet.resolve_params(params),
                             [acts[layer.srclayers[0]]], training=True)
        auxes.append(aux)
    want = metrics["loss"]["loss"] + 0.01 * auxes[0] + 0.01 * auxes[1]
    assert float(total) == pytest.approx(float(want), abs=1e-7)
    assert float(total) > float(metrics["loss"]["loss"])


def test_dispatch_is_validated(shard):
    txt = narrow_conf(shard).replace(
        "aux_loss_weight: 0.01 }", 'aux_loss_weight: 0.01 dispatch: "x" }',
        1)
    with pytest.raises(ConfigError, match="dispatch"):
        t_build_net(t_parse(txt))


@pytest.mark.parametrize("dtype", ["", "bfloat16"])
def test_trainer_matches_jax_trainer_over_five_steps(shard, dtype):
    """5 steps of the narrowed conf from the JAX init's params on the
    same batches: losses within 1e-4 at float32; as the conf is written
    (bf16 compute), within one bf16 rounding of the loss (2^-8
    relative): the two packages round their bf16 activations after
    float32 sums in other orders."""
    jt = JTrainer(j_parse(narrow_conf(shard, dtype)),
                  mesh=build_mesh(1, 1, jax.devices()[:1]), seed=0,
                  log=lambda s: None, prefetch=False)
    tt = Trainer(t_parse(narrow_conf(shard, dtype)), seed=0,
                 log=lambda s: None, device="cpu")
    tt.params = params_from_numpy(
        tt.train_net, {n: np.asarray(v) for n, v in jt.params.items()})
    losses = [(step_loss(jt, s), step_loss(tt, s)) for s in range(5)]
    for j, t in losses:
        assert abs(j - t) <= (BF16_RTOL * abs(j) if dtype else 1e-4), losses
    assert losses[-1][1] < losses[0][1]


def test_an_expert_axis_is_refused_by_name(shard, tmp_path):
    """(Named for the refusal it held until the expert axis crossed
    processes.) The expert axis splits the expert weights over its
    ranks, and across processes each expert rank's partial outputs reach
    the other through kMoE's exchange: data 1 x expert 2 as 2 processes
    of one rank each, through ``main``, ends with the digest of one
    process holding both ranks, bitwise."""
    from test_torch_axes_span_seq import check_axes, one_run
    from test_torch_model_span_trainer import span_launch

    lines = "nworkers: 2\nnprocs_per_group: 2\nnexperts_per_group: 2"
    text = narrow_conf(shard).replace("train_steps: 2000", "train_steps: 3")
    reports = span_launch(tmp_path, text, 2, lines)
    one = one_run(text, lines, 2, tmp_path)
    assert one.mesh.widths["expert"] == 2
    assert one._layout["b0_moe/up"] == (0, "expert")
    check_axes(reports, 2, one.digest(), exchanged=True, steps=3)
