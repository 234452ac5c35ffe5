"""BatchNorm in the port against the JAX package: ``ops/norm.py``
(the training ops' hand-written backward, the sampled op, the eval op,
the anchored one-pass moments and the cancellation rescue), the
kBatchNorm and kGlobalPooling layers, and the running stats as buffers
on every Trainer path: the eager step, the graphed step and chunk, eval
(graphed or not) and checkpoints in both packages' npz format.

The Trainer tests run a small conf (conv -> kBatchNorm -> kReLU ->
kGlobalPooling -> kInnerProduct -> kBatchNorm (2-D) -> kSoftmaxLoss)
over synthetic MNIST-shaped shards at float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import ops as j_ops
from singa_tpu.config import parse_model_config as j_parse
from singa_tpu.parallel import build_mesh as j_build_mesh
from singa_tpu.trainer import Trainer as JTrainer
from singa_tpu.trainer.checkpoint import save_checkpoint as j_save
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.config.schema import ConfigError
from singa_tpu_torch.data import loader as t_loader
from singa_tpu_torch.graph.builder import build_net as t_build_net
from singa_tpu_torch.layers.norm import GlobalPoolingLayer
from singa_tpu_torch.ops import norm as t_norm
from singa_tpu_torch.parallel import build_mesh
from singa_tpu_torch.trainer import Trainer, params_from_numpy
from singa_tpu_torch.trainer.checkpoint import save_checkpoint

TOL = dict(atol=1e-5, rtol=1e-5)
SHAPES = [(16, 6), (4, 5, 6, 6)]


def _data(shape, seed, offset=0.0):
    rs = np.random.RandomState(seed)
    c = shape[1]
    x = (rs.randn(*shape) + offset).astype(np.float32)
    gamma = (1.0 + 0.3 * rs.randn(c)).astype(np.float32)
    beta = (0.2 * rs.randn(c)).astype(np.float32)
    dy = rs.randn(*shape).astype(np.float32)
    shift = (0.5 * rs.randn(c)).astype(np.float32)
    return x, gamma, beta, dy, shift


def _both(op_j, op_t, arrays, cotangents):
    """Forward outputs and the grads of the first three inputs of both
    packages' op under the cotangents ``cotangents`` (one per output)."""
    def loss_j(*a):
        outs = op_j(*a)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cotangents)), outs

    (_, jouts), jgrads = jax.value_and_grad(
        loss_j, argnums=(0, 1, 2), has_aux=True)(
            *[jnp.asarray(a) for a in arrays])
    ts = [torch.from_numpy(a.copy()).requires_grad_(i < 3)
          for i, a in enumerate(arrays)]
    touts = op_t(*ts)
    sum((o * torch.from_numpy(c)).sum()
        for o, c in zip(touts, cotangents)).backward()
    return ([np.asarray(o) for o in jouts], [np.asarray(g) for g in jgrads],
            [o.detach().numpy() for o in touts],
            [t.grad.numpy() for t in ts[:3]])


def _assert_all(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, err_msg=f"{what} {i}", **TOL)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("anchored", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_batch_norm_train_and_grads_match_jax(shape, anchored):
    """y, mean, var and the grads of x, gamma and beta with the mean/var
    outputs unused (their cotangents zero, as in training)."""
    x, gamma, beta, dy, shift = _data(shape, 0, offset=1.5)
    arrays = [x, gamma, beta] + ([shift] if anchored else [])
    c = shape[1]
    cts = [dy, np.zeros(c, np.float32), np.zeros(c, np.float32)]
    jo, jg, to, tg = _both(
        lambda x, g, b, *s: j_ops.batch_norm_train(x, g, b, 1e-5, *s),
        lambda x, g, b, *s: t_norm.batch_norm_train(x, g, b, 1e-5, *s),
        arrays, cts)
    _assert_all(to, jo, "output")
    _assert_all(tg, jg, "grad")


@pytest.mark.parametrize("shape", SHAPES)
def test_mean_var_cotangents_match_jax(shape):
    """Nonzero cotangents on the mean and var outputs: the backward's
    dmean/n + 2*dvar*(x - mean)/n terms."""
    x, gamma, beta, dy, shift = _data(shape, 1)
    rs = np.random.RandomState(2)
    c = shape[1]
    cts = [dy, rs.randn(c).astype(np.float32) * 3,
           rs.randn(c).astype(np.float32) * 0.5]
    jo, jg, to, tg = _both(
        lambda x, g, b, s: j_ops.batch_norm_train(x, g, b, 1e-5, shift=s),
        lambda x, g, b, s: t_norm.batch_norm_train(x, g, b, 1e-5, shift=s),
        [x, gamma, beta, shift], cts)
    _assert_all(to, jo, "output")
    _assert_all(tg, jg, "grad")


@pytest.mark.parametrize("shape", [(32, 3), (8, 4, 5, 5)])
def test_anchored_and_rescued_variance(shape, monkeypatch):
    """|mean|/std ~ 1e5 (the JAX package's
    test_fused_bn_one_pass_variance_is_anchored case): unanchored, the
    rescue recovers the variance; anchored at the mean, the one pass is
    already exact. Both within 1e-5 of JAX's and 1e-2 of the true
    variance; with the rescue off the unanchored variance is wrong."""
    rs = np.random.RandomState(1)
    x = (rs.randn(*shape) * 1e-2 + 1e3).astype(np.float32)
    c = shape[1]
    gamma, beta = np.ones(c, np.float32), np.zeros(c, np.float32)
    axes = (0,) if len(shape) == 2 else (0, 2, 3)
    true_var = x.astype(np.float64).var(axis=axes)
    anchor = np.full(c, 1e3, np.float32)
    for shift in (None, anchor):
        jv = j_ops.batch_norm_train(
            jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), 1e-5,
            shift=None if shift is None else jnp.asarray(shift))[2]
        tv = t_norm.batch_norm_train(
            torch.from_numpy(x), torch.from_numpy(gamma),
            torch.from_numpy(beta), 1e-5,
            shift=None if shift is None else torch.from_numpy(shift))[2]
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
        np.testing.assert_allclose(tv.numpy(), true_var, rtol=1e-2)
    monkeypatch.setattr(t_norm, "RESCUE", False)
    tv = t_norm.batch_norm_train(torch.from_numpy(x),
                                 torch.from_numpy(gamma),
                                 torch.from_numpy(beta), 1e-5)[2]
    assert np.abs(tv.numpy() - true_var).max() > 10 * true_var.max()


@pytest.mark.parametrize("stride", [1, 2, 4])
@pytest.mark.parametrize("shape", [(32, 6), (16, 5, 4, 4)])
def test_sampled_batch_norm_matches_jax(shape, stride):
    """Moments from the first batch/stride rows, the straight-through
    backward: outputs and grads."""
    x, gamma, beta, dy, shift = _data(shape, 3, offset=0.5)
    c = shape[1]
    cts = [dy, np.zeros(c, np.float32), np.zeros(c, np.float32)]
    jo, jg, to, tg = _both(
        lambda x, g, b, s: j_ops.batch_norm_train_sampled(
            x, g, b, 1e-5, stride, shift=s),
        lambda x, g, b, s: t_norm.batch_norm_train_sampled(
            x, g, b, 1e-5, stride, shift=s),
        [x, gamma, beta, shift], cts)
    _assert_all(to, jo, "output")
    _assert_all(tg, jg, "grad")


@pytest.mark.parametrize("shape", SHAPES)
def test_batch_norm_infer_matches_jax(shape):
    x, gamma, beta, dy, _ = _data(shape, 4)
    rs = np.random.RandomState(5)
    mean = rs.randn(shape[1]).astype(np.float32)
    var = rs.rand(shape[1]).astype(np.float32) + 0.5
    jo, jg, to, tg = _both(
        lambda x, g, b, m, v: (j_ops.batch_norm_infer(x, g, b, m, v),),
        lambda x, g, b, m, v: (t_norm.batch_norm_infer(x, g, b, m, v),),
        [x, gamma, beta, mean, var], [dy])
    _assert_all(to, jo, "output")
    _assert_all(tg, jg, "grad")


def test_bf16_rounds_scale_and_shift_to_the_input_dtype():
    """Under a bf16 x: y is bf16, the stats float32, and y is x times the
    bf16-rounded scale plus the bf16-rounded shift, as in JAX."""
    x, gamma, beta, _, shift = _data((8, 4, 3, 3), 6, offset=2.0)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    y, mean, var = t_norm.batch_norm_train(
        xb, torch.from_numpy(gamma), torch.from_numpy(beta), 1e-5,
        shift=torch.from_numpy(shift))
    assert y.dtype == torch.bfloat16
    assert mean.dtype == var.dtype == torch.float32
    scale = torch.from_numpy(gamma) * torch.rsqrt(var + 1e-5)
    sh = torch.from_numpy(beta) - scale * mean
    shape = (1, -1, 1, 1)
    want = (xb * scale.to(torch.bfloat16).reshape(shape)
            + sh.to(torch.bfloat16).reshape(shape))
    assert torch.equal(y, want)
    jy = j_ops.batch_norm_train(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(gamma), jnp.asarray(beta),
        1e-5, shift=jnp.asarray(shift))[0]
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("pool", ["AVE", "MAX"])
def test_global_pooling_matches_jax(pool):
    """kGlobalPooling forward and input grad, integer inputs with ties
    for MAX."""
    rs = np.random.RandomState(7)
    x = rs.randint(0, 3, (3, 4, 5, 5)).astype(np.float32)
    dy = rs.randn(3, 4).astype(np.float32)
    fn_j = (lambda a: jnp.max(a, axis=(2, 3))) if pool == "MAX" else (
        lambda a: jnp.mean(a, axis=(2, 3)))
    jy, vjp = jax.vjp(fn_j, jnp.asarray(x))
    layer = GlobalPoolingLayer.__new__(GlobalPoolingLayer)
    layer.pool = pool
    xt = torch.from_numpy(x).requires_grad_(True)
    ty = layer.apply({}, [xt], training=True)
    ty.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(dy))[0]), **TOL)


# ---------------------------------------------------------------------------
# layers and the Trainer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("bn")
    out = {"train": str(root / "train"), "test": str(root / "test")}
    t_loader.write_records(out["train"], *t_loader.synthetic_arrays(64))
    t_loader.write_records(out["test"],
                           *t_loader.synthetic_arrays(32, noise_seed=1))
    return out


def bn_text(shards, extra=""):
    return f'''
name: "bn-net"
train_steps: 8
test_steps: 2
test_frequency: 4
{extra}
updater {{ type: "kSGD" base_learning_rate: 0.05 momentum: 0.9
          weight_decay: 0.0001 learning_rate_change_method: kFixed }}
neuralnet {{
  layer {{ name: "data" type: "kShardData"
    data_param {{ path: "{shards["train"]}" batchsize: 8 }}
    exclude: kTest }}
  layer {{ name: "data" type: "kShardData"
    data_param {{ path: "{shards["test"]}" batchsize: 8 }}
    exclude: kTrain }}
  layer {{ name: "mnist" type: "kMnistImage" srclayers: "data"
    mnist_param {{ norm_a: 255 norm_b: 0 }} }}
  layer {{ name: "label" type: "kLabel" srclayers: "data" }}
  layer {{ name: "conv" type: "kConvolution" srclayers: "mnist"
    convolution_param {{ num_filters: 6 kernel: 3 stride: 2 pad: 1
                        bias_term: false }}
    param {{ name: "weight" init_method: kGaussainSqrtFanIn }} }}
  layer {{ name: "bn" type: "kBatchNorm" srclayers: "conv"
    batchnorm_param {{ momentum: 0.9 eps: 1e-5 }}
    param {{ name: "gamma" init_method: kConstant value: 1 }}
    param {{ name: "beta" init_method: kConstant value: 0 }} }}
  layer {{ name: "relu" type: "kReLU" srclayers: "bn" }}
  layer {{ name: "gap" type: "kGlobalPooling" srclayers: "relu" }}
  layer {{ name: "ip" type: "kInnerProduct" srclayers: "gap"
    inner_product_param {{ num_output: 10 }}
    param {{ name: "weight" init_method: kGaussain std: 0.1 }}
    param {{ name: "bias" init_method: kConstant value: 0 }} }}
  layer {{ name: "bn2" type: "kBatchNorm" srclayers: "ip" }}
  layer {{ name: "loss" type: "kSoftmaxLoss" srclayers: "bn2"
    srclayers: "label" }}
}}
'''


BUFFERS = {"bn/running_mean", "bn/running_var", "bn2/running_mean",
           "bn2/running_var"}


def t_trainer(shards, **kw):
    return Trainer(t_parse(bn_text(shards)), seed=0, log=lambda s: None,
                   device="cpu", **kw)


def j_trainer(shards):
    return JTrainer(j_parse(bn_text(shards)),
                    mesh=j_build_mesh(1, 1, jax.devices()[:1]), seed=0,
                    log=lambda s: None, prefetch=False)


def step_loss(tr, step):
    tr.train_one_batch(step)
    loss = tr.perf.avg()["loss"]["loss"]
    tr.perf.reset()
    return loss


def buffers_np(tr):
    """A copy of the trainer's buffers (the port's update in place)."""
    return {k: np.array(v) for k, v in tr.buffers.items()}


def test_buffers_track_the_running_stats(shards):
    """One step: each running stat is 0.9 * init + 0.1 * the batch's
    (biased) statistic, float32, declared as <layer>/running_*."""
    tr = t_trainer(shards, graphs=False)
    assert set(tr.buffers) == BUFFERS
    assert tr.train_net.buffer_specs()["bn/running_var"].init == 1.0
    batch = tr._next_batch(tr.train_net)
    _, _, acts = tr.train_net.forward(tr.params, batch, training=True,
                                      return_acts=True)
    conv = acts["conv"].detach().double()
    tr._pipelines[id(tr.train_net)]["data"].seek(0)
    tr.train_one_batch(0)
    mean = conv.mean((0, 2, 3))
    var = conv.var((0, 2, 3), correction=0)
    for name, want in (("bn/running_mean", 0.1 * mean),
                       ("bn/running_var", 0.9 + 0.1 * var)):
        got = tr.buffers[name]
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_buffers_stay_float32_under_a_bf16_compute_dtype(shards):
    """compute_dtype bfloat16 casts params and batch, never the running
    stats: they stay float32 through a graphed and an eager step."""
    cfg = t_parse(bn_text(shards, 'compute_dtype: "bfloat16"'))
    for graphs in (None, False):
        tr = Trainer(cfg, seed=0, log=lambda s: None, device="cpu",
                     graphs=graphs)
        tr.train_one_batch(0)
        assert np.isfinite(tr.perf.avg()["loss"]["loss"])
        for k, v in tr.buffers.items():
            assert v.dtype == torch.float32 and torch.isfinite(v).all(), k


def test_trainer_matches_jax_with_buffers_and_eval_reads_them(shards):
    """5 steps from the same params: losses within 1e-4, running stats
    within 1e-5; the test phase normalizes by the running stats (the
    same metrics as JAX's, and another result once the stats change)."""
    jt, tt = j_trainer(shards), t_trainer(shards)
    tt.params = params_from_numpy(tt.train_net,
                                  {k: np.asarray(v)
                                   for k, v in jt.params.items()})
    for step in range(5):
        assert step_loss(tt, step) == pytest.approx(step_loss(jt, step),
                                                    abs=1e-4)
    jb, tb = buffers_np(jt), buffers_np(tt)
    assert set(jb) == set(tb) == BUFFERS
    for k in jb:
        np.testing.assert_allclose(tb[k], jb[k], err_msg=k, **TOL)
    jm = jt.evaluate(jt.test_net, 2, "test", 5)["loss"]
    tm = tt.evaluate(tt.test_net, 2, "test", 5)["loss"]
    for k in jm:
        assert tm[k] == pytest.approx(jm[k], abs=1e-4), k
    # the eval path reads the live stats: other stats, other metrics
    tt._store_buffers({"bn2/running_var":
                       tt.buffers["bn2/running_var"] * 4})
    moved = tt.evaluate(tt.test_net, 2, "test", 5)["loss"]
    assert moved["loss"] != pytest.approx(tm["loss"], abs=1e-3)


def test_graphed_chunk_equals_eager_steps_stats_included(shards):
    """The graphed step (its body called per step on the CPU) over a
    6-step chunk: the eager per-step losses and running stats to the
    bit."""
    graph = t_trainer(shards)
    eager = t_trainer(shards, graphs=False, device_cache=False,
                      prefetch=False)
    assert graph.dispatch_mode == "graph" and graph.feeder_mode == "cached"
    graph.train_chunk(0, 6)
    g_loss = graph.perf.avg()["loss"]["loss"]
    e_loss = np.mean([step_loss(eager, s) for s in range(6)])
    assert g_loss == pytest.approx(e_loss, rel=1e-6)
    gb, eb = buffers_np(graph), buffers_np(eager)
    for k in BUFFERS:
        np.testing.assert_array_equal(gb[k], eb[k], err_msg=k)
        assert not np.array_equal(gb[k], t_build_net(
            t_parse(bn_text(shards))).init_buffers()[k].numpy())


def test_eager_steps_then_graphed_eval_read_the_updated_stats(shards):
    """Eager steps on a trainer whose eval graph already exists update
    the running stats in place (the captured eval reads them at fixed
    addresses): the buffers stay the same tensors, and the graphed eval
    gives the metrics of a trainer that took the same steps."""
    tr = t_trainer(shards)
    other = t_trainer(shards, graphs=False, device_cache=False,
                      prefetch=False)
    tr.evaluate(tr.test_net, 2, "test", 0)
    assert tr._eval_g, "the eval graph was not built"
    ptrs = {k: v.data_ptr() for k, v in tr.buffers.items()}
    before = buffers_np(tr)
    for step in range(3):
        tr._step_core(step, tr._next_batch(tr.train_net))
        step_loss(other, step)
    assert {k: v.data_ptr() for k, v in tr.buffers.items()} == ptrs
    for k in BUFFERS:
        assert not np.array_equal(before[k], buffers_np(tr)[k])
        np.testing.assert_array_equal(buffers_np(tr)[k],
                                      buffers_np(other)[k])
    for pipe in tr._pipelines[id(tr.test_net)].values():
        pipe.seek(0)
    got = tr.evaluate(tr.test_net, 2, "test", 3)["loss"]
    want = other.evaluate(other.test_net, 2, "test", 3)["loss"]
    assert got == want


def test_eager_steps_keep_every_param_and_slot_address(shards):
    """The eager step's update lands in the params and updater slots in
    place, as the graphed step's does: a captured eval reads them at
    fixed addresses, so a step that rebound them would leave the eval
    graph reading the old (or freed) memory on the card. The values
    are those of a trainer that took the same steps."""
    tr = t_trainer(shards)
    other = t_trainer(shards, graphs=False, device_cache=False,
                      prefetch=False)
    tr.evaluate(tr.test_net, 2, "test", 0)
    p_ptrs = {k: v.data_ptr() for k, v in tr.params.items()}
    s_ptrs = {(k, s): v.data_ptr() for k, slots in tr.state.items()
              for s, v in slots.items()}
    assert s_ptrs, "the updater keeps no slots: nothing to check"
    before = {k: np.array(v) for k, v in tr.params.items()}
    for step in range(3):
        tr._step_core(step, tr._next_batch(tr.train_net))
        step_loss(other, step)
    assert {k: v.data_ptr() for k, v in tr.params.items()} == p_ptrs
    assert {(k, s): v.data_ptr() for k, slots in tr.state.items()
            for s, v in slots.items()} == s_ptrs
    assert any(not np.array_equal(before[k], np.array(v))
               for k, v in tr.params.items())
    for k, v in tr.params.items():
        np.testing.assert_array_equal(np.array(v),
                                      np.array(other.params[k]), err_msg=k)
    for k, slots in tr.state.items():
        for s, v in slots.items():
            np.testing.assert_array_equal(
                np.array(v), np.array(other.state[k][s]), err_msg=f"{k}/{s}")


def test_checkpoints_carry_buffers_both_ways(shards, tmp_path):
    """b|<layer>/running_* keys: the JAX Trainer's checkpoint restores
    into the port and the port's into the JAX Trainer."""
    jt, tt = j_trainer(shards), t_trainer(shards)
    for step in range(2):
        jt.train_one_batch(step)
        tt.train_one_batch(step)
    j_save(str(tmp_path / "j.npz"), 2, jt.params, jt.state, jt.buffers)
    save_checkpoint(str(tmp_path / "t.npz"), 2, tt.params, tt.state,
                    tt.buffers)
    with np.load(tmp_path / "t.npz") as z:
        assert {k for k in z.files if k.startswith("b|")} == {
            f"b|{k}" for k in BUFFERS}
    tcfg = t_parse(bn_text(shards))
    tcfg.checkpoint = str(tmp_path / "j.npz")
    restored = Trainer(tcfg, seed=1, log=lambda s: None, device="cpu")
    jcfg = j_parse(bn_text(shards))
    jcfg.checkpoint = str(tmp_path / "t.npz")
    jrestored = JTrainer(jcfg, mesh=j_build_mesh(1, 1, jax.devices()[:1]),
                         seed=1, log=lambda s: None, prefetch=False)
    for got, want in ((buffers_np(restored), buffers_np(jt)),
                      (buffers_np(jrestored), buffers_np(tt))):
        for k in BUFFERS:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert restored.start_step == jrestored.start_step == 2


def test_buffers_on_more_than_one_rank_are_refused_by_name(shards):
    """Exact data parallel synchronises BatchNorm over the ranks
    (tests/test_torch_sync_bn.py); the int8 ring's per-rank backward
    cannot, and refuses a net with buffers by name, as the JAX Trainer
    does, on one rank and on two."""
    ring = t_parse(bn_text(shards, "grad_comm { mode: quantized }\n"
                           "kernels { grad_allreduce: quantized_ring }"))
    with pytest.raises(ConfigError, match="batch-statistics buffers"):
        Trainer(ring, mesh=build_mesh(2, 1, ["cpu"] * 2), log=lambda s: None)
    with pytest.raises(ConfigError, match="batch-statistics buffers"):
        Trainer(ring, device="cpu", log=lambda s: None)


def test_stats_sample_stride_refuses_fewer_than_eight_rows(shards):
    txt = bn_text(shards).replace(
        "batchnorm_param { momentum: 0.9 eps: 1e-5 }",
        "batchnorm_param { momentum: 0.9 eps: 1e-5 "
        "stats_sample_stride: 2 }")
    with pytest.raises(ConfigError, match="leaves 4 of 8 sample rows"):
        t_build_net(t_parse(txt))


def test_offset_case_within_its_float64_bound_and_rescue_off_breaks_it(
        monkeypatch):
    """The card test's offset case (x near 1e3, std 1e-2) on the CPU:
    every output within ``bn_float64_bounds`` of the float64 formula;
    with the cancellation rescue planted off, y, var, dx and dgamma
    leave it."""
    from test_torch_cuda import BN_OUTPUTS, _bn_inputs, bn_float64_bounds, \
        bn_outputs

    _, dy, gamma, beta, offset = _bn_inputs()
    ref, bounds = bn_float64_bounds(offset, gamma, beta, dy)

    def errors():
        outs = bn_outputs(offset, gamma, beta, dy, "cpu")
        return {n: float((o - r).abs().max())
                for n, o, r in zip(BN_OUTPUTS, outs, ref)}

    errs = errors()
    for name, b in zip(BN_OUTPUTS, bounds):
        assert errs[name] <= b, (name, errs[name], b)
    monkeypatch.setattr(t_norm, "RESCUE", False)
    errs = errors()
    broken = {n for n, b in zip(BN_OUTPUTS, bounds) if errs[n] > b}
    assert {"y", "var", "dx", "dgamma"} <= broken, errs
