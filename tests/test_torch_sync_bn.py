"""BatchNorm synchronised over data-parallel ranks in the port
(``Net.forward_ranks``, ``BatchNormLayer.apply_stateful_ranks``,
``ops/norm.py``'s ``batch_norm_train_sync``), the JAX package's
BatchNorm over a batch sharded by GSPMD.

Nets: tests/test_torch_norm.py's conv + kBatchNorm conf (a 4-D and a
2-D BatchNorm) and ``resnet_conf(depth=18)`` at
tests/test_torch_resnet.py's size (batch 8, 32 x 32, 4 classes, float32,
centre crops). Bars:

- 4 ranks on one controller against the JAX Trainer on 4 of the suite's
  virtual devices, each step from the JAX Trainer's state (the drift of
  test_torch_resnet.py): losses within 1e-4 relative, running stats
  within 1e-5 relative of max(1, |stat|);
- 4 ranks against 1 rank at the global batch, each step from the 1-rank
  state: losses within SYNC_TOL (1e-5) relative, running stats within
  SYNC_TOL of max(1, |stat|). The partials' sum is not the one-rank
  pairwise sum, so not bitwise (2e-7 measured on the first step). The
  sampled form is held at SAMPLED_TOL (1e-4): its 2-D BatchNorm takes
  one channel's moments over 16 rows where the variance is about 1e-4
  of the squared shifted mean, and there the one-pass float32 variance
  moves by 0.2% with the summation order (5.5e-5 on the step-2 loss;
  measured on the CPU);
- 2 processes x 2 ranks (the CLI over gloo) against 1 process x 4:
  params, slots and running stats to the bit;
- the offset case x = 1e3 + 1e-2 N(0, 1) over 4 ranks: every output
  within tests/test_torch_cuda.py's float64-derived bound.

The sampled form (``stats_sample_stride``) is reproduced, not refused:
its moments come from the global batch's first rows, which the ranks
that hold them contribute. The int8 ring still refuses a net with
buffers, in the JAX Trainer's words (up to its closing note).
"""

import json

import jax
import numpy as np
import pytest
import torch

from singa_tpu.config import parse_model_config as j_parse
from singa_tpu.config.schema import ConfigError as JConfigError
from singa_tpu.parallel import build_mesh as j_mesh
from singa_tpu.trainer import Trainer as JTrainer
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.config.schema import ConfigError
from singa_tpu_torch.data import loader as t_loader
from singa_tpu_torch.models import resnet as t_resnet
from singa_tpu_torch.ops import norm as t_norm
from singa_tpu_torch.parallel import build_mesh
from singa_tpu_torch.trainer import Trainer, params_from_numpy
from test_torch_cuda import BN_OUTPUTS, _bn_inputs, bn_float64_bounds
from test_torch_launch import one_torch_thread  # noqa: F401
from test_torch_multiprocess import launch
from test_torch_norm import bn_text, shards  # noqa: F401
from test_torch_resnet import rgb_eval_crop  # noqa: F401

N = 4
SYNC_TOL = 1e-5
SAMPLED_TOL = 1e-4
SAMPLED = ("batchnorm_param { momentum: 0.9 eps: 1e-5 }",
           "batchnorm_param { momentum: 0.9 eps: 1e-5 "
           "stats_sample_stride: 2 }")


def np_tree(tree):
    return {n: np.array(v) for n, v in tree.items()}


def step_loss(tr, step):
    tr.train_one_batch(step)
    loss = tr.perf.avg()["loss"]["loss"]
    tr.perf.reset()
    return loss


def t_trainer(text, n):
    return Trainer(t_parse(text), mesh=build_mesh(n, 1, ["cpu"] * n),
                   seed=0, log=lambda s: None)


def stats_close(got: dict, want: dict, tol: float, what):
    assert got.keys() == want.keys()
    for k in want:
        scale = np.maximum(1, np.abs(want[k]))
        np.testing.assert_allclose(got[k] / scale, want[k] / scale,
                                   atol=tol, rtol=0, err_msg=f"{what} {k}")


def sampled_text(shards):
    """The conv conf at batch 32 with both BatchNorms sampling half the
    batch: 16 rows, the first two ranks' of four."""
    text = bn_text(shards).replace("batchsize: 8", "batchsize: 32")
    text = text.replace(*SAMPLED)
    return text.replace('"bn2" type: "kBatchNorm" srclayers: "ip" }',
                        '"bn2" type: "kBatchNorm" srclayers: "ip"\n'
                        "    batchnorm_param { stats_sample_stride: 2 } }")


@pytest.fixture(scope="module")
def resnet_text(tmp_path_factory):
    shard = str(tmp_path_factory.mktemp("sync_bn") / "shard")
    t_loader.write_records(shard, *t_loader.imagenet_shaped_arrays(
        16, classes=4, size=32))
    return t_resnet.resnet_conf(
        18, classes=4, batchsize=8, size=32, train_shard=shard,
        test_shard=shard, train_steps=3, compute_dtype="float32",
    ).replace("random_skip: 5000", "random_skip: 0")


def nets(shards, resnet_text):
    return {"conv": bn_text(shards), "sampled": sampled_text(shards),
            "resnet18": resnet_text}


# ---------------------------------------------------------------------------
# against the JAX Trainer on a 4-device mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("net", ["conv", "sampled", "resnet18"])
def test_four_ranks_match_the_jax_trainer_on_four_devices(
        shards, resnet_text, rgb_eval_crop, net):
    """3 steps, each from the JAX Trainer's state: losses within 1e-4
    relative, running stats within 1e-5 relative of max(1, |stat|)."""
    text = nets(shards, resnet_text)[net]
    jt = JTrainer(j_parse(text), mesh=j_mesh(N, 1, jax.devices()[:N]),
                  seed=0, log=lambda s: None, prefetch=False)
    tt = t_trainer(text, N)
    assert tt.dispatch_mode == "eager"
    for step in range(3):
        tt.params = params_from_numpy(tt.train_net, np_tree(jt.params))
        tt.state = {n: {k: torch.from_numpy(v) for k, v in
                        np_tree(slots).items()}
                    for n, slots in jt.state.items()}
        tt._store_buffers({k: torch.from_numpy(v)
                           for k, v in np_tree(jt.buffers).items()})
        want, got = step_loss(jt, step), step_loss(tt, step)
        assert abs(got - want) <= 1e-4 * abs(want), (step, got, want)
        stats_close(np_tree(tt.buffers), np_tree(jt.buffers), 1e-5,
                    f"step {step}")


# ---------------------------------------------------------------------------
# against one rank at the global batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("net", ["conv", "sampled", "resnet18"])
def test_four_ranks_match_one_rank_at_the_global_batch(
        shards, resnet_text, rgb_eval_crop, net):
    """3 steps, each from the 1-rank trainer's state: losses and running
    stats within SYNC_TOL (the sampled form: SAMPLED_TOL). Statistics
    that skip the sum over ranks miss the loss by far more (the next
    test)."""
    text = nets(shards, resnet_text)[net]
    tol = SAMPLED_TOL if net == "sampled" else SYNC_TOL
    one, four = t_trainer(text, 1), t_trainer(text, N)
    for step in range(3):
        four.params = one.params
        four.state = one.state
        four._store_buffers(one.buffers)
        want, got = step_loss(one, step), step_loss(four, step)
        assert abs(got - want) <= tol * abs(want), (step, got, want)
        stats_close(np_tree(four.buffers), np_tree(one.buffers), tol,
                    f"step {step}")


def test_a_skipped_sum_breaks_the_global_batch(shards, monkeypatch):
    """Planted fault: the sum over ranks skipped, every rank normalising
    by rank 0's rows alone (its partials scaled to the global count).
    Step 0's loss leaves SYNC_TOL of the 1-rank loss by more than 100x,
    so the bar above sees the sync."""
    text = bn_text(shards)
    want = step_loss(t_trainer(text, 1), 0)
    monkeypatch.setattr(
        t_norm, "_rank_sum",
        lambda sync, parts, device: parts[0].to(device) * sync.width)
    got = step_loss(t_trainer(text, N), 0)
    assert abs(got - want) > 100 * SYNC_TOL * abs(want), (got, want)


def test_offset_case_over_four_ranks_within_its_float64_bound():
    """x = 1e3 + 1e-2 N(0, 1) (16 x 8 x 7 x 7) cut into 4 ranks' rows:
    y and dx (the ranks' outputs, stacked), the global mean and var,
    and dgamma and dbeta (the ranks' partials summed, as the Trainer's
    reduction sums them) within ``bn_float64_bounds``, the rescue taken
    globally."""
    _, dy, gamma, beta, offset = _bn_inputs()
    ref, bounds = bn_float64_bounds(offset, gamma, beta, dy)
    mesh = build_mesh(N, 1, ["cpu"] * N)
    xs = [x.clone().requires_grad_(True) for x in offset.chunk(N)]
    gs = [gamma.clone().requires_grad_(True) for _ in range(N)]
    bs = [beta.clone().requires_grad_(True) for _ in range(N)]
    ys, mean, var = t_norm.batch_norm_train_sync(xs, gs, bs, 1e-5, mesh)
    torch.autograd.backward(ys, list(dy.chunk(N)))
    outs = [torch.cat([y.detach() for y in ys]), mean, var,
            torch.cat([x.grad for x in xs]), sum(g.grad for g in gs),
            sum(b.grad for b in bs)]
    for name, out, want, bound in zip(BN_OUTPUTS, outs, ref, bounds):
        err = float((out.double() - want).abs().max())
        assert err <= bound, (name, err, bound)


# ---------------------------------------------------------------------------
# across processes, and the ring's refusal
# ---------------------------------------------------------------------------


def test_two_processes_of_two_ranks_equal_one_process_of_four(
        shards, tmp_path):
    """The conv conf's 8 steps (a test pass every 4) through the CLI as 2
    processes of 2 ranks over gloo: params and slots (the processes'
    digests) and the running stats (process 0's npz save) are the 1 x 4
    run's to the bit."""
    text = bn_text(shards)
    reports, _ = launch(tmp_path, text, N)
    one = t_trainer(text, N)
    one.run()
    assert [r["digest"] for r in reports] == [one.digest()] * 2
    assert all(r["steps"] == one.cfg.train_steps for r in reports)
    with np.load(tmp_path / "ws_job" / "checkpoints" / "step_8.npz") as z:
        for k, v in one.buffers.items():
            np.testing.assert_array_equal(z[f"b|{k}"], v.numpy(), err_msg=k)
    print(json.dumps(reports[0]))


def test_the_ring_still_refuses_batchnorm_in_the_jax_words(shards):
    text = bn_text(shards, "grad_comm { mode: quantized }\n"
                   "kernels { grad_allreduce: quantized_ring }")
    with pytest.raises(JConfigError) as want:
        JTrainer(j_parse(text), mesh=j_mesh(N, 1, jax.devices()[:N]),
                 seed=0, log=lambda s: None, prefetch=False)
    with pytest.raises(ConfigError) as got:
        t_trainer(text, N)
    # the port's words are the JAX Trainer's, up to its note on why
    assert str(want.value).startswith(str(got.value)), (got, want)
    assert "(kBatchNorm)" in str(got.value)
