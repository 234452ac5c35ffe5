"""The port's zero_update (singa_tpu_torch/parallel/shardings.py and the
Trainer's zero update) on 2 and 4 CPU ranks: against the replicated
update, against the JAX zero Trainer, and with the CD engine.

Zero and replicated sum the ranks' gradients in the same order and the
updaters are elementwise, so zero must give the replicated run's losses
and params to the bit: a difference means a shard cut or stitched
wrongly, not rounding. Against the JAX zero Trainer (the suite's virtual
CPU devices) the bar is ROADMAP's: losses over 5 steps within 1e-4.

Nets: test_torch_ring_trainer's narrowed tinylm_d128.conf (every param's
dim 0 divides 4) and the JAX zero tests' MLP (its (10,) head bias
divides 2 but not 4: the replicate fallback and its warning).
"""

import warnings

import jax
import numpy as np
import pytest
import torch

from singa_tpu.config import parse_model_config as j_parse
from singa_tpu.parallel import build_mesh as j_mesh
from singa_tpu.trainer import CDTrainer as JCDTrainer
from singa_tpu.trainer import Trainer as JTrainer
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.data import loader as t_loader
from singa_tpu_torch.parallel import build_mesh
from singa_tpu_torch.trainer import CDTrainer, Trainer, params_from_numpy
from test_torch_ring_trainer import narrow_conf
from test_zero_update import MLP_CONF

LOSS_TOL = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test on one intra-op thread: the tensors are small, and under
    the suite's xdist workers every worker's thread pool contends for the
    same cores (a test that takes 0.3 s alone took 46 s under 5
    workers). Restored after the test; the other files' tests keep
    theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

RBM_CONF = """
name: "zero-rbm"
train_steps: 8
alg: kContrastiveDivergence
zero_update: {zero}
updater {{ base_learning_rate: 0.1 momentum: 0.8 type: kSGD }}
neuralnet {{
  layer {{ name: "data" type: "kShardData"
    data_param {{ path: "{shard}" batchsize: 32 }} }}
  layer {{ name: "mnist" type: "kMnistImage" srclayers: "data"
    mnist_param {{ norm_a: 255 norm_b: 0 }} }}
  layer {{ name: "rbm1" type: "kRBM" srclayers: "mnist"
    rbm_param {{ num_hidden: 16 cd_k: 1 }}
    param {{ name: "weight" init_method: kGaussain mean: 0 std: 0.1 }}
    param {{ name: "vbias" init_method: kConstant value: 0 }}
    param {{ name: "hbias" init_method: kConstant value: 0 }} }}
}}
"""


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("zero")
    tok, img = str(root / "tok"), str(root / "img")
    t_loader.write_records(
        tok, *t_loader.synthetic_token_arrays(32, seq_len=32, vocab=256))
    t_loader.write_records(img, *t_loader.synthetic_arrays(96, seed=4))
    return {"tok": tok, "img": img}


def lm_conf(shards, zero: bool) -> str:
    return narrow_conf(shards["tok"], f"zero_update: {str(zero).lower()}")


def mlp_conf(shards, zero: bool) -> str:
    return MLP_CONF.format(
        shard=shards["img"], zero=str(zero).lower(), train_steps=12,
        checkpoint_frequency=0, checkpoint_format="npz", extra="")


def t_trainer(txt, n, cls=Trainer):
    return cls(t_parse(txt), mesh=build_mesh(n, 1, ["cpu"] * n), seed=3,
               log=lambda s: None)


def losses(tr, nsteps):
    out = []
    for s in range(nsteps):
        tr.train_one_batch(s)
        out.append(float(next(iter(tr.perf.avg().values()))["loss"]))
        tr.perf.reset()
    return out


def same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("n", [2, 4])
def test_zero_matches_replicated_to_the_bit(shards, n):
    """n ranks, 4 steps: zero and replicated give equal losses, params
    and slots, bit for bit; every param is zero-sharded on dim 0."""
    tz = t_trainer(lm_conf(shards, True), n)
    tr = t_trainer(lm_conf(shards, False), n)
    assert (tz.update_mode, tr.update_mode) == ("zero", "replicated")
    assert tz.dispatch_mode == "eager"
    assert set(tz._zero_dims.values()) == {0}
    assert losses(tz, 4) == losses(tr, 4)
    assert same(tz.params, tr.params)
    for nm in tr.state:
        assert same(tz.state[nm], tr.state[nm]), nm


@pytest.mark.parametrize("n", [2, 4])
def test_slot_shards_live_on_their_ranks(shards, n):
    """Rank r holds only slice r of each slot, on its own device, and
    one rank's updater bytes are 1/n of the replicated update's."""
    tz = t_trainer(lm_conf(shards, True), n)
    tr = t_trainer(lm_conf(shards, False), n)
    losses(tz, 2)
    losses(tr, 2)
    assert not tz._replicas[tz.device]["state"]
    for r, dev in enumerate(tz.mesh.devices):
        for nm, slots in tz._zero_slots[r].items():
            whole = tr.state[nm]["history"]
            part = slots["history"]
            assert part.device == dev
            assert part.shape[0] * n == whole.shape[0]
            assert torch.equal(part, whole.chunk(n)[r])
    assert tz.opt_state_bytes_per_device() * n == \
        tr.opt_state_bytes_per_device()


def test_indivisible_dim_warns_and_stays_replicated(shards):
    """The MLP's (10,) head bias on 4 ranks: the JAX package's warning,
    word for word, and a replicated update for that param alone."""
    with pytest.warns(UserWarning) as jw:
        JTrainer(j_parse(mlp_conf(shards, True)), None,
                 mesh=j_mesh(4, 1, jax.devices()[:4]), seed=3,
                 log=lambda s: None, prefetch=False)
    with pytest.warns(UserWarning, match="stays replicated") as tw:
        tz = t_trainer(mlp_conf(shards, True), 4)
    jmsg = [str(w.message) for w in jw if "zero_update" in str(w.message)]
    tmsg = [str(w.message) for w in tw if "zero_update" in str(w.message)]
    assert tmsg == jmsg and "'fc2/bias'" in tmsg[0]
    assert tz._zero_dims["fc2/bias"] is None
    assert set(tz._replicas[tz.device]["state"]) == {"fc2/bias"}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tr = t_trainer(mlp_conf(shards, False), 4)
    assert losses(tz, 3) == losses(tr, 3)
    assert same(tz.params, tr.params)


def test_five_steps_match_the_jax_zero_trainer(shards):
    """2 ranks, the JAX zero Trainer's init params in both: 5 losses
    within LOSS_TOL, both trainers in zero mode."""
    jt = JTrainer(j_parse(lm_conf(shards, True)), None,
                  mesh=j_mesh(2, 1, jax.devices()[:2]), seed=0,
                  log=lambda s: None, prefetch=False)
    tt = t_trainer(lm_conf(shards, True), 2)
    tt.params = params_from_numpy(
        tt.train_net, {n: np.asarray(v) for n, v in jt.params.items()})
    assert jt.update_mode == tt.update_mode == "zero"
    got, want = losses(tt, 5), losses(jt, 5)
    assert np.abs(np.subtract(got, want)).max() <= LOSS_TOL, (got, want)
    assert got[-1] < got[0]


def test_cd_with_zero_matches_replicated(shards):
    """The CD engine on 2 ranks: zero and replicated give equal
    reconstruction errors and params to the bit (the JAX CD engine
    takes zero as well)."""
    def txt(zero):
        return RBM_CONF.format(shard=shards["img"], zero=zero)

    assert JCDTrainer(j_parse(txt("true")), None,
                      mesh=j_mesh(2, 1, jax.devices()[:2]), seed=3,
                      log=lambda s: None, prefetch=False,
                      device_cache=False).update_mode == "zero"
    tz = t_trainer(txt("true"), 2, CDTrainer)
    tr = t_trainer(txt("false"), 2, CDTrainer)
    assert tz.update_mode == "zero"
    assert losses(tz, 6) == losses(tr, 6)
    assert same(tz.params, tr.params)
