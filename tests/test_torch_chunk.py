"""The port's host dispatch: the device-resident dataset, multi-step
chunks and the graphed step body, on the CPU.

Mirrors tests/test_chunk.py for ``singa_tpu_torch``. On the CPU the
graphed step's body is called once per step (the card replays it as a
CUDA graph; tests/test_torch_cuda.py holds the two together there), so
these tests cover everything but the capture: a chunk must equal the
eager per-step path to the bit (params, updater slots, stream positions,
metrics), the cadences must cut the chunks where the JAX package cuts
them, and a chunked run must match the JAX Trainer's chunked run (device
cache on, ``prefetch=False``) within 1e-4 on the narrowed confs of
tests/test_torch_nets_train.py and tests/test_torch_train.py.
"""

import os

import jax
import numpy as np
import pytest
import torch

from singa_tpu.config import load_model_config as j_load
from singa_tpu.config import parse_model_config as j_parse
from singa_tpu.parallel import build_mesh as j_build_mesh
from singa_tpu.trainer import Trainer as JTrainer
from singa_tpu_torch.config import load_model_config as t_load
from singa_tpu_torch.config import parse_cluster_config
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.data.loader import (
    compute_mean,
    structured_rgb,
    synthetic_arrays,
    synthetic_token_arrays,
    write_records,
)
from singa_tpu_torch.layers.data import StagedDraw
from singa_tpu_torch.optim import learning_rate
from singa_tpu_torch.parallel import build_mesh
from singa_tpu_torch.trainer import Trainer, params_from_numpy
from singa_tpu_torch.utils.rng import fold_in
from test_torch_nets_train import NETS, narrow, rgb_eval_crop  # noqa: F401
from test_torch_train import SCHEDULES, _updater_cfg, narrow_conf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _conf(shard, extra="", steps=12, batch=16, rgb=None, layers=""):
    parser = (
        f'layer {{ name: "rgb" type: "kRGBImage" srclayers: "data" '
        f'rgbimage_param {{ scale: 0.0039 cropsize: 28 mirror: true '
        f'meanfile: "{rgb}" }} }}'
        if rgb else
        'layer { name: "mnist" type: "kMnistImage" srclayers: "data" '
        'mnist_param { norm_a: 255 norm_b: 0 } }')
    src = "rgb" if rgb else "mnist"
    return f"""
name: "chunk-test"
train_steps: {steps}
{extra}
updater {{ base_learning_rate: 0.1 momentum: 0.9 param_type: "Param"
          learning_rate_change_method: kStep gamma: 0.9
          learning_rate_change_frequency: 2 }}
neuralnet {{
  layer {{ name: "data" type: "kShardData"
          data_param {{ path: "{shard}" batchsize: {batch} }} }}
  {parser}
  layer {{ name: "label" type: "kLabel" srclayers: "data" }}
  {layers}
  layer {{ name: "fc" type: "kInnerProduct" srclayers: "{src}"
          inner_product_param {{ num_output: 10 }}
          param {{ name: "w" init_method: "kUniformSqrtFanIn" }}
          param {{ name: "b" init_method: "kConstant" value: 0 }} }}
  layer {{ name: "loss" type: "kSoftmaxLoss" srclayers: "fc" srclayers: "label"
          softmaxloss_param {{ topk: 1 }} }}
}}
"""


@pytest.fixture
def shard(tmp_path):
    path = str(tmp_path / "shard")
    # 40 records with batch 16 -> wraparound inside the chunk
    write_records(path, *synthetic_arrays(40, seed=2))
    return path


@pytest.fixture
def rgb(tmp_path):
    """A CIFAR-shaped shard of 40 records and its mean file."""
    path = str(tmp_path / "rgb")
    write_records(path, *structured_rgb(40, seed=2))
    mean = str(tmp_path / "mean.npy")
    compute_mean(path, mean)
    return path, mean


def _mk(text, **kw):
    kw.setdefault("seed", 3)
    kw.setdefault("log", lambda s: None)
    return Trainer(t_parse(text), device="cpu", **kw)


def _eager(text, **kw):
    """The per-step eager path of the slices before: host batches, one
    dispatch per step."""
    return _mk(text, graphs=False, device_cache=False, prefetch=False, **kw)


def assert_same_training_state(a, b):
    for name in a.params:
        assert torch.equal(a.params[name], b.params[name]), name
        for slot, v in a.state[name].items():
            assert torch.equal(v, b.state[name][slot]), (name, slot)
    assert a._stream_positions() == b._stream_positions()


# ---------------------------------------------------------------------------
# a chunk is the per-step path, to the bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("parser", ["mnist", "rgb"])
def test_chunk_equals_stepwise_to_the_bit(shard, rgb, parser):
    """6 steps as one chunk (the batch gathered on the device, wrapping
    the 40-record dataset twice) == 6 eager per-step steps on host
    batches: params, momentum slots, stream positions and the summed
    metrics, bitwise; kRGBImage's crops and mirrors staged for the
    chunk equal its eager draws."""
    text = _conf(rgb[0] if parser == "rgb" else shard,
                 rgb=rgb[1] if parser == "rgb" else None)
    a, b = _mk(text), _eager(text)
    assert a.dispatch_mode == "graph" and a.feeder_mode == "cached"
    assert a._can_chunk()
    a.train_chunk(0, 6)
    for step in range(6):
        b.train_one_batch(step)
    assert_same_training_state(a, b)
    assert a._stream_positions() == {"kTrain|data": (6 * 16) % 40}
    assert a.perf.count == b.perf.count == 6
    assert a.perf.avg() == b.perf.avg()
    assert a._g.run.eager_calls == 6  # the body, once per step


def test_chunked_run_equals_unchunked_run(shard, monkeypatch):
    """A whole run() in chunks == the same run() one step at a time."""
    extra = "display_frequency: 5"
    a, b = _mk(_conf(shard, extra)), _eager(_conf(shard, extra))
    chunks = []
    orig = Trainer.train_chunk

    def spy(self, step0, nsteps):
        chunks.append((step0, nsteps))
        return orig(self, step0, nsteps)

    monkeypatch.setattr(Trainer, "train_chunk", spy)
    a.run()
    b.run()
    # display fires after steps 0, 5 and 10: windows of one step (at 0
    # and 11) run as single steps
    assert chunks == [(1, 5), (6, 5)]
    assert_same_training_state(a, b)


def test_chunk_longer_than_the_cap_runs_in_pieces(shard, monkeypatch):
    """SINGA_TPU_CHUNK bounds a window; a longer train_chunk call runs
    in pieces of the cap, the same steps."""
    monkeypatch.setenv("SINGA_TPU_CHUNK", "4")
    a, b = _mk(_conf(shard)), _eager(_conf(shard))
    a.train_chunk(0, 10)
    for step in range(10):
        b.train_one_batch(step)
    assert_same_training_state(a, b)


def test_chunked_eval_equals_per_batch_eval(shard, tmp_path):
    """evaluate() through the eval chunk (one graph, summed on the
    device) == the per-batch path: the same averages and positions."""
    test_shard = str(tmp_path / "test_shard")
    write_records(test_shard, *synthetic_arrays(48, seed=7))
    text = _conf(shard, "test_steps: 3").replace(
        'data_param { path: "%s" batchsize: 16 } }' % shard,
        'data_param { path: "%s" batchsize: 16 } exclude: "kTest" }\n'
        '  layer { name: "data" type: "kShardData" exclude: "kTrain"\n'
        '          data_param { path: "%s" batchsize: 16 } }'
        % (shard, test_shard))
    a, b = _mk(text), _eager(text)
    want = b.evaluate(b.test_net, 3, "test", 0)
    got = a.evaluate(a.test_net, 3, "test", 0)
    assert a._eval_g, "the eval chunk never engaged"
    assert got == want
    assert a._stream_positions() == b._stream_positions()


def test_chunk_respects_cadences(shard):
    """Chunks stop at test/display boundaries; events still fire."""
    extra = "test_steps: 1\ntest_frequency: 5\ndisplay_frequency: 4\n"
    logs = []
    tr = _mk(_conf(shard, extra), log=logs.append)
    tr.run()
    # display at steps 0, 4, 8; test at 0, 5, 10
    assert len([l for l in logs if ": train " in l]) == 3
    assert [l.split(":")[0] for l in logs if ": test " in l] == \
        ["step 0", "step 5", "step 10"]


def test_chunk_len_math(shard):
    tr = _mk(_conf(shard, "display_frequency: 10", steps=100))
    # display fires at 10, 20, ... -> from step 1 the chunk may run
    # through step 10 inclusive (display is a post-event)
    assert tr._chunk_len(1) == 10
    assert tr._chunk_len(10) == 1  # display closes every chunk at 10, 20
    assert tr._chunk_len(11) == 10
    tr = _mk(_conf(shard, "checkpoint_frequency: 7\ntest_steps: 1\n"
                          "test_frequency: 5", steps=100))
    # test runs before step 5 (stop short), a checkpoint after step 6
    assert tr._chunk_len(0) == 5
    assert tr._chunk_len(5) == 2
    assert tr._chunk_len(7) == 3
    assert tr._chunk_len(98) == 2  # the run's end


def test_checkpoint_inside_chunked_run_resumes_exactly(shard, tmp_path):
    """Checkpoints land at their cadence inside a chunked run with the
    stream position of the chunk edge, and a resume from one reaches
    the uninterrupted run's state bitwise."""
    cluster = parse_cluster_config(f'nworkers: 1 workspace: "{tmp_path}/ws"')
    a = _mk(_conf(shard, "checkpoint_frequency: 5"), cluster_cfg=cluster)
    a.run()
    folder = f"{tmp_path}/ws/checkpoints"
    assert sorted(os.listdir(folder)) == [
        "step_10.npz", "step_12.npz", "step_5.npz"]
    text = _conf(shard, f'checkpoint: "{folder}/step_5.npz"')
    b = _mk(text)
    assert b.start_step == 5
    assert b._stream_positions() == {"kTrain|data": (5 * 16) % 40}
    b.run()
    assert_same_training_state(a, b)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


def test_uint8_cache_round_trip(shard):
    """Byte-valued records are cached as uint8 and cast back after the
    gather: the batch equals the host pipeline's float32 batch."""
    tr = _mk(_conf(shard))
    (name,) = tr._dev_data[id(tr.train_net)]
    cached = tr._dev_data[id(tr.train_net)][name]
    assert cached["image"].dtype == torch.uint8
    pipe = tr._pipelines[id(tr.train_net)][name]
    images, labels = pipe.images[[38, 39, 0, 1]], pipe.labels[[38, 39, 0, 1]]
    got = tr._gather(tr.train_net, name, cached,
                     torch.tensor([38, 39, 0, 1]))
    assert got["image"].dtype == torch.float32
    assert torch.equal(got["image"], torch.from_numpy(images))
    assert torch.equal(got["label"], torch.from_numpy(labels))
    # non-byte data stays as it is
    f = np.array([[0.5, 1.0]], np.float32)
    assert Trainer._compact_cache_array(f)[0] is f
    big = np.array([[3.0, 256.0]], np.float32)
    assert Trainer._compact_cache_array(big)[0].dtype == np.float32


def test_device_cache_budget(shard, monkeypatch):
    """Over SINGA_TPU_DEVICE_CACHE_MB the dataset stays on the host (the
    stream stager takes over); device_cache=False always does."""
    monkeypatch.setenv("SINGA_TPU_DEVICE_CACHE_MB", "0.001")
    tr = _mk(_conf(shard))
    assert tr.feeder_mode == "stream" and not tr._cached
    monkeypatch.setenv("SINGA_TPU_DEVICE_CACHE_MB", "512")
    assert _mk(_conf(shard), device_cache=False).feeder_mode == "stream"
    assert _mk(_conf(shard)).feeder_mode == "cached"


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_learning_rate_on_a_device_step_matches_the_host_float(schedule):
    """Every schedule: a step tensor on the device gives the host
    float's bits for steps 0-200 (the graphed step reads its counter)."""
    cfg = _updater_cfg(t_parse, "kSGD", schedule)
    for step in range(201):
        host = float(learning_rate(cfg, step) * 2.0)
        dev = learning_rate(cfg, torch.tensor(step)) * 2.0
        assert dev.dtype == torch.float32 and dev.shape == ()
        assert np.float32(host).tobytes() == dev.numpy().tobytes(), step


def test_rgb_staged_draws_equal_eager_draws(rgb):
    """kRGBImage fed a StagedDraw row (drawn on the host from the eager
    generators) crops and mirrors exactly as it does with the generator
    itself."""
    tr = _mk(_conf(rgb[0], rgb=rgb[1]))
    (i, layer), = [(i, l) for i, l in enumerate(tr.train_net.layers)
                   if l.TYPE == "kRGBImage"]
    x = {"image": torch.from_numpy(
        tr.train_net.datalayers[0].images[:16].copy())}
    for step in range(4):
        gen = fold_in(fold_in(fold_in(tr._step_gen, step), 0), i)
        row = torch.tensor(layer.staged_row(fold_in(
            fold_in(fold_in(tr._step_gen, step), 0), i)))
        want = layer.apply({}, [x], training=True, generator=gen)
        got = layer.apply({}, [x], training=True,
                          generator=StagedDraw(row[:2], row[2:]))
        assert torch.equal(got, want), step
    assert row[2:].max() == 1 and row[2:].min() == 0  # mirrors drawn


# ---------------------------------------------------------------------------
# dispatch rules
# ---------------------------------------------------------------------------


DROPOUT = ('layer { name: "drop" type: "kDropout" srclayers: "mnist" }')


@pytest.mark.parametrize("case", [
    "graph", "graphs_off", "ranks", "dropout", "distortion", "debug"])
def test_dispatch_mode_rules(shard, case):
    """One rule each: a graphed step unless it is asked off, more than
    one rank, a layer that draws on the device, or debug; the choice is
    logged once, with the rule."""
    text = _conf(shard)
    kw = {}
    if case == "graphs_off":
        kw["graphs"] = False
    elif case == "ranks":
        kw["mesh"] = build_mesh(2, 1, ["cpu"] * 2)
    elif case == "dropout":
        text = _conf(shard, layers=DROPOUT).replace(
            'srclayers: "mnist"\n          inner', 'srclayers: "drop"\n'
            '          inner')
    elif case == "distortion":
        text = text.replace("norm_b: 0", "norm_b: 0 beta: 10")
    elif case == "debug":
        text = _conf(shard, "debug: true")
    logs = []
    tr = Trainer(t_parse(text), seed=0, log=logs.append,
                 **({"device": "cpu"} if "mesh" not in kw else {}), **kw)
    reason = {
        "graph": "", "graphs_off": "graphs=False",
        "ranks": "2 ranks: the per-rank loop, the ring's host bucket "
                 "loop and ppermute.sent_bytes",
        "dropout": "layer 'drop' (kDropout) draws on the device",
        "distortion": "layer 'mnist' (kMnistImage) draws on the device",
        "debug": "debug",
    }[case]
    assert tr.dispatch_mode == ("graph" if case == "graph" else "eager")
    assert tr.dispatch_reason == reason
    want = "dispatch: graph" if case == "graph" else \
        f"dispatch: eager ({reason})"
    assert [l for l in logs if l.startswith("dispatch")] == [want]
    # an eager dispatch takes one step a call: no chunks, no stream
    assert tr._can_chunk() == (case == "graph")
    tr.train_chunk(0, 2)
    assert tr.perf.count == 2


def test_assigned_params_land_in_the_static_tensors(shard):
    """``tr.params = ...`` copies into the tensors a captured step reads
    (their addresses stay), and the next chunk trains from them."""
    tr = _mk(_conf(shard))
    tr.train_chunk(0, 2)
    ids = {n: v.data_ptr() for n, v in tr.params.items()}
    fresh = {n: torch.zeros_like(v) for n, v in tr.params.items()}
    tr.params = fresh
    assert {n: v.data_ptr() for n, v in tr.params.items()} == ids
    assert all(not v.any() for v in tr.params.values())
    fresh["fc/w"] += 1  # the trainer holds its own copy
    assert not tr.params["fc/w"].any()


# ---------------------------------------------------------------------------
# the port's chunked run against the JAX Trainer's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def net_shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("chunk_nets")
    out = {"mnist": str(root / "mnist"), "cifar": str(root / "cifar"),
           "mean": str(root / "mean.npy")}
    write_records(out["mnist"], *synthetic_arrays(64))
    write_records(out["cifar"], *structured_rgb(64))
    compute_mean(out["cifar"], out["mean"])
    out["tokens"] = str(root / "tokens")
    write_records(out["tokens"],
                  *synthetic_token_arrays(8, seq_len=128, vocab=256))
    return out


def _chunked_losses(tr, windows=((0, 3), (3, 3))):
    out = []
    for step0, n in windows:
        tr.train_chunk(step0, n)
        out.append(tr.perf.avg()["loss"]["loss"])
        tr.perf.reset()
    return out


@pytest.mark.parametrize("name", list(NETS) + ["lm"])
def test_chunked_run_matches_jax_chunked_run(name, net_shards, monkeypatch,
                                             rgb_eval_crop):
    """6 steps of each narrowed conf in chunks of 3, in both packages
    from the same params (device cache on, prefetch off): window losses
    within 1e-4, params within 1e-4 after."""
    if name == "lm":
        monkeypatch.setenv("SINGA_TPU_DENSE_ATTN_MB", "0")
        jcfg = j_parse(narrow_conf(net_shards["tokens"]))
        tcfg = t_parse(narrow_conf(net_shards["tokens"]))
    else:
        path = os.path.join(REPO, NETS[name][0])
        jcfg = narrow(j_load(path), name, net_shards)
        tcfg = narrow(t_load(path), name, net_shards)
    jt = JTrainer(jcfg, mesh=j_build_mesh(1, 1, jax.devices()[:1]), seed=0,
                  log=lambda s: None, prefetch=False, device_cache=True)
    tt = Trainer(tcfg, seed=0, log=lambda s: None, device="cpu",
                 prefetch=False, device_cache=True)
    assert jt._can_chunk() and tt._can_chunk()
    tt.params = params_from_numpy(
        tt.train_net, {n: np.asarray(v) for n, v in jt.params.items()})
    jl, tl = _chunked_losses(jt), _chunked_losses(tt)
    assert np.isfinite(tl).all()
    for j, t in zip(jl, tl):
        assert abs(j - t) <= 1e-4, (jl, tl)
    for n, v in tt.params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jt.params[n]),
                                   atol=1e-4, err_msg=n)
    assert tt._stream_positions() == {
        k: v for k, v in jt._stream_positions().items()}
