"""The port's training slice (singa_tpu_torch: config, data, params,
optim, layers, graph, checkpoint, Trainer, main) against the JAX
package, on the same numpy inputs.

The model is a narrowed copy of examples/lm/tinylm_longctx_d128.conf:
d_model 64, 2 heads x 32, d_ff 128, vocab 256, 2 blocks, S = 128,
batch 2, float32 compute. With SINGA_TPU_DENSE_ATTN_MB=0 the port's
kAttention takes its flash path (the plain versions of the kernels on
the CPU) while the JAX package's falls back to dense off the TPU, so the
slice as a whole is held against a second implementation of attention.

Tolerances: per-op and per-layer 2e-5 (float32, different summation
orders); updaters 1e-6 (elementwise float32 arithmetic in the same
order); losses over 5 steps 1e-4.
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import optim as j_optim
from singa_tpu import params as j_params
from singa_tpu.config import parse_cluster_config as j_cluster
from singa_tpu.config import parse_model_config as j_parse
from singa_tpu.data import loader as j_loader
from singa_tpu.data import pipeline as j_pipeline
from singa_tpu.graph.builder import build_net as j_build_net
from singa_tpu.layers import registered_types as j_registered
from singa_tpu.parallel import build_mesh
from singa_tpu.trainer import Trainer as JTrainer
from singa_tpu_torch import optim as t_optim
from singa_tpu_torch import params as t_params
from singa_tpu_torch.config import ConfigError
from singa_tpu_torch.config import load_model_config as t_load
from singa_tpu_torch.config import parse_cluster_config as t_cluster
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.data import loader as t_loader
from singa_tpu_torch.data import pipeline as t_pipeline
from singa_tpu_torch.graph.builder import build_net as t_build_net
from singa_tpu_torch.layers import registered_types
from singa_tpu_torch.trainer import Trainer, params_from_numpy
from singa_tpu_torch.trainer.trainer import unsupported as t_unsupported

REPO = pathlib.Path(__file__).resolve().parent.parent
CONF = REPO / "examples" / "lm" / "tinylm_longctx_d128.conf"
ACT = dict(atol=2e-5, rtol=1e-5)


def narrow_conf(shard: str, extra: str = "") -> str:
    """tinylm_longctx_d128.conf at d_model 64, 2 x 32 heads, d_ff 128,
    batch 2, float32 (vocab and depth as written)."""
    txt = CONF.read_text()
    for old, new in (
        ("examples/lm/train_shard_8k", shard),
        ("batchsize: 1", "batchsize: 2"),
        ("embedding_dim: 256", "embedding_dim: 64"),
        ("num_output: 1024", "num_output: 128"),
        ("num_output: 256 }", "num_output: 64 }"),  # the down projections
        ('compute_dtype: "bfloat16"', ""),
    ):
        assert old in txt, old
        txt = txt.replace(old, new)
    return txt + "\n" + extra


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tokens") / "shard")
    t_loader.write_records(
        path, *t_loader.synthetic_token_arrays(8, seq_len=128, vocab=256)
    )
    return path


def j_trainer(cfg, cluster=None):
    return JTrainer(cfg, cluster, mesh=build_mesh(1, 1, jax.devices()[:1]),
                    seed=0, log=lambda s: None, prefetch=False)


def t_trainer(cfg, cluster=None):
    return Trainer(cfg, cluster, seed=0, log=lambda s: None, device="cpu")


def np_params(tree):
    return {n: np.asarray(v) for n, v in tree.items()}


def step_loss(tr, step):
    tr.train_one_batch(step)
    loss = tr.perf.avg()["loss"]["loss"]
    tr.perf.reset()
    return loss


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "path", sorted(str(p.relative_to(REPO))
                   for p in (REPO / "examples").rglob("*.conf")),
)
def test_every_example_conf_parses_like_the_original(path):
    from singa_tpu.config import load_cluster_config as j_lc
    from singa_tpu.config import load_model_config as j_lm
    from singa_tpu_torch.config import load_cluster_config as t_lc

    j_load, t_load_ = (j_lc, t_lc) if "cluster" in path else (j_lm, t_load)
    assert t_load_(str(REPO / path)).to_dict() == \
        j_load(str(REPO / path)).to_dict()


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def test_write_records_bytes_and_arrays_match(tmp_path):
    """The port's Python writer writes the bytes the JAX package's
    writer does; both loaders decode them to the same arrays."""
    toks, labels = t_loader.synthetic_token_arrays(6, seq_len=40, vocab=97,
                                                   seed=4)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert t_loader.write_records(a, toks, labels) == 6
    assert j_loader.write_records(b, toks, labels) == 6
    assert (tmp_path / "a" / "shard.dat").read_bytes() == \
        (tmp_path / "b" / "shard.dat").read_bytes()
    for got, want in zip(t_pipeline.load_shard_arrays(a),
                         j_pipeline.load_shard_arrays(b)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_synthetic_and_text_tokens_match(tmp_path):
    for args in ((5, 33, 64, 1), (3, 17, 256, 0)):
        for got, want in zip(t_loader.synthetic_token_arrays(*args),
                             j_loader.synthetic_token_arrays(*args)):
            np.testing.assert_array_equal(got, want)
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(bytes(range(256)) * 3)
    assert t_loader.main(["text", "--input", str(corpus), "--output",
                          str(tmp_path / "t"), "--seq-len", "100"]) == 0
    want, _ = j_loader.text_token_arrays(str(corpus), 100)
    got, _ = t_pipeline.load_shard_arrays(str(tmp_path / "t"))
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_batch_pipeline_index_sequence_matches():
    images = np.arange(11 * 3, dtype=np.float32).reshape(11, 3)
    labels = np.arange(11, dtype=np.int32)
    pipes = [mod.BatchPipeline(images, labels, 4, random_skip=5, seed=3)
             for mod in (t_pipeline, j_pipeline)]
    for _ in range(2):
        trace = []
        for p in pipes:
            out = [p.position]
            for i in range(7):
                out += [p.next_batch()[1].tolist(), p.position]
                if i == 3:
                    p.seek(9)
            trace.append(out)
        assert trace[0] == trace[1]


# ---------------------------------------------------------------------------
# params and optim
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method,kw", [
    ("kConstant", dict(value=0.5)),
    ("kUniform", dict(low=-0.3, high=0.7, value=2.0)),
    ("kUniformSqrtFanIn", dict(fan_in=64, value=1.0)),
    ("kUniformSqrtFanInOut", dict(value=1.0)),
    ("kGaussain", dict(mean=0.1, std=0.02, value=0.0)),
    ("kGaussainSqrtFanIn", dict(std=1.0, value=1.0)),
    ("kPretrained", dict()),
])
def test_init_methods_match_by_distribution(method, kw):
    """RNG parity is by distribution: the same support and moments
    (2e-2 of the scale) as the JAX package's init, scaling quirks
    included."""
    shape = (256, 128)
    got = t_params.init_param(
        torch.Generator().manual_seed(0),
        t_params.ParamSpec("w", shape, init_method=method, **kw),
    ).numpy()
    want = np.asarray(j_params.init_param(
        jax.random.PRNGKey(0),
        j_params.ParamSpec("w", shape, init_method=method, **kw),
    ))
    assert got.shape == want.shape and got.dtype == np.float32
    scale = max(np.abs(want).max(), 1e-6)
    assert abs(got.mean() - want.mean()) <= 2e-2 * scale
    assert abs(got.std() - want.std()) <= 2e-2 * scale
    assert got.min() >= want.min() - 0.1 * scale
    assert got.max() <= want.max() + 0.1 * scale


def test_init_errors_match():
    for spec in (dict(init_method="kUniformSqrtFanIn", fan_in=0),
                 dict(init_method="kBogus")):
        with pytest.raises(ConfigError):
            t_params.init_param(torch.Generator(),
                                t_params.ParamSpec("w", (2, 2), **spec))


SCHEDULES = {
    "kFixed": "",
    "kLinear": "learning_rate_change_frequency: 10 final_learning_rate: 0.01",
    "kExponential": "learning_rate_change_frequency: 3 "
                    "final_learning_rate: 0.05",
    "kInverse_t": "final_learning_rate: 0.05",
    "kInverse": "gamma: 0.1 pow: 0.75",
    "kStep": "gamma: 0.5 learning_rate_change_frequency: 2",
}


def _updater_cfg(parse, kind, schedule):
    return parse(
        f'updater {{ type: "{kind}" base_learning_rate: 0.1 momentum: 0.9 '
        f'weight_decay: 0.01 learning_rate_change_method: "{schedule}" '
        f"{SCHEDULES[schedule]} }}"
    ).updater


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize(
    "kind", ["kSGD", "kNesterov", "kAdaGrad", "kRMSProp", "kAdaDelta"]
)
def test_updaters_match_jax(kind, schedule):
    """Every updater x every schedule, 5 steps on the same grads, with
    per-param lr/wd multipliers; same slot names, values at 1e-6."""
    rs = np.random.RandomState(0)
    shapes = {"a/w": (4, 3), "b/b": (5,)}
    p0 = {n: rs.randn(*s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: rs.randn(*s).astype(np.float32) for n, s in shapes.items()}
             for _ in range(5)]
    spec_kw = {"a/w": dict(lr_mult=2.0, wd_mult=0.5), "b/b": {}}
    ju = j_optim.make_updater(_updater_cfg(j_parse, kind, schedule))
    tu = t_optim.make_updater(_updater_cfg(t_parse, kind, schedule))
    assert tu.SLOTS == ju.SLOTS
    jspecs = {n: j_params.ParamSpec(n, shapes[n], **spec_kw[n])
              for n in shapes}
    tspecs = {n: t_params.ParamSpec(n, shapes[n], **spec_kw[n])
              for n in shapes}
    jp = {n: jnp.asarray(v) for n, v in p0.items()}
    tp = {n: torch.from_numpy(v.copy()) for n, v in p0.items()}
    js, ts = ju.init_state(jp), tu.init_state(tp)
    for step, g in enumerate(grads):
        jp, js = ju.apply(jnp.int32(step), jp,
                          {n: jnp.asarray(v) for n, v in g.items()}, js,
                          jspecs)
        tp, ts = tu.apply(step, tp,
                          {n: torch.from_numpy(v) for n, v in g.items()}, ts,
                          tspecs)
    for n in shapes:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   atol=1e-6, rtol=1e-6, err_msg=n)
        assert set(ts[n]) == set(js[n])
        for slot in ts[n]:
            np.testing.assert_allclose(ts[n][slot].numpy(),
                                       np.asarray(js[n][slot]),
                                       atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_learning_rate_schedules_match(schedule):
    jc = _updater_cfg(j_parse, "kSGD", schedule)
    tc = _updater_cfg(t_parse, "kSGD", schedule)
    for step in range(25):
        assert float(t_optim.learning_rate(tc, step)) == pytest.approx(
            float(j_optim.learning_rate(jc, step)), rel=1e-6, abs=1e-9)


def test_updater_config_errors_match():
    bad = [
        'updater { type: "kSGD" base_learning_rate: 0.1 '
        'learning_rate_change_method: "kExponential" '
        "final_learning_rate: 0.01 learning_rate_change_frequency: 2 }",
        'updater { type: "kSGD" base_learning_rate: 0.1 '
        'learning_rate_change_method: "kInverse_t" final_learning_rate: 1 }',
    ]
    for text in bad:
        for parse, optim in ((j_parse, j_optim), (t_parse, t_optim)):
            with pytest.raises(ValueError, match="2\\*final"):
                optim.learning_rate(parse(text).updater, 0)
    for parse, optim in ((j_parse, j_optim), (t_parse, t_optim)):
        with pytest.raises(Exception, match="base_learning_rate"):
            optim.make_updater(parse('updater { type: "kSGD" }').updater)
        cfg = parse('updater { type: "kSGD" base_learning_rate: 0.1 }').updater
        cfg.type = "kBogus"
        with pytest.raises(Exception, match="unknown updater"):
            optim.make_updater(cfg)


# ---------------------------------------------------------------------------
# layers and the net
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def both_forwards(shard):
    """One forward of the narrowed conf through both packages on the
    JAX init's params, the port on its flash path -> (JAX acts, port
    acts, port net, the port's flash forwards)."""
    from singa_tpu_torch.ops import attention as ta

    jnet = j_build_net(j_parse(narrow_conf(shard)))
    tnet = t_build_net(t_parse(narrow_conf(shard)))
    jp = j_params.init_params(jax.random.PRNGKey(0), jnet.param_specs())
    tp = params_from_numpy(tnet, np_params(jp))
    tokens = jnet.name2layer["data"].images[:2]
    labels = np.zeros(2, np.int32)
    flash_calls = []
    plain = ta.flash_fwd_plain
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SINGA_TPU_DENSE_ATTN_MB", "0")
        mp.setattr(ta, "flash_fwd_plain",
                   lambda *a: flash_calls.append(1) or plain(*a))
        _, jm, jacts = jnet.forward(
            jp, {"data": {"image": jnp.asarray(tokens),
                          "label": jnp.asarray(labels)}},
            training=True, return_acts=True,
        )
        _, tm, tacts = tnet.forward(
            tp, {"data": {"image": torch.from_numpy(tokens),
                          "label": torch.from_numpy(labels)}},
            training=True, return_acts=True,
        )
    return (jm, jacts), (tm, tacts), tnet, len(flash_calls)


@pytest.mark.parametrize("kind", [
    "kSequenceData", "kEmbedding", "kLayerNorm", "kAttention", "kAdd",
    "kDense", "kLMLoss",
])
def test_each_layer_forward_matches_jax(both_forwards, kind):
    (jm, jacts), (tm, tacts), tnet, _ = both_forwards
    layers = [l for l in tnet.layers if l.TYPE == kind]
    assert layers
    for layer in layers:
        got, want = tacts[layer.name], jacts[layer.name]
        if kind == "kSequenceData":
            got, want = got["image"], want["image"]
        np.testing.assert_allclose(
            got.detach().numpy(), np.asarray(want), err_msg=layer.name, **ACT)
    if kind == "kLMLoss":
        for k in ("loss", "precision"):
            assert float(tm["loss"][k]) == pytest.approx(
                float(jm["loss"][k]), abs=2e-5)


def test_attention_layers_took_the_flash_path(both_forwards):
    assert both_forwards[-1] == 2  # one flash forward per kAttention


def test_registry_covers_the_jax_package():
    """The port registers exactly the JAX package's layer types."""
    assert set(registered_types()) == set(j_registered())


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------


def test_trainer_matches_jax_trainer_over_five_steps(shard, monkeypatch):
    """5 steps of the port's Trainer (flash path) and the JAX Trainer
    from the same params on the same batches: losses within 1e-4."""
    monkeypatch.setenv("SINGA_TPU_DENSE_ATTN_MB", "0")
    jt = j_trainer(j_parse(narrow_conf(shard)))
    tt = t_trainer(t_parse(narrow_conf(shard)))
    tt.params = params_from_numpy(tt.train_net, np_params(jt.params))
    losses = [(step_loss(jt, s), step_loss(tt, s)) for s in range(5)]
    for j, t in losses:
        assert abs(j - t) <= 1e-4, losses
    assert losses[-1][1] < losses[0][1]
    for n, v in tt.params.items():
        assert v.dtype == torch.float32
        np.testing.assert_allclose(v.numpy(), np.asarray(jt.params[n]),
                                   atol=1e-4, err_msg=n)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_resume_in_the_other_package(shard, tmp_path, writer):
    """2 steps, save, resume in the other package: params, updater
    slots, step and stream position carry over, and the next step's
    loss agrees within 1e-4."""
    ws = str(tmp_path / "ws")
    jc = j_cluster(f'workspace: "{ws}"')
    tc = t_cluster(f'workspace: "{ws}"')
    if writer == "jax":
        src = j_trainer(j_parse(narrow_conf(shard)), jc)
    else:
        src = t_trainer(t_parse(narrow_conf(shard)), tc)
    for s in range(2):
        src.train_one_batch(s)
    path = src.save(2)
    assert os.path.exists(path)
    resume = f'checkpoint: "{path}"'
    if writer == "jax":
        dst = t_trainer(t_parse(narrow_conf(shard, resume)))
    else:
        dst = j_trainer(j_parse(narrow_conf(shard, resume)))
    assert dst.start_step == 2
    for n in src.params:
        np.testing.assert_array_equal(np.asarray(dst.params[n]),
                                      np.asarray(src.params[n]))
        for slot, v in src.state[n].items():
            np.testing.assert_array_equal(np.asarray(dst.state[n][slot]),
                                          np.asarray(v))
    assert dst._stream_positions() == src._stream_positions()
    src.perf.reset()
    assert abs(step_loss(src, 2) - step_loss(dst, 2)) <= 1e-4


def test_evaluate_matches_jax(shard, monkeypatch):
    """A kTest net over the same shard: the cadence loop runs the test
    phase before the train step it triggers on, and its averaged metrics
    match the JAX Trainer's evaluate from the same params."""
    monkeypatch.setenv("SINGA_TPU_DENSE_ATTN_MB", "0")
    extra = "test_steps: 2 test_frequency: 2"
    jt = j_trainer(j_parse(narrow_conf(shard, extra)))
    logs = []
    tt = Trainer(t_parse(narrow_conf(shard, extra).replace(
        "train_steps: 2000", "train_steps: 3")), log=logs.append,
        device="cpu")
    tt.params = params_from_numpy(tt.train_net, np_params(jt.params))
    want = jt.evaluate(jt.test_net, 2, "test", 0)
    got = tt.evaluate(tt.test_net, 2, "test", 0)
    for k in ("loss", "precision"):
        assert got["loss"][k] == pytest.approx(want["loss"][k], abs=2e-5)
    tt.run()
    assert [l.split(":")[0] for l in logs if ": test " in l] == \
        ["step 0", "step 0", "step 2"]


def test_main_runs_two_steps_on_the_cpu(shard, tmp_path):
    conf = tmp_path / "job.conf"
    conf.write_text(
        narrow_conf(shard).replace("train_steps: 2000", "train_steps: 2")
        .replace("display_frequency: 100", "display_frequency: 1")
    )
    res = subprocess.run(
        [sys.executable, "-m", "singa_tpu_torch.main", "-model_conf",
         str(conf), "-device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=str(REPO),
    )
    assert res.returncode == 0, res.stderr
    lines = [l for l in res.stdout.splitlines() if ": train loss" in l]
    assert [l.split(":")[0] for l in lines] == ["step 0", "step 1"], \
        res.stdout
    assert "tok/s" in lines[-1]


# ---------------------------------------------------------------------------
# what the slice refuses
# ---------------------------------------------------------------------------


def test_unported_layer_type_is_refused_by_name(shard):
    """An unknown type is refused by name, and a layer type a seq axis
    does not run is refused there by name (a partition_type builds);
    kMoE builds, and refuses a layer without its moe_param by name."""
    txt = narrow_conf(shard).replace(
        'layer { name: "ln_f" type: "kLayerNorm"',
        'layer { name: "ln_f" type: "kMoE"')
    with pytest.raises(ConfigError, match="moe_param required"):
        t_build_net(t_parse(txt))
    with pytest.raises(ConfigError, match="unknown layer type"):
        t_build_net(t_parse(txt.replace("kMoE", "kBogus")))
    net = t_build_net(t_parse(txt.replace(
        'type: "kMoE"',
        'type: "kLayerNorm" partition_type: kDataPartition')))
    assert net.name2layer["ln_f"].partition_type == "kDataPartition"
    cl = t_cluster('workspace: "ws" nworkers: 2 nprocs_per_group: 2 '
                   'nseq_per_group: 2')
    moe = txt.replace('layer { name: "ln_f" type: "kMoE"',
                      'layer { name: "ln_f" type: "kMoE" moe_param { '
                      'num_experts: 2 d_ff: 8 }')
    # kMoE routes the gathered sequence on a seq axis since it joined
    # SEQ_LAYERS; a type outside the list is still refused by name
    assert t_trainer(t_parse(moe), cl).mesh_shape["seq"] == 2
    with pytest.raises(ConfigError,
                       match="'ln_f' \\(kDropout\\) on the seq axis"):
        t_trainer(t_parse(txt.replace('type: "kMoE"', 'type: "kDropout"')),
                  cl)


@pytest.mark.parametrize("extra,cluster,knob", [
    ("kernels { grad_allreduce: quantized_ring }", "", "grad_comm"),
    ('ring { intra_axis: "data" inter_axis: "model" }', "", "ring"),
    ("resilience { }", "", "resilience"),
    ("fleet { }", "", "fleet"),
    ("pipeline_microbatches: 2", "", "pipeline_microbatches"),
    ("", "nworkers: 4", "nworkers"),
    ("", "nworkers: 2 nprocs_per_group: 2 nseq_per_group: 2",
     "nseq_per_group"),
])
def test_unported_knobs_are_refused_by_name(shard, tmp_path, extra, cluster,
                                            knob):
    """What the port does not run is refused by name; the knobs it has
    ported since (the named ring block, pipeline_microbatches, a seq
    axis, the resilience block) build, and ``unsupported`` no longer
    names them."""
    cl = t_cluster(f'workspace: "{tmp_path}" {cluster}') if cluster else None
    cfg = t_parse(narrow_conf(shard, extra))
    if knob in ("ring", "pipeline_microbatches", "nseq_per_group",
                "resilience"):
        assert t_unsupported(cfg, cl) == []
        t_trainer(cfg, cl)
        return
    with pytest.raises(ConfigError, match=knob):
        t_trainer(cfg, cl)
