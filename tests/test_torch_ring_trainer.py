"""The port's data-parallel Trainer (singa_tpu_torch: trainer, parallel)
on n CPU ranks against the JAX Trainer on the suite's virtual CPU
devices: losses over 5 steps within 1e-4 for exact data parallel, the
reference q8 seam, the flat int8 ring and q8_hier; wire bytes against
the models; conf refusals; the cluster mesh; checkpoints. Split from
tests/test_torch_ring.py (the ring alone), whose helpers it uses.
"""

import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from singa_tpu.config import parse_cluster_config as j_cluster
from singa_tpu.config import parse_model_config as j_parse
from singa_tpu.config.schema import ConfigError as JConfigError
from singa_tpu.ops import quantized_collective as jq
from singa_tpu.parallel import apply_grad_comm_tag as j_tag
from singa_tpu.parallel import build_mesh as j_mesh
from singa_tpu.parallel.collectives import GradCommSpec as JSpec
from singa_tpu.trainer import Trainer as JTrainer
from singa_tpu_torch.config import ConfigError
from singa_tpu_torch.config import parse_cluster_config as t_cluster
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.data import loader as t_loader
from singa_tpu_torch.ops import quantized_collective as tq
from singa_tpu_torch.parallel import (
    GradCommSpec,
    apply_grad_comm_tag,
    build_mesh,
    is_residual_key,
    mesh_from_cluster,
)
from singa_tpu_torch.trainer import Trainer, params_from_numpy
from test_torch_ring import as_np

REPO = pathlib.Path(__file__).resolve().parent.parent
CONF = REPO / "examples" / "lm" / "tinylm_d128.conf"
LOSS_TOL = 1e-4


# ---------------------------------------------------------------------------
# the Trainer, against the JAX Trainer
# ---------------------------------------------------------------------------


def narrow_conf(shard: str, extra: str = "") -> str:
    """tinylm_d128.conf at d_model 64, 2 x 32 heads, d_ff 128, S 32 (the
    shard's), batch 8, float32."""
    txt = CONF.read_text()
    for old, new in (
        ("examples/lm/train_shard", shard),
        ("batchsize: 64", "batchsize: 8"),
        ("embedding_dim: 256", "embedding_dim: 64"),
        ("num_output: 1024", "num_output: 128"),
        ("num_output: 256 }", "num_output: 64 }"),
        ('compute_dtype: "bfloat16"', ""),
    ):
        assert old in txt, old
        txt = txt.replace(old, new)
    return txt + "\n" + extra


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ring_tokens") / "shard")
    t_loader.write_records(
        path, *t_loader.synthetic_token_arrays(32, seq_len=32, vocab=256)
    )
    return path


def make_cfgs(shard, tag, extra=""):
    """(JAX cfg, port cfg) of the narrow conf with a grad_comm tag and 4
    buckets, as bench.py's lm_d128_q8* rows build them."""
    cfgs = []
    for parse, tagger in ((j_parse, j_tag), (t_parse, apply_grad_comm_tag)):
        cfg = parse(narrow_conf(shard, extra))
        if tag != "exact":
            tagger(cfg, tag)
            cfg.grad_comm.buckets = 4
        cfgs.append(cfg)
    return cfgs


def j_trainer(cfg, n=4, cluster=None):
    return JTrainer(cfg, cluster, mesh=j_mesh(n, 1, jax.devices()[:n]),
                    seed=0, log=lambda s: None, prefetch=False)


def t_trainer(cfg, n=4, cluster=None, **kw):
    return Trainer(cfg, cluster, mesh=build_mesh(n, 1, ["cpu"] * n),
                   seed=0, log=lambda s: None, **kw)


def step_loss(tr, step):
    tr.train_one_batch(step)
    loss = tr.perf.avg()["loss"]["loss"]
    tr.perf.reset()
    return loss


def residuals(tr):
    return {k: np.asarray(v) for k, v in tr.buffers.items()
            if is_residual_key(k)}


@pytest.fixture(scope="module")
def trained(shard):
    """tag -> (JAX trainer, port trainer, [(JAX loss, port loss)] over 5
    steps), both from the JAX init's params on 4 ranks."""
    out = {}
    for tag in ("exact", "q8", "q8wire", "q8hier"):
        jc, tc = make_cfgs(shard, tag)
        jt, tt = j_trainer(jc), t_trainer(tc)
        tt.params = params_from_numpy(
            tt.train_net, {n: np.asarray(v) for n, v in jt.params.items()})
        out[tag] = (jt, tt, [(step_loss(jt, s), step_loss(tt, s))
                             for s in range(5)])
    return out


@pytest.mark.parametrize("tag", ["exact", "q8", "q8wire", "q8hier"])
def test_trainer_matches_jax_trainer_data_parallel(trained, tag):
    """4 ranks, 5 steps from the same params on the same batches: losses
    within 1e-4; the reduction the tag names is the one that ran; the
    residuals within one quantization step of the JAX Trainer's, and
    within a twentieth of one on average."""
    jt, tt, losses = trained[tag]
    for j, t in losses:
        assert abs(j - t) <= LOSS_TOL, losses
    assert losses[-1][1] < losses[0][1]
    assert tt.grad_wire_impl == jt.grad_wire_impl
    assert (tt.comm_mode, tt.comm_dtype) == (jt.comm_mode, jt.comm_dtype)
    jr, tr = residuals(jt), residuals(tt)
    assert set(jr) == set(tr) == (set() if tag == "exact" else
                                  {f"__gradres__/{n}" for n in tt.params})
    for k, want in jr.items():
        got = tr[k]
        assert got.shape == want.shape
        # |residual| <= half a step on both sides: one step bounds the gap
        step = 2 * max(np.abs(want).max(), np.abs(got).max()) + 1e-12
        assert np.abs(got - want).max() <= step, k
        assert np.abs(got - want).mean() <= 0.05 * step, k
    # a sum that lands the other side of a rounding boundary moves one
    # element by a quantization step, times the learning rate
    atol = 1e-4 if tag == "exact" else 5e-4
    for n, v in tt.params.items():
        np.testing.assert_allclose(as_np(v), np.asarray(jt.params[n]),
                                   atol=atol, err_msg=n)


@pytest.mark.parametrize("tag", ["q8wire", "q8hier"])
def test_wire_bytes_counted_equal_the_models(shard, tag):
    """One ring step's bytes, counted at the port's ppermute for every
    rank, equal the port's modeled_wire_bytes (the per-level split for
    q8hier) and the JAX package's functions of the same name."""
    _, tc = make_cfgs(shard, tag)
    tt = t_trainer(tc)
    tq.ppermute.sent_bytes.clear()
    tt.train_one_batch(0)
    sizes = {n: int(np.prod(s.shape)) for n, s in tt.specs.items()}
    buckets = tt._buckets(sizes)
    counted = tq.ppermute.sent_bytes
    model = tt.wire_bytes_model()
    if tag == "q8wire":
        want = tq.modeled_wire_bytes(sizes, buckets, 4)
        assert want == jq.modeled_wire_bytes(sizes, buckets, 4) > 0
        assert dict(counted) == {("data", r): want for r in range(4)}
        assert model["quantized_ring"] == want
    else:
        want = tq.modeled_wire_bytes_levels(sizes, buckets, 4,
                                            intra_degree=2)
        assert want == jq.modeled_wire_bytes_levels(sizes, buckets, 4,
                                                    intra_degree=2)
        assert dict(counted) == {(lv, r): want[lv] for r in range(4)
                                 for lv in ("intra", "inter")}
        assert (model["intra"], model["inter"]) == (want["intra"],
                                                    want["inter"])
    assert tt.modeled_wire_bytes_per_step() == model["quantized_ring"]
    assert model["reference"] == tq.reference_wire_bytes(sizes, 4) == \
        jq.reference_wire_bytes(sizes, 4)


@pytest.mark.parametrize("tag", ["q8", "q8wire", "q8hier", "bf16", "exact"])
def test_grad_comm_tags_and_specs_match(shard, tag):
    jc, tc = make_cfgs(shard, tag) if tag != "bf16" else [
        tagger(parse(narrow_conf(shard)), "bf16")
        for parse, tagger in ((j_parse, j_tag), (t_parse, apply_grad_comm_tag))
    ]
    assert tc.to_dict() == jc.to_dict()
    js = JSpec.from_config(jc.grad_comm, jc.kernels, jc.ring)
    ts = GradCommSpec.from_config(tc.grad_comm, tc.kernels, tc.ring)
    if js is None:
        assert ts is None
        return
    for field in ("mode", "dtype", "error_feedback", "buckets", "wire_impl",
                  "interpret", "intra_degree", "ring", "hier",
                  "wants_residuals"):
        assert getattr(ts, field) == getattr(js, field), field


def _refusal(shard, case):
    """(JAX callable, port callable) that must raise, per case."""
    q8 = "grad_comm { mode: quantized }"
    ring = "kernels { grad_allreduce: quantized_ring }"
    if case == "batch":        # 3 ranks do not divide the batch of 8
        jc, tc = make_cfgs(shard, "q8wire")
        return lambda: j_trainer(jc, 3), lambda: t_trainer(tc, 3)
    if case == "dim":          # b0_up/bias (126,) over 4 ranks
        extra_conf = narrow_conf(shard).replace("num_output: 128",
                                                "num_output: 126")
        jc, tc = (p(extra_conf + "\n" + q8 + "\n" + ring)
                  for p in (j_parse, t_parse))
        return lambda: j_trainer(jc), lambda: t_trainer(tc)
    if case == "no quantized block":
        jc, tc = (p(narrow_conf(shard, ring)) for p in (j_parse, t_parse))
        return lambda: j_trainer(jc), lambda: t_trainer(tc)
    if case == "interpret off":  # 64-element chunks do not tile (8, 128)
        text = q8 + "\nkernels { grad_allreduce: quantized_ring " \
            "interpret: false }"
        jc, tc = (p(narrow_conf(shard, text)) for p in (j_parse, t_parse))
        return lambda: j_trainer(jc), lambda: t_trainer(tc)
    if case == "hier degree":  # intra_degree 3 does not divide 4
        jc, tc = make_cfgs(shard, "q8hier", "ring { intra_degree: 3 }")
        return lambda: j_trainer(jc), lambda: t_trainer(tc)
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["batch", "dim", "no quantized block",
                                  "interpret off", "hier degree"])
def test_config_errors_match_jax(shard, case):
    jcall, tcall = _refusal(shard, case)
    with pytest.raises(JConfigError) as jerr:
        jcall()
    with pytest.raises(ConfigError) as terr:
        tcall()
    assert str(terr.value) == str(jerr.value)


def test_zero_update_and_a_model_axis_stay_refused(shard, tmp_path):
    """zero_update with the ring runs in both packages (the port's
    composition: tests/test_torch_zero_ring.py); the flat ring on a mesh
    with a model axis is refused by both Trainers with the same message,
    naming the axis (the mesh itself builds in both)."""
    jc, tc = make_cfgs(shard, "q8wire", "zero_update: true")
    assert j_trainer(jc).update_mode == "zero"
    assert t_trainer(tc).update_mode == "zero"
    jc, tc = make_cfgs(shard, "q8wire")
    with pytest.raises(JConfigError, match="'model': 2") as jerr:
        JTrainer(jc, None, mesh=j_mesh(2, 2, jax.devices()[:4]), seed=0,
                 log=lambda s: None, prefetch=False)
    with pytest.raises(ConfigError, match="'model': 2") as terr:
        Trainer(tc, mesh=build_mesh(2, 2, ["cpu"] * 4), log=lambda s: None)
    assert str(terr.value) == str(jerr.value)
    cl = t_cluster(f'workspace: "{tmp_path}" nworkers: 4 nprocs_per_group: 2')
    with pytest.raises(ConfigError, match="'model': 2"):
        Trainer(tc, cl, device="cpu", log=lambda s: None)


def test_cluster_nworkers_builds_the_mesh(shard, tmp_path):
    """``nworkers`` worker groups -> that many ranks on the device named;
    a mesh wider than the devices raises as the JAX package's does."""
    cl = t_cluster(f'workspace: "{tmp_path}" nworkers: 2')
    _, tc = make_cfgs(shard, "q8wire")
    tt = Trainer(tc, cl, device="cpu", log=lambda s: None)
    assert tt.mesh.shape == {"data": 2}
    assert tt._ring_chunk_dims is not None
    assert len(mesh_from_cluster(cl, ["cpu"] * 3).devices) == 2
    with pytest.raises(ConfigError, match="only 1 visible"):
        build_mesh(2, 1, ["cpu"])
    with pytest.raises(JConfigError, match="only 1 visible"):
        j_mesh(2, 1, jax.devices()[:1])


def test_main_trains_on_the_cluster_ranks(shard, tmp_path):
    """``-cluster_conf`` with nworkers 2 and ``-device cpu``: 2 CPU ranks
    through the int8 ring, 2 steps, and a final checkpoint holding the
    residuals."""
    conf = tmp_path / "job.conf"
    conf.write_text(narrow_conf(
        shard, "grad_comm { mode: quantized }\n"
        "kernels { grad_allreduce: quantized_ring }",
    ).replace("train_steps: 2000", "train_steps: 2")
     .replace("display_frequency: 100", "display_frequency: 1"))
    cluster = tmp_path / "cluster.conf"
    cluster.write_text(f'workspace: "{tmp_path / "ws"}" nworkers: 2')
    res = subprocess.run(
        [sys.executable, "-m", "singa_tpu_torch.main", "-model_conf",
         str(conf), "-cluster_conf", str(cluster), "-device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=str(REPO),
    )
    assert res.returncode == 0, res.stderr
    lines = [l for l in res.stdout.splitlines() if ": train loss" in l]
    assert [l.split(":")[0] for l in lines] == ["step 0", "step 1"]
    with np.load(tmp_path / "ws" / "checkpoints" / "step_2.npz") as z:
        assert any(k.startswith("b|__gradres__/") for k in z.files)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_ring_checkpoint_keys_match_jax_and_resume_bitwise(shard, tmp_path):
    """A port ring checkpoint holds the JAX Trainer's b|__gradres__/*
    keys and shapes; a port run resumed at step 3 continues bitwise like
    the run that never stopped (params and residuals)."""
    def run(package, steps, ws, checkpoint=None):
        extra = "checkpoint_frequency: 3"
        if checkpoint:
            extra += f'\ncheckpoint: "{checkpoint}"'
        jc, tc = make_cfgs(shard, "q8wire", extra)
        for c in (jc, tc):
            c.train_steps = steps
        if package == "jax":
            tr = j_trainer(jc, cluster=j_cluster(f'workspace: "{ws}"'))
        else:
            tr = t_trainer(tc, cluster=t_cluster(f'workspace: "{ws}"'))
        tr.run()
        return tr

    jws, tws = tmp_path / "j", tmp_path / "t"
    run("jax", 3, jws)
    full = run("port", 6, tws)
    ck = tws / "checkpoints" / "step_3.npz"
    with np.load(jws / "checkpoints" / "step_3.npz") as jz, np.load(ck) as tz:
        jkeys = {k: jz[k].shape for k in jz.files if k.startswith("b|")}
        tkeys = {k: tz[k].shape for k in tz.files if k.startswith("b|")}
    assert jkeys == tkeys and jkeys
    resumed = run("port", 6, tmp_path / "r", checkpoint=str(ck))
    assert resumed.start_step == 3
    for n, v in full.params.items():
        np.testing.assert_array_equal(as_np(resumed.params[n]), as_np(v))
    a, b = residuals(full), residuals(resumed)
    assert set(a) == set(b) and a
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
