"""The port's quantized gradient ring and data-parallel Trainer
(singa_tpu_torch: ops/quantized_collective, parallel, trainer) against
the JAX package, on the same numpy inputs.

The JAX side runs on the suite's 8 virtual CPU devices
(tests/conftest.py) with ``build_mesh(n, 1, jax.devices()[:n])``; the
port runs its n ranks on the CPU, ``build_mesh(n, 1, ["cpu"] * n)``,
where ``quant_acc`` takes its plain version.

Tolerances, with their reasons:
  - the int8 helpers are bitwise (max, true division, round half to
    even and the cast are exact in both);
  - XLA on the CPU contracts the hop's ``float(q) * scale + local`` into
    one fused multiply-add, the port rounds the product first (as its
    CUDA kernel does), so a hop may differ by 1 ulp: ring outputs are
    held within n ulps of their magnitude, far below one quantization
    step;
  - Trainer losses over 5 steps within 1e-4 (float32, different
    summation orders), as for the single-device Trainer.
"""

import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.config import parse_cluster_config as j_cluster
from singa_tpu.config import parse_model_config as j_parse
from singa_tpu.config.schema import ConfigError as JConfigError
from singa_tpu.config.schema import RingConfig as JRing
from singa_tpu.ops import quantized_collective as jq
from singa_tpu.parallel import apply_grad_comm_tag as j_tag
from singa_tpu.parallel import build_mesh as j_mesh
from singa_tpu.parallel.collectives import GradCommSpec as JSpec
from singa_tpu.trainer import Trainer as JTrainer
from singa_tpu_torch.config import ConfigError
from singa_tpu_torch.config import parse_cluster_config as t_cluster
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.config.schema import RingConfig as TRing
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

REPO = pathlib.Path(__file__).resolve().parent.parent
CONF = REPO / "examples" / "lm" / "tinylm_d128.conf"
LOSS_TOL = 1e-4


def as_np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


# ---------------------------------------------------------------------------
# helpers and the per-hop kernel
# ---------------------------------------------------------------------------


HELPER_CASES = {
    "random": [np.random.RandomState(0).randn(7, 5), np.random.RandomState(
        1).randn(11) * 3],
    "zero bucket": [np.zeros((4,)), np.zeros((2, 3))],
    "nan poisons": [np.array([1.0, np.nan, -2.0]), np.array([0.5])],
    # scale 127/127 = 1 exactly: e / scale lands on exact halves
    "half ties": [np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5])],
}


@pytest.mark.parametrize("case", sorted(HELPER_CASES))
def test_int8_helpers_match_jax_bitwise(case):
    arrays = [a.astype(np.float32) for a in HELPER_CASES[case]]
    js = jq.symmetric_scale([jnp.asarray(a) for a in arrays])
    ts = tq.symmetric_scale([torch.from_numpy(a) for a in arrays])
    np.testing.assert_array_equal(as_np(ts), np.asarray(js))
    for a in arrays:
        jw = jq.quantize_int8(jnp.asarray(a), js)
        tw = tq.quantize_int8(torch.from_numpy(a), ts)
        if np.isfinite(np.asarray(js)):  # a NaN scale's bytes are unspecified
            np.testing.assert_array_equal(as_np(tw), np.asarray(jw))
        # dequantized: equal, NaN where the scale is NaN
        np.testing.assert_array_equal(
            as_np(tq.dequantize_int8(tw, ts)),
            np.asarray(jq.dequantize_int8(jnp.asarray(as_np(tw)), js)))
    if case == "zero bucket":
        assert float(ts) > 0
    if case == "nan poisons":
        assert np.isnan(as_np(tq.dequantize_int8(tw, ts))).all()
    if case == "half ties":  # half to even, both ways
        assert as_np(tw).tolist() == [127, 0, 2, 2, 0, -2, -2, 126]


@pytest.mark.parametrize("shape", [(8, 128), (3,), (64,)])
def test_quant_acc_plain_matches_jax_interpret(shape):
    """The port's hop on the CPU (quant_acc -> quant_acc_plain) against
    the JAX package's Pallas kernel in interpret mode: within 1 ulp of the
    operands' magnitude (XLA fuses the multiply-add, which matters most
    where the sum cancels)."""
    rs = np.random.RandomState(2)
    g = rs.randn(*shape).astype(np.float32)
    local = rs.randn(*shape).astype(np.float32)
    js = jq.symmetric_scale([jnp.asarray(g)])
    jqv = jq.quantize_int8(jnp.asarray(g), js)
    want = np.asarray(jq.quant_acc(jqv, js, jnp.asarray(local),
                                   interpret=True))
    tqv = torch.from_numpy(np.array(jqv))
    ts = torch.from_numpy(np.array(js))
    got = tq.quant_acc(tqv, ts, torch.from_numpy(local))
    assert tq.quant_acc.launches == 0  # the CPU takes the plain version
    magnitude = np.abs(np.array(jqv, np.float32) * np.array(js)) + np.abs(local)
    assert (np.abs(as_np(got) - want) <= np.spacing(magnitude)).all()
    np.testing.assert_array_equal(
        as_np(got), as_np(tq.quant_acc_plain(tqv, ts, torch.from_numpy(local))))


def test_quant_acc_refuses_bad_operands():
    q = torch.zeros(4, dtype=torch.int8)
    s = torch.ones(())
    x = torch.zeros(4)
    for args, what in (
        ((q.float(), s, x), "int8"),
        ((q, s.double(), x), "one float32"),
        ((q[:3], s, x), "shape"),
        ((torch.zeros(4, 2, dtype=torch.int8).t()[0], s, torch.zeros(4, 2).t()[0]),
         "contiguous"),
    ):
        with pytest.raises(ValueError, match=what):
            tq.quant_acc(*args)


PREDICATE_CASES = [
    ("reducible", ({"w": (8, 3), "b": (4,)}, 4)),
    ("reducible", ({"w": (8, 3), "b": (4,)}, 1)),
    ("reducible", ({"b": (10,)}, 4)),
    ("reducible", ({"s": ()}, 2)),
    ("reducible", ({"w": (3, 8)}, 4, {"w": 1})),
    ("fusable", ({"w": (4, 3)}, 2, None, True)),
    ("fusable", ({"w": (16, 512)}, 2, None, False)),
    ("fusable", ({"w": (4, 3)}, 2, None, False)),
    ("fusable", ({"w": (256, 256), "b": (256,)}, 4, None, False)),
    ("hier", ({"data": 4}, dict(intra_degree=2))),
    ("hier", ({"data": 8}, dict(intra_degree=2))),
    ("hier", ({"data": 1}, dict(intra_degree=2))),
    ("hier", ({"data": 2, "model": 2},
              dict(intra_axis="model", inter_axis="data"))),
    ("hier", ({"data": 4}, None)),
    ("hier", ({"data": 4}, dict(intra_degree=3))),
    ("hier", ({"data": 4, "model": 2}, dict(intra_degree=2))),
    ("hier", ({"data": 4}, dict(intra_degree=2, intra_axis="data",
                                inter_axis="data"))),
    ("hier", ({"data": 4}, dict(intra_axis="data"))),
    ("hier", ({"data": 4}, dict(intra_axis="data", inter_axis="data"))),
    ("hier", ({"data": 2, "model": 2},
              dict(intra_axis="modle", inter_axis="data"))),
    ("hier", ({"data": 2, "model": 2, "expert": 2},
              dict(intra_axis="model", inter_axis="expert"))),
    ("hier", ({"data": 2, "model": 2, "expert": 2},
              dict(intra_axis="model", inter_axis="data"))),
]


@pytest.mark.parametrize("kind,args", PREDICATE_CASES)
def test_geometry_predicates_give_the_jax_verdicts(kind, args):
    if kind == "reducible":
        got, want = tq.ring_reducible(*args), jq.ring_reducible(*args)
    elif kind == "fusable":
        got, want = tq.ring_fusable(*args), jq.ring_fusable(*args)
    else:
        widths, ring = args
        got = tq.hier_ring_geometry(widths, None if ring is None
                                    else TRing(**ring))
        want = jq.hier_ring_geometry(widths, None if ring is None
                                     else JRing(**ring))
    assert got == want


# ---------------------------------------------------------------------------
# the ring against the JAX package's under shard_map
# ---------------------------------------------------------------------------


SHAPES = {"a": (8, 12), "b": (16,), "c": (4, 8, 3)}


def jax_ring(grads, res, buckets, cdims, ef, hier, shapes=SHAPES):
    """The JAX ring under shard_map: rank r's partials are grads[r], its
    residual chunk is chunk r of ``res``. -> (per-rank outputs, whole new
    residuals)."""
    from jax.sharding import PartitionSpec as P

    n = len(grads)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]), ("data",))
    rkey = lambda nm: "res/" + nm  # noqa: E731
    cspec = {k: P(*([None] * cdims[k] + ["data"])) for k in shapes}
    rspec = {rkey(k): cspec[k] for k in shapes}

    def body(gs, rs):
        out, nr = jq.ring_reduce_gradients(
            {k: v[0] for k, v in gs.items()}, rs, buckets,
            axis_name="data", nshards=n, chunk_dims=cdims,
            gather={k: True for k in shapes}, dtype="int8",
            error_feedback=ef, residual_key=rkey,
            hier=None if hier is None else ("data", "data", *hier))
        return {k: v[None] for k, v in out.items()}, nr

    fn = jq.shard_map(
        body, mesh=mesh,
        in_specs=({k: P("data") for k in shapes}, rspec),
        out_specs=({k: P("data") for k in shapes}, rspec if ef else {}),
        check_rep=False,
    )
    out, new_res = fn(
        {k: jnp.asarray(np.stack([g[k] for g in grads])) for k in shapes},
        {rkey(k): jnp.asarray(v) for k, v in res.items()},
    )
    return ([{k: np.asarray(v[r]) for k, v in out.items()}
             for r in range(n)],
            {k[4:]: np.asarray(v) for k, v in new_res.items()})


RING_CASES = [
    (n, nb, ef, False, None)
    for n in (2, 4) for nb in (1, 2) for ef in (True, False)
] + [
    (2, 1, True, True, None),      # a chunk dim of 1
    (4, 2, True, False, (2, 2)),   # q8_hier, K = M = 2
    (4, 1, False, False, (2, 2)),
]


def ring_inputs(seed, n, shapes=SHAPES):
    """Seeded per-rank partials and whole residuals (numpy)."""
    rs = np.random.RandomState(seed)
    grads = [{k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(n)]
    res = {k: (rs.randn(*s) * 1e-3).astype(np.float32)
           for k, s in shapes.items()}
    return grads, res


def port_ring(grads, res, buckets, cdims, ef, hier):
    """The port's ring on n CPU ranks, each given its residual chunk r."""
    n = len(grads)
    return tq.ring_reduce_gradients(
        [{k: torch.from_numpy(v) for k, v in g.items()} for g in grads],
        [{"res/" + k: torch.from_numpy(np.ascontiguousarray(
            np.split(v, n, axis=cdims[k])[r])) for k, v in res.items()}
         for r in range(n)],
        buckets, chunk_dims=cdims, error_feedback=ef,
        residual_key=lambda nm: "res/" + nm, hier=hier,
    )


def check_against_jax(grads, res, buckets, cdims, ef, hier, shapes=SHAPES):
    n = len(grads)
    want, want_res = jax_ring(grads, res, buckets, cdims, ef, hier, shapes)
    got, got_res = port_ring(grads, res, buckets, cdims, ef, hier)
    # a hop's 1-ulp difference in a sum shows in the outputs and in the
    # residuals (sum - dequantized) at the sums' magnitude
    atol = n * np.spacing(max(np.abs(w).max() for w in want[0].values()))
    for r in range(n):
        for k in shapes:
            np.testing.assert_allclose(as_np(got[r][k]), want[r][k], rtol=0,
                                       atol=atol, err_msg=(r, k))
            # every rank holds the same bits
            np.testing.assert_array_equal(as_np(got[r][k]),
                                          as_np(got[0][k]))
    assert bool(got_res[0]) == ef
    for k, w in want_res.items():
        whole = np.concatenate([as_np(g["res/" + k]) for g in got_res],
                               axis=cdims[k])
        np.testing.assert_allclose(whole, w, rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("n,nb,ef,dim1,hier", RING_CASES)
def test_ring_reduce_matches_jax_ring(n, nb, ef, dim1, hier):
    grads, res = ring_inputs(n * 10 + nb, n)
    cdims = {k: 0 for k in SHAPES}
    if dim1:
        cdims["a"] = 1
    buckets = (tuple(SHAPES),) if nb == 1 else (("a",), ("b", "c"))
    check_against_jax(grads, res, buckets, cdims, ef, hier)


#: params chunked along different dims, whose per-rank chunks (21, 10, 3
#: and 6 elements on 4 ranks) are multiples of neither 4 nor 16, so a
#: bucket's rows (C = 31 and 9, or 40 with all four in one bucket) are
#: ragged and each param starts at a ragged offset
RAGGED = {"e": (4, 7, 3), "f": (5, 8), "g": (12,), "h": (2, 3, 4)}
RAGGED_DIMS = {"e": 0, "f": 1, "g": 0, "h": 2}


@pytest.mark.parametrize("ef,hier", [(True, None), (False, (2, 2))])
def test_ragged_mixed_dim_bucket_matches_jax_ring(ef, hier):
    grads, res = ring_inputs(40 + ef, 4, RAGGED)
    check_against_jax(grads, res, (("f", "e"), ("h", "g")), RAGGED_DIMS, ef,
                      hier, RAGGED)


@pytest.mark.parametrize("ef", [True, False])
@pytest.mark.parametrize("hier", [None, (2, 2), (4, 1)])
def test_permuting_a_bucket_is_bitwise_neutral(ef, hier):
    """The bucket's rows are laid out in bucket order, but the scale is
    one per bucket and every element takes the same operations: any order
    of the params gives the same outputs and residuals to the bit."""
    grads, res = ring_inputs(7, 4, RAGGED)
    runs = [port_ring(grads, res, (order,), RAGGED_DIMS, ef, hier)
            for order in (("e", "f", "g", "h"), ("h", "f", "e", "g"),
                          ("g", "h", "e", "f"))]
    for out, new_res in runs[1:]:
        for r in range(4):
            for k, v in runs[0][0][r].items():
                assert torch.equal(out[r][k], v), (r, k)
            assert new_res[r].keys() == runs[0][1][r].keys()
            for k, v in runs[0][1][r].items():
                assert torch.equal(new_res[r][k], v), (r, k)


@pytest.mark.parametrize("ef", [True, False])
@pytest.mark.parametrize("n,nb,hier", [(4, 2, None), (2, 1, None),
                                       (4, 2, (2, 2)), (8, 2, (2, 4))])
def test_one_quant_acc_per_rank_bucket_and_hop(monkeypatch, n, nb, hier, ef):
    """quant_acc runs once per rank, bucket and quantized reduce hop (n-1
    flat, M-1 inter hops on q8_hier), whatever the params in a bucket;
    every hop whose sum feeds another scale returns its max-abs from the
    same call: all but the last, and the last too when no residual is
    added before the owner's quantize."""
    calls = []
    real = tq.quant_acc

    def counted(q, s, x, *, amax=False):
        calls.append(amax)
        return real(q, s, x, amax=amax)

    monkeypatch.setattr(tq, "quant_acc", counted)
    shapes = {"a": (8, 16), "b": (16,), "c": (8, 8, 3)}
    grads, res = ring_inputs(n, n, shapes)
    buckets = (tuple(shapes),) if nb == 1 else (("a",), ("b", "c"))
    port_ring(grads, res, buckets, {k: 0 for k in shapes}, ef, hier)
    hops = n - 1 if hier is None else hier[1] - 1
    assert len(calls) == n * nb * hops
    assert sum(calls) == n * nb * (hops - 1 if ef else hops)


@pytest.mark.parametrize("case", sorted(HELPER_CASES) + ["inf", "-0.0"])
def test_scale_from_the_fused_amax_equals_symmetric_scale(case):
    """The scale the ring forms from quant_acc's amax is bitwise the one
    symmetric_scale forms from the same sums: NaN poisons both, -0.0
    counts as 0 and an all-zero sum takes the floor."""
    arrays = {**HELPER_CASES, "inf": [np.array([1.0, np.inf, -3.0])],
              "-0.0": [np.array([-0.0, 0.0, -0.0])]}[case]
    local = torch.from_numpy(np.concatenate(
        [np.ravel(a) for a in arrays]).astype(np.float32))
    rs = np.random.RandomState(3)
    q = torch.from_numpy(rs.randint(-127, 128, local.numel()).astype(np.int8))
    if case in ("zero bucket", "-0.0"):
        q.zero_()
    scale = torch.tensor(np.float32(1e-3))
    out, amax = tq.quant_acc(q, scale, local, amax=True)
    got, want = tq.scale_from_amax(amax), tq.symmetric_scale([out])
    assert got.dtype == want.dtype == torch.float32 and got.shape == ()
    if case == "nan poisons":
        assert torch.isnan(got) and torch.isnan(want)
    else:
        assert got.view(torch.int32) == want.view(torch.int32)
        assert float(got) > 0


def test_ppermute_copies_between_ranks_on_one_device():
    xs = [torch.full((3,), float(r)) for r in range(3)]
    tq.ppermute.sent_bytes.clear()
    out = tq.ppermute(xs, [(0, 1), (1, 2), (2, 0)])
    assert [float(o[0]) for o in out] == [2.0, 0.0, 1.0]
    out[1].add_(5)                      # no rank aliases another's tensor
    assert float(xs[0][0]) == 0.0
    assert dict(tq.ppermute.sent_bytes) == {("data", r): 12
                                            for r in range(3)}


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
    """zero_update with the ring runs in the JAX package and is refused
    here by name; a model axis is refused by the JAX ring and by the
    port's mesh, each naming it."""
    jc, tc = make_cfgs(shard, "q8wire", "zero_update: true")
    assert j_trainer(jc).update_mode == "zero"
    with pytest.raises(ConfigError, match="zero_update"):
        t_trainer(tc)
    jc, tc = make_cfgs(shard, "q8wire")
    with pytest.raises(JConfigError, match="'model': 2"):
        JTrainer(jc, None, mesh=j_mesh(2, 2, jax.devices()[:4]), seed=0,
                 log=lambda s: None, prefetch=False)
    with pytest.raises(ConfigError, match="model axis width 2"):
        build_mesh(2, 2, ["cpu"] * 4)
    cl = t_cluster(f'workspace: "{tmp_path}" nworkers: 4 nprocs_per_group: 2')
    with pytest.raises(ConfigError, match="nprocs_per_group"):
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
