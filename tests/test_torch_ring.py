"""The port's quantized gradient ring (singa_tpu_torch:
ops/quantized_collective) against the JAX package, on the same numpy
inputs: the int8 helpers, the per-hop kernel's plain version, the
geometry predicates, and the ring on two ranks. The ring on four ranks
is in tests/test_torch_ring_jax.py, its ragged mixed-dim bucket in
tests/test_torch_ring_ragged.py, and the data-parallel Trainer in
tests/test_torch_ring_trainer.py (split so that the suite's workers,
which take a file each, spread the JAX compiles).

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
    step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.config.schema import RingConfig as JRing
from singa_tpu.ops import quantized_collective as jq
from singa_tpu_torch.config.schema import RingConfig as TRing
from singa_tpu_torch.ops import quantized_collective as tq


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


@pytest.mark.parametrize("n,nb,ef,dim1,hier",
                         [c for c in RING_CASES if c[0] == 2])
def test_ring_reduce_matches_jax_ring(n, nb, ef, dim1, hier):
    """Two ranks here; four in tests/test_torch_ring_jax.py."""
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
