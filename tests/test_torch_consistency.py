"""The port's consistency protocols (singa_tpu_torch/parallel/
consistency.py) against the JAX package's (singa_tpu/parallel/
consistency.py) and against tests/test_consistency.py's straight-line
numpy transcriptions of the reference's message handlers
(src/utils/param.cc:100-256).

EASGD and each form of RandomSync (every coordinate; partial coverage
through the dense prefix sum and through the server's serial loop) are
held to both within 1e-6 on the same inputs; the dense prefix and the
serial loop add the same deltas in another association, so they are
held to each other within float32 rounding. ``sample_sync_indices`` is
the JAX package's numpy draw and must give its indices to the bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.parallel import consistency as jc
from singa_tpu_torch.parallel import consistency as tc
from test_consistency import _rand_trees, np_elastic, np_random_sync
from test_torch_launch import one_torch_thread  # noqa: F401

TOL = 1e-6


def _t(tree):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _close(got, want, tol=TOL):
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=0, atol=tol, err_msg=k)


def test_elastic_matches_jax_and_numpy():
    reps, center, _ = _rand_trees(R=4)
    want_r, want_c = np_elastic(reps, center, alpha=0.3)
    j_r, j_c = jc.elastic_sync(_j(reps), _j(center), 0.3)
    t_reps, t_center = _t(reps), _t(center)
    got_r, got_c = tc.elastic_sync(t_reps, t_center, 0.3)
    for got, oracle, jax_out in ((got_r, want_r, j_r), (got_c, want_c, j_c)):
        _close({k: v.numpy() for k, v in got.items()}, oracle)
        _close({k: v.numpy() for k, v in got.items()}, jax_out)
    # functional: the inputs are left as they were
    _close({k: v.numpy() for k, v in t_reps.items()}, reps, 0)
    _close({k: v.numpy() for k, v in t_center.items()}, center, 0)


def test_elastic_order_is_serial():
    """Replica 1 sees the center replica 0 already moved (the server's
    per-param lock, server.cc:110-143), not an all-reduce."""
    got_r, got_c = tc.elastic_sync(
        {"w": torch.tensor([[1.0], [1.0]])}, {"w": torch.tensor([0.0])}, 0.5)
    assert got_c["w"].tolist() == [0.75]
    assert got_r["w"].tolist() == [[0.5], [0.75]]


def _sync_inputs(ratio, seed=1):
    reps, center, shapes = _rand_trees(R=3, seed=seed)
    snaps = {k: v + np.random.RandomState(9).randn(*v.shape).astype(
        np.float32) for k, v in reps.items()}
    idx = jc.sample_sync_indices(np.random.RandomState(5), shapes,
                                 nreplicas=3, ratio=ratio)
    return reps, snaps, center, idx


@pytest.mark.parametrize("form", ["full", "dense", "scan"])
def test_random_sync_forms_match_jax_and_numpy(form, monkeypatch):
    """Every coordinate (ratio 1, no indices), the dense prefix and the
    serial loop (the budget forced to 0 in both packages)."""
    ratio = 1.0 if form == "full" else 0.4
    reps, snaps, center, idx = _sync_inputs(ratio)
    if form == "scan":
        monkeypatch.setattr(jc, "DENSE_PREFIX_MAX_ELEMS", 0)
        monkeypatch.setattr(tc, "DENSE_PREFIX_MAX_ELEMS", 0)
    want = np_random_sync(reps, snaps, center, idx)
    full = form == "full"
    j_out = jc.random_sync(_j(reps), _j(snaps), _j(center),
                           None if full else _j(idx), full_coverage=full)
    got = tc.random_sync(_t(reps), _t(snaps), _t(center),
                         None if full else _t(idx), full_coverage=full)
    for got_t, want_t, j_t in zip(got, want, j_out):
        got_np = {k: v.numpy() for k, v in got_t.items()}
        _close(got_np, want_t)
        _close(got_np, j_t)


def test_dense_prefix_equals_serial_scan(monkeypatch):
    """The two partial forms on the same indices, a replica count and
    ratio where coordinates overlap across replicas."""
    reps, center, shapes = _rand_trees(R=6, seed=4)
    snaps = {k: v * 0.5 for k, v in reps.items()}
    idx = _t(tc.sample_sync_indices(np.random.RandomState(2), shapes, 6,
                                    0.6))
    dense = tc.random_sync(_t(reps), _t(snaps), _t(center), idx)
    monkeypatch.setattr(tc, "DENSE_PREFIX_MAX_ELEMS", 0)
    scan = tc.random_sync(_t(reps), _t(snaps), _t(center), idx)
    for a, b in zip(dense, scan):
        _close({k: v.numpy() for k, v in a.items()},
               {k: v.numpy() for k, v in b.items()})


def test_full_ratio_single_replica_adopts_center_plus_delta():
    got_r, got_s, got_c = tc.random_sync(
        {"w": torch.tensor([[2.0, 4.0]])}, {"w": torch.tensor([[1.0, 1.0]])},
        {"w": torch.tensor([10.0, 20.0])}, None, full_coverage=True)
    assert got_r["w"].tolist() == [[11.0, 23.0]]
    assert got_s["w"].tolist() == [[11.0, 23.0]]
    assert got_c["w"].tolist() == [11.0, 23.0]


@pytest.mark.parametrize("seed,ratio,nreplicas", [
    (0, 0.25, 4), (7, 0.01, 3), (123, 0.5, 8), (5, 0.999, 2), (1, 1.0, 4),
    (2, 1.5, 2)])
def test_sample_sync_indices_equal_jax_bitwise(seed, ratio, nreplicas):
    shapes = {"fc1/weight": (64, 784), "fc1/bias": (64,), "w": (10, 10),
              "b": (7,)}
    got = tc.sample_sync_indices(np.random.RandomState(seed), shapes,
                                 nreplicas, ratio)
    want = jc.sample_sync_indices(np.random.RandomState(seed), shapes,
                                  nreplicas, ratio)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        m = got[k].shape[1]
        n = int(np.prod(shapes[k]))
        assert m == (n if ratio >= 1.0 else max(1, int(n * ratio)))
        for row in got[k]:
            assert len(set(row.tolist())) == m and row.max() < n


def test_sync_now_matches_jax():
    for freq in (0, 1, 2, 4, 8):
        for warmup in (0, 4, 10, 60):
            got = [s for s in range(100) if tc.sync_now(s, freq, warmup)]
            want = [s for s in range(100) if jc.sync_now(s, freq, warmup)]
            assert got == want, (freq, warmup)
    assert [s for s in range(30) if tc.sync_now(s, 4, 10)] == [
        11, 15, 19, 23, 27]


@pytest.mark.parametrize("args", [
    (1.0, 200.0, 4, 2, 100.0),   # the formula: 100 * 2 / (200 * 4)
    (1.0, 1.0, 1, 1, 1e9),       # clamped to 1
    (0.0, 10.0, 4, 1, 1.0),      # no measured time: 1
    (-1.0, 10.0, 4, 1, 1.0),
    (0.5, 0.0, 4, 1, 1.0),       # no model: 1
    (0.01, 48.0, 4, 0, 100.0),   # nservers 0 counts as one server
    (2e-3, 46.3, 4, 1, 100.0),   # mlp.conf's model on cluster_elastic
])
def test_sync_ratio_matches_jax(args):
    got = tc.sync_ratio(*args)
    assert got == jc.sync_ratio(*args)
    assert 0.0 < got <= 1.0
    assert tc.sync_ratio(1.0, 200.0, 4, 2, 100.0) == pytest.approx(0.25)
