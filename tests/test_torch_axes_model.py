"""The port's model axis (kLayerPartition's Slice/Concate over the model
ranks, padded storage of uneven splits) and q8_hier's named axes,
against the JAX package; and the layout of every axis across
processes.

kLayerPartition on data 2 x model 2 is held to the JAX Trainer on the
same mesh (the suite's virtual CPU devices) within 1e-4 over 4 steps,
with an FFN width of 33 that the model axis does not divide: both
packages pad its stored arrays to 34 and warn, and npz saves (logical
arrays) load in both directions to the bit. A Concate in reversed rank
order must move the losses past the bar.

The named q8_hier (``ring { intra_axis: "model" inter_axis: "data" }``)
on data 2 x model 2 is the factored 2 x 2 ring to the bit (as in the
JAX package's own test), within 1e-4 of the JAX Trainer's named run,
and within the ring's bar (2e-2, the JAX package's ring-vs-reference
bar) of the exact sum on the same mesh; its refusals carry the JAX
Trainer's messages.
"""

import jax
import numpy as np
import pytest
import torch

from singa_tpu.config import parse_cluster_config as j_cluster
from singa_tpu.config import parse_model_config as j_parse
from singa_tpu.parallel import build_mesh as j_mesh
from singa_tpu.trainer import Trainer as JTrainer
from singa_tpu_torch.config import ConfigError
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.layers import sequence as t_seq
from singa_tpu_torch.parallel import build_mesh, mesh as t_mesh
from singa_tpu_torch.parallel import mesh_from_cluster
from singa_tpu_torch.trainer import Trainer, params_from_numpy
from test_torch_axes_seq import (
    LOSS_TOL,
    close,
    cluster,
    lm_text,
    losses_of,
    one_torch_thread,  # noqa: F401 (autouse)
    shard,  # noqa: F401 (fixture)
)
from test_torch_ring_trainer import make_cfgs

#: the JAX package's ring-vs-reference q8 bar (chip_smoke's RING_TOL)
RING_TOL = 2e-2


def tp_text(shard):
    return lm_text(shard, part=True, up=33)


def j_tp(text, tmp_path=None):
    cl = (j_cluster(f'workspace: "{tmp_path}"') if tmp_path is not None
          else None)
    with pytest.warns(UserWarning, match="storage pads to 34"):
        return JTrainer(j_parse(text), cl, mesh=j_mesh(2, 2,
                                                       jax.devices()[:4]),
                        seed=0, log=lambda s: None, prefetch=False)


def t_tp(text, tmp_path=None):
    with pytest.warns(UserWarning, match="storage pads to 34"):
        return Trainer(t_parse(text), cluster(
            "nworkers: 4\nnprocs_per_group: 2", tmp_path), seed=0,
            log=lambda s: None, device="cpu", prefetch=False,
            device_cache=False)


def logical(jt) -> dict:
    return {n: np.asarray(v) for n, v in jt._unpad_stored(jt.params).items()}


@pytest.fixture(scope="module")
def tp_ref(shard):
    jt = j_tp(tp_text(shard))
    params = logical(jt)
    return losses_of(jt, 4), params, {n: tuple(v.shape)
                                      for n, v in jt.params.items()}


def test_layer_partition_matches_jax_at_model_2(shard, tp_ref):
    jl, params, stored = tp_ref
    tr = t_tp(tp_text(shard))
    tr.params = params_from_numpy(tr.train_net, params)
    assert tr.mesh.shape == {"data": 2, "model": 2}
    assert {n: tuple(v.shape) for n, v in tr.params.items()} == stored
    assert stored["up/weight"] == (32, 34) and stored["down/weight"] == (
        33, 32)
    assert tr._layout["up/weight"] == (1, "model")
    assert tr._layout["attn/out"] == (0, "model")
    assert tr._layout["up/bias"] is None
    close(losses_of(tr, 4), jl, LOSS_TOL)
    assert not tr.params["up/weight"][:, 33:].any()


def test_reversed_concate_exceeds_the_bar(shard, tp_ref, monkeypatch):
    jl, params, _ = tp_ref
    monkeypatch.setattr(t_seq, "concate",
                        lambda parts, dim: torch.cat(parts[::-1], dim))
    tr = t_tp(tp_text(shard))
    tr.params = params_from_numpy(tr.train_net, params)
    diff = float(np.max(np.abs(np.asarray(losses_of(tr, 2))
                               - np.asarray(jl[:2]))))
    assert diff > 100 * LOSS_TOL, diff


def test_layer_partition_npz_saves_load_both_ways(shard, tp_ref,
                                                  tmp_path):
    """The port's save restores into the JAX Trainer at model 2, and the
    JAX Trainer's into the port, to the bit (params and slots)."""
    _, params, _ = tp_ref
    tr = t_tp(tp_text(shard), tmp_path / "t")
    tr.params = params_from_numpy(tr.train_net, params)
    losses_of(tr, 2)
    path = tr.save(2)
    cfg = j_parse(tp_text(shard))
    cfg.checkpoint = path
    jt = j_tp_cfg(cfg)
    for n, v in logical(jt).items():
        np.testing.assert_array_equal(v, tr._unpad_one(n, tr.params[n]))
    jt2 = j_tp(tp_text(shard), tmp_path / "j")
    losses_of(jt2, 2)
    jpath = jt2.save(2)
    tcfg = t_parse(tp_text(shard))
    tcfg.checkpoint = jpath
    with pytest.warns(UserWarning):
        back = Trainer(tcfg, cluster("nworkers: 4\nnprocs_per_group: 2"),
                       seed=0, log=lambda s: None, device="cpu")
    for n, v in logical(jt2).items():
        np.testing.assert_array_equal(back._unpad_one(n, back.params[n]), v)
    jstate = jt2._unpad_state(jt2.state)
    for n, slots in jstate.items():
        for s, v in slots.items():
            np.testing.assert_array_equal(
                back._unpad_one(n, back.state[n][s]), np.asarray(v))


def j_tp_cfg(cfg):
    with pytest.warns(UserWarning):
        return JTrainer(cfg, None, mesh=j_mesh(2, 2, jax.devices()[:4]),
                        seed=0, log=lambda s: None, prefetch=False)


# ---------------------------------------------------------------------------
# q8_hier's named axes
# ---------------------------------------------------------------------------


def named(cfgs, intra="model", inter="data"):
    for cfg in cfgs:
        cfg.ring.intra_degree = 0
        cfg.ring.intra_axis, cfg.ring.inter_axis = intra, inter
    return cfgs


def t_2x2(cfg):
    return Trainer(cfg, mesh=build_mesh(2, 2, ["cpu"] * 4), seed=0,
                   log=lambda s: None)


@pytest.fixture(scope="module")
def named_runs(shard_ring):
    jc, tc = named(make_cfgs(shard_ring, "q8hier"))
    jt = JTrainer(jc, None, mesh=j_mesh(2, 2, jax.devices()[:4]), seed=0,
                  log=lambda s: None, prefetch=False)
    params = {n: np.asarray(v) for n, v in jt.params.items()}
    out = {"jax": losses_of(jt, 4)}
    for name, tag, fix in (("named", "q8hier", named),
                           ("factored", "q8hier", None),
                           ("exact", "exact", None)):
        _, cfg = make_cfgs(shard_ring, tag)
        if fix is not None:
            fix([cfg])
        tr = (t_2x2(cfg) if name != "factored" else
              Trainer(cfg, mesh=build_mesh(4, 1, ["cpu"] * 4), seed=0,
                      log=lambda s: None))
        tr.params = params_from_numpy(tr.train_net, params)
        out[name] = (losses_of(tr, 4), tr)
    return out


@pytest.fixture(scope="module")
def shard_ring(tmp_path_factory):
    from singa_tpu_torch.data import loader as t_loader

    path = str(tmp_path_factory.mktemp("named") / "shard")
    t_loader.write_records(
        path, *t_loader.synthetic_token_arrays(32, seq_len=32, vocab=256))
    return path


def test_named_hier_is_the_factored_ring_to_the_bit(named_runs):
    (ln, tn), (lf, tf) = named_runs["named"], named_runs["factored"]
    assert tn.mesh_shape == {"data": 2, "model": 2}
    assert tn._ring_hier == (2, 2) and tn.grad_wire_impl == "q8_hier"
    assert ln == lf
    for n in tf.params:
        assert torch.equal(tn.params[n], tf.params[n]), n


def test_named_hier_matches_jax_and_tracks_the_exact_sum(named_runs):
    ln = named_runs["named"][0]
    close(ln, named_runs["jax"], LOSS_TOL)
    close(ln, named_runs["exact"][0], RING_TOL)


@pytest.mark.parametrize("intra,inter,zero", [
    ("modle", "data", False), ("model", "", False),
    ("model", "data", True)], ids=["unknown_axis", "one_axis", "zero"])
def test_named_hier_refusals_match_jax(shard_ring, intra, inter, zero):
    extra = "zero_update: true" if zero else ""
    jc, tc = named(make_cfgs(shard_ring, "q8hier", extra), intra, inter)
    with pytest.raises(Exception) as jerr:
        JTrainer(jc, None, mesh=j_mesh(2, 2, jax.devices()[:4]), seed=0,
                 log=lambda s: None, prefetch=False)
    with pytest.raises(ConfigError) as terr:
        t_2x2(tc)
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# every axis spans processes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("axis,text,nprocs", [
    ("seq", "nworkers: 4\nnprocs_per_group: 2\nnseq_per_group: 2", 2),
    ("expert", "nworkers: 4\nnprocs_per_group: 2\nnexperts_per_group: 2",
     2),
    # 4 processes of one rank each: every model group of 2 spans two,
    # which the mesh lays out (the layers' exchanges cross processes)
    ("model", "nworkers: 4\nnprocs_per_group: 2", 4),
    ("pipe", "nworkers: 4\nnprocs_per_group: 2\nnpipes_per_group: 2", 2),
])
def test_an_axis_across_processes_is_refused_by_name(monkeypatch, axis,
                                                     text, nprocs):
    """(Named for the refusal it held until the seq, expert and pipe axes
    crossed processes.) Every inner axis lays over processes: on 2
    processes of 2 ranks each holds one whole group of the axis, on 4 of
    one rank each group spans two (the layers' exchanges cross them,
    tests/test_torch_axes_span_*.py)."""
    cl = cluster(text)
    assert mesh_from_cluster(cl, ["cpu"] * 4).widths[axis] == 2
    monkeypatch.setattr(t_mesh, "_processes", lambda: (nprocs, 3))
    if axis == "model":
        m = mesh_from_cluster(cl, ["cpu"])
        assert (m.nprocs, m.proc, list(m.local_ranks)) == (4, 3, [3])
        assert m.coords(3) == {"data": 1, "pipe": 0, "expert": 0, "seq": 0,
                               "model": 1}
        assert m.procs_of([2, 3]) == (2, 3)
        assert m.spanning_groups() == [(0, 1), (2, 3)]
        return
    monkeypatch.setattr(t_mesh, "_processes", lambda: (nprocs, 1))
    m = mesh_from_cluster(cl, ["cpu"] * (4 // nprocs))
    assert (m.nprocs, m.proc, list(m.local_ranks)) == (2, 1, [2, 3])
    assert m.coords(3)[axis] == 1
    assert m.group_of(3, (axis,)) == (2, 3)
    assert m.spanning_groups((axis,)) == []
    monkeypatch.setattr(t_mesh, "_processes", lambda: (4, 3))
    m = mesh_from_cluster(cl, ["cpu"])
    assert list(m.local_ranks) == [3]
    assert m.spanning_groups((axis,)) == [(0, 1), (2, 3)]
