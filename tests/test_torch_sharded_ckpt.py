"""The port's sharded checkpoint format (singa_tpu_torch/trainer/
sharded_ckpt.py), its resharding restore (resilience/reshard.py) and
its validation (resilience/retention.py, coord.py), against the JAX
package's on the same files.

Trainers run test_torch_zero's narrowed tinylm_d128 conf with zero_update
and the int8 ring (q8wire), so a save holds all three layouts: params
replicated, updater slots as rank shards along their zero dim, residuals
as rank chunks along the ring's chunk dim. Every restore is held to the
saved arrays bit for bit (re-slicing moves bytes, never math), and a
resume on the same ranks to the uninterrupted run bit for bit.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from singa_tpu.config import parse_model_config as j_parse
from singa_tpu.parallel import apply_grad_comm_tag as j_tag
from singa_tpu.parallel import build_mesh as j_mesh
from singa_tpu.trainer import Trainer as JTrainer
from singa_tpu.trainer import sharded_ckpt as j_sc
from singa_tpu_torch.config import parse_cluster_config as t_cluster
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.models.transformer import TransformerConfig as TCfg
from singa_tpu_torch.models.transformer import init_lm
from singa_tpu_torch.parallel import apply_grad_comm_tag, build_mesh
from singa_tpu_torch.resilience import retention
from singa_tpu_torch.resilience.reshard import Resharder, load_serving_params
from singa_tpu_torch.serve import Engine, EngineConfig, Request, Scheduler
from singa_tpu_torch.trainer import Trainer, save_checkpoint
from singa_tpu_torch.trainer import sharded_ckpt as t_sc
from test_torch_zero import (  # noqa: F401
    lm_conf, losses, one_torch_thread, same, shards)


def conf(shards, extra=""):
    return lm_conf(shards, True) + "\ncheckpoint_format: \"sharded\"\n" + extra


def t_trainer(txt, n, *, ckpt=None, workspace=None, tag="q8wire"):
    cfg = t_parse(txt)
    apply_grad_comm_tag(cfg, tag)
    cfg.grad_comm.buckets = 4
    if ckpt:
        cfg.checkpoint = ckpt
    cl = t_cluster(f'workspace: "{workspace}"') if workspace else None
    return Trainer(cfg, cl, mesh=build_mesh(n, 1, ["cpu"] * n), seed=3,
                   log=lambda s: None)


def arrays(tr) -> dict:
    """Every saved array of a trainer as whole numpy arrays, by key."""
    out = {f"p|{n}": v.numpy() for n, v in tr.params.items()}
    out.update({f"s|{n}|{s}": v.numpy() for n, slots in tr.state.items()
                for s, v in slots.items()})
    out.update({f"b|{n}": v.numpy() for n, v in tr.buffers.items()})
    return out


def saved(path, reader=t_sc.ShardedCheckpoint) -> dict:
    with reader(path) as ck:
        return {k: ck.assemble(k) for k in ck.keys()}


def assert_same_arrays(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def save4(shards, tmp_path_factory):
    """(path, arrays) of a 4-rank zero + ring trainer's save after 2
    steps."""
    tr = t_trainer(conf(shards), 4,
                   workspace=tmp_path_factory.mktemp("ws4"))
    losses(tr, 2)
    return tr.save(2), arrays(tr)


def test_roundtrip_writes_the_jax_format(save4):
    """manifest.json (format, step, streams, nprocs, commit, shape/dtype/
    spec per array), one proc_0.npz entry per rank shard and one for a
    replicated array, a commit marker the JAX package's check accepts;
    both readers assemble the saved arrays."""
    from singa_tpu.resilience import coord as j_coord

    path, want = save4
    assert path.endswith("step_2.ckpt") and t_sc.is_sharded_checkpoint(path)
    assert sorted(os.listdir(path)) == ["commit_0.json", "manifest.json",
                                        "proc_0.npz"]
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    assert (m["format"], m["step"], m["nprocs"], m["commit"]) == (
        "singa-tpu-sharded-v1", 2, 1, 2)
    assert m["streams"] == {"kTrain|data": 16}
    qkv = "b0_attn/qkv"
    assert m["arrays"][f"p|{qkv}"]["spec"] == []
    assert m["arrays"][f"s|{qkv}|history"]["spec"] == ["data"]
    assert m["arrays"][f"b|__gradres__/{qkv}"]["spec"] == ["data"]
    with np.load(os.path.join(path, "proc_0.npz")) as z:
        names = set(z.files)
        assert {f"p|{qkv}##0", f"p|{qkv}##0##idx"} <= names
        assert f"p|{qkv}##1" not in names
        for r in range(4):
            box = z[f"s|{qkv}|history##{r}##idx"].tolist()
            assert box == [[r * 16, (r + 1) * 16], [0, 192]]
    assert j_coord.commit_ok(path, 0) and retention.validate_checkpoint(path)
    assert_same_arrays(saved(path), want)
    assert_same_arrays(saved(path, j_sc.ShardedCheckpoint), want)


def test_resume_equals_the_uninterrupted_run(shards, tmp_path):
    """2 ranks, a save every 3 steps: the run resumed from step_3.ckpt
    ends at step 6 with the uninterrupted run's params, slots and
    residuals, to the bit."""
    txt = conf(shards).replace("train_steps: 2000", "train_steps: 6")
    txt += "\ncheckpoint_frequency: 3\n"
    full = t_trainer(txt, 2, workspace=tmp_path / "a")
    full.run()
    ck = str(tmp_path / "a" / "checkpoints" / "step_3.ckpt")
    assert retention.validate_checkpoint(ck)
    resumed = t_trainer(txt, 2, ckpt=ck, workspace=tmp_path / "b")
    assert resumed.start_step == 3
    resumed.run()
    assert_same_arrays(arrays(resumed), arrays(full))


@pytest.mark.parametrize("n_from,n_to", [(4, 2), (2, 4)])
def test_restore_onto_another_rank_count_is_bitwise(shards, save4,
                                                    tmp_path, n_from, n_to):
    """A save of n_from ranks restored on n_to: every array equals the
    saved one, the slots land as the new rank shards, and the step and
    streams carry over; the restore logs the sharded entries as
    resharded."""
    if n_from == 4:
        path, want = save4
    else:
        tr = t_trainer(conf(shards), 2, workspace=tmp_path)
        losses(tr, 2)
        path, want = tr.save(2), arrays(tr)
    logs = []
    cfg = t_parse(conf(shards))
    apply_grad_comm_tag(cfg, "q8wire")
    cfg.grad_comm.buckets = 4
    cfg.checkpoint = path
    tt = Trainer(cfg, mesh=build_mesh(n_to, 1, ["cpu"] * n_to), seed=3,
                 log=logs.append)
    assert tt.start_step == 2
    assert_same_arrays(arrays(tt), want)
    for r in range(n_to):
        for nm, slots in tt._zero_slots[r].items():
            whole = torch.from_numpy(want[f"s|{nm}|history"])
            assert torch.equal(slots["history"], whole.chunk(n_to)[r])
    assert any("elastic restore: resharded" in line for line in logs)
    assert tt._pipelines[id(tt.train_net)]["data"].position == 16


def test_missing_or_stale_commit_marker_is_not_resumable(shards, tmp_path):
    """A save whose commit marker is gone, or whose shard changed after
    the marker, never validates: resolve_latest falls back to the save
    before it."""
    txt = conf(shards).replace("train_steps: 2000", "train_steps: 4")
    txt += "\ncheckpoint_frequency: 2\n"
    t_trainer(txt, 2, workspace=tmp_path).run()
    folder = str(tmp_path / "checkpoints")
    new, old = (os.path.join(folder, f"step_{s}.ckpt") for s in (4, 2))
    assert retention.resolve_latest(folder) == new
    os.remove(os.path.join(new, "commit_0.json"))
    assert not retention.validate_checkpoint(new)
    assert retention.resolve_latest(folder) == old
    with open(os.path.join(old, "proc_0.npz"), "ab") as f:
        f.write(b"\0")
    assert not retention.validate_checkpoint(old)
    assert retention.resolve_latest(folder) is None


def test_resave_removes_stale_shards_of_a_larger_job(save4, tmp_path):
    path, want = str(tmp_path / "step_2.ckpt"), save4[1]
    shutil.copytree(save4[0], path)
    stale = ["proc_3.npz", "proc_7.npz", "proc_7.npz.tmp", "commit_3.json"]
    for name in stale:
        with open(os.path.join(path, name), "wb") as f:
            f.write(b"stale")
    params = {k[2:]: torch.from_numpy(v) for k, v in want.items()
              if k.startswith("p|")}
    t_sc.save_sharded(path, 2, params)
    assert sorted(os.listdir(path)) == ["commit_0.json", "manifest.json",
                                        "proc_0.npz"]
    assert retention.validate_checkpoint(path)


def test_jax_saves_resume_in_the_port(shards, tmp_path):
    """The JAX zero + ring Trainer on 4 virtual devices saves sharded;
    the port resumes it on 4 and on 2 ranks with every array equal to
    the JAX save's."""
    jcfg = j_parse(conf(shards))
    j_tag(jcfg, "q8wire")
    jcfg.grad_comm.buckets = 4
    jt = JTrainer(jcfg, None, mesh=j_mesh(4, 1, jax.devices()[:4]), seed=3,
                  log=lambda s: None, prefetch=False)
    losses(jt, 2)
    path = str(tmp_path / "jax.ckpt")
    j_sc.save_sharded(path, 2, jt.params, jt.state, jt.buffers,
                      streams={"kTrain|data": 16})
    want = saved(path, j_sc.ShardedCheckpoint)
    assert retention.validate_checkpoint(path)
    for n in (4, 2):
        tt = t_trainer(conf(shards), n, ckpt=path)
        assert tt.start_step == 2
        assert_same_arrays(arrays(tt), want)


def test_port_saves_read_back_in_the_jax_package(shards, save4):
    """The JAX package's Resharder places the port's 4-rank save onto a
    2-device JAX mesh, and a JAX zero Trainer resumes from it with the
    saved arrays."""
    from singa_tpu.resilience.reshard import Resharder as JResharder

    path, want = save4
    jcfg = j_parse(conf(shards))
    j_tag(jcfg, "q8wire")
    jcfg.grad_comm.buckets = 4
    jcfg.checkpoint = path
    jt = JTrainer(jcfg, None, mesh=j_mesh(2, 1, jax.devices()[:2]), seed=3,
                  log=lambda s: None, prefetch=False)
    got = {f"p|{n}": np.asarray(v) for n, v in jt.params.items()}
    got.update({f"s|{n}|{s}": np.asarray(v)
                for n, slots in jt.state.items() for s, v in slots.items()})
    got.update({f"b|{n}": np.asarray(v) for n, v in jt.buffers.items()})
    assert_same_arrays(got, want)
    with j_sc.ShardedCheckpoint(path) as ck:
        rs = JResharder(ck, {"data": 2, "model": 1})
        key = "s|b0_attn/qkv|history"
        arr = rs.place(key, jt.state["b0_attn/qkv"]["history"].sharding)
        np.testing.assert_array_equal(np.asarray(arr), want[key])


def test_serving_restore_from_a_sharded_save(tmp_path):
    """load_serving_params on a sharded save of an LM's params (written
    as a 2-rank layout, the qkv weights chunked) gives the npz save's
    params, bit for bit, and engines booted from each stream the same
    greedy tokens; a checkpoint folder resolves to its newest complete
    save of either format."""
    cfg = TCfg(vocab=32, d_model=32, n_heads=2, n_layers=2, d_ff=64,
               max_len=32)
    trained = init_lm(torch.Generator().manual_seed(1), cfg, "cpu")
    init = init_lm(torch.Generator().manual_seed(2), cfg, "cpu")
    folder = tmp_path / "checkpoints"
    npz = save_checkpoint(str(folder / "step_5.npz"), 5, trained)
    def halves(v):
        c = v.shape[0] // 2
        return t_sc.RankBoxes(
            tuple(v.chunk(2)), tuple([[r * c, (r + 1) * c], [0, v.shape[1]]]
                                     for r in range(2)),
            (0, 1), tuple(v.shape), ["data"])

    layout = {n: halves(v) if n.endswith("/qkv") else v
              for n, v in trained.items()}
    sh = t_sc.save_sharded(str(folder / "step_6.ckpt"), 6, layout)
    a, ia = load_serving_params(npz, init)
    b, ib = load_serving_params(sh, init)
    c, ic = load_serving_params(str(folder), init)
    assert (ia["format"], ib["format"], ic["path"]) == ("npz", "sharded", sh)
    assert ib["restored"] == len(trained) and ib["resharded"] == 2
    assert same(a, b) and same(b, trained)

    def stream(params):
        eng = Engine(params, cfg, EngineConfig(slots=2, kv_block_len=4,
                                               max_prefill_chunk=8),
                     device="cpu")
        sched = Scheduler(eng)
        for rid in range(2):
            sched.submit(Request(rid=rid, prompt=np.arange(
                1 + rid, 9 + rid, dtype=np.int32), max_new_tokens=8))
        sched.serve()
        return {r.rid: list(r.tokens) for r in sched.finished}

    assert stream(a) == stream(b) != stream(init)
    with t_sc.ShardedCheckpoint(sh) as ck:
        (part,) = Resharder(ck).place_boxes(
            "p|blk0/attn/qkv", [[[0, d] for d in trained[
                "blk0/attn/qkv"].shape]], ["cpu"])
        assert torch.equal(part, trained["blk0/attn/qkv"])


def test_a_mesh_that_cannot_host_the_save_is_refused(shards, save4,
                                                     tmp_path):
    """The admission check runs before anything is placed: an entry
    sharded over an axis the port's mesh lacks (it has the five of
    ``FULL_AXES``, the model axis among them) raises ReshardError naming
    the entry; the save's process count reads back."""
    from singa_tpu_torch.resilience.reshard import (
        ReshardError,
        checkpoint_nprocs,
    )

    path = str(tmp_path / "step_2.ckpt")
    shutil.copytree(save4[0], path)
    assert checkpoint_nprocs(path) == 1 and checkpoint_nprocs(
        str(tmp_path)) is None
    mpath = os.path.join(path, "manifest.json")
    with open(mpath) as f:
        m = json.load(f)
    m["arrays"]["p|b0_attn/qkv"]["spec"] = [None, "rows"]
    with open(mpath, "w") as f:
        json.dump(m, f)
    with pytest.raises(ReshardError, match="p\\|b0_attn/qkv.*'rows'"):
        t_trainer(conf(shards), 2, ckpt=path)
