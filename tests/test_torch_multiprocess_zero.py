"""zero_update and sharded saves across OS processes in the port: two
processes through the real CLI over gloo on the CPU, on
tests/test_torch_multiprocess.py's MLP job (split from it so that
``--dist loadfile`` spreads the two over workers).

Zero at 2 processes x 1 rank, and zero + the int8 ring at 2 x 2 with
``checkpoint_format: "sharded"``: (i) the processes' params and slots
agree to the bit, (ii) with the port's one-process Trainer over the
same ranks, (iii) within the ring tests' bars of the JAX Trainer on a
mesh of that width (zero: the JAX zero Trainer; zero + ring: the JAX
ring alone, which zero + ring equals to the bit in the port,
tests/test_torch_zero_ring.py). The 2-process sharded save has
``proc_0``, ``proc_1``, both commit markers and ``"nprocs": 2``; it
restores on one process bitwise, and the JAX package's loader reads it;
a one-process save restores on two processes bitwise.
"""

import json
import os

import numpy as np
import pytest

from singa_tpu.trainer import sharded_ckpt as j_sc
from singa_tpu_torch.config import parse_cluster_config as t_cluster
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.parallel import build_mesh
from singa_tpu_torch.resilience import retention
from singa_tpu_torch.trainer import Trainer
from singa_tpu_torch.trainer import sharded_ckpt as t_sc
from test_torch_launch import one_torch_thread  # noqa: F401
from test_torch_multiprocess import (  # noqa: F401
    LOSS_TOL, RING, STEPS, check_reports, jax_run, job_text, launch,
    port_run, shard)

SHARDED = 'checkpoint_format: "sharded"\n'


def arrays(tr) -> dict:
    """A trainer's params, whole slots and buffers by checkpoint key."""
    out = {f"p|{n}": v.numpy() for n, v in tr.params.items()}
    out.update({f"s|{n}|{s}": v.numpy() for n, slots in tr.state.items()
                for s, v in slots.items()})
    out.update({f"b|{n}": v.numpy() for n, v in tr.buffers.items()})
    return out


def assert_same(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("per", [1, 2])
def test_zero_across_processes_equals_one_process_and_the_jax_trainer(
        tmp_path, shard, per):
    """per 1: zero alone; per 2: zero + ring, saved sharded, the save
    checked for its files, restored on one process (4 ranks and 2) and
    read by the JAX package's loader, each array bitwise."""
    width = 2 * per
    ring = RING if per == 2 else ""
    init = str(tmp_path / "init.npz")
    # the JAX oracle: the zero Trainer; with the ring, the ring alone
    jlosses, jparams = jax_run(
        job_text(shard, ring or "zero_update: true\n", width), width, init)
    text = job_text(shard, ring + "zero_update: true\n"
                    + (SHARDED if per == 2 else ""), width, init)
    reports, _ = launch(tmp_path, text, width)
    tr, losses, params, sent = port_run(text, width)
    assert tr.update_mode == "zero"
    check_reports(reports, width, tr.digest())
    # the steps' bytes: each process's count less its comm probe's
    probe = sum(r["comm_probe"]["ring_sent_bytes"] for r in reports)
    assert sum(r["ring_sent_bytes"] for r in reports) - probe == sent
    for j, t in zip(jlosses, losses):
        assert abs(j - t) <= LOSS_TOL, (jlosses, losses)
    atol = 5e-4 if ring else 1e-4
    for n, v in params.items():
        np.testing.assert_allclose(v, jparams[n], atol=atol, err_msg=n)
    if per == 1:
        return
    path = str(tmp_path / "ws_job" / "checkpoints" / f"step_{STEPS}.ckpt")
    names = set(os.listdir(path))
    assert {"proc_0.npz", "proc_1.npz", "commit_0.json", "commit_1.json",
            "manifest.json"} <= names, names
    with open(os.path.join(path, "manifest.json")) as f:
        assert json.load(f)["nprocs"] == 2
    assert retention.validate_checkpoint(path)
    want = arrays(tr)
    with t_sc.ShardedCheckpoint(path) as ck:
        saved = {k: ck.assemble(k) for k in ck.keys()}
    with j_sc.ShardedCheckpoint(path) as jck:
        jsaved = {k: np.asarray(jck.assemble(k)) for k in jck.keys()}
    # each slot and residual chunk lies in the proc file of its rank
    with np.load(os.path.join(path, "proc_1.npz")) as z:
        ranks = {int(e.split("##")[1]) for e in z.files}
    assert ranks == {2, 3}
    assert_same(saved, want)
    assert_same(jsaved, want)
    for n in (4, 2):
        cfg = t_parse(text)
        cfg.checkpoint = path
        logs = []
        back = Trainer(cfg, mesh=build_mesh(n, 1, ["cpu"] * n), seed=7,
                       log=logs.append)
        assert back.start_step == STEPS
        assert ("elastic restore: checkpoint written by 2 process(es), "
                "resuming on 1") in logs
        assert_same(arrays(back), want)


def test_a_one_process_sharded_save_restores_on_two_processes(
        tmp_path, shard):
    """4 ranks in one process save sharded at step 3; two processes of 2
    ranks each resume from it with nothing left to train: their params
    and slots are the saved ones to the bit, and their own final save
    is a 2-process one."""
    text = job_text(shard, RING + "zero_update: true\n" + SHARDED, 4)
    cfg = t_parse(text)
    cfg.train_steps = 3
    one = Trainer(cfg, t_cluster(f'workspace: "{tmp_path}/one"'),
                  mesh=build_mesh(4, 1, ["cpu"] * 4), seed=0,
                  log=lambda s: None)
    one.run()
    path = str(tmp_path / "one" / "checkpoints" / "step_3.ckpt")
    with open(os.path.join(path, "manifest.json")) as f:
        assert json.load(f)["nprocs"] == 1
    resumed = text.replace(f"train_steps: {STEPS}", "train_steps: 3") \
        + f'checkpoint: "{path}"\n'
    reports, logs = launch(tmp_path, resumed, 4, name="resume")
    for rep in reports:
        assert rep["digest"] == one.digest() and rep["steps"] == 0
    for log in logs:
        assert ("elastic restore: checkpoint written by 1 process(es), "
                "resuming on 2") in log, log
    again = str(tmp_path / "ws_resume" / "checkpoints" / "step_3.ckpt")
    with open(os.path.join(again, "manifest.json")) as f:
        assert json.load(f)["nprocs"] == 2
    with t_sc.ShardedCheckpoint(again) as ck:
        assert_same({k: ck.assemble(k) for k in ck.keys()}, arrays(one))
