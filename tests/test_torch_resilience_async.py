"""The port's zero-stall checkpoints (singa_tpu_torch/resilience/
async_ckpt.py and Trainer._snapshot) on the CPU.

- ``crash@7`` on an async job resumes to the uninterrupted run's params
  and slots bitwise, as on a sync job.
- ``async_torn_write`` never becomes LATEST, and a crash after it
  resumes from the save before.
- The async saves hold the same arrays as the sync saves, in the npz and
  the sharded format (a save crosses to the JAX package's restore).
- A snapshot is the state at its step boundary: the steps that run while
  its write waits do not reach it; at most two snapshots are alive.
- A write failure is raised at the next flush.
"""

import os
import threading

import numpy as np
import pytest
import torch

from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.config.schema import ClusterConfig
from singa_tpu_torch.data import loader as t_loader
from singa_tpu_torch.resilience import (
    EXIT_OK,
    AsyncWriteError,
    FaultPlan,
    ResilienceContext,
    retention,
    supervisor,
)
from singa_tpu_torch.trainer import Trainer, load_checkpoint
from singa_tpu_torch.trainer import trainer as ttr
from test_resilience import MLP_CONF
from test_torch_launch import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("async")
    out = {"train": str(root / "train"), "test": str(root / "test")}
    t_loader.write_records(out["train"], *t_loader.synthetic_arrays(
        256, seed=1))
    t_loader.write_records(out["test"], *t_loader.synthetic_arrays(
        64, seed=1, noise_seed=2))
    return out


def job(shards, root, *, mode="async", fmt="npz", steps=12, ckpt=5):
    res = "async_checkpoint: true" if mode == "async" else ""
    cfg = t_parse(MLP_CONF.format(
        train_shard=shards["train"], test_shard=shards["test"],
        train_steps=steps, checkpoint_frequency=ckpt, resilience=res))
    cfg.checkpoint_format = fmt
    cl = ClusterConfig()
    cl.workspace = str(root / "ws")
    return cfg, cl, str(root / "ws" / "checkpoints")


def arrays(path) -> dict:
    if os.path.isdir(path):
        from singa_tpu_torch.trainer.sharded_ckpt import ShardedCheckpoint

        with ShardedCheckpoint(path) as ck:
            return {k: np.asarray(ck.assemble(k)) for k in ck.keys()}
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        np.array_equal(a[k], b[k]) for k in a)


def run(cfg, cl, faults=""):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return supervisor.run(cfg, cl, seed=0, faults=faults,
                              log=lambda s: None, device="cpu",
                              prefetch=False)
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sync_saves(shards, tmp_path_factory):
    """The sync job's saves, by format: {name: arrays}."""
    out = {}
    for fmt in ("npz", "sharded"):
        root = tmp_path_factory.mktemp(f"sync_{fmt}")
        cfg, cl, ck = job(shards, root, mode="sync", fmt=fmt)
        assert run(cfg, cl) == EXIT_OK
        out[fmt] = {name: arrays(os.path.join(ck, name))
                    for name in os.listdir(ck) if name.startswith("step_")}
    return out


@pytest.mark.parametrize("fmt", ["npz", "sharded"])
def test_async_saves_equal_sync_saves(fmt, shards, sync_saves, tmp_path):
    """keep_last 3 keeps step_5, 10 and 12 in both: the same arrays."""
    cfg, cl, ck = job(shards, tmp_path, fmt=fmt)
    assert run(cfg, cl) == EXIT_OK
    got = {name: arrays(os.path.join(ck, name))
           for name in os.listdir(ck) if name.startswith("step_")}
    assert sorted(got) == sorted(sync_saves[fmt]) and len(got) == 3
    for name, want in sync_saves[fmt].items():
        assert same(got[name], want), name


@pytest.mark.parametrize("faults", ["crash@7", "async_torn_write@2,crash@11"])
def test_async_drills_resume_bitwise(faults, shards, sync_saves, tmp_path):
    """crash@7 resumes from the async step_5; with the 2nd write (step_10)
    torn, LATEST stays on step_5 and crash@11 resumes from it: either way
    the final save equals the uninterrupted run's."""
    cfg, cl, ck = job(shards, tmp_path)
    assert run(cfg, cl, faults) == EXIT_OK
    assert same(arrays(os.path.join(ck, "step_12.npz")),
                sync_saves["npz"]["step_12.npz"])
    assert retention.resolve_latest(ck).endswith("step_12.npz")


def test_torn_async_write_never_becomes_latest(shards, tmp_path):
    cfg, cl, ck = job(shards, tmp_path, steps=10)
    log = []
    ctx = ResilienceContext(cfg.resilience, FaultPlan.parse(
        "async_torn_write@2"), log=log.append)
    tr = Trainer(cfg, cl, seed=0, log=log.append, device="cpu",
                 prefetch=False)
    ctx.bind(tr)
    try:
        for step in range(10):
            tr.train_one_batch(step)
            if step == 4:
                tr.save(5)
                ctx.flush_async()
            if step == 7:
                tr.save(8)
                ctx.flush_async()
                with open(os.path.join(ck, "LATEST")) as f:
                    assert f.read().strip() == "step_5.npz"
                assert not retention.validate_checkpoint(
                    os.path.join(ck, "step_8.npz"))
    finally:
        ctx.stop()
    assert any("async_torn_write@2" in s for s in log)
    assert ctx.async_ckpt.max_in_flight <= 2


def test_snapshot_is_the_step_boundary_state(shards, tmp_path,
                                             monkeypatch):
    """The writer is held until 3 more steps ran: the save still holds
    the params and slots of its own step, and a third save waits for a
    free snapshot buffer (at most two alive)."""
    cfg, cl, ck = job(shards, tmp_path, steps=12)
    ctx = ResilienceContext(cfg.resilience, FaultPlan(), log=lambda s: None)
    tr = Trainer(cfg, cl, seed=0, log=lambda s: None, device="cpu",
                 prefetch=False)
    ctx.bind(tr)
    gate = threading.Event()
    real = ttr.save_checkpoint

    def held(*a, **kw):
        gate.wait(timeout=30)
        return real(*a, **kw)

    monkeypatch.setattr(ttr, "save_checkpoint", held)
    try:
        for step in range(3):
            tr.train_one_batch(step)
        want = {n: v.clone() for n, v in tr.params.items()}
        tr.save(3)
        for step in range(3, 6):
            tr.train_one_batch(step)
        tr.save(6)
        assert ctx.async_ckpt.in_flight() == 2
        third = threading.Thread(target=tr.save, args=(7,))
        third.start()
        third.join(timeout=1.0)
        assert third.is_alive()  # both buffers are taken
        gate.set()
        third.join(timeout=30)
        ctx.flush_async()
    finally:
        gate.set()
        ctx.stop()
    _, params, _, _ = load_checkpoint(os.path.join(ck, "step_3.npz"))
    for n, v in want.items():
        np.testing.assert_array_equal(params[n], v.numpy())
    assert not any(np.array_equal(params[n], v.numpy())
                   for n, v in tr.params.items() if n.endswith("weight"))
    assert ctx.async_ckpt.max_in_flight <= 2


def test_write_failure_surfaces_at_flush(shards, tmp_path, monkeypatch):
    cfg, cl, _ = job(shards, tmp_path)
    ctx = ResilienceContext(cfg.resilience, FaultPlan(), log=lambda s: None)
    tr = Trainer(cfg, cl, seed=0, log=lambda s: None, device="cpu",
                 prefetch=False)
    ctx.bind(tr)

    def broken(*a, **kw):
        raise OSError("disk full")

    real = ttr.save_checkpoint
    monkeypatch.setattr(ttr, "save_checkpoint", broken)
    try:
        tr.train_one_batch(0)
        tr.save(1)
        with pytest.raises(AsyncWriteError, match="disk full"):
            ctx.flush_async()
        # the failed write released its snapshot buffer: two more saves
        # take both buffers without blocking
        monkeypatch.setattr(ttr, "save_checkpoint", real)
        tr.save(1)
        tr.save(2)
        ctx.flush_async()
    finally:
        ctx.stop()
