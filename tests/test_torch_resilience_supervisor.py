"""The port's supervisor, retention and launcher budget
(singa_tpu_torch/resilience/{supervisor,retention,launcher}.py) on the
CPU, against the JAX package's where both can run the same thing.

- Retention: the same sequence of saves, torn ones among them, leaves
  the same file set and LATEST under ``keep_last`` in both packages.
- The supervisor: ``crash@5`` resumes to the uninterrupted run's params
  and slots bitwise; ``sigterm`` drains with status 75 and a relaunch
  finishes bitwise; ``corrupt_ckpt`` never becomes LATEST; the crash-loop
  breaker gives up; kRollback on a divergence that replays
  deterministically raises GuardGaveUp instead of looping; the shipped
  ``mlp_resilient.conf`` runs through ``main -device cpu``.
- The launcher: ``gang_verdict``, ``RestartBudget`` and
  ``supervise_gang`` give the JAX package's answers.
"""

import os

import numpy as np
import pytest
import torch

from singa_tpu.resilience import launcher as j_launcher
from singa_tpu.resilience import retention as j_retention
from singa_tpu.trainer import save_checkpoint as j_save
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.config.schema import ClusterConfig
from singa_tpu_torch.data import loader as t_loader
from singa_tpu_torch.main import main as t_main
from singa_tpu_torch.resilience import (
    EXIT_OK,
    EXIT_RESUMABLE,
    GuardGaveUp,
    launcher,
    retention,
    supervisor,
    tear_file,
)
from singa_tpu_torch.trainer import load_checkpoint, make_trainer
from singa_tpu_torch.trainer import save_checkpoint as t_save
from test_resilience import MLP_CONF
from test_torch_axes_seq import lm_text
from test_torch_launch import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("sup")
    out = {"train": str(root / "train"), "test": str(root / "test")}
    t_loader.write_records(out["train"], *t_loader.synthetic_arrays(
        256, seed=1))
    t_loader.write_records(out["test"], *t_loader.synthetic_arrays(
        64, seed=1, noise_seed=2))
    return out


def job(shards, root, *, steps=12, ckpt=5, resilience=""):
    """-> (model conf, cluster conf, checkpoint folder) of one workspace."""
    cfg = t_parse(MLP_CONF.format(
        train_shard=shards["train"], test_shard=shards["test"],
        train_steps=steps, checkpoint_frequency=ckpt,
        resilience=resilience))
    cl = ClusterConfig()
    cl.workspace = str(root / "ws")
    return cfg, cl, str(root / "ws" / "checkpoints")


def final_arrays(ck_dir, step) -> dict:
    _, params, state, _ = load_checkpoint(
        os.path.join(ck_dir, f"step_{step}.npz"))
    out = {("p", n): v for n, v in params.items()}
    out.update({("s", n, s): v for n, slots in state.items()
                for s, v in slots.items()})
    return out


def same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        np.array_equal(a[k], b[k]) for k in a)


def supervised(cfg, cl, faults="", **kw):
    return supervisor.run(cfg, cl, seed=0, faults=faults,
                          log=lambda s: None, device="cpu",
                          prefetch=False, **kw)


@pytest.fixture(scope="module")
def clean(shards, tmp_path_factory):
    """The uninterrupted run's final params and slots (on one intra-op
    thread, as the tests' runs: the sums' order follows the threads)."""
    root = tmp_path_factory.mktemp("clean")
    cfg, cl, ck = job(shards, root)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert supervised(cfg, cl) == EXIT_OK
    finally:
        torch.set_num_threads(n)
    return final_arrays(ck, 12)


def test_crash_resumes_bitwise(shards, clean, tmp_path):
    cfg, cl, ck = job(shards, tmp_path)
    log = []
    rc = supervisor.run(cfg, cl, seed=0, faults="crash@7", log=log.append,
                        device="cpu", prefetch=False)
    assert rc == EXIT_OK
    assert any("restart 1/3" in s for s in log)
    assert any("resumed from" in s and "step_5.npz" in s for s in log)
    assert same(final_arrays(ck, 12), clean)
    assert not cfg.checkpoint  # the configured path is restored


def test_sigterm_drains_then_relaunch_is_bitwise(shards, clean, tmp_path):
    cfg, cl, ck = job(shards, tmp_path)
    assert supervised(cfg, cl, "sigterm@8") == EXIT_RESUMABLE
    assert retention.resolve_latest(ck).endswith("step_8.npz")
    assert supervised(cfg, cl) == EXIT_OK
    assert same(final_arrays(ck, 12), clean)


def test_corrupt_ckpt_never_becomes_latest(shards, clean, tmp_path):
    """The 2nd save (step_10) is torn between write and LATEST: LATEST
    stays on step_5, and a crash after it resumes from step_5."""
    cfg, cl, ck = job(shards, tmp_path)
    log = []
    rc = supervisor.run(cfg, cl, seed=0, faults="corrupt_ckpt@2,crash@11",
                        log=log.append, device="cpu", prefetch=False)
    assert rc == EXIT_OK
    assert any("step_10.npz failed validation" in s for s in log)
    assert any("resumed from" in s and "step_5.npz" in s for s in log)
    assert same(final_arrays(ck, 12), clean)


def test_breaker_gives_up(shards, tmp_path):
    """Every attempt dies before a step: after max_restarts restarts the
    supervisor re-raises."""
    cfg, cl, _ = job(shards, tmp_path, resilience="restart_window_steps: 5")
    built = []

    def factory(*a, **kw):
        built.append(1)
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        supervisor.run(cfg, cl, log=lambda s: None, trainer_factory=factory)
    assert len(built) == 4  # the first attempt and 3 restarts


def test_rollback_livelock_raises_guard_gave_up(tmp_path):
    """A divergence baked into the data (a poison token whose table row
    is NaN, read at step 2) replays after every rollback: the guard gives
    up loudly instead of looping, and the supervisor does not restart."""
    toks, labels = t_loader.synthetic_token_arrays(32, seq_len=16, vocab=64)
    toks = np.minimum(toks, 62)
    toks[2 * 8, 3] = 63
    shard = str(tmp_path / "tok")
    t_loader.write_records(shard, toks, labels)
    text = lm_text(shard).replace("train_steps: 4", "train_steps: 6") + (
        "checkpoint_frequency: 2\nresilience { guard_policy: kRollback "
        "guard_rollback_after: 1 max_restarts: 2 backoff_base: 0 }\n")
    cl = ClusterConfig()
    cl.workspace = str(tmp_path / "ws")

    def factory(*a, **kw):
        tr = make_trainer(*a, **kw)
        with torch.no_grad():
            tr.params["embed/tok"][63] = float("nan")
        return tr

    log = []
    with pytest.raises(GuardGaveUp):
        supervisor.run(t_parse(text), cl, log=log.append, device="cpu",
                       trainer_factory=factory)
    assert sum("rolling back to" in s for s in log) == 2
    assert not any("supervisor: restart" in s for s in log)


def test_main_runs_the_shipped_resilient_conf(shards, tmp_path):
    """examples/mnist/mlp_resilient.conf as written (batch 256, 60 steps,
    a save every 5, kRollback) through ``main -device cpu -faults
    crash@7``: exit 0, LATEST the step_60 save, keep_last 2."""
    with open(os.path.join(REPO, "examples/mnist/mlp_resilient.conf")) as f:
        text = f.read()
    text = text.replace('path: "train_shard"', f'path: "{shards["train"]}"')
    text = text.replace('path: "test_shard"', f'path: "{shards["test"]}"')
    conf = tmp_path / "res.conf"
    conf.write_text(text)
    cluster = tmp_path / "cluster.conf"
    cluster.write_text(f'nworkers: 1\nworkspace: "{tmp_path / "ws"}"\n')
    assert t_main(["-model_conf", str(conf), "-cluster_conf", str(cluster),
                   "-device", "cpu", "-faults", "crash@7"]) == 0
    ck = tmp_path / "ws" / "checkpoints"
    assert (ck / "LATEST").read_text().strip() == "step_60.npz"
    assert sorted(os.listdir(ck)) == ["LATEST", "step_55.npz",
                                      "step_60.npz"]
    assert os.listdir(tmp_path / "ws" / "events") == ["rank_0.jsonl"]


@pytest.mark.parametrize("keep", [1, 2, 3])
def test_retention_matches_jax(keep, tmp_path):
    """Each package writes the same saves (steps 2..12, the 8th torn and
    the newest torn in flight), marks LATEST after validating and applies
    keep-last-N after each: the same files and LATEST in both."""
    folders = {}
    for pkg, save, ret in (("jax", j_save, j_retention),
                           ("port", t_save, retention)):
        folder = tmp_path / pkg
        folder.mkdir()
        for step in range(2, 14, 2):
            path = str(folder / f"step_{step}.npz")
            params = {"w": np.full((3,), float(step), np.float32)}
            if pkg == "port":
                params = {"w": torch.from_numpy(params["w"])}
            save(path, step, params)
            if step in (8, 12):
                tear_file(path)
            if ret.validate_checkpoint(path):
                ret.mark_latest(str(folder), path)
            ret.apply_retention(str(folder), keep)
        folders[pkg] = (sorted(os.listdir(folder)),
                        (folder / "LATEST").read_text())
    assert folders["port"] == folders["jax"]
    assert folders["port"][1].strip() == "step_10.npz"


def test_gc_stale_shards_matches_jax(tmp_path):
    for pkg, ret in (("jax", j_retention), ("port", retention)):
        d = tmp_path / pkg / "step_4.ckpt"
        d.mkdir(parents=True)
        (d / "manifest.json").write_text('{"nprocs": 2}')
        for k in range(4):
            (d / f"proc_{k}.npz").write_bytes(b"x")
            (d / f"commit_{k}.json").write_text("{}")
        gone = ret.gc_stale_shards(str(d))
        assert sorted(os.path.basename(p) for p in gone) == [
            "commit_2.json", "commit_3.json", "proc_2.npz", "proc_3.npz"]


GANGS = [[0, 0], [75, 0], [75, -9], [-9, -9], [1, 75], [75, 75], [2, 0]]


def test_launcher_matches_jax():
    for codes in GANGS:
        assert launcher.gang_verdict(codes) == j_launcher.gang_verdict(codes)
    got = {}
    for cap in (0, 2):
        for mod in (launcher, j_launcher):
            runs = iter([[75, 75], [75, 0], [75, 75], [0, 0]])
            budget = mod.RestartBudget(cap, 10.0, clock=lambda: 0.0)
            got.setdefault(cap, []).append(mod.supervise_gang(
                lambda: next(runs), budget, log=lambda s: None))
    # unbudgeted: relaunched to the end; 2 a window: gives up resumable
    assert got == {0: [EXIT_OK, EXIT_OK],
                   2: [EXIT_RESUMABLE, EXIT_RESUMABLE]}
