"""The resilience drills across two processes (gloo, CPU) through
``python -m singa_tpu_torch.main -procsID k -hostfile hf``, as the JAX
package's tests/test_mp_resilience.py drills its ranks:

- ``sigterm@6:rank=1``: the coordinated drain stops both processes at
  step 6 with status 75, and a relaunch of both finishes with the
  uninterrupted job's digest, to the bit;
- ``crash@6:rank=0``: the crashed process exits 75 without a restart in
  place, its peer exits 75 too, and a relaunch resumes from the newest
  complete save to the same digests; once more with ``async_checkpoint``
  and the sharded format, whose writer threads issue no collective
  beside the step loops' own;
- kRollback across processes, with async sharded saves: both processes
  roll back to process 0's LATEST (flushed, then broadcast), and the
  rollback's step, save and LR scale, the guard counters and the digests
  equal those of one process running the same 2 ranks under the same
  fault plan (the run the guard tests hold to the JAX Trainer).
"""

import json
import os
import re
import sys

import pytest
import torch

from singa_tpu_torch.config import parse_cluster_config as t_cluster
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.data import loader as t_loader
from singa_tpu_torch.parallel import build_mesh
from singa_tpu_torch.resilience import FaultPlan, ResilienceContext
from singa_tpu_torch.trainer import Trainer
from test_resilience import MLP_CONF
from test_torch_launch import one_torch_thread, run_processes  # noqa: F401

STEPS = 10
SHARDED = 'checkpoint_format: "sharded"\n'
ROLLBACK = "guard_policy: kRollback guard_rollback_after: 1"
ROLLBACK_RE = re.compile(r"at step (\d+) .* rolling back to (.+), "
                         r"LR scale -> (\S+)$")
CONFS = {  # name: (top of the conf, resilience fields)
    "sync": ("", ""),
    "async_sharded": (SHARDED, "async_checkpoint: true"),
    "rollback": (SHARDED, f"{ROLLBACK} async_checkpoint: true"),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("mp")
    shard = {"train": str(root / "train"), "test": str(root / "test")}
    t_loader.write_records(shard["train"], *t_loader.synthetic_arrays(
        256, seed=1))
    t_loader.write_records(shard["test"], *t_loader.synthetic_arrays(
        64, seed=1, noise_seed=2))
    confs = {}
    for name, (top, extra) in CONFS.items():
        confs[name] = root / f"{name}.conf"
        confs[name].write_text(top + MLP_CONF.format(
            train_shard=shard["train"], test_shard=shard["test"],
            train_steps=STEPS, checkpoint_frequency=4,
            resilience="coordinate_preemption: true "
                       f"heartbeat_timeout_s: 10 {extra}"))
    return root, confs


def launch(root, conf, tag, faults=""):
    """Both processes of one run in the workspace ``tag`` ->
    [(exit code, output)]."""
    cluster = root / f"cluster_{tag}.conf"
    cluster.write_text(f'nworkers: 2\nworkspace: "{root / ("ws_" + tag)}"\n')
    extra = ["-faults", faults] if faults else []
    return run_processes(root, lambda k, hostfile: [
        sys.executable, "-m", "singa_tpu_torch.main", "-model_conf",
        str(conf), "-cluster_conf", str(cluster), "-procsID", str(k),
        "-hostfile", hostfile, "-device", "cpu", *extra],
        name=f"{tag}_{faults.replace('@', '_').replace(':', '_')}")


def reports(out) -> list:
    """Each process's ``TRAIN PROCESS:`` report of a run that ended 0."""
    got = []
    for k, (rc, log) in enumerate(out):
        assert rc == 0, f"process {k} exited {rc}:\n{log}"
        line = [ln for ln in log.splitlines()
                if ln.startswith("TRAIN PROCESS: ")]
        assert len(line) == 1, log
        got.append(json.loads(line[0].split(": ", 1)[1]))
    return got


def digests(out) -> list:
    return [r["digest"] for r in reports(out)]


def one_process(root, conf, tag, faults=""):
    """The same job in this process over the same 2 ranks (two processes
    give its bits: tests/test_torch_multiprocess.py), on one intra-op
    thread as the children, under a context with ``faults`` when given
    -> (trainer, context or None, log lines)."""
    lines: list = []
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    ctx = None
    try:
        tr = Trainer(t_parse(conf.read_text()),
                     t_cluster(f'nworkers: 2\nworkspace: "{root / tag}"\n'),
                     mesh=build_mesh(2, 1, ["cpu"] * 2), seed=0,
                     log=lambda s: lines.extend(str(s).splitlines()))
        if faults:
            ctx = ResilienceContext(tr.cfg.resilience,
                                    FaultPlan.parse(faults), log=tr.log)
            ctx.bind(tr)
        try:
            tr.run()
        finally:
            if ctx is not None:
                ctx.stop()
        return tr, ctx, lines
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clean(files):
    """The uninterrupted job's digest, from one process."""
    root, confs = files
    return [one_process(root, confs["sync"], "one")[0].digest()] * 2


@pytest.mark.parametrize("saves, faults", [
    ("sync", "sigterm@6:rank=1"), ("sync", "crash@6:rank=0"),
    ("async_sharded", "crash@6:rank=0")])
def test_drill_then_relaunch_is_bitwise(saves, faults, files, clean):
    root, confs = files
    conf = confs[saves]
    tag = saves + "_" + faults.split("@")[0]
    out = launch(root, conf, tag, faults)
    for k, (rc, log) in enumerate(out):
        assert rc == 75, f"process {k} exited {rc}:\n{log}"
        assert "resumed from" not in log  # no restart in place
    if "sigterm" in tag:
        steps = [re.search(r"drained at step (\d+)", log).group(1)
                 for _, log in out]
        assert steps == ["6", "6"]
        assert "injected sigterm@6" in out[1][1]
        assert "coordinated drain" in out[0][1]
    else:
        assert "FAULT: crash@6" in out[0][1]
    if saves == "async_sharded":
        # the save before the crash published whole, both shards
        ws = root / f"ws_{tag}" / "checkpoints"
        assert (ws / "LATEST").read_text().strip().endswith("step_4.ckpt")
        assert {"proc_0.npz", "proc_1.npz", "manifest.json"} <= set(
            os.listdir(ws / "step_4.ckpt"))
    again = launch(root, conf, tag)
    assert all(re.search(r"resumed (sharded )?from", log)
               for _, log in again)
    assert digests(again) == clean


def _rollback(lines) -> tuple:
    """(step, save, LR scale) of the one rollback a log holds."""
    got = [m.groups() for m in map(ROLLBACK_RE.search, lines) if m]
    assert len(got) == 1, lines
    step, path, scale = got[0]
    return int(step), os.path.basename(path), float(scale)


def test_rollback_across_processes_agrees(files):
    """nanloss@5 on both processes under kRollback (after 1, async
    sharded saves every 4): each rolls back once, at the step, to the
    save and with the LR scale of the one-process run, and ends with its
    guard counters and digest."""
    root, confs = files
    conf = confs["rollback"]
    ref, ctx, ref_lines = one_process(root, conf, "one_rb", "nanloss@5")
    want = _rollback(ref_lines)
    assert want == (6, "step_4.ckpt", 0.5) and ctx.rollbacks == 1
    out = launch(root, conf, "rollback", "nanloss@5")
    for _, log in out:
        assert _rollback(log.splitlines()) == want, log
    for rep in reports(out):
        assert rep["guard"] == ref.guard_counters()
        assert rep["rollbacks"] == 1
        assert rep["digest"] == ref.digest()
