"""Multi-process training in the port: two OS processes through the real
CLI (``python -m singa_tpu_torch.main -procsID k -hostfile hf -device
cpu``) over gloo on the CPU, on tests/test_multiprocess.py's MLP conf
(6 steps, batch 32, a synthetic shard), under exact data parallel, the
reference q8 seam, the flat int8 ring and q8_hier at 2 processes x 2
ranks (tests/test_torch_multiprocess_zero.py has zero, zero + ring and
the sharded saves).

For each mode: (i) the processes end with the same params and slots to
the bit (each prints ``Trainer.digest``), (ii) those of the port's
one-process Trainer over the same global rank count, and (iii) within
tests/test_torch_ring_trainer.py's bars of the JAX Trainer on a mesh of
that width (losses 1e-4 at every step; params 1e-4 exact, 5e-4
quantized, after the 5 steps those bars are set for), every run from
the JAX Trainer's initial params (an npz the conf restores). The conf's
learning rate 0.05 with momentum 0.9 multiplies float32 rounding about
8x a step: on one rank, with no reduction at all, the two packages'
params differ by 2.6e-5 after 5 steps and by 6.5e-4 after 6 (measured
on the CPU), so the sixth step is held bitwise to the
one-process port run only. The
ring's bytes, counted at each process's ``ppermute`` for its own ranks,
sum to the one-process count. The 4-wide ring needs the head's bias to
chunk over 4 ranks, so that job's head has 12 outputs (the 10 classes
and two never labelled): a 10-wide bias is refused by both packages.
"""

import json
import sys

import jax
import numpy as np
import pytest

from singa_tpu.config import parse_model_config as j_parse
from singa_tpu.parallel import build_mesh as j_mesh
from singa_tpu.trainer import Trainer as JTrainer
from singa_tpu.trainer.checkpoint import save_checkpoint as j_save
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.data import loader as t_loader
from singa_tpu_torch.ops import quantized_collective as tq
from singa_tpu_torch.parallel import build_mesh
from singa_tpu_torch.trainer import Trainer
from test_multiprocess import STEPS, _conf_text
from test_torch_launch import one_torch_thread, run_processes  # noqa: F401

LOSS_TOL = 1e-4
#: the params are held to the JAX Trainer's after this many steps
PARAM_STEPS = 5
RING = ("grad_comm { mode: quantized buckets: 2 }\n"
        "kernels { grad_allreduce: quantized_ring }\n")
#: mode -> (ranks a process, conf lines)
MODES = {
    "exact": (1, ""),
    "reference": (1, "grad_comm { mode: quantized buckets: 2 }\n"),
    "quantized_ring": (1, RING),
    "q8_hier": (2, "grad_comm { mode: quantized buckets: 2 }\n"
                   "kernels { grad_allreduce: q8_hier }\n"
                   "ring { intra_degree: 2 }\n"),
}


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mp_shard") / "shard")
    t_loader.write_records(path, *t_loader.synthetic_arrays(128, seed=5))
    return path


def job_text(shard, extra: str, width: int, checkpoint: str = "") -> str:
    """The MLP conf with ``extra``; a 12-output head at width 4; resumed
    from ``checkpoint`` when given."""
    txt = _conf_text(shard)
    if width == 4:
        assert "num_output: 10" in txt
        txt = txt.replace("num_output: 10", "num_output: 12")
    if checkpoint:
        extra += f'checkpoint: "{checkpoint}"\n'
    return txt + extra


def step_loss(tr, step):
    tr.train_one_batch(step)
    loss = tr.perf.avg()["loss"]["loss"]
    tr.perf.reset()
    return loss


def jax_run(text, width, init_path):
    """The JAX Trainer on ``width`` of the suite's virtual devices: its
    initial params saved to ``init_path``, then STEPS steps -> (losses,
    the params after PARAM_STEPS)."""
    jt = JTrainer(j_parse(text), mesh=j_mesh(width, 1, jax.devices()[:width]),
                  seed=0, log=lambda s: None, prefetch=False)
    j_save(init_path, 0, {n: np.asarray(v) for n, v in jt.params.items()})
    losses, params = [], None
    for s in range(STEPS):
        losses.append(step_loss(jt, s))
        if s + 1 == PARAM_STEPS:
            params = {n: np.array(v) for n, v in jt.params.items()}
    return losses, params


def port_run(text, width):
    """The port's one-process Trainer over ``width`` CPU ranks, STEPS
    steps -> (trainer, losses, the params after PARAM_STEPS, the ring's
    counted bytes)."""
    tr = Trainer(t_parse(text), mesh=build_mesh(width, 1, ["cpu"] * width),
                 seed=0, log=lambda s: None)
    tq.ppermute.sent_bytes.clear()
    losses, params = [], None
    for s in range(STEPS):
        losses.append(step_loss(tr, s))
        if s + 1 == PARAM_STEPS:
            params = {n: v.numpy().copy() for n, v in tr.params.items()}
    return tr, losses, params, sum(tq.ppermute.sent_bytes.values())


def cli(conf, cluster):
    """process k's command line for run_processes."""
    return lambda k, hostfile: [
        sys.executable, "-m", "singa_tpu_torch.main", "-model_conf",
        str(conf), "-cluster_conf", str(cluster), "-procsID", str(k),
        "-hostfile", hostfile, "-device", "cpu"]


def launch(tmp_path, text, width, name="job", extra_cluster=""):
    """The job as two processes of width/2 ranks each -> (reports, logs)."""
    conf = tmp_path / f"{name}.conf"
    conf.write_text(text)
    cluster = tmp_path / f"{name}_cluster.conf"
    cluster.write_text(f'nworkers: {width}\nworkspace: "{tmp_path}/ws_{name}"'
                       f"\n{extra_cluster}")
    out = run_processes(tmp_path, cli(conf, cluster), name=name)
    reports = []
    for k, (rc, log) in enumerate(out):
        assert rc == 0, f"process {k} exited {rc}:\n{log}"
        line = [ln for ln in log.splitlines()
                if ln.startswith("TRAIN PROCESS: ")]
        assert len(line) == 1, log
        reports.append(json.loads(line[0].split(": ", 1)[1]))
    return reports, [log for _, log in out]


def check_reports(reports, width, digest):
    """(i) and (ii): both processes on gloo and the CPU with their ranks,
    the same digest, the one-process run's."""
    per = width // 2
    for k, rep in enumerate(reports):
        assert (rep["proc"], rep["nprocs"], rep["backend"], rep["device"]) \
            == (k, 2, "gloo", "cpu"), rep
        assert rep["ranks"] == list(range(k * per, (k + 1) * per)), rep
        assert rep["steps"] == STEPS and rep["quant_acc_launches"] == 0
    assert reports[0]["digest"] == reports[1]["digest"], reports
    assert reports[0]["digest"] == digest


@pytest.mark.parametrize("mode", sorted(MODES))
def test_two_processes_equal_one_process_and_the_jax_trainer(
        tmp_path, shard, mode):
    per, extra = MODES[mode]
    width = 2 * per
    init = str(tmp_path / "init.npz")
    jlosses, jparams = jax_run(job_text(shard, extra, width), width, init)
    text = job_text(shard, extra, width, init)
    reports, _ = launch(tmp_path, text, width)
    tr, losses, params, sent = port_run(text, width)
    check_reports(reports, width, tr.digest())
    # the steps' bytes: each process's count less its comm probe's
    probe = sum(r["comm_probe"]["ring_sent_bytes"] for r in reports)
    assert sum(r["ring_sent_bytes"] for r in reports) - probe == sent
    assert (probe > 0) == (sent > 0)
    assert (sent > 0) == ("ring" in mode or "hier" in mode)
    for j, t in zip(jlosses, losses):
        assert abs(j - t) <= LOSS_TOL, (jlosses, losses)
    atol = 1e-4 if mode == "exact" else 5e-4
    for n, v in params.items():
        np.testing.assert_allclose(v, jparams[n], atol=atol, err_msg=n)
    # process 0 wrote the final npz save: the one-process params
    with np.load(tmp_path / "ws_job" / "checkpoints" / f"step_{STEPS}.npz") \
            as z:
        for n, v in tr.params.items():
            np.testing.assert_array_equal(z[f"p|{n}"], v.numpy(), err_msg=n)


def test_a_process_that_fails_ends_the_job_with_its_exit_code(
        tmp_path, shard):
    """Process 1's conf names a shard that does not exist: it exits 1
    after the rendezvous, and process 0, at its first exchange, sees the
    peer gone and exits 1 too; neither hangs."""
    good = tmp_path / "good.conf"
    good.write_text(job_text(shard, "", 2))
    bad = tmp_path / "bad.conf"
    bad.write_text(job_text(shard + "_missing", "", 2))
    cluster = tmp_path / "cluster.conf"
    cluster.write_text("nworkers: 2\n")
    out = run_processes(tmp_path, lambda k, hf: cli(
        bad if k else good, cluster)(k, hf), name="fail", timeout=90)
    assert [rc for rc, _ in out] == [1, 1], out
    assert "TRAIN PROCESS" not in out[0][1] + out[1][1]
    assert "Traceback" in out[1][1]
