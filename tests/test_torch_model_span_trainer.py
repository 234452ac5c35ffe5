"""A model group that spans OS processes in the port, for the sync
Trainer: the reference's partitioned workers one process each (the
JAX package's dp x tp over four processes, tests/test_multiprocess.py:
285, which runs there as a slow test), through the real CLI over gloo
on the CPU.

tests/test_multiprocess.py's MLP with kLayerPartition on data 2 x
model 2 as 4 processes of one rank each: every kInnerProduct's Concate
crosses a process boundary inside the layer (``Lanes.exchange``), its
gradients come back across it in the backward. Every process ends with
the digest of one process holding the four ranks, bitwise, and that
one-process run is held to the JAX package's single-process Trainer on
its ``build_mesh(2, 2)`` from the same initial params: the losses
within 1e-4 at every step, the params at the JAX oracle's bars (rtol
1e-4, atol 1e-5) after 3 steps (``PARAM_STEPS``). A planted fault, an
exchange whose backward keeps only this process's consumers'
gradients, patched into the four processes from outside the port, must
leave the JAX params by more than 100 times that bar.

It also holds the launcher of the other ``test_torch_model_span_*``
files: ``span_launch`` runs a job as n processes through ``main``.
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
from singa_tpu_torch.config import parse_cluster_config as t_cluster
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.parallel import build_mesh
from singa_tpu_torch.trainer import make_trainer
from test_multiprocess import STEPS, _conf_text
from test_torch_launch import one_torch_thread, run_processes  # noqa: F401
from test_torch_multiprocess import shard  # noqa: F401

PARTITION = 'partition_type: "kLayerPartition"'
#: tests/test_multiprocess.py's bars for the 4-process run against the
#: single-process (2, 2) mesh
RTOL, ATOL = 1e-4, 1e-5
#: the params are held to the JAX Trainer's at those bars after this many
#: steps (the losses at every step): the conf's learning rate 0.05 with
#: momentum 0.9 multiplies float32 rounding several times a step, and
#: even one rank with no exchange at all leaves the JAX params by 1.1e-5
#: after 4 steps and 6.5e-4 after 6 (measured on the CPU); the later
#: steps are held bitwise to the one-process port run
PARAM_STEPS = 3
LOSS_TOL = 1e-4


#: a child that runs ``main`` with the exchange's backward keeping only
#: this process's consumers' gradients (the planted fault: the remote
#: consumers' gradients dropped), patched in from outside the port
LOCAL_ONLY_MAIN = """
import functools, sys
import torch
from singa_tpu_torch.parallel import axes

def local_only(ctx, *grads):
    plan = ctx.plan
    mine = torch.stack(grads)
    return (None, *(functools.reduce(torch.add, (
        mine[c, plan.first + k] for c in range(mine.shape[0])))
        for k in range(plan.local)))

axes.GroupExchange.backward = staticmethod(local_only)
from singa_tpu_torch.main import main
sys.exit(main(sys.argv[1:]))
"""


def span_launch(tmp_path, text, nprocs, cluster, name="span",
                child=("-m", "singa_tpu_torch.main")):
    """The job ``text`` on the cluster conf lines ``cluster`` as
    ``nprocs`` processes through ``main -device cpu`` (or the Python
    ``child`` arguments that end in it) -> their ``TRAIN PROCESS``
    reports, in process order."""
    conf = tmp_path / f"{name}.conf"
    conf.write_text(text)
    cl = tmp_path / f"{name}_cluster.conf"
    cl.write_text(f'{cluster}\nworkspace: "{tmp_path}/ws_{name}"\n')
    out = run_processes(tmp_path, lambda k, hf: [
        sys.executable, *child, "-model_conf",
        str(conf), "-cluster_conf", str(cl), "-procsID", str(k),
        "-hostfile", hf, "-device", "cpu"], nprocs, name=name)
    reports = []
    for k, (rc, log) in enumerate(out):
        assert rc == 0, f"process {k} exited {rc}:\n{log}"
        line = [ln for ln in log.splitlines()
                if ln.startswith("TRAIN PROCESS: ")]
        assert len(line) == 1, log
        reports.append(json.loads(line[0].split(": ", 1)[1]))
    return reports


def one_process(text, cluster, ndata, nmodel, tmp_path, run=True):
    """The same job in this process on ndata x nmodel CPU ranks."""
    tr = make_trainer(
        t_parse(text), t_cluster(f'{cluster}\nworkspace: "{tmp_path}/one"'),
        mesh=build_mesh(ndata, nmodel, ["cpu"] * (ndata * nmodel)), seed=0,
        log=lambda s: None)
    if run:
        tr.run()
    return tr


def check_span(reports, nprocs, per, digest, steps=STEPS, exchanged=True):
    """Each process on gloo and the CPU with its ranks, with (or without)
    layer exchanges, every digest the one-process run's."""
    for k, rep in enumerate(reports):
        assert (rep["proc"], rep["nprocs"], rep["backend"], rep["device"]) \
            == (k, nprocs, "gloo", "cpu"), rep
        assert rep["ranks"] == list(range(k * per, (k + 1) * per)), rep
        assert rep["steps"] == steps, rep
        assert (rep["layer_exchange_s"] > 0) == exchanged, rep
        assert rep["digest"] == digest, (k, rep["digest"], digest)


def steps_of(tr, steps=STEPS, keep=0):
    """``steps`` steps -> (each step's loss, the logical params after
    the first ``keep``)."""
    losses, params = [], None
    for s in range(steps):
        tr.train_one_batch(s)
        losses.append(float(tr.perf.avg()["loss"]["loss"]))
        tr.perf.reset()
        if s + 1 == keep:
            params = {n: np.array(v) for n, v in tr._unpad_stored(
                tr.params).items()} if hasattr(tr, "_unpad_stored") else {
                n: tr._unpad_one(n, v).numpy().copy()
                for n, v in tr.params.items()}
    return losses, params


@pytest.fixture(scope="module")
def oracle(shard, tmp_path_factory):
    """The JAX single-process Trainer on its (2, 2) mesh: its initial
    params saved for the port, then STEPS steps -> (the conf the port
    runs, the JAX losses, the JAX params after PARAM_STEPS)."""
    tmp = tmp_path_factory.mktemp("span_oracle")
    text = _conf_text(shard, PARTITION)
    jt = JTrainer(j_parse(text), mesh=j_mesh(2, 2, jax.devices()[:4]),
                  seed=0, log=lambda s: None, prefetch=False)
    init = str(tmp / "init.npz")
    j_save(init, 0, {n: np.asarray(v)
                     for n, v in jt._unpad_stored(jt.params).items()})
    return (text + f'checkpoint: "{init}"\n',
            *steps_of(jt, keep=PARAM_STEPS))


@pytest.fixture(scope="module")
def one(oracle, tmp_path_factory):
    """The port's one-process Trainer on (2, 2), STEPS steps -> (it, its
    losses, its params after PARAM_STEPS)."""
    tr = one_process(oracle[0], "nworkers: 4\nnprocs_per_group: 2", 2, 2,
                     tmp_path_factory.mktemp("span_one"), run=False)
    return (tr, *steps_of(tr, keep=PARAM_STEPS))


def test_one_process_2x2_matches_the_jax_trainer(oracle, one):
    tr, losses, params = one
    assert tr.mesh_shape == {"data": 2, "model": 2}
    assert tr._layout["fc1/w"] == (1, "model")
    np.testing.assert_allclose(losses, oracle[1], rtol=0, atol=LOSS_TOL)
    for n, want in oracle[2].items():
        np.testing.assert_allclose(params[n], want, rtol=RTOL, atol=ATOL,
                                   err_msg=n)


def test_four_processes_of_one_rank_equal_one_process(tmp_path, oracle,
                                                      one):
    """Layout 1 (the JAX oracles'): data 2 x model 2, one rank a
    process; each model group spans two processes."""
    reports = span_launch(tmp_path, oracle[0], 4,
                          "nworkers: 4\nnprocs_per_group: 2")
    check_span(reports, 4, 1, one[0].digest())


def test_dropping_the_remote_consumers_gradients_misses_the_bar(
        tmp_path, oracle):
    """The planted fault in every process of layout 1: each part's
    gradient from this process's consumers only. After PARAM_STEPS steps
    process 0's save leaves the JAX params by more than 100 times the
    bar."""
    text = oracle[0].replace(f"train_steps: {STEPS}",
                             f"train_steps: {PARAM_STEPS}")
    reports = span_launch(tmp_path, text, 4,
                          "nworkers: 4\nnprocs_per_group: 2", name="fault",
                          child=("-c", LOCAL_ONLY_MAIN))
    assert all(r["steps"] == PARAM_STEPS for r in reports)
    path = tmp_path / "ws_fault" / "checkpoints" / f"step_{PARAM_STEPS}.npz"
    with np.load(path) as z:
        miss = max(float(np.max(np.abs(z[f"p|{n}"] - want)
                             / (ATOL + RTOL * np.abs(want))))
                   for n, want in oracle[2].items())
    assert miss > 100, miss
