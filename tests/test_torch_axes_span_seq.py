"""The seq axis across OS processes, for the sync Trainer through ``main``.

The JAX package runs its seq ring over the global device list, so under
``jax.distributed`` ring attention's K/V cross hosts with no code of
their own. The port hands each seq lane every rank's K/V block (ring
mode) or every rank's Q/K/V block (the global attention of the other
modes) through one exchange over the seq group (``Lanes.exchange``),
and kLMLoss's shifted targets and sums through two more; a group may
span processes. No JAX test runs the axes across processes, so a
P-process run is held bitwise to the port's one-process run of the same
ranks (every process's digest of params and slots); the one-process run
stays held to the JAX package by tests/test_torch_axes_seq.py.

The test LM (tests/test_torch_axes_seq.py's ``lm_text``: d 32, 2 heads,
vocab 64, S 16, float32, 4 steps) on data 2 x seq 4 through the real CLI
over gloo on the CPU, in both attention modes, as 2 processes of 4 ranks
(whole seq groups; the data axis crosses) and as 4 processes of 2 (each
seq group over two processes); the ``grad_comm`` reference seam; and
kLayerPartition beside a seq axis with every rank its own process. A planted fault, every exchange's
backward keeping only this process's consumers' gradients, patched in
from outside the port, must leave the one-process params by more than
100 times the JAX oracle's bar (tests/test_torch_model_span_trainer.py's
rtol 1e-4, atol 1e-5). A process that would hold parts of two seq groups
is refused by name.

It also holds the helpers of the other ``test_torch_axes_span_*`` files.
"""

import numpy as np
import pytest
import torch

from singa_tpu_torch.config import ConfigError
from singa_tpu_torch.config import parse_cluster_config as t_cluster
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.parallel import mesh as t_mesh
from singa_tpu_torch.parallel.mesh import build_full_mesh, mesh_from_cluster
from singa_tpu_torch.trainer import make_trainer
from test_torch_axes_seq import lm_text, one_torch_thread, shard  # noqa: F401
from test_torch_model_span_trainer import (
    ATOL, LOCAL_ONLY_MAIN, RTOL, span_launch)

#: ``lm_text``'s train_steps
STEPS = 4
#: tinylm_ring.conf's cluster_sp.conf: data 2 x seq 4
SP = "nworkers: 8\nnprocs_per_group: 4\nnseq_per_group: 4"


def one_run(text: str, lines: str, n: int, tmp_path, name: str = "one"):
    """The job in this process on the ``n`` CPU ranks of the cluster
    conf lines ``lines``, run to its end (its final save in
    ``tmp_path/ws_{name}``) on one intra-op thread, as the children run
    (a module fixture's run comes before the autouse fixture's pin)."""
    cl = t_cluster(f'{lines}\nworkspace: "{tmp_path}/ws_{name}"')
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tr = make_trainer(t_parse(text), cl,
                          mesh=mesh_from_cluster(cl, ["cpu"] * n), seed=0,
                          log=lambda s: None)
        tr.run()
    finally:
        torch.set_num_threads(threads)
    return tr


def check_axes(reports, nprocs: int, digest: str, exchanged: bool,
               steps: int = STEPS):
    """Each process on gloo and the CPU with its share of the ranks,
    with (or without) layer exchanges, every digest ``digest``."""
    per = len(reports[0]["ranks"])
    for k, rep in enumerate(reports):
        assert (rep["proc"], rep["nprocs"], rep["backend"], rep["device"]) \
            == (k, nprocs, "gloo", "cpu"), rep
        assert rep["ranks"] == list(range(k * per, (k + 1) * per)), rep
        assert rep["steps"] == steps, rep
        assert (rep["layer_exchange_s"] > 0) == exchanged, rep
        assert rep["digest"] == digest, (k, rep["digest"], digest)


def fault_miss(tmp_path, name: str, one, steps: int = STEPS) -> float:
    """How far process 0's final npz save of the job ``name`` leaves the
    one-process run's params, in units of the JAX oracle's bar."""
    path = tmp_path / f"ws_{name}" / "checkpoints" / f"step_{steps}.npz"
    miss = 0.0
    with np.load(path) as z:
        for n, v in one.params.items():
            want = one._unpad_one(n, v).numpy()
            miss = max(miss, float(np.max(np.abs(z[f"p|{n}"] - want)
                                          / (ATOL + RTOL * np.abs(want)))))
    return miss


@pytest.fixture(scope="module", params=["ring", "flash"])
def seq_run(request, shard, tmp_path_factory):
    """(mode, its conf, the one-process data 2 x seq 4 run)."""
    text = lm_text(shard, mode=request.param)
    tmp = tmp_path_factory.mktemp(f"seq_{request.param}")
    return request.param, text, one_run(text, SP, 8, tmp)


@pytest.mark.parametrize("nprocs", [2, 4], ids=["whole", "spanning"])
def test_seq_axis_over_processes_equals_one_process(tmp_path, seq_run,
                                                    nprocs):
    mode, text, one = seq_run
    assert one.mesh_shape == {"data": 2, "pipe": 1, "expert": 1, "seq": 4,
                              "model": 1}
    reports = span_launch(tmp_path, text, nprocs, SP)
    # whole groups: only the data axis crosses (Mesh.gather)
    check_axes(reports, nprocs, one.digest(), exchanged=nprocs == 4)


def test_seq_beside_a_model_axis_one_rank_a_process(tmp_path, shard):
    """kLayerPartition beside the ring on data 1 x seq 2 x model 2, each
    rank its own process: the fused projection's Concate and the output
    projection's partial sums over model groups, the ring's K/V over seq
    groups, each across two processes."""
    lines = "nworkers: 4\nnprocs_per_group: 4\nnseq_per_group: 2"
    text = lm_text(shard, mode="ring", part=True)
    reports = span_launch(tmp_path, text, 4, lines)
    one = one_run(text, lines, 4, tmp_path)
    assert one._layout["attn/qkv"] == (1, "model")
    check_axes(reports, 4, one.digest(), exchanged=True)


def test_the_grad_comm_seam_beside_a_seq_axis_over_processes(tmp_path,
                                                             shard):
    """The ``grad_comm`` reference seam (the q8 cast with error feedback
    on each param's summed gradient, after the processes' gather) on 4
    processes of 2 ranks."""
    text = lm_text(shard, mode="ring",
                   extra="grad_comm { mode: quantized buckets: 2 }")
    reports = span_launch(tmp_path, text, 4, SP)
    one = one_run(text, SP, 8, tmp_path)
    assert one.comm_mode == "quantized"
    check_axes(reports, 4, one.digest(), exchanged=True)


def test_dropping_remote_seq_consumers_gradients_misses_the_bar(tmp_path,
                                                                seq_run):
    """The planted fault on 4 processes of 2 ranks: each K/V block's
    gradient from this process's folds only, the ring's other half
    dropped."""
    _, text, one = seq_run
    reports = span_launch(tmp_path, text, 4, SP, name="fault",
                          child=("-c", LOCAL_ONLY_MAIN))
    assert all(r["digest"] != one.digest() for r in reports)
    assert fault_miss(tmp_path, "fault", one) > 100


def test_a_process_holding_parts_of_two_seq_groups_is_refused(monkeypatch):
    """Whole seq groups on a process, or a seq group over whole
    processes; data 1 x seq 2 x model 2 on 2 processes of 2 ranks puts
    one rank of each seq group on each process."""
    monkeypatch.setattr(t_mesh, "_processes", lambda: (4, 1))
    m = build_full_mesh({"data": 2, "seq": 4}, ["cpu"] * 2)
    assert list(m.local_ranks) == [2, 3]
    assert m.group_of(3, ("seq",)) == (0, 1, 2, 3)
    assert m.spanning_groups(("seq",)) == [(0, 1), (2, 3)]
    monkeypatch.setattr(t_mesh, "_processes", lambda: (2, 1))
    with pytest.raises(ConfigError, match=(
            "^seq axis width 2 \\(nseq_per_group\\) across 2 processes of 2 "
            "ranks: a process would hold parts of two seq groups")):
        build_full_mesh({"seq": 2, "model": 2}, ["cpu"] * 2)

