"""The expert axis and kMoE's routing across OS processes, for the sync
Trainer through ``main``.

Each kMoE lane computes its own output and aux loss with its own params
(``MoELayer.apply_ranks``): its routing group's tokens reach it through
one exchange (``moe.share``), the expert ranks' partial outputs
(psum form) or their experts' outputs on every source's buffers
(all-to-all form) through a second over the expert axis, and the
all-to-all form's statistics over the data axis. Any of them may cross
processes. A P-process run is held bitwise to the port's one-process
run of the same ranks; the one-process runs stay held to the JAX
package by tests/test_torch_axes_moe.py and test_torch_moe_routing.py
(and kMoE on a data axis across processes to the JAX Trainer's global
routing by test_torch_moe_routing.py).

The test LM with a kMoE FFN (``lm_text``: 4 experts, capacity factor
1.0, batch 16) on data 2 x expert 4 as 2 processes of 4 ranks (whole
expert groups) and 4 of 2 (each expert group over two processes), psum
and all-to-all; kMoE beside a seq axis with every rank its own process;
``zero_update`` with a sharded save on 4 processes, restored on one,
and one process's save restored on 4. Planted, each patched in from
outside the port: the exchange backward that keeps only this process's
consumers' gradients (the remote experts' share of each token's
gradient dropped), and a kMoE that routes each process's tokens alone
(the data axis's global batch on 2 processes): each must leave the
one-process params by more than 100 times the JAX oracle's bar.
"""

import pytest

from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.parallel.mesh import mesh_from_cluster
from singa_tpu_torch.trainer import Trainer
from test_torch_axes_seq import lm_text, one_torch_thread, shard  # noqa: F401
from test_torch_axes_span_seq import (
    STEPS, check_axes, fault_miss, one_run)
from test_torch_model_span_trainer import LOCAL_ONLY_MAIN, span_launch
from test_torch_multiprocess_zero import SHARDED, arrays, assert_same

#: tinylm_moe.conf's cluster_ep.conf: data 2 x expert 4
EP = "nworkers: 8\nnprocs_per_group: 4\nnexperts_per_group: 4"

#: a child that runs ``main`` with kMoE seeing only this process's parts
#: of each routing group (the planted fault: every part of another
#: process's lanes replaced by one of this process's, so each process
#: routes its tokens alone), patched in from outside the port
ALONE_MAIN = """
import sys
from singa_tpu_torch.parallel import moe

real = moe.share

def alone(lanes, g, parts, axes):
    got = real(lanes, g, parts, axes)
    group = lanes.mesh.group_of(lanes.ranks[g[0]], axes)
    mine = [i for i, r in enumerate(group) if lanes.mesh.is_local(r)]
    return [[w[i] if i in mine else w[mine[i % len(mine)]]
             for i in range(len(group))] for w in got]

moe.share = alone
from singa_tpu_torch.main import main
sys.exit(main(sys.argv[1:]))
"""


def moe_text(shard, dispatch, extra=""):
    return lm_text(shard, moe=dispatch, cf=1.0, batch=16, extra=extra)


@pytest.fixture(scope="module", params=["psum", "alltoall"])
def ep_run(request, shard, tmp_path_factory):
    """(dispatch, its conf, the one-process data 2 x expert 4 run)."""
    text = moe_text(shard, request.param)
    tmp = tmp_path_factory.mktemp(f"ep_{request.param}")
    return request.param, text, one_run(text, EP, 8, tmp)


@pytest.mark.parametrize("nprocs", [2, 4], ids=["whole", "spanning"])
def test_expert_axis_over_processes_equals_one_process(tmp_path, ep_run,
                                                       nprocs):
    dispatch, text, one = ep_run
    assert one.mesh_shape["expert"] == 4
    assert one._layout["moe/up"] == (0, "expert")
    reports = span_launch(tmp_path, text, nprocs, EP)
    # whole groups: the all-to-all form's statistics still cross the
    # data axis inside the layer
    check_axes(reports, nprocs, one.digest(),
               exchanged=nprocs == 4 or dispatch == "alltoall")


def test_moe_beside_a_seq_axis_one_rank_a_process(tmp_path, shard):
    """kMoE's psum form beside the ring on data 1 x seq 2 x expert 2,
    each rank its own process: each expert rank's tokens gathered over
    its seq group, the partial outputs over its expert group, each
    across two processes."""
    lines = ("nworkers: 4\nnprocs_per_group: 4\nnseq_per_group: 2\n"
             "nexperts_per_group: 2")
    text = lm_text(shard, mode="ring", moe="psum", cf=1.0)
    reports = span_launch(tmp_path, text, 4, lines)
    one = one_run(text, lines, 4, tmp_path)
    check_axes(reports, 4, one.digest(), exchanged=True)


def test_dropping_remote_expert_consumers_gradients_misses_the_bar(
        tmp_path, ep_run):
    _, text, one = ep_run
    reports = span_launch(tmp_path, text, 4, EP, name="fault",
                          child=("-c", LOCAL_ONLY_MAIN))
    assert all(r["digest"] != one.digest() for r in reports)
    assert fault_miss(tmp_path, "fault", one) > 100


def test_routing_each_processs_tokens_alone_misses_the_bar(tmp_path, shard):
    """The data axis's global routing on 2 processes of one rank: routed
    alone, each process's capacity holds only its own tokens."""
    text = moe_text(shard, "psum")
    one = one_run(text, "nworkers: 2", 2, tmp_path)
    reports = span_launch(tmp_path, text, 2, "nworkers: 2", name="alone",
                          child=("-c", ALONE_MAIN))
    assert all(r["digest"] != one.digest() for r in reports)
    assert fault_miss(tmp_path, "alone", one) > 100


def test_zero_and_sharded_saves_across_the_expert_axis(tmp_path, shard):
    """zero_update on data 2 x expert 4 as 4 processes of 2 ranks: every
    digest the one-process run's; the 4-process sharded save restores on
    one process to its arrays, and the one-process save restores on 4
    processes to its digest."""
    text = moe_text(shard, "psum", "zero_update: true\n" + SHARDED)
    reports = span_launch(tmp_path, text, 4, EP)
    one = one_run(text, EP, 8, tmp_path)
    assert one.update_mode == "zero"
    check_axes(reports, 4, one.digest(), exchanged=True)
    want = arrays(one)
    saved = tmp_path / "ws_span" / "checkpoints" / f"step_{STEPS}.ckpt"
    cfg = t_parse(text)
    cfg.checkpoint = str(saved)
    back = Trainer(cfg, mesh=mesh_from_cluster(one.cluster, ["cpu"] * 8),
                   seed=7, log=lambda s: None)
    assert back.start_step == STEPS
    assert_same(arrays(back), want)
    mine = tmp_path / "ws_one" / "checkpoints" / f"step_{STEPS}.ckpt"
    resumed = span_launch(tmp_path, text + f'checkpoint: "{mine}"\n', 4, EP,
                          name="resume")
    check_axes(resumed, 4, one.digest(), exchanged=False, steps=0)
