"""The pipe axis across OS processes, for the sync Trainer through
``main``, and what stays refused across processes.

A process runs only its own stages (``pipeline.gpipe_lanes``): every
tick of the GPipe schedule ends in one hop, an exchange over each pipe
group that hands every lane every stage's output of the tick (zeros
from a stage idle at it), entered by every process of the group at
every tick in the same order; the last stage's output reaches every
pipe rank through the same hops. A P-process run is held bitwise to the
port's one-process run of the same ranks; the one-process run stays
held to the JAX package by tests/test_torch_axes_pipe.py.

The staged test LM (``lm_text``: two blocks at locationid 0 and 1, 4
microbatches, batch 16) on data 2 x pipe 2 as 4 processes of one rank
(every pipe group over two processes) and 2 of 2 (whole pipe groups),
and with kLayerPartition on data 1 x pipe 2 x model 2 as 4 processes of
one rank. A planted fault, every exchange's backward keeping only this
process's consumers' gradients, patched in from outside the port, must
leave the one-process params by more than 100 times the JAX oracle's
bar.

Refused by name, each queued in ROADMAP §1 item 3: a net with buffers
(kBatchNorm) on a pipe or expert mesh across processes, the replica
engine beside a seq, expert or pipe axis across processes, and
``Engine(mesh=...)`` over a seq mesh across processes (the model-axis
forms of the first and the last, and q8_hier's named axes across
processes: tests/test_torch_model_span_exchange.py and
tests/test_torch_serve_tp.py). The int8 rings (``quantized_ring`` and
the factored ``q8_hier``) beside these axes across processes keep the
JAX Trainer's refusals.
"""

import pytest
import torch

from singa_tpu_torch.config import ConfigError
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.models.transformer import TransformerConfig
from singa_tpu_torch.models.transformer import init_lm
from singa_tpu_torch.parallel.mesh import Mesh
from singa_tpu_torch.serve import Engine
from singa_tpu_torch.trainer import Trainer
from singa_tpu_torch.trainer.replica import ReplicaTrainer
from test_torch_axes_seq import lm_text, one_torch_thread, shard  # noqa: F401
from test_torch_axes_span_seq import check_axes, fault_miss, one_run
from test_torch_model_span_trainer import LOCAL_ONLY_MAIN, span_launch
from test_torch_norm import bn_text, shards  # noqa: F401
from test_torch_replica_axes import ELASTIC, PARAM

#: tinylm_pp.conf's stages on data 2 x pipe 2
PP = "nworkers: 4\nnprocs_per_group: 2\nnpipes_per_group: 2"
#: the inner axes' widths (pipe, expert, seq, model) of a mesh with one
#: of them 2 wide
INNER = {"pipe": (2, 1, 1, 1), "expert": (1, 2, 1, 1),
         "seq": (1, 1, 2, 1)}


def pp_text(shard, part=False):
    return lm_text(shard, stages=True, nmicro=4, batch=16, part=part)


@pytest.fixture(scope="module")
def pp_run(shard, tmp_path_factory):
    """(the staged conf, its one-process data 2 x pipe 2 run)."""
    text = pp_text(shard)
    return text, one_run(text, PP, 4, tmp_path_factory.mktemp("pp"))


@pytest.mark.parametrize("nprocs", [4, 2], ids=["spanning", "whole"])
def test_pipe_axis_over_processes_equals_one_process(tmp_path, pp_run,
                                                     nprocs):
    text, one = pp_run
    plan = one.train_net.pipeline_plan
    assert (plan.nstages, plan.nmicro) == (2, 4)
    reports = span_launch(tmp_path, text, nprocs, PP)
    check_axes(reports, nprocs, one.digest(), exchanged=nprocs == 4)


def test_pipe_beside_a_model_axis_one_rank_a_process(tmp_path, shard):
    """Each stage's kLayerPartition exchanges over a model group of two
    processes, the hops over pipe groups of two others."""
    lines = "nworkers: 4\nnprocs_per_group: 4\nnpipes_per_group: 2"
    text = pp_text(shard, part=True)
    reports = span_launch(tmp_path, text, 4, lines)
    one = one_run(text, lines, 4, tmp_path)
    assert one.mesh_shape["model"] == 2
    check_axes(reports, 4, one.digest(), exchanged=True)


def test_dropping_remote_stage_consumers_gradients_misses_the_bar(
        tmp_path, pp_run):
    """The planted fault on 4 processes: each stage's output takes no
    gradient from the next stage, which another process runs."""
    text, one = pp_run
    reports = span_launch(tmp_path, text, 4, PP, name="fault",
                          child=("-c", LOCAL_ONLY_MAIN))
    assert all(r["digest"] != one.digest() for r in reports)
    assert fault_miss(tmp_path, "fault", one) > 100


# ---------------------------------------------------------------------------
# what stays refused across processes
# ---------------------------------------------------------------------------


def over_processes(axis: str) -> Mesh:
    """A process of one rank on a 2-wide ``axis`` over 2 processes."""
    return Mesh((torch.device("cpu"),), nprocs=2, proc=0,
                inner=INNER[axis])


@pytest.mark.parametrize("axis", ["pipe", "expert"])
def test_buffers_on_the_axis_over_processes_are_refused(shards, axis):
    with pytest.raises(ConfigError, match=f"a net with buffers on the {axis} "
                       "2 mesh axes across 2 processes is not ported"):
        Trainer(t_parse(bn_text(shards)), mesh=over_processes(axis),
                log=lambda s: None)


@pytest.mark.parametrize("axis", sorted(INNER))
def test_the_replica_engine_beside_the_axis_over_processes_is_refused(
        shard, axis):
    kw = {"pipe": dict(stages=True), "expert": dict(moe="psum"),
          "seq": dict(mode="ring")}[axis]
    text = lm_text(shard, **kw).replace(PARAM, ELASTIC)
    with pytest.raises(ConfigError, match=(
            f"^ReplicaTrainer on the {axis} 2 mesh axes across 2 processes "
            "is not ported")):
        ReplicaTrainer(t_parse(text), mesh=over_processes(axis),
                       log=lambda s: None)


@pytest.mark.parametrize("ring,match", [
    ("kernels { grad_allreduce: quantized_ring }",
     "quantized_ring } runs over the data axis only"),
    ("kernels { grad_allreduce: q8_hier }\nring { intra_degree: 2 }",
     "q8_hier } cannot run"),
], ids=["quantized_ring", "q8_hier_factored"])
@pytest.mark.parametrize("axis", sorted(INNER))
def test_the_int8_rings_beside_the_axis_over_processes_are_refused(
        shard, axis, ring, match):
    """The rings reduce over the data axis only (the JAX Trainer's
    refusals, the same on one process)."""
    kw = {"pipe": dict(stages=True), "expert": dict(moe="psum"),
          "seq": dict(mode="ring")}[axis]
    text = lm_text(shard, **kw, extra="grad_comm { mode: quantized "
                   f"buckets: 2 }}\n{ring}")
    with pytest.raises(ConfigError, match=match):
        Trainer(t_parse(text), mesh=over_processes(axis),
                log=lambda s: None)


def test_engine_over_a_seq_mesh_across_processes_is_refused():
    cfg = TransformerConfig(vocab=32, d_model=16, n_heads=2, n_layers=1,
                            d_ff=32, max_len=16)
    params = init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(ValueError, match="over 2 processes: the serving "
                       "engine runs its mesh in one process"):
        Engine(params, cfg, mesh=over_processes("seq"))
