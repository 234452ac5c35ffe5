"""kLayerPartition's group exchange (``parallel/axes.py``'s
``Lanes.exchange``) at function level on one process, and the
compositions beside a model group that spans processes.

- The forward hands every consumer the group's parts in rank order:
  their Concate is ``torch.cat`` of the parts. The backward gives each
  part the sum of every consumer's gradient of it in consumer rank
  order, bitwise the sum written out; with one consumer (the attention a
  process runs once for its share of a group) that consumer's gradient.
- A walk whose lanes are not one process's share of a model group
  raises.
- kMoE beside a model group that spans processes runs, bitwise one
  process.
- Refused by name: a net with buffers (kBatchNorm) on an axes mesh over
  processes, and the named q8_hier (``ring { intra_axis/inter_axis }``)
  over processes, spanning groups or whole ones (it raised an
  IndexError before: its ring view indexed one process's devices by
  global rank) (the other axes: tests/test_torch_axes_span_pipe.py;
  ``Engine(mesh=...)`` over processes: tests/test_torch_serve_tp.py).
"""

import functools

import numpy as np
import pytest
import torch

from singa_tpu_torch.config import ConfigError
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.parallel import Mesh, build_mesh
from singa_tpu_torch.parallel.axes import Lanes, concate
from singa_tpu_torch.trainer import Trainer
from test_torch_axes_seq import lm_text, shard  # noqa: F401
from test_torch_launch import one_torch_thread  # noqa: F401
from test_torch_multiprocess import job_text
from test_torch_multiprocess import shard as mlp_shard  # noqa: F401
from test_torch_norm import bn_text, shards  # noqa: F401

#: a process of one rank whose model group of 2 spans two processes
SPANNING = Mesh((torch.device("cpu"),), nprocs=2, proc=0,
                inner=(1, 1, 1, 2))


def seeded(*shape, seed):
    return torch.from_numpy(np.random.RandomState(seed).standard_normal(
        shape).astype(np.float32))


@pytest.mark.parametrize("per_lane", [True, False])
def test_exchange_is_cat_forward_and_the_rank_order_sum_backward(per_lane):
    lanes = Lanes(build_mesh(2, 3, ["cpu"] * 6), tuple(range(6)))
    assert lanes.groups("model") == [[0, 1, 2], [3, 4, 5]]
    for g in lanes.groups("model"):
        parts = [seeded(4, 5, seed=j).requires_grad_(True) for j in g]
        outs = lanes.exchange(g, parts, per_lane=per_lane)
        assert len(outs) == (len(g) if per_lane else 1)
        weights = [seeded(4, 15, seed=10 + c) for c in range(len(outs))]
        for whole in outs:
            assert torch.equal(concate(whole, -1), torch.cat(parts, -1))
        sum(((concate(whole, -1) * w).sum() for whole, w
             in zip(outs, weights)), torch.zeros(())).backward()
        for k, p in enumerate(parts):
            want = functools.reduce(torch.add, (
                w[:, 5 * k:5 * (k + 1)] for w in weights))
            assert torch.equal(p.grad, want)


def test_lanes_that_are_not_a_share_of_one_group_raise():
    lanes = Lanes(build_mesh(1, 4, ["cpu"] * 4), (0, 2))
    with pytest.raises(ValueError, match="not one process's share"):
        lanes.exchange([0, 1], [torch.zeros(2), torch.zeros(2)])


def test_moe_beside_a_spanning_model_group_is_refused(shard, tmp_path):
    """(Named for the refusal it held until kMoE's routing crossed
    processes.) kMoE beside kLayerPartition on data 1 x model 2 as 2
    processes of one rank: each model rank routes its own copy of the
    tokens, and every process ends with the one-process digest."""
    from test_torch_axes_span_seq import check_axes, one_run
    from test_torch_model_span_trainer import span_launch

    lines = "nworkers: 2\nnprocs_per_group: 2"
    text = lm_text(shard, moe="psum", part=True)
    reports = span_launch(tmp_path, text, 2, lines)
    check_axes(reports, 2, one_run(text, lines, 2, tmp_path).digest(),
               exchanged=True)


def test_buffers_on_an_axes_mesh_over_processes_are_refused(shards):
    text = bn_text(shards).replace(
        "neuralnet {", "neuralnet {\n  partition_type: kLayerPartition", 1)
    with pytest.raises(ConfigError, match="a net with buffers on the model 2 "
                       "mesh axes across 2 processes is not ported"):
        Trainer(t_parse(text), mesh=SPANNING, log=lambda s: None)


@pytest.mark.parametrize("mesh", [
    SPANNING, Mesh((torch.device("cpu"),) * 2, nprocs=2, proc=1,
                   inner=(1, 1, 1, 2))], ids=["spanning", "whole_groups"])
def test_named_q8_hier_over_processes_is_refused(mlp_shard, mesh):
    text = job_text(mlp_shard, (
        "grad_comm { mode: quantized buckets: 2 }\n"
        "kernels { grad_allreduce: q8_hier }\n"
        'ring { intra_axis: "model" inter_axis: "data" }\n'), 4).replace(
        "neuralnet {", "neuralnet {\n  partition_type: kLayerPartition")
    with pytest.raises(ConfigError, match="q8_hier } with a ring { "
                       "intra_axis/inter_axis } block across 2 processes "
                       "is not ported"):
        Trainer(t_parse(text), mesh=mesh, log=lambda s: None)
