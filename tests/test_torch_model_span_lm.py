"""A model group that spans OS processes on the LM: kAttention's fused
projection (a Concate, attended once a process over the gathered
heads) and output projection (partial sums), and kDense's Concate, each
across two processes.

tests/test_torch_ring_trainer.py's narrowed LM (d_model 64, 2 heads of
32, d_ff 128, S 32, batch 8, float32) with kLayerPartition on data 1 x
model 2 as 2 processes of one rank each, through the real CLI over gloo
on the CPU: both processes end with the digest of one process holding
the two ranks, bitwise; exact, and through the ``grad_comm`` reference
seam (the q8 cast with error feedback on each param's summed gradient,
after the processes' gather).
"""

import pytest

from test_multiprocess import STEPS
from test_torch_launch import one_torch_thread  # noqa: F401
from test_torch_model_span_trainer import (
    PARTITION, check_span, one_process, span_launch)
from test_torch_ring_trainer import narrow_conf
from test_torch_ring_trainer import shard as tokens  # noqa: F401

CLUSTER = "nworkers: 2\nnprocs_per_group: 2"
COMMS = {"exact": "", "seam": "grad_comm { mode: quantized buckets: 2 }\n"}


@pytest.mark.parametrize("comm", sorted(COMMS))
def test_lm_model_group_over_two_processes_equals_one_process(tmp_path,
                                                              tokens, comm):
    text = narrow_conf(tokens, COMMS[comm]).replace(
        "train_steps: 2000", f"train_steps: {STEPS}").replace(
        "neuralnet {", "neuralnet {\n  " + PARTITION)
    reports = span_launch(tmp_path, text, 2, CLUSTER)
    one = one_process(text, CLUSTER, 1, 2, tmp_path)
    assert one.mesh_shape == {"data": 1, "model": 2}
    assert one._layout["b0_attn/qkv"] == (1, "model")
    assert one._layout["b0_attn/out"] == (0, "model")
    assert (one.comm_mode == "quantized") == (comm == "seam")
    check_span(reports, 2, 1, one.digest())
