"""The replica engine with model lanes that span OS processes: the JAX
package's capstone topology (tests/test_multiprocess.py:227, a slow
test there), worker groups of partitioned workers, each worker an OS
process, the groups reconciling through Elastic (or RandomSync).

tests/test_multiprocess.py's MLP with kLayerPartition under Elastic,
and under RandomSync at ratio 1 (``bandwidth: 1e9``: no process's
warmup timing picks the ratio), on 2 replicas x 2 model ranks as 4
processes of one rank each, through the real CLI over gloo on the CPU:
each replica's lane spans two processes (its layers' Concate crosses
them, its ranks' gradients meet in one gather a step), the protocol
rounds gather every replica. Every process ends with the digest
(replicas, slots, the center and RandomSync's snapshots) of one process
holding the four ranks, bitwise. That one-process run is held to the
JAX replica engine by tests/test_torch_model_axis.py's
``test_replicas_of_model_lanes_match_jax_and_the_data_only_run``.
"""

import pytest

from test_multiprocess import _conf_text
from test_torch_launch import one_torch_thread  # noqa: F401
from test_torch_model_span_trainer import (
    PARTITION, check_span, one_process, span_launch)
from test_torch_multiprocess import shard  # noqa: F401

PROTOCOLS = {
    "Elastic": ('param_type: "Elastic" moving_rate: 0.3 sync_frequency: 2 '
                "warmup_steps: 2"),
    "RandomSync": 'param_type: "RandomSync" sync_frequency: 2 '
                  "warmup_steps: 2",
}
CLUSTER = "nworkers: 4\nnprocs_per_group: 2\nnservers: 1\nbandwidth: 1e9"


@pytest.mark.parametrize("protocol", sorted(PROTOCOLS))
def test_replicas_of_spanning_lanes_equal_one_process(tmp_path, shard,
                                                      protocol):
    text = _conf_text(shard, PARTITION)
    assert 'param_type: "Param"' in text
    text = text.replace('param_type: "Param"', PROTOCOLS[protocol])
    reports = span_launch(tmp_path, text, 4, CLUSTER)
    one = one_process(text, CLUSTER, 2, 2, tmp_path)
    assert type(one).__name__ == "ReplicaTrainer"
    assert one.protocol == protocol and one.sample_ratio == 1.0
    assert one.mesh_shape == {"data": 2, "model": 2}
    assert one.center is not None
    assert (one.snapshot is not None) == (protocol == "RandomSync")
    check_span(reports, 4, 1, one.digest())
