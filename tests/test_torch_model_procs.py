"""Whole model groups across OS processes in the port: two processes of
one model group each (data 1 x model 2 a process, a 2 x 2 mesh), through
the real CLI over gloo on the CPU, against one process holding all four
ranks (the JAX package's dp x tp over processes,
tests/test_multiprocess.py:285, which runs there as a slow test).

The kLayerPartition MLP of tests/test_torch_multiprocess.py:

- the Trainer with zero_update and sharded saves: each piece's gradient
  sum, the zero shards and the save cross the processes; both processes
  end with the one-process digest, and the two-process save reads back
  as the one-process arrays;
- the replica engine (Elastic) on 2 replicas of 2 model ranks: the
  protocol rounds gather the replicas' pieces; the same digests;
- test_torch_ring_trainer's narrowed LM with zero_update: every param
  zero-sharded, the model-split ones inside their pieces (each process
  must flatten its exchanges in one key order).
"""

import pytest

from singa_tpu_torch.config import parse_cluster_config as t_cluster
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.parallel import build_mesh
from singa_tpu_torch.trainer import make_trainer
from singa_tpu_torch.trainer import sharded_ckpt as t_sc
from test_multiprocess import STEPS
from test_torch_launch import one_torch_thread  # noqa: F401
from test_torch_multiprocess import (  # noqa: F401
    check_reports, job_text, launch, shard)
from test_torch_multiprocess_zero import SHARDED, arrays, assert_same
from test_torch_ring_trainer import narrow_conf
from test_torch_ring_trainer import shard as tokens  # noqa: F401

PARTITION = 'partition_type: "kLayerPartition"'
ELASTIC = ('param_type: "Elastic" moving_rate: 0.3 sync_frequency: 2 '
           "warmup_steps: 2")
#: engine -> (model conf lines, cluster conf lines)
ENGINES = {
    "trainer": ("zero_update: true\n" + SHARDED, "nprocs_per_group: 2\n"),
    "replica": ("", "nprocs_per_group: 2\nnservers: 1\nbandwidth: 1e9\n"),
    "lm_zero": ("zero_update: true\n", "nprocs_per_group: 2\n"),
}


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_model_groups_across_processes_equal_one_process(tmp_path, shard,
                                                         tokens, engine):
    extra, cluster = ENGINES[engine]
    if engine == "lm_zero":
        text = narrow_conf(tokens, extra).replace(
            "train_steps: 2000", f"train_steps: {STEPS}")
    else:
        text = job_text(shard, extra, 4)
    text = text.replace("neuralnet {", "neuralnet {\n  " + PARTITION)
    if engine == "replica":
        assert 'param_type: "Param"' in text
        text = text.replace('param_type: "Param"', ELASTIC)
    reports, _ = launch(tmp_path, text, 4, extra_cluster=cluster)
    one = make_trainer(
        t_parse(text), t_cluster(f'nworkers: 4\nworkspace: "{tmp_path}/one"'
                                 f"\n{cluster}"),
        mesh=build_mesh(2, 2, ["cpu"] * 4), seed=0, log=lambda s: None)
    assert type(one).__name__ == ("ReplicaTrainer" if engine == "replica"
                                  else "Trainer")
    assert one.mesh_shape == {"data": 2, "model": 2}
    one.run()
    check_reports(reports, 4, one.digest())
    if engine != "replica":
        assert one.update_mode == "zero"
    if engine == "trainer":
        path = str(tmp_path / "ws_job" / "checkpoints" / f"step_{STEPS}.ckpt")
        with t_sc.ShardedCheckpoint(path) as ck:
            assert ck.manifest["nprocs"] == 2
            assert_same({k: ck.assemble(k) for k in ck.keys()}, arrays(one))
