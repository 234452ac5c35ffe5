"""A model group that spans OS processes under zero_update, with a
sharded save: the model axis's pieces and the zero chunks of one group
on two processes.

tests/test_torch_multiprocess.py's MLP (a 12-output head) with
kLayerPartition, ``zero_update`` and ``checkpoint_format: "sharded"``
on data 1 x model 4 as 2 processes of 2 ranks each, through the real
CLI over gloo on the CPU: each model group is partly local, partly
remote. Both processes end with the digest of one process holding the
four ranks, bitwise. The 2-process save's manifest says 2 processes,
its writers are the ranks at index 0 on every axis that does not cut a
box, it assembles to the one-process run's arrays, and it restores on
one process, on the same layout and on data 2 x model 2, bitwise.
"""

import json
import os

import numpy as np

from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.parallel import build_mesh
from singa_tpu_torch.trainer import Trainer
from singa_tpu_torch.trainer import sharded_ckpt as t_sc
from test_multiprocess import STEPS
from test_torch_launch import one_torch_thread  # noqa: F401
from test_torch_model_span_trainer import (
    PARTITION, check_span, one_process, span_launch)
from test_torch_multiprocess import job_text, shard  # noqa: F401
from test_torch_multiprocess_zero import SHARDED, arrays, assert_same

CLUSTER = "nworkers: 4\nnprocs_per_group: 4"


def test_zero_and_a_sharded_save_of_a_group_over_two_processes(tmp_path,
                                                               shard):
    text = job_text(shard, "zero_update: true\n" + SHARDED, 4).replace(
        "neuralnet {", "neuralnet {\n  " + PARTITION)
    reports = span_launch(tmp_path, text, 2, CLUSTER)
    one = one_process(text, CLUSTER, 1, 4, tmp_path)
    assert one.update_mode == "zero"
    assert one.mesh_shape == {"data": 1, "model": 4}
    check_span(reports, 2, 2, one.digest())
    path = str(tmp_path / "ws_span" / "checkpoints" / f"step_{STEPS}.ckpt")
    with open(os.path.join(path, "manifest.json")) as f:
        assert json.load(f)["nprocs"] == 2
    want = arrays(one)
    with t_sc.ShardedCheckpoint(path) as ck:
        assert_same({k: ck.assemble(k) for k in ck.keys()}, want)
    # fc1's weight is cut over the model axis: each process wrote its
    # own ranks' boxes
    for k, ranks in ((0, {0, 1}), (1, {2, 3})):
        with np.load(os.path.join(path, f"proc_{k}.npz")) as z:
            assert {int(e.split("##")[1]) for e in z.files
                    if e.startswith("p|fc1/w##")} == ranks
    for nd, nm in ((1, 4), (2, 2)):
        cfg = t_parse(text)
        cfg.checkpoint = path
        back = Trainer(cfg, mesh=build_mesh(nd, nm, ["cpu"] * 4), seed=7,
                       log=lambda s: None)
        assert back.start_step == STEPS
        assert_same(arrays(back), want)
