"""The replica engine across OS processes: the port's counterpart of the
JAX package's tests/test_multiprocess.py:163-225. Each process is one
worker group holding one replica, the reference's own deployment
(worker groups as processes syncing through the server,
src/worker/worker.cc:50-55): two processes through the real CLI
(``python -m singa_tpu_torch.main -procsID k -hostfile hf -device
cpu``, gloo) on tests/test_multiprocess.py's MLP job with the protocol
swapped in, ``nservers: 1`` on an asynchronous cluster, ``bandwidth:
1e9`` pinning RandomSync's ratio at 1.

Oracle: the port's one-process ReplicaTrainer over the same 2 ranks.
Both processes end with its replicas, slots, center and snapshots to the
bit (``ReplicaTrainer.digest``), and process 0's save (npz, or the
sharded format's proc files with its sidecar and commit marker) holds
its arrays.
"""

import json
import os
import sys

import numpy as np
import pytest

from singa_tpu_torch.config import parse_cluster_config as t_cluster
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.data import loader as t_loader
from singa_tpu_torch.parallel import build_mesh
from singa_tpu_torch.resilience import retention
from singa_tpu_torch.trainer import ReplicaTrainer
from test_multiprocess import STEPS, _conf_text
from test_torch_launch import one_torch_thread, run_processes  # noqa: F401


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("replica_procs") / "shard")
    t_loader.write_records(path, *t_loader.synthetic_arrays(128, seed=5))
    return path


def job(shard, protocol, fmt):
    moving = "0.3" if protocol == "Elastic" else "0.0"
    txt = _conf_text(shard)
    assert 'param_type: "Param"' in txt
    txt = txt.replace('param_type: "Param"',
                      f'param_type: "{protocol}" moving_rate: {moving} '
                      "sync_frequency: 2 warmup_steps: 2")
    if fmt == "sharded":
        txt += 'checkpoint_format: "sharded"\n'
    return txt


def cluster(workspace):
    return ("nworkers: 2\nnprocs_per_group: 1\nnservers: 1\n"
            f'bandwidth: 1e9\nworkspace: "{workspace}"\n')


def saved(path) -> dict:
    """The arrays of a save and its sidecar, by their npz keys."""
    from singa_tpu_torch.trainer.sharded_ckpt import ShardedCheckpoint

    if os.path.isdir(path):
        with ShardedCheckpoint(path) as ck:
            out = {k: ck.assemble(k) for k in ck.keys()}
    else:
        with np.load(path) as z:
            out = {k: z[k] for k in z.files if k[:2] in ("p|", "s|")}
    with np.load(path + ".server") as z:
        out.update({"server " + k: z[k] for k in z.files if k != "__step__"})
    return out


@pytest.mark.parametrize("protocol,fmt", [("Elastic", "npz"),
                                          ("RandomSync", "sharded")])
def test_two_processes_equal_one_bitwise(tmp_path, shard, protocol, fmt):
    text = job(shard, protocol, fmt)
    conf = tmp_path / "job.conf"
    conf.write_text(text)
    ccf = tmp_path / "cluster.conf"
    ccf.write_text(cluster(tmp_path / "ws"))
    out = run_processes(tmp_path, lambda k, hostfile: [
        sys.executable, "-m", "singa_tpu_torch.main", "-model_conf",
        str(conf), "-cluster_conf", str(ccf), "-procsID", str(k),
        "-hostfile", hostfile, "-device", "cpu"], name=protocol)
    reports = []
    for k, (rc, log) in enumerate(out):
        assert rc == 0, f"process {k} exited {rc}:\n{log}"
        line = [ln for ln in log.splitlines()
                if ln.startswith("TRAIN PROCESS: ")]
        assert len(line) == 1, log
        reports.append(json.loads(line[0].split(": ", 1)[1]))

    one = ReplicaTrainer(t_parse(text), t_cluster(cluster(tmp_path / "one")),
                         mesh=build_mesh(2, 1, ["cpu"] * 2), seed=0,
                         log=lambda s: None)
    one.run()
    assert one.sample_ratio == 1.0 and one.center is not None
    for k, rep in enumerate(reports):
        assert (rep["proc"], rep["nprocs"], rep["backend"], rep["device"],
                rep["ranks"], rep["steps"]) == (k, 2, "gloo", "cpu", [k],
                                                 STEPS), rep
        assert rep["digest"] == one.digest(), f"process {k}"

    ext = "ckpt" if fmt == "sharded" else "npz"
    path = str(tmp_path / "ws" / "checkpoints" / f"step_{STEPS}.{ext}")
    ref = str(tmp_path / "one" / "checkpoints" / f"step_{STEPS}.{ext}")
    got, want = saved(path), saved(ref)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert got["p|fc1/w"].shape[0] == 2  # the replica axis
    if fmt == "sharded":
        assert sorted(os.listdir(path)) == [
            "commit_0.json", "commit_1.json", "commit_server.json",
            "manifest.json", "proc_0.npz", "proc_1.npz"]
        assert retention.validate_checkpoint(path)
        assert "server s|__snapshot__|fc1/w" in got
        # the two processes' save resumes in one process, bitwise
        cfg = t_parse(text)
        cfg.checkpoint = path
        back = ReplicaTrainer(cfg, mesh=build_mesh(2, 1, ["cpu"] * 2),
                              seed=0, log=lambda s: None)
        assert back.start_step == STEPS
        assert back.digest() == one.digest()
