"""The port's operator tools that start processes, on the CPU:
``cluster`` (start, ps and stop of real local processes) and
``elastic_launch`` (a crashed gang relaunched to the uninterrupted run's
digest). ``sweep`` is in ``test_torch_tools_sweep.py``, which shares
this file's job and fixtures.
"""

import json
import time

import pytest

from singa_tpu_torch.data import loader as t_loader
from singa_tpu_torch.tools import cluster as t_cluster
from singa_tpu_torch.tools import elastic_launch as t_elastic
from test_torch_launch import CHILD_ENV, free_port
from test_torch_launch import one_torch_thread  # noqa: F401

#: a small job for the tools that start processes
JOB = """
name: "cluster-tool-test"
train_steps: {steps}
checkpoint_frequency: {ckpt}
updater {{ base_learning_rate: 0.1 param_type: "Param" }}
neuralnet {{
  layer {{ name: "data" type: "kShardData"
          data_param {{ path: "{shard}" batchsize: 16 }} }}
  layer {{ name: "mnist" type: "kMnistImage" srclayers: "data"
          mnist_param {{ norm_a: 255 norm_b: 0 }} }}
  layer {{ name: "label" type: "kLabel" srclayers: "data" }}
  layer {{ name: "fc" type: "kInnerProduct" srclayers: "mnist"
          inner_product_param {{ num_output: 10 }}
          param {{ name: "w" init_method: "kUniformSqrtFanIn" }}
          param {{ name: "b" init_method: "kConstant" value: 0 }} }}
  layer {{ name: "loss" type: "kSoftmaxLoss" srclayers: "fc" srclayers: "label"
          softmaxloss_param {{ topk: 1 }} }}
}}
"""


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("procs") / "shard")
    t_loader.write_records(path, *t_loader.synthetic_arrays(64, seed=7))
    return path


@pytest.fixture
def children(monkeypatch):
    """Child processes import this checkout on one intra-op thread."""
    for k, v in CHILD_ENV.items():
        monkeypatch.setenv(k, v)


def test_cluster_start_ps_stop_local(shard, tmp_path, monkeypatch,
                                     children):
    """`cluster start` launches one port process per hostfile line, `ps`
    reads the pid files, the job trains to its end in both processes,
    and `stop` clears the records."""
    conf = tmp_path / "job.conf"
    conf.write_text(JOB.format(steps=4, ckpt=0, shard=shard))
    hostfile = tmp_path / "hostfile"
    hostfile.write_text(f"127.0.0.1:{free_port()}\n127.0.0.1\n")
    ws = tmp_path / "ws"
    cluster = tmp_path / "cluster.conf"
    cluster.write_text(f'nworkers: 2\nworkspace: "{tmp_path / "run"}"\n')
    monkeypatch.chdir(tmp_path)
    rc = t_cluster.main([
        "start", "-n", "2", "-hostfile", str(hostfile),
        "-model_conf", str(conf), "-cluster_conf", str(cluster),
        "-workspace", str(ws), "-device", "cpu",
    ])
    try:
        assert rc == 0
        pids = t_cluster._pids(str(ws))
        assert sorted(pids) == [0, 1]
        deadline = time.time() + 120
        while time.time() < deadline and any(
            t_cluster._alive(pid) for _, pid in pids.values()
        ):
            time.sleep(0.5)
        for rank in (0, 1):
            log = (ws / "procs" / f"rank{rank}.log").read_text()
            assert "TRAIN PROCESS: " in log, log
            report = json.loads(log.split("TRAIN PROCESS: ")[1]
                                .splitlines()[0])
            assert report["proc"] == rank and report["nprocs"] == 2
            assert report["steps"] == 4
        assert t_cluster.main(["ps", "-hostfile", str(hostfile),
                               "-workspace", str(ws)]) == 0
    finally:
        t_cluster.main(["stop", "-hostfile", str(hostfile),
                        "-workspace", str(ws)])
    assert t_cluster._pids(str(ws)) == {}


def digests(text: str) -> list:
    return [json.loads(line.split("TRAIN PROCESS: ")[1])["digest"]
            for line in text.splitlines() if "TRAIN PROCESS: " in line]


def test_elastic_launch_relaunches_a_crashed_gang(shard, tmp_path,
                                                  monkeypatch, capfd,
                                                  children):
    """A 2-process gang whose processes crash at step 3 exits resumable
    (75); the launcher relaunches it (its first attempt alone carries the
    fault plan) from the step-2 save, and it ends with the params and
    slots of a gang that never crashed."""
    conf = tmp_path / "job.conf"
    conf.write_text(JOB.format(steps=6, ckpt=2, shard=shard)
                    + '\ncheckpoint_format: "sharded"\n')
    runs = {}
    once = t_elastic.run_gang_once

    def first_attempt_faulted(args, nprocs, *, log=print):
        codes = once(args, nprocs, log=log)
        args.faults = None
        return codes

    monkeypatch.setattr(t_elastic, "run_gang_once", first_attempt_faulted)
    for name, faults in (("clean", []), ("crashed", ["-faults", "crash@3"])):
        cluster = tmp_path / f"{name}.conf"
        cluster.write_text(f'nworkers: 2\nworkspace: "{tmp_path / name}"\n')
        capfd.readouterr()
        rc = t_elastic.main(["-model_conf", str(conf), "-cluster_conf",
                             str(cluster), "-nprocs", "2", "-device", "cpu"]
                            + faults)
        out = capfd.readouterr()
        runs[name] = (rc, out.out + out.err)
    assert runs["clean"][0] == 0, runs["clean"][1]
    assert runs["crashed"][0] == 0, runs["crashed"][1]
    text = runs["crashed"][1]
    assert "launcher: gang of 2 exited [75, 75]" in text, text
    assert "relaunching" in text, text
    want = digests(runs["clean"][1])
    assert len(want) == 2 and want[0] == want[1]
    assert digests(text) == want
