"""The port's training telemetry and watchdog on the CPU: the flight
recorder's event log of a supervised run against the JAX package's, the
step path that gains no write, the watchdog's stack dump, the
``profile@K`` trigger's torch.profiler trace, and the modules the port
copies whole (their code the JAX package's, docstrings aside).
"""

import json
import os
import time

import pytest

from singa_tpu.config import parse_model_config as j_parse
from singa_tpu.config.schema import ClusterConfig as JCluster
from singa_tpu.obs import recorder as j_recorder
from singa_tpu.resilience import async_ckpt as j_async
from singa_tpu.resilience import launcher as j_launcher
from singa_tpu.resilience import retention as j_retention
from singa_tpu.resilience import supervisor as j_supervisor
from singa_tpu.resilience import watchdog as j_watchdog
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.config.schema import ClusterConfig
from singa_tpu_torch.data import loader as t_loader
from singa_tpu_torch.obs import FlightRecorder
from singa_tpu_torch.obs import recorder as t_recorder
from singa_tpu_torch.resilience import async_ckpt as t_async
from singa_tpu_torch.resilience import launcher as t_launcher
from singa_tpu_torch.resilience import retention as t_retention
from singa_tpu_torch.resilience import supervisor
from singa_tpu_torch.resilience import watchdog as t_watchdog
from singa_tpu_torch.trainer import Trainer
from test_resilience import MLP_CONF
from test_torch_launch import one_torch_thread  # noqa: F401
from test_torch_port import _body_without_docstring


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("tel")
    out = {"train": str(root / "train"), "test": str(root / "test")}
    t_loader.write_records(out["train"], *t_loader.synthetic_arrays(
        128, seed=1))
    t_loader.write_records(out["test"], *t_loader.synthetic_arrays(
        64, seed=1, noise_seed=2))
    return out


def text(shards, steps=12, ckpt=5, resilience=""):
    return MLP_CONF.format(
        train_shard=shards["train"], test_shard=shards["test"],
        train_steps=steps, checkpoint_frequency=ckpt, resilience=resilience)


def events(ws) -> list:
    with open(os.path.join(ws, "events", "rank_0.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_supervised_crash_events_match_jax(shards, tmp_path):
    """crash@7 with a save every 5 and a display every 4, through each
    package's supervisor: the same lifecycle events, in the same order,
    with the same steps; the port's span names are the JAX package's."""
    kinds = {}
    for pkg, parse, cluster, sup, kw in (
            ("jax", j_parse, JCluster, j_supervisor, {}),
            ("port", t_parse, ClusterConfig, supervisor,
             {"device": "cpu"})):
        cfg = parse(text(shards))
        cfg.display_frequency = 4
        cl = cluster()
        cl.workspace = str(tmp_path / pkg)
        assert sup.run(cfg, cl, seed=0, faults="crash@7",
                       log=lambda s: None, prefetch=False, **kw) == 0
        recs = events(cl.workspace)
        kinds[pkg] = [(r["kind"], r["step"]) for r in recs
                      if r["kind"] != "span"]
        kinds[pkg + "_spans"] = {r["name"] for r in recs
                                 if r["kind"] == "span"}
    assert kinds["port"] == kinds["jax"]
    assert kinds["port_spans"] <= kinds["jax_spans"] | {"eval"}
    assert {"run_start", "fault", "crash", "restart", "ckpt_save",
            "ckpt_latest", "step", "run_stop"} <= {k for k, _ in
                                                   kinds["port"]}


def test_step_path_never_writes(shards, tmp_path):
    """With the recorder attached, six steps write no file (events and
    spans buffer in memory); the first write is an explicit flush."""
    cl = ClusterConfig()
    cl.workspace = str(tmp_path)
    tr = Trainer(t_parse(text(shards, steps=50, ckpt=0)), cl, seed=0,
                 log=lambda s: None, device="cpu", prefetch=False)
    rec = FlightRecorder(os.path.join(tmp_path, "events"), rank=0)
    tr.attach_telemetry(rec)
    for step in range(6):
        tr.train_one_batch(step)
    assert rec.writes == 0 and not os.path.exists(rec.path)
    assert rec.recorded >= 12
    rec.flush()
    assert rec.writes == 1
    names = {r["name"] for r in events(tmp_path) if r["kind"] == "span"}
    assert names == {"data", "train"}


def test_watchdog_dumps_the_train_loop(shards, tmp_path):
    """slowstep@3 past watchdog_timeout: one stack dump, the train loop's
    frame in it, and a watchdog_stall event."""
    cfg = t_parse(text(shards, steps=5, ckpt=0,
                       resilience="watchdog_timeout: 0.3"))
    cl = ClusterConfig()
    cl.workspace = str(tmp_path)
    log = []
    assert supervisor.run(cfg, cl, seed=0, faults="slowstep@3=1.0",
                          log=log.append, device="cpu") == 0
    dump = "\n".join(s for s in log if "WATCHDOG" in s)
    assert "WATCHDOG: step 3" in dump
    assert "trainer.py" in dump and "in run" in dump
    assert [r["step"] for r in events(tmp_path)
            if r["kind"] == "watchdog_stall"] == [3]


def test_profile_trigger_writes_a_chrome_trace(shards, tmp_path):
    """profile@3:steps=2 brackets steps [3, 5) with torch.profiler into
    <workspace>/xprof (the telemetry block's default subfolder)."""
    cfg = t_parse(text(shards, steps=8, ckpt=0))
    cl = ClusterConfig()
    cl.workspace = str(tmp_path)
    assert supervisor.run(cfg, cl, seed=0, faults="profile@3:steps=2",
                          log=lambda s: None, device="cpu") == 0
    with open(tmp_path / "xprof" / "trace_step3.json") as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    recs = events(tmp_path)
    start = next(r for r in recs if r["kind"] == "profile_start")
    stop = next(r for r in recs if r["kind"] == "profile_stop")
    assert (start["step"], start["data"]["stop_at"], stop["step"]) == (
        3, 5, 5)


@pytest.mark.parametrize("orig, copy", [
    (j_watchdog, t_watchdog), (j_launcher, t_launcher),
    (j_async, t_async), (j_retention, t_retention),
    (j_recorder, t_recorder)])
def test_copies_keep_the_originals_code(orig, copy):
    """Only the module docstring differs: carry a JAX fix over."""
    assert _body_without_docstring(copy.__file__) == \
        _body_without_docstring(orig.__file__)


def test_heartbeats_and_done_sentinel(tmp_path):
    """A rank's heartbeat counter advances while it lives; ``mark_done``
    publishes the sentinel peers read as a deliberate exit; a peer whose
    heartbeat never came is declared dead once our own step stalls past
    the deadline."""
    wd = t_watchdog.Watchdog(0.0, log=lambda s: None)
    dead = []
    # no step beats here, so the silent peer 1 is declared dead: record
    # it instead of the default exit (75)
    wd.enable_heartbeats(str(tmp_path), rank=0, nprocs=2, peer_timeout=0.2,
                         on_peer_dead=lambda k, age: dead.append(k))
    wd.start()
    try:
        path = t_watchdog.heartbeat_file(str(tmp_path), 0)
        first = t_watchdog.read_heartbeat_counter(path)
        deadline = time.monotonic() + 10.0  # a loaded host polls late
        while (t_watchdog.read_heartbeat_counter(path) == first
               and time.monotonic() < deadline):
            time.sleep(0.05)
        assert t_watchdog.read_heartbeat_counter(path) > first
        wd.mark_done()
        assert os.path.exists(t_watchdog.done_file(str(tmp_path), 0))
        deadline = time.monotonic() + 10.0
        while not dead and time.monotonic() < deadline:
            time.sleep(0.05)
        assert dead == [1] and wd.dead_peers == {1}
    finally:
        wd.stop()
