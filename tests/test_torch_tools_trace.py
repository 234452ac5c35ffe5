"""The port's trace tool and the records it reads, against the JAX
package on the CPU: the Trainer's feeder, stager, ``kernel_select`` and
``comm`` records (the same ``(kind, name, track)`` set as the JAX
Trainer's log of the same job), and ``singa_tpu_torch.tools.trace``
giving the JAX tool's merged Chrome trace and ``--summarize`` dict on
the same logs: written by the JAX recorder, by a two-process port run
through ``main``, and by a fleet. Also the JAX tool's own trace tests
(tests/test_telemetry.py) on the port's tool: two ranks, a torn tail, a
missing directory, a real run.
"""

import json
import os
import sys

import pytest

from singa_tpu.config import parse_model_config as j_parse
from singa_tpu.obs.recorder import FlightRecorder as JRecorder
from singa_tpu.parallel import build_mesh as j_mesh
from singa_tpu.tools import input_stall as j_input
from singa_tpu.tools import trace as j_trace
from singa_tpu.trainer import Trainer as JTrainer
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.data import loader as t_loader
from singa_tpu_torch.obs import FlightRecorder
from singa_tpu_torch.parallel import build_mesh as t_mesh
from singa_tpu_torch.tools import trace as t_trace
from singa_tpu_torch.trainer import Trainer
from test_torch_launch import one_torch_thread, run_processes  # noqa: F401

#: the streaming MLP with the quantized, bucketed gradient collective
GRAD_COMM = "grad_comm { mode: quantized buckets: 4 }"
STEPS = 8


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("trace") / "shard")
    t_loader.write_records(path, *t_loader.synthetic_arrays(256, seed=3))
    return path


def conf_text(shard, batch=16) -> str:
    return (j_input._CONF.format(shard=shard, batch=batch, hidden=32,
                                 head=10)
            + "\n" + GRAD_COMM + "\n")


def _cfg(parse, shard):
    cfg = parse(conf_text(shard))
    cfg.train_steps = STEPS
    cfg.display_frequency = 4
    return cfg


def jax_run(shard, ranks, events, stream):
    import jax

    rec = JRecorder(events, rank=0, run_id="r", log=lambda s: None)
    tr = JTrainer(_cfg(j_parse, shard), seed=0, log=lambda s: None,
                  mesh=j_mesh(ranks, 1, jax.devices()[:ranks]),
                  prefetch=True, device_cache=False, stream_chunks=stream)
    tr.attach_telemetry(rec)
    tr.run()
    rec.close()
    return tr


def port_run(shard, ranks, events, stream):
    rec = FlightRecorder(events, rank=0, run_id="r", log=lambda s: None)
    tr = Trainer(_cfg(t_parse, shard), seed=0, log=lambda s: None,
                 mesh=t_mesh(ranks, 1, ["cpu"] * ranks), prefetch=True,
                 device_cache=False, stream_chunks=stream)
    tr.attach_telemetry(rec)
    tr.run()
    rec.close()
    return tr


def triples(events) -> set:
    recs, skipped = t_trace.load_events(events)
    assert skipped == 0
    return {(r["kind"], r.get("name"), r.get("track")) for r in recs}


# one rank streams in both packages (the stager); two ranks step the
# port's per-rank loop eagerly, which takes the per-step feeder, so the
# JAX Trainer is held to the same feeder there (stream_chunks off)
@pytest.mark.parametrize("ranks,stream,feeder", [
    (1, True, ("span", "stage_block", "stager")),
    (2, False, ("span", "assemble_batch", "feeder")),
])
def test_trainer_records_match_jax(shard, tmp_path, ranks, stream, feeder):
    """The streaming grad_comm job through both Trainers with telemetry
    on: the same (kind, name, track) set, the feeder or stager span, the
    grad_allreduce kernel_select event with the JAX payload and the comm
    probe's span and event among them."""
    jt = jax_run(shard, ranks, str(tmp_path / "jax"), stream)
    tt = port_run(shard, ranks, str(tmp_path / "port"), stream)
    assert tt.feeder_mode == jt.feeder_mode == (
        "stream" if stream else "prefetch")
    got, want = triples(str(tmp_path / "port")), triples(str(tmp_path / "jax"))
    assert got == want
    for rec in (feeder, ("kernel_select", None, None),
                ("span", "comm", "phases"), ("comm_probe", None, None)):
        assert rec in got, rec
    recs = {pkg: t_trace.load_events(str(tmp_path / pkg))[0]
            for pkg in ("jax", "port")}
    sel = {pkg: next(r["data"] for r in rs if r["kind"] == "kernel_select")
           for pkg, rs in recs.items()}
    assert sel["port"] == sel["jax"]
    probe = {pkg: next(r["data"] for r in rs if r["kind"] == "comm_probe")
             for pkg, rs in recs.items()}
    # the port's event also says what the probe launched and sent
    assert set(probe["port"]) == set(probe["jax"]) | {"launches",
                                                      "sent_bytes"}
    for key in ("mode", "dtype", "buckets", "rounds"):
        assert probe["port"][key] == probe["jax"][key], key
    assert probe["port"]["comm_ms"] > 0


def test_comm_probe_counts_what_it_sends(shard, tmp_path):
    """The probe on the int8 ring sends what its rounds send (a warm
    chain and a timed one, each round one ring reduction of the model's
    bytes a rank) and launches quant_acc only on the card (the CPU takes
    the plain version): the process counters count it, and the trainer
    and the comm_probe event say how much of them is the probe's."""
    from singa_tpu_torch.ops import quantized_collective as qc
    from singa_tpu_torch.tools.collective_stall import record_comm_probe

    cfg = t_parse(conf_text(shard)
                  + "kernels { grad_allreduce: quantized_ring }\n")
    tr = Trainer(cfg, seed=0, log=lambda s: None,
                 mesh=t_mesh(2, 1, ["cpu"] * 2), device_cache=False)
    rec = FlightRecorder(str(tmp_path / "ev"), rank=0, run_id="r",
                         log=lambda s: None)
    tr.attach_telemetry(rec)
    qc.ppermute.sent_bytes.clear()
    qc.ppermute.sent_bytes[("data", 0)] = 7
    launches = qc.quant_acc.launches
    assert record_comm_probe(tr, rounds=2) > 0
    rec.close()
    sent = 2 * 2 * 2 * tr.wire_bytes_model()["quantized_ring"]
    assert sum(qc.ppermute.sent_bytes.values()) == 7 + sent
    assert qc.quant_acc.launches == launches
    assert tr.comm_probe_counts["ring_sent_bytes"] == sent
    assert tr.comm_probe_counts["quant_acc_launches"] == 0
    ev = next(r["data"] for r in t_trace.load_events(str(tmp_path / "ev"))[0]
              if r["kind"] == "comm_probe")
    assert (ev["launches"], ev["sent_bytes"]) == (0, sent)
    assert "comm" in tr.timers.phases()


def test_records_absent_without_telemetry(shard, tmp_path):
    """No recorder: no probe runs (the comm phase never times) and the
    feeder and stager record nothing."""
    tr = Trainer(_cfg(t_parse, shard), seed=0, log=lambda s: None,
                 device="cpu", prefetch=True, device_cache=False)
    tr.run()
    assert tr.feeder_mode == "stream"
    assert "comm" not in tr.timers.phases()
    assert not tr._comm_probe_done


# ---------------------------------------------------------------------------
# the merge and the summary: the port's tool gives the JAX tool's output
# ---------------------------------------------------------------------------


def both_tools(path, tmp_path) -> dict:
    """Both tools' merge (through main, loaded back) and summary of the
    logs under ``path``; asserts they are equal and returns the port's."""
    out = {}
    for name, tool in (("jax", j_trace), ("port", t_trace)):
        dest = str(tmp_path / f"{name}_trace.json")
        assert tool.main([path, "-o", dest]) == 0
        with open(dest) as f:
            out[name] = {"trace": json.load(f),
                         "summary": tool.summarize(tool.load_events(path)[0])}
    assert out["port"]["trace"] == out["jax"]["trace"]
    assert out["port"]["summary"] == out["jax"]["summary"]
    return out["port"]


def test_trace_same_on_jax_written_logs(shard, tmp_path):
    jax_run(shard, 1, str(tmp_path / "ws" / "events"), True)
    got = both_tools(str(tmp_path / "ws"), tmp_path)
    names = {e["name"] for e in got["trace"]["traceEvents"]}
    assert {"stage_block", "comm", "kernel_select", "train"} <= names
    s = got["summary"]
    assert s["grad_wire_impl"] == "reference"
    assert s["comm_ms_per_step"] is not None
    assert s["stall_shares"]["comm"] > 0


def test_trace_same_on_two_process_port_run(shard, tmp_path, monkeypatch):
    """Two OS processes through the port's ``main`` on the CPU, each its
    own rank of a 2-wide data mesh, the dataset streamed (no device
    cache), telemetry on (a workspace): every process's log, its feeder
    spans and the comm probe merge to the JAX tool's output."""
    monkeypatch.setenv("SINGA_TPU_DEVICE_CACHE_MB", "0")
    conf = tmp_path / "job.conf"
    conf.write_text(conf_text(shard).replace(
        "train_steps: 1000000", f"train_steps: {STEPS}\ndisplay_frequency: 4"))
    cluster = tmp_path / "cluster.conf"
    ws = tmp_path / "ws"
    cluster.write_text(f'nworkers: 2\nworkspace: "{ws}"\n')
    outs = run_processes(tmp_path, lambda k, hf: [
        sys.executable, "-m", "singa_tpu_torch.main",
        "-model_conf", str(conf), "-cluster_conf", str(cluster),
        "-procsID", str(k), "-hostfile", hf, "-device", "cpu"], n=2,
        name="trace")
    for rc, out in outs:
        assert rc == 0, out
    got = both_tools(str(ws), tmp_path)
    evs = got["trace"]["traceEvents"]
    spans = {(e["pid"], e["name"]) for e in evs if e["ph"] == "X"}
    for pid in (0, 1):
        for name in ("assemble_batch", "comm", "train", "data"):
            assert (pid, name) in spans, (pid, name)
    assert got["summary"]["ranks"].keys() == {"0", "1"}
    assert got["summary"]["grad_wire_impl"] == "reference"


def fleet_records() -> list:
    """A fleet incident's log: two hosts' roles, admissions, prefix hits,
    cache fetches and ships, a migration, the wire's sends and retries,
    and a staged rollout with a canary, flips, a rollback and its
    verdict; each record as the port's recorder writes it."""
    recs = []
    t = [1000.0]

    def rec(rank, kind, step=None, **data):
        t[0] += 0.01
        recs.append({"ts": t[0], "mono": t[0], "rank": rank, "run": "f",
                     "step": step, "kind": kind, "data": data})

    def span(rank, name, track, dur, steps=None):
        t[0] += 0.01
        r = {"ts": t[0], "mono": t[0], "rank": rank, "run": "f",
             "step": None, "kind": "span", "name": name, "track": track,
             "dur": dur}
        if steps is not None:
            r["steps"] = steps
        recs.append(r)

    rec(0, "fleet_role", role="prefill")
    rec(1, "fleet_role", role="decode")
    rec(0, "kernel_select", site="serve.paged_attention", impl="fused")
    for i in range(4):
        rec(0, "route", rid=i)
        rec(0, "request_admit", rid=i)
        rec(0, "prefill", rid=i)
        if i % 2:
            rec(0, "prefix_hit", blocks_shared=2, chunks_saved=1)
        rec(0, "migrate_out", blocks=3)
        rec(1, "migrate_in", blocks=3)
        span(1, "decode", "serving", 0.004 + i * 1e-3, steps=8)
        span(1, f"req{i}", "requests", 0.05 + i * 0.01)
        rec(1, "retire", rid=i)
    rec(1, "cache_fetch", blocks=2)
    rec(0, "cache_ship", dir="out", blocks=2, bytes=4096)
    rec(1, "cache_ship", dir="in", blocks=2, bytes=4096)
    rec(1, "partial_hit", tail_tokens=5)
    rec(1, "decode_register")
    rec(0, "spec_draft", drafted=8)
    rec(0, "spec_accept", accepted=5)
    rec(0, "wire_connect", peer="h1")
    for ms in (0.4, 0.7, 2.5):
        rec(0, "wire_send", peer="h1", ms=ms)
    rec(0, "wire_retry", peer="h1")
    rec(0, "wire_redeliver", peer="h1")
    rec(1, "weight_ship", dir="in", ok=True, bytes=1 << 20)
    rec(1, "weight_ship", dir="in", ok=False, bytes=12)
    rec(0, "rollout_stage", version=2)
    rec(0, "rollout_canary", parity=True, probes=4)
    rec(0, "rollout_flip", version=2, tick=9)
    rec(1, "rollout_flip", version=2, tick=10)
    rec(1, "rollout_flip", version=1, tick=12, rollback=True)
    rec(0, "rollout_abort", reason="parity", version=2)
    rec(0, "rollout_done", verdict="rollback", version=1)
    return recs


def test_trace_same_on_fleet_log(tmp_path):
    ev = tmp_path / "events"
    ev.mkdir()
    by_rank: dict = {}
    for r in fleet_records():
        by_rank.setdefault(r["rank"], []).append(r)
    for rank, recs in by_rank.items():
        with open(ev / f"rank_{rank}.jsonl", "w") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
    s = both_tools(str(tmp_path), tmp_path)["summary"]
    assert s["serving"]["hosts"].keys() == {"0", "1"}
    assert s["serving"]["attend_impl"] == "fused"
    assert s["serving"]["fleet_cache"]["ships"] == 1
    assert s["rollout"]["verdict"] == "rollback"
    assert s["rollout"]["rollbacks"] == 1 and s["rollout"]["torn_ships"] == 1
    assert s["wire"]["peers"]["h1"]["sends"] == 3


# ---------------------------------------------------------------------------
# tests/test_telemetry.py's trace tests, on the port's tool
# ---------------------------------------------------------------------------


def _write_rank_log(events_dir, rank, records, torn_tail=False):
    os.makedirs(events_dir, exist_ok=True)
    with open(os.path.join(events_dir, f"rank_{rank}.jsonl"), "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
        if torn_tail:
            f.write('{"ts": 1.0, "kind": "trunc')  # no newline, torn


def test_trace_merge_two_ranks(tmp_path):
    ev = str(tmp_path / "events")
    base = 1000.0
    for rank in (0, 1):
        _write_rank_log(ev, rank, [
            {"ts": base + rank * 0.25, "mono": 1.0, "rank": rank,
             "run": "r", "step": 0, "kind": "run_start",
             "data": {"attempt": 1}},
            {"ts": base + 1.0, "mono": 2.0, "rank": rank, "run": "r",
             "step": 4, "kind": "span", "name": "train",
             "track": "phases", "dur": 0.5, "steps": 4},
            {"ts": base + 2.0 + rank * 0.5, "mono": 3.0, "rank": rank,
             "run": "r", "step": 4, "kind": "step",
             "data": {"steps_per_s": 8.0}},
        ], torn_tail=(rank == 1))
    assert t_trace.main([str(tmp_path), "-o", str(tmp_path / "t.json")]) == 0
    with open(tmp_path / "t.json") as f:
        trace = json.load(f)
    evs = trace["traceEvents"]
    assert {e["pid"] for e in evs} == {0, 1}
    spans = [e for e in evs if e["ph"] == "X"]
    assert len(spans) == 2 and spans[0]["dur"] == pytest.approx(5e5)
    instants = [e for e in evs if e["ph"] == "i"]
    assert {e["name"] for e in instants} == {"run_start", "step"}
    assert min(e["ts"] for e in evs if e["ph"] != "M") == 0.0
    meta = [e for e in evs if e["ph"] == "M" and e["name"] == "process_name"]
    assert {m["args"]["name"] for m in meta} == {"rank 0", "rank 1"}
    summary = t_trace.summarize(t_trace.load_events(str(tmp_path))[0])
    assert summary["step_time_ms"]["p50"] == pytest.approx(125.0)
    assert summary["max_rank_skew_s"] == pytest.approx(0.5)
    assert summary["ranks"] == {"0": 3, "1": 3}


def test_trace_tolerates_torn_tail(tmp_path):
    _write_rank_log(str(tmp_path / "events"), 0, [
        {"ts": 1.0, "mono": 1.0, "rank": 0, "run": "r", "step": 0,
         "kind": "run_start"},
    ], torn_tail=True)
    records, skipped = t_trace.load_events(str(tmp_path))
    assert len(records) == 1 and skipped == 1


def test_trace_missing_dir_errors(tmp_path):
    assert t_trace.main([str(tmp_path / "nope")]) == 2


def test_trace_on_real_run_is_valid_chrome_trace(shard, tmp_path, capsys):
    """A port run's events merge into a Chrome trace every event of which
    has the keys a viewer needs, and the summary prints as JSON."""
    port_run(shard, 1, str(tmp_path / "events"), True)
    assert t_trace.main([str(tmp_path)]) == 0
    with open(tmp_path / "trace.json") as f:
        trace = json.load(f)
    for e in trace["traceEvents"]:
        assert {"name", "ph", "pid", "tid"} <= e.keys()
        if e["ph"] != "M":
            assert e["ts"] >= 0.0
    capsys.readouterr()
    assert t_trace.main([str(tmp_path), "--summarize"]) == 0
    s = json.loads(capsys.readouterr().out)
    assert s["step_time_ms"]["n"] == STEPS
    assert s["stall_shares"]["input"] > 0


def test_trace_is_the_jax_tool(tmp_path):
    """The port's tool is the JAX tool's code (docstrings aside)."""
    from test_torch_port import _body_without_docstring

    assert (_body_without_docstring(t_trace.__file__)
            == _body_without_docstring(j_trace.__file__))
