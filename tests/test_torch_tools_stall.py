"""The port's stall gates against the JAX package's on the CPU, at small
``--steps``/``--trials``: each tool's JSON line has exactly the JAX
tool's keys, and the fields that do not depend on a clock are equal at
the same flags (the record and write counts, the optimizer bytes).
Timing verdicts are not asserted here: the CPU's times say nothing of
the card's. ``collective_stall`` and ``attend_stall`` are in
tests/test_torch_tools_collective.py.
"""

import json
import math

import pytest

from singa_tpu.tools import ckpt_stall as j_ckpt
from singa_tpu.tools import input_stall as j_input
from singa_tpu.tools import telemetry_overhead as j_tel
from singa_tpu.tools import update_stall as j_update
from singa_tpu_torch.tools import ckpt_stall as t_ckpt
from singa_tpu_torch.tools import input_stall as t_input
from singa_tpu_torch.tools import telemetry_overhead as t_tel
from singa_tpu_torch.tools import update_stall as t_update
from test_torch_launch import one_torch_thread  # noqa: F401


def json_line(tool, argv, capsys) -> dict:
    """Run ``tool.main(argv)`` and parse the JSON line it prints last
    (the exit code is the timing verdict, not asserted)."""
    capsys.readouterr()
    tool.main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


def both(jtool, ttool, argv, capsys) -> tuple[dict, dict]:
    j = json_line(jtool, argv, capsys)
    t = json_line(ttool, argv + ["--device", "cpu"], capsys)
    assert list(t) == list(j)
    return j, t


def test_telemetry_overhead_counts_match_jax(capsys):
    """On against off: the recorder's file opens equal the cadence
    flushes (never the steps) in both packages, and both record the same
    number of records."""
    argv = ["--steps", "10", "--warmup", "2", "--trials", "2",
            "--display", "5", "--batch", "64", "--hidden", "16"]
    j, t = both(j_tel, t_tel, argv, capsys)
    # two windows of 10 steps, a flush every 5 steps
    assert t["writes"] == j["writes"] == 4
    assert t["events"] == j["events"]
    assert t["off_step_ms"] > 0 and t["on_step_ms"] > 0


def test_ckpt_stall_keys_match_jax(capsys):
    argv = ["--steps", "3", "--warmup", "2", "--trials", "1",
            "--batch", "64", "--hidden", "16"]
    j, t = both(j_ckpt, t_ckpt, argv, capsys)
    for k in ("nockpt_step_ms", "async_step_ms", "sync_step_ms"):
        assert t[k] > 0
    assert t["threshold"] == j["threshold"] == 1.25


def test_input_stall_keys_match_jax(capsys, monkeypatch):
    # both tools set SINGA_TPU_CHUNK (default 16) for their process:
    # set it here so that the test's teardown takes it away again
    monkeypatch.setenv("SINGA_TPU_CHUNK", "16")
    argv = ["--steps", "8", "--warmup", "2", "--trials", "1",
            "--batch", "32", "--hidden", "16", "--records", "256"]
    j, t = both(j_input, t_input, argv, capsys)
    for k in ("sync_step_ms", "prefetch_step_ms", "stream_step_ms"):
        assert t[k] > 0
    assert t["threshold"] == j["threshold"] == 1.0


def test_update_stall_opt_bytes_match_jax(capsys):
    """The zero update's per-rank optimizer bytes: the same halving on a
    2-wide data mesh in both packages."""
    argv = ["--steps", "2", "--warmup", "1", "--trials", "1",
            "--batch", "64", "--hidden", "32", "--records", "256"]
    j, t = both(j_update, t_update, argv, capsys)
    for k in ("opt_bytes_replicated", "opt_bytes_zero", "opt_bytes_ratio",
              "ndata", "threshold"):
        assert t[k] == j[k], k
    assert t["opt_bytes_zero"] < t["opt_bytes_replicated"]


@pytest.mark.parametrize("zero", [False, True])
def test_measure_update_ms_positive(zero, tmp_path):
    from singa_tpu_torch.data.loader import synthetic_arrays, write_records

    shard = str(tmp_path / "shard")
    write_records(shard, *synthetic_arrays(128, seed=0))
    tr, _ = t_update._make_runner(shard, 64, 32, 1, zero, 2, device="cpu")
    ms = t_update.measure_update_ms(tr, i1=1, i2=4, trials=2)
    assert math.isfinite(ms) and ms > 0
