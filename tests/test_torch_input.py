"""The port's double-buffered input (``data/device_prefetch.py``): the
device feeder and the chunk stager must be invisible to training.

Mirrors tests/test_input.py for ``singa_tpu_torch``, on the CPU: every
run through a feeder is bitwise the synchronous path's (same batches,
same wraparound stream positions, same checkpointed resume points), an
error on the feeder thread surfaces on the step path, and a reset
discards the read-ahead so the streams can be re-seeked exactly.
"""

import time

import numpy as np
import pytest
import torch

from singa_tpu_torch.config import parse_cluster_config
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.data.device_prefetch import (
    ChunkStager,
    DeviceFeeder,
    InputFeedError,
    ready,
    to_device,
)
from singa_tpu_torch.data.loader import synthetic_arrays, write_records
from singa_tpu_torch.trainer import Trainer
from test_torch_chunk import _conf, assert_same_training_state


@pytest.fixture
def shard(tmp_path):
    path = str(tmp_path / "shard")
    # 40 records with batch 16 -> wraparound inside every window
    write_records(path, *synthetic_arrays(40, seed=2))
    return path


def _mk(shard, *, prefetch, stream_chunks=None, extra="", seed=3, cl=None,
        log=None, graphs=None):
    return Trainer(
        t_parse(_conf(shard, extra)), cl, seed=seed,
        log=log or (lambda s: None), device="cpu", prefetch=prefetch,
        device_cache=False, stream_chunks=stream_chunks, graphs=graphs,
    )


# ---------------------------------------------------------------------------
# mode selection
# ---------------------------------------------------------------------------


def test_feeder_mode_selection(shard, monkeypatch):
    assert _mk(shard, prefetch=False).feeder_mode == "sync"
    assert _mk(shard, prefetch=True).feeder_mode == "stream"
    assert _mk(shard, prefetch=True,
               stream_chunks=False).feeder_mode == "prefetch"
    cached = Trainer(t_parse(_conf(shard)), seed=3, log=lambda s: None,
                     device="cpu", prefetch=True, device_cache=True)
    assert cached.feeder_mode == "cached"
    # an eager step takes one batch a call: streaming degrades to the
    # per-step feeder, as does SINGA_TPU_CHUNK=1 and the env switch
    assert _mk(shard, prefetch=True,
               graphs=False).feeder_mode == "prefetch"
    monkeypatch.setenv("SINGA_TPU_CHUNK", "1")
    assert _mk(shard, prefetch=True).feeder_mode == "prefetch"
    monkeypatch.setenv("SINGA_TPU_CHUNK", "64")
    monkeypatch.setenv("SINGA_TPU_STREAM_CHUNK", "0")
    assert _mk(shard, prefetch=True).feeder_mode == "prefetch"


# ---------------------------------------------------------------------------
# device feeder (per-step prefetch)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("graphs", [None, False])
def test_device_prefetch_bitwise_matches_sync(shard, graphs):
    """Per-step training through the device feeder == the synchronous
    path, graphed or eager: params bitwise, the same consumed stream
    positions (the feeder read ahead)."""
    a = _mk(shard, prefetch=False, graphs=graphs)
    b = _mk(shard, prefetch=True, stream_chunks=False, graphs=graphs)
    assert b.feeder_mode == "prefetch"
    for step in range(8):
        a.train_one_batch(step)
        b.train_one_batch(step)
    assert_same_training_state(a, b)
    # the feeder thread stages the next batch after the last step's
    # swap; wait (bounded) for it to have read ahead
    pipe = b._pipelines[id(b.train_net)]["data"]
    deadline = time.monotonic() + 30
    while (pipe.position == b._stream_positions()["kTrain|data"]
           and time.monotonic() < deadline):
        time.sleep(0.01)
    assert pipe.position != b._stream_positions()["kTrain|data"]
    b._reset_feeders()


def test_feeder_reset_and_resume_are_exact(shard):
    """Reset discards the read-ahead; re-seeking the pipelines to the
    consumed positions resumes the stream exactly."""
    a = _mk(shard, prefetch=False)
    b = _mk(shard, prefetch=True, stream_chunks=False)
    for step in range(3):
        b.train_one_batch(step)
    consumed = b._stream_positions()
    b._reset_feeders()
    assert b._feeder_positions == {}
    for name, pipe in b._pipelines[id(b.train_net)].items():
        pipe.seek(consumed[f"kTrain|{name}"])
    for step in range(3, 8):
        b.train_one_batch(step)
    for step in range(8):
        a.train_one_batch(step)
    assert_same_training_state(a, b)
    b._reset_feeders()


def test_feeder_error_surfaces_and_never_wedges():
    calls = []

    def boom():
        calls.append(1)
        raise ValueError("disk gone")

    feeder = DeviceFeeder(boom, dict)
    with pytest.raises(InputFeedError, match="disk gone"):
        feeder.next()
    # a retry after the error restarts production and fails loudly
    # again: it must never block on the dead thread's empty queue
    with pytest.raises(InputFeedError, match="disk gone"):
        feeder.next()
    assert len(calls) == 2


def test_host_arrays_on_the_cpu_pass_as_they_are():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = to_device(a, torch.device("cpu"))
    assert ready(t) is t and t.data_ptr() == a.ctypes.data


# ---------------------------------------------------------------------------
# chunk stager
# ---------------------------------------------------------------------------


def test_chunk_stager_blocks_and_reset():
    images = np.arange(10, dtype=np.float32)[:, None]
    labels = np.arange(10, dtype=np.int32)
    # a pure function of step, like the trainer's window schedule (the
    # stager's thread evaluates it ahead of the consumer)
    stager = ChunkStager(
        {"d": (images, labels, 4)},
        batches_per_step=1,
        schedule=lambda step: {0: 2, 2: 3, 5: 2, 7: 3}.get(step, 1),
        cursors=lambda: {"d": 6},
        put=lambda a, name, kind: a,
    )
    block, pos = stager.take(0, 2)
    # 2 steps x batch 4 from record 6, wrapping at 10
    np.testing.assert_array_equal(
        block["d"]["image"][:, 0], [6, 7, 8, 9, 0, 1, 2, 3])
    assert pos == {"d": 4}
    block, pos = stager.take(2, 3)
    np.testing.assert_array_equal(
        block["d"]["image"][:, 0], [4, 5, 6, 7, 8, 9, 0, 1, 2, 3, 4, 5])
    assert pos == {"d": 6}
    # a schedule mismatch is loud, not silently wrong records
    with pytest.raises(InputFeedError, match="schedule"):
        stager.take(99, 1)
    # reset discards read-ahead; the next take restarts from cursors()
    stager.reset()
    block, pos = stager.take(0, 2)
    np.testing.assert_array_equal(
        block["d"]["image"][:, 0], [6, 7, 8, 9, 0, 1, 2, 3])
    stager.reset()


# ---------------------------------------------------------------------------
# streaming chunks
# ---------------------------------------------------------------------------


def test_stream_chunk_run_bitwise_matches_stepwise(shard, monkeypatch):
    """A whole streaming run() (chunks over staged blocks copied into the
    static block) is bitwise the per-step synchronous run()."""
    a = _mk(shard, prefetch=False, seed=1)
    b = _mk(shard, prefetch=True, seed=1)
    assert not b._can_chunk()  # not device-cached ...
    assert b.feeder_mode == "stream"  # ... yet it chunks anyway
    chunks = []
    orig = Trainer.train_chunk

    def spy(self, step0, nsteps):
        chunks.append((step0, nsteps))
        return orig(self, step0, nsteps)

    monkeypatch.setattr(Trainer, "train_chunk", spy)
    a.run()
    b.run()
    assert chunks == [(0, 12)]
    assert_same_training_state(a, b)
    # the static block holds one window of the cap: 64 steps x 16
    assert b._g.sources["data"][0]["image"].shape[0] == 64 * 16
    assert b._g.sources["data"][0]["image"].dtype == torch.uint8


def test_stream_chunk_respects_cadences(shard):
    """Cadence events fire at their exact steps (windows cut at display
    and test boundaries, length-1 windows stay on the stager's
    schedule), and the result stays bitwise the synchronous run's."""
    extra = "test_steps: 1\ntest_frequency: 5\ndisplay_frequency: 4\n"
    logs_a, logs_b = [], []
    a = _mk(shard, prefetch=False, extra=extra, log=logs_a.append)
    b = _mk(shard, prefetch=True, extra=extra, log=logs_b.append)
    a.run()
    b.run()
    assert_same_training_state(a, b)
    for logs in (logs_a, logs_b):
        assert len([l for l in logs if ": train " in l]) == 3  # 0, 4, 8
        assert len([l for l in logs if ": test " in l]) == 3  # 0, 5, 10


def test_stream_resume_is_exact(shard, tmp_path):
    """Streaming run -> mid-run checkpoint -> a fresh streaming trainer
    resumes it: the stream position restores exactly, and the final
    params equal the uninterrupted run's bitwise."""
    cl1 = parse_cluster_config(f'nworkers: 1 workspace: "{tmp_path}/ws1"')
    a = _mk(shard, prefetch=True, extra="checkpoint_frequency: 5", seed=2,
            cl=cl1)
    assert a.feeder_mode == "stream"
    a.run()
    extra = (f'checkpoint: "{tmp_path}/ws1/checkpoints/step_5.npz"\n'
             "checkpoint_frequency: 5")
    cl2 = parse_cluster_config(f'nworkers: 1 workspace: "{tmp_path}/ws2"')
    b = _mk(shard, prefetch=True, extra=extra, seed=2, cl=cl2)
    assert b.start_step == 5
    # the resumed stream starts at the checkpoint's consumed position
    assert b._stream_positions() == {"kTrain|data": (5 * 16) % 40}
    b.run()
    assert_same_training_state(a, b)
