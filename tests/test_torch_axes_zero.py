"""``zero_update`` and ``checkpoint_format: "sharded"`` beside the seq,
expert and pipe axes (singa_tpu_torch/trainer/trainer.py: ``_zero_box``,
``_rank_box`` and ``_save_layout``, whose writers are the ranks at index
0 on every axis that does not cut the box).

Each mesh trains the axes LM 4 steps with zero and with the replicated
update: the losses, params and slots equal to the bit, and the losses
within 1e-4 of the JAX Trainer's single-device run (the pipe cases
too: the JAX staged pipeline is wrong on this image, so the unstaged
run is the reference). A sharded save of the zero run on data 2 x seq 2
and on data 2 x expert 2 restores bitwise on data 4 and on data 1. A
planted fault (every rank's zero box taken at data index 0) must move
the run past the bar 100 times.
"""

import warnings

import numpy as np
import pytest

from singa_tpu_torch.config import parse_cluster_config as t_cluster
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.parallel import build_full_mesh
from singa_tpu_torch.trainer import Trainer
from singa_tpu_torch.trainer import trainer as t_trainer
from test_torch_axes_seq import (
    LOSS_TOL,
    close,
    jax_run,
    lm_text,
    losses_of,
    one_torch_thread,  # noqa: F401 (autouse)
    shard,  # noqa: F401 (fixture)
)
from test_torch_moe_routing import port_on, width_of

ZERO = 'zero_update: true\ncheckpoint_format: "sharded"'
MESHES = {
    "seq": ({"data": 2, "seq": 2}, dict(mode="ring")),
    "expert": ({"data": 2, "expert": 2}, dict(moe="psum")),
    "pipe": ({"data": 4, "pipe": 2}, dict(stages=True)),
}


def texts(shard, kw):
    text = lm_text(shard, **kw)
    return text, text.replace("train_steps: 4", f"train_steps: 4\n{ZERO}")


def arrays(tr) -> dict:
    """A trainer's params and whole slots, logical, by checkpoint key."""
    out = {f"p|{n}": np.asarray(tr._unpad_one(n, v))
           for n, v in tr.params.items()}
    out.update({f"s|{n}|{s}": np.asarray(tr._unpad_one(n, v))
                for n, slots in tr.state.items() for s, v in slots.items()})
    return out


def zero_run(shard, axis, steps=4):
    widths, kw = MESHES[axis]
    text, ztext = texts(shard, kw)
    jl, params = jax_run(text, steps)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rep = port_on(text, widths, params)
        zero = port_on(ztext, widths, params)
    return jl, rep, zero


@pytest.mark.parametrize("axis", list(MESHES))
def test_zero_beside_the_axis_equals_replicated_and_jax(shard, axis):
    jl, rep, zero = zero_run(shard, axis)
    assert zero.update_mode == "zero"
    assert any(d is not None for d in zero._zero_dims.values())
    rl, zl = losses_of(rep, 4), losses_of(zero, 4)
    assert zl == rl
    want, got = arrays(rep), arrays(zero)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    close(zl, jl, LOSS_TOL)


@pytest.fixture(scope="module")
def saves(shard, tmp_path_factory):
    """Sharded saves of the zero run after 2 steps on data 2 x seq 2 and
    data 2 x expert 2 -> {axis: (conf text, path, its arrays)}."""
    out = {}
    for axis in ("seq", "expert"):
        widths, kw = MESHES[axis]
        _, ztext = texts(shard, kw)
        ws = tmp_path_factory.mktemp(f"zero_{axis}")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            tr = Trainer(t_parse(ztext), t_cluster(f'workspace: "{ws}"'),
                         mesh=build_full_mesh(widths,
                                              ["cpu"] * width_of(widths)),
                         seed=0, log=lambda s: None, prefetch=False,
                         device_cache=False)
        losses_of(tr, 2)
        out[axis] = (ztext, tr.save(2), arrays(tr))
    return out


@pytest.mark.parametrize("ndata", [4, 1])
@pytest.mark.parametrize("axis", ["seq", "expert"])
def test_a_sharded_save_restores_bitwise_on_another_mesh(saves, axis,
                                                        ndata):
    text, path, want = saves[axis]
    cfg = t_parse(text)
    cfg.checkpoint = path
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        back = Trainer(cfg, mesh=build_full_mesh({"data": ndata},
                                                 ["cpu"] * ndata),
                       seed=1, log=lambda s: None)
    got = arrays(back)
    assert got.keys() == want.keys() and back.start_step == 2
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_a_zero_box_at_the_wrong_data_index_exceeds_the_bar(shard,
                                                          monkeypatch):
    good = t_trainer.Trainer._zero_chunk

    def first_chunk(self, name, piece, r):
        return good(self, name, piece, 0)

    monkeypatch.setattr(t_trainer.Trainer, "_zero_chunk", first_chunk)
    jl, _, zero = zero_run(shard, "seq")
    diff = float(np.max(np.abs(np.asarray(losses_of(zero, 4))
                               - np.asarray(jl))))
    assert diff > 100 * LOSS_TOL, diff
