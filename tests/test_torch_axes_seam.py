"""The ``grad_comm`` reference seam on an axes mesh
(singa_tpu_torch/trainer/trainer.py ``_axes_seam``).

The quantized seam (``grad_comm { mode: quantized }``, int8 and bf16;
not the rings) quantizes each param's logical gradient, bucket by
bucket, as the JAX seam does on its global arrays: the lockstep step
joins each param's summed pieces into that gradient, runs the seam and
cuts it back. int8 on data 2 x seq 2 (ring attention) and on data 2 x
expert 2 (psum), bf16 on data 2 x model 2 with kLayerPartition, each
held to the JAX Trainer's seam on the same mesh: losses within LOSS_TOL
over 4 steps, and the error-feedback residuals after the first step
(both sides from the same params, so only the order of the sums
differs) within RES_TOL of the JAX residuals, as the mean gap over every
element against their mean size. A seam that is skipped leaves the
losses within about 7e-5 of the JAX run, so the residuals are what a
skipped seam cannot match: it banks none, a gap of 1.0, 500 times the
bar.
"""

import functools

import numpy as np
import pytest

from singa_tpu_torch.parallel import is_residual_key
from singa_tpu_torch.trainer import Trainer
from test_torch_axes_bn_seam import DM
from test_torch_axes_seq import (
    LOSS_TOL,
    JTrainer,
    close,
    j_parse,
    lm_text,
    one_torch_thread,  # noqa: F401 (autouse)
    shard,  # noqa: F401 (fixture)
)
from test_torch_moe_routing import jax_mesh, port_on

#: the residuals' mean gap over their mean size after one step: int8
#: reads about 2e-5 and bf16 5.4e-4 (a bf16 rounding that lands the
#: other side of a tie moves one element by a whole bf16 step)
RES_TOL = 2e-3

CASES = {
    "seq_int8": ({"data": 2, "seq": 2}, dict(mode="ring"), "int8"),
    "expert_int8": ({"data": 2, "expert": 2}, dict(moe="psum"), "int8"),
    "model_bf16": (DM, dict(part=True), "bf16"),
}


def residuals(tr) -> dict:
    return {k: np.array(v) for k, v in tr.buffers.items()
            if is_residual_key(k)}


def res_gap(got: dict, want: dict) -> float:
    assert set(got) <= set(want) and want
    gap = np.concatenate([(got.get(k, 0 * w) - w).ravel()
                          for k, w in want.items()])
    size = np.concatenate([w.ravel() for w in want.values()])
    return float(np.abs(gap).mean() / np.abs(size).mean())


def run(tr) -> tuple[list, dict]:
    """4 steps -> (losses, the residuals after the first)."""
    losses, res = [], None
    for s in range(4):
        tr.train_one_batch(s)
        (m,) = tr.perf.avg().values()
        losses.append(float(m["loss"]))
        tr.perf.reset()
        res = res or residuals(tr)
    return losses, res


def text_of(shard, case: str) -> str:
    _, kw, dtype = CASES[case]
    return lm_text(shard, extra="grad_comm { mode: quantized "
                   f'dtype: "{dtype}" }}', **kw)


@functools.cache
def jax_seam(shard: str, case: str):
    """The JAX Trainer's seam on ``case``'s mesh -> (losses, first-step
    residuals, its initial params)."""
    jt = JTrainer(j_parse(text_of(shard, case)), None,
                  mesh=jax_mesh(CASES[case][0]), seed=0,
                  log=lambda s: None, prefetch=False)
    params = {n: np.asarray(v) for n, v in jt.params.items()}
    return (*run(jt), params)


@pytest.mark.parametrize("case", list(CASES))
def test_the_quantized_seam_on_an_axes_mesh_matches_jax(shard, case):
    jl, jres, params = jax_seam(shard, case)
    tr = port_on(text_of(shard, case), CASES[case][0], params)
    assert tr.comm_mode == "quantized" and tr.comm_dtype == CASES[case][2]
    losses, res = run(tr)
    close(losses, jl, LOSS_TOL)
    assert set(res) == set(jres) == {f"__gradres__/{n}" for n in tr.params}
    assert res_gap(res, jres) <= RES_TOL


def test_a_skipped_seam_exceeds_the_bar(shard, monkeypatch):
    """The planted fault: the lockstep step sums exactly and banks no
    residual."""
    jl, jres, params = jax_seam(shard, "seq_int8")
    monkeypatch.setattr(Trainer, "_axes_seam", lambda self, g: (g, {}))
    tr = port_on(text_of(shard, "seq_int8"), CASES["seq_int8"][0], params)
    _, res = run(tr)
    assert res_gap(res, jres) > 100 * RES_TOL
