"""kMoE routes the tokens the JAX program routes together, on every mesh
(singa_tpu_torch/layers/sequence.py ``MoELayer.apply_ranks``).

Without an expert axis the JAX ``MoELayer`` takes ``moe_ffn_dense`` on
the global array, so GSPMD routes the global batch at once: one capacity
``int(cf * N / E)`` over every data rank's tokens and one aux loss. The
port's data-axis step walks its ranks in lockstep for a net with kMoE
(``Trainer._lockstep``) and routes them together. At a capacity factor
where queues overflow, 4 steps are held to the JAX Trainer on the same
mesh within 1e-4: data 2 at cf 1.0 and 0.5, and data 2 x model 2. A
planted fault (each rank routing its own tokens, the port's routing
before this repair) must exceed the bar 100 times. kMoE on a data axis
that spans processes routes the same global batch.

This file also holds the helpers the other new axes files use to build
a mesh of any widths in both packages.
"""

import jax
import numpy as np
import pytest

from singa_tpu.parallel import build_full_mesh as j_full_mesh
from singa_tpu_torch.layers import sequence as t_seq
from test_torch_axes_seq import (
    LOSS_TOL,
    close,
    cluster,
    jax_run,
    lm_text,
    losses_of,
    one_torch_thread,  # noqa: F401 (autouse)
    port_trainer,
    shard,  # noqa: F401 (fixture)
)

AXES = ("pipe", "expert", "seq", "model")
FIELDS = {"pipe": "npipes_per_group", "expert": "nexperts_per_group",
          "seq": "nseq_per_group"}


def width_of(widths: dict) -> int:
    return int(np.prod(list(widths.values())))


def cluster_text(widths: dict) -> str:
    """The cluster conf lines of a mesh of ``widths`` (axes left out are
    1): nworkers every rank, nprocs_per_group the inner axes, each of
    seq, expert and pipe carved out by its field, the model axis the
    rest."""
    group = width_of({a: w for a, w in widths.items() if a in AXES})
    lines = [f"nworkers: {width_of(widths)}"]
    if group > 1:
        lines.append(f"nprocs_per_group: {group}")
    lines += [f"{FIELDS[a]}: {widths[a]}" for a in FIELDS
              if widths.get(a, 1) > 1]
    return "\n".join(lines)


def jax_mesh(widths: dict):
    return j_full_mesh(widths, jax.devices()[:width_of(widths)])


def jax_on(text: str, widths: dict, steps: int = 4):
    """The JAX Trainer on a mesh of ``widths`` -> (losses, its params)."""
    return jax_run(text, steps, mesh=jax_mesh(widths))


def port_on(text: str, widths: dict, params: dict, **kw):
    """The port's Trainer on CPU ranks of ``widths`` from ``params``."""
    return port_trainer(text, cluster(cluster_text(widths)), params, **kw)


def _per_rank_routing(self):
    """The planted fault: kMoE never crosses the ranks, so each routes
    its own tokens with its own capacity and aux loss."""
    return False


@pytest.mark.parametrize("cf", [1.0, 0.5])
def test_data_axis_routes_the_global_batch_as_jax_does(shard, cf):
    text = lm_text(shard, moe="psum", cf=cf)
    jl, params = jax_on(text, {"data": 2})
    tr = port_on(text, {"data": 2}, params)
    assert tr.mesh_shape == {"data": 2} and tr._lockstep()
    close(losses_of(tr, 4), jl, LOSS_TOL)


def test_data_x_model_routes_the_global_batch_as_jax_does(shard):
    text = lm_text(shard, moe="psum", cf=1.0, part=True)
    widths = {"data": 2, "model": 2}
    jl, params = jax_on(text, widths)
    tr = port_on(text, widths, params)
    assert tr._layout["attn/qkv"] == (1, "model")
    close(losses_of(tr, 4), jl, LOSS_TOL)


def test_per_rank_routing_exceeds_the_bar(shard, monkeypatch):
    text = lm_text(shard, moe="psum", cf=1.0)
    jl, params = jax_on(text, {"data": 2})
    monkeypatch.setattr(t_seq.MoELayer, "crosses", _per_rank_routing)
    tr = port_on(text, {"data": 2}, params)
    assert not tr._lockstep()
    diff = float(np.max(np.abs(np.asarray(losses_of(tr, 4))
                               - np.asarray(jl))))
    assert diff > 100 * LOSS_TOL, diff


def test_moe_on_a_data_axis_across_processes_is_refused(shard, tmp_path):
    """(Named for the refusal it held until kMoE's tokens crossed
    processes.) Two processes of one rank, through ``main`` from the JAX
    Trainer's initial params: the global batch's tokens cross processes
    through kMoE's exchange, both processes end with the digest of one
    process holding both ranks, bitwise, and that run's losses are the
    JAX Trainer's global routing on data 2 within the bar."""
    from singa_tpu.trainer.checkpoint import save_checkpoint as j_save
    from test_torch_axes_span_seq import check_axes
    from test_torch_model_span_trainer import span_launch

    text = lm_text(shard, moe="psum", cf=1.0)
    jl, params = jax_on(text, {"data": 2})
    init = str(tmp_path / "init.npz")
    j_save(init, 0, params)
    text += f'checkpoint: "{init}"\n'
    reports = span_launch(tmp_path, text, 2, "nworkers: 2")
    tr = port_on(text, {"data": 2}, params)
    close(losses_of(tr, 4), jl, LOSS_TOL)
    check_axes(reports, 2, tr.digest(), exchanged=True)
