"""The port's expert axis (singa_tpu_torch/parallel/moe.py's psum and
all-to-all forms, kMoE's ``apply_ranks``) against the JAX package.

``moe_ffn`` and ``moe_ffn_a2a`` are held to the JAX functions
(shard_map over the suite's virtual CPU devices) on (data 2, expert 4):
outputs, aux and gradients within 1e-5; the all-to-all form with ample
capacity and with queues that overflow (capacity per source rank and
expert, as in the JAX form). Through the Trainer, 4 steps within 1e-4:
the psum form on data 2 x expert 4 against the JAX Trainer's psum run
on data 2 x expert 2 (the same token sets: each data shard with its
whole sequence), and both forms on expert 4 against the
JAX Trainer's single-device dense run. A planted fault (each expert
rank computing the next rank's experts) must move the losses past the
bar.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.parallel import build_full_mesh
from singa_tpu.parallel import moe as jm
from singa_tpu_torch.parallel import moe as tm
from test_torch_axes_seq import (
    LOSS_TOL,
    OP_TOL,
    close,
    cluster,
    jax_run,
    lm_text,
    losses_of,
    one_torch_thread,  # noqa: F401 (autouse)
    port_trainer,
    shard,  # noqa: F401 (fixture)
)


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((8, 8, 16)).astype(np.float32)
    params = {
        "gate": rng.standard_normal((16, 8)).astype(np.float32),
        "up": (0.3 * rng.standard_normal((8, 16, 24))).astype(np.float32),
        "down": (0.3 * rng.standard_normal((8, 24, 16))).astype(np.float32),
    }
    w = rng.standard_normal((8, 8, 16)).astype(np.float32)
    return x, params, w


@pytest.mark.parametrize("form,cf", [
    ("psum", 1.25), ("a2a", 8.0), ("a2a", 1.0)],
    ids=["psum", "a2a_ample", "a2a_overflow"])
def test_expert_forms_match_jax(form, cf):
    ndata, nexp = 2, 4
    x, params, w = _inputs(7)
    mesh = jm.build_ep_mesh(ndata, nexp, jax.devices()[:ndata * nexp])
    jfn = {"psum": jm.moe_ffn, "a2a": jm.moe_ffn_a2a}[form]
    tfn = {"psum": tm.moe_ffn, "a2a": tm.moe_ffn_a2a}[form]

    def jloss(x, p):
        y, aux = jfn(x, p, mesh, capacity_factor=cf)
        return jnp.sum(y * w) + aux, (y, aux)

    (_, (jy, jaux)), (jgx, jgp) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(x, params)
    tx = torch.tensor(x, requires_grad=True)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    ty, taux = tfn(tx, tp, ndata=ndata, nexpert=nexp, capacity_factor=cf)
    ((ty * torch.tensor(w)).sum() + taux).backward()
    close(ty.detach(), jy, OP_TOL)
    close(taux.detach(), jaux, OP_TOL)
    close(tx.grad, jgx, OP_TOL)
    for k in params:
        close(tp[k].grad, jgp[k], OP_TOL)


DP2 = "nworkers: 2"
EP = "nworkers: 8\nnprocs_per_group: 4\nnexperts_per_group: 4"
EP1 = "nworkers: 4\nnprocs_per_group: 4\nnexperts_per_group: 4"


@pytest.fixture(scope="module")
def moe_ref(shard):
    """The JAX Trainer's single-device dense kMoE run."""
    return jax_run(lm_text(shard, moe="psum"))


def test_psum_form_on_data2_expert4_matches_the_data2_dense_run(shard):
    """The psum form routes each data shard with its whole sequence
    (the JAX ``moe_ffn``'s ``P(data, None, None)``), whatever the expert
    width: the JAX Trainer's psum run on data 2 x expert 2 routes the
    same token sets, at a capacity factor of 1 where queues overflow.
    (The port's data-2 dense run routes the global batch, as the JAX
    dense path does.)"""
    text = lm_text(shard, moe="psum", cf=1.0)
    jl, params = jax_run(text, mesh=build_full_mesh(
        {"data": 2, "expert": 2}, jax.devices()[:4]))
    tr = port_trainer(text, cluster(EP), params)
    assert tr._layout["moe/up"] == (0, "expert")
    assert tr._layout["moe/gate"] is None
    close(losses_of(tr, 4), jl, LOSS_TOL)


@pytest.mark.parametrize("dispatch", ["psum", "alltoall"])
def test_expert_axis_matches_jax_dense_single_device(shard, moe_ref,
                                                     dispatch):
    """On expert 4 alone (one data rank, ample capacity) both forms are
    the dense math: the JAX Trainer's single-device run."""
    jl, params = moe_ref
    tr = port_trainer(lm_text(shard, moe=dispatch), cluster(EP1), params)
    close(losses_of(tr, 4), jl, LOSS_TOL)


@pytest.mark.parametrize("dispatch", ["psum", "alltoall"])
def test_shifted_expert_ownership_exceeds_the_bar(shard, moe_ref,
                                                  monkeypatch, dispatch):
    jl, params = moe_ref
    monkeypatch.setattr(tm, "_shard_of", lambda e, n: (e + 1) % n)
    tr = port_trainer(lm_text(shard, moe=dispatch), cluster(EP1), params)
    diff = float(np.max(np.abs(np.asarray(losses_of(tr, 2))
                               - np.asarray(jl[:2]))))
    assert diff > 100 * LOSS_TOL, diff


def test_indivisible_experts_replicate_with_a_warning_and_refuse(shard):
    """3 expert ranks do not divide 4 experts: the layout replicates
    with the JAX package's warning, and the layer refuses by name at
    its first step, as the JAX layer does."""
    from singa_tpu_torch.config import ConfigError

    ep3 = "nworkers: 3\nnprocs_per_group: 3\nnexperts_per_group: 3"
    with pytest.warns(UserWarning, match="falling back to replication"):
        tr = port_trainer(lm_text(shard, moe="psum", batch=6),
                          cluster(ep3), jax_run(
                              lm_text(shard, moe="psum", batch=6), 0)[1])
    assert tr._layout["moe/up"] is None
    with pytest.raises(ConfigError, match="not divisible by expert axis "
                       "width 3"):
        tr.train_one_batch(0)
