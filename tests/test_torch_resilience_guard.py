"""The port's divergence guard (singa_tpu_torch/resilience/guard.py and
the Trainer's guard seam) against the JAX package's, on the CPU.

Both packages start from the same params (the JAX Trainer's, loaded into
the port), read the same shards and run under their own
ResilienceContext with the same fault plan. The bars: the same guard
counters (bad steps, consecutive, LR scale), the same rollbacks, and
every displayed window loss within 1e-4. An LM step goes bad through a
poison token: id 63 appears only in the records one step reads, and row
63 of the token table is NaN in both packages' params (a token feed
cannot hold NaN; ``nanloss`` feeds id 0 there, which is finite in both).

The port alone: the graphed step (its body called per step on the CPU)
equals the eager step to the bit under the guard, with a bad step inside
the body; a guard with no bad step equals no guard to the bit; a rollback
restores into the live tensors (the same addresses, the graph kept); a
save with guard counters crosses to the JAX package and back. The squared
grad-norm equals the JAX package's, non-finite where it is (a NaN, a sum
of squares past float32's range), and ``guard_grads`` scales a tree of
grads by the LR backoff.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch

from singa_tpu.config import parse_cluster_config as j_cluster
from singa_tpu.config import parse_model_config as j_parse
from singa_tpu.parallel import build_mesh as j_mesh
from singa_tpu.resilience import FaultPlan as JPlan
from singa_tpu.resilience import ResilienceContext as JCtx
from singa_tpu.trainer import Trainer as JTrainer
from singa_tpu_torch.config import parse_cluster_config as t_cluster
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.data import loader as t_loader
from singa_tpu_torch.resilience import FaultPlan, ResilienceContext
from singa_tpu.resilience.guard import grad_norm_sq as j_grad_norm_sq
from singa_tpu_torch.resilience.guard import (
    GUARD_KEYS,
    GUARD_LR,
    grad_norm_sq,
    guard_grads,
    init_guard_buffers,
)
from singa_tpu_torch.trainer import Trainer, params_from_numpy
from test_torch_axes_seq import lm_text
from test_torch_launch import one_torch_thread  # noqa: F401
from test_trainer import MLP_CONF

LOSS_TOL = 1e-4
POISON = 63
LOSS_RE = re.compile(r"^step (\d+): train loss : ([-+0-9.einfa]+)")


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("guard")
    out = {"train": str(root / "train"), "test": str(root / "test"),
           "tokens": str(root / "tokens")}
    t_loader.write_records(out["train"], *t_loader.synthetic_arrays(
        320, seed=1))
    t_loader.write_records(out["test"], *t_loader.synthetic_arrays(
        128, seed=1, noise_seed=2))
    toks, labels = t_loader.synthetic_token_arrays(48, seq_len=16, vocab=64)
    toks = np.minimum(toks, POISON - 1)
    toks[2 * 8 + 3, 5] = POISON  # read by step 2 only (batch 8)
    t_loader.write_records(out["tokens"], toks, labels)
    return out


def mlp_conf(shards, resilience: str, *, steps: int = 8, ckpt: int = 0):
    text = MLP_CONF.format(
        train_shard=shards["train"], test_shard=shards["test"],
        train_steps=steps, batchsize=32, lr=0.05, test_frequency=0,
        checkpoint_frequency=ckpt)
    return text.replace("display_frequency: 0", "display_frequency: 1") + (
        f"\nresilience {{ {resilience} }}\n")


def lm_conf(shards, resilience: str, steps: int = 5):
    return (lm_text(shards["tokens"]).replace("train_steps: 4",
                                              f"train_steps: {steps}")
            + f"\ndisplay_frequency: 1\nresilience {{ {resilience} }}\n")


class Log:
    """A trainer log that keeps every line."""

    def __init__(self):
        self.lines = []

    def __call__(self, s):
        self.lines.extend(str(s).splitlines())

    def losses(self) -> list:
        return [float(m.group(2)) for m in map(LOSS_RE.match, self.lines)
                if m]


def jax_guarded(text, faults, ws=None, poison=False):
    """The JAX Trainer under its context -> (trainer, context, log, its
    initial params)."""
    cfg = j_parse(text)
    cl = j_cluster(f'nworkers: 1\nworkspace: "{ws}"\n') if ws else None
    log = Log()
    jt = JTrainer(cfg, cl, mesh=j_mesh(1, 1, jax.devices()[:1]), seed=0,
                  log=log, prefetch=False, device_cache=True)
    params = {n: np.asarray(v) for n, v in jt.params.items()}
    if poison:
        params["embed/tok"] = params["embed/tok"].copy()
        params["embed/tok"][POISON] = np.nan
        jt.params = {n: jax.device_put(v) for n, v in params.items()}
    ctx = JCtx(cfg.resilience, JPlan.parse(faults), log=log)
    ctx.bind(jt)
    try:
        jt.run()
    finally:
        ctx.stop()
    return jt, ctx, log, params


def port_guarded(text, faults, params, ws=None, **kw):
    cl = t_cluster(f'nworkers: 1\nworkspace: "{ws}"\n') if ws else None
    log = Log()
    tt = Trainer(t_parse(text), cl, seed=0, log=log, device="cpu",
                 prefetch=False, device_cache=True, **kw)
    tt.params = params_from_numpy(tt.train_net, params)
    ctx = ResilienceContext(tt.cfg.resilience, FaultPlan.parse(faults),
                            log=log)
    ctx.bind(tt)
    try:
        tt.run()
    finally:
        ctx.stop()
    return tt, ctx, log


CASES = {
    # (conf, resilience block, faults, checkpoint_frequency)
    "mlp_skip": ("mlp", "guard_policy: kSkip", "nanloss@3,nanloss@4", 0),
    # the counter is read every 2 steps from step 1: steps 3 and 4 bad
    # trip it at step 5, back to step_4
    "mlp_rollback": ("mlp", "guard_policy: kRollback guard_rollback_after: "
                     "2 guard_lr_backoff: 0.5 keep_last: 2",
                     "nanloss@3,nanloss@4", 2),
    "lm_skip": ("lm", "guard_policy: kSkip", "", 0),
    # a token feed's nanloss is id 0: finite, as in the JAX package
    "lm_nanloss_finite": ("lm", "guard_policy: kSkip", "nanloss@1", 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_guard_matches_jax(case, shards, tmp_path):
    kind, res, faults, ckpt = CASES[case]
    if kind == "mlp":
        text = mlp_conf(shards, res, steps=8, ckpt=ckpt)
    else:
        text = lm_conf(shards, res)
    poison = case == "lm_skip"
    ws = (tmp_path / "j", tmp_path / "t") if ckpt else (None, None)
    jt, jctx, jlog, params = jax_guarded(text, faults, ws[0], poison)
    tt, tctx, tlog = port_guarded(text, faults, params, ws[1])
    assert tt.guard_counters() == jt.guard_counters()
    assert tctx.rollbacks == jctx.rollbacks
    jl, tl = jlog.losses(), tlog.losses()
    assert len(jl) == len(tl) > 0
    np.testing.assert_allclose(tl, jl, atol=LOSS_TOL)
    expect = {"mlp_skip": (2, 0, 1.0), "mlp_rollback": (1, 1, 0.5),
              "lm_skip": (1, 0, 1.0), "lm_nanloss_finite": (0, 0, 1.0)}
    g = tt.guard_counters()
    assert (g["bad_steps"], tctx.rollbacks, g["lr_scale"]) == expect[case]
    if case == "mlp_rollback":
        assert any("rolling back to" in s and "step_4.npz" in s
                   for s in tlog.lines)
        assert sorted(os.listdir(ws[1] / "checkpoints")) == sorted(
            os.listdir(ws[0] / "checkpoints"))
    for n, v in tt.params.items():
        if not (poison and n == "embed/tok"):
            np.testing.assert_allclose(v.numpy(), np.asarray(jt.params[n]),
                                       atol=LOSS_TOL, err_msg=n)


def _bytes(tr) -> dict:
    """Every param, slot and buffer's bytes (NaN rows compare too)."""
    out = {("p", n): v.numpy().tobytes() for n, v in tr.params.items()}
    out.update({("s", n, s): v.numpy().tobytes()
                for n, slots in tr.state.items() for s, v in slots.items()})
    out.update({("b", n): v.numpy().tobytes()
                for n, v in tr.buffers.items()})
    return out


def _poisoned(tr):
    """Row 63 of the token table NaN, in place."""
    with torch.no_grad():
        tr.params["embed/tok"][POISON] = float("nan")


def test_graphed_guard_equals_eager_and_drops_the_bad_step(shards):
    """The LM's step 2 goes bad inside the graphed body: the step leaves
    every param, slot and buffer byte as step 1 left them (counters
    aside), bad_steps is 1, and graphed equals eager to the bit."""
    text = lm_conf(shards, "guard_policy: kSkip")
    runs = {}
    for graphs in (None, False):
        tr = Trainer(t_parse(text), seed=0, log=lambda s: None,
                     device="cpu", prefetch=False, device_cache=True,
                     graphs=graphs)
        _poisoned(tr)
        snaps = []
        for step in range(4):
            tr.train_one_batch(step)
            snaps.append(_bytes(tr))
        runs[tr.dispatch_mode] = (tr, snaps)
    (tg, sg), (te, se) = runs["graph"], runs["eager"]
    assert sg == se
    before, after = sg[1], sg[2]
    assert {k: v for k, v in after.items() if k[-1] not in GUARD_KEYS} == {
        k: v for k, v in before.items() if k[-1] not in GUARD_KEYS}
    assert sg[3] != sg[2]
    assert tg.guard_counters() == {"consecutive_bad": 0, "bad_steps": 1,
                                   "lr_scale": 1.0}


def test_guard_with_no_bad_step_equals_no_guard(shards):
    """A guarded run without a bad step is the unguarded run, bitwise
    (the LR scale 1.0 multiply and the select are exact)."""
    out = []
    for res in ("guard_policy: kRollback", "guard_policy: kNone"):
        tr = Trainer(t_parse(mlp_conf(shards, res, steps=5)), seed=0,
                     log=lambda s: None, device="cpu", prefetch=False,
                     device_cache=True)
        assert tr.dispatch_mode == "graph"
        tr.run()
        out.append({k: v for k, v in _bytes(tr).items()
                    if k[-1] not in GUARD_KEYS})
    assert out[0] == out[1]


def test_rollback_restores_in_place(shards, tmp_path):
    """``rollback_to`` writes the checkpoint into the live tensors: every
    address the captured step reads is the same after, the graph is kept,
    and the next steps equal a fresh trainer resumed from that save."""
    text = mlp_conf(shards, "guard_policy: kRollback", steps=6, ckpt=2)
    cl = t_cluster(f'nworkers: 1\nworkspace: "{tmp_path}"\n')
    tr = Trainer(t_parse(text), cl, seed=0, log=lambda s: None,
                 device="cpu", prefetch=False, device_cache=True)
    tr.run()
    ptrs = {k: v.data_ptr() for k, v in list(tr.params.items())
            + list(tr.buffers.items())}
    graph = tr._g
    path = str(tmp_path / "checkpoints" / "step_4.npz")
    assert tr.rollback_to(path) == 4
    assert tr._g is graph
    assert {k: v.data_ptr() for k, v in list(tr.params.items())
            + list(tr.buffers.items())} == ptrs
    for s in (4, 5):
        tr.train_one_batch(s)
    cfg = t_parse(text)
    cfg.checkpoint = path
    fresh = Trainer(cfg, seed=0, log=lambda s: None, device="cpu",
                    prefetch=False, device_cache=True)
    for s in (4, 5):
        fresh.train_one_batch(s)
    assert _bytes(tr) == _bytes(fresh)


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_saves_with_guard_counters_cross(saver, shards, tmp_path):
    """A save with nonzero guard counters restores in the other package
    with the same counters and params."""
    text = mlp_conf(shards, "guard_policy: kSkip", steps=4)
    if saver == "port":
        from singa_tpu_torch.trainer import save_checkpoint

        tr, _, _ = port_guarded(text, "nanloss@1", _jax_params(text))
        tr.set_guard_state(lr_scale=0.25)
        path = str(tmp_path / "ck.npz")
        save_checkpoint(path, 4, tr.params, tr.state, tr.buffers)
        want = tr.guard_counters()
        cfg = j_parse(text)
        cfg.checkpoint = path
        other = JTrainer(cfg, mesh=j_mesh(1, 1, jax.devices()[:1]),
                         log=lambda s: None, prefetch=False)
        got = other.guard_counters()
        params = {n: np.asarray(v) for n, v in other.params.items()}
        mine = {n: v.numpy() for n, v in tr.params.items()}
    else:
        from singa_tpu.trainer.checkpoint import save_checkpoint as j_save

        jt, _, _, _ = jax_guarded(text, "nanloss@1")
        jt.set_guard_state(lr_scale=0.25)
        path = str(tmp_path / "ck.npz")
        j_save(path, 4, jt.params, jt.state, jt.buffers)
        want = jt.guard_counters()
        cfg = t_parse(text)
        cfg.checkpoint = path
        other = Trainer(cfg, log=lambda s: None, device="cpu",
                        prefetch=False)
        got = other.guard_counters()
        params = {n: v.numpy() for n, v in other.params.items()}
        mine = {n: np.asarray(v) for n, v in jt.params.items()}
    assert want == got == {"consecutive_bad": 0, "bad_steps": 1,
                           "lr_scale": 0.25}
    for n in mine:
        np.testing.assert_array_equal(params[n], mine[n])


def _jax_params(text) -> dict:
    jt = JTrainer(j_parse(text), mesh=j_mesh(1, 1, jax.devices()[:1]),
                  seed=0, log=lambda s: None, prefetch=False)
    return {n: np.asarray(v) for n, v in jt.params.items()}


NORM_CASES = {
    # name: the grads (float32 unless named), the JAX norm's finiteness
    "finite": ([np.linspace(-3, 3, 12).reshape(3, 4), np.ones(5)], True),
    "nan": ([np.ones(4), np.array([1.0, np.nan])], False),
    # each tensor's sum of squares finite, their total past float32's
    "overflow_total": ([np.full(1, 1.4e19), np.full(1, 1.4e19)], False),
    # one tensor's own sum of squares past float32's range
    "overflow_one": ([np.full(2, 1.4e19), np.ones(3)], False),
    "bf16": ([np.linspace(-2, 2, 8)], True),
}


@pytest.mark.parametrize("case", list(NORM_CASES))
def test_grad_norm_sq_matches_jax(case):
    arrays, finite = NORM_CASES[case]
    dt = torch.bfloat16 if case == "bf16" else torch.float32
    got = grad_norm_sq({f"g{i}": torch.tensor(a, dtype=torch.float32)
                        .to(dt) for i, a in enumerate(arrays)})
    jdt = jax.numpy.bfloat16 if case == "bf16" else np.float32
    want = np.asarray(j_grad_norm_sq(
        {f"g{i}": jax.numpy.asarray(a, dtype=jdt)
         for i, a in enumerate(arrays)}))
    assert got.dtype == torch.float32
    assert bool(torch.isfinite(got)) == bool(np.isfinite(want)) == finite
    if finite:
        np.testing.assert_allclose(got.item(), want, rtol=1e-6)


def test_guard_grads_scales_a_tree_and_takes_the_verdict():
    """One verdict over every leaf (or the caller's norm), every leaf
    times the LR scale; a scale of 1 leaves the grads' bits."""
    counters = init_guard_buffers("cpu")
    tree = ({"a": torch.arange(4.0)}, {0: {"b": torch.ones(2, 3)}})
    ok, same = guard_grads(counters, torch.tensor(0.5), tree)
    assert bool(ok)
    assert torch.equal(same[0]["a"], tree[0]["a"])
    assert torch.equal(same[1][0]["b"], tree[1][0]["b"])
    counters[GUARD_LR].fill_(0.25)
    ok, scaled = guard_grads(counters, torch.tensor(0.5), tree,
                             gnorm=torch.tensor(float("inf")))
    assert not bool(ok)
    assert torch.equal(scaled[0]["a"], tree[0]["a"] * 0.25)
    assert torch.equal(scaled[1][0]["b"], tree[1][0]["b"] * 0.25)
    ok, _ = guard_grads(counters, torch.tensor(float("nan")), tree)
    assert not bool(ok)
