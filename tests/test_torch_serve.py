"""The port's serving engine and scheduler (singa_tpu_torch/serve)
against the JAX package's, on the same weights.

Every workload runs through the JAX ``Engine``/``Scheduler`` (its
``reference`` attend, whose streams the JAX suite pins identical to its
fused kernel) and through the port under both ``attend_impl`` values
(on the CPU ``fused`` runs the kernel's plain version). The bar is the
one the JAX package holds its own kernel to: greedy token streams
identical, request by request.

EOS is held against the port's own one-token decode, never against
``test_eos_mid_accepted_run_retires_at_the_right_token`` of
tests/test_speculate.py, which fails on the JAX reference itself.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from singa_tpu.models.transformer import TransformerConfig as JCfg
from singa_tpu.models.transformer import init_lm as j_init_lm
from singa_tpu.serve import Engine as JEngine
from singa_tpu.serve import EngineConfig as JEngineConfig
from singa_tpu.serve import Request as JRequest
from singa_tpu.serve import Scheduler as JScheduler
from singa_tpu_torch.models.transformer import TransformerConfig as TCfg
from singa_tpu_torch.models.transformer import load_jax_params
from singa_tpu_torch.serve import (
    Engine,
    EngineConfig,
    NullDrafter,
    Request,
    Scheduler,
)

KW = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_len=48)
IMPLS = ["fused", "reference"]

#: workload name -> engine knobs (both packages) and request shape
WORKLOADS = {
    "interleaved": dict(slots=3, n=6),
    "single_slot": dict(slots=1, n=4),
    # the smallest pool: one full-length sequence (6 blocks) + trash, so
    # admissions wait on retirements
    "backpressure": dict(slots=3, n=6, kv_blocks=7),
    "spec2": dict(slots=3, n=6, spec_k=2),
    "spec4": dict(slots=3, n=6, spec_k=4),
}


@functools.cache
def jax_params():
    return j_init_lm(jax.random.PRNGKey(0), JCfg(**KW))


@functools.cache
def torch_params():
    return load_jax_params(
        {k: np.asarray(v) for k, v in jax_params().items()}, "cpu"
    )


def requests(n, seed=0, repeat=False):
    """Ragged prompts and budgets from a seed; ``repeat`` tiles motifs
    (drafter-friendly, so speculative ticks accept)."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        plen = int(rs.randint(3, 20))
        if repeat:
            motif = rs.randint(0, KW["vocab"], size=(3,))
            prompt = np.tile(motif, plen // 3 + 1)[:plen]
        else:
            prompt = rs.randint(0, KW["vocab"], size=(plen,))
        out.append((prompt.astype(np.int32), int(rs.randint(4, 20))))
    return out


def serve_torch(impl, *, slots, n, spec_k=0, kv_blocks=0, drafter=None,
                reqs=None, eos=None):
    eng = Engine(torch_params(), TCfg(**KW), EngineConfig(
        slots=slots, kv_block_len=8, kv_blocks=kv_blocks,
        max_prefill_chunk=4, spec_k=spec_k, attend_impl=impl,
    ), device="cpu")
    sched = Scheduler(eng, drafter=drafter)
    for i, (p, m) in enumerate(reqs or requests(n, repeat=spec_k > 0)):
        sched.submit(Request(rid=i, prompt=p, max_new_tokens=m, eos=eos))
    sched.serve()
    return sched, {r.rid: r.tokens for r in sched.finished}


@functools.cache
def serve_jax(workload):
    kw = WORKLOADS[workload]
    spec_k = kw.get("spec_k", 0)
    eng = JEngine(jax_params(), JCfg(**KW), JEngineConfig(
        slots=kw["slots"], kv_block_len=8, kv_blocks=kw.get("kv_blocks", 0),
        max_prefill_chunk=4, spec_k=spec_k,
    ))
    sched = JScheduler(eng)
    for i, (p, m) in enumerate(requests(kw["n"], repeat=spec_k > 0)):
        sched.submit(JRequest(rid=i, prompt=p, max_new_tokens=m))
    sched.serve()
    return sched.backpressure_ticks, {r.rid: r.tokens for r in sched.finished}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_streams_match_jax(workload, impl):
    kw = WORKLOADS[workload]
    sched, got = serve_torch(impl, **kw)
    jax_bp, want = serve_jax(workload)
    assert got == want
    assert len(got) == kw["n"]
    if workload == "backpressure":
        assert sched.backpressure_ticks > 0 and jax_bp > 0
    if kw.get("spec_k"):
        assert sched.spec_accepted > 0


def _eos_case():
    """A request and an EOS token whose first occurrence in the free run
    (the port's own one-token decode) is past the first token."""
    (prompt, _), = requests(1, seed=3)
    _, free = serve_torch("reference", slots=2, n=1,
                          reqs=[(prompt, 16)])
    run = free[0]
    cut = next(i for i in range(1, len(run)) if run[i] not in run[:i])
    return prompt, run, cut


@pytest.mark.parametrize("impl", IMPLS)
def test_eos_retires_at_the_eos_token(impl):
    prompt, run, cut = _eos_case()
    sched, got = serve_torch(impl, slots=2, n=1, reqs=[(prompt, 16)],
                             eos=run[cut])
    assert got[0] == run[:cut + 1]
    assert sched.engine.allocator.used_blocks == 0


class ScriptedDrafter:
    """Proposes the true continuation, so whole runs are accepted."""

    def __init__(self, prompt, run):
        self.full = list(prompt) + list(run)

    def draft(self, ctx, k):
        n = len(ctx)
        return self.full[n:n + k] if self.full[:n] == list(ctx) else []


@pytest.mark.parametrize("impl", IMPLS)
def test_eos_inside_accepted_run_cuts_at_eos(impl):
    prompt, run, cut = _eos_case()
    sched, got = serve_torch(
        impl, slots=2, n=1, spec_k=4, reqs=[(prompt, 16)], eos=run[cut],
        drafter=ScriptedDrafter(prompt, run),
    )
    assert got[0] == run[:cut + 1]
    assert sched.spec_accepted > 0


@pytest.mark.parametrize("impl", IMPLS)
def test_zero_acceptance_verify_matches_one_token_tick(impl):
    reqs = requests(5, seed=6)
    _, want = serve_torch(impl, slots=3, n=5, reqs=reqs)
    _, got = serve_torch(impl, slots=3, n=5, spec_k=3, reqs=reqs,
                         drafter=NullDrafter())
    assert got == want


def _temperature_streams(others):
    """Request 0 samples at temperature 0.8 with seed 5; ``others``
    extra requests (greedy and sampling, other seeds) share the batch."""
    eng = Engine(torch_params(), TCfg(**KW), EngineConfig(
        slots=4, kv_block_len=8, max_prefill_chunk=4,
    ), device="cpu")
    sched = Scheduler(eng)
    reqs = requests(1 + others, seed=4)
    for i, (p, m) in enumerate(reqs):
        sched.submit(Request(rid=i, prompt=p, max_new_tokens=m,
                             temperature=0.8 if i % 2 == 0 else 0.0,
                             seed=5 + 10 * i))
    sched.serve()
    return {r.rid: r.tokens for r in sched.finished}


def test_temperature_streams_are_seeded_and_slot_independent():
    alone = _temperature_streams(0)[0]
    crowded = _temperature_streams(3)
    assert crowded[0] == alone
    assert _temperature_streams(3) == crowded


@pytest.mark.parametrize(
    "make,error",
    [
        # a mesh runs (tests/test_torch_serve_tp.py); one that is not the
        # port's Mesh is refused by name
        (lambda p, c: Engine(p, c, mesh=object(), device="cpu"), TypeError),
    ],
)
def test_later_slice_options_raise(make, error):
    with pytest.raises(error, match="Mesh"):
        make(torch_params(), TCfg(**KW))


def test_dead_rows_reach_the_kernel_at_position_minus_one(monkeypatch):
    """A dead slot (never admitted, or retired with a stale position)
    attends at position -1, so the kernel reads none of its blocks."""
    import singa_tpu_torch.serve.engine as engine_mod

    seen = []
    for name in ("paged_attention", "paged_attention_overlay"):
        real = getattr(engine_mod, name)

        def spy(q, kp, vp, tables, positions, *chunk, real=real):
            seen.append(positions.clone())
            return real(q, kp, vp, tables, positions, *chunk)

        monkeypatch.setattr(engine_mod, name, spy)
    eng = Engine(torch_params(), TCfg(**KW), EngineConfig(
        slots=3, kv_block_len=8, max_prefill_chunk=8, spec_k=2,
    ), device="cpu")
    (prompt, _), = requests(1, seed=2)
    plen = min(len(prompt), 8)
    eng.admit(1, plen + 4)
    logits = eng.prefill_chunk(1, prompt[:plen], 0)
    eng.activate(1, logits, plen, seed=0)
    seen.clear()
    eng.decode()
    eng.verify(np.zeros((3, 2), np.int64), np.asarray([0, 2, 0]))
    dec, ver = seen[-2 * KW["n_layers"]], seen[-1]
    assert dec[:, 0].tolist() == [-1, plen, -1]
    assert ver[1].tolist() == [plen + 1, plen + 2, plen + 3]
    assert (ver[[0, 2]] == -1).all()
    eng.retire(1)
    seen.clear()
    assert (eng.decode() == -1).all()
    assert all((p == -1).all() for p in seen)


def test_unknown_attend_impl_raises():
    with pytest.raises(ValueError):
        Engine(torch_params(), TCfg(**KW),
               EngineConfig(attend_impl="pallas"), device="cpu")


def test_submit_rejects_requests_past_max_len():
    sched = Scheduler(Engine(torch_params(), TCfg(**KW), device="cpu"))
    with pytest.raises(ValueError):
        sched.submit(Request(rid=0, prompt=np.zeros(40, np.int32),
                             max_new_tokens=9))
    assert not sched.busy


def test_engine_tensors_live_on_the_engine_device():
    eng = Engine(torch_params(), TCfg(**KW), device="cpu")
    assert eng.state["tables"].dtype == torch.int32
    assert eng.state["pos"].dtype == torch.int32
    assert all(t.device.type == "cpu" for t in eng._pools[0]["k"])


class EagerEngine(Engine):
    """The engine's decode and prefill as they were before they became
    graph bodies: Python-int prefill arguments, the sampling inside the
    tick, the lanes rebound to fresh tensors. The oracle for the
    restructured programs."""

    @torch.no_grad()
    def decode(self):
        from singa_tpu_torch.models.transformer import _block_apply, lm_head

        st = self.state
        tokens, pos, live, tables = (
            st["tokens"], st["pos"], st["live"], st["tables"])
        x = self._embed(tokens, pos)[:, None, :]
        bid, off = self._block_of(tables, pos[:, None])
        bid = torch.where(live, bid[:, 0], 0)
        off = off[:, 0]
        pos_attend = torch.where(live, pos, -1)[:, None]

        def mk_attend(i):
            def attend(q, k, v):
                self._write(i, bid, off, k[:, :, 0], v[:, :, 0])
                return self._paged_attend(q, self._pools[0]["k"][i],
                                          self._pools[0]["v"][i], tables,
                                          pos_attend), None
            return attend

        for i in range(self.cfg.n_layers):
            x, _, _ = _block_apply(self.params, f"blk{i}", x, mk_attend(i),
                                self.cfg)
        nxt = self._sample(lm_head(self.params, x)[:, 0], live, tokens)
        st["tokens"] = nxt
        st["pos"] = pos + live.to(torch.int32)
        return torch.where(live, nxt, -1)

    @torch.no_grad()
    def prefill_chunk(self, slot, tokens, pos0):
        from singa_tpu_torch.models.transformer import _block_apply, lm_head

        c, n = self.serving.max_prefill_chunk, len(tokens)
        buf = np.zeros((c,), np.int64)
        buf[:n] = tokens
        chunk = torch.from_numpy(buf)
        ar = torch.arange(c)
        p = int(pos0) + ar
        valid = ar < n
        x = self._embed(chunk, p)[None]
        row = self.state["tables"][slot][None]
        bid, off = self._block_of(row, p[None])
        bid = torch.where(valid, bid[0], 0)
        off = off[0]

        def mk_attend(i):
            def attend(q, k, v):
                self._write(i, bid, off, k[0].transpose(0, 1),
                            v[0].transpose(0, 1))
                return self._paged_attend(q, self._pools[0]["k"][i],
                                          self._pools[0]["v"][i], row,
                                          p[None]), None
            return attend

        for i in range(self.cfg.n_layers):
            x, _, _ = _block_apply(self.params, f"blk{i}", x, mk_attend(i),
                                self.cfg)
        return lm_head(self.params, x)[0][max(n - 1, 0)]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_graph_bodies_give_the_eager_engines_streams(temperature):
    """decode and prefill as graph bodies (static prefill args, the
    temperature draws after the tick on its logits) give the streams of
    the eager engine before them, temperature slots included, and the
    greedy streams equal the JAX engine's."""
    reqs = requests(6)
    out = []
    for cls in (Engine, EagerEngine):
        eng = cls(torch_params(), TCfg(**KW), EngineConfig(
            slots=3, kv_block_len=8, max_prefill_chunk=4,
        ), device="cpu")
        sched = Scheduler(eng)
        for i, (p, m) in enumerate(reqs):
            # every other request samples, with its own seed
            sched.submit(Request(rid=i, prompt=p, max_new_tokens=m, seed=i,
                                 temperature=temperature * (i % 2)))
        sched.serve()
        out.append({r.rid: r.tokens for r in sched.finished})
    assert out[0] == out[1] and len(out[0]) == 6
    if temperature == 0.0:
        assert out[0] == serve_jax("interleaved")[1]
    else:
        greedy = serve_jax("interleaved")[1]
        assert any(out[0][i] != greedy[i] for i in (1, 3, 5))
