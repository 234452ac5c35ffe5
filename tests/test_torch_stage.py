"""Weight staging in the port's engine: ``stage_params`` validates a
next version against the live tree (keys, shapes, dtypes) before it
copies anything, ``flip_params`` makes it live in place (the live
tensors keep their addresses, which the captured graphs read) and
purges the prefix cache, ``rollback_params`` restores the pinned
previous version; a slot admitted under a replaced version is not
registered. A JAX weight frame stages into the port.
"""

import io

import numpy as np
import pytest
import torch

from singa_tpu.models.transformer import TransformerConfig as JCfg
from singa_tpu.serve import Engine as JEngine
from singa_tpu.serve import EngineConfig as JEngineConfig
from singa_tpu.serve import Request as JRequest
from singa_tpu.serve import Scheduler as JScheduler
from singa_tpu.serve.fleet import migrate as jm
from singa_tpu_torch.models.transformer import TransformerConfig as TCfg
from singa_tpu_torch.serve import Engine, EngineConfig, Request, Scheduler
from singa_tpu_torch.serve.fleet import migrate as tm
from test_torch_prefix import KW, jax_params, torch_params

EC = dict(slots=2, kv_block_len=4, max_prefill_chunk=4, prefix_cache=True)


def prompts():
    rs = np.random.RandomState(3)
    prefix = rs.randint(0, KW["vocab"], size=(8,))
    return [np.concatenate([prefix, rs.randint(0, KW["vocab"], size=(3,))])
            .astype(np.int32) for _ in range(3)]


def engine(params):
    return Engine(params, TCfg(**KW), EngineConfig(**EC), device="cpu")


def streams(eng):
    sched = Scheduler(eng)
    for i, p in enumerate(prompts()):
        sched.submit(Request(rid=i, prompt=p, max_new_tokens=6))
    sched.serve()
    return {r.rid: r.tokens for r in sched.finished}, sched


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "dtype"])
def test_stage_rejects_a_mismatched_tree(fault):
    eng = engine(torch_params())
    new = {k: v.clone() for k, v in torch_params(1).items()}
    if fault == "missing":
        del new["blk0/attn/qkv"]
    elif fault == "extra":
        new["blk9/attn/qkv"] = new["blk0/attn/qkv"]
    elif fault == "shape":
        new["blk0/attn/qkv"] = new["blk0/attn/qkv"][:, :-1]
    else:
        new["blk0/attn/qkv"] = new["blk0/attn/qkv"].double()
    with pytest.raises(ValueError, match=fault if fault in (
            "shape", "dtype") else "mismatch"):
        eng.stage_params(new, 1)
    assert eng.staged_version is None
    with pytest.raises(ValueError, match="already live"):
        eng.stage_params(torch_params(1), 0)


def test_flip_gives_a_fresh_engines_streams_and_rollback_the_old():
    """After flip_params the streams are a fresh engine's on the new
    weights; rollback_params brings the old streams back. The live
    tensors keep their addresses through both, and the caller's params
    are never written."""
    old, _ = streams(engine(torch_params()))
    new, _ = streams(engine(torch_params(1)))
    assert old != new
    eng = engine(torch_params())
    addrs = {k: v.data_ptr() for k, v in eng.params.items()}
    warm, sched = streams(eng)
    assert warm == old and sched.prefix_hits > 0
    cached = eng.allocator.cached_blocks
    assert cached > 0
    nbytes = eng.stage_params(torch_params(1), 1)
    assert nbytes == sum(v.numel() * 4 for v in torch_params(1).values())
    assert eng.staged_version == 1 and eng.params_version == 0
    out = eng.flip_params()
    assert out == {"version": 1, "prev_version": 0, "purged_blocks": cached}
    assert eng.staged_version is None and eng.allocator.cached_blocks == 0
    assert streams(eng)[0] == new
    cached = eng.allocator.cached_blocks
    assert eng.rollback_params() == {
        "version": 0, "aborted_version": 1, "purged_blocks": cached}
    assert streams(eng)[0] == old
    assert {k: v.data_ptr() for k, v in eng.params.items()} == addrs
    fresh = torch_params()
    assert all(torch.equal(eng.params[k], fresh[k]) for k in fresh)
    with pytest.raises(ValueError, match="no previous"):
        eng.rollback_params()
    with pytest.raises(ValueError, match="nothing staged"):
        eng.flip_params()


def test_unstage_drops_the_staged_version():
    eng = engine(torch_params())
    eng.stage_params(torch_params(1), 4)
    eng.unstage()
    assert eng.staged_version is None
    with pytest.raises(ValueError, match="nothing staged"):
        eng.flip_params()


def test_a_slot_of_a_replaced_version_is_not_registered():
    """A slot admitted before a flip finishes its prefill afterwards: its
    bytes mix two versions, so register_prefix and register_history skip
    it; a slot admitted after the flip registers."""
    p = prompts()[0]
    eng = engine(torch_params())
    eng.admit(0, len(p) + 4, prompt=p)
    eng.prefill_chunk(0, p[:4], 0)
    eng.stage_params(torch_params(1), 1)
    eng.flip_params()
    eng.prefill_chunk(0, p[4:8], 4)
    eng.prefill_chunk(0, p[8:], 8)
    assert eng.register_prefix(0, p) == 0
    assert eng.register_history(0, np.concatenate([p, p])) == 0
    eng.retire(0)
    eng.admit(1, len(p) + 4, prompt=p)
    for c0 in range(0, len(p), 4):
        eng.prefill_chunk(1, p[c0:c0 + 4], c0)
    assert eng.register_prefix(1, p) == 2


def test_a_jax_weight_frame_stages_into_the_port():
    """The JAX package's weight frame of version 1 deserializes in the
    port, stages and flips: the streams are the JAX engine's on those
    weights. A torn frame is rejected before it can be staged."""
    frame = jm.serialize_weights(
        1, {k: np.asarray(v) for k, v in jax_params(1).items()})
    version, tree = tm.deserialize_weights(frame)
    eng = engine(torch_params())
    eng.stage_params(tree, version)
    eng.flip_params()
    got, _ = streams(eng)
    jeng = JEngine(jax_params(1), JCfg(**KW), JEngineConfig(**EC))
    jsched = JScheduler(jeng)
    for i, p in enumerate(prompts()):
        jsched.submit(JRequest(rid=i, prompt=p, max_new_tokens=6))
    jsched.serve()
    assert got == {r.rid: [int(t) for t in r.tokens]
                   for r in jsched.finished}
    # a torn artifact in a sound container: one weight's bytes changed
    # after the CRC was taken
    with np.load(io.BytesIO(frame)) as z:
        arrays = {k: z[k].copy() for k in z.files}
    arrays["w0003"].flat[0] += 1.0
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    with pytest.raises(ValueError, match="CRC"):
        tm.deserialize_weights(buf.getvalue())
    # the port's frame of the same tree reads in the JAX package
    assert jm.deserialize_weights(tm.serialize_weights(
        1, torch_params(1)))[1].keys() == tree.keys()
