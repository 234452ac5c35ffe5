"""The port's CUDA paged-attention kernel on the card: held to its plain
PyTorch version, its wrapper's refusals, and the serving engine's
streams through it.

Every test here needs a GPU and skips without one (the kernel has no
CPU mode). The file imports neither jax nor singa_tpu, so it runs on a
machine that has only PyTorch and the CUDA toolkit, from the repository
root, without the suite's conftest (which imports jax)::

  python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from singa_tpu_torch.models.transformer import TransformerConfig, init_lm
from singa_tpu_torch.ops import paged_attention as pa
from singa_tpu_torch.serve import Engine, EngineConfig, Request, Scheduler

#: kernel vs plain in float32: the kernel folds keys by online softmax in
#: another order than the plain one-pass softmax, and expf differs from
#: torch's exp by a few ulps
TOL = dict(atol=1e-4, rtol=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


def make_case(dev, seed, *, s, nq, bl, d, max_len, pos0, overlay):
    rs = np.random.RandomState(seed)
    mb = max_len // bl
    nb = s * mb + 1

    def randn(*shape):
        return torch.from_numpy(
            rs.randn(*shape).astype(np.float32)
        ).to(dev)

    tables = (1 + rs.permutation(s * mb)).reshape(s, mb).astype(np.int32)
    positions = np.asarray(pos0)[:, None] + np.arange(nq)[None, :]
    case = {
        "q": randn(s, 2, nq, d),
        "k_pool": randn(nb, 2, bl, d),
        "v_pool": randn(nb, 2, bl, d),
        "tables": torch.from_numpy(tables).to(dev),
        "positions": torch.from_numpy(positions.astype(np.int32)).to(dev),
    }
    if overlay:
        valid = (rs.rand(s, nq) < 0.7).astype(np.int32)
        valid[:, 0] = 1
        valid[-1] = 0              # a dead row
        case["chunk_k"] = randn(s, 2, nq, d)
        case["chunk_v"] = randn(s, 2, nq, d)
        case["chunk_valid"] = torch.from_numpy(valid).to(dev)
    return case


@pytest.mark.parametrize("overlay", [False, True])
@pytest.mark.parametrize("bl,d,nq", [(16, 128, 1), (8, 64, 5), (5, 64, 40),
                                     (16, 128, 64)])
def test_kernel_matches_plain(cuda_device, overlay, bl, d, nq):
    pos0 = [0, 37, 400, 1]
    case = make_case(cuda_device, bl * d + nq, s=4, nq=nq, bl=bl, d=d,
                     max_len=480, pos0=pos0, overlay=overlay)
    fn, plain = (
        (pa.paged_attention_overlay, pa.paged_attention_overlay_plain)
        if overlay else (pa.paged_attention, pa.paged_attention_plain)
    )
    before = fn.launches
    got = fn(**case)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    torch.testing.assert_close(got, plain(**case), **TOL)


def test_wrapper_refuses_what_the_kernel_cannot_take(cuda_device):
    case = make_case(cuda_device, 0, s=2, nq=1, bl=16, d=128, max_len=64,
                     pos0=[3, 9], overlay=False)
    bad = [
        (TypeError, dict(case, q=case["q"].double())),
        (TypeError, dict(case, tables=case["tables"].long())),
        (ValueError, dict(case, q=case["q"].transpose(0, 1).contiguous()
                          .transpose(0, 1))),
        (ValueError, dict(case, positions=case["positions"].cpu())),
    ]
    narrow = make_case(cuda_device, 1, s=2, nq=1, bl=16, d=16, max_len=64,
                       pos0=[3, 9], overlay=False)
    bad.append((ValueError, narrow))
    before = pa.paged_attention.launches
    for exc, args in bad:
        with pytest.raises(exc):
            pa.paged_attention(**args)
    assert pa.paged_attention.launches == before


def _streams(dev, impl, spec_k=0):
    cfg = TransformerConfig(vocab=64, d_model=128, n_heads=2, n_layers=2,
                            d_ff=128, max_len=128)
    params = init_lm(torch.Generator().manual_seed(0), cfg, dev)
    eng = Engine(params, cfg, EngineConfig(
        slots=3, kv_block_len=8, max_prefill_chunk=16, spec_k=spec_k,
        attend_impl=impl,
    ), device=dev)
    sched = Scheduler(eng)
    rs = np.random.RandomState(1)
    for i in range(5):
        motif = rs.randint(0, 64, size=(3,))
        prompt = np.tile(motif, 12)[:int(rs.randint(5, 36))]
        sched.submit(Request(rid=i, prompt=prompt, max_new_tokens=20))
    before = (pa.paged_attention.launches,
              pa.paged_attention_overlay.launches)
    sched.serve()
    launches = (pa.paged_attention.launches - before[0],
                pa.paged_attention_overlay.launches - before[1])
    return sched, {r.rid: r.tokens for r in sched.finished}, launches


def test_engine_streams_through_the_kernel_match_reference(cuda_device):
    sched, fused, launches = _streams(cuda_device, "fused")
    _, ref, ref_launches = _streams(cuda_device, "reference")
    assert fused == ref and len(fused) == 5
    assert launches == (2 * (sched.prefill_chunks + sched.decode_ticks), 0)
    assert ref_launches == (0, 0)


def test_speculative_streams_through_the_overlay_match(cuda_device):
    _, one, _ = _streams(cuda_device, "fused")
    sched, spec, launches = _streams(cuda_device, "fused", spec_k=4)
    assert spec == one
    assert sched.spec_accepted > 0
    assert launches == (2 * sched.prefill_chunks, 2 * sched.decode_ticks)
