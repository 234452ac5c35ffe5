"""The port's CUDA kernels on the card: the paged-attention kernel, the
flash-attention kernels (forward; the fused float32 backward; the bf16
dQ and dK/dV pair) and the gradient
ring's quant_acc, each held to its plain PyTorch version, their
wrappers' refusals and launch counts, the serving engine's streams
through the paged kernel, Trainer steps through the flash kernels, and
the 4-rank quantized ring on the card against the same ring on the CPU.

Every test here needs a GPU and skips without one (the kernel has no
CPU mode). The file imports neither jax nor singa_tpu, so it runs on a
machine that has only PyTorch and the CUDA toolkit, from the repository
root, without the suite's conftest (which imports jax)::

  python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import gc
import pathlib

import numpy as np
import pytest
import torch

from singa_tpu_torch.config import parse_model_config
from singa_tpu_torch.data.loader import synthetic_token_arrays, write_records
from singa_tpu_torch.models.transformer import TransformerConfig, init_lm
from singa_tpu_torch.ops import attention as ta
from singa_tpu_torch.ops import paged_attention as pa
from singa_tpu_torch.ops import quantized_collective as qc
from singa_tpu_torch.serve import Engine, EngineConfig, Request, Scheduler
from singa_tpu_torch.trainer import Trainer
from singa_tpu_torch.utils.graphs import Graphed

REPO = pathlib.Path(__file__).resolve().parent.parent

#: kernel vs plain in float32: the kernel folds keys by online softmax in
#: another order than the plain one-pass softmax, and expf differs from
#: torch's exp by a few ulps
TOL = dict(atol=1e-4, rtol=0)
#: flash kernel vs plain, relative to the largest |plain| value: float32
#: sums in another order (1e-4); bf16 outputs round once, 2^-8 relative
#: (2e-2)
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
FLASH_KERNELS = (ta.flash_fwd, ta.flash_bwd, ta.flash_bwd_dq,
                 ta.flash_bwd_dkv)
#: launches one forward and one backward add to FLASH_KERNELS' counts:
#: float32's backward is the fused kernel, bf16's the pair
FLASH_LAUNCHES = {torch.float32: [1, 1, 0, 0], torch.bfloat16: [1, 0, 1, 1]}


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


@pytest.mark.parametrize("overlay", [False, True])
def test_kernel_split_edges_and_repeat(cuda_device, overlay):
    """At the serving geometry (table width 128 blocks of 16) the wrapper
    splits the key range: sequences shorter than one split, more splits
    than live tiles and fully masked rows (position -1; the dead overlay
    row) still match the plain version, masked rows are exact zeros, and
    a second call gives bitwise-equal outputs."""
    nq = 5 if overlay else 1
    case = make_case(cuda_device, 3, s=4, nq=nq, bl=16, d=128,
                     max_len=2048, pos0=[0, 2, 2040, -1 if nq == 1 else 0],
                     overlay=overlay)
    fn, plain = (
        (pa.paged_attention_overlay, pa.paged_attention_overlay_plain)
        if overlay else (pa.paged_attention, pa.paged_attention_plain)
    )
    assert pa.launch_geometry(4, 2, nq, 128, 16, 132)[1] > 1
    got, again = fn(**case), fn(**case)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, plain(**case), **TOL)
    assert torch.equal(got, again)
    assert not got[-1].any()


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


def _flash_counts():
    return [fn.launches for fn in FLASH_KERNELS]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,s", [(2, 320), (3, 192)])
def test_flash_kernels_match_plain(cuda_device, dtype, d, causal, bh, s):
    """Each kernel against its plain version at S a multiple of 64 but
    not of 128 (an odd count of 64-row tiles) and at an odd B*H, and
    every kernel deterministic: a second launch on the same inputs gives
    bitwise-equal outputs. The backward is flash_bwd: the fused kernel
    in float32, the dQ and dK/dV pair in bf16."""
    gen = torch.Generator().manual_seed(d + causal)
    q, k, v, do = [torch.randn(bh, s, d, generator=gen).to(cuda_device, dtype)
                   for _ in range(4)]
    before = _flash_counts()
    out, lse = ta.flash_fwd(q, k, v, causal)
    want_out, want_lse = ta.flash_fwd_plain(q, k, v, causal)
    delta = (do.float() * want_out.float()).sum(-1)
    got = [out, lse, *ta.flash_bwd(q, k, v, do, want_lse, delta, causal)]
    want = [want_out, want_lse,
            *ta.flash_bwd_plain(q, k, v, do, want_lse, delta, causal)]
    torch.cuda.synchronize()
    assert _flash_counts() == [
        n + m for n, m in zip(before, FLASH_LAUNCHES[dtype])]
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype, name
        scale = float(b.float().abs().max())
        err = float((a.float() - b.float()).abs().max())
        assert err <= FLASH_TOL[dtype] * scale, (name, err, scale)
    again = [*ta.flash_fwd(q, k, v, causal),
             *ta.flash_bwd(q, k, v, do, want_lse, delta, causal)]
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, again):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("bh,s,d,causal", [
    (3, 192, 128, True), (3, 192, 64, False), (2, 1088, 128, True),
    (5, 1088, 64, False),
])
def test_float32_forward_matches_plain_and_repeats_bitwise(cuda_device, bh,
                                                           s, d, causal):
    """The float32 forward (two key groups a block, merged in a fixed
    order) at an odd count of 64-row tiles (3, 17) and an odd B*H:
    against flash_fwd_plain (out at FLASH_TOL of its max, lse at 1e-4
    relative, clamped at 1: chip_smoke's LSE_TOL), and two launches on
    the same inputs bitwise equal."""
    gen = torch.Generator().manual_seed(bh * s + d + causal)
    q, k, v = [torch.randn(bh, s, d, generator=gen).to(cuda_device)
               for _ in range(3)]
    out, lse = ta.flash_fwd(q, k, v, causal)
    out2, lse2 = ta.flash_fwd(q, k, v, causal)
    want_out, want_lse = ta.flash_fwd_plain(q, k, v, causal)
    torch.cuda.synchronize()
    err = float((out - want_out).abs().max())
    assert err <= FLASH_TOL[torch.float32] * float(want_out.abs().max())
    assert float(((lse - want_lse).abs()
                  / want_lse.abs().clamp(min=1.0)).max()) <= 1e-4
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("bh,s,d,causal", [
    (3, 192, 128, True), (3, 192, 64, False), (2, 1024, 128, True),
    (2, 1024, 64, False), (1, 4096, 128, True),
])
def test_fused_backward_matches_plain_and_repeats_bitwise(cuda_device, bh, s,
                                                          d, causal):
    """The fused float32 backward against flash_bwd_plain (dQ, dK, dV at
    FLASH_TOL), its counters at their q tiles' contributor counts after
    the launch, every work tile claimed once by the resident grid, and
    two launches bitwise equal (dQ is summed over the key tiles in a
    fixed order, whatever order the blocks run in)."""
    gen = torch.Generator().manual_seed(bh * s + d + causal)
    q, k, v, do = [torch.randn(bh, s, d, generator=gen).to(cuda_device)
                   for _ in range(4)]
    out, lse = ta.flash_fwd_plain(q, k, v, causal)
    delta = (do * out).sum(-1)
    *got, scratch = ta.launch_flash_bwd(q, k, v, do, lse, delta, causal)
    again = ta.flash_bwd(q, k, v, do, lse, delta, causal)
    want = ta.flash_bwd_plain(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    for name, a, b, c in zip(("dq", "dk", "dv"), got, again, want):
        err = float((a - c).abs().max())
        assert err <= FLASH_TOL[torch.float32] * float(c.abs().max()), (
            name, err)
        assert torch.equal(a, b), name
    nt = s // ta.KERNEL_TILE
    head = scratch[:ta.BWD_SCRATCH_HEAD].cpu()
    blocks, ticket = int(head[4:6].view(torch.int64)), int(head[6])
    counters = scratch[ta.BWD_SCRATCH_HEAD:].view(bh, nt).cpu()
    want_ctr = (torch.arange(1, nt + 1) if causal
                else torch.full((nt,), nt)).expand(bh, nt)
    assert torch.equal(counters, want_ctr.to(torch.int32))
    assert blocks >= torch.cuda.get_device_properties(0).multi_processor_count
    assert ticket == bh * nt + blocks


def test_flash_wrappers_refuse_what_the_kernels_cannot_take(cuda_device):
    q = torch.randn(2, 256, 64, device=cuda_device)
    bad = [
        (q[..., :32].contiguous(),) * 3,            # head_dim 32
        (q[:, :200].contiguous(),) * 3,             # S not a multiple of 64
        (q.half(),) * 3,                            # float16
        (q.transpose(0, 1).contiguous().transpose(0, 1),) * 3,  # strided
    ]
    before = _flash_counts()
    for args in bad:
        with pytest.raises(ValueError):
            ta.flash_fwd(*args, True)
    with pytest.raises(ValueError):
        ta.flash_fwd(q, q.cpu(), q, True)
    # float32 has no pair kernel on the card: its backward is flash_bwd
    lse = torch.zeros(2, 256, device=cuda_device)
    for pair in (ta.flash_bwd_dq, ta.flash_bwd_dkv):
        with pytest.raises(ValueError, match="flash_bwd"):
            pair(q, q, q, q, lse, lse, True)
    assert _flash_counts() == before


def _train_conf(shard):
    """tinylm_longctx_d128.conf at S = 256, batch 2, d_model 128 (2 heads
    x 64), float32, through the flash kernels (SINGA_TPU_DENSE_ATTN_MB=0
    is set by the caller)."""
    txt = (REPO / "examples" / "lm" / "tinylm_longctx_d128.conf").read_text()
    for old, new in (("examples/lm/train_shard_8k", shard),
                     ("batchsize: 1", "batchsize: 2"),
                     ("embedding_dim: 256", "embedding_dim: 128"),
                     ("num_output: 1024", "num_output: 256"),
                     ("num_output: 256 }", "num_output: 128 }"),
                     ('compute_dtype: "bfloat16"', "")):
        txt = txt.replace(old, new)
    return parse_model_config(txt)


def test_trainer_steps_through_the_flash_kernels(cuda_device, tmp_path,
                                                monkeypatch):
    """2 Trainer steps on the card launch the float32 flash kernels (the
    forward and the fused backward) once per layer per step, and the bf16
    pair never, and their losses match 2 CPU steps (plain versions) from
    the same params within 1e-4."""
    shard = str(tmp_path / "shard")
    write_records(shard, *synthetic_token_arrays(4, seq_len=256, vocab=256))
    monkeypatch.setenv("SINGA_TPU_DENSE_ATTN_MB", "0")
    gpu = Trainer(_train_conf(shard), log=lambda s: None)
    cpu = Trainer(_train_conf(shard), log=lambda s: None, device="cpu")
    cpu.params = {n: v.cpu() for n, v in gpu.params.items()}
    before = _flash_counts()
    losses = []
    for tr in (gpu, cpu):
        for step in range(2):
            tr.train_one_batch(step)
            losses.append(tr.perf.avg()["loss"]["loss"])
            tr.perf.reset()
    assert _flash_counts() == [
        n + 2 * 2 * m for n, m in zip(before, FLASH_LAUNCHES[torch.float32])]
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses[:2], losses[2:], atol=1e-4)


@pytest.mark.parametrize("m", [1, 3, 64, 1000, 16384, 65536, 41088,
                               147648, 1 << 24])
def test_quant_acc_matches_plain_bitwise(cuda_device, m):
    """The kernel rounds the product and the sum separately, as the plain
    version does: out and the fused amax equal to the bit at every length
    (the ring's bucket chunks among them), the vector body and the scalar
    tail, aligned or not (offsets of one and of four elements)."""
    gen = torch.Generator().manual_seed(m)
    q = torch.randint(-127, 128, (m + 4,), generator=gen,
                      dtype=torch.int8).to(cuda_device)
    local = torch.randn(m + 4, generator=gen).to(cuda_device)
    scale = torch.tensor(0.0123, device=cuda_device)
    before = qc.quant_acc.launches
    for a, b in ((q[:m], local[:m]), (q[1:m + 1], local[1:m + 1]),
                 (q[4:], local[4:])):
        got = qc.quant_acc(a, scale, b)
        fused, amax = qc.quant_acc(a, scale, b, amax=True)
        torch.cuda.synchronize()
        want, want_max = qc.quant_acc_plain(a, scale, b, amax=True)
        assert torch.equal(got, want) and torch.equal(fused, want)
        assert amax.dtype == torch.float32 and amax.shape == ()
        assert torch.equal(amax, want_max)
    assert qc.quant_acc.launches == before + 6


def test_quant_acc_nan_scale_and_refusals(cuda_device):
    q = torch.zeros(1000, dtype=torch.int8, device=cuda_device)
    local = torch.randn(1000, device=cuda_device)
    nan = torch.tensor(float("nan"), device=cuda_device)
    assert bool(qc.quant_acc(q, nan, local).isnan().all())
    out, amax = qc.quant_acc(q, nan, local, amax=True)
    assert bool(out.isnan().all()) and bool(amax.isnan())
    local[500] = float("nan")
    half = torch.tensor(0.5, device=cuda_device)
    assert bool(qc.quant_acc(q, half, local, amax=True)[1].isnan())
    before = qc.quant_acc.launches
    strided = torch.zeros(1000, 2, dtype=torch.int8, device=cuda_device)[:, 0]
    with pytest.raises(ValueError, match="contiguous"):
        qc.quant_acc(strided, nan, local)
    with pytest.raises(ValueError, match="different devices"):
        qc.quant_acc(q, nan.cpu(), local)
    assert qc.quant_acc.launches == before


@pytest.mark.parametrize("hier", [None, (2, 2)])
def test_ring_on_the_card_equals_the_ring_on_the_cpu(cuda_device, hier):
    """4 ranks on the card and 4 on the CPU, the same partials and
    residual chunks: the same reduced grads and residuals to the bit, and
    one launch per rank, bucket and quantized reduce hop."""
    rs = np.random.RandomState(0)
    shapes = {"w": (256, 64), "b": (64,), "ln": (8, 4, 4)}
    grads = [{k: rs.randn(*v).astype(np.float32) for k, v in shapes.items()}
             for _ in range(4)]
    res = [{"r/" + k: (rs.randn(*v) * 1e-3).astype(np.float32)[:v[0] // 4]
            for k, v in shapes.items()} for _ in range(4)]
    outs = {}
    for dev in (cuda_device, torch.device("cpu")):
        before = qc.quant_acc.launches
        outs[dev.type] = qc.ring_reduce_gradients(
            [{k: torch.from_numpy(v).to(dev) for k, v in g.items()}
             for g in grads],
            [{k: torch.from_numpy(v.copy()).to(dev) for k, v in r.items()}
             for r in res],
            (("w",), ("b", "ln")), chunk_dims={k: 0 for k in shapes},
            residual_key=lambda k: "r/" + k, hier=hier,
        )
        hops = 3 if hier is None else 1
        want = 4 * 2 * hops if dev.type == "cuda" else 0  # 2 buckets
        assert qc.quant_acc.launches == before + want
    for got, ref in zip(outs["cuda"], outs["cpu"]):
        for r in range(4):
            for k, v in ref[r].items():
                assert torch.equal(got[r][k].cpu(), v), (r, k)


# ---------------------------------------------------------------------------
# host dispatch: the step and the engine's programs as CUDA graphs
# ---------------------------------------------------------------------------


def _mlp_conf(shard, updater=""):
    return parse_model_config(f"""
name: "graph-test"
train_steps: 12
updater {{ base_learning_rate: 0.1 momentum: 0.9 param_type: "Param"
          learning_rate_change_method: kStep gamma: 0.9
          learning_rate_change_frequency: 2 {updater} }}
neuralnet {{
  layer {{ name: "data" type: "kShardData"
          data_param {{ path: "{shard}" batchsize: 16 }} }}
  layer {{ name: "mnist" type: "kMnistImage" srclayers: "data"
          mnist_param {{ norm_a: 255 norm_b: 0 }} }}
  layer {{ name: "label" type: "kLabel" srclayers: "data" }}
  layer {{ name: "fc1" type: "kInnerProduct" srclayers: "mnist"
          inner_product_param {{ num_output: 64 }}
          param {{ name: "w" init_method: "kUniformSqrtFanIn" }}
          param {{ name: "b" init_method: "kConstant" value: 0 }} }}
  layer {{ name: "tanh" type: "kTanh" srclayers: "fc1" }}
  layer {{ name: "fc2" type: "kInnerProduct" srclayers: "tanh"
          inner_product_param {{ num_output: 10 }}
          param {{ name: "w" init_method: "kUniformSqrtFanIn" }}
          param {{ name: "b" init_method: "kConstant" value: 0 }} }}
  layer {{ name: "loss" type: "kSoftmaxLoss" srclayers: "fc2"
          srclayers: "label" softmaxloss_param {{ topk: 1 }} }}
}}
""")


def test_capture_keeps_the_garbage_collector_off(cuda_device):
    """Python's collector is off while a body is captured and on again
    after: a dead cycle holding an old graph, collected mid-capture,
    would destroy that graph there and invalidate the capture (the serve
    phase's second Engine hit this)."""
    x = torch.zeros(4, device=cuda_device)
    seen = []

    def body():
        x.add_(1)
        if torch.cuda.is_current_stream_capturing():
            seen.append(gc.isenabled())

    assert gc.isenabled()
    Graphed(body, cuda_device)(3)  # one eager step, a capture, 2 replays
    torch.cuda.synchronize()
    assert seen == [False] and gc.isenabled()
    assert float(x[0]) == 3


def test_graphed_chunk_equals_eager_steps_on_the_card(cuda_device,
                                                     tmp_path):
    """6 steps as replays of the captured step == 6 eager per-step steps
    on host batches, on the card: params and slots to the bit, and the
    graph was captured once and replayed."""
    from singa_tpu_torch.data.loader import synthetic_arrays

    shard = str(tmp_path / "shard")
    write_records(shard, *synthetic_arrays(40, seed=2))
    a = Trainer(_mlp_conf(shard), seed=3, log=lambda s: None)
    b = Trainer(_mlp_conf(shard), seed=3, log=lambda s: None, graphs=False,
                device_cache=False, prefetch=False)
    assert a.dispatch_mode == "graph"
    a.train_chunk(0, 6)
    for step in range(6):
        b.train_one_batch(step)
    torch.cuda.synchronize()
    assert a._g.run.captured and a._g.run.replays == 5
    for n, v in a.params.items():
        assert torch.equal(v, b.params[n]), n
        for slot, s in a.state[n].items():
            assert torch.equal(s, b.state[n][slot]), (n, slot)
    assert a.perf.avg() == b.perf.avg()


@pytest.mark.parametrize("schedule", [
    "kFixed", "kLinear", "kExponential", "kInverse_t", "kInverse", "kStep"])
def test_learning_rate_on_the_card_matches_the_host_float(cuda_device,
                                                          schedule):
    from singa_tpu_torch.optim import learning_rate

    extra = {
        "kFixed": "",
        "kLinear": "learning_rate_change_frequency: 10 "
                   "final_learning_rate: 0.01",
        "kExponential": "learning_rate_change_frequency: 3 "
                        "final_learning_rate: 0.05",
        "kInverse_t": "final_learning_rate: 0.05",
        "kInverse": "gamma: 0.1 pow: 0.75",
        "kStep": "gamma: 0.5 learning_rate_change_frequency: 2",
    }[schedule]
    cfg = parse_model_config(
        f'updater {{ type: "kSGD" base_learning_rate: 0.1 '
        f'learning_rate_change_method: "{schedule}" {extra} }}').updater
    steps = torch.arange(201, device=cuda_device)
    got = torch.stack([learning_rate(cfg, s) for s in steps]).cpu()
    want = torch.stack([learning_rate(cfg, s) for s in range(201)])
    assert torch.equal(got, want)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_engine_graphs_give_the_eager_streams(cuda_device, temperature):
    """decode and prefill replayed as graphs give the eager engine's
    streams (temperature slots included), and the kernel's launch count
    still equals layers x (prefill chunks + decode ticks)."""
    cfg = TransformerConfig(vocab=64, d_model=128, n_heads=2, n_layers=2,
                            d_ff=128, max_len=96)
    params = init_lm(torch.Generator().manual_seed(0), cfg, cuda_device)
    rs = np.random.RandomState(0)
    reqs = [(rs.randint(0, 64, size=(int(rs.randint(3, 40)),)),
             int(rs.randint(4, 30))) for _ in range(6)]
    out = []
    for graphs in (True, False):
        eng = Engine(params, cfg, EngineConfig(
            slots=3, kv_block_len=16, max_prefill_chunk=16,
        ), device=cuda_device, graphs=graphs)
        sched = Scheduler(eng)
        for i, (p, m) in enumerate(reqs):
            sched.submit(Request(rid=i, prompt=p.astype(np.int32),
                                 max_new_tokens=m, seed=i,
                                 temperature=temperature * (i % 2)))
        before = pa.paged_attention.launches
        sched.serve()
        assert pa.paged_attention.launches - before == cfg.n_layers * (
            sched.prefill_chunks + sched.decode_ticks)
        assert eng._decode_graph.captured == graphs
        out.append({r.rid: r.tokens for r in sched.finished})
    assert out[0] == out[1]


def _serve_lm(dev):
    cfg = TransformerConfig(vocab=64, d_model=128, n_heads=2, n_layers=2,
                            d_ff=128, max_len=96)
    return cfg, init_lm(torch.Generator().manual_seed(0), cfg, dev)


def test_flip_after_capture_serves_the_new_weights(cuda_device):
    """Both graphs are captured, then flip_params: the next decode tick's
    logits are the new weights' (an eager engine flipped at the same
    point), not the captured old ones'. A flip that rebound the params
    instead of writing them would leave the graphs replaying the old
    weights."""
    cfg, params = _serve_lm(cuda_device)
    new = init_lm(torch.Generator().manual_seed(1), cfg, cuda_device)
    prompt = np.arange(40, dtype=np.int32) % 64
    logits = {}
    for tag, graphs, flip in (("graphed", True, True), ("eager", False, True),
                              ("unflipped", True, False)):
        eng = Engine(params, cfg, EngineConfig(
            slots=2, kv_block_len=16, max_prefill_chunk=16,
        ), device=cuda_device, graphs=graphs)
        eng.admit(0, 60)
        for c0 in range(0, 40, 16):
            last = eng.prefill_chunk(0, prompt[c0:c0 + 16], c0)
        eng.activate(0, last, 40, seed=0)
        for _ in range(3):
            eng.decode()
        assert eng._decode_graph.captured == graphs
        assert eng._prefill_graph.captured == graphs
        if flip:
            eng.stage_params(new, 1)
            eng.flip_params()
        eng.decode()
        logits[tag] = eng._dec_logits[0].clone()
    torch.testing.assert_close(logits["graphed"], logits["eager"],
                               atol=1e-5, rtol=0)
    assert float((logits["graphed"] - logits["unflipped"]).abs().max()) > 1e-2


def test_fleet_weight_flip_under_captured_graphs(cuda_device):
    """A prefill and a decode host on the card serve a first wave
    (capturing both hosts' decode and prefill graphs), then a rollout
    controller ships, canaries and flips v1 into both through weight
    frames: the next wave's streams equal a fresh v1 engine's, and no
    graph was captured twice."""
    from singa_tpu_torch.serve.fleet import FleetHost, LocalTransport
    from singa_tpu_torch.serve.fleet import Router
    from singa_tpu_torch.serve.rollout import RolloutController

    cfg, params = _serve_lm(cuda_device)
    new = init_lm(torch.Generator().manual_seed(1), cfg, cuda_device)
    ec = EngineConfig(slots=2, kv_block_len=16, max_prefill_chunk=16,
                      attend_impl="fused")
    rs = np.random.RandomState(4)
    waves = [[rs.randint(0, 64, size=(int(n),)).astype(np.int32)
              for n in rs.randint(8, 40, size=3)] for _ in range(2)]
    t = LocalTransport()
    hosts = [FleetHost("p0", "prefill", Engine(params, cfg, ec,
                                               device=cuda_device), t,
                       peers={"d0": "decode"}),
             FleetHost("d0", "decode", Engine(params, cfg, ec,
                                              device=cuda_device), t,
                       peers={"p0": "prefill"})]
    router = Router(t)

    def serve(wave, base):
        for i, p in enumerate(wave):
            router.submit(Request(rid=base + i, prompt=p,
                                  max_new_tokens=12))
        for _ in range(2000):
            for h in hosts:
                h.tick()
            done = {r.rid for h in hosts for r in h.sched.finished}
            if all(base + i in done for i in range(len(wave))):
                break
        return {r.rid - base: list(r.tokens) for h in hosts
                for r in h.sched.finished if r.rid >= base}

    serve(waves[0], 0)
    graphs = [(h.engine._decode_graph, h.engine._prefill_graph)
              for h in hosts]
    assert hosts[0].engine._prefill_graph.captured
    assert hosts[1].engine._decode_graph.captured
    res = RolloutController(
        t, {"p0": "prefill", "d0": "decode"}, params=new, version=1,
        cfg=cfg, serving=ec, probes=2, probe_tokens=4,
        stage_timeout_s=120.0, device=cuda_device,
        tick=lambda: [h.tick() for h in hosts]).run()
    assert res["verdict"] == "promoted", res
    got = serve(waves[1], 100)
    fresh = Scheduler(Engine(new, cfg, ec, device=cuda_device))
    for i, p in enumerate(waves[1]):
        fresh.submit(Request(rid=i, prompt=p, max_new_tokens=12))
    fresh.serve()
    assert got == {r.rid: list(r.tokens) for r in fresh.finished}
    for h, (dg, pg) in zip(hosts, graphs):
        assert h.engine._decode_graph is dg and h.engine._prefill_graph is pg
        assert h.engine.params_version == 1


def test_hit_cow_import_and_reclaim_never_recapture(cuda_device):
    """Prefix hits, whole-prompt COWs, LRU reclaims in a small pool and
    an imported slot all run through the graphs captured once: each
    graph is captured one time, and the streams are the eager engine's."""
    cfg, params = _serve_lm(cuda_device)
    rs = np.random.RandomState(2)
    prefix = rs.randint(0, 64, size=(32,)).astype(np.int32)
    reqs = [np.concatenate([prefix, rs.randint(0, 64, size=(5,))])
            .astype(np.int32) for _ in range(6)] + [prefix, prefix]
    reqs += [rs.randint(0, 64, size=(30,)).astype(np.int32)
             for _ in range(4)]
    ec = EngineConfig(slots=3, kv_block_len=16, max_prefill_chunk=16,
                      kv_blocks=14, prefix_cache=True)
    out = []
    for graphs in (True, False):
        donor = Engine(params, cfg, ec, device=cuda_device, graphs=graphs)
        donor.admit(0, 40, prompt=prefix[:20])
        last = donor.prefill_chunk(0, prefix[:16], 0)
        last = donor.prefill_chunk(0, prefix[16:20], 16)
        donor.activate(0, last, 20, seed=0)
        donor.decode()
        eng = Engine(params, cfg, ec, device=cuda_device, graphs=graphs)
        sched = Scheduler(eng)
        for i, p in enumerate(reqs):
            sched.submit(Request(rid=i, prompt=p, max_new_tokens=8))
        while sched.busy and not eng._decode_graph.captured:
            sched.tick()
        graph = eng._decode_graph.graph
        sched.serve()
        # an imported slot decodes through the same graphs
        eng.import_slot(1, donor.export_slot(0))
        moved = [int(eng.decode()[1]) for _ in range(5)]
        assert sched.prefix_hits > 0 and sched.cow_copies >= 2
        assert eng.allocator.lru_reclaims + eng.allocator.lru_evictions > 0
        if graphs:
            assert eng._decode_graph.graph is graph is not None
            assert eng._decode_graph.eager_calls == 1
            assert eng._prefill_graph.eager_calls == 1
        out.append(({r.rid: r.tokens for r in sched.finished}, moved))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# BatchNorm's running stats and the RBM's draws on the card
# ---------------------------------------------------------------------------


def _bn_conf(shard):
    return parse_model_config(f"""
name: "bn-graph-test"
train_steps: 12
test_steps: 2
test_frequency: 6
updater {{ type: "kSGD" base_learning_rate: 0.05 momentum: 0.9
          learning_rate_change_method: kFixed }}
neuralnet {{
  layer {{ name: "data" type: "kShardData"
          data_param {{ path: "{shard}" batchsize: 16 }} }}
  layer {{ name: "mnist" type: "kMnistImage" srclayers: "data"
          mnist_param {{ norm_a: 255 norm_b: 0 }} }}
  layer {{ name: "label" type: "kLabel" srclayers: "data" }}
  layer {{ name: "conv" type: "kConvolution" srclayers: "mnist"
          convolution_param {{ num_filters: 8 kernel: 3 stride: 2 pad: 1
                              bias_term: false }}
          param {{ name: "weight" init_method: kGaussainSqrtFanIn }} }}
  layer {{ name: "bn" type: "kBatchNorm" srclayers: "conv" }}
  layer {{ name: "relu" type: "kReLU" srclayers: "bn" }}
  layer {{ name: "gap" type: "kGlobalPooling" srclayers: "relu" }}
  layer {{ name: "fc" type: "kInnerProduct" srclayers: "gap"
          inner_product_param {{ num_output: 10 }}
          param {{ name: "w" init_method: kGaussain std: 0.1 }}
          param {{ name: "b" init_method: kConstant value: 0 }} }}
  layer {{ name: "loss" type: "kSoftmaxLoss" srclayers: "fc"
          srclayers: "label" }}
}}
""")


def _bn_shard(tmp_path):
    from singa_tpu_torch.data.loader import synthetic_arrays

    shard = str(tmp_path / "shard")
    write_records(shard, *synthetic_arrays(48, seed=2))
    return shard


def test_batchnorm_graphed_chunk_equals_eager_steps_stats_included(
        cuda_device, tmp_path):
    """6 replayed steps of a net with BatchNorm == 6 eager steps on the
    card: params and running stats to the bit, the stats moved."""
    shard = _bn_shard(tmp_path)
    a = Trainer(_bn_conf(shard), seed=3, log=lambda s: None)
    b = Trainer(_bn_conf(shard), seed=3, log=lambda s: None, graphs=False,
                device_cache=False, prefetch=False)
    init = {k: v.clone() for k, v in a.buffers.items()}
    a.train_chunk(0, 6)
    for step in range(6):
        b.train_one_batch(step)
    torch.cuda.synchronize()
    assert a._g.run.captured and a._g.run.replays == 5
    for n, v in a.params.items():
        assert torch.equal(v, b.params[n]), n
    for k, v in a.buffers.items():
        assert torch.equal(v, b.buffers[k]), k
        assert not torch.equal(v, init[k]), k


def test_batchnorm_graphed_eval_reads_the_stats_of_eager_steps(cuda_device,
                                                              tmp_path):
    """A captured eval, then eager steps on the same trainer: the stats
    are updated in place, so the replayed eval reads them and gives the
    metrics of an eager trainer that took the same steps."""
    shard = _bn_shard(tmp_path)
    a = Trainer(_bn_conf(shard), seed=3, log=lambda s: None)
    b = Trainer(_bn_conf(shard), seed=3, log=lambda s: None, graphs=False,
                device_cache=False, prefetch=False)
    a.evaluate(a.test_net, 2, "test", 0)
    a.evaluate(a.test_net, 2, "test", 0)
    (eg,) = a._eval_g.values()
    assert eg.run.captured
    for step in range(3):
        a._step_core(step, a._next_batch(a.train_net))
        b.train_one_batch(step)
    for pipe in a._pipelines[id(a.test_net)].values():
        pipe.seek(0)
    got = a.evaluate(a.test_net, 2, "test", 3)
    want = b.evaluate(b.test_net, 2, "test", 3)
    assert got == want


def _bn_inputs():
    """The ops test's inputs: x near 2 (well conditioned), gamma, beta,
    dy, and the offset case's x = 1e3 + 1e-2 N(0, 1): |mean| / std near
    1e5, the cancellation the rescue exists for."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(16, 8, 7, 7, generator=gen) + 2.0
    dy = torch.randn(16, 8, 7, 7, generator=gen)
    gamma = 1 + 0.3 * torch.randn(8, generator=gen)
    beta = 0.2 * torch.randn(8, generator=gen)
    offset = torch.randn(16, 8, 7, 7, generator=gen) * 1e-2 + 1e3
    return x, dy, gamma, beta, offset


def bn_outputs(x, gamma, beta, dy, dev, shift=None):
    """(y, mean, var, dx, dgamma, dbeta) of the port's training op on
    ``dev``, as float64 CPU tensors."""
    from singa_tpu_torch.ops import norm

    xt = x.to(dev).requires_grad_(True)
    g = gamma.to(dev).requires_grad_(True)
    b = beta.to(dev).requires_grad_(True)
    y, mean, var = norm.batch_norm_train(
        xt, g, b, 1e-5, shift=None if shift is None else shift.to(dev))
    grads = torch.autograd.grad(y, (xt, g, b), dy.to(dev))
    return [t.detach().cpu().double() for t in (y, mean, var, *grads)]


def _bn_float64(x, gamma, beta, dy, eps, mean_shift=0.0):
    """The JAX formula (two-pass moments, _bn_bwd) in float64 on the
    float32 inputs, with the mean moved by ``mean_shift``."""
    x, gamma, beta, dy = (t.double() for t in (x, gamma, beta, dy))
    axes, shape = (0, 2, 3), (1, -1, 1, 1)
    n = x.numel() // x.shape[1]
    mean = x.mean(axes) + mean_shift
    xc = x - mean.reshape(shape)
    var = (xc * xc).mean(axes)
    inv = torch.rsqrt(var + eps)
    xhat = xc * inv.reshape(shape)
    y = gamma.reshape(shape) * xhat + beta.reshape(shape)
    dbeta = dy.sum(axes)
    dgamma = (dy * xhat).sum(axes)
    dx = (gamma * inv).reshape(shape) * (
        dy - dbeta.reshape(shape) / n - xhat * dgamma.reshape(shape) / n)
    return [y, mean, var, dx, dgamma, dbeta], inv


def bn_float64_bounds(x, gamma, beta, dy, eps=1e-5):
    """-> (float64 outputs, a bound on each float32 output's error).

    Derived from float32's unit roundoff u = 2^-24, max|x| and
    max|gamma * inv| alone, before any run on the card. A float32 sum of
    n terms in any tree order is off by at most ceil(log2 n) u of the
    sum of |terms| (each level rounds once), and subtracting the mean
    from x rounds once more at |x|: the per-channel mean, and so
    x - mean, is off by at most d0 = K u max|x| with K = ceil(log2 n) +
    6 (six more roundings: the division by n, the variance's sum, the
    rsqrt, gamma * inv, the fused y = x * scale + shift and its shift).
    To first order that error moves each output as moving the mean by
    d0 moves the float64 formula; the outputs y and dx also carry the
    fused form's own rounding, K u max|x| max|gamma * inv| (x * scale
    and shift = beta - scale * mean are each near |x| max|gamma * inv|
    before they cancel), and every output K u of its own magnitude. So
    bound = max over +-d0 of |F64(mean + -d0) - F64| + K u max|out|
    (+ K u max|x| max|gamma * inv| for y and dx)."""
    n = x.numel() // x.shape[1]
    u = 2.0 ** -24
    k = int(np.ceil(np.log2(n))) + 6
    d0 = k * u * float(x.abs().max())
    ref, inv = _bn_float64(x, gamma, beta, dy, eps)
    fused = d0 * float((gamma.double() * inv).abs().max())
    bounds = []
    for i, out in enumerate(ref):
        moved = max(float((_bn_float64(x, gamma, beta, dy, eps, s)[0][i]
                           - out).abs().max()) for s in (d0, -d0))
        extra = fused if i in (0, 3) else 0.0
        bounds.append(moved + k * u * float(out.abs().max()) + extra)
    return ref, bounds


BN_OUTPUTS = ("y", "mean", "var", "dx", "dgamma", "dbeta")


def test_batchnorm_ops_on_the_card_match_the_cpu(cuda_device):
    """The training op (forward, grads of x, gamma and beta), unanchored
    and anchored: card vs CPU within 1e-5. The offset case (x near 1e3,
    std 1e-2, the rescued variance) is float32's conditioning, not the
    port's: there each device is held to the float64 formula within
    ``bn_float64_bounds`` (derived from u, max|x| and max|gamma * inv|;
    the CPU with RESCUE off breaks it, tests/test_torch_norm.py). Prints
    each device's error against float64 and the per-channel mean bits."""
    x, dy, gamma, beta, offset = _bn_inputs()
    for xin, shift in ((x, None), (x, torch.full((8,), 2.0))):
        cpu = bn_outputs(xin, gamma, beta, dy, "cpu", shift)
        card = bn_outputs(xin, gamma, beta, dy, cuda_device, shift)
        for got, want in zip(card, cpu):
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    ref, bounds = bn_float64_bounds(offset, gamma, beta, dy)
    for dev in ("cpu", cuda_device):
        outs = bn_outputs(offset, gamma, beta, dy, dev)
        errs = [float((o - r).abs().max()) for o, r in zip(outs, ref)]
        print(f"bn offset {dev}: " + ", ".join(
            f"{n} {e:.3e} (bound {b:.3e})"
            for n, e, b in zip(BN_OUTPUTS, errs, bounds)))
        print(f"bn offset {dev}: mean bits " + " ".join(
            float(m).hex() for m in outs[1].float()))
        for name, e, b in zip(BN_OUTPUTS, errs, bounds):
            assert e <= b, (dev, name, e, b)


def test_rbm_draws_on_the_card_repeat_from_the_seed(cuda_device):
    from singa_tpu_torch.layers.rbm import bernoulli

    p = torch.rand(256, 512, device=cuda_device)
    a = bernoulli(torch.Generator().manual_seed(5), p)
    b = bernoulli(torch.Generator().manual_seed(5), p)
    c = bernoulli(torch.Generator().manual_seed(6), p)
    assert a.device.type == "cuda"
    assert torch.equal(a, b) and not torch.equal(a, c)


def _poison_lm_conf(shard, extra=""):
    """A one-block LM (vocab 64, d 32) under kSkip over ``shard``."""
    return parse_model_config(f"""
name: "guard-test"
train_steps: 6
{extra}
updater {{ type: kSGD momentum: 0.9 base_learning_rate: 0.05
           param_type: "Param" }}
neuralnet {{
  layer {{ name: "data" type: "kSequenceData"
    data_param {{ path: "{shard}" batchsize: 8 }} }}
  layer {{ name: "embed" type: "kEmbedding" srclayers: "data"
    embedding_param {{ vocab_size: 64 embedding_dim: 32 }}
    param {{ name: "tok" init_method: "kGaussain" std: 0.5 }}
    param {{ name: "pos" init_method: "kGaussain" std: 0.5 }} }}
  layer {{ name: "attn" type: "kAttention" srclayers: "embed"
    attention_param {{ num_heads: 2 mode: "flash" }}
    param {{ name: "qkv" init_method: "kUniformSqrtFanIn" }}
    param {{ name: "out" init_method: "kUniformSqrtFanIn" }} }}
  layer {{ name: "head" type: "kDense" srclayers: "attn"
    dense_param {{ num_output: 64 bias_term: false }}
    param {{ name: "weight" init_method: "kGaussain" std: 0.3 }} }}
  layer {{ name: "loss" type: "kLMLoss" srclayers: "head" srclayers: "data" }}
}}
resilience {{ guard_policy: kSkip }}
""")


def _state_bytes(tr) -> dict:
    out = {("p", n): v.cpu().numpy().tobytes() for n, v in tr.params.items()}
    out.update({("s", n, s): v.cpu().numpy().tobytes()
                for n, slots in tr.state.items() for s, v in slots.items()})
    return out


def test_guarded_graph_drops_the_bad_step_like_eager(cuda_device, tmp_path):
    """A poison token (its table row NaN) read by step 3 only: inside the
    captured graph the verdict drops that step to the bit, and the graphed
    run equals the eager run to the bit."""
    toks, labels = synthetic_token_arrays(48, seq_len=64, vocab=63)
    toks[3 * 8 + 2, 9] = 63
    shard = str(tmp_path / "tok")
    write_records(shard, toks, labels)
    runs = []
    for graphs in (None, False):
        tr = Trainer(_poison_lm_conf(shard), seed=0, log=lambda s: None,
                     graphs=graphs)
        with torch.no_grad():
            tr.params["embed/tok"][63] = float("nan")
        snaps = []
        for step in range(6):
            tr.train_one_batch(step)
            snaps.append(_state_bytes(tr))
        torch.cuda.synchronize()
        assert tr.guard_counters()["bad_steps"] == 1
        runs.append((tr.dispatch_mode, snaps))
    (mode, graphed), (_, eager) = runs
    assert mode == "graph"
    assert graphed[3] == graphed[2] and graphed[4] != graphed[3]
    assert graphed == eager


def test_async_snapshot_is_ordered_before_the_next_replays(cuda_device,
                                                          tmp_path):
    """An async save at step 4, then graph replays enqueued at once (they
    overwrite the live tensors): the save holds step 4's params and slots,
    those of a second run stopped there."""
    from singa_tpu_torch.config.schema import ClusterConfig
    from singa_tpu_torch.data.loader import synthetic_arrays
    from singa_tpu_torch.resilience import FaultPlan, ResilienceContext
    from singa_tpu_torch.trainer import load_checkpoint

    shard = str(tmp_path / "shard")
    write_records(shard, *synthetic_arrays(64, seed=2))
    cfg = _mlp_conf(shard)
    cfg.resilience = parse_model_config(
        "resilience { async_checkpoint: true }").resilience
    cl = ClusterConfig()
    cl.workspace = str(tmp_path / "ws")
    a = Trainer(cfg, cl, seed=3, log=lambda s: None)
    ctx = ResilienceContext(cfg.resilience, FaultPlan(), log=lambda s: None)
    ctx.bind(a)
    try:
        a.train_chunk(0, 4)
        a.save(4)
        a.train_chunk(4, 6)
        ctx.flush_async()
    finally:
        ctx.stop()
    b = Trainer(_mlp_conf(shard), seed=3, log=lambda s: None)
    b.train_chunk(0, 4)
    _, params, state, _ = load_checkpoint(
        str(tmp_path / "ws" / "checkpoints" / "step_4.npz"))
    for n, v in b.params.items():
        assert np.array_equal(params[n], v.cpu().numpy()), n
        for slot, s in b.state[n].items():
            assert np.array_equal(state[n][slot], s.cpu().numpy())
        assert not torch.equal(v, a.params[n]), n


def test_mesh_engine_graphs_each_rank_over_its_pools(cuda_device):
    """Engine(mesh=build_mesh(1, 2)) with both ranks on the card: decode
    and prefill captured as graphs over both ranks, the kernel launched
    ranks x layers x (prefill chunks + decode ticks) times, and the
    streams equal to the unsharded engine's."""
    from singa_tpu_torch.parallel import build_mesh

    cfg, params = _serve_lm(cuda_device)
    rs = np.random.RandomState(1)
    reqs = [(rs.randint(0, 64, size=(int(rs.randint(3, 40)),)),
             int(rs.randint(4, 30))) for _ in range(6)]
    out = []
    for mesh in (None, build_mesh(1, 2, [cuda_device] * 2)):
        eng = Engine(params, cfg, EngineConfig(
            slots=3, kv_block_len=16, max_prefill_chunk=16,
        ), device=cuda_device, mesh=mesh)
        sched = Scheduler(eng)
        for i, (p, m) in enumerate(reqs):
            sched.submit(Request(rid=i, prompt=p.astype(np.int32),
                                 max_new_tokens=m))
        before = pa.paged_attention.launches
        sched.serve()
        ranks = 1 if mesh is None else 2
        assert pa.paged_attention.launches - before == ranks * cfg.n_layers \
            * (sched.prefill_chunks + sched.decode_ticks)
        assert eng._decode_graph.captured and eng._prefill_graph.captured
        assert eng.dispatch_reason == ""
        out.append({r.rid: r.tokens for r in sched.finished})
    assert out[0] == out[1]


def test_replica_lanes_attend_their_heads(cuda_device, tmp_path,
                                          monkeypatch):
    """Two replicas of two model ranks (kLayerPartition) on the card
    through the flash kernels: each kernel of the float32 route launched
    lanes x attention layers x steps times (a lane's heads meet on one
    device and attend at once), finite losses."""
    from singa_tpu_torch.parallel import build_mesh
    from singa_tpu_torch.trainer import ReplicaTrainer

    shard = str(tmp_path / "shard")
    write_records(shard, *synthetic_token_arrays(16, seq_len=256,
                                                 vocab=256))
    monkeypatch.setenv("SINGA_TPU_DENSE_ATTN_MB", "0")
    cfg = _train_conf(shard)
    cfg.neuralnet.partition_type = "kLayerPartition"
    cfg.updater.param_type = "Elastic"
    cfg.updater.moving_rate = 0.5
    cfg.updater.sync_frequency = 2
    cfg.updater.warmup_steps = 1
    tr = ReplicaTrainer(cfg, mesh=build_mesh(2, 2, [cuda_device] * 4),
                        seed=0, log=lambda s: None)
    layers = sum(l.TYPE == "kAttention" for l in tr.train_net.layers)
    before = _flash_counts()
    losses = []
    for step in range(4):
        tr.train_one_batch(step)
        losses.append(tr.perf.avg()["loss"]["loss"])
        tr.perf.reset()
    assert _flash_counts() == [n + 2 * layers * 4 * m for n, m in zip(
        before, FLASH_LAUNCHES[torch.float32])]
    assert np.isfinite(losses).all()
