"""Chip smoke test of the PyTorch port (``singa_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port builds, is right, serves
and trains on the card.

Run from the repository root, with no arguments::

  python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero; nothing is
caught and carried on):

  1. env     the card's name and power limit (nvidia-smi), torch and CUDA
             versions, and the nvcc build of every kernel in
             singa_tpu_torch/csrc/ (one nvcc per source, started together),
             with ptxas's register and spill lines; the flash kernels
             (flash_attention.cu, flash_attention_bf16.cu) and the paged
             kernel (paged_attention.cu) must report no spills.
  2. kernel  the paged-attention kernel, both forms, against its plain
             PyTorch version on the card: decode (S=8, Q=1), prefill
             (S=1, Q=64) and overlay/verify (S=8, Q=5) at head_dim 128 and
             64, block_len 16 and 8, ragged fills with fully-masked rows;
             then the key-range split's edge cases at the serve geometry
             (sequences shorter than one split, more splits than live
             tiles, a prefill chunk from position 0, the position -1 row
             and the dead overlay row, both exact zeros), each form
             launched twice on the same inputs (bitwise equal), and the
             thread blocks of a decode call (at least one per SM).
             Times (CUDA events, L2 flushed before each launch) of the
             kernel (a wrapper call: the split kernel and its combine),
             the plain version and, as a yardstick the port never calls,
             F.scaled_dot_product_attention on the gathered dense view;
             the bound is the larger of modeled bytes / 3.35 TB/s and
             operations / 67 TFLOP/s (f32 without tensor cores).
  3. serve   the d128 LM (vocab 256, d_model 256, 2 heads x 128, 2 layers,
             d_ff 1024, max_len 2048, seeded init_lm) behind Engine +
             Scheduler (8 slots, kv_block_len 16, prefill chunk 64): 16
             greedy requests, ragged prompts of 32-1024 tokens, 64 new
             tokens each, through the kernel ("fused") and through gather +
             cache_attend ("reference") in turns: fused, reference,
             reference, fused. Streams must be identical, the kernel's
             launches must equal layers x (prefill chunks + decode ticks),
             and one stream must equal the sequential ``generate`` oracle.
  4. spec    speculative decode (spec_k 4) on the repeat workload (8
             requests, prompt 64, 64 new tokens) against one-token ticks,
             in turns: streams identical, the overlay form launched.
  5. flash   the flash-attention kernels of each type (FLASH_ROUTES:
             bf16, on the tensor cores in csrc/flash_attention_bf16.cu,
             the forward and the dQ and dK/dV pair; float32, on the CUDA
             cores in csrc/flash_attention.cu, the forward and the fused
             backward) against their plain PyTorch versions on the card:
             B*H in {2, 8}, S in {256, 1024, 8192}, head_dim 64 and 128,
             causal and not, float32 and bfloat16, plus S=32768 causal
             bf16 head_dim 128, B*H 3 at S=192 (S a multiple of 64 but
             not of 128) in both types; the forward's lse is held to the
             plain version's at LSE_TOL at every shape (the backward reads
             it); the float32 forward and the fused backward, each
             launched twice, must give bitwise-equal outputs at every
             float32 shape (the forward's key groups merge in a fixed
             order; the backward's dQ is summed across blocks in one), and
             every kernel at the training shape; the float32 forward's
             resident blocks an SM (the occupancy query through its
             library) are printed. Times at the training shape (B=1, H=2,
             S=8192, D=128, causal) in bf16 and in float32 of each kernel,
             its plain version and, as a yardstick the port never calls,
             F.scaled_dot_product_attention forward and its autograd
             backward (float32 with TF32 off), with each kernel's achieved
             TFLOP/s, the forward's ratio to SDPA's forward and the
             backward's (the bf16 pair's sum, the fused float32 kernel) to
             SDPA's backward, and the share of the fused kernel's block
             time that its blocks spent polling the dQ counters; the bound
             is the larger of bytes / 3.35 TB/s and operations / 989
             TFLOP/s (bf16) or 67 TFLOP/s (float32).
  6. train   the port's Trainer on examples/lm/tinylm_longctx_d128.conf
             (full width, read by the port's load_model_config) over a
             shard of 32 synthetic 8192-token sequences: at float32, 8
             steps through the flash kernels and 8 through dense
             attention, in turns (flash, dense, dense, flash) from the
             same initial params, losses agreeing (and whether they
             agree to the bit, printed) and launches = layers x
             steps of the float32 route's kernels (the forward and the
             fused backward; 0 of the bf16 pair, 0 on dense); the same
             comparison failing on each
             gradient fault of FAULTS planted in the flash backward; then
             the conf as written (bf16) for 30 steps: finite losses, the
             last below the first, step ms (host clock to a device sync
             after each step) and tokens/s, and 3 more steps under
             torch.profiler (wall and device ms per step of that window,
             its idle share, the largest kernels).
  7. ring    the quant_acc kernel (the int8 gradient ring's per-hop
             dequantize + accumulate over a flat bucket row, with the next
             hop's max-abs from the same pass, csrc/quant_acc.cu) against
             its plain version, out and amax bitwise, at m in RING_SIZES
             (the bucket chunks among them), on row 1 of a ragged (4,
             1001) tensor, with a NaN partial and a NaN scale; times with
             and without amax at m = 147648 (the path's largest bucket
             chunk), 65536 and 2^24 of the kernel, its plain version and,
             as a yardstick the port never calls, torch.addcmul; the bound
             is (9 m + 4) bytes / 3.35 TB/s (+ 4 with amax). Then
             examples/lm/tinylm_d128.conf with the q8wire tag and 4
             buckets (as bench.py's lm_d128_q8wire row builds it) over 256
             synthetic 128-token
             sequences, on 4 ranks of one card: the ring alone
             (_ring_reduce_probe) on the global gradient of one step,
             within 3.5 bucket scales of it, bitwise the same on every
             rank and equal to the same probe on the CPU, with four
             planted ring faults each breaking that bar; float32, 8 steps
             in turns (ring, reference q8, reference q8, ring), losses
             within RING_TOL and 48 quant_acc launches per ring step
             (ranks x buckets x hops); then bf16 as written, 30 steps each
             of the flat ring (48 launches per step), q8hier (16) and
             exact data parallel (0): finite falling losses, step ms,
             tokens/s, 3 more flat-ring steps under torch.profiler, and
             the probe's host time as a share of the ring step; last, the
             flat ring with the next hop's max-abs fused into quant_acc
             and without it (a pass of its own per scale) on one trainer:
             the probe's outputs equal to the bit, then 10 pairs in
             alternating order of the probe's host ms and the median of
             5 synced steps.
  8. nets    the reference's MNIST and CIFAR nets through the port's
             Trainer, each conf as written (examples/mnist/mlp.conf,
             batch 1000; conv.conf, LeNet, batch 64;
             examples/cifar10/alexnet.conf, batch 100, crop 28;
             autoencoder.conf, batch 100, its pretrained params drawn
             from the seed) on synthetic shards (synthetic_arrays;
             structured_rgb and its compute_mean mean file for CIFAR):
             first the tie-sharing max-pool backward and the k² average
             at AlexNet's pool1 shape on inputs full of ties, card vs
             CPU, with a planted fault for each (PyTorch's single-winner
             backward; its ceil_mode average) that must fail the same
             check; then per net 5 float32 steps on the card and on the
             CPU from the same seed-0 params (losses within NETS_TOL),
             30 more on the card (finite, falling; step ms median,
             images/s), one test batch, and 3 steps under
             torch.profiler (device ms per step, idle share, the 5
             largest kernels); for mlp the bound, its operations over
             67 TFLOP/s. No kernel of csrc/ lies on this path.
  9. dispatch host dispatch (the device-resident dataset, multi-step
             chunks, the step and the engine's decode and prefill as
             CUDA graphs): the four image confs as written (float32) on
             full-size synthetic shards (60000 MNIST-shaped records, the
             real training set's size; 50000 CIFAR-shaped, CIFAR-10's)
             and train_longctx as written (bf16, S 8192): 30 steps as
             graphed chunks (windows of 10 through Trainer.train_chunk)
             against 30 eager per-step steps on host batches from the
             same params, window losses within DISPATCH_TOL; under
             graphs the flash kernels' launch counts equal layers x
             steps (each replay adds its capture's counts); step ms of
             a 30-step graphed chunk and of 30 eager steps (synced at
             the end), images/s or tokens/s, the graphed chunk's device
             ms by CUDA events (unprofiled) and its idle share, and its
             largest device rows; two planted faults of a replayed step
             (the step counter frozen, on LeNet; the update not copied
             back into the static params, on mlp), each of which must
             move the losses past DISPATCH_TOL by 100x; one decode
             engine call split into host, ATen and kernel ms, eager and
             graphed; the 16-request serve workload with graphs and
             without, in turns (graph, eager, eager, graph): streams
             identical, tokens/s.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from singa_tpu_torch import _build
from singa_tpu_torch.config import load_model_config
from singa_tpu_torch.data.loader import (
    compute_mean,
    structured_rgb,
    synthetic_arrays,
    synthetic_token_arrays,
    write_records,
)
from singa_tpu_torch.device import resolve_device
from singa_tpu_torch.models.transformer import (
    TransformerConfig,
    generate,
    init_lm,
    lm_apply,
)
from singa_tpu_torch.ops import attention as ta
from singa_tpu_torch.ops import nn as tnn
from singa_tpu_torch.ops import paged_attention as pa
from singa_tpu_torch.ops import quantized_collective as qc
from singa_tpu_torch.parallel import apply_grad_comm_tag, build_mesh
from singa_tpu_torch.serve import Engine, EngineConfig, Request, Scheduler
from singa_tpu_torch.tools.serve_bench import _percentile
from singa_tpu_torch.trainer import Trainer

#: kernel vs plain, float32 on the card: online softmax folds the keys in
#: another order than the plain one-pass softmax (up to 2048 keys), and
#: the kernel's expf and the plain exp differ by a few ulps
TOL = 1e-4
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM data sheet, f32 without tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM data sheet, bf16 tensor cores, dense
SOURCE = "singa_tpu_torch/csrc/paged_attention.cu"
REPLACES = "singa_tpu/ops/paged_attention.py:121"
TRAIN_CONF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "examples", "lm", "tinylm_longctx_d128.conf")
#: each flash kernel's wrapper, the Pallas kernel it replaces (the staged
#: body; the streamed one is the same function), and its matrix products
#: per visible (q, k) pair, 2*D operations each. flash_bwd is the fused
#: float32 backward: it replaces both backward kernels (:419 and :451)
FLASH = {
    "flash_fwd": (ta.flash_fwd, "singa_tpu/ops/attention.py:386", 2),
    "flash_bwd_dq": (ta.flash_bwd_dq, "singa_tpu/ops/attention.py:419", 3),
    "flash_bwd_dkv": (ta.flash_bwd_dkv, "singa_tpu/ops/attention.py:451", 4),
    "flash_bwd": (ta.flash_bwd, "singa_tpu/ops/attention.py:419", 5),
}
#: the kernels each type runs on the card
FLASH_ROUTES = ta.KERNEL_NAMES
#: flash kernel vs plain, as max |kernel - plain| / max |plain| per
#: output: float32 sums the same products in another order (7.3e-6 at
#: worst on an H100, over 8192-term rows); bf16 outputs are rounded once
#: to 8 bits of mantissa, 2^-8 = 3.9e-3 relative, so 2e-2 allows a few
#: roundings
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: the forward's lse vs plain, |err| / max(1, |lse|) per row: both are
#: float32 m + log(l) over the same float32 scores, summed in other
#: orders, with ex2.approx on the tensor-core path (~2 ulp); a wrong exp
#: base or scale moves it by O(1), which the backward (P = exp(S * scale -
#: lse)) would turn into wrong gradients
LSE_TOL = 1e-4
#: flash vs dense training losses at float32 over 8 steps. The kernels and
#: cuBLAS sum attention in different orders (~1e-6 relative per call);
#: on an H100 the sound runs' losses came out equal (0.0), and 1e-5 is
#: ~20 float32 ulps of a loss near 5.5. Step 0's loss comes before any
#: update, so a gradient fault shows from step 1 on: the smallest of
#: FAULTS (dK zeroed) moved the step-1 loss by 6.2e-3 on an H100, over
#: 600x this limit
TRAIN_TOL = 1e-5
#: gradient faults planted in the flash backward, each of which the
#: flash vs dense comparison must catch: name -> what is done to the
#: backward's (dQ, dK, dV)
FAULTS = {
    "dK zeroed": lambda dq, dk, dv: (dq, torch.zeros_like(dk), dv),
    "dV zeroed": lambda dq, dk, dv: (dq, dk, torch.zeros_like(dv)),
    "dQ unscaled": lambda dq, dk, dv: (dq * dq.shape[-1] ** 0.5, dk, dv),
}
#: (B*H, S, D, causal, dtype) of every kernel-vs-plain check, and the
#: training shape the kernels are timed at (B=1, H=2, S=8192, D=128)
FLASH_SHAPES = [
    (bh, s, d, causal, dtype)
    for dtype in (torch.float32, torch.bfloat16)
    for bh in (2, 8) for s in (256, 1024, 8192) for d in (64, 128)
    for causal in (False, True)
] + [(2, 32768, 128, True, torch.bfloat16),   # the TPU's streamed regime
      # S a multiple of 64 but not 128 and an odd B*H: an odd tile count,
      # the backward's pipeline tail and, in float32, the fused
      # backward's work tiles not a multiple of its grid
      (3, 192, 128, True, torch.bfloat16), (3, 192, 64, False, torch.bfloat16),
      (3, 192, 128, True, torch.float32), (3, 192, 64, False, torch.float32)]
FLASH_TIMED = (2, 8192, 128, True, torch.bfloat16)
#: the float32 route (csrc/flash_attention.cu, CUDA cores) timed at the
#: same shape; the train phase's float32 runs go through it
FLASH_TIMED_F32 = FLASH_TIMED[:4] + (torch.float32,)
#: each flash kernel's source by type: bf16 is the tensor-core file
FLASH_SOURCES = {
    (name, dtype): "singa_tpu_torch/csrc/"
                   f"{ta.kernel_source(name, dtype)[0]}.cu"
    for dtype, names in FLASH_ROUTES.items() for name in names
}
#: the libraries whose ptxas reports must show no spills
SPILL_FREE = ("flash_attention", "flash_attention_bf16", "paged_attention")
RING_SOURCE = "singa_tpu_torch/csrc/quant_acc.cu"
RING_REPLACES = "singa_tpu/ops/quantized_collective.py:341"
RING_CONF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "examples", "lm", "tinylm_d128.conf")
#: the main path's bucket chunks (elements per rank and bucket row) on
#: tinylm_d128.conf with 4 buckets on 4 ranks, largest first
RING_BUCKETS = (147648, 131584, 115136, 41088)
#: quant_acc vs plain sizes (elements): ragged, a 64-element LayerNorm
#: chunk, the largest param chunk (65536), the bucket chunks, a large one
RING_SIZES = (1, 3, 64, 1000, 16384, 65536) + RING_BUCKETS + (1 << 24,)
#: timed: the largest bucket chunk, the previous design's shape (one
#: param's chunk) and 2^24
RING_TIMED = (147648, 65536, 1 << 24)
RING_RANKS = 4
#: ring vs reference q8 losses at float32, every step of 8: the JAX
#: package's bar for the same comparison
#: (tests/test_quantized_collective.py::test_ring_tracks_reference_q8);
#: the ring re-quantizes at every hop where the reference quantizes once
RING_TOL = 2e-2
#: the probe's bar, in bucket scales (max |g| over the bucket / 127):
#: the JAX package's (test_ring_probe_reduces_correctly)
PROBE_BAR = 3.5
#: quant_acc launches per step: ranks x buckets x quantized reduce hops
#: (flat ring: n - 1 = 3; q8_hier with intra_degree 2: M - 1 = 1), so
#: 48, 16 and 0 per step with 4 buckets on 4 ranks
RING_FORMS = {"q8wire": 3, "q8hier": 1, "exact": 0}
REPO = os.path.dirname(os.path.abspath(__file__))
#: the image nets, each conf as written: net -> (conf, dataset, batch)
NETS = {
    "mlp": ("examples/mnist/mlp.conf", "mnist", 1000),
    "lenet": ("examples/mnist/conv.conf", "mnist", 64),
    "alexnet": ("examples/cifar10/alexnet.conf", "cifar", 100),
    "autoencoder": ("examples/mnist/autoencoder.conf", "mnist", 100),
}
#: card vs CPU losses over NETS_PARITY_STEPS float32 steps, relative:
#: the port's card-vs-JAX bar of slice 2 (TF32 off; cuBLAS, cuDNN and
#: the CPU's kernels sum in other orders)
NETS_TOL = 1e-4
NETS_PARITY_STEPS = 5
NETS_STEPS = 30
#: pools on the card vs the CPU, max abs over outputs and input grads:
#: integer inputs, sums of at most 4 window contributions (a planted
#: fault moves a gradient by whole cotangent values, O(1))
POOL_TOL = 1e-5


#: graphed vs eager training losses, relative, per DISPATCH_WINDOW-step
#: window: the same kernels in the same order on the same batches give
#: the same bits (0.0 on an H100 for all five cells), unless a kernel
#: adds with atomics (cuDNN's wgrad_alg0_engine in AlexNet's
#: convolutions), when two eager runs differ as much; each planted fault
#: must move it by DISPATCH_FAULT_FACTOR times more
DISPATCH_TOL = 1e-5
DISPATCH_FAULT_FACTOR = 100
DISPATCH_STEPS = 30
DISPATCH_WINDOW = 10


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def make_case(rs, dev, *, s, h, nq, d, bl, max_len, pos0, overlay,
              valid=None):
    """Random pools and queries; each sequence owns a shuffled disjoint
    set of blocks (block 0 is the trash block)."""
    mb = max_len // bl
    nb = s * mb + 1

    def randn(*shape):
        return torch.from_numpy(
            rs.standard_normal(shape).astype(np.float32)
        ).to(dev)

    tables = (1 + rs.permutation(s * mb)).reshape(s, mb).astype(np.int32)
    positions = (np.asarray(pos0)[:, None] + np.arange(nq)[None, :])
    case = {
        "q": randn(s, h, nq, d),
        "k_pool": randn(nb, h, bl, d),
        "v_pool": randn(nb, h, bl, d),
        "tables": torch.from_numpy(tables).to(dev),
        "positions": torch.from_numpy(positions.astype(np.int32)).to(dev),
    }
    if overlay:
        case["chunk_k"] = randn(s, h, nq, d)
        case["chunk_v"] = randn(s, h, nq, d)
        case["chunk_valid"] = torch.from_numpy(valid).to(dev)
    return case


def run_kernel(case):
    if "chunk_k" in case:
        return pa.paged_attention_overlay(**case)
    return pa.paged_attention(**case)


def run_plain(case):
    if "chunk_k" in case:
        return pa.paged_attention_overlay_plain(**case)
    return pa.paged_attention_plain(**case)


def live_per_seq(case):
    """live_blocks of each sequence, as the kernel computes them."""
    pos = case["positions"].cpu().numpy().astype(np.int64)
    bl, mb = case["k_pool"].shape[2], case["tables"].shape[1]
    last = pos[:, 0] - 1 if "chunk_k" in case else pos.max(1)
    return pa.live_blocks(last, bl, mb)


def visible(case, n_blocks):
    """The kernel's (S, 1, Q, keys) visibility mask over the first
    ``n_blocks`` table entries (and, overlay, the chunk columns)."""
    return pa._mask(case["positions"], case["k_pool"].shape[2], n_blocks,
                    case.get("chunk_valid"))


def library_call(case):
    """F.scaled_dot_product_attention over the dense view gathered to
    the longest live length (built once, outside the timed call)."""
    q, kp, vp, tables = case["q"], case["k_pool"], case["v_pool"], \
        case["tables"]
    n = max(int(live_per_seq(case).max()), 1)
    dk = pa._gather(kp, tables[:, :n])
    dv = pa._gather(vp, tables[:, :n])
    mask = visible(case, n)
    if "chunk_k" in case:
        dk = torch.cat([dk, case["chunk_k"]], dim=2)
        dv = torch.cat([dv, case["chunk_v"]], dim=2)

    def call():
        return F.scaled_dot_product_attention(q, dk, dv, attn_mask=mask)

    return call


def time_ms(fn, flush, iters=30):
    """Mean device ms of one call: CUDA events around each call, the L2
    flushed (64 MB written) before each, after 3 warm-up calls. A device
    sleep (~1 ms) before each start event keeps the card busy while the
    host enqueues the call, so the events time the device's work and not
    the wrapper's Python overhead."""
    for _ in range(3):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def bound(case):
    """(bound_ms, bound_by) from this case's inputs: the larger of the
    modeled bytes over HBM bandwidth and the operations over the f32
    rate. Operations count only the (query, key) pairs the mask leaves
    visible, QK^T and PV at 2 ops per multiply-add each: causally hidden
    keys and the tail of the last live block need no work."""
    s, h, nq, d = case["q"].shape
    bl = case["k_pool"].shape[2]
    overlay = "chunk_k" in case
    live = live_per_seq(case)
    nbytes = pa.modeled_bytes(s, h, nq, d, bl, int(live.sum()),
                              overlay=overlay)
    pairs = int(visible(case, case["tables"].shape[1]).sum())
    ops = 4 * h * d * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def split_edges(dev, rs, errs):
    """The key-range split's edge cases at the serve geometry (head_dim
    128, block_len 16, table width 128): decode with sequences shorter
    than one split (1 and 3 keys: one live tile for ~17 splits), a full
    table and the position -1 row; a prefill chunk from position 0 (2
    live tiles, more splits than tiles); an overlay with a dead row and
    an empty pool. Each against the plain version, masked rows exact
    zeros, each launched twice (bitwise equal); prints the thread blocks
    of a decode call. Updates ``errs`` in place."""
    max_len, s, h, d, bl = 2048, 8, 2, 128, 16
    dec = make_case(rs, dev, s=s, h=h, nq=1, d=d, bl=bl, max_len=max_len,
                    pos0=np.array([0, 2, 2047, -1, 31, 32, 700, 1500]),
                    overlay=False)
    pre = make_case(rs, dev, s=1, h=h, nq=64, d=d, bl=bl, max_len=max_len,
                    pos0=[0], overlay=False)
    valid = np.ones((s, 5), np.int32)
    valid[2] = 0
    ovl = make_case(rs, dev, s=s, h=h, nq=5, d=d, bl=bl, max_len=max_len,
                    pos0=np.array([0, 3, 0, 1, 2040, 33, 64, 500]),
                    overlay=True, valid=valid)
    for name, case, dead in (("decode", dec, 3), ("prefill", pre, None),
                             ("overlay", ovl, 2)):
        got, again = run_kernel(case), run_kernel(case)
        want = run_plain(case)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        form = "paged_attention_overlay" if name == "overlay" \
            else "paged_attention"
        errs[form] = max(errs[form], err)
        s_, h_, nq, _ = case["q"].shape
        _, splits, blocks = pa.launch_geometry(
            s_, h_, nq, case["tables"].shape[1], bl, pa._sm_count(dev.index))
        print(f"kernel split edge {name:8s} splits {splits} blocks {blocks} "
              f"max_abs_err {err:.3e} (tol {TOL:g}) bitwise repeat "
              f"{bool(torch.equal(got, again))}")
        check(err <= TOL, f"split edge {name}: max_abs_err {err} > {TOL}")
        check(torch.equal(got, again),
              f"split edge {name}: two launches on the same inputs differ")
        if dead is not None:
            check(bool((got[dead] == 0).all()),
                  f"split edge {name}: fully masked row is not zero")
    n_sms = pa._sm_count(dev.index)
    blocks = pa.launch_geometry(s, h, 1, max_len // bl, bl, n_sms)[2]
    print(f"kernel decode call: {blocks} thread blocks on {n_sms} SMs")
    check(blocks >= n_sms, f"decode launches {blocks} blocks < {n_sms} SMs")


def kernel_phase(dev, rs):
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    max_len, s, h = 2048, 8, 2
    errs = {"paged_attention": 0.0, "paged_attention_overlay": 0.0}
    timed = {}
    for d in (128, 64):
        for bl in (16, 8):
            # decode: ragged fills, one row at position -1 (fully masked)
            pos0 = rs.randint(32, 1088, size=s)
            pos0[3] = -1
            dec = make_case(rs, dev, s=s, h=h, nq=1, d=d, bl=bl,
                            max_len=max_len, pos0=pos0, overlay=False)
            # prefill: one slot, a 64-token chunk deep into its prompt
            pre = make_case(rs, dev, s=1, h=h, nq=64, d=d, bl=bl,
                            max_len=max_len, pos0=[960], overlay=False)
            # overlay: ragged pos0 (one at 0), ragged draft validity, one
            # dead row with no pool entry and no valid column
            pos0 = rs.randint(32, 1088, size=s)
            pos0[0] = 0
            pos0[5] = 0
            n_draft = rs.randint(0, 5, size=s)
            valid = (np.arange(5)[None, :] <= n_draft[:, None]).astype(
                np.int32)
            valid[5] = 0
            ovl = make_case(rs, dev, s=s, h=h, nq=5, d=d, bl=bl,
                            max_len=max_len, pos0=pos0, overlay=True,
                            valid=valid)
            for name, case in (("decode", dec), ("prefill", pre),
                               ("overlay", ovl)):
                got = run_kernel(case)
                want = run_plain(case)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got).all()),
                      f"kernel {name} d{d} bl{bl}: non-finite output")
                err = float((got - want).abs().max())
                form = ("paged_attention_overlay" if name == "overlay"
                        else "paged_attention")
                errs[form] = max(errs[form], err)
                print(f"kernel {name:8s} head_dim {d:3d} block_len {bl:2d} "
                      f"max_abs_err {err:.3e} (tol {TOL:g})")
                check(err <= TOL, f"kernel {name} d{d} bl{bl}: max_abs_err "
                      f"{err} > {TOL}")
            # fully-masked rows emit zeros
            check(bool((run_kernel(dec)[3] == 0).all()),
                  "decode row at position -1 is not zero")
            check(bool((run_kernel(ovl)[5] == 0).all()),
                  "dead overlay row is not zero")
            if (d, bl) == (128, 16):   # the serve phase's geometry
                # the timed decode case without the masked row, fills as
                # the serve phase's requests reach them
                dec = make_case(rs, dev, s=s, h=h, nq=1, d=d, bl=bl,
                                max_len=max_len,
                                pos0=rs.randint(32, 1088, size=s),
                                overlay=False)
                timed = {"decode": dec, "prefill": pre, "overlay": ovl}
    split_edges(dev, rs, errs)
    rows = {}
    for name, case in timed.items():
        b_ms, b_by = bound(case)
        rows[name] = {
            "ms": time_ms(lambda: run_kernel(case), flush),
            "plain_ms": time_ms(lambda: run_plain(case), flush),
            "library_ms": time_ms(library_call(case), flush),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "live_blocks": int(live_per_seq(case).sum()),
            "shape": list(case["q"].shape),
        }
        print("kernel_timing", json.dumps({"case": name, **rows[name]}))
    return errs, rows


# ---------------------------------------------------------------------------
# serve and spec phases
# ---------------------------------------------------------------------------


def serve(dev, params, cfg, prompts, *, impl, spec_k=0, max_new=64,
          graphs=True):
    """One Engine + Scheduler run, warmed by a throwaway request (which
    also captures the engine's graphs); kernel launch counts are zeroed
    just before the measured requests and read just after. -> (scheduler,
    seconds, launches, {rid: tokens})."""
    eng = Engine(params, cfg, EngineConfig(
        slots=8, kv_block_len=16, max_prefill_chunk=64, spec_k=spec_k,
        attend_impl=impl,
    ), device=dev, graphs=graphs)
    sched = Scheduler(eng)
    sched.submit(Request(rid=-1, prompt=prompts[0][:40], max_new_tokens=4))
    sched.serve()
    sched.reset_counters()
    torch.cuda.synchronize()
    pa.paged_attention.launches = 0
    pa.paged_attention_overlay.launches = 0
    for i, pr in enumerate(prompts):
        sched.submit(Request(rid=i, prompt=pr, max_new_tokens=max_new,
                             seed=i))
    t0 = time.perf_counter()
    sched.serve()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {
        "paged_attention": pa.paged_attention.launches,
        "paged_attention_overlay": pa.paged_attention_overlay.launches,
    }
    streams = {r.rid: r.tokens for r in sched.finished}
    return sched, seconds, launches, streams


def report(tag, sched, seconds):
    lat = sorted(r.latency_s * 1e3 for r in sched.finished)
    tokens = sched.tokens_emitted + len(sched.finished)
    out = {
        "run": tag,
        "tokens": tokens,
        "seconds": seconds,
        "tokens_per_s": tokens / seconds,
        "p50_ms": _percentile(lat, 0.50),
        "p99_ms": _percentile(lat, 0.99),
        **sched.occupancy(),
    }
    print("serve", json.dumps(out))
    return out


def in_turns(dev, params, cfg, prompts, a, b):
    """After an untimed run of ``a``, run configuration ``a``, ``b``,
    ``b``, ``a`` (dicts of serve() keywords; the turns spread host noise
    over both) and check that every run's streams equal the untimed
    run's. -> [(tag, sched, seconds,
    launches)] in run order."""
    # an untimed pass of the whole workload first: the first run in a
    # process pays allocator growth and clock ramp-up
    _, _, _, first = serve(dev, params, cfg, prompts, **a)
    runs = []
    for tag, kw in (("a", a), ("b", b), ("b", b), ("a", a)):
        sched, seconds, launches, streams = serve(dev, params, cfg,
                                                  prompts, **kw)
        name = kw["impl"] + (f"_spec{kw['spec_k']}" if kw.get("spec_k")
                             else "") + ("_eager" if kw.get("graphs") is False
                                         else "")
        report(name, sched, seconds)
        check(len(streams) == len(prompts) and all(
            len(t) == 64 and all(0 <= x < cfg.vocab for x in t)
            for t in streams.values()
        ), f"{name}: not every request finished with 64 in-vocabulary "
           "tokens")
        mism = sum(streams[i] != first.get(i) for i in streams)
        print(f"{name}: {mism} of {len(prompts)} streams differ from the "
              f"untimed run; launches {launches}")
        check(mism == 0, f"{name}: greedy streams differ")
        runs.append((tag, sched, seconds, launches))
    return runs


def serve_phase(dev, cfg, params):
    rs = np.random.RandomState(1)
    prompts = [
        rs.randint(0, cfg.vocab, size=(int(rs.randint(32, 1025)),)).astype(
            np.int32)
        for _ in range(16)
    ]
    runs = in_turns(dev, params, cfg, prompts, {"impl": "fused"},
                    {"impl": "reference"})
    for tag, sched, _, launches in runs:
        want = cfg.n_layers * (sched.prefill_chunks + sched.decode_ticks)
        if tag == "a":
            print(f"serve kernel launches {launches['paged_attention']} = "
                  f"layers {cfg.n_layers} x (prefill chunks "
                  f"{sched.prefill_chunks} + decode ticks "
                  f"{sched.decode_ticks}) = {want}")
            check(launches["paged_attention"] == want > 0,
                  "serve: launches != layers x (chunks + ticks)")
        else:
            check(launches["paged_attention"] == 0,
                  "reference run launched the kernel")
    # the sequential oracle on one request, and finite logits
    i = min(range(16), key=lambda j: len(prompts[j]))
    prompt = torch.from_numpy(prompts[i]).to(dev)[None]
    oracle = generate(params, prompt, cfg, 64)[0, len(prompts[i]):]
    got = next(r for r in runs[0][1].finished if r.rid == i).tokens
    check(oracle.tolist() == got,
          "serve: fused stream differs from sequential generate()")
    with torch.no_grad():
        logits = lm_apply(params, prompt[:, :64], cfg)
    check(tuple(logits.shape) == (1, 64, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          "lm_apply logits not finite / wrong shape")
    print("serve oracle: request", i, "matches generate()")
    return runs[-1][3]["paged_attention"]


def spec_phase(dev, cfg, params):
    rs = np.random.RandomState(2)
    prompts = [
        np.tile(rs.randint(0, cfg.vocab, size=(4,)), 16)[:64].astype(
            np.int32)
        for _ in range(8)
    ]
    runs = in_turns(dev, params, cfg, prompts, {"impl": "fused"},
                    {"impl": "fused", "spec_k": 4})
    for tag, sched, _, launches in runs:
        if tag == "b":
            check(launches["paged_attention_overlay"]
                  == cfg.n_layers * sched.decode_ticks > 0,
                  "spec: overlay launches != layers x verify ticks")
            check(launches["paged_attention"]
                  == cfg.n_layers * sched.prefill_chunks,
                  "spec: write-then-read launches != layers x chunks")
    return runs[2][3]["paged_attention_overlay"]


# ---------------------------------------------------------------------------
# flash kernel phase
# ---------------------------------------------------------------------------


def flash_case(bh, s, d, causal, dtype, dev, gen):
    """Random (BH, S, D) q, k, v, dO and the plain versions' out, lse,
    delta = rowsum(dO * O) (what the backward kernels are fed)."""
    q, k, v, do = [torch.randn(bh, s, d, device=dev, generator=gen).to(dtype)
                   for _ in range(4)]
    out, lse = ta.flash_fwd_plain(q, k, v, causal)
    delta = (do.float() * out.float()).sum(-1)
    return {"q": q, "k": k, "v": v, "do": do, "out": out, "lse": lse,
            "delta": delta, "causal": causal}


def flash_calls(c):
    """name -> (kernel call, plain call) on one case, for the kernels of
    its type (FLASH_ROUTES)."""
    args = (c["q"], c["k"], c["v"], c["do"], c["lse"], c["delta"],
            c["causal"])
    calls = {
        "flash_fwd": (lambda: ta.flash_fwd(c["q"], c["k"], c["v"],
                                           c["causal"]),
                      lambda: ta.flash_fwd_plain(c["q"], c["k"], c["v"],
                                                 c["causal"])),
        "flash_bwd_dq": (lambda: ta.flash_bwd_dq(*args),
                         lambda: ta.flash_bwd_dq_plain(*args)),
        "flash_bwd_dkv": (lambda: ta.flash_bwd_dkv(*args),
                          lambda: ta.flash_bwd_dkv_plain(*args)),
        "flash_bwd": (lambda: ta.flash_bwd(*args),
                      lambda: ta.flash_bwd_plain(*args)),
    }
    return {name: calls[name] for name in FLASH_ROUTES[c["q"].dtype]}


def flash_ops(name, c):
    """Operations of one kernel call: its products (FLASH) x 2*D per
    visible (q, k) pair."""
    bh, s, d = c["q"].shape
    pairs = bh * s * (s + 1) // 2 if c["causal"] else bh * s * s
    return FLASH[name][2] * 2 * d * pairs


def flash_bound(name, c):
    """(bound_ms, bound_by) for one kernel call: the larger of its bytes
    (each input read once, each output written once) over HBM bandwidth
    and its operations (2*D per product per visible (q, k) pair) over the
    bf16 or f32 rate of the inputs' type."""
    bh, s, d = c["q"].shape
    item = c["q"].element_size()
    rows, vecs = bh * s * d * item, bh * s * 4
    nbytes = {"flash_fwd": 4 * rows + vecs,            # q k v in; out, lse
              "flash_bwd_dq": 5 * rows + 2 * vecs,     # q k v dO lse delta; dq
              "flash_bwd_dkv": 6 * rows + 2 * vecs,    # ...; dk dv
              "flash_bwd": 7 * rows + 2 * vecs}[name]  # ...; dq dk dv
    ops = flash_ops(name, c)
    rate = BF16_FLOPS_PER_S if c["q"].dtype == torch.bfloat16 \
        else F32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def flash_timings(c, flush):
    """Times at one timed case ``c``: each kernel (after two launches on
    the same inputs, which must be bitwise equal), its plain version and,
    as yardsticks the port never calls, SDPA's forward and its autograd
    backward on the same inputs. -> timing rows by kernel."""
    bh, s, d = c["q"].shape
    dtype = str(c["q"].dtype)[6:]
    rows = {}
    for name, (kernel, plain) in flash_calls(c).items():
        # deterministic: each block owns its output rows, and the fused
        # backward sums dQ across blocks in a fixed order
        first, again = kernel(), kernel()
        torch.cuda.synchronize()
        first = first if isinstance(first, tuple) else (first,)
        again = again if isinstance(again, tuple) else (again,)
        check(all(torch.equal(a, b) for a, b in zip(first, again)),
              f"{name} {dtype}: two launches on the same inputs differ")
        print(f"flash {name} {dtype}: two launches bitwise equal")
        b_ms, b_by = flash_bound(name, c)
        ms = time_ms(kernel, flush, iters=10)
        rows[name] = {"ms": ms,
                      "plain_ms": time_ms(plain, flush, iters=10),
                      "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": None,
                      "tflops": flash_ops(name, c) / ms / 1e9}
    # yardstick only: SDPA forward, and its autograd backward (which
    # computes dQ, dK and dV in one call: the fused backward's function,
    # and neither pair kernel's alone); float32 runs with TF32 off
    # (device.py)
    q, k, v = (c[n].reshape(1, bh, s, d).detach().requires_grad_(True)
               for n in ("q", "k", "v"))
    do = c["do"].reshape(1, bh, s, d)
    rows["flash_fwd"]["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
        flush, iters=10)
    out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    sdpa_bwd = time_ms(
        lambda: torch.autograd.grad(out, (q, k, v), do, retain_graph=True),
        flush, iters=10)
    extra = {}
    if "flash_bwd" in rows:
        rows["flash_bwd"]["library_ms"] = sdpa_bwd
        backward_ms = rows["flash_bwd"]["ms"]
        extra = flash_bwd_polling(c, backward_ms)
    else:
        backward_ms = rows["flash_bwd_dq"]["ms"] + rows["flash_bwd_dkv"]["ms"]
    for name, row in rows.items():
        print("flash_timing", json.dumps({"kernel": name, "dtype": dtype,
                                          **row, "shape": [1, bh, s, d]}))
    print("flash_timing", json.dumps({
        "dtype": dtype,
        "library_backward_dq_dk_dv_ms": sdpa_bwd,
        "backward_kernels": [n for n in rows if n != "flash_fwd"],
        "backward_ms": backward_ms,
        "backward_over_library": backward_ms / sdpa_bwd,
        "forward_over_library":
            rows["flash_fwd"]["ms"] / rows["flash_fwd"]["library_ms"],
        **extra}))
    return rows


def flash_fwd_blocks_per_sm(d: int) -> int:
    """The float32 forward's resident blocks an SM at head width ``d``
    (causal), from the occupancy query on its shared memory and threads
    (``singa_flash_fwd_blocks_per_sm``); minus a CUDA error."""
    fn = _build.load("flash_attention").singa_flash_fwd_blocks_per_sm
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(d, 1)


def flash_bwd_polling(c, ms):
    """The fused backward's own statistics from one launch on case ``c``
    (``ms`` its time): the share of its blocks' cycles that thread 0
    spent polling a dQ counter (the other threads wait at the barrier
    meanwhile), that share of ``ms``, and the blocks it ran."""
    args = (c["q"], c["k"], c["v"], c["do"], c["lse"], c["delta"],
            c["causal"])
    scratch = ta.launch_flash_bwd(*args)[3]
    torch.cuda.synchronize()
    polled, cycles, blocks = (
        scratch[:6].view(torch.int64).tolist())
    share = polled / cycles
    return {"poll_share": share, "poll_ms": share * ms, "blocks": blocks,
            "poll_cycles": polled, "block_cycles": cycles}


def flash_phase(dev):
    """Each flash kernel against its plain version at every listed shape
    (the fused backward twice, bitwise equal); timings at the training
    shape in bf16 (the main path's route) and in float32 (the CUDA-core
    route). -> (max_abs_err by dtype and kernel, timing rows by dtype and
    kernel)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {dt: {name: 0.0 for name in names}
            for dt, names in FLASH_ROUTES.items()}
    lse_worst = 0.0
    for bh, s, d, causal, dtype in FLASH_SHAPES:
        c = flash_case(bh, s, d, causal, dtype, dev, gen)
        worst = []
        for name, (kernel, plain) in flash_calls(c).items():
            got, want = kernel(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                check(g.dtype == w.dtype and g.shape == w.shape
                      and bool(torch.isfinite(g).all()),
                      f"{name} {(bh, s, d, causal, dtype)}: bad output")
                err = float((g.float() - w.float()).abs().max())
                rel = err / max(float(w.float().abs().max()), 1e-30)
                errs[dtype][name] = max(errs[dtype][name], err)
                worst.append(rel)
                check(rel <= FLASH_TOL[dtype],
                      f"{name} {(bh, s, d, causal, dtype)}: error {rel} > "
                      f"{FLASH_TOL[dtype]} of the output's scale")
            if dtype == torch.float32:
                again = kernel()
                again = again if isinstance(again, tuple) else (again,)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"{name} {(bh, s, d, causal, dtype)}: two launches "
                      "on the same inputs differ")
            if name == "flash_fwd":
                lse_err = float(((got[1] - want[1]).abs()
                                 / want[1].abs().clamp(min=1.0)).max())
                lse_worst = max(lse_worst, lse_err)
                check(lse_err <= LSE_TOL,
                      f"flash_fwd {(bh, s, d, causal, dtype)}: lse error "
                      f"{lse_err} > {LSE_TOL}")
        print(f"flash BH {bh} S {s:5d} D {d:3d} causal {int(causal)} "
              f"{str(dtype)[6:]:8s} worst relative error {max(worst):.2e} "
              f"(tol {FLASH_TOL[dtype]:g})")
        del c
    print(f"flash_fwd lse: worst relative error {lse_worst:.2e} over all "
          f"shapes (tol {LSE_TOL:g}); float32 kernels: two launches "
          "bitwise equal at every float32 shape")
    for d in ta.KERNEL_HEAD_DIMS:
        n = flash_fwd_blocks_per_sm(d)
        check(n >= 1, f"flash_fwd float32 D {d}: occupancy query gave {n}")
        print(f"flash_fwd float32 D {d}: {n} resident block(s) an SM")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = {}
    for shape in (FLASH_TIMED, FLASH_TIMED_F32):
        c = flash_case(*shape, dev, gen)
        rows[shape[4]] = flash_timings(c, flush)
        del c
    return errs, rows


# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------


def write_shard(tmp: str) -> str:
    """The conf's kSequenceData shard: 32 synthetic 8192-token sequences
    from seed 0 (the port's synthetic_token_arrays)."""
    shard = os.path.join(tmp, "shard")
    write_records(shard, *synthetic_token_arrays(32, seq_len=8192,
                                                 vocab=256, seed=0))
    return shard


def profile(tr, step0, nsteps):
    """``nsteps`` train steps under torch.profiler -> wall ms and device
    ms per step, both from this window, its idle share 1 - device / wall,
    and the 10 largest device-side rows per step. The profiler slows the
    host, so the idle share is an upper estimate of an unprofiled step's."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for step in range(step0, step0 + nsteps):
            tr.train_one_batch(step)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / nsteps
    tr.perf.reset()
    # device-side rows only: an operator's row also carries the device
    # time of the kernels it launched, which the kernels' rows hold
    rows = [(e.key, e.self_device_time_total / 1e3 / nsteps)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(ms for _, ms in rows)
    return {"wall_ms_per_step": wall_ms, "device_ms_per_step": device_ms,
            "idle_share": 1.0 - device_ms / wall_ms,
            "top": sorted(rows, key=lambda kv: -kv[1])[:10]}


def train_run(dev, shard, *, steps, dtype, dense, tag, profile_steps=0):
    """``steps`` steps of the port's Trainer on the conf (read by the
    port's load_model_config) over ``shard`` at compute ``dtype``, fresh
    params from seed 0. ``dense`` sets SINGA_TPU_DENSE_ATTN_MB (read at
    every attention call) above the conf's 1,074 MB of scores, else to
    its default 512, where the conf takes the flash kernels. Each step is
    timed on the host clock to a device sync; the flash launch counts are
    set to 0 just before the steps and read just after; then
    ``profile_steps`` more under torch.profiler. Checked: finite losses,
    launches = attention layers x steps of each kernel of the type's
    route on the flash path (FLASH_ROUTES), 0 of every other flash
    kernel and 0 on the dense path. -> the run's record."""
    cfg = load_model_config(TRAIN_CONF)
    cfg.compute_dtype = dtype
    for layer in cfg.neuralnet.layer:
        if layer.type == "kSequenceData":
            layer.data_param.path = shard
    os.environ["SINGA_TPU_DENSE_ATTN_MB"] = "1e12" if dense else "512"
    tr = Trainer(cfg, seed=0, log=lambda s: None, device=dev)
    for fn, _, _ in FLASH.values():
        fn.launches = 0
    ms, losses = [], []
    for step in range(steps):
        t0 = time.perf_counter()
        tr.train_one_batch(step)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(tr.perf.avg()["loss"]["loss"])
        tr.perf.reset()
    launches = {name: fn.launches for name, (fn, _, _) in FLASH.items()}
    median = sorted(ms)[len(ms) // 2]
    out = {"run": tag, "compute_dtype": dtype, "steps": steps,
           "step_ms_median": median, "step_ms_min": min(ms),
           "tokens_per_s": tr.tokens_per_step / median * 1e3,
           "losses": losses, "launches": launches}
    if profile_steps:
        out["profile"] = profile(tr, steps, profile_steps)
    print("train", json.dumps(out))
    layers = sum(l.type == "kAttention" for l in cfg.neuralnet.layer)
    check(all(np.isfinite(losses)), f"train {tag}: non-finite loss")
    want = flash_launches(getattr(torch, dtype), 0 if dense
                          else layers * steps)
    check(launches == want,
          f"train {tag}: flash launches {launches} != {want}")
    return out


def flash_launches(dtype, n):
    """The flash launch counts of ``n`` forward and backward calls of
    ``dtype``: n for each kernel of its route, 0 for the others."""
    return {name: n if name in FLASH_ROUTES[dtype] else 0 for name in FLASH}


def train_phase(dev):
    """-> (flash launches of the bf16 run, of the first float32 flash
    run)."""
    with tempfile.TemporaryDirectory() as tmp:
        shard = write_shard(tmp)
        recs = [train_run(dev, shard, steps=8, dtype="float32", dense=dense,
                          tag=f"{tag}_f32")
                for tag, dense in (("flash", False), ("dense", True),
                                   ("dense", True), ("flash", False))]
        runs = [r["losses"] for r in recs]
        diff = max(abs(a - b) for f, d_ in ((runs[0], runs[1]),
                                            (runs[3], runs[2]))
                   for a, b in zip(f, d_))
        print(f"train float32 flash vs dense: max loss difference "
              f"{diff:.3e} over 8 steps (tol {TRAIN_TOL:g}); equal to the "
              f"bit: {diff == 0.0}")
        check(diff <= TRAIN_TOL, "train: flash and dense losses differ")
        # the same comparison must fail on a planted gradient fault
        backward = ta._FlashAttention.backward
        for fault, change in FAULTS.items():
            def planted(ctx, g, change=change):
                dq, dk, dv, _ = backward(ctx, g)
                return (*change(dq, dk, dv), None)
            ta._FlashAttention.backward = staticmethod(planted)
            try:
                losses = train_run(dev, shard, steps=8, dtype="float32",
                                   dense=False, tag="fault_f32")["losses"]
            finally:
                ta._FlashAttention.backward = staticmethod(backward)
            moved = [abs(a - b) for a, b in zip(losses, runs[1])]
            print(f"train float32 {fault} vs dense: loss difference by "
                  f"step {' '.join(f'{m:.3e}' for m in moved)}")
            check(max(moved) > TRAIN_TOL,
                  f"train: {fault} passes the flash vs dense check")
        out = train_run(dev, shard, steps=30, dtype="bfloat16", dense=False,
                        tag="flash_bf16", profile_steps=3)
    check(out["losses"][-1] < out["losses"][0],
          "train bf16: loss did not fall")
    return out["launches"], recs[0]["launches"]


# ---------------------------------------------------------------------------
# ring phase
# ---------------------------------------------------------------------------


def quant_acc_case(m, dev, gen):
    q = torch.randint(-127, 128, (m,), device=dev, generator=gen,
                      dtype=torch.int8)
    local = torch.randn(m, device=dev, generator=gen)
    scale = torch.rand((), device=dev, generator=gen) * 1e-2
    return q, scale, local


def same_bits(got, want) -> bool:
    """Bitwise equal, a NaN matching any NaN (its payload is the
    hardware's)."""
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan)) and bool(torch.equal(
        got[~nan].view(torch.int32), want[~nan].view(torch.int32)))


def quant_acc_parity(q, scale, local, what):
    """quant_acc (out, amax) and out alone against quant_acc_plain,
    bitwise. -> max |out - plain| over the non-NaN elements."""
    want, want_max = qc.quant_acc_plain(q, scale, local, amax=True)
    got, got_max = qc.quant_acc(q, scale, local, amax=True)
    bare = qc.quant_acc(q, scale, local)
    torch.cuda.synchronize()
    ok = (same_bits(got, want) and same_bits(got_max, want_max)
          and same_bits(bare, want))
    live = ~torch.isnan(want)
    err = (float((got[live] - want[live]).abs().max())
           if bool(live.any()) else 0.0)
    print(f"quant_acc {what}: out and amax bitwise {ok}")
    check(ok, f"quant_acc {what}: differs from plain")
    return err


def quant_acc_phase(dev):
    """quant_acc against quant_acc_plain, out and amax bitwise: at every
    RING_SIZES, on an unaligned row of a flat (4, 1001) bucket tensor,
    with a NaN partial and with a NaN scale; then times at RING_TIMED
    with and without amax. -> (max_abs_err, rows by m)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    err = 0.0
    for m in RING_SIZES:
        q, scale, local = quant_acc_case(m, dev, gen)
        err = max(err, quant_acc_parity(q, scale, local, f"m {m}"))
        nan = torch.full((), float("nan"), device=dev)
        out, mx = qc.quant_acc(q, nan, local, amax=True)
        check(bool(out.isnan().all()) and bool(mx.isnan()),
              f"quant_acc m {m}: a NaN scale does not give NaN everywhere")
    # a ragged flat bucket tensor: row 1 starts 1001 bytes / 4004 bytes in
    q, scale, local = quant_acc_case(4 * 1001, dev, gen)
    err = max(err, quant_acc_parity(q.view(4, 1001)[1],
                                    scale, local.view(4, 1001)[1],
                                    "row 1 of (4, 1001)"))
    # a NaN partial: NaN in its place and in amax
    q, scale, local = quant_acc_case(RING_BUCKETS[0], dev, gen)
    local[12345] = float("nan")
    err = max(err, quant_acc_parity(q, scale, local, "NaN partial"))
    check(bool(qc.quant_acc(q, scale, local, amax=True)[1].isnan()),
          "quant_acc: a NaN partial does not give a NaN amax")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = {}
    for m in RING_TIMED:
        q, scale, local = quant_acc_case(m, dev, gen)
        t_bytes, t_ops = (9 * m + 4) / HBM_BYTES_PER_S, 2 * m / F32_FLOPS_PER_S
        rows[m] = {
            "ms": time_ms(lambda: qc.quant_acc(q, scale, local), flush),
            "amax_ms": time_ms(
                lambda: qc.quant_acc(q, scale, local, amax=True), flush),
            "plain_ms": time_ms(lambda: qc.quant_acc_plain(q, scale, local),
                                flush),
            "amax_plain_ms": time_ms(
                lambda: qc.quant_acc_plain(q, scale, local, amax=True),
                flush),
            "library_ms": time_ms(lambda: torch.addcmul(local, q, scale),
                                  flush),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            # amax adds one 4-byte write
            "amax_bound_ms": max(t_bytes + 4 / HBM_BYTES_PER_S, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        print("quant_acc_timing", json.dumps({"m": m, **rows[m]}))
    return err, rows


def write_ring_shard(tmp: str) -> str:
    """256 synthetic 128-token sequences from seed 0, as bench.py's
    tinylm rows make them."""
    shard = os.path.join(tmp, "ring_shard")
    write_records(shard, *synthetic_token_arrays(256, seq_len=128,
                                                 vocab=256, seed=0))
    return shard


def ring_trainer(dev, shard, tag, dtype=None):
    """The port's Trainer on tinylm_d128.conf with grad_comm tag ``tag``
    and 4 buckets, on RING_RANKS ranks of ``dev``."""
    cfg = load_model_config(RING_CONF)
    if dtype is not None:
        cfg.compute_dtype = dtype
    for layer in cfg.neuralnet.layer:
        if layer.type == "kSequenceData":
            layer.data_param.path = shard
    if tag != "exact":
        apply_grad_comm_tag(cfg, tag)
        cfg.grad_comm.buckets = 4
    mesh = build_mesh(RING_RANKS, 1, [dev] * RING_RANKS)
    return Trainer(cfg, mesh=mesh, seed=0, log=lambda s: None)


def global_grads(tr):
    """The gradient of one real step: the whole batch through one
    forward and backward."""
    batch = tr._next_batch(tr.train_net)
    leaves = {n: p.detach().requires_grad_(True)
              for n, p in tr.params.items()}
    loss, _ = tr.train_net.forward(leaves, batch, training=True)
    loss.backward()
    return {n: leaves[n].grad.detach() for n in leaves}


def probe(tr, grads):
    """_ring_reduce_probe on ``grads`` with zero residuals -> (per-rank
    reduced grads, new residuals, worst error in bucket scales, worst
    residual in bucket scales)."""
    res = {f"__gradres__/{n}": torch.zeros_like(g) for n, g in grads.items()}
    outs, new_res = tr._ring_reduce_probe(grads, res)
    worst = worst_res = 0.0
    for bucket in tr._buckets(grads):
        scale = max(float(grads[n].abs().max()) for n in bucket) / 127.0
        for n in bucket:
            for out in outs:
                worst = max(worst, float((out[n].to(grads[n].device)
                                          - grads[n]).abs().max()) / scale)
            worst_res = max(worst_res, float(
                new_res[f"__gradres__/{n}"].abs().max()) / scale)
    return outs, new_res, worst, worst_res


def _allgather_wrong_index(*args):
    """A planted fault: every chunk row written one index off."""
    return [torch.roll(full, 1, 0) for full in RING_ALLGATHER(*args)]


def _hop_fault(change):
    """A planted quant_acc fault: ``change(q, s, x)`` for the sum, its
    max-abs taken from that sum."""
    def planted(q, s, x, *, amax=False):
        out = change(q, s, x)
        return (out, out.abs().max()) if amax else out
    return planted


def _amax_halved(q, s, x, *, amax=False):
    """A planted fault: the fused max-abs reads half the max (the kernel
    launched directly: a planted run counts no launches)."""
    got = qc._launch(q, s, x, amax)
    return (got[0], got[1] / 2) if amax else got


RING_ALLGATHER = qc._allgather
#: planted ring faults, each of which the probe's bar must catch
RING_FAULTS = {
    "hop drops its scale": ("quant_acc",
                            _hop_fault(lambda q, s, x: q.float() + x)),
    "hop skips its local add": ("quant_acc",
                                _hop_fault(lambda q, s, x: q.float() * s)),
    "allgather writes the wrong index": ("_allgather",
                                         _allgather_wrong_index),
    "the fused amax reads half the max": ("quant_acc", _amax_halved),
}


def ring_probe_phase(dev, shard):
    tr = ring_trainer(dev, shard, "q8wire", "float32")
    grads = global_grads(tr)
    outs, new_res, worst, worst_res = probe(tr, grads)
    torch.cuda.synchronize()
    same = all(torch.equal(o[n], outs[0][n]) for o in outs for n in grads)
    print(f"ring probe: worst error {worst:.3f} bucket scales (bar "
          f"{PROBE_BAR}), worst residual {worst_res:.3f} scales, ranks "
          f"bitwise equal {same}")
    check(worst <= PROBE_BAR, "ring probe: reduced grads off the bar")
    check(worst_res <= 1.0, "ring probe: residual above one scale")
    check(same, "ring probe: reduced grads differ between ranks")
    # the same probe on the CPU from the same inputs
    cpu = ring_trainer(torch.device("cpu"), shard, "q8wire", "float32")
    host = {n: g.cpu() for n, g in grads.items()}
    c_outs, c_res, _, _ = probe(cpu, host)
    diff = max(float((a.cpu() - b).abs().max())
               for a, b in [(outs[0][n], c_outs[0][n]) for n in grads]
               + [(new_res[k], c_res[k]) for k in c_res])
    print(f"ring probe: card vs CPU max difference {diff:.3e}")
    for fault, (name, fn) in RING_FAULTS.items():
        real = getattr(qc, name)
        setattr(qc, name, fn)
        try:
            bad = probe(tr, grads)[2]
        finally:
            setattr(qc, name, real)
        print(f"ring probe with fault '{fault}': worst error {bad:.3f} "
              f"bucket scales")
        check(bad > PROBE_BAR, f"ring probe: fault '{fault}' passes")
    return diff


def ring_run(dev, shard, tag, *, steps, dtype, profile_steps=0):
    """``steps`` steps of one form on 4 ranks; the quant_acc count set to
    0 just before the steps and read just after; then ``profile_steps``
    more under torch.profiler. -> the run's record."""
    tr = ring_trainer(dev, shard, tag, dtype)
    qc.quant_acc.launches = 0
    ms, losses = [], []
    for step in range(steps):
        t0 = time.perf_counter()
        tr.train_one_batch(step)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(tr.perf.avg()["loss"]["loss"])
        tr.perf.reset()
    launches = qc.quant_acc.launches
    median = sorted(ms)[len(ms) // 2]
    out = {"run": tag, "compute_dtype": dtype, "ranks": RING_RANKS,
           "steps": steps, "step_ms_median": median, "step_ms_min": min(ms),
           "tokens_per_s": tr.tokens_per_step / median * 1e3,
           "losses": losses, "quant_acc_launches": launches}
    if profile_steps:
        out["profile"] = profile(tr, steps, profile_steps)
    print("ring_train", json.dumps(out))
    buckets = len(tr._buckets(tr.params)) if tag != "exact" else 0
    want = RING_RANKS * buckets * RING_FORMS.get(tag, 0) * steps
    check(all(np.isfinite(losses)), f"ring {tag}: non-finite loss")
    check(launches == want, f"ring {tag}: quant_acc launches {launches} "
          f"!= {want}")
    out["trainer"] = tr
    return out


def reduce_ms(tr, reps=10) -> float:
    """The ring's reduction alone (_ring_reduce_probe on random grads and
    zero residuals) on the host clock to a device sync: ms per call, the
    mean of ``reps`` after one warm-up call."""
    grads = {n: torch.randn_like(p) * 1e-3 for n, p in tr.params.items()}
    res = {k: torch.zeros_like(v) for k, v in tr.buffers.items()}
    tr._ring_reduce_probe(grads, res)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        tr._ring_reduce_probe(grads, res)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


RING_HOP = qc._hop


def _unfused_hop(*args, **kw):
    """The ring's hop without the fused max-abs: every next scale from a
    pass of its own over the row (symmetric_scale)."""
    return RING_HOP(*args, **{**kw, "fused": False})


def ring_fusion(dev, shard, pairs=10):
    """The bf16 flat ring with the next hop's max-abs fused into quant_acc
    and without it, on one trainer: the probe's reduced grads and
    residuals must be equal to the bit (the two give the same scales);
    then ``pairs`` pairs, the order alternating (fused first in even
    pairs), each side the probe's host ms (reduce_ms) and the median ms
    of 5 synced train steps."""
    tr = ring_trainer(dev, shard, "q8wire")
    grads = {n: torch.randn_like(p) * 1e-3 for n, p in tr.params.items()}
    res = {k: torch.zeros_like(v) for k, v in tr.buffers.items()}
    times = {form: {"reduce_ms": [], "step_ms": []}
             for form in ("fused", "unfused")}
    got, step = {}, 0
    for i in range(pairs):
        for form in ("fused", "unfused")[::1 if i % 2 == 0 else -1]:
            qc._hop = RING_HOP if form == "fused" else _unfused_hop
            try:
                got[form] = tr._ring_reduce_probe(grads, res)
                times[form]["reduce_ms"].append(reduce_ms(tr))
                ms = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    tr.train_one_batch(step)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                    tr.perf.reset()
                    step += 1
                times[form]["step_ms"].append(sorted(ms)[2])
            finally:
                qc._hop = RING_HOP
    (outs, new_res), (u_outs, u_res) = got["fused"], got["unfused"]
    check(all(torch.equal(a[n], b[n]) for a, b in zip(outs, u_outs)
              for n in a)
          and all(torch.equal(new_res[k], u_res[k]) for k in new_res),
          "ring: fused and unfused max-abs reduce differently")
    print("ring_fusion", json.dumps({"pairs": pairs, **{
        f"{form}_{key}": v for form, t in times.items()
        for key, v in t.items()}}))


def ring_phase(dev):
    """-> (max_abs_err, the timing row at the largest bucket chunk,
    launches of the bf16 flat ring)."""
    err, rows = quant_acc_phase(dev)
    with tempfile.TemporaryDirectory() as tmp:
        shard = write_ring_shard(tmp)
        ring_probe_phase(dev, shard)
        runs = [ring_run(dev, shard, tag, steps=8, dtype="float32")
                for tag in ("q8wire", "q8", "q8", "q8wire")]
        diff = max(abs(a - b) for ring, ref in ((runs[0], runs[1]),
                                                (runs[3], runs[2]))
                   for a, b in zip(ring["losses"], ref["losses"]))
        print(f"ring float32 ring vs reference q8: max loss difference "
              f"{diff:.3e} over 8 steps (tol {RING_TOL:g})")
        check(diff <= RING_TOL, "ring: ring and reference q8 losses differ")
        bf16 = {tag: ring_run(dev, shard, tag, steps=30, dtype=None,
                              profile_steps=3 if tag == "q8wire" else 0)
                for tag in ("q8wire", "q8hier", "exact")}
        for tag, run in bf16.items():
            check(run["losses"][-1] < run["losses"][0],
                  f"ring bf16 {tag}: loss did not fall")
        # the reduction alone on the host clock, as a share of the step
        ms = reduce_ms(bf16["q8wire"]["trainer"])
        print("ring_reduce", json.dumps({
            "reduce_ms": ms,
            "ring_step_ms": bf16["q8wire"]["step_ms_median"],
            "share": ms / bf16["q8wire"]["step_ms_median"]}))
        ring_fusion(dev, shard)
    return err, rows[RING_TIMED[0]], bf16["q8wire"]["quant_acc_launches"]


# ---------------------------------------------------------------------------
# nets phase
# ---------------------------------------------------------------------------


def write_net_shards(tmp: str) -> dict:
    """MNIST-shaped train and test shards (synthetic_arrays, templates
    from seed 0, the test split's noise from seed 1), a CIFAR-shaped
    train shard (structured_rgb, seed 0), its test split and the train
    shard's mean file (compute_mean)."""
    out = {k: os.path.join(tmp, k) for k in
           ("mnist", "mnist_test", "cifar", "cifar_test")}
    write_records(out["mnist"], *synthetic_arrays(2000, seed=0))
    write_records(out["mnist_test"],
                  *synthetic_arrays(1000, seed=0, noise_seed=1))
    write_records(out["cifar"], *structured_rgb(1000, seed=0))
    write_records(out["cifar_test"],
                  *structured_rgb(200, seed=0, noise_seed=1))
    out["mean"] = os.path.join(tmp, "mean.npy")
    compute_mean(out["cifar"], out["mean"])
    return out


def net_config(name: str, shards: dict):
    """The conf as written (widths, batch, updater), read by the port's
    load_model_config, on the synthetic shards. The autoencoder's
    kPretrained params, which the real job restores from an RBM-stack
    checkpoint, are drawn kGaussain (std 0.1) from the seed instead."""
    conf, data, _ = NETS[name]
    cfg = load_model_config(os.path.join(REPO, conf))
    cfg.checkpoint = None
    for layer in cfg.neuralnet.layer:
        if layer.type == "kShardData":
            test = "kTrain" in (layer.exclude or [])
            layer.data_param.path = shards[data + ("_test" if test else "")]
        if layer.rgbimage_param is not None:
            layer.rgbimage_param.meanfile = shards["mean"]
        for p in layer.param:
            if p.init_method == "kPretrained":
                p.init_method, p.std = "kGaussain", 0.1
    return cfg


def net_steps(tr, step0, nsteps, timed=False):
    """-> (losses, host ms per step synced to the device)."""
    losses, ms = [], []
    for step in range(step0, step0 + nsteps):
        t0 = time.perf_counter()
        tr.train_one_batch(step)
        if timed:
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(tr.perf.avg()["loss"]["loss"])
        tr.perf.reset()
    return losses, ms


def mlp_bound(tr):
    """(operations of one mlp step, ms at F32_FLOPS_PER_S): each FC
    layer's forward, dW and dX products, 2·vdim·hdim·batch each, less
    the first layer's dX (its input is data)."""
    fcs = [l for l in tr.train_net.layers if l.TYPE == "kInnerProduct"]
    batch = tr.train_net.batchsize
    ops = sum(3 * 2 * l.vdim * l.hdim * batch for l in fcs)
    ops -= 2 * fcs[0].vdim * fcs[0].hdim * batch
    return ops, ops / F32_FLOPS_PER_S * 1e3


def net_run(dev, name, shards, smi):
    """One conf at full width: NETS_PARITY_STEPS float32 steps on the card
    and on the CPU from the same seed-0 params and batches (losses within
    NETS_TOL relative), NETS_STEPS more timed steps on the card (finite,
    the last below the first), one test batch, then a 3-step profile."""
    batch = NETS[name][2]
    card = Trainer(net_config(name, shards), seed=0, log=lambda s: None,
                   device=dev)
    host = Trainer(net_config(name, shards), seed=0, log=lambda s: None,
                   device="cpu")
    check(card.train_net.batchsize == batch,
          f"nets {name}: batch {card.train_net.batchsize} != {batch}")
    ours, _ = net_steps(card, 0, NETS_PARITY_STEPS)
    ref, _ = net_steps(host, 0, NETS_PARITY_STEPS)
    rel = max(abs(a - b) / abs(b) for a, b in zip(ours, ref))
    print(f"nets {name}: card vs CPU over {NETS_PARITY_STEPS} float32 "
          f"steps, max relative loss difference {rel:.3e} (tol "
          f"{NETS_TOL:g}); card {' '.join(f'{x:.6f}' for x in ours)} "
          f"[{smi}]")
    check(rel <= NETS_TOL, f"nets {name}: card and CPU losses differ")
    losses, ms = net_steps(card, NETS_PARITY_STEPS, NETS_STEPS, timed=True)
    check(all(np.isfinite(losses)), f"nets {name}: non-finite loss")
    check(losses[-1] < losses[0], f"nets {name}: loss did not fall")
    test = card.evaluate(card.test_net, 1, "test", NETS_STEPS)["loss"]
    check(all(np.isfinite(list(test.values()))),
          f"nets {name}: non-finite test metric")
    median = sorted(ms)[len(ms) // 2]
    prof = profile(card, NETS_PARITY_STEPS + NETS_STEPS, 3)
    out = {"net": name, "conf": NETS[name][0], "batch": batch,
           "params": sum(p.numel() for p in card.params.values()),
           "steps": NETS_STEPS, "first_loss": losses[0],
           "last_loss": losses[-1], "test": test,
           "step_ms_median": median, "step_ms_min": min(ms),
           "images_per_s": batch / median * 1e3,
           "device_ms_per_step": prof["device_ms_per_step"],
           "profiled_wall_ms_per_step": prof["wall_ms_per_step"],
           "idle_share": prof["idle_share"], "top5": prof["top"][:5],
           "card": smi}
    if name == "mlp":
        out["bound_ops"], out["bound_ms"] = mlp_bound(card)
    print("nets", json.dumps(out))
    return out


def pool_check(dev, smi):
    """The tie-sharing max-pool backward and the k² average at AlexNet's
    pool1 shape (100, 32, 28, 28), k 3, s 2 (the last window overhangs),
    on integer inputs full of ties: card vs CPU, forward and backward.
    Each planted fault (PyTorch's single-winner backward; PyTorch's
    ceil_mode average, which divides an overhanging window by its
    in-bounds count) must fail the same comparison."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randint(0, 3, (100, 32, 28, 28), generator=gen).float()
    dy = torch.randn(100, 32, 14, 14, generator=gen)

    def run(fn, device):
        xd = x.to(device).clone().requires_grad_(True)
        y = fn(xd)
        y.backward(dy.to(device))
        return y.detach().cpu(), xd.grad.cpu()

    def err(a, b):
        return max(float((u - v).abs().max()) for u, v in zip(a, b))

    single = lambda t: F.max_pool2d(  # noqa: E731
        F.pad(t, (0, 1, 0, 1), value=float("-inf")), 3, 2)
    in_bounds = lambda t: F.avg_pool2d(t, 3, 2, ceil_mode=True)  # noqa
    for kind, ours, fault in (
            ("max", lambda t: tnn.max_pool2d(t, 3, 2), single),
            ("avg", lambda t: tnn.avg_pool2d(t, 3, 2), in_bounds)):
        want = run(ours, "cpu")
        got, planted = err(run(ours, dev), want), err(run(fault, dev), want)
        print(f"nets pool {kind}: card vs CPU max abs {got:.3e}, planted "
              f"fault vs CPU {planted:.3e} (tol {POOL_TOL:g}) [{smi}]")
        check(got <= POOL_TOL, f"nets pool {kind}: card and CPU differ")
        check(planted > POOL_TOL,
              f"nets pool {kind}: the planted fault passes the check")


def nets_phase(dev, smi):
    """-> {net: record} for the four confs."""
    pool_check(dev, smi)
    with tempfile.TemporaryDirectory() as tmp:
        shards = write_net_shards(tmp)
        return {name: net_run(dev, name, shards, smi) for name in NETS}


# ---------------------------------------------------------------------------
# dispatch phase
# ---------------------------------------------------------------------------


def window_losses(tr, step0=0):
    """DISPATCH_STEPS steps from ``step0`` in windows of DISPATCH_WINDOW
    (``train_chunk``: replays of the captured step, or eager steps) ->
    each window's mean loss."""
    out = []
    for s in range(step0, step0 + DISPATCH_STEPS, DISPATCH_WINDOW):
        tr.train_chunk(s, DISPATCH_WINDOW)
        out.append(tr.perf.avg()["loss"]["loss"])
        tr.perf.reset()
    return out


def rel_diff(got, want) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def chunk_ms(tr, step0, n):
    """Host ms per step of one ``n``-step chunk, synced at its end."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.train_chunk(step0, n)
    torch.cuda.synchronize()
    tr.perf.reset()
    return (time.perf_counter() - t0) * 1e3 / n


def chunk_device_ms(tr, step0, n):
    """Device ms per step of an unprofiled ``n``-step graphed chunk, by
    CUDA events: a ~10 ms device sleep before the start event keeps the
    card busy while the host uploads the chunk's args and enqueues its
    replays, so the events time the device's work alone."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    t0 = time.perf_counter()
    tr.train_chunk(step0, n)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    tr.perf.reset()
    return start.elapsed_time(end) / n, enqueue_ms


def dispatch_times(tr, eager, step0, units_per_step):
    """Step ms of the graphed and the eager trainer (a 30-step chunk
    each, synced at its end), the graphed chunk's unprofiled device ms
    and idle share, and its largest device rows (10 profiled steps)."""
    from singa_tpu_torch.tools.dispatch_turns import profiled_device_ms

    g_ms = chunk_ms(tr, step0, DISPATCH_STEPS)
    e_ms = chunk_ms(eager, step0, DISPATCH_STEPS)
    dev_ms, enqueue_ms = chunk_device_ms(tr, step0 + DISPATCH_STEPS,
                                         DISPATCH_STEPS)
    prof_ms, top = profiled_device_ms(
        lambda: tr.train_chunk(step0 + 2 * DISPATCH_STEPS, 10), 10)
    tr.perf.reset()
    return {"step_ms": g_ms, "eager_step_ms": e_ms,
            "per_s": units_per_step / g_ms * 1e3,
            "eager_per_s": units_per_step / e_ms * 1e3,
            "device_ms_per_step": dev_ms, "idle_share": 1.0 - dev_ms / g_ms,
            "chunk_enqueue_ms": enqueue_ms,
            "profiled_device_ms_per_step": prof_ms, "top5": top}


def dispatch_pair(dev, make_cfg, units, tag, smi):
    """A graphed and an eager trainer (the eager one on host batches,
    the per-step path of the slices before) from the same seed-0 params:
    DISPATCH_STEPS steps each, window losses within DISPATCH_TOL, then
    their times (``units`` per step: images, or None for the LM's
    tokens). -> (record, the eager run's window losses)."""
    graph = Trainer(make_cfg(), seed=0, log=lambda s: None, device=dev)
    units = units or graph.tokens_per_step
    eager = Trainer(make_cfg(), seed=0, log=lambda s: None, device=dev,
                    graphs=False, device_cache=False, prefetch=False)
    check(graph.dispatch_mode == "graph" and graph.feeder_mode == "cached",
          f"dispatch {tag}: not a graphed step on the cached dataset "
          f"({graph.dispatch_mode}, {graph.feeder_mode})")
    for fn, _, _ in FLASH.values():
        fn.launches = 0
    g_losses = window_losses(graph)
    launches = {name: fn.launches for name, (fn, _, _) in FLASH.items()}
    e_losses = window_losses(eager)
    rel = rel_diff(g_losses, e_losses)
    print(f"dispatch {tag}: graphed vs eager, {DISPATCH_STEPS} steps in "
          f"windows of {DISPATCH_WINDOW}, max relative loss difference "
          f"{rel:.3e} (tol {DISPATCH_TOL:g}); graphed "
          f"{' '.join(f'{x:.7f}' for x in g_losses)}, eager "
          f"{' '.join(f'{x:.7f}' for x in e_losses)} [{smi}]")
    if rel:
        # the same kernels in the same order: a difference comes from a
        # kernel that is not deterministic, and shows between two eager
        # runs as well
        again = window_losses(Trainer(
            make_cfg(), seed=0, log=lambda s: None, device=dev,
            graphs=False, device_cache=False, prefetch=False))
        print(f"dispatch {tag}: eager vs eager, the same steps: max "
              f"relative loss difference {rel_diff(again, e_losses):.3e}")
    check(all(np.isfinite(g_losses)), f"dispatch {tag}: non-finite loss")
    check(rel <= DISPATCH_TOL, f"dispatch {tag}: graphed and eager "
          "losses differ")
    check(graph._g.run.captured, f"dispatch {tag}: the step was never "
          "captured")
    rec = {"run": tag, "graphed_losses": g_losses, "eager_losses": e_losses,
           "rel_diff": rel, "flash_launches": launches,
           **dispatch_times(graph, eager, DISPATCH_STEPS, units),
           "card": smi}
    print("dispatch", json.dumps(rec))
    return rec, e_losses


def _slots_only(self, new_p, new_s, res):
    """The planted copy-back fault: the update's slots and residuals land
    in the static tensors, its params do not."""
    STORE_UPDATE(self, {}, new_s, res)


STORE_UPDATE = Trainer._store_update
#: the two classic faults of a replayed step, planted in the step body:
#: name -> (net, Trainer attribute, its faulty value)
DISPATCH_FAULTS = {
    "step counter frozen": ("lenet", "_advance_step", lambda self: None),
    "update not copied back": ("mlp", "_store_update", _slots_only),
}


def dispatch_shards(tmp: str) -> dict:
    """Full-size synthetic shards (tools/dispatch_turns.write_shards):
    60000 MNIST-shaped records, the real training set's size, 50000
    CIFAR-shaped (CIFAR-10's), their test splits, the mean file and the
    LM's token shard."""
    from singa_tpu_torch.tools.dispatch_turns import write_shards

    return write_shards(tmp)


def dispatch_phase(dev, smi, cfg, params):
    """-> {run: record}: the four nets and train_longctx graphed vs eager,
    the two planted faults, the engine call's split and serve with and
    without graphs in turns."""
    import functools

    from singa_tpu_torch.data.pipeline import load_shard_arrays
    from singa_tpu_torch.layers.data import ShardDataLayer
    from singa_tpu_torch.tools.dispatch_turns import engine_split

    out = {}
    # every Trainer of this phase reads the same shards: decode each once
    ShardDataLayer.LOADER = staticmethod(
        functools.lru_cache(maxsize=None)(load_shard_arrays))
    try:
        with tempfile.TemporaryDirectory() as tmp:
            shards = dispatch_shards(tmp)
            eager_losses = {}
            for name in NETS:
                out[name], eager_losses[name] = dispatch_pair(
                    dev, functools.partial(net_config, name, shards),
                    NETS[name][2], name, smi)
            for fault, (name, attr, value) in DISPATCH_FAULTS.items():
                real = getattr(Trainer, attr)
                setattr(Trainer, attr, value)
                try:
                    tr = Trainer(net_config(name, shards), seed=0,
                                 log=lambda s: None, device=dev)
                    losses = window_losses(tr)
                finally:
                    setattr(Trainer, attr, real)
                moved = rel_diff(losses, eager_losses[name])
                print(f"dispatch fault {fault!r} on {name}: graphed vs "
                      f"eager relative loss difference {moved:.3e}, "
                      f"{moved / DISPATCH_TOL:.0f}x DISPATCH_TOL")
                check(moved >= DISPATCH_FAULT_FACTOR * DISPATCH_TOL,
                      f"dispatch: the planted fault {fault!r} passes the "
                      "graphed vs eager check")

            def lm_cfg():
                c = load_model_config(TRAIN_CONF)
                for layer in c.neuralnet.layer:
                    if layer.type == "kSequenceData":
                        layer.data_param.path = shards["tokens"]
                return c

            os.environ["SINGA_TPU_DENSE_ATTN_MB"] = "512"
            out["train_longctx"], _ = dispatch_pair(
                dev, lm_cfg, None, "train_longctx", smi)
            layers = sum(l.type == "kAttention"
                         for l in lm_cfg().neuralnet.layer)
            launches = out["train_longctx"]["flash_launches"]
            print(f"dispatch train_longctx: flash launches under graphs "
                  f"{launches}, want layers {layers} x steps "
                  f"{DISPATCH_STEPS}")
            check(launches == flash_launches(torch.bfloat16,
                                             layers * DISPATCH_STEPS),
                  "dispatch train_longctx: flash launches under graphs "
                  "!= layers x steps")
    finally:
        ShardDataLayer.LOADER = staticmethod(load_shard_arrays)
    for graphs in (False, True):
        split = engine_split(Engine(params, cfg, EngineConfig(
            slots=8, kv_block_len=16, max_prefill_chunk=64), device=dev,
            graphs=graphs))
        out[f"engine_split_{'graph' if graphs else 'eager'}"] = split
        print("dispatch engine call", "graph" if graphs else "eager",
              json.dumps(split), f"[{smi}]")
    rs = np.random.RandomState(1)
    prompts = [
        rs.randint(0, cfg.vocab, size=(int(rs.randint(32, 1025)),)).astype(
            np.int32)
        for _ in range(16)
    ]
    runs = in_turns(dev, params, cfg, prompts, {"impl": "fused"},
                    {"impl": "fused", "graphs": False})
    out["serve"] = [
        {"graphs": tag == "a", "tokens_per_s":
         (sched.tokens_emitted + len(sched.finished)) / seconds}
        for tag, sched, seconds, _ in runs]
    return out


def short_kernel_name(mangled: str) -> str:
    """'_ZN12_GLOBAL__N_124flash_bwd_dq_bf16_kernelILi128ELb1EEEv...' ->
    'flash_bwd_dq_bf16_kernel<128,1>' (the last name of the nested name,
    its type argument, then its integer and bool arguments)."""
    i, name = (3 if mangled.startswith("_ZN") else 2), mangled
    while i < len(mangled) and mangled[i].isdigit():
        n = re.match(r"\d+", mangled[i:]).group()
        i += len(n)
        name = mangled[i:i + int(n)]
        i += int(n)
    tmpl = mangled[i:]
    if not tmpl.startswith("I"):
        return name
    args = re.findall(r"L[ib](\d+)E", tmpl.split("EE")[0] + "E")
    kind = ("bf16," if tmpl.startswith("I13__nv_bfloat16")
            else "f32," if tmpl.startswith("If") else "")
    return f"{name}<{kind}{','.join(args)}>"


def ptxas_report(logs):
    """Print each kernel's register and spill lines from the nvcc logs
    (``-Xptxas -v``) -> {library: [kernels that spill]}."""
    spills = {}
    for lib, log in logs.items():
        spills[lib], kernel = [], "?"
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '(\S+)'", line)
            if entry:
                kernel = short_kernel_name(entry.group(1))
            if "registers" in line or "spill" in line:
                print(f"ptxas {lib} {kernel}: {line.strip()}")
            stores = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                               r"spill loads", line)
            if stores and (int(stores.group(1)) or int(stores.group(2))):
                spills[lib].append(kernel)
    return spills


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"kernel build {time.perf_counter() - t0:.1f} s "
          f"({', '.join(logs) or 'already built'})")
    spills = ptxas_report(logs)
    for lib in SPILL_FREE:
        check(lib in logs, f"{lib}: no ptxas report (not built by this "
              "run)")
        check(not spills[lib],
              f"{lib}: ptxas reports spills in {spills[lib]}")

    errs, rows = kernel_phase(dev, np.random.RandomState(0))

    cfg = TransformerConfig(vocab=256, d_model=256, n_heads=2, n_layers=2,
                            d_ff=1024, max_len=2048)
    params = init_lm(torch.Generator().manual_seed(0), cfg, dev)
    launches = {
        "paged_attention": serve_phase(dev, cfg, params),
        "paged_attention_overlay": spec_phase(dev, cfg, params),
    }
    flash_errs, flash_rows = flash_phase(dev)
    bf16_launches, f32_launches = train_phase(dev)
    launches.update(bf16_launches)
    ring_err, ring_row, launches["quant_acc"] = ring_phase(dev)
    nets_phase(dev, smi)
    dispatch_phase(dev, smi, cfg, params)

    kernels = []
    for name, case in (("paged_attention", "decode"),
                       ("paged_attention_overlay", "overlay")):
        row = rows[case]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": launches[name],
            "max_abs_err": errs[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    # the bf16 route (the main path's), then the float32 route, whose
    # launches are those of the train phase's first float32 flash run
    for dtype, suffix, counts in ((torch.bfloat16, "", launches),
                                  (torch.float32, "_f32", f32_launches)):
        for name in FLASH_ROUTES[dtype]:
            row = flash_rows[dtype][name]
            kernels.append({
                "name": name + suffix, "route": "cuda",
                "source": FLASH_SOURCES[name, dtype],
                "replaces": FLASH[name][1], "launches": counts[name],
                "max_abs_err": flash_errs[dtype][name], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"],
            })
            if name == "flash_bwd":
                kernels[-1]["replaces_also"] = (
                    "singa_tpu/ops/attention.py:451")
    kernels.append({
        "name": "quant_acc", "route": "cuda", "source": RING_SOURCE,
        "replaces": RING_REPLACES, "launches": launches["quant_acc"],
        "max_abs_err": ring_err, "ms": ring_row["ms"],
        "plain_ms": ring_row["plain_ms"], "bound_ms": ring_row["bound_ms"],
        "bound_by": ring_row["bound_by"],
        "library_ms": ring_row["library_ms"],
        "m": RING_TIMED[0], "amax_ms": ring_row["amax_ms"],
        "amax_bound_ms": ring_row["amax_bound_ms"],
    })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
