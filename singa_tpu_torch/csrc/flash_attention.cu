// Flash attention for Hopper (sm_90a) on the CUDA cores, in float32: the
// forward and one fused backward (dQ, dK and dV in one kernel), causal or
// full, over (batch * heads, S, D) rows with float32 accumulation
// everywhere.
//
// bfloat16 runs on the tensor cores in flash_attention_bf16.cu. float32
// stays here: TF32 tensor cores would break the float32 flash-vs-dense
// training bar (1e-5) and the port's no-TF32 contract (device.py).
//
// Replaces, for float32 inputs, the six Pallas TPU kernels of
// singa_tpu/ops/attention.py:
//   flash_fwd  <- _flash_kernel_staged (:386) and _flash_kernel (:210),
//                 launched by _flash_fwd_impl (:552)
//   flash_bwd  <- _flash_bwd_dq_staged (:419), _flash_bwd_dkv_staged (:451),
//                 _flash_bwd_dq_kernel (:268) and _flash_bwd_dkv_kernel
//                 (:316), launched by _flash_bwd (:615): the TPU's dQ and
//                 dK/dV kernels become one kernel here
// The TPU's staged/streamed split is only a VMEM budget (_variant): here
// every K/V, Q and dO tile is streamed from device memory through shared
// memory whatever S is, so one kernel covers both variants.
//
// What each computes (scale = 1/sqrt(D); masked scores are NEG_INF = -1e30
// and their probabilities exactly 0):
//   forward:  O = softmax(Q K^T * scale) V by online softmax over the live
//             K tiles; lse = m + log(l) in float32, laid out (BH, S); a row
//             with l == 0 emits 0 (and lse = m).
//   backward: P = exp(S * scale - lse); dS = P * (dO V^T - delta);
//             dV = P^T dO; dK = scale * dS^T Q; dQ = scale * dS K.
//             delta = rowsum(dO * O) comes in, computed once outside the
//             kernel (as _flash_bwd does).
//
// Bound on the H100: operations. At B*H = 2, S = 8192, D = 128, causal, the
// backward moves ~59 MB (0.018 ms at 3.35 TB/s) but does 5 products of 2*D
// operations per visible (q, k) pair, 85.9 GFLOP: 1.282 ms at the 67
// TFLOP/s float32 rate. The forward does 2 products (0.513 ms).
//
// Forward design. The first forward ("right and simple first") was
// one 256-thread block per 64-row q tile: K and V loaded through the
// registers between two barriers at every key tile and a third barrier
// before PV; thread tiles of 4 q rows x 4 keys (scores) and 4 rows x D/16
// columns (output), with a warp spanning 2 rows x 16 key lanes, so each
// K or V operand load took two shared wavefronts. It took 1.19 ms at B*H
// 2, S 8192, D 128, causal: 43% of its 0.513 ms bound. What this kernel
// does, each choice timed on the card against the others
// (tools/flash_bwd_variants.py --source flash_attention):
//   * Two key groups a block. A block is one (q tile, bh), numbered
//     heaviest causal tile first over every bh, with two groups of 128
//     threads that share the Q tile and fold every other live key tile
//     each (group g: g, g + 2, ...), each with its own m, l and output
//     accumulator, its own K, V and P tiles and its own named barrier
//     (bar.sync 1 + g, 128). At the end group 1 hands m, l and its
//     accumulator to group 0 through shared memory, and group 0 merges
//     them in that fixed order. The grid stays one block per q tile,
//     which the hardware hands out heaviest first as SMs free up, so the
//     SMs end within about one tile of each other. One group a block
//     was 15% slower; two groups of 256 threads (16 warps, at most 128
//     registers a thread, so half the thread tile) 6% slower. Not built:
//     two 256-thread blocks an SM (with 256 q tiles and 264 block slots
//     at the timed shape every block is resident at once, so an SM
//     holding the heaviest tile also holds another) and a 128-row q tile
//     (128 blocks, the heaviest with twice the average SM's work).
//   * Large thread tiles, few bytes loaded an FMA. What bounds the
//     products is the bytes shared memory delivers to registers (128 B a
//     clock an SM) for each FMA, more than wavefronts. A group's warp
//     covers 2 q rows x 16 key lanes: lane (ry, kx) holds rows row +
//     8i (i < 8), keys kx + 16j (j < 4) of the score tile and output
//     columns 4kx + 64c + e (c < D/64). Per d-quad the scores load 12
//     float4 for 128 FMAs (0.375 floats an FMA; the first forward 0.5);
//     per key-quad PV loads 16 float4 for 256 FMAs at D = 128 (0.25;
//     before 0.375). Wavefronts a warp: the scores 16 per 128 FMAs (Q
//     rows 2 a load: one wavefront; K rows 16: two), PV 24 per 256 (P
//     one, V two), 0.125 and 0.094 an FMA instruction (the first forward
//     0.19 and 0.16). Tile rows are padded to D + 4 floats and P's to 80,
//     so no load or P store has a bank conflict beyond its bytes. 8 key
//     lanes a row (4 rows x 8 keys, every load one wavefront, 0.375 and
//     0.3125 floats an FMA) was 5% slower. A row's statistics live in one
//     warp: max over 16 lanes by shuffles; the sum l stays per lane until
//     the end.
//   * Asynchronous K and V, one stage each, two barriers a step. With
//     K_kt in shared memory, a group issues V_kt (cp.async) and computes
//     the scores and the softmax meanwhile; waits for V_kt, then its
//     barrier (P and V_kt visible, K_kt read); issues K_{kt+2} and
//     computes PV meanwhile; waits, then its barrier (K_{kt+2} visible, P
//     and V read). Each copy overlaps half a step.
//   * The softmax step: m is the row max of the raw scores, P = 2^(S sc -
//     m sc) with sc = scale log2(e) folded into one FMA before exp2f (1-2%
//     faster than expf of the scaled score), and lse = m scale + ln l.
//     The causal mask applies on the diagonal tile only (a masked and an
//     unmasked instance of the step; masking every tile was 9% slower);
//     masked scores are exactly -1e30 and their probabilities exactly 0.
// Shared memory at D = 128: Q, then per group K, V (64 x 132 floats each)
// and P (64 x 80): 209,920 B, one block (8 warps) an SM, 226-232
// registers a thread and no spills. The score loop over D and PV's over
// the keys are unrolled 4 times (2 was 0.2-1.7% slower). No block waits
// on another (each owns its output rows), so there is no persistent grid
// or ticket; two launches give the same bits.
// Measured (NVIDIA H100 80GB HBM3, 700 W; B*H 2, S 8192, D 128, causal):
// 0.888 ms, 38.7 TFLOP/s, 58% of the bound (tools/flash_bwd_variants.py).
// With PV unrolled 2 times: 0.896 and 0.902 ms in turns with the first
// forward's 1.195 and 1.189 (tools/flash_bwd_turns.py), where SDPA's
// float32 forward took 1.21-1.22 ms. What holds it at 58%: the bytes
// loaded an FMA (0.3125 floats, at most 80% of the FMA rate through 128 B
// a clock), the softmax step's exp2f, shuffles and P stores (about 7% of
// the instructions), and two warps a scheduler to hide latency.
//
// Backward design. The previous design was two kernels, dQ (one block per
// q tile) and dK/dV (one block per key tile). Each recomputed S and dP, so
// the pair did 7 products where 5 are needed; each tile load was a memory
// round trip between two barriers; each thread had small register tiles.
// What this kernel does about each:
//   * 5 products. One work tile is a (key tile kt, bh) pair. K and V stay
//     in shared memory for the tile's life. The tile walks its q tiles
//     from the last (nt - 1) down to the first that sees it (kt when
//     causal, 0 when not); for each it computes S^T = K Q^T and dP^T =
//     V dO^T, then P and dS elementwise, then dV += P^T dO, dK += dS^T Q
//     and the 64 x D dQ partial dS K. dK and dV stay in registers.
//   * dQ summed in a fixed order, no atomics on values. dq (zeroed by the
//     wrapper) is the accumulator, with one int32 counter per (bh, q tile),
//     also zeroed. Tile kt adds its partial to q tile qt only when that
//     counter equals kt (thread 0 polls with ld.acquire.gpu), with plain
//     loads and stores that bypass L1; then __threadfence, a barrier, and
//     the counter is released (st.release.gpu) as kt + 1. Every dQ element
//     is thus summed over key tiles 0, 1, 2, ... in that order, and two
//     launches give the same bits. The q tiles go downward so that every
//     tile starts at the last q tile at once and trails its predecessor by
//     one add; walking upward, tile kt could not start its first add until
//     tile kt - 1 had finished its second step.
//   * Forward progress without trusting the block scheduler's order. The
//     grid is SMs x cudaOccupancyMaxActiveBlocksPerMultiprocessor blocks
//     (one a SM at D = 128), each claiming work tiles in turn with
//     atomicAdd on a zeroed ticket, heaviest first: ticket t is (kt = t /
//     BH, bh = t % BH). The tile any wait depends on, (kt - 1, bh), has an
//     earlier ticket, so a running block holds it or has finished it; a
//     block that has not started holds none. Every poll is bounded
//     (SINGA_FLASH_POLL_LIMIT, then __trap), so a design fault fails the
//     launch instead of hanging.
//   * Asynchronous copies. The next q tile's Q, dO, lse and delta come in
//     with cp.async (two stages) while the current one computes.
//   * Register tiles and shared loads. A warp's 32 threads cover 4 rows x 8
//     columns of the 16 x 16 thread grid (ty, tx), so each operand load of
//     a warp touches 4 or 8 distinct 16-byte chunks: one shared wavefront.
//     Scores: thread (ty, tx) holds keys ty + 16i and queries tx + 16j,
//     4 x 4, 8 float4 loads per 64 FMAs. dK and dV: keys ty + 16i and
//     columns 64g + 4tx + e, 4 x D/16 each (4 x 8 at D = 128), 12 float4
//     loads per 128 FMAs. dQ: queries 4ty + i, same columns, 3 float4 loads
//     per 32 FMAs.
//   * One P/dS buffer. A second Q/dO stage does not fit beside separate P
//     and dS tiles at D = 128 (238,080 B against the 232,448 a block may
//     use), so P and dS share one (64 keys, 64 queries) tile, row = key,
//     padded to 68: dV's product reads P, a barrier, then dS overwrites it
//     (the thread keeps dS in registers meanwhile). dS is read in two
//     orientations: over queries for dK (a float4 of 4 queries for each of
//     a thread's 4 keys) and over keys for dQ (a float4 of the thread's 4
//     consecutive queries for each key). Both read dS as one float4 per 4
//     of its elements, with no transposed copy. Shared memory at
//     D = 128: K, V, two Q and two dO stages (64 x 132 floats each), the
//     P/dS tile, lse and delta stages: 221,200 B.
//   * Scale. P takes S * scale inside the exponent; dK is scaled once, in
//     registers, when the tile stores it; dQ is scaled once by its last
//     contributor (key tile qt when causal, nt - 1 when not), after the
//     last add: one rounding a dK and dQ element, as the plain version.
// Registers at D = 128: dK and dV (32 each) for the tile's life, the dQ
// partial (32) and the scores (16 + 16) in turn; ptxas must report no
// spills (chip_smoke checks).
//
// C interface, bound with ctypes: every pointer and the stream are void*,
// dtype must be 0 (float32), the launch is on the given stream, and each
// launching entry returns cudaGetLastError() (0 = launched);
// singa_flash_fwd_blocks_per_sm returns the forward's resident blocks an
// SM (or minus a CUDA error). singa_flash_bwd's scratch is int32, zeroed by the caller: kScratchHead ints (three uint64
// statistics: cycles thread 0 of each block spent polling, cycles each
// block ran, blocks run; then the ticket), then BH * (S / 64) counters.

#include <cuda_runtime.h>

#include <type_traits>

#ifndef SINGA_FLASH_POLL_LIMIT
// ~30 s of polling at the latency of an L2 round trip; a legal wait is one
// predecessor's step, well under a millisecond
#define SINGA_FLASH_POLL_LIMIT (1LL << 26)
#endif

namespace {

constexpr int kTile = 64;       // query rows and key rows per tile
constexpr int kThreads = 256;   // 16 x 16: thread (ty, tx), ty = tid / 16
constexpr float kNegInf = -1e30f;
constexpr int kScratchHead = 8;  // scratch ints before the counters
constexpr int kTicket = 6;       // the ticket's index in the scratch
constexpr int kFwdGroups = 2;        // the forward's key groups a block
constexpr int kFwdGroupThreads = 128;  // threads a key group
constexpr int kFwdThreads = kFwdGroups * kFwdGroupThreads;
// lanes that share a forward q row (each holds 64 / kFwdKeyLanes of its
// keys); a warp holds 32 / kFwdKeyLanes rows at a time
constexpr int kFwdKeyLanes = 16;
constexpr int kFwdKeys = kTile / kFwdKeyLanes;  // keys a thread
// a forward thread's q rows lie kFwdRowStep apart; kFwdRows of them
constexpr int kFwdRowStep = kFwdGroupThreads / kFwdKeyLanes;
constexpr int kFwdRows = kTile / kFwdRowStep;

template <int D>
struct Geo {
  static constexpr int LD = D + 4;          // padded row stride of a (64, D) tile
  static constexpr int TILE = kTile * LD;   // floats of a (64, D) tile
  static constexpr int LDP = kTile + 4;     // padded row stride of a (64, 64) tile
  static constexpr int PTILE = kTile * LDP;
  static constexpr int NC = D / 16;         // output columns per thread
  static constexpr int LDF = kTile + kFwdKeyLanes;  // the forward's P rows
  static constexpr int FTILE = kTile * LDF;
};

__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : (u == 1 ? v.y : (u == 2 ? v.z : v.w));
}

// max / sum over the kFwdKeyLanes lanes that share a forward row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = kFwdKeyLanes / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = kFwdKeyLanes / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without the registers (L2 only: .cg)
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// every copy group but the newest has landed
__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// every copy group has landed
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the barrier of the forward's key group g alone (named barrier 1 + g;
// barrier 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(g + 1), "r"(kFwdGroupThreads)
               : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// (64, D) float32 tile at src (row stride D) -> shared tile (stride LD),
// issued as cp.async by THREADS threads (t: this thread's index among
// them), landing at a later wait
template <int D, int THREADS = kThreads>
__device__ __forceinline__ void copy_tile(const float* __restrict__ src,
                                          float* dst, int t) {
  constexpr int PER_ROW = D / 4;
  constexpr int PER_THREAD = kTile * PER_ROW / THREADS;
  static_assert(kTile * PER_ROW % THREADS == 0, "tile must split evenly");
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int c = t + i * THREADS;
    const int r = c / PER_ROW, col = (c - r * PER_ROW) * 4;
    cp_async16(smem_u32(dst + r * Geo<D>::LD + col), src + (size_t)r * D + col);
  }
}

// ---------------------------------------------------------------------------
// the forward
// ---------------------------------------------------------------------------

// A forward thread's place in its key group: warp w, lane (ry, kx) =
// (l / kFwdKeyLanes, l % kFwdKeyLanes); its q rows are row + kFwdRowStep
// i (i < kFwdRows), row = (32 / kFwdKeyLanes) w + ry; its keys kx +
// kFwdKeyLanes j (j < kFwdKeys); its output columns 4 kx + 4 kFwdKeyLanes
// c + e
struct FwdThread {
  int row, kx;
  __device__ explicit FwdThread(int t) {
    const int w = t >> 5, l = t & 31;
    row = (32 / kFwdKeyLanes) * w + l / kFwdKeyLanes;
    kx = l % kFwdKeyLanes;
  }
};

// s[i][j] = sum_d Q[row + kFwdRowStep i][d] * K[kx + kFwdKeyLanes j][d]
template <int D>
__device__ __forceinline__ void fwd_scores(const float* Q, const float* K,
                                           float s[kFwdRows][kFwdKeys],
                                           FwdThread th) {
  constexpr int LD = Geo<D>::LD;
  const float* a = Q + th.row * LD;
  const float* b = K + th.kx * LD;
#pragma unroll
  for (int i = 0; i < kFwdRows; ++i)
#pragma unroll
    for (int j = 0; j < kFwdKeys; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[kFwdRows], bv[kFwdKeys];
#pragma unroll
    for (int i = 0; i < kFwdRows; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + kFwdRowStep * i * LD + d);
#pragma unroll
    for (int j = 0; j < kFwdKeys; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + kFwdKeyLanes * j * LD + d);
#pragma unroll
    for (int i = 0; i < kFwdRows; ++i)
#pragma unroll
      for (int j = 0; j < kFwdKeys; ++j) {
        float t = s[i][j];
        t = fmaf(av[i].x, bv[j].x, t);
        t = fmaf(av[i].y, bv[j].y, t);
        t = fmaf(av[i].z, bv[j].z, t);
        t = fmaf(av[i].w, bv[j].w, t);
        s[i][j] = t;
      }
  }
}

// acc[i][4c+e] += sum_kk P[row + kFwdRowStep i][kk] *
// V[kk][4 kx + 4 kFwdKeyLanes c + e]
template <int D>
__device__ __forceinline__ void fwd_pv(const float* P, const float* V,
                                       float acc[kFwdRows][D / kFwdKeyLanes],
                                       FwdThread th) {
  constexpr int LD = Geo<D>::LD, LDF = Geo<D>::LDF;
  constexpr int C = D / (4 * kFwdKeyLanes);
  const float* p = P + th.row * LDF;
  const float* v = V + 4 * th.kx;
#pragma unroll 4
  for (int kk = 0; kk < kTile; kk += 4) {
    float4 pv[kFwdRows];
#pragma unroll
    for (int i = 0; i < kFwdRows; ++i)
      pv[i] = *reinterpret_cast<const float4*>(p + kFwdRowStep * i * LDF + kk);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(
            v + (kk + u) * LD + 4 * kFwdKeyLanes * c);
#pragma unroll
        for (int i = 0; i < kFwdRows; ++i) {
          const float pu = comp(pv[i], u);
          acc[i][4 * c + 0] = fmaf(pu, vv.x, acc[i][4 * c + 0]);
          acc[i][4 * c + 1] = fmaf(pu, vv.y, acc[i][4 * c + 1]);
          acc[i][4 * c + 2] = fmaf(pu, vv.z, acc[i][4 * c + 2]);
          acc[i][4 * c + 3] = fmaf(pu, vv.w, acc[i][4 * c + 3]);
        }
      }
    }
  }
}

template <int D>
constexpr size_t fwd_smem_bytes() {
  // Q; then per key group K, V and P
  return (Geo<D>::TILE + kFwdGroups * (2 * Geo<D>::TILE + Geo<D>::FTILE)) *
         sizeof(float);
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kFwdThreads, 1) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse, int BH, int S, float scale) {
  using G = Geo<D>;
  constexpr int NA = D / kFwdKeyLanes;  // output columns a thread, per row
  constexpr int GT = kFwdGroupThreads;
  extern __shared__ uint4 smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  const int g = threadIdx.x / GT, lt = threadIdx.x % GT;
  float* Ks = Qs + G::TILE + g * (2 * G::TILE + G::FTILE);
  float* Vs = Ks + G::TILE;
  float* Ps = Vs + G::TILE;

  const int nt = S / kTile, t = (int)blockIdx.x;
  const int qt = nt - 1 - t / BH, bh = t % BH;  // heaviest causal tiles first
  const size_t base = (size_t)bh * S * D;
  const int q0 = qt * kTile;
  const int nlive = CAUSAL ? qt + 1 : nt;
  const FwdThread th(lt);
  const float sc = scale * 1.4426950408889634f;  // e^x = 2^(x log2(e))

  copy_tile<D, kFwdThreads>(q + base + (size_t)q0 * D, Qs, threadIdx.x);
  if (g < nlive) copy_tile<D, GT>(k + base + (size_t)g * kTile * D, Ks, lt);
  cp_commit();
  cp_wait_all();
  __syncthreads();  // Q and each group's first K tile, for every thread

  float m[kFwdRows], l[kFwdRows], acc[kFwdRows][NA];
#pragma unroll
  for (int i = 0; i < kFwdRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NA; ++c) acc[i][c] = 0.f;
  }

  for (int kt = g; kt < nlive; kt += kFwdGroups) {
    const int k0 = kt * kTile;
    // K_kt is in; V and P are free
    copy_tile<D, GT>(v + base + (size_t)k0 * D, Vs, lt);
    cp_commit();
    float s[kFwdRows][kFwdKeys];
    fwd_scores<D>(Qs, Ks, s, th);
    // P = e^((S - m) scale) = 2^(S sc - m sc), one FMA and exp2f, into
    // Ps; m is the row max of the raw scores; the row statistics and the
    // accumulator rescaled; the causal mask only on the diagonal tile,
    // below which every key is visible
    auto softmax = [&](auto masked) {
#pragma unroll
      for (int i = 0; i < kFwdRows; ++i) {
        const int qpos = q0 + th.row + kFwdRowStep * i;
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < kFwdKeys; ++j) {
          const bool ok =
              !decltype(masked)::value || k0 + th.kx + kFwdKeyLanes * j <= qpos;
          s[i][j] = ok ? s[i][j] : kNegInf;
          mx = fmaxf(mx, s[i][j]);
        }
        const float m_new = fmaxf(m[i], row_max(mx));
        const float alpha = exp2f((m[i] - m_new) * sc);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kFwdKeys; ++j) {
          const bool ok =
              !decltype(masked)::value || k0 + th.kx + kFwdKeyLanes * j <= qpos;
          const float p = ok ? exp2f(fmaf(s[i][j], sc, -m_new * sc)) : 0.f;
          Ps[(th.row + kFwdRowStep * i) * G::LDF + th.kx + kFwdKeyLanes * j] =
              p;
          sum += p;
        }
        l[i] = l[i] * alpha + sum;  // this lane's keys; the row's at the end
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < NA; ++c) acc[i][c] *= alpha;
      }
    };
    if (CAUSAL && kt == qt) softmax(std::true_type{});
    else softmax(std::false_type{});
    cp_wait_all();  // this thread's part of V_kt
    group_sync(g);  // P and V_kt visible to the group; K_kt read
    if (kt + kFwdGroups < nlive) {
      copy_tile<D, GT>(k + base + (size_t)(k0 + kFwdGroups * kTile) * D, Ks,
                       lt);
      cp_commit();
    }
    fwd_pv<D>(Ps, Vs, acc, th);
    cp_wait_all();  // this thread's part of the next K tile
    group_sync(g);  // the next K tile visible; P and V read
  }

#pragma unroll
  for (int i = 0; i < kFwdRows; ++i) l[i] = row_sum(l[i]);
  if constexpr (kFwdGroups == 2) {
    // group 1 hands m, l and its accumulator to group 0 through its own
    // K/V tiles, one column of GT floats a value (conflict-free)
    static_assert((2 + NA) * kFwdRows * GT <= 2 * G::TILE, "merge space");
    float* x = Qs + G::TILE + (2 * G::TILE + G::FTILE);
    if (g == 1) {
#pragma unroll
      for (int i = 0; i < kFwdRows; ++i) {
        x[(2 * i) * GT + lt] = m[i];
        x[(2 * i + 1) * GT + lt] = l[i];
#pragma unroll
        for (int c = 0; c < NA; ++c)
          x[(2 * kFwdRows + i * NA + c) * GT + lt] = acc[i][c];
      }
    }
    __syncthreads();
    if (g == 1) return;
#pragma unroll
    for (int i = 0; i < kFwdRows; ++i) {
      const float m1 = x[(2 * i) * GT + lt];
      const float l1 = x[(2 * i + 1) * GT + lt];
      const float mm = fmaxf(m[i], m1);
      const float a0 = exp2f((m[i] - mm) * sc), a1 = exp2f((m1 - mm) * sc);
      l[i] = l[i] * a0 + l1 * a1;
      m[i] = mm;
#pragma unroll
      for (int c = 0; c < NA; ++c)
        acc[i][c] =
            acc[i][c] * a0 + x[(2 * kFwdRows + i * NA + c) * GT + lt] * a1;
    }
  }

#pragma unroll
  for (int i = 0; i < kFwdRows; ++i) {
    const int r = q0 + th.row + kFwdRowStep * i;
    const float safe = l[i] == 0.f ? 1.f : l[i];
    const float inv = 1.f / safe;
    if (th.kx == 0) lse[(size_t)bh * S + r] = m[i] * scale + logf(safe);
    float* o = out + base + (size_t)r * D + 4 * th.kx;
#pragma unroll
    for (int c = 0; c < NA / 4; ++c)
      *reinterpret_cast<float4*>(o + 4 * kFwdKeyLanes * c) =
          make_float4(acc[i][4 * c] * inv, acc[i][4 * c + 1] * inv,
                      acc[i][4 * c + 2] * inv, acc[i][4 * c + 3] * inv);
  }
}

// ---------------------------------------------------------------------------
// the fused backward
// ---------------------------------------------------------------------------

// The backward's thread grid: warp w covers ty in 4 (w / 2) .. + 3 and tx
// in 8 (w % 2) .. + 7
struct BwdThread {
  int ty, tx;
  __device__ BwdThread() {
    const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
    ty = 4 * (w >> 1) + (l >> 3);
    tx = 8 * (w & 1) + (l & 7);
  }
};

// acc[i][j] = sum_d A[ty + 16i][d] * B[tx + 16j][d]; A, B (64, D) shared
// tiles: 4 distinct A rows and 8 distinct B rows a warp, one wavefront each
template <int D>
__device__ __forceinline__ void score_t(const float* A, const float* B,
                                        float acc[4][4], BwdThread th) {
  constexpr int LD = Geo<D>::LD;
  const float* a = A + th.ty * LD;
  const float* b = B + th.tx * LD;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + 16 * i * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + 16 * j * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t = acc[i][j];
        t = fmaf(av[i].x, bv[j].x, t);
        t = fmaf(av[i].y, bv[j].y, t);
        t = fmaf(av[i].z, bv[j].z, t);
        t = fmaf(av[i].w, bv[j].w, t);
        acc[i][j] = t;
      }
  }
}

// acc[i][4g+e] += sum_c A[ty + 16i][c] * B[c][64g + 4tx + e]: A a (64, 64)
// shared tile over its rows (P or dS, row = key), B a (64, D) tile (dO or Q)
template <int D>
__device__ __forceinline__ void rows_times_tile(const float* A,
                                                const float* B,
                                                float acc[4][Geo<D>::NC],
                                                BwdThread th) {
  constexpr int LD = Geo<D>::LD, LDP = Geo<D>::LDP, G = D / 64;
  const float* a = A + th.ty * LDP;
  const float* b = B + th.tx * 4;
#pragma unroll 4
  for (int c = 0; c < kTile; c += 4) {
    float4 av[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + 16 * i * LDP + c);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 bv =
            *reinterpret_cast<const float4*>(b + (c + u) * LD + 64 * g);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float au = comp(av[i], u);
          acc[i][4 * g + 0] = fmaf(au, bv.x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(au, bv.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(au, bv.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(au, bv.w, acc[i][4 * g + 3]);
        }
      }
    }
  }
}

// acc[i][4g+e] = sum_r A[r][4ty + i] * B[r][64g + 4tx + e]: A the (64, 64)
// dS tile down its columns (one float4 of 4 queries a key), B the K tile
template <int D>
__device__ __forceinline__ void cols_times_tile(const float* A,
                                                const float* B,
                                                float acc[4][Geo<D>::NC],
                                                BwdThread th) {
  constexpr int LD = Geo<D>::LD, LDP = Geo<D>::LDP, G = D / 64;
  const float* a = A + 4 * th.ty;
  const float* b = B + th.tx * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < Geo<D>::NC; ++c) acc[i][c] = 0.f;
#pragma unroll 8
  for (int r = 0; r < kTile; ++r) {
    const float4 av = *reinterpret_cast<const float4*>(a + r * LDP);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float4 bv = *reinterpret_cast<const float4*>(b + r * LD + 64 * g);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ai = comp(av, i);
        acc[i][4 * g + 0] = fmaf(ai, bv.x, acc[i][4 * g + 0]);
        acc[i][4 * g + 1] = fmaf(ai, bv.y, acc[i][4 * g + 1]);
        acc[i][4 * g + 2] = fmaf(ai, bv.z, acc[i][4 * g + 2]);
        acc[i][4 * g + 3] = fmaf(ai, bv.w, acc[i][4 * g + 3]);
      }
    }
  }
}

// Q, dO, lse and delta of the q tile at row q0 -> one stage (cp.async)
template <int D>
__device__ __forceinline__ void copy_stage(
    const float* __restrict__ q, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* Qs, float* dOs, float* lse_s, float* del_s) {
  copy_tile<D>(q, Qs, threadIdx.x);
  copy_tile<D>(dout, dOs, threadIdx.x);
  if (threadIdx.x < kTile / 4)
    cp_async16(smem_u32(lse_s + 4 * threadIdx.x), lse + 4 * threadIdx.x);
  else if (threadIdx.x < kTile / 2)
    cp_async16(smem_u32(del_s + 4 * (threadIdx.x - kTile / 4)),
               delta + 4 * (threadIdx.x - kTile / 4));
}

template <int D>
constexpr size_t bwd_smem_bytes() {
  // K, V, Q x 2, dO x 2; P/dS; lse x 2, delta x 2; the claimed ticket
  return (6 * Geo<D>::TILE + Geo<D>::PTILE + 4 * kTile + 4) * sizeof(float);
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* dq, float* __restrict__ dk, float* __restrict__ dv,
    int* scratch, int BH, int S, float scale) {
  using G = Geo<D>;
  extern __shared__ uint4 smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + G::TILE;
  float* Qs = Vs + G::TILE;           // two stages
  float* dOs = Qs + 2 * G::TILE;      // two stages
  float* PS = dOs + 2 * G::TILE;      // P, then dS; row = key
  float* lse_s = PS + G::PTILE;       // two stages
  float* del_s = lse_s + 2 * kTile;   // two stages
  int* claimed = reinterpret_cast<int*>(del_s + 2 * kTile);

  const long long t_start = clock64();
  long long polled = 0;
  const BwdThread th;
  const int nt = S / kTile, total = nt * BH;
  int* counters = scratch + kScratchHead;

  for (;;) {
    if (threadIdx.x == 0) *claimed = atomicAdd(scratch + kTicket, 1);
    __syncthreads();  // also: the previous tile's shared tiles are read
    const int t = *claimed;
    if (t >= total) break;
    const int kt = t / BH, bh = t - kt * BH;  // heaviest (lowest kt) first
    const int k0 = kt * kTile, first = CAUSAL ? kt : 0;
    const size_t base = (size_t)bh * S * D, rbase = (size_t)bh * S;

    copy_tile<D>(k + base + (size_t)k0 * D, Ks, threadIdx.x);
    copy_tile<D>(v + base + (size_t)k0 * D, Vs, threadIdx.x);
    copy_stage<D>(q + base + (size_t)(nt - 1) * kTile * D,
                  dout + base + (size_t)(nt - 1) * kTile * D,
                  lse + rbase + (nt - 1) * kTile,
                  delta + rbase + (nt - 1) * kTile, Qs, dOs, lse_s, del_s);
    cp_commit();

    float dk_acc[4][G::NC], dv_acc[4][G::NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < G::NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

    for (int qt = nt - 1, st = 0; qt >= first; --qt, st ^= 1) {
      const int q0 = qt * kTile;
      float* Qc = Qs + st * G::TILE;
      float* dOc = dOs + st * G::TILE;
      const float* lse_c = lse_s + st * kTile;
      const float* del_c = del_s + st * kTile;
      if (qt > first) {
        const int qn = q0 - kTile;
        copy_stage<D>(q + base + (size_t)qn * D, dout + base + (size_t)qn * D,
                      lse + rbase + qn, delta + rbase + qn,
                      Qs + (st ^ 1) * G::TILE, dOs + (st ^ 1) * G::TILE,
                      lse_s + (st ^ 1) * kTile, del_s + (st ^ 1) * kTile);
      }
      cp_commit();
      cp_wait_one();  // this stage (and K, V) landed; the next may not have
      __syncthreads();

      // transposed scores: rows are keys (ty + 16i), columns queries
      // (tx + 16j)
      float s[4][4], ds[4][4];
      score_t<D>(Ks, Qc, s, th);
      score_t<D>(Vs, dOc, ds, th);
      float lq[4], dl[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lq[j] = lse_c[th.tx + 16 * j];
        dl[j] = del_c[th.tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int krow = th.ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qcol = th.tx + 16 * j;
          const bool ok = !CAUSAL || q0 + qcol >= k0 + krow;
          const float p = ok ? expf(s[i][j] * scale - lq[j]) : 0.f;
          PS[krow * G::LDP + qcol] = p;
          ds[i][j] = p * (ds[i][j] - dl[j]);
        }
      }
      __syncthreads();
      rows_times_tile<D>(PS, dOc, dv_acc, th);  // dV += P^T dO
      __syncthreads();                         // P is read: dS replaces it
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          PS[(th.ty + 16 * i) * G::LDP + th.tx + 16 * j] = ds[i][j];
      __syncthreads();
      rows_times_tile<D>(PS, Qc, dk_acc, th);  // dK += dS^T Q
      float part[4][G::NC];
      cols_times_tile<D>(PS, Ks, part, th);    // dQ partial = dS K

      // add the partial to q tile qt's dQ after key tiles 0 .. kt - 1
      int* ctr = counters + (size_t)bh * nt + qt;
      if (threadIdx.x == 0) {
        const long long p0 = clock64();
        for (long long n = 0; ld_acquire(ctr) != kt;) {
          if (++n > SINGA_FLASH_POLL_LIMIT) {
            __trap();
            break;
          }
        }
        polled += clock64() - p0;
      }
      __syncthreads();
      const bool last = kt == (CAUSAL ? qt : nt - 1);
      float* dst = dq + base + (size_t)q0 * D;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int g = 0; g < D / 64; ++g) {
          float4* p = reinterpret_cast<float4*>(
              dst + (size_t)(4 * th.ty + i) * D + 64 * g + 4 * th.tx);
          float4 o = __ldcg(p);
          o.x += part[i][4 * g + 0];
          o.y += part[i][4 * g + 1];
          o.z += part[i][4 * g + 2];
          o.w += part[i][4 * g + 3];
          if (last) {
            o.x *= scale;
            o.y *= scale;
            o.z *= scale;
            o.w *= scale;
          }
          __stcg(p, o);
        }
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) st_release(ctr, kt + 1);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const size_t row = (size_t)(k0 + th.ty + 16 * i) * D;
#pragma unroll
      for (int g = 0; g < D / 64; ++g) {
        const int col = 64 * g + 4 * th.tx;
        *reinterpret_cast<float4*>(dk + base + row + col) = make_float4(
            dk_acc[i][4 * g] * scale, dk_acc[i][4 * g + 1] * scale,
            dk_acc[i][4 * g + 2] * scale, dk_acc[i][4 * g + 3] * scale);
        *reinterpret_cast<float4*>(dv + base + row + col) =
            make_float4(dv_acc[i][4 * g], dv_acc[i][4 * g + 1],
                        dv_acc[i][4 * g + 2], dv_acc[i][4 * g + 3]);
      }
    }
  }
  if (threadIdx.x == 0) {
    unsigned long long* stats = reinterpret_cast<unsigned long long*>(scratch);
    atomicAdd(stats + 0, (unsigned long long)polled);
    atomicAdd(stats + 1, (unsigned long long)(clock64() - t_start));
    atomicAdd(stats + 2, 1ULL);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int N>
using IntC = std::integral_constant<int, N>;

// call f(IntC<D>, bool_constant<causal>) for the runtime choice; dtype 0
// (float32) only: bfloat16 has its own kernels
template <typename F>
int dispatch(int dtype, int D, int causal, F f) {
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  if (D == 64)
    return causal ? f(IntC<64>{}, std::true_type{})
                  : f(IntC<64>{}, std::false_type{});
  if (D == 128)
    return causal ? f(IntC<128>{}, std::true_type{})
                  : f(IntC<128>{}, std::false_type{});
  return (int)cudaErrorInvalidValue;
}

// above 48 KB only as dynamic shared memory, after this attribute
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool bad_shape(int BH, int S) {
  return BH <= 0 || BH > 65535 || S <= 0 || S % kTile != 0;
}

}  // namespace

// One block per (q tile, bh), numbered heaviest causal tile first over
// every bh.
extern "C" int singa_flash_fwd(const void* q, const void* k, const void* v,
                               void* out, void* lse, int BH, int S, int D,
                               int dtype, int causal, float scale,
                               void* stream) {
  if (bad_shape(BH, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, D, causal, [&](auto d, auto c) -> int {
    constexpr int DD = decltype(d)::value;
    constexpr bool C = decltype(c)::value;
    constexpr size_t smem = fwd_smem_bytes<DD>();
    auto kern = flash_fwd_kernel<DD, C>;
    const int e = allow_smem(kern, smem);
    if (e != 0) return e;
    kern<<<dim3((S / kTile) * BH), kFwdThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out),
        static_cast<float*>(lse), BH, S, scale);
    return (int)cudaGetLastError();
  });
}

// The forward's resident blocks an SM at head width D (the occupancy
// query on its shared memory and threads) -> that count, or minus a CUDA
// error.
extern "C" int singa_flash_fwd_blocks_per_sm(int D, int causal) {
  return dispatch(0, D, causal, [&](auto d, auto c) -> int {
    constexpr int DD = decltype(d)::value;
    constexpr size_t smem = fwd_smem_bytes<DD>();
    auto kern = flash_fwd_kernel<DD, decltype(c)::value>;
    int n = 0, e = allow_smem(kern, smem);
    if (e == 0)
      e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kern, kFwdThreads, smem);
    return e != 0 ? -e : n;
  });
}

// dQ, dK and dV in one launch. dq and scratch must be zeroed (dq is the
// accumulator; scratch holds the statistics, the ticket and the counters).
extern "C" int singa_flash_bwd(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, void* dk,
                               void* dv, void* scratch, int BH, int S, int D,
                               int dtype, int causal, float scale,
                               void* stream) {
  if (bad_shape(BH, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, D, causal, [&](auto d, auto c) -> int {
    constexpr int DD = decltype(d)::value;
    constexpr bool C = decltype(c)::value;
    constexpr size_t smem = bwd_smem_bytes<DD>();
    auto kern = flash_bwd_kernel<DD, C>;
    int e = allow_smem(kern, smem);
    if (e != 0) return e;
    // only blocks that can be resident at once: a block that waits on a
    // counter then waits on one that runs
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = (int)cudaGetDevice(&dev)) != 0 ||
        (e = (int)cudaDeviceGetAttribute(
             &sms, cudaDevAttrMultiProcessorCount, dev)) != 0 ||
        (e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kern, kThreads, smem)) != 0)
      return e;
    if (sms < 1 || per_sm < 1) return (int)cudaErrorInvalidValue;
    kern<<<dim3(sms * per_sm), kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dq), static_cast<float*>(dk),
        static_cast<float*>(dv), static_cast<int*>(scratch), BH, S, scale);
    return (int)cudaGetLastError();
  });
}
