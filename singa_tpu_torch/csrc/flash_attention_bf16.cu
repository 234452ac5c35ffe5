// Flash attention in bfloat16 on Hopper's tensor cores (sm_90a): the
// forward and the backward (dQ, dK/dV), causal or full, over
// (batch * heads, S, D) rows, D 64 or 128, any S that is a multiple of 64.
// The three kernels share one set of primitives below (cp.async, ldmatrix,
// mma.sync, the swizzle), so they live in one file: the build hashes each
// .cu alone, and a shared header would load stale libraries.
//
// Replaces, for bfloat16 inputs, the Pallas TPU kernels of
// singa_tpu/ops/attention.py:
//   flash_fwd_bf16     <- _flash_kernel_staged (:386) and _flash_kernel (:210),
//                         launched by _flash_fwd_impl (:552, sites :570, :589)
//   flash_bwd_dq_bf16  <- _flash_bwd_dq_staged (:419) and _flash_bwd_dq_kernel (:268)
//   flash_bwd_dkv_bf16 <- _flash_bwd_dkv_staged (:451) and _flash_bwd_dkv_kernel (:316)
// the last two launched by _flash_bwd (:615, sites :644, :655, :673, :690).
// Float32 stays on the CUDA-core kernels of flash_attention.cu (TF32 tensor
// cores would break the float32 tolerances and the port's no-TF32
// contract).
//
// What each computes (scale = 1/sqrt(D); masked probabilities exactly 0):
//   forward: O = softmax(Q K^T * scale) V by online softmax over the live
//            key tiles; lse = m + log(l) in float32, (BH, S), natural log
//            (what the backward reads); a row with l == 0 emits 0.
//   P  = exp(S * scale - lse), S = Q K^T
//   dS = P * (dO V^T - delta), delta = rowsum(dO * O) computed outside
//   dQ = scale * dS K;  dV = P^T dO;  dK = scale * dS^T Q
// S and dP = dO V^T are float32 sums of bf16 products. P (forward and
// backward) and dS are formed in float32 in the accumulator fragments and
// rounded ONCE to bf16 to feed the next product (FlashAttention-2 does the
// same; the JAX kernels keep them in float32, so this is a documented
// difference, bounded on the CPU by tests/test_torch_flash_fwd.py and
// tests/test_torch_flash_bwd.py). The forward's running max m and sum l
// are float32, l summed from the float32 P before that rounding; dP -
// delta is taken in float32 before the rounding of dS. Every other sum is
// float32.
//
// Bound on the H100: operations. The forward does 2, dQ 3 and dK/dV 4
// products of 2*D operations per visible (q, k) pair; at B*H = 2, S =
// 8192, D = 128, causal that is 35, 52 and 69 GFLOP, 0.035, 0.052 and
// 0.069 ms at 989 TFLOP/s, while the bytes (each input read once, each
// output written once) take 0.005-0.006 ms at 3.35 TB/s.
//
// Design (mma.sync, the simple right start; wgmma/TMA/warp specialisation
// are later work):
//   * All products on the tensor cores: mma.sync.m16n8k16 bf16 x bf16 ->
//     f32, operands from shared memory by ldmatrix (.trans where the B
//     operand is stored row-major over its k dimension: V in P V, K in
//     dS K, dO in P^T dO, Q in dS^T Q). The m16n8 f32 score fragments of
//     two adjacent 8-column tiles are exactly the A fragment of a k16
//     step, so P and dS go from the accumulators into the next product in
//     registers, with no shared-memory round trip.
//   * bf16 tiles in shared memory (64 x D: 16 KB at D = 128), 16-byte
//     chunks XOR-swizzled by row (chunk ^ (row & 7)), so the 8 rows that
//     one ldmatrix phase reads hit 8 distinct bank groups.
//   * cp.async.cg 16-byte copies, double-buffered: the next K/V tile
//     (forward, dQ) or Q/dO/lse/delta tile (dK/dV) lands while this one
//     computes.
//   * Forward: a block owns 64 query rows; each of its kFwdGroups key
//     groups is 4 warps, a warp owning 16 rows across the whole 64-key
//     tile, its Q fragments held in registers, and group u folds key
//     tiles u, u + G, ... A row's max and sum reduce over the 4 lanes of
//     a quad (__shfl_xor_sync 1, 2) with no shared-memory exchange; l is
//     kept per lane and reduced once at the end, after the groups' (o, m,
//     l) merge in group order through shared memory. Two groups halve the
//     heaviest causal tile's path: at B*H 2, S 8192 every block is
//     resident at once, and one group a block left the SMs that hold the
//     heaviest tiles with twice the mean work (H100, B*H 2, S 8192, D
//     128, causal: two groups 0.153 ms; one group 0.270-0.273; 8 warps
//     over 128 rows 0.281; tools/flash_bwd_variants.py). Two groups lose
//     8-9% where many waves balance the load anyway (S 32768; non-causal
//     B*H 8): they keep one block per SM (144 KB of shared memory).
//     Causal: a warp skips a key tile wholly above its rows and masks
//     only a tile that crosses its diagonal. 2^x by fast_exp2 with scale *
//     log2(e) folded into one FMA; lse = m * scale + log(l), natural log.
//   * Backward: 8 warps per block of 64 rows: warp (wm, wn) owns rows
//     16wm..16wm+15 and columns 32wn..32wn+31 of each 64 x 64 score
//     tile, and accumulates a partial dQ (or dK, dV) over its 32 columns
//     for all D. The two partials of a row are summed once per output
//     tile, through shared memory, in a fixed order. This keeps the
//     per-thread accumulators at 4*D/8 floats each (dK/dV: 2 x 64 at
//     D = 128), so one 256-thread block holds its rows in registers
//     without spills.
//   * No atomics anywhere: each block owns its output rows, so two
//     launches on the same inputs give bitwise-equal outputs.
//   * Causal balance: one block per row tile, heaviest first (forward, dQ:
//     the last query tile, which sees every key tile; dK/dV: key tile 0).
//     The next tile goes to whichever SM frees first: a longest-first
//     schedule. Pairing tiles i and nt-1-i in one block (nt + 1 steps
//     each) measured 1-5% slower for the backward on an H100 (B*H 2-8, S
//     8192-32768, D 64 and 128; tools/flash_bwd_variants.py, variant
//     paired).
//   * Shared memory at D = 128: forward 16 + 64 * kFwdGroups KB (Q, and
//     each group's K and V double-buffered); dQ 96 KB; dK/dV 97 KB.
//
// C interface, bound with ctypes, the same argument list as the entries of
// flash_attention.cu: every pointer and the stream are void*, dtype must be
// 1 (bfloat16), the launch is on the given stream, and each function
// returns cudaGetLastError() (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;      // query rows and key rows per tile
constexpr int kThreads = 256;  // backward: 8 warps, (wm, wn) = (warp & 3, warp >> 2)
// forward: key groups of a block; each group is 4 warps over the block's
// 64 query rows and folds every G-th key tile
constexpr int kFwdGroups = 2;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;  // masked score, as the JAX kernels

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// byte address of the 16-byte chunk `ch` of row `r` of a swizzled (64, D)
// bf16 tile at shared address `base`
template <int D>
__device__ __forceinline__ unsigned chunk_addr(unsigned base, int r, int ch) {
  return base + (unsigned)((r * D + ((ch ^ (r & 7)) << 3)) * 2);
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// (ROWS, D) bf16 rows at src (row stride D) -> swizzled tile at base,
// copied by the block's THREADS threads
template <int D, int ROWS = kTile, int THREADS = kThreads>
__device__ __forceinline__ void load_tile(unsigned base,
                                          const bf16* __restrict__ src) {
  constexpr int CH = D / 8;
  static_assert(ROWS * CH % THREADS == 0, "tile must split evenly");
#pragma unroll
  for (int i = 0; i < ROWS * CH / THREADS; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int r = idx / CH, ch = idx % CH;
    cp_async16(chunk_addr<D>(base, r, ch), src + (size_t)r * D + ch * 8);
  }
}

// 64 floats of lse and of delta from row q0 into two shared vectors
__device__ __forceinline__ void load_rows(float* lse_s, float* del_s,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta) {
  if (threadIdx.x < 16)
    cp_async16(smem_u32(lse_s + 4 * threadIdx.x), lse + 4 * threadIdx.x);
  else if (threadIdx.x < 32)
    cp_async16(smem_u32(del_s + 4 * (threadIdx.x - 16)),
               delta + 4 * (threadIdx.x - 16));
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned r[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned addr, unsigned r[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float c[4], const unsigned a[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the special-function unit alone (ex2.approx.ftz: ~2 ulp, results
// below 2^-126 flushed to 0). exp2f adds range handling for subnormal
// results, which P = exp(S * scale - lse) <= 1 does not need: on an H100
// at B*H 2, S 8192, D 128, causal, exp2f in its place took dQ from 0.167
// to 0.204 ms and dK/dV from 0.255 to 0.278 ms, with bitwise-equal
// outputs (tools/flash_bwd_variants.py, variant exp2f).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

// Lane addresses of the three ldmatrix.x4 shapes (lane l, 16 x 16 block
// at row r0, 16-byte chunk c0):
//   A (rows x k, row-major):   matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15)
//                              in the order a0 a1 a2 a3
//   B stored [n][k] (no trans): b0 b1 of n-tile 0, then b0 b1 of n-tile 1
//   B stored [k][n] (.trans):   the same, from a tile stored k-major
template <int D>
__device__ __forceinline__ unsigned a_addr(unsigned base, int r0, int c0) {
  const int l = threadIdx.x & 31;
  return chunk_addr<D>(base, r0 + (l & 15), c0 + (l >> 4));
}
template <int D>
__device__ __forceinline__ unsigned bn_addr(unsigned base, int r0, int c0) {
  const int l = threadIdx.x & 31;
  return chunk_addr<D>(base, r0 + (l & 7) + ((l >> 4) << 3),
                       c0 + ((l >> 3) & 1));
}
template <int D>
__device__ __forceinline__ unsigned bt_addr(unsigned base, int r0, int c0) {
  const int l = threadIdx.x & 31;
  return chunk_addr<D>(base, r0 + (l & 7) + (((l >> 3) & 1) << 3),
                       c0 + (l >> 4));
}

// acc[j] (16 x 32 of scores, 4 n-tiles) = the A operand (16 rows, its
// fragment of k-step ks from a_of(ks, a)) times rows c0..c0+31 of tile B,
// contracted over D
template <int D, typename AOf>
__device__ __forceinline__ void scores(float acc[4][4], AOf a_of, unsigned B,
                                       int c0) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    unsigned a[4];
    a_of(ks, a);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      unsigned b[4];
      ldsm_x4(bn_addr<D>(B, c0 + 16 * jj, 2 * ks), b);
      mma(acc[2 * jj], a, b[0], b[1]);
      mma(acc[2 * jj + 1], a, b[2], b[3]);
    }
  }
}

// out[n] (16 x D) += p (16 x 32, the score fragments rounded to bf16)
// times rows r0..r0+31 of the k-major tile B
template <int D>
__device__ __forceinline__ void accumulate(float out[D / 8][4],
                                           const float p[4][4], unsigned B,
                                           int r0) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const unsigned a[4] = {pack(p[2 * kk][0], p[2 * kk][1]),
                           pack(p[2 * kk][2], p[2 * kk][3]),
                           pack(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int nd = 0; nd < D / 16; ++nd) {
      unsigned b[4];
      ldsm_x4_t(bt_addr<D>(B, r0 + 16 * kk, 2 * nd), b);
      mma(out[2 * nd], a, b[0], b[1]);
      mma(out[2 * nd + 1], a, b[2], b[3]);
    }
  }
}

// Sum the two column halves' partial outputs (warps wn = 0 and 1 hold the
// same fragment positions), in a fixed order, into wn = 0's registers.
// red: 128 * D / 2 floats of shared memory that no thread reads any more.
template <int D>
__device__ __forceinline__ void reduce_halves(float acc[D / 8][4], float* red,
                                              int wn) {
  const int slot = threadIdx.x & 127;  // (wm, lane)
  if (wn == 1) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(n * 4 + e) * 128 + slot] = acc[n][e];
  }
  __syncthreads();
  if (wn == 0) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += red[(n * 4 + e) * 128 + slot];
  }
}

// rows r0 + g and r0 + g + 8 of a (S, D) bf16 output at dst, times mul
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, int r0,
                                           const float acc[D / 8][4],
                                           float mul) {
  const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = 8 * n + 2 * t;
    *reinterpret_cast<unsigned*>(dst + (size_t)(r0 + g) * D + col) =
        pack(acc[n][0] * mul, acc[n][1] * mul);
    *reinterpret_cast<unsigned*>(dst + (size_t)(r0 + g + 8) * D + col) =
        pack(acc[n][2] * mul, acc[n][3] * mul);
  }
}

template <int D, bool CAUSAL, int G>
__global__ void __launch_bounds__(128 * G, 1) flash_fwd_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out,
    float* __restrict__ lse, int S, float scale) {
  constexpr int NT = 128 * G;      // threads: G key groups of 4 warps
  constexpr int TILE = kTile * D;  // bf16 elements of a tile
  extern __shared__ uint4 smem[];
  const unsigned Qs = smem_u32(smem);
  // double-buffered stages of G key tiles, one per group, by index
  // (arithmetic, so they stay in registers)
  auto Ks = [&](int b, int gg) {
    return Qs + (1 + 2 * (b * G + gg)) * TILE * 2;
  };
  auto Vs = [&](int b, int gg) { return Ks(b, gg) + TILE * 2; };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int grp = warp >> 2, wq = warp & 3;  // key group, row quarter
  const size_t base = (size_t)blockIdx.y * S * D;
  const float scale_log2 = scale * kLog2e;

  const int q0 = (S / kTile - 1 - (int)blockIdx.x) * kTile;  // heaviest first
  const int w0 = q0 + 16 * wq;  // this warp's first row
  const int nlive = CAUSAL ? q0 / kTile + 1 : S / kTile;
  const int nsteps = (nlive + G - 1) / G;
  // step i: group gg folds key tile i * G + gg
  auto load_step = [&](int i, int b) {
#pragma unroll
    for (int gg = 0; gg < G; ++gg) {
      const int kt = i * G + gg;
      if (kt < nlive) {
        load_tile<D, kTile, NT>(Ks(b, gg), k + base + (size_t)kt * TILE);
        load_tile<D, kTile, NT>(Vs(b, gg), v + base + (size_t)kt * TILE);
      }
    }
  };
  load_tile<D, kTile, NT>(Qs, q + base + (size_t)q0 * D);
  load_step(0, 0);
  cp_commit();
  cp_wait_all();
  __syncthreads();
  unsigned qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    ldsm_x4(a_addr<D>(Qs, 16 * wq, 2 * ks), qf[ks]);
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  // running max (raw scores) and this lane's share of the sum of rows
  // w0 + g (index 0) and w0 + g + 8 (index 1), over this group's tiles
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int step = 0; step < nsteps; ++step) {
    const int buf = step & 1;
    if (step + 1 < nsteps) load_step(step + 1, buf ^ 1);  // lands meanwhile
    cp_commit();
    const int k0 = (step * G + grp) * kTile;
    // causal: a tile wholly above this warp's rows adds nothing; only a
    // tile that crosses the warp's diagonal is masked
    if (k0 < nlive * kTile && (!CAUSAL || k0 <= w0 + 15)) {
      const bool diag = CAUSAL && k0 + kTile - 1 > w0;
      auto visible = [&](int j, int e) {
        return !diag || k0 + 8 * j + 2 * t + (e & 1) <= w0 + g + (e >> 1) * 8;
      };
      float s[8][4];
      auto a_of = [&](int ks, unsigned a[4]) {
        for (int e = 0; e < 4; ++e) a[e] = qf[ks][e];
      };
      scores<D>(s, a_of, Ks(buf, grp), 0);
      scores<D>(s + 4, a_of, Ks(buf, grp), 32);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!visible(j, e)) s[j][e] = kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      float neg[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // the row's max over its quad
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float alpha = fast_exp2((m[r] - mx[r]) * scale_log2);
        m[r] = mx[r];
        neg[r] = -mx[r] * scale_log2;
        l[r] *= alpha;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          o[n][2 * r] *= alpha;
          o[n][2 * r + 1] *= alpha;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              visible(j, e)
                  ? fast_exp2(fmaf(s[j][e], scale_log2, neg[e >> 1]))
                  : 0.f;
          l[e >> 1] += p;  // the float32 P, before its bf16 rounding
          s[j][e] = p;
        }
      accumulate<D>(o, s, Vs(buf, grp), 0);
      accumulate<D>(o, s + 4, Vs(buf, grp), 32);
    }
    cp_wait_all();
    __syncthreads();
  }
  // merge the groups into group 0 in group order (the tile buffers are
  // free now): each thread of group u > 0 leaves its fragments at its
  // (row quarter, lane) slot
  if (G > 1) {
    constexpr int REC = D / 2 + 4;  // floats per thread: o, then m and l
    float* red = reinterpret_cast<float*>(smem) + kTile * D / 2;
    const int slot = threadIdx.x & 127;
    if (grp > 0) {
      float* rec = red + ((grp - 1) * 128 + slot) * REC;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) rec[4 * n + e] = o[n][e];
      rec[D / 2] = m[0];
      rec[D / 2 + 1] = m[1];
      rec[D / 2 + 2] = l[0];
      rec[D / 2 + 3] = l[1];
    }
    __syncthreads();
    if (grp > 0) return;
#pragma unroll
    for (int u = 1; u < G; ++u) {
      const float* rec = red + ((u - 1) * 128 + slot) * REC;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mu = rec[D / 2 + r];
        const float mx = fmaxf(m[r], mu);
        const float a0 = fast_exp2((m[r] - mx) * scale_log2);
        const float a1 = fast_exp2((mu - mx) * scale_log2);
        m[r] = mx;
        l[r] = l[r] * a0 + rec[D / 2 + 2 + r] * a1;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          o[n][2 * r] = o[n][2 * r] * a0 + rec[4 * n + 2 * r] * a1;
          o[n][2 * r + 1] =
              o[n][2 * r + 1] * a0 + rec[4 * n + 2 * r + 1] * a1;
        }
      }
    }
  }
  float* lrow = lse + (size_t)blockIdx.y * S + w0 + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (t == 0)
      lrow[8 * r] = l[r] == 0.f ? kNegInf : m[r] * scale + logf(l[r]);
    const float inv = l[r] == 0.f ? 0.f : 1.f / l[r];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][2 * r] *= inv;
      o[n][2 * r + 1] *= inv;
    }
  }
  store_rows<D>(out + base, w0, o, 1.f);
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int S, float scale) {
  constexpr int TILE = kTile * D;  // bf16 elements of a tile
  extern __shared__ uint4 smem[];
  bf16* base_ptr = reinterpret_cast<bf16*>(smem);
  const unsigned Qs = smem_u32(base_ptr);
  const unsigned dOs = Qs + TILE * 2;
  // double buffers, by index (arithmetic, so they stay in registers)
  auto Ks = [&](int b) { return Qs + (2 + b) * TILE * 2; };
  auto Vs = [&](int b) { return Qs + (4 + b) * TILE * 2; };
  // after the key loop the K buffers (2 x TILE bf16) hold the reduction
  float* red = reinterpret_cast<float*>(base_ptr + 2 * TILE);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2, g = lane >> 2, t = lane & 3;
  const int nt = S / kTile;
  const size_t base = (size_t)blockIdx.y * S * D;
  const size_t rbase = (size_t)blockIdx.y * S;
  const float scale_log2 = scale * kLog2e;

  const int qt = nt - 1 - (int)blockIdx.x;  // heaviest causal tiles first
  const int q0 = qt * kTile;
  load_tile<D>(Qs, q + base + (size_t)q0 * D);
  load_tile<D>(dOs, dout + base + (size_t)q0 * D);
  load_tile<D>(Ks(0), k + base);
  load_tile<D>(Vs(0), v + base);
  cp_commit();
  // this thread's two rows: q0 + 16 wm + g (+ 8)
  const int r0 = q0 + 16 * wm + g;
  const float lse0 = lse[rbase + r0] * kLog2e;
  const float lse1 = lse[rbase + r0 + 8] * kLog2e;
  const float del0 = delta[rbase + r0], del1 = delta[rbase + r0 + 8];
  cp_wait_all();
  __syncthreads();
  unsigned qf[D / 16][4], dof[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    ldsm_x4(a_addr<D>(Qs, 16 * wm, 2 * ks), qf[ks]);
    ldsm_x4(a_addr<D>(dOs, 16 * wm, 2 * ks), dof[ks]);
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int nlive = CAUSAL ? qt + 1 : nt;
  for (int kt = 0; kt < nlive; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nlive) {  // the next tile lands while this one computes
      load_tile<D>(Ks(buf ^ 1), k + base + (size_t)(kt + 1) * kTile * D);
      load_tile<D>(Vs(buf ^ 1), v + base + (size_t)(kt + 1) * kTile * D);
    }
    cp_commit();
    float s[4][4], dp[4][4];
    scores<D>(s, [&](int ks, unsigned a[4]) {
      for (int e = 0; e < 4; ++e) a[e] = qf[ks][e];
    }, Ks(buf), 32 * wn);
    scores<D>(dp, [&](int ks, unsigned a[4]) {
      for (int e = 0; e < 4; ++e) a[e] = dof[ks][e];
    }, Vs(buf), 32 * wn);
    // P and dS in float32; the diagonal tile masks key > query
    const int c0 = kt * kTile + 32 * wn + 2 * t;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + (e >> 1) * 8, col = c0 + 8 * j + (e & 1);
        const bool ok = !CAUSAL || col <= row;
        const float p =
            ok ? fast_exp2(fmaf(s[j][e], scale_log2, -(e < 2 ? lse0 : lse1)))
               : 0.f;
        s[j][e] = p * (dp[j][e] - (e < 2 ? del0 : del1));
      }
    accumulate<D>(acc, s, Ks(buf), 32 * wn);
    cp_wait_all();
    __syncthreads();
  }
  reduce_halves<D>(acc, red, wn);
  if (wn == 0) store_rows<D>(dq + base, q0 + 16 * wm, acc, scale);
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkv_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int S, float scale) {
  constexpr int TILE = kTile * D;
  extern __shared__ uint4 smem[];
  bf16* base_ptr = reinterpret_cast<bf16*>(smem);
  const unsigned Ks = smem_u32(base_ptr);
  const unsigned Vs = Ks + TILE * 2;
  // double buffers, by index (arithmetic, so they stay in registers)
  auto Qs = [&](int b) { return Ks + (2 + b) * TILE * 2; };
  auto dOs = [&](int b) { return Ks + (4 + b) * TILE * 2; };
  float* lse_s = reinterpret_cast<float*>(base_ptr + 6 * TILE);  // [2][64]
  float* del_s = lse_s + 2 * kTile;                              // [2][64]
  // after the query loop the Q and dO buffers hold the two reductions
  float* red_k = reinterpret_cast<float*>(base_ptr + 2 * TILE);
  float* red_v = reinterpret_cast<float*>(base_ptr + 4 * TILE);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2, g = lane >> 2, t = lane & 3;
  const int nt = S / kTile;
  const size_t base = (size_t)blockIdx.y * S * D;
  const size_t rbase = (size_t)blockIdx.y * S;
  const float scale_log2 = scale * kLog2e;

  const int kt = (int)blockIdx.x;  // causal: key tile 0 sees every q tile
  const int k0 = kt * kTile;
  // causal: the first q tile that sees this key tile (_causal_first)
  const int first = CAUSAL ? kt : 0;
  load_tile<D>(Ks, k + base + (size_t)k0 * D);
  load_tile<D>(Vs, v + base + (size_t)k0 * D);
  load_tile<D>(Qs(0), q + base + (size_t)first * kTile * D);
  load_tile<D>(dOs(0), dout + base + (size_t)first * kTile * D);
  load_rows(lse_s, del_s, lse + rbase + first * kTile,
            delta + rbase + first * kTile);
  cp_commit();
  cp_wait_all();
  __syncthreads();
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  // this thread's key rows: k0 + 16 wm + g (+ 8)
  const int r0 = k0 + 16 * wm + g;
  for (int qt = first; qt < nt; ++qt) {
    const int buf = (qt - first) & 1;
    if (qt + 1 < nt) {  // the next tile lands while this one computes
      const size_t nxt = (size_t)(qt + 1) * kTile;
      load_tile<D>(Qs(buf ^ 1), q + base + nxt * D);
      load_tile<D>(dOs(buf ^ 1), dout + base + nxt * D);
      load_rows(lse_s + (buf ^ 1) * kTile, del_s + (buf ^ 1) * kTile,
                lse + rbase + nxt, delta + rbase + nxt);
    }
    cp_commit();
    // transposed scores: rows are keys, columns queries
    float st[4][4], dpt[4][4];
    scores<D>(st, [&](int ks, unsigned a[4]) {
      ldsm_x4(a_addr<D>(Ks, 16 * wm, 2 * ks), a);
    }, Qs(buf), 32 * wn);
    scores<D>(dpt, [&](int ks, unsigned a[4]) {
      ldsm_x4(a_addr<D>(Vs, 16 * wm, 2 * ks), a);
    }, dOs(buf), 32 * wn);
    const float* lrow = lse_s + buf * kTile + 32 * wn + 2 * t;
    const float* drow = del_s + buf * kTile + 32 * wn + 2 * t;
    const int c0 = qt * kTile + 32 * wn + 2 * t;
    float ds[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lrow + 8 * j);
      const float2 d2 = *reinterpret_cast<const float2*>(drow + 8 * j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + (e >> 1) * 8, col = c0 + 8 * j + (e & 1);
        const bool ok = !CAUSAL || col >= row;
        const float lc = (e & 1) ? l2.y : l2.x;
        const float dc = (e & 1) ? d2.y : d2.x;
        const float p =
            ok ? fast_exp2(fmaf(st[j][e], scale_log2, -lc * kLog2e)) : 0.f;
        st[j][e] = p;
        ds[j][e] = p * (dpt[j][e] - dc);
      }
    }
    accumulate<D>(dv_acc, st, dOs(buf), 32 * wn);
    accumulate<D>(dk_acc, ds, Qs(buf), 32 * wn);
    cp_wait_all();
    __syncthreads();
  }
  reduce_halves<D>(dk_acc, red_k, wn);
  reduce_halves<D>(dv_acc, red_v, wn);
  if (wn == 0) {
    store_rows<D>(dk + base, k0 + 16 * wm, dk_acc, scale);
    store_rows<D>(dv + base, k0 + 16 * wm, dv_acc, 1.f);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int N>
using IntC = std::integral_constant<int, N>;

// call f(IntC<D>, bool_constant<causal>) for the runtime choice
template <typename F>
int dispatch(int dtype, int D, int causal, F f) {
  if (dtype != 1) return (int)cudaErrorInvalidValue;  // bfloat16 only
  if (D == 64)
    return causal ? f(IntC<64>{}, std::true_type{})
                  : f(IntC<64>{}, std::false_type{});
  if (D == 128)
    return causal ? f(IntC<128>{}, std::true_type{})
                  : f(IntC<128>{}, std::false_type{});
  return (int)cudaErrorInvalidValue;
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool bad_shape(int BH, int S) {
  return BH <= 0 || BH > 65535 || S <= 0 || S % kTile != 0;
}


}  // namespace

extern "C" int singa_flash_fwd_bf16(const void* q, const void* k,
                                    const void* v, void* out, void* lse,
                                    int BH, int S, int D, int dtype,
                                    int causal, float scale, void* stream) {
  if (bad_shape(BH, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, D, causal, [&](auto d, auto c) -> int {
    constexpr int DD = decltype(d)::value;
    constexpr bool C = decltype(c)::value;
    constexpr int G = kFwdGroups;
    // Q, then two stages of G (K, V) tiles
    constexpr size_t smem = (1 + 4 * G) * kTile * DD * sizeof(bf16);
    auto kern = flash_fwd_bf16_kernel<DD, C, G>;
    const int e = allow_smem(kern, smem);
    if (e != 0) return e;
    kern<<<dim3(S / kTile, BH), 128 * G, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out),
        static_cast<float*>(lse), S, scale);
    return (int)cudaGetLastError();
  });
}

extern "C" int singa_flash_bwd_dq_bf16(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dq, int BH, int S, int D,
                                       int dtype, int causal, float scale,
                                       void* stream) {
  if (bad_shape(BH, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, D, causal, [&](auto d, auto c) -> int {
    constexpr int DD = decltype(d)::value;
    constexpr bool C = decltype(c)::value;
    constexpr size_t smem = 6 * kTile * DD * sizeof(bf16);
    auto kern = flash_bwd_dq_bf16_kernel<DD, C>;
    const int e = allow_smem(kern, smem);
    if (e != 0) return e;
    kern<<<dim3(S / kTile, BH), kThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dq), S, scale);
    return (int)cudaGetLastError();
  });
}

extern "C" int singa_flash_bwd_dkv_bf16(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const void* lse, const void* delta,
                                        void* dk, void* dv, int BH, int S,
                                        int D, int dtype, int causal,
                                        float scale, void* stream) {
  if (bad_shape(BH, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, D, causal, [&](auto d, auto c) -> int {
    constexpr int DD = decltype(d)::value;
    constexpr bool C = decltype(c)::value;
    constexpr size_t smem =
        6 * kTile * DD * sizeof(bf16) + 4 * kTile * sizeof(float);
    auto kern = flash_bwd_dkv_bf16_kernel<DD, C>;
    const int e = allow_smem(kern, smem);
    if (e != 0) return e;
    kern<<<dim3(S / kTile, BH), kThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, scale);
    return (int)cudaGetLastError();
  });
}
