// Flash attention for Hopper (sm_90a) on the CUDA cores: the forward in
// float32 or bfloat16 and the backward (dQ, dK/dV) in float32, causal or
// full, over (batch * heads, S, D) rows with float32 accumulation
// everywhere.
//
// Which kernel serves which dtype:
//   flash_fwd           float32 and bfloat16 (this file)
//   flash_bwd_dq/_dkv   float32 (this file); bfloat16 runs on the tensor
//                       cores in flash_attention_bwd.cu. The float32
//                       backward stays here: TF32 tensor cores would break
//                       the float32 flash-vs-dense training bar (1e-5) and
//                       the port's no-TF32 contract (device.py).
//
// Replaces the six Pallas TPU kernels of singa_tpu/ops/attention.py:
//   flash_fwd     <- _flash_kernel_staged (:386) and _flash_kernel (:210),
//                    launched by _flash_fwd_impl (:552)
//   flash_bwd_dq  <- _flash_bwd_dq_staged (:419) and _flash_bwd_dq_kernel (:268)
//   flash_bwd_dkv <- _flash_bwd_dkv_staged (:451) and _flash_bwd_dkv_kernel (:316),
//                    launched by _flash_bwd (:615)
// The TPU's staged/streamed split is only a VMEM budget (_variant): here
// every K/V, Q and dO tile is streamed from device memory through shared
// memory whatever S is, so one kernel covers both variants.
//
// What each computes (scale = 1/sqrt(D); masked scores are NEG_INF = -1e30
// and their probabilities exactly 0):
//   forward: O = softmax(Q K^T * scale) V by online softmax over the live K
//            tiles; lse = m + log(l) in float32, laid out (BH, S); a row with
//            l == 0 emits 0 (and lse = m).
//   dQ:      P = exp(S * scale - lse); dS = P * (dO V^T - delta);
//            dQ = scale * dS K. delta = rowsum(dO * O) comes in, computed once
//            outside the kernels (as _flash_bwd does).
//   dK/dV:   dV = P^T dO; dK = scale * dS^T Q, looping over the q tiles from
//            the first one that sees this key tile (causal) to the last.
//            Each thread block owns its dK/dV rows: no atomics, so the result
//            is deterministic.
//
// Bound on the H100: operations. At the training shape (B*H = 2, S = 8192,
// D = 128, causal) a call moves ~17 MB (0.005 ms at 3.35 TB/s) but does
// 2 (forward), 3 (dQ) or 4 (dK/dV) products of 2*D operations per visible
// (q, k) pair: 34-69 GFLOP, 0.035-0.069 ms on the bf16 tensor cores and
// 0.5-1.0 ms at the 67 TFLOP/s float32 rate without them.
//
// Design (right and simple first; these kernels use CUDA-core FMAs, not the
// tensor cores, so they sit near the float32 rate at best):
//   * One thread block of 256 threads per (64-row tile, batch * head). The
//     TPU grid's sequential K axis becomes a loop inside the block. Causal
//     blocks skip every tile above the diagonal; the heaviest tiles get the
//     lowest block indices, so they start first and the tail is short.
//   * Tiles are converted to float32 into shared memory, rows padded to
//     D + 4 floats so float4 reads of 8 different rows hit distinct banks.
//     At D = 128 that is up to 170 KB: dynamic shared memory, enabled with
//     cudaFuncSetAttribute.
//   * Every product is one of two register-tiled shapes. score_tile: each
//     thread computes a 4 x 4 block of a 64 x 64 score tile (rows ty*4+i,
//     columns tx+16j), 16 FMAs per two float4 reads of each operand. pv_tile:
//     each thread accumulates 4 rows x D/16 columns of a 64 x D output.
//     Row statistics reduce over the 16 threads that share a row, all within
//     one warp (shuffles).
//   * The dK/dV kernel computes the transposed scores K Q^T directly, so its
//     two accumulations have the same pv_tile shape as the forward's P V.
// Known limits: no tensor cores, no asynchronous copies (each tile load is a
// full memory round trip between two barriers), one thread block per SM at
// D = 128 (shared memory). For the float32 backward that is the price of
// full float32 products; the bf16 backward has left this file for the
// tensor cores (flash_attention_bwd.cu); the forward's redesign is next.
//
// C interface, bound with ctypes: every pointer and the stream are void*,
// dtype 0 = float32 and 1 = bfloat16 (the backward entries take 0 only),
// the launch is on the given stream, and each function returns
// cudaGetLastError() (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kTile = 64;       // query rows and key rows per tile
constexpr int kThreads = 256;   // 16 x 16: thread (ty, tx), ty = tid / 16
constexpr float kNegInf = -1e30f;

template <int D>
struct Geo {
  static constexpr int LD = D + 4;          // padded row stride of a (64, D) tile
  static constexpr int TILE = kTile * LD;   // floats of a (64, D) tile
  static constexpr int LDP = kTile + 4;     // padded row stride of a (64, 64) tile
  static constexpr int PTILE = kTile * LDP;
  static constexpr int NC = D / 16;         // output columns per thread
};

// 16 bytes of global memory <-> floats
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  __device__ static void store4(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* f) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h;
      *reinterpret_cast<unsigned*>(&h) = w[i];
      const float2 t = __bfloat1622float2(h);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ static void store4(__nv_bfloat16* p, const float* f) {
    __nv_bfloat162 a = __floats2bfloat162_rn(f[0], f[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(f[2], f[3]);
    uint2 u;
    u.x = *reinterpret_cast<unsigned*>(&a);
    u.y = *reinterpret_cast<unsigned*>(&b);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : (u == 1 ? v.y : (u == 2 ? v.z : v.w));
}

// max / sum over the 16 threads that share a row (one half of a warp)
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// (64, D) tile of T at src (row stride D) -> float32 shared tile (stride LD).
// Each thread issues all its 16-byte loads before it stores any.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          float* dst) {
  constexpr int N = Vec<T>::N;
  constexpr int PER_ROW = D / N;
  constexpr int PER_THREAD = kTile * PER_ROW / kThreads;
  static_assert(kTile * PER_ROW % kThreads == 0, "tile must split evenly");
  float f[PER_THREAD][N];
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / PER_ROW, col = (c - r * PER_ROW) * N;
    Vec<T>::load(src + (size_t)r * D + col, f[i]);
  }
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / PER_ROW, col = (c - r * PER_ROW) * N;
    float* d = dst + r * Geo<D>::LD + col;
#pragma unroll
    for (int e = 0; e < N; e += 4)
      *reinterpret_cast<float4*>(d + e) =
          make_float4(f[i][e], f[i][e + 1], f[i][e + 2], f[i][e + 3]);
  }
}

// acc[i][j] = sum_d A[ty*4+i][d] * B[tx+16j][d]; A, B (64, D) shared tiles
template <int D>
__device__ __forceinline__ void score_tile(const float* A, const float* B,
                                           float acc[4][4]) {
  constexpr int LD = Geo<D>::LD;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* a = A + ty * 4 * LD;
  const float* b = B + tx * LD;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + i * LD + d);
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

// acc[i][4g+e] += sum_kk P[ty*4+i][kk] * V[kk][64g + 4tx + e];
// P a (64, 64) shared tile (stride LDP), V a (64, D) shared tile
template <int D>
__device__ __forceinline__ void pv_tile(const float* P, const float* V,
                                        float acc[4][Geo<D>::NC]) {
  constexpr int LD = Geo<D>::LD, LDP = Geo<D>::LDP, G = D / 64;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* p = P + ty * 4 * LDP;
  const float* v = V + tx * 4;
#pragma unroll 2
  for (int kk = 0; kk < kTile; kk += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pv[i] = *reinterpret_cast<const float4*>(p + i * LDP + kk);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(v + (kk + u) * LD + 64 * g);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pu = comp(pv[i], u);
          acc[i][4 * g + 0] = fmaf(pu, vv.x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(pu, vv.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(pu, vv.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(pu, vv.w, acc[i][4 * g + 3]);
        }
      }
    }
  }
}

// rows ty*4+i of a (64, D) output tile at dst (row stride D), times mul
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, float acc[4][Geo<D>::NC],
                                           const float mul_row[4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T* o = dst + (size_t)(ty * 4 + i) * D + 4 * tx;
#pragma unroll
    for (int g = 0; g < D / 64; ++g) {
      float f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = acc[i][4 * g + e] * mul_row[i];
      Vec<T>::store4(o + 64 * g, f);
    }
  }
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, int S, float scale) {
  using G = Geo<D>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + G::TILE;
  float* Vs = Ks + G::TILE;
  float* Ps = Vs + G::TILE;

  const int nt = S / kTile;
  const int qt = nt - 1 - (int)blockIdx.x;  // heaviest causal tiles first
  const size_t base = (size_t)blockIdx.y * S * D;
  const int q0 = qt * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile<T, D>(q + base + (size_t)q0 * D, Qs);
  float m[4], l[4], acc[4][G::NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < G::NC; ++c) acc[i][c] = 0.f;
  }

  const int nlive = CAUSAL ? qt + 1 : nt;
  for (int kt = 0; kt < nlive; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's Ks / Vs / Ps are fully read
    load_tile<T, D>(k + base + (size_t)k0 * D, Ks);
    load_tile<T, D>(v + base + (size_t)k0 * D, Vs);
    __syncthreads();
    float s[4][4];
    score_tile<D>(Qs, Ks, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = !CAUSAL || k0 + tx + 16 * j <= qpos;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = !CAUSAL || k0 + tx + 16 * j <= qpos;
        const float p = ok ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty * 4 + i) * G::LDP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < G::NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    pv_tile<D>(Ps, Vs, acc);
  }

  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float safe = l[i] == 0.f ? 1.f : l[i];
    inv[i] = 1.f / safe;
    if (tx == 0)
      lse[(size_t)blockIdx.y * S + q0 + ty * 4 + i] = m[i] + logf(safe);
  }
  store_rows<T, D>(out + base + (size_t)q0 * D, acc, inv);
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int S, float scale) {
  using G = Geo<D>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + G::TILE;
  float* Ks = dOs + G::TILE;
  float* Vs = Ks + G::TILE;
  float* DSs = Vs + G::TILE;
  float* lse_s = DSs + G::PTILE;
  float* del_s = lse_s + kTile;

  const int nt = S / kTile;
  const int qt = nt - 1 - (int)blockIdx.x;  // heaviest causal tiles first
  const size_t base = (size_t)blockIdx.y * S * D;
  const size_t rbase = (size_t)blockIdx.y * S;
  const int q0 = qt * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile<T, D>(q + base + (size_t)q0 * D, Qs);
  load_tile<T, D>(dout + base + (size_t)q0 * D, dOs);
  if (threadIdx.x < kTile) {
    lse_s[threadIdx.x] = lse[rbase + q0 + threadIdx.x];
    del_s[threadIdx.x] = delta[rbase + q0 + threadIdx.x];
  }
  float acc[4][G::NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < G::NC; ++c) acc[i][c] = 0.f;

  const int nlive = CAUSAL ? qt + 1 : nt;
  for (int kt = 0; kt < nlive; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, D>(k + base + (size_t)k0 * D, Ks);
    load_tile<T, D>(v + base + (size_t)k0 * D, Vs);
    __syncthreads();
    float s[4][4], dp[4][4];
    score_tile<D>(Qs, Ks, s);
    score_tile<D>(dOs, Vs, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
      const float lrow = lse_s[row], drow = del_s[row];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = !CAUSAL || k0 + tx + 16 * j <= q0 + row;
        const float p = ok ? expf(s[i][j] * scale - lrow) : 0.f;
        DSs[row * G::LDP + tx + 16 * j] = p * (dp[i][j] - drow);
      }
    }
    __syncthreads();
    pv_tile<D>(DSs, Ks, acc);
  }
  float mul[4] = {scale, scale, scale, scale};
  store_rows<T, D>(dq + base + (size_t)q0 * D, acc, mul);
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int S, float scale) {
  using G = Geo<D>;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + G::TILE;
  float* Qs = Vs + G::TILE;
  float* dOs = Qs + G::TILE;
  float* Ps = dOs + G::TILE;
  float* DSs = Ps + G::PTILE;
  float* lse_s = DSs + G::PTILE;
  float* del_s = lse_s + kTile;

  const int nt = S / kTile;
  const int kt = (int)blockIdx.x;  // causal: key tile 0 sees every q tile
  const size_t base = (size_t)blockIdx.y * S * D;
  const size_t rbase = (size_t)blockIdx.y * S;
  const int k0 = kt * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile<T, D>(k + base + (size_t)k0 * D, Ks);
  load_tile<T, D>(v + base + (size_t)k0 * D, Vs);
  float dk_acc[4][G::NC], dv_acc[4][G::NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < G::NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // causal: the first q tile that sees this key tile (_causal_first)
  const int first = CAUSAL ? kt : 0;
  for (int qt = first; qt < nt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<T, D>(q + base + (size_t)q0 * D, Qs);
    load_tile<T, D>(dout + base + (size_t)q0 * D, dOs);
    if (threadIdx.x < kTile) {
      lse_s[threadIdx.x] = lse[rbase + q0 + threadIdx.x];
      del_s[threadIdx.x] = delta[rbase + q0 + threadIdx.x];
    }
    __syncthreads();
    // transposed scores: rows are keys (ty*4+i), columns queries (tx+16j)
    float st[4][4], dpt[4][4];
    score_tile<D>(Ks, Qs, st);
    score_tile<D>(Vs, dOs, dpt);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int krow = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qcol = tx + 16 * j;
        const bool ok = !CAUSAL || q0 + qcol >= k0 + krow;
        const float p = ok ? expf(st[i][j] * scale - lse_s[qcol]) : 0.f;
        Ps[krow * G::LDP + qcol] = p;
        DSs[krow * G::LDP + qcol] = p * (dpt[i][j] - del_s[qcol]);
      }
    }
    __syncthreads();
    pv_tile<D>(Ps, dOs, dv_acc);
    pv_tile<D>(DSs, Qs, dk_acc);
  }
  float one[4] = {1.f, 1.f, 1.f, 1.f};
  float mul[4] = {scale, scale, scale, scale};
  store_rows<T, D>(dk + base + (size_t)k0 * D, dk_acc, mul);
  store_rows<T, D>(dv + base + (size_t)k0 * D, dv_acc, one);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename T>
struct Tag {
  using type = T;
};
template <int N>
using IntC = std::integral_constant<int, N>;

// call f(Tag<T>, IntC<D>, bool_constant<causal>) for the runtime choice;
// BF16 = false takes float32 only (the backward: bf16 has its own kernels)
template <bool BF16 = true, typename F>
int dispatch(int dtype, int D, int causal, F f) {
  auto by_d = [&](auto t) -> int {
    if (D == 64)
      return causal ? f(t, IntC<64>{}, std::true_type{})
                    : f(t, IntC<64>{}, std::false_type{});
    if (D == 128)
      return causal ? f(t, IntC<128>{}, std::true_type{})
                    : f(t, IntC<128>{}, std::false_type{});
    return (int)cudaErrorInvalidValue;
  };
  if (dtype == 0) return by_d(Tag<float>{});
  if constexpr (BF16)
    if (dtype == 1) return by_d(Tag<__nv_bfloat16>{});
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

extern "C" int singa_flash_fwd(const void* q, const void* k, const void* v,
                               void* out, void* lse, int BH, int S, int D,
                               int dtype, int causal, float scale,
                               void* stream) {
  if (bad_shape(BH, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, D, causal, [&](auto t, auto d, auto c) -> int {
    using T = typename decltype(t)::type;
    constexpr int DD = decltype(d)::value;
    constexpr bool C = decltype(c)::value;
    constexpr size_t smem = (3 * Geo<DD>::TILE + Geo<DD>::PTILE) * sizeof(float);
    auto kern = flash_fwd_kernel<T, DD, C>;
    const int e = allow_smem(kern, smem);
    if (e != 0) return e;
    kern<<<dim3(S / kTile, BH), kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out),
        static_cast<float*>(lse), S, scale);
    return (int)cudaGetLastError();
  });
}

extern "C" int singa_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dq, int BH, int S,
                                  int D, int dtype, int causal, float scale,
                                  void* stream) {
  if (bad_shape(BH, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f32_only = [&](auto t, auto d, auto c) -> int {
    using T = typename decltype(t)::type;
    constexpr int DD = decltype(d)::value;
    constexpr bool C = decltype(c)::value;
    constexpr size_t smem =
        (4 * Geo<DD>::TILE + Geo<DD>::PTILE + 2 * kTile) * sizeof(float);
    auto kern = flash_bwd_dq_kernel<T, DD, C>;
    const int e = allow_smem(kern, smem);
    if (e != 0) return e;
    kern<<<dim3(S / kTile, BH), kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dq), S, scale);
    return (int)cudaGetLastError();
  };
  return dispatch<false>(dtype, D, causal, f32_only);
}

extern "C" int singa_flash_bwd_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, int BH, int S, int D,
                                   int dtype, int causal, float scale,
                                   void* stream) {
  if (bad_shape(BH, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f32_only = [&](auto t, auto d, auto c) -> int {
    using T = typename decltype(t)::type;
    constexpr int DD = decltype(d)::value;
    constexpr bool C = decltype(c)::value;
    constexpr size_t smem =
        (4 * Geo<DD>::TILE + 2 * Geo<DD>::PTILE + 2 * kTile) * sizeof(float);
    auto kern = flash_bwd_dkv_kernel<T, DD, C>;
    const int e = allow_smem(kern, smem);
    if (e != 0) return e;
    kern<<<dim3(S / kTile, BH), kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dk), static_cast<T*>(dv), S, scale);
    return (int)cudaGetLastError();
  };
  return dispatch<false>(dtype, D, causal, f32_only);
}
