// Paged attention for Hopper (sm_90a): masked online-softmax attention of
// query rows over K/V blocks read in place through a block table.
//
// Replaces the Pallas TPU kernel singa_tpu/ops/paged_attention.py::_kernel
// (launched by _call at its pl.pallas_call), both of its forms:
//   write-then-read (OVERLAY = false): the decode tick (S, 1) and chunked
//     prefill (1, chunk). Every attended entry is already in the pool; a
//     query at position p sees pool positions <= p.
//   overlay (OVERLAY = true): the speculative verify (S, k+1). Pool
//     positions strictly before positions[s, 0], then the fresh chunk K/V
//     folded last, causal within the chunk and masked by chunk_valid. The
//     pool is never written.
//
// Bound on the H100: HBM bytes. Each call reads Q, the live K/V blocks
// (and the chunk) once and writes O once -- modeled_bytes() in
// ops/paged_attention.py -- at 3.35 TB/s. Operations are 4 * Q * D per key
// per (sequence, head), far below the f32 rate for any Q the engine uses,
// so bytes bound every call shape.
//
// Design (right and simple first):
//   * One thread block (4 warps) per (sequence * head, tile of 4 query
//     rows); each warp owns one query row. The TPU grid's sequential block
//     axis becomes a loop inside the thread block, and the scalar prefetch
//     becomes the block's own loads of its table row and positions.
//   * Only the live blocks are read: the block computes
//     live_blocks(max position) itself and loops over ceil(live * BL / 32)
//     tiles of 32 key positions. Each position looks up its own pool block,
//     so any block length works and all 32 lanes are busy for BL < 32.
//   * A tile's K and V (32 x D floats each) are staged in shared memory by
//     the whole thread block, so the 4 query rows share one read of every
//     live K/V byte. Each thread issues all its float4 loads of a tile
//     before storing any, from key-row offsets that were looked up in the
//     table one tile ahead: a tile costs one memory round trip. Shared rows
//     are padded to D + 1 floats: lane j reads key row j without bank
//     conflicts.
//   * Scores: lane j computes the dot product of its row's query with key
//     j. Online softmax statistics (m, l) and the output accumulator
//     (D / 32 columns per lane) stay in registers for the whole loop;
//     masked keys score NEG_INF and get probability exactly 0; a row
//     with l == 0 emits zeros.
// Known limit: decode at 8 slots x 2 heads launches 16 thread blocks on
// 132 SMs, with one busy warp each. Splitting the key range over blocks
// (a second reduction pass) is the fix, left to a later change.
//
// C interface, bound with ctypes: every pointer and the stream are void*,
// the launch is on the given stream, and the function returns
// cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;  // key positions per staged tile: one per lane
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D, bool OVERLAY>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const float* __restrict__ q,            // (S, H, Q, D)
    const float* __restrict__ k_pool,       // (NB, H, BL, D)
    const float* __restrict__ v_pool,       // (NB, H, BL, D)
    const int* __restrict__ tables,         // (S, MB)
    const int* __restrict__ positions,      // (S, Q)
    const float* __restrict__ chunk_k,      // (S, H, Q, D), overlay only
    const float* __restrict__ chunk_v,      // (S, H, Q, D), overlay only
    const int* __restrict__ chunk_valid,    // (S, Q), overlay only
    float* __restrict__ out,                // (S, H, Q, D)
    int H, int Q, int n_blocks, int BL, int MB, float scale) {
  constexpr int DL = D / 32;  // output columns per lane
  constexpr int D4 = D / 4;   // float4 per key row
  constexpr int KS = D + 1;   // padded shared-memory row stride

  __shared__ float q_s[kWarps][D];
  __shared__ float k_s[kTile][KS];
  __shared__ float v_s[kTile][KS];
  __shared__ int kpos_s[kTile];  // chunk tiles: each column's position
  __shared__ int kok_s[kTile];   // chunk tiles: column is real
  __shared__ long long koff_s[2][kTile];  // key row offsets, double-buffered
  __shared__ int n_keys_s;

  const int sh = blockIdx.x;  // sequence * H + head
  const int s = sh / H;
  const int h = sh - s * H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row = blockIdx.y * kWarps + warp;  // this warp's query row
  const bool active = row < Q;
  const int* pos_row = positions + (size_t)s * Q;
  const int* tab_row = tables + (size_t)s * MB;

  for (int e = tid; e < kWarps * D; e += kThreads) {
    const int r = blockIdx.y * kWarps + e / D;
    q_s[e / D][e % D] = r < Q ? q[((size_t)sh * Q + r) * D + e % D] : 0.f;
  }
  if (tid == 0) {
    // live_blocks(): the last pool position this sequence attends
    int last;
    if (OVERLAY) {
      last = pos_row[0] - 1;
    } else {
      last = pos_row[0];
      for (int j = 1; j < Q; ++j) last = max(last, pos_row[j]);
    }
    const int live = last >= 0 ? min(last / BL + 1, MB) : 0;
    n_keys_s = live * BL;
  }
  __syncthreads();
  const int n_keys = n_keys_s;
  const int qpos = active ? pos_row[row] : 0;
  const int pos0 = pos_row[0];

  float m = kNegInf, l = 0.f, acc[DL];
#pragma unroll
  for (int c = 0; c < DL; ++c) acc[c] = 0.f;

  // fold the staged tile into (m, l, acc); ok = this lane's key is visible
  auto fold = [&](bool ok) {
    // four partial sums: independent FMA chains instead of one of length D
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int d = 0; d < D; d += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        part[u] += q_s[warp][d + u] * k_s[lane][d + u];
    }
    const float dot = (part[0] + part[1]) + (part[2] + part[3]);
    const float sc = ok ? dot * scale : kNegInf;
    const float m_new = fmaxf(m, warp_max(sc));
    const float alpha = expf(m - m_new);
    const float p = ok ? expf(sc - m_new) : 0.f;
    l = l * alpha + warp_sum(p);
    m = m_new;
#pragma unroll
    for (int c = 0; c < DL; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
      for (int c = 0; c < DL; ++c) acc[c] += pj * v_s[j][lane + 32 * c];
    }
  };

  // Staging a tile of 32 keys: each thread issues all of its kLoads float4
  // loads of K and V before it stores any, so a tile costs one memory round
  // trip and not one per load. The key rows' pool offsets come from
  // koff_s, filled one tile ahead (row offset in floats, -1 = no key).
  constexpr int kLoads = kTile * D4 / kThreads;
  static_assert(kTile * D4 % kThreads == 0, "tile must split evenly");
  float4 kr[kLoads], vr[kLoads];
  auto load_tile = [&](const float* ksrc, const float* vsrc,
                       const long long* rows) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = tid + i * kThreads;
      const int j = e / D4, c4 = e - j * D4;
      const long long r = rows[j];
      kr[i] = vr[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r >= 0) {
        kr[i] = *reinterpret_cast<const float4*>(ksrc + r + 4 * c4);
        vr[i] = *reinterpret_cast<const float4*>(vsrc + r + 4 * c4);
      }
    }
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = tid + i * kThreads;
      const int j = e / D4, c = 4 * (e - j * D4);
      k_s[j][c] = kr[i].x; k_s[j][c + 1] = kr[i].y;
      k_s[j][c + 2] = kr[i].z; k_s[j][c + 3] = kr[i].w;
      v_s[j][c] = vr[i].x; v_s[j][c + 1] = vr[i].y;
      v_s[j][c + 2] = vr[i].z; v_s[j][c + 3] = vr[i].w;
    }
  };
  // offset of pool key position t: block tab_row[t / BL], slot t % BL
  auto pool_row = [&](int t) -> long long {
    if (t >= n_keys) return -1;
    const int b = t / BL;
    // table entries are allocator-issued block ids; the clamp only guards
    // memory against a corrupt table
    const int phys = min(max(tab_row[b], 0), n_blocks - 1);
    return (((long long)phys * H + h) * BL + (t - b * BL)) * D;
  };

  // pool tiles
  if (tid < kTile) koff_s[0][tid] = pool_row(tid);
  for (int t0 = 0, buf = 0; t0 < n_keys; t0 += kTile, buf ^= 1) {
    __syncthreads();  // koff_s[buf] written; the previous tile fully read
    load_tile(k_pool, v_pool, koff_s[buf]);
    if (tid < kTile) koff_s[buf ^ 1][tid] = pool_row(t0 + kTile + tid);
    store_tile();
    __syncthreads();
    if (active) {
      const int t = t0 + lane;
      fold(t < n_keys && (OVERLAY ? t < pos0 : t <= qpos));
    }
  }

  if (OVERLAY) {
    // the fresh chunk, folded last: column j sits at positions[s, j]
    for (int t0 = 0; t0 < Q; t0 += kTile) {
      __syncthreads();
      if (tid < kTile) {
        const int t = t0 + tid;
        koff_s[0][tid] = t < Q ? ((long long)sh * Q + t) * D : -1;
        kpos_s[tid] = t < Q ? pos_row[t] : 0;
        kok_s[tid] = t < Q ? (chunk_valid[(size_t)s * Q + t] != 0) : 0;
      }
      __syncthreads();
      load_tile(chunk_k, chunk_v, koff_s[0]);
      store_tile();
      __syncthreads();
      if (active) fold(kok_s[lane] && kpos_s[lane] <= qpos);
    }
  }

  if (active) {
    const float safe = l == 0.f ? 1.f : l;
    float* o = out + ((size_t)sh * Q + row) * D;
#pragma unroll
    for (int c = 0; c < DL; ++c) o[lane + 32 * c] = acc[c] / safe;
  }
}

template <int D>
void launch(bool overlay, dim3 grid, cudaStream_t st, const float* q,
            const float* kp, const float* vp, const int* tab, const int* pos,
            const float* ck, const float* cv, const int* cvalid, float* out,
            int H, int Q, int NB, int BL, int MB, float scale) {
  if (overlay)
    paged_attention_kernel<D, true><<<grid, kThreads, 0, st>>>(
        q, kp, vp, tab, pos, ck, cv, cvalid, out, H, Q, NB, BL, MB, scale);
  else
    paged_attention_kernel<D, false><<<grid, kThreads, 0, st>>>(
        q, kp, vp, tab, pos, ck, cv, cvalid, out, H, Q, NB, BL, MB, scale);
}

}  // namespace

extern "C" int singa_paged_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* positions, const void* chunk_k, const void* chunk_v,
    const void* chunk_valid, void* out, int S, int H, int Q, int D,
    int n_blocks, int BL, int MB, int overlay, float scale, void* stream) {
  if (S <= 0 || H <= 0 || Q <= 0 || BL <= 0 || MB <= 0 || n_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  if (overlay && (chunk_k == nullptr || chunk_v == nullptr ||
                  chunk_valid == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(S * H), (unsigned)((Q + kWarps - 1) / kWarps));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k_pool);
  const auto* vf = static_cast<const float*>(v_pool);
  const auto* tb = static_cast<const int*>(tables);
  const auto* ps = static_cast<const int*>(positions);
  const auto* ckf = static_cast<const float*>(chunk_k);
  const auto* cvf = static_cast<const float*>(chunk_v);
  const auto* cvl = static_cast<const int*>(chunk_valid);
  auto* of = static_cast<float*>(out);
  switch (D) {
    case 64:
      launch<64>(overlay != 0, grid, st, qf, kf, vf, tb, ps, ckf, cvf, cvl,
                 of, H, Q, n_blocks, BL, MB, scale);
      break;
    case 128:
      launch<128>(overlay != 0, grid, st, qf, kf, vf, tb, ps, ckf, cvf, cvl,
                  of, H, Q, n_blocks, BL, MB, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
