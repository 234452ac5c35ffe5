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
// so bytes bound every call shape. Float32 on the CUDA cores throughout:
// the pools are float32 and the port takes no TF32.
//
// Design:
//   * The key range is split across thread blocks. The grid is (sequence
//     * head, tile of R query rows, split); the wrapper picks the split
//     count from shapes alone (S, H, Q, the table width, the SM count),
//     never from positions, so a call adds no device-to-host copy. Each
//     block computes its sequence's live key count from positions
//     (live_blocks of the last attended position) and takes an equal share
//     of that range's 32-key tiles; a block whose share is empty writes
//     m = NEG_INF, l = 0.
//   * Every warp is busy at any Q: a block has 4 warps and R = 4 / P rows
//     (R = 1 at decode, 2 at Q = 2, else 4); the P warps of a row each
//     take KW = 32 / P keys of every tile, P lanes to a key, each lane
//     D / P of its dimensions (the partial dot products summed by
//     __shfl_xor_sync). Each warp keeps its own online-softmax state (m,
//     l, D / 32 output columns a lane); at the end the P warps of a row
//     merge in a fixed order through shared memory.
//   * Tiles of 32 keys (K rows padded to D + 4 floats, so the 8 rows one
//     float4 phase reads hit 8 distinct bank groups; V unpadded, read by
//     row) are copied by cp.async and double-buffered: the next tile lands
//     while this one is folded. Each key looks up its own pool block, so
//     any block length works. Keys past the live range are zero-filled,
//     so a masked key's probability, exactly 0, meets a finite V.
//   * With one split the block writes the normalized output. With more,
//     each split writes its unnormalized (acc, m, l) to float32 scratch
//     (the wrapper's torch.empty) and a second small launch merges the
//     splits of each row in split order: no atomics, so two calls on the
//     same inputs give bitwise-equal outputs. A row with no visible key in
//     any split emits zeros.
//   * The overlay's fresh chunk is folded once, by the last split, after
//     its share of the pool.
//   * Block-shared memory is one extern __shared__ array (two K/V tile
//     buffers, the block's query rows, the live key count): 68 KB at
//     D = 128, dynamic, so three blocks fit an SM.
//
// C interface, bound with ctypes: every pointer and the stream are void*,
// the launch is on the given stream, and the function returns
// cudaGetLastError() (0 = launched).

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;  // key positions per staged tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// every group but the newest has landed
__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// floats of one K/V tile buffer: K (kTile x (D + 4)) then V (kTile x D)
__host__ __device__ constexpr int tile_buffer(int D) {
  return kTile * (2 * D + 4);
}

// bytes of block-shared memory: two tile buffers, the block's query rows
// and the live key count
constexpr size_t smem_bytes(int D, int rows) {
  return (2 * tile_buffer(D) + rows * D + 1) * sizeof(float);
}

template <int D, bool OVERLAY, int P>
__global__ void __launch_bounds__(kThreads, 1) paged_attention_kernel(
    const float* __restrict__ q,            // (S, H, Q, D)
    const float* __restrict__ k_pool,       // (NB, H, BL, D)
    const float* __restrict__ v_pool,       // (NB, H, BL, D)
    const int* __restrict__ tables,         // (S, MB)
    const int* __restrict__ positions,      // (S, Q)
    const float* __restrict__ chunk_k,      // (S, H, Q, D), overlay only
    const float* __restrict__ chunk_v,      // (S, H, Q, D), overlay only
    const int* __restrict__ chunk_valid,    // (S, Q), overlay only
    float* __restrict__ out,                // (S, H, Q, D), one split
    float* __restrict__ part,               // (S, H, Q, splits, D + 2)
    int H, int Q, int n_blocks, int BL, int MB, int n_splits, float scale) {
  constexpr int R = kWarps / P;  // query rows of the block
  constexpr int KW = kTile / P;  // keys of a tile per warp
  constexpr int NCH = D / P / 4; // float4 chunks of a key per lane
  constexpr int DL = D / 32;     // output columns per lane
  constexpr int KS = D + 4;      // padded K row stride
  constexpr int D4 = D / 4;
  constexpr int BUF = tile_buffer(D);
  extern __shared__ uint4 smem[];
  float* sm = reinterpret_cast<float*>(smem);
  auto k_s = [&](int b) { return sm + b * BUF; };
  auto v_s = [&](int b) { return sm + b * BUF + kTile * KS; };
  float* q_s = sm + 2 * BUF;  // [R][D]
  int* n_keys_s = reinterpret_cast<int*>(q_s + R * D);

  const int sh = blockIdx.x;  // sequence * H + head
  const int s = sh / H;
  const int h = sh - s * H;
  const int z = blockIdx.z;   // split
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rl = warp / P, sub = warp % P;  // the warp's row, key sub-slice
  const int row = blockIdx.y * R + rl;
  const bool active = row < Q;
  const int key = sub * KW + lane / P;  // this lane's key in a tile
  const int slice = lane % P;           // and its part of that key's dims
  const int* pos_row = positions + (size_t)s * Q;
  const int* tab_row = tables + (size_t)s * MB;

  for (int e = tid; e < R * D; e += kThreads) {
    const int r = blockIdx.y * R + e / D;
    q_s[e] = r < Q ? q[((size_t)sh * Q + r) * D + e % D] : 0.f;
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
    *n_keys_s = live * BL;
  }
  __syncthreads();
  const int n_keys = *n_keys_s;
  const int qpos = active ? pos_row[row] : 0;
  const int pos0 = pos_row[0];
  // this split's equal share of the live tiles; then, overlay, the last
  // split folds the fresh chunk's tiles
  const int nt = (n_keys + kTile - 1) / kTile;
  const int tb = (int)((long long)z * nt / n_splits);
  const int np = (int)((long long)(z + 1) * nt / n_splits) - tb;
  const int n = np + (OVERLAY && z == n_splits - 1 ? (Q + kTile - 1) / kTile
                                                   : 0);

  // float offset of key j of tile i in its source (pool or chunk); -1 = no
  // key there
  auto key_row = [&](int i, int j) -> long long {
    if (i < np) {
      const int t = (tb + i) * kTile + j;
      if (t >= n_keys) return -1;
      const int b = t / BL;
      // table entries are allocator-issued block ids; the clamp only
      // guards memory against a corrupt table
      const int phys = min(max(tab_row[b], 0), n_blocks - 1);
      return (((long long)phys * H + h) * BL + (t - b * BL)) * D;
    }
    const int c = (i - np) * kTile + j;
    return c < Q ? ((long long)sh * Q + c) * D : -1;
  };
  // key j of tile i is visible to a query at position p iff limit <= p
  auto key_limit = [&](int i, int j) -> int {
    if (i < np) {
      const int t = (tb + i) * kTile + j;
      if (t >= n_keys) return INT_MAX;
      if (OVERLAY) return t < pos0 ? INT_MIN : INT_MAX;
      return t;
    }
    const int c = (i - np) * kTile + j;
    return c < Q && chunk_valid[(size_t)s * Q + c] != 0 ? pos_row[c]
                                                        : INT_MAX;
  };
  // tile i into buffer b: cp.async for real keys, zeros for the rest
  auto stage = [&](int i, int b) {
    const float* ksrc = i < np ? k_pool : chunk_k;
    const float* vsrc = i < np ? v_pool : chunk_v;
    for (int e = tid; e < kTile * D4; e += kThreads) {
      const int j = e / D4, c = 4 * (e - j * D4);
      float* kd = k_s(b) + j * KS + c;
      float* vd = v_s(b) + j * D + c;
      const long long r = key_row(i, j);
      if (r >= 0) {
        cp_async16(smem_u32(kd), ksrc + r + c);
        cp_async16(smem_u32(vd), vsrc + r + c);
      } else {
        *reinterpret_cast<float4*>(kd) = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(vd) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  };

  float m = kNegInf, l = 0.f, acc[DL];
#pragma unroll
  for (int c = 0; c < DL; ++c) acc[c] = 0.f;

  // fold this warp's KW keys of tile i (buffer b) into (m, l, acc)
  auto fold = [&](int i, int b) {
    const float* kr = k_s(b) + key * KS;
    const float* qr = q_s + rl * D;
    // four partial sums: independent FMA chains; the chunk order is
    // rotated by slice so the P lanes of a key read distinct bank groups
    float part4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int u = 0; u < NCH; ++u) {
      const int col = slice * (D / P) + 4 * ((u + slice * (8 / P)) % NCH);
      const float4 kv = *reinterpret_cast<const float4*>(kr + col);
      const float4 qv = *reinterpret_cast<const float4*>(qr + col);
      part4[0] += qv.x * kv.x;
      part4[1] += qv.y * kv.y;
      part4[2] += qv.z * kv.z;
      part4[3] += qv.w * kv.w;
    }
    float dot = (part4[0] + part4[1]) + (part4[2] + part4[3]);
#pragma unroll
    for (int o = 1; o < P; o <<= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    const bool ok = key_limit(i, key) <= qpos;
    const float sc = ok ? dot * scale : kNegInf;
    const float m_new = fmaxf(m, warp_max(sc));
    const float alpha = expf(m - m_new);
    const float p = ok ? expf(sc - m_new) : 0.f;
    l = l * alpha + warp_sum(slice == 0 ? p : 0.f);
    m = m_new;
#pragma unroll
    for (int c = 0; c < DL; ++c) acc[c] *= alpha;
    const float* vr = v_s(b) + sub * KW * D;
#pragma unroll
    for (int kk = 0; kk < KW; ++kk) {
      const float pk = __shfl_sync(0xffffffffu, p, kk * P);
#pragma unroll
      for (int c = 0; c < DL; ++c) acc[c] += pk * vr[kk * D + lane + 32 * c];
    }
  };

  if (n > 0) stage(0, 0);
  cp_commit();
  for (int i = 0; i < n; ++i) {
    const int b = i & 1;
    if (i + 1 < n) stage(i + 1, b ^ 1);  // lands while tile i is folded
    cp_commit();
    cp_wait_one();
    __syncthreads();  // tile i is in buffer b for every thread
    if (active) fold(i, b);
    __syncthreads();  // buffer b is free for tile i + 2
  }

  // merge the P warps of each row in warp order (the tile buffers are
  // free now): red[warp][D] partial outputs, then m and l by warp
  float* red = sm;
  float* red_m = red + kWarps * D;
  float* red_l = red_m + kWarps;
#pragma unroll
  for (int c = 0; c < DL; ++c) red[warp * D + lane + 32 * c] = acc[c];
  if (lane == 0) {
    red_m[warp] = m;
    red_l[warp] = l;
  }
  __syncthreads();
  if (!active || sub != 0) return;
  float mx = kNegInf, sum = 0.f, o[DL];
#pragma unroll
  for (int u = 0; u < P; ++u) mx = fmaxf(mx, red_m[warp + u]);
#pragma unroll
  for (int c = 0; c < DL; ++c) o[c] = 0.f;
#pragma unroll
  for (int u = 0; u < P; ++u) {
    const float w = expf(red_m[warp + u] - mx);
    sum += red_l[warp + u] * w;
#pragma unroll
    for (int c = 0; c < DL; ++c)
      o[c] += red[(warp + u) * D + lane + 32 * c] * w;
  }
  const size_t r = (size_t)sh * Q + row;
  if (n_splits == 1) {
    const float safe = sum == 0.f ? 1.f : sum;
#pragma unroll
    for (int c = 0; c < DL; ++c) out[r * D + lane + 32 * c] = o[c] / safe;
    return;
  }
  float* rec = part + (r * n_splits + z) * (D + 2);
#pragma unroll
  for (int c = 0; c < DL; ++c) rec[lane + 32 * c] = o[c];
  if (lane == 0) {
    rec[D] = mx;
    rec[D + 1] = sum;
  }
}

// One warp per query row: merge its splits' (acc, m, l) in split order
template <int D>
__global__ void __launch_bounds__(kThreads) paged_combine_kernel(
    const float* __restrict__ part, float* __restrict__ out, int rows,
    int n_splits) {
  constexpr int DL = D / 32;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const float* pr = part + (size_t)r * n_splits * (D + 2);
  float mx = kNegInf, sum = 0.f, o[DL];
  for (int z = 0; z < n_splits; ++z) mx = fmaxf(mx, pr[z * (D + 2) + D]);
#pragma unroll
  for (int c = 0; c < DL; ++c) o[c] = 0.f;
  for (int z = 0; z < n_splits; ++z) {
    const float* rec = pr + z * (D + 2);
    const float w = expf(rec[D] - mx);
    sum += rec[D + 1] * w;
#pragma unroll
    for (int c = 0; c < DL; ++c) o[c] += rec[lane + 32 * c] * w;
  }
  const float safe = sum == 0.f ? 1.f : sum;
#pragma unroll
  for (int c = 0; c < DL; ++c) out[(size_t)r * D + lane + 32 * c] = o[c] / safe;
}

struct Args {
  const float *q, *kp, *vp;
  const int *tab, *pos;
  const float *ck, *cv;
  const int* cvalid;
  float *out, *part;
  int S, H, Q, NB, BL, MB, splits;
  float scale;
};

template <int D, bool OVERLAY, int P>
int launch(const Args& a, cudaStream_t st) {
  constexpr int R = kWarps / P;
  constexpr size_t smem = smem_bytes(D, R);
  {
    auto kern = paged_attention_kernel<D, OVERLAY, P>;
    const int e = (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != 0) return e;
    const dim3 grid((unsigned)(a.S * a.H), (unsigned)((a.Q + R - 1) / R),
                    (unsigned)a.splits);
    kern<<<grid, kThreads, smem, st>>>(
        a.q, a.kp, a.vp, a.tab, a.pos, a.ck, a.cv, a.cvalid, a.out, a.part,
        a.H, a.Q, a.NB, a.BL, a.MB, a.splits, a.scale);
    const int err = (int)cudaGetLastError();
    if (err != 0 || a.splits == 1) return err;
  }
  const int rows = a.S * a.H * a.Q;
  auto kern = paged_combine_kernel<D>;
  kern<<<dim3((unsigned)((rows + kWarps - 1) / kWarps)), kThreads, 0, st>>>(
      a.part, a.out, rows, a.splits);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(bool overlay, int rows, const Args& a, cudaStream_t st) {
  switch (rows * 2 + (overlay ? 1 : 0)) {
    case 2: return launch<D, false, 4>(a, st);
    case 3: return launch<D, true, 4>(a, st);
    case 4: return launch<D, false, 2>(a, st);
    case 5: return launch<D, true, 2>(a, st);
    case 8: return launch<D, false, 1>(a, st);
    case 9: return launch<D, true, 1>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// rows_per_block (1, 2 or 4) and n_splits come from the wrapper
// (ops/paged_attention.launch_geometry); part holds S * H * Q * n_splits *
// (D + 2) floats when n_splits > 1 and may be null otherwise.
extern "C" int singa_paged_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* positions, const void* chunk_k, const void* chunk_v,
    const void* chunk_valid, void* out, void* part, int S, int H, int Q,
    int D, int n_blocks, int BL, int MB, int overlay, int rows_per_block,
    int n_splits, float scale, void* stream) {
  if (S <= 0 || H <= 0 || Q <= 0 || BL <= 0 || MB <= 0 || n_blocks <= 0 ||
      n_splits <= 0 || n_splits > 65535 || (long long)S * H > 2147483647)
    return (int)cudaErrorInvalidValue;
  if (overlay && (chunk_k == nullptr || chunk_v == nullptr ||
                  chunk_valid == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_splits > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(q),
               static_cast<const float*>(k_pool),
               static_cast<const float*>(v_pool),
               static_cast<const int*>(tables),
               static_cast<const int*>(positions),
               static_cast<const float*>(chunk_k),
               static_cast<const float*>(chunk_v),
               static_cast<const int*>(chunk_valid),
               static_cast<float*>(out),
               static_cast<float*>(part),
               S, H, Q, n_blocks, BL, MB, n_splits, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_d<64>(overlay != 0, rows_per_block, a, st);
    case 128: return launch_d<128>(overlay != 0, rows_per_block, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
