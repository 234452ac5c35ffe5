// The quantized gradient ring's per-hop step for Hopper (sm_90a):
// out[i] = float(q[i]) * scale + local[i] over m contiguous elements --
// dequantize the int8 bucket chunk that arrived from the previous rank and
// add this rank's own float32 partial of the same chunk -- and, on
// request, amax = max |out[i]|, the next hop's max-abs, from the same pass.
//
// Replaces the Pallas TPU kernel
// singa_tpu/ops/quantized_collective.py::_quant_acc_kernel (launched by
// quant_acc at its pl.pallas_call), which the JAX ring runs on every
// reduce-scatter hop of the flat ring and on every inter-group hop of the
// hierarchical q8_hier ring. The port's ring lays each bucket out as one
// flat (n, C) float32 row per chunk index, so one launch covers a whole
// bucket chunk (41k-148k elements on tinylm_d128.conf with 4 buckets on 4
// ranks), not one parameter.
//
// Bound on the H100: HBM bytes. Each call reads m int8 values, 4 bytes of
// scale and m float32 partials and writes m float32 sums (and 4 bytes of
// amax): 9 * m + 4 (+ 4) bytes at 3.35 TB/s. Two operations per element
// are ~1/5 of an operation per byte, far below the float32 rate, so bytes
// bound every m. At the ring's sizes the bound is below a microsecond and
// launch latency dominates.
//
// Design:
//   * Groups of 4 elements: a thread takes one 4-byte word of q and one
//     float4 of the partials per step, consecutive threads consecutive
//     groups, so every warp load and store is contiguous (32 x 4 bytes of
//     q, 32 x 16 bytes of the partials and sums). (16 or 8 elements a
//     thread, more bytes in flight, timed in turns on an H100 at the
//     ring's bucket chunks and at 2^24, were no faster: the chunks are
//     latency-bound and 2^24 runs at one bandwidth; PERF.md.) The groups
//     need q aligned to 4 bytes and the partials and sums to 16; anything
//     else runs one element at a time, so any m and any row offset of a
//     ragged flat row works. The last m % 4 elements go one at a time.
//   * The grid comes from the card, not a constant: the SM count is read
//     once, and blocks of 256, 128 or 64 threads are chosen so that the
//     ring's bucket chunks spread over every SM; large m is capped at 8
//     blocks an SM, each thread striding over the rest.
//   * amax: each thread keeps the largest |out| as the bits of the float
//     with the sign cleared (for non-negative floats the unsigned order is
//     the float order; any NaN's bits exceed +Inf's, so a NaN wins, as
//     torch.maximum lets it; -0.0 counts as 0). The warp reduces by
//     shuffles, the block in shared memory, and one atomicMax a block
//     merges the blocks into *amax, which the entry zeroes first on the
//     same stream. Max is order-free: the result is deterministic.
//   * The scale is read from device memory (a one-element float32 tensor,
//     the scale the previous rank sent), never passed from the host, so the
//     ring never waits for the device between hops.
//   * Multiply and add are rounded separately (__fmul_rn, __fadd_rn):
//     nvcc would otherwise contract them into one FMA, and the plain
//     version (quant_acc_plain: q.float() * scale + local) rounds twice.
//     The kernel equals it bitwise, and a NaN scale gives NaN everywhere
//     (0 * NaN is NaN), the guard's contract.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMinThreads = 64;
constexpr long long kBlocksPerSm = 8;

extern __shared__ uint4 smem[];

// byte k (0-3, little-endian) of a word, as the int8 it holds
__device__ __forceinline__ signed char byte_of(unsigned u, int k) {
  return static_cast<signed char>((u >> (8 * k)) & 0xffu);
}

__device__ __forceinline__ float hop(signed char q, float s, float x) {
  return __fadd_rn(__fmul_rn(static_cast<float>(q), s), x);
}

// |v| as ordered bits: the float's bits with the sign cleared
__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

// the block's largest bits, merged into *amax by one atomic
__device__ __forceinline__ void block_max(unsigned v, unsigned* amax) {
  for (int o = 16; o > 0; o >>= 1) {
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  auto* warp_max = reinterpret_cast<unsigned*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) {
      v = max(v, warp_max[w]);
    }
    atomicMax(amax, v);
  }
}

// kVec: q, local and out aligned for groups of 4 (else one at a time)
template <bool kVec, bool kAmax>
__global__ void __launch_bounds__(kMaxThreads)
    quant_acc_kernel(const signed char* __restrict__ q,
                     const float* __restrict__ scale,
                     const float* __restrict__ local,
                     float* __restrict__ out, unsigned* __restrict__ amax,
                     long long m) {
  const float s = __ldg(scale);
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  unsigned big = 0;
  long long done = 0;
  if constexpr (kVec) {
    const long long groups = m / 4;
    const auto* q4 = reinterpret_cast<const unsigned*>(q);
    const auto* x4 = reinterpret_cast<const float4*>(local);
    auto* o4 = reinterpret_cast<float4*>(out);
    for (long long g = tid; g < groups; g += stride) {
      const unsigned u = __ldg(q4 + g);
      const float4 x = __ldg(x4 + g);
      float4 o;
      o.x = hop(byte_of(u, 0), s, x.x);
      o.y = hop(byte_of(u, 1), s, x.y);
      o.z = hop(byte_of(u, 2), s, x.z);
      o.w = hop(byte_of(u, 3), s, x.w);
      o4[g] = o;
      if (kAmax) {
        big = max(big, max(max(abs_bits(o.x), abs_bits(o.y)),
                           max(abs_bits(o.z), abs_bits(o.w))));
      }
    }
    done = groups * 4;
  }
  // the last m % 4 elements (every element without kVec), one at a time
  for (long long i = done + tid; i < m; i += stride) {
    const float o = hop(q[i], s, local[i]);
    out[i] = o;
    if (kAmax) big = max(big, abs_bits(o));
  }
  if (kAmax) block_max(big, amax);
}

// the card's SM count, read once (an H100's 132 if the query fails: the
// count shapes the grid only, never the result)
int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        sms <= 0) {
      sms = 132;
    }
    return sms;
  }();
  return n;
}

bool aligned(const void* p, unsigned bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <bool kVec, bool kAmax>
cudaError_t launch(const signed char* q, const float* scale,
                   const float* local, float* out, unsigned* amax,
                   long long m, cudaStream_t stream) {
  // one thread per group of 4, plus the tail's (fewer than 4)
  const long long items = kVec ? m / 4 + m % 4 : m;
  const long long sms = sm_count();
  int threads = kMaxThreads;
  while (threads > kMinThreads && (items + threads - 1) / threads < sms) {
    threads /= 2;
  }
  long long blocks = (items + threads - 1) / threads;
  if (blocks > sms * kBlocksPerSm) blocks = sms * kBlocksPerSm;
  const auto kern = quant_acc_kernel<kVec, kAmax>;
  kern<<<static_cast<unsigned>(blocks), threads,
         kAmax ? (threads / 32) * sizeof(unsigned) : 0, stream>>>(
      q, scale, local, out, amax, m);
  return cudaGetLastError();
}

template <bool kAmax>
cudaError_t dispatch(const signed char* q, const float* scale,
                     const float* local, float* out, unsigned* amax,
                     long long m, cudaStream_t stream) {
  if (aligned(q, 4) && aligned(local, 16) && aligned(out, 16)) {
    return launch<true, kAmax>(q, scale, local, out, amax, m, stream);
  }
  return launch<false, kAmax>(q, scale, local, out, amax, m, stream);
}

}  // namespace

// q: m int8; scale: one float32; local, out: m float32; amax: one float32
// (max |out|) or null; all on the device of `stream`. Returns the CUDA
// error of the launch (0 on success).
extern "C" int singa_quant_acc(const void* q, const void* scale,
                               const void* local, void* out, void* amax,
                               long long m, void* stream) {
  if (m < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (amax != nullptr) {
    const cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(float), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (m == 0) return 0;
  const auto* qp = static_cast<const signed char*>(q);
  const auto* sp = static_cast<const float*>(scale);
  const auto* lp = static_cast<const float*>(local);
  auto* op = static_cast<float*>(out);
  const cudaError_t err =
      amax != nullptr
          ? dispatch<true>(qp, sp, lp, op,
                           static_cast<unsigned*>(amax), m, st)
          : dispatch<false>(qp, sp, lp, op, nullptr, m, st);
  return static_cast<int>(err);
}
