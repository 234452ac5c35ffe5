// The quantized gradient ring's per-hop step for Hopper (sm_90a):
// out[i] = float(q[i]) * scale + local[i] over m contiguous elements --
// dequantize the int8 chunk that arrived from the previous rank and add
// this rank's own float32 partial of the same chunk.
//
// Replaces the Pallas TPU kernel
// singa_tpu/ops/quantized_collective.py::_quant_acc_kernel (launched by
// quant_acc at its pl.pallas_call), which the JAX ring runs on every
// reduce-scatter hop of the flat ring and on every inter-group hop of the
// hierarchical q8_hier ring.
//
// Bound on the H100: HBM bytes. Each call reads m int8 values, 4 bytes of
// scale and m float32 partials and writes m float32 sums: 9 * m + 4 bytes
// at 3.35 TB/s. Two operations per element are ~1/5 of an operation per
// byte, far below the float32 rate, so bytes bound every m.
//
// Design (right and simple first):
//   * A grid-stride loop; each thread takes four elements at a time as one
//     char4 and two float4 (16-byte) accesses when the three pointers are
//     aligned for them, then the last m % 4 elements one at a time. Any m
//     works (1, 3, 64, 2^24), and unaligned pointers take the scalar loop.
//     The TPU kernel's (8, 128) tile floor has no counterpart here.
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

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;  // 16 blocks per SM at most

__device__ __forceinline__ float hop(signed char q, float s, float x) {
  return __fadd_rn(__fmul_rn(static_cast<float>(q), s), x);
}

__global__ void __launch_bounds__(kThreads)
    quant_acc_kernel(const signed char* __restrict__ q,
                     const float* __restrict__ scale,
                     const float* __restrict__ local,
                     float* __restrict__ out, long long m, int vec) {
  const float s = __ldg(scale);
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long done = 0;
  if (vec) {
    const long long m4 = m >> 2;
    const auto* q4 = reinterpret_cast<const char4*>(q);
    const auto* x4 = reinterpret_cast<const float4*>(local);
    auto* o4 = reinterpret_cast<float4*>(out);
    for (long long i = tid; i < m4; i += stride) {
      const char4 a = q4[i];
      const float4 x = x4[i];
      float4 o;
      o.x = hop(a.x, s, x.x);
      o.y = hop(a.y, s, x.y);
      o.z = hop(a.z, s, x.z);
      o.w = hop(a.w, s, x.w);
      o4[i] = o;
    }
    done = m4 << 2;
  }
  for (long long i = done + tid; i < m; i += stride) {
    out[i] = hop(q[i], s, local[i]);
  }
}

}  // namespace

// q: m int8; scale: one float32; local, out: m float32; all on the device
// of `stream`. Returns the CUDA error of the launch (0 on success).
extern "C" int singa_quant_acc(const void* q, const void* scale,
                               const void* local, void* out, long long m,
                               void* stream) {
  if (m < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  const int vec = (reinterpret_cast<uintptr_t>(q) % 4 == 0) &&
                  (reinterpret_cast<uintptr_t>(local) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const long long work = vec ? (m >> 2) + (m & 3) : m;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  quant_acc_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const signed char*>(q), static_cast<const float*>(scale),
      static_cast<const float*>(local), static_cast<float*>(out), m, vec);
  return static_cast<int>(cudaGetLastError());
}
