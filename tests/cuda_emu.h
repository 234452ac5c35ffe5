// CPU emulation of the CUDA primitives that the kernel sources
// singa_tpu_torch/csrc/flash_attention.cu, flash_attention_bf16.cu,
// paged_attention.cu and quant_acc.cu use, so that their kernel code (tile
// loads, swizzled ldmatrix addressing, mma fragment layouts, shuffles,
// masks, reductions, atomics, the fused backward's ticket and counters)
// runs on a machine without a GPU. The tests that use it
// (tests/test_torch_flash_bwd.py, test_torch_flash_fwd.py,
// test_torch_flash_f32_emu.py, test_torch_paged_split.py,
// test_torch_quant_acc.py) compile a kernel source with g++ after
// swapping each inline-assembly primitive for the emu_* function of the
// same meaning and each <<<grid, block, smem, stream>>> launch for
// emu_launch.
//
// One std::thread per CUDA thread; the blocks of a grid run one after
// another, each in the one shared-memory array `smem` (filled with 0xff
// first, since shared memory starts undefined). __syncthreads is a
// barrier of the block's threads, and bar.sync id, n (emu_bar_sync) one of
// the n threads that name barrier id; each warp-collective operation
// (ldmatrix, mma, __shfl_sync, __shfl_xor_sync) writes
// its lanes' operands, meets the warp's other lanes at a barrier, computes
// its lane's result from all of them, and meets them again before the
// operands are reused. cp.async lands at its wait: each thread's copies
// read their 16 source bytes when issued and queue by commit group, and
// reach shared memory only at a cp.async.wait_group n of that thread
// (emu_cp_wait: every group but the newest n), so a kernel that reads a
// stage before waiting for it, or before the barrier after its threads'
// waits, reads the stage's old bytes. The mma sums its 16
// products in float32 in k order (the card's tensor cores may round
// differently within a step, well inside the tests' bf16 bar).
// __fmul_rn and __fadd_rn round each result to float32 on its own (a
// volatile store, so g++ cannot contract them into an FMA); atomicMax is
// a compare-and-swap loop; the device reports emu_sm_count SMs.
// Since blocks run one after another, a block that waits on another's
// flag (ld.acquire / st.release: emu_ld_acquire, emu_st_release) finds it
// set or waits forever: a kernel must bound its polls. __trap records
// cudaErrorLaunchFailure, which the next cudaGetLastError returns (the
// thread then runs on); the occupancy query allows blocks by the SM's
// 228 KB of shared memory (1 KB reserved a block) and 2048 threads.
#pragma once

#include <algorithm>
#include <atomic>
#include <barrier>
#include <chrono>
#include <climits>
#include <cmath>
#include <cstddef>
#include <condition_variable>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

#define __device__
#define __host__
#define __global__
#define __shared__
#define __forceinline__ inline
#define __launch_bounds__(...)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3_ {
  unsigned x, y, z;
};
struct uint4 {
  unsigned x, y, z, w;
};
struct float2 {
  float x, y;
};
struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}

using std::max;
using std::min;

inline thread_local uint3_ threadIdx;
inline uint3_ blockIdx;
inline dim3 gridDim, blockDim;
inline uint4 smem[1 << 15];  // 512 KB, above the card's 227 KB a block
inline std::barrier<>* block_barrier;
inline std::barrier<>* warp_barrier[32];

inline void __syncthreads() { block_barrier->arrive_and_wait(); }
inline size_t __cvta_generic_to_shared(const void* p) {
  return (size_t)((const char*)p - (const char*)smem);
}

typedef void* cudaStream_t;
enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorLaunchFailure = 719
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <typename K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int bytes) {
  return bytes <= 232448 ? cudaSuccess : cudaErrorInvalidValue;
}
inline cudaError_t emu_error = cudaSuccess;
inline cudaError_t cudaGetLastError() {
  const cudaError_t e = emu_error;
  emu_error = cudaSuccess;
  return e;
}
inline void __trap() { emu_error = cudaErrorLaunchFailure; }
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return cudaSuccess;
}
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline int emu_sm_count = 132;  // an H100's
extern "C" void emu_set_sm_count(int n) { emu_sm_count = n; }
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = emu_sm_count;
  return cudaSuccess;
}
template <typename K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K,
                                                          int threads,
                                                          size_t smem) {
  *n = std::min(2048 / threads, (int)(233472 / (smem + 1024)));
  return cudaSuccess;
}

template <typename T>
inline T __ldg(const T* p) {
  return *p;
}
inline float __fmul_rn(float a, float b) {
  volatile float r = a * b;
  return r;
}
inline float __fadd_rn(float a, float b) {
  volatile float r = a + b;
  return r;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline float4 __ldcg(const float4* p) { return *p; }
inline void __stcg(float4* p, float4 v) { *p = v; }
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
inline long long clock64() {
  return std::chrono::steady_clock::now().time_since_epoch().count();
}
inline int atomicAdd(int* p, int v) {
  return std::atomic_ref<int>(*p).fetch_add(v);
}
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).fetch_add(v);
}
inline int emu_ld_acquire(const int* p) {
  return std::atomic_ref<int>(*const_cast<int*>(p))
      .load(std::memory_order_acquire);
}
inline void emu_st_release(int* p, int v) {
  std::atomic_ref<int>(*p).store(v, std::memory_order_release);
}
inline unsigned atomicMax(unsigned* p, unsigned v) {
  std::atomic_ref<unsigned> a(*p);
  unsigned old = a.load();
  while (old < v && !a.compare_exchange_weak(old, v)) {
  }
  return old;
}

struct __nv_bfloat16 {
  unsigned short x;
};
struct __nv_bfloat162 {
  __nv_bfloat16 x, y;
};
inline unsigned short emu_f2bf(float f) {  // round to nearest even
  unsigned u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0;  // NaN
  u += 0x7fffu + ((u >> 16) & 1u);
  return (unsigned short)(u >> 16);
}
inline float emu_bf2f(unsigned short h) {
  const unsigned u = (unsigned)h << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat162 __floats2bfloat162_rn(float lo, float hi) {
  __nv_bfloat162 r;
  r.x.x = emu_f2bf(lo);
  r.y.x = emu_f2bf(hi);
  return r;
}

inline unsigned char* emu_smem() { return (unsigned char*)smem; }

struct EmuWarp {
  unsigned addr[32];
  unsigned a[32][4], b[32][2];
  float f[32];
  unsigned u[32];
};
inline EmuWarp emu_warp[32];

// cp.async.cg.shared.global 16 bytes, commit_group, wait_group n: a
// thread's copies queue by commit group and land at its wait
struct EmuCopy {
  unsigned dst;
  unsigned char bytes[16];
};
struct EmuCopyQueue {
  std::vector<EmuCopy> open;                // issued, not yet committed
  std::deque<std::vector<EmuCopy>> groups;  // committed, oldest first
};
inline thread_local EmuCopyQueue emu_copies;

inline void emu_cp_async16(unsigned dst, const void* src) {
  EmuCopy c;
  c.dst = dst;
  std::memcpy(c.bytes, src, 16);
  emu_copies.open.push_back(c);
}
inline void emu_cp_commit() {
  emu_copies.groups.push_back(std::move(emu_copies.open));
  emu_copies.open.clear();
}
// every committed group but the newest n lands
inline void emu_cp_wait(int n) {
  while ((int)emu_copies.groups.size() > n) {
    for (const EmuCopy& c : emu_copies.groups.front())
      std::memcpy(emu_smem() + c.dst, c.bytes, 16);
    emu_copies.groups.pop_front();
  }
}

// bar.sync id, n: the n threads that name barrier id meet
struct EmuNamedBarrier {
  std::mutex mu;
  std::condition_variable cv;
  int arrived = 0;
  unsigned long generation = 0;
};
inline EmuNamedBarrier emu_named_barrier[16];
inline void emu_bar_sync(int id, int n) {
  EmuNamedBarrier& b = emu_named_barrier[id];
  std::unique_lock<std::mutex> lock(b.mu);
  const unsigned long gen = b.generation;
  if (++b.arrived == n) {
    b.arrived = 0;
    ++b.generation;
    b.cv.notify_all();
  } else {
    b.cv.wait(lock, [&] { return b.generation != gen; });
  }
}

// ldmatrix.sync.aligned.m8n8.x4[.trans].shared.b16: lanes 8i..8i+7 give
// the row addresses of matrix i; lane l receives, in register i, elements
// (l / 4, 2 (l % 4) + {0, 1}) of matrix i, or with .trans elements
// (2 (l % 4) + {0, 1}, l / 4)
inline void emu_ldmatrix(unsigned addr, unsigned r[4], bool trans) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  EmuWarp& x = emu_warp[w];
  x.addr[l] = addr;
  warp_barrier[w]->arrive_and_wait();
  const int g = l >> 2, t = l & 3;
  for (int i = 0; i < 4; ++i) {
    unsigned short lo, hi;
    if (!trans) {
      std::memcpy(&lo, emu_smem() + x.addr[8 * i + g] + 4 * t, 2);
      std::memcpy(&hi, emu_smem() + x.addr[8 * i + g] + 4 * t + 2, 2);
    } else {
      std::memcpy(&lo, emu_smem() + x.addr[8 * i + 2 * t] + 2 * g, 2);
      std::memcpy(&hi, emu_smem() + x.addr[8 * i + 2 * t + 1] + 2 * g, 2);
    }
    r[i] = lo | ((unsigned)hi << 16);
  }
  warp_barrier[w]->arrive_and_wait();
}

inline float emu_half(unsigned v, int high) {
  return emu_bf2f(high ? (unsigned short)(v >> 16)
                       : (unsigned short)(v & 0xffffu));
}

// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, c += a b: lane
// (g, t) = (l / 4, l % 4) holds A rows g, g + 8 and k 2t + {0, 1},
// 2t + 8 + {0, 1} (a0 a1 a2 a3); B k 2t + {0, 1}, 2t + 8 + {0, 1} of
// column g (b0 b1); C rows g, g + 8 of columns 2t + {0, 1}
inline void emu_mma(float c[4], const unsigned a[4], unsigned b0,
                    unsigned b1) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  EmuWarp& x = emu_warp[w];
  for (int e = 0; e < 4; ++e) x.a[l][e] = a[e];
  x.b[l][0] = b0;
  x.b[l][1] = b1;
  warp_barrier[w]->arrive_and_wait();
  const int g = l >> 2, t = l & 3;
  for (int e = 0; e < 4; ++e) {
    const int row = g + (e >> 1) * 8, col = 2 * t + (e & 1);
    float sum = 0.f;
    for (int k = 0; k < 16; ++k) {
      const float av = emu_half(
          x.a[(row % 8) * 4 + (k % 8) / 2][(row >= 8) + 2 * (k >= 8)], k & 1);
      const float bv = emu_half(x.b[col * 4 + (k % 8) / 2][k >= 8], k & 1);
      sum += av * bv;
    }
    c[e] += sum;
  }
  warp_barrier[w]->arrive_and_wait();
}

// a warp shuffle: lane l receives the value of lane src(l)
template <typename Src>
inline float emu_shfl(float v, Src src) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  EmuWarp& x = emu_warp[w];
  x.f[l] = v;
  warp_barrier[w]->arrive_and_wait();
  const float r = x.f[src(l) & 31];
  warp_barrier[w]->arrive_and_wait();
  return r;
}
inline float __shfl_xor_sync(unsigned, float v, int mask) {
  return emu_shfl(v, [mask](int l) { return l ^ mask; });
}
inline float __shfl_sync(unsigned, float v, int src) {
  return emu_shfl(v, [src](int) { return src; });
}
inline unsigned __shfl_xor_sync(unsigned, unsigned v, int mask) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  EmuWarp& x = emu_warp[w];
  x.u[l] = v;
  warp_barrier[w]->arrive_and_wait();
  const unsigned r = x.u[(l ^ mask) & 31];
  warp_barrier[w]->arrive_and_wait();
  return r;
}

template <typename K, typename... A>
void emu_launch(K kernel, dim3 grid, int threads, A... args) {
  std::barrier<> block(threads);
  block_barrier = &block;
  gridDim = grid;
  blockDim = dim3(threads);
  for (int w = 0; w < threads / 32; ++w)
    warp_barrier[w] = new std::barrier<>(32);
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        blockIdx = {x, y, z};
        std::memset(smem, 0xff, sizeof(smem));
        std::vector<std::thread> pool;
        for (int i = 0; i < threads; ++i)
          pool.emplace_back([&, i] {
            threadIdx = {(unsigned)i, 0, 0};
            kernel(args...);
          });
        for (auto& th : pool) th.join();
      }
  for (int w = 0; w < threads / 32; ++w) delete warp_barrier[w];
}
