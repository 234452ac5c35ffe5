// CPU emulation of the CUDA primitives that
// singa_tpu_torch/csrc/flash_attention_bwd.cu uses, so that its kernel
// code (tile loads, swizzled ldmatrix addressing, mma fragment layouts,
// masks, reductions) runs on a machine without a GPU. The test that uses
// it (tests/test_torch_flash_bwd.py) compiles the kernel source with g++
// after swapping each inline-assembly primitive for the emu_* function
// of the same meaning and each <<<grid, block, smem, stream>>> launch for
// emu_launch.
//
// One std::thread per CUDA thread; the blocks of a grid run one after
// another, each in the one shared-memory array `smem` (filled with 0xff
// first, since shared memory starts undefined). __syncthreads is a
// barrier of the block's threads; each warp-collective operation writes
// its lanes' operands, meets the warp's other lanes at a barrier, computes
// its lane's result from all of them, and meets them again before the
// operands are reused. cp.async copies synchronously. The mma sums its 16
// products in float32 in k order (the card's tensor cores may round
// differently within a step, well inside the tests' bf16 bar).
#pragma once

#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <thread>
#include <vector>

#define __device__
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

inline thread_local uint3_ threadIdx;
inline uint3_ blockIdx;
inline uint4 smem[1 << 15];  // 512 KB, above the card's 227 KB a block
inline std::barrier<>* block_barrier;
inline std::barrier<>* warp_barrier[32];

inline void __syncthreads() { block_barrier->arrive_and_wait(); }
inline size_t __cvta_generic_to_shared(const void* p) {
  return (size_t)((const char*)p - (const char*)smem);
}

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <typename K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int bytes) {
  return bytes <= 232448 ? cudaSuccess : cudaErrorInvalidValue;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

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
};
inline EmuWarp emu_warp[32];

inline void emu_cp_async16(unsigned dst, const void* src) {
  std::memcpy(emu_smem() + dst, src, 16);
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

template <typename K, typename... A>
void emu_launch(K kernel, dim3 grid, int threads, A... args) {
  std::barrier<> block(threads);
  block_barrier = &block;
  for (int w = 0; w < threads / 32; ++w)
    warp_barrier[w] = new std::barrier<>(32);
  for (unsigned y = 0; y < grid.y; ++y)
    for (unsigned x = 0; x < grid.x; ++x) {
      blockIdx = {x, y, 0};
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
