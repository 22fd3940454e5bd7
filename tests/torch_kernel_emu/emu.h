// A CPU stand-in for the CUDA runtime, enough to run the flash kernels of
// mxnet_tpu_torch/csrc/ as plain C++ (g++), for the CPU tests of
// tests/test_torch_kernel_emulation.py. It is force-included ahead of each
// kernel source.
//
// Each CUDA thread of a block is one std::thread; the blocks of a grid run
// one after another. __syncthreads is a barrier over the block, and every
// warp collective (shuffles here, ldmatrix and mma.sync in emu_tc.h) is an
// exchange through a per-warp buffer between two barriers over the warp's
// 32 threads. Dynamic shared memory is one buffer, filled with 0xff (NaN
// in bf16 and f32) before each block, so a kernel that reads shared memory
// it never wrote shows it.
#pragma once

#include <pthread.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>
using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(x)
#define __shared__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct emu_uint3 {
  unsigned x, y, z;
};
inline thread_local emu_uint3 threadIdx;
inline thread_local emu_uint3 blockIdx;

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorMisalignedAddress = 716 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
constexpr int EMU_SMEM_LIMIT = 232448;  // a Hopper block's shared memory
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int bytes) {
  return bytes > EMU_SMEM_LIMIT ? cudaErrorInvalidValue : cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

struct __nv_bfloat16 {
  uint16_t x;
};
struct __nv_bfloat162 {
  __nv_bfloat16 x, y;
};
inline __nv_bfloat16 __float2bfloat16(float f) {  // round to nearest even
  uint32_t u;
  memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {uint16_t((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {uint16_t(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = uint32_t(b.x) << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}
struct uint4 {
  unsigned x, y, z, w;
};
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }

struct EmuBlock {
  pthread_barrier_t bar;
  std::vector<pthread_barrier_t> wbar;
  std::vector<std::vector<unsigned char>> xbuf;  // per warp: 32 lanes x 256 bytes
  explicit EmuBlock(int n)
      : wbar(n / 32), xbuf(n / 32, std::vector<unsigned char>(32 * 256)) {
    pthread_barrier_init(&bar, nullptr, n);
    for (auto& b : wbar) pthread_barrier_init(&b, nullptr, 32);
  }
  ~EmuBlock() {
    pthread_barrier_destroy(&bar);
    for (auto& b : wbar) pthread_barrier_destroy(&b);
  }
};
inline thread_local EmuBlock* emu_block;
inline int emu_lane() { return threadIdx.x & 31; }
inline int emu_warp() { return threadIdx.x >> 5; }
inline void emu_warp_barrier() { pthread_barrier_wait(&emu_block->wbar[emu_warp()]); }
inline unsigned char* emu_exchange() { return emu_block->xbuf[emu_warp()].data(); }

inline void __syncthreads() { pthread_barrier_wait(&emu_block->bar); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp_barrier(); }
template <class T>
T __shfl_xor_sync(unsigned, T v, int mask) {
  T* x = reinterpret_cast<T*>(emu_exchange());
  x[emu_lane()] = v;
  emu_warp_barrier();
  T r = x[emu_lane() ^ mask];
  emu_warp_barrier();
  return r;
}

// Defined by the including translation unit: its dynamic shared memory.
extern unsigned char* emu_smem_base;
extern size_t emu_smem_bytes;

// kernel<<<grid, block, smem, stream>>>(p), one block at a time.
template <class K, class P>
void emu_launch(K kernel, dim3 grid, int block, size_t smem, cudaStream_t, P p) {
  if (smem > emu_smem_bytes) {
    fprintf(stderr, "emu_launch: %zu bytes of shared memory\n", smem);
    abort();
  }
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        memset(emu_smem_base, 0xff, emu_smem_bytes);
        EmuBlock blk(block);
        std::vector<std::thread> threads;
        for (int t = 0; t < block; ++t)
          threads.emplace_back([&, t] {
            threadIdx = {(unsigned)t, 0, 0};
            blockIdx = {x, y, z};
            emu_block = &blk;
            kernel(p);
          });
        for (auto& th : threads) th.join();
      }
}
