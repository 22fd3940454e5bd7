// Tensor-core building blocks shared by the 16-bit flash kernels
// (flash_fwd.cu K1, flash_bwd.cu K2 and K3): 16-byte cp.async tile
// loads, ldmatrix fragment loads and the m16n8k16 mma.sync with f32
// accumulation, for sm_80 and later (Hopper runs them at the mma.sync
// rate, below wgmma's). The element type T is bf16 or f16 (IEEE half):
// the two instructions take the same fragment layouts, so only the
// operand type of mma, the rounding of f32 values into operands (pack)
// and the conversions differ.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4), each register holding two 16-bit values with the lower
// column in the low half:
//   A (16 x 16, row-major): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..),
//                           a2 = (g, 2t+8..),   a3 = (g+8, 2t+8..)
//   B (16 x 8, k x n):      b0 = (k 2t..2t+1, n g), b1 = (k 2t+8.., n g)
//   C (16 x 8, f32):        c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..)
// So the C fragments of two neighbouring 8-column tiles are, once packed
// to T, the A fragment of one 16-deep product: P goes from S = Q K^T
// into P V without leaving registers.
//
// Tiles live in shared memory row-major with a row stride of D_pad + 8
// elements (D_pad = D rounded up to 16): the 16-byte pad shifts each row
// by one 16-byte bank group, so the eight rows an ldmatrix reads fall in
// eight different bank groups (no conflicts) without a swizzle.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace flash_tc {

typedef __nv_bfloat16 bf16;
typedef __half f16;

__host__ __device__ constexpr int dpad(int D) { return (D + 15) & ~15; }
__host__ __device__ constexpr int row_ld(int D) { return dpad(D) + 8; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lane i gives the address of row i % 8 of
// matrix i / 8, and register j receives matrix j's (row g, cols 2t..2t+1).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed: register j receives matrix j's
// (rows 2t..2t+1, col g), the B fragment of a row-major (k x n) tile.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a * b on the tensor cores: T operands (bf16 or f16), f32
// accumulation.
template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  if constexpr (std::is_same<T, f16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// Two floats rounded to T (nearest even) in one register, lo in the low
// half.
template <typename T>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  if constexpr (std::is_same<T, f16>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(f16 x) { return __half2float(x); }

// Two floats rounded to T, stored at p (4-byte aligned).
template <typename T>
__device__ __forceinline__ void store2(T* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack<T>(lo, hi);
}

// The A fragment of a 16-deep product from the C fragments of two
// neighbouring 8-column tiles (columns 0-7 in c0, 8-15 in c1), rounded
// to T.
template <typename T>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack<T>(c0[0], c0[1]);
  a[1] = pack<T>(c0[2], c0[3]);
  a[2] = pack<T>(c1[0], c1[1]);
  a[3] = pack<T>(c1[2], c1[3]);
}

// Lane offsets inside a 16 x 16 tile for ldsm_x4:
//   A operand (rows m, cols k):  row lane%8 + 8*((lane/8)%2), col 8*(lane/16)
//   B operand from an (n x k) row-major tile (non-transposed) and from a
//   (k x n) row-major tile (transposed): row lane%8 + 8*(lane/16),
//   col 8*((lane/8)%2) for the first; row lane%8 + 8*((lane/8)%2),
//   col 8*(lane/16) for the second. Registers 0, 1 are then the B
//   fragment of the first 8 columns of n, 2, 3 of the next 8.
__device__ __forceinline__ int a_row(int lane) { return (lane & 7) + ((lane >> 3) & 1) * 8; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) * 8; }
__device__ __forceinline__ int bn_row(int lane) { return (lane & 7) + (lane >> 4) * 8; }
__device__ __forceinline__ int bn_col(int lane) { return ((lane >> 3) & 1) * 8; }

// A thread's share of a tile copy: its first 16-byte chunk (row r0,
// chunk c0) of a row-major tile of D 16-bit elements a row, and the step (dr rows,
// dc chunks) to its next one, NT chunks on. Worked out once per kernel,
// so the copies themselves divide nothing.
struct TileSplit {
  int r0, c0, dr, dc, chunks;
};

template <int NT>
__device__ __forceinline__ TileSplit tile_split(int D) {
  const int chunks = D / 8;
  const int r0 = threadIdx.x / chunks, dr = NT / chunks;
  return {r0, (int)threadIdx.x - r0 * chunks, dr, NT - dr * chunks, chunks};
}

// Copy `rows` rows (row stride `rs` elements in device memory) into
// shared memory rows of `ld` elements, 16 bytes a cp.async.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long rs, int rows, int ld,
                                          const TileSplit& s) {
  int r = s.r0, c = s.c0;
  while (r < rows) {
    cp_async16(dst + r * ld + c * 8, src + r * rs + c * 8);
    r += s.dr;
    c += s.dc;
    if (c >= s.chunks) {
      c -= s.chunks;
      ++r;
    }
  }
}

// Zero columns [D, dpad(D)) of `rows` rows: the head-dim padding that the
// 16-deep products read and the loads never write.
template <int NT, typename T>
__device__ __forceinline__ void zero_pad(T* base, int rows, int D, int ld) {
  if (dpad(D) == D) return;
  for (int r = threadIdx.x; r < rows; r += NT)
    *reinterpret_cast<uint4*>(base + r * ld + D) = make_uint4(0u, 0u, 0u, 0u);
}

// Write a warp's 16 staged rows (ld elements apart in shared memory) to
// device memory rows `rs` elements apart, D columns, 16 bytes a store.
template <typename T>
__device__ __forceinline__ void store_rows16(T* dst, long long rs, const T* src, int D, int ld,
                                             int lane) {
  const int chunks = D / 8;
  for (int i = lane; i < 16 * chunks; i += 32) {
    const int r = i / chunks, c = i - r * chunks;
    *reinterpret_cast<uint4*>(dst + r * rs + c * 8) =
        *reinterpret_cast<const uint4*>(src + r * ld + c * 8);
  }
}

}  // namespace flash_tc
