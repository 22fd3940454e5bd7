// CPU stand-ins for the inline-PTX helpers of csrc/flash_tc.cuh (cp.async,
// ldmatrix, mma.sync), spliced into a copy of that header in place of the
// asm versions; everything else in the header is used as written. Each
// warp collective reads the other lanes' operands through the per-warp
// exchange buffer of emu.h and computes this lane's share, with the
// fragment layouts of the PTX ISA (lane = 4 * g + t):
//   ldmatrix: register j of lane i = row i / 4, columns 2 (i % 4) and
//             2 (i % 4) + 1 of matrix j (transposed: rows 2 (i % 4) and
//             2 (i % 4) + 1, column i / 4), matrix j's rows at the
//             addresses of lanes 8 j .. 8 j + 7;
//   mma.m16n8k16: A, B, C as in flash_tc.cuh's header.
// The copies are synchronous, so commit and wait do nothing.

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  memcpy(smem, gmem, 16);
}
__device__ __forceinline__ void cp_async_commit() {}
template <int N>
__device__ __forceinline__ void cp_async_wait() {}

inline uint32_t emu_pair(const bf16* lo, const bf16* hi) {
  return uint32_t(lo->x) | (uint32_t(hi->x) << 16);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const bf16** rows = reinterpret_cast<const bf16**>(emu_exchange());
  const int lane = emu_lane();
  rows[lane] = p;
  emu_warp_barrier();
  for (int j = 0; j < 4; ++j) {
    const bf16* row = rows[8 * j + lane / 4];
    r[j] = emu_pair(row + 2 * (lane % 4), row + 2 * (lane % 4) + 1);
  }
  emu_warp_barrier();
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const bf16** rows = reinterpret_cast<const bf16**>(emu_exchange());
  const int lane = emu_lane();
  rows[lane] = p;
  emu_warp_barrier();
  for (int j = 0; j < 4; ++j)
    r[j] = emu_pair(rows[8 * j + 2 * (lane % 4)] + lane / 4,
                    rows[8 * j + 2 * (lane % 4) + 1] + lane / 4);
  emu_warp_barrier();
}

inline float emu_lo(uint32_t v) { return __bfloat162float({uint16_t(v & 0xffffu)}); }
inline float emu_hi(uint32_t v) { return __bfloat162float({uint16_t(v >> 16)}); }

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  struct Operands {
    uint32_t a[4], b[2];
  };
  Operands* x = reinterpret_cast<Operands*>(emu_exchange());
  const int lane = emu_lane();
  x[lane] = {{a[0], a[1], a[2], a[3]}, {b0, b1}};
  emu_warp_barrier();
  float A[16][16], B[16][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l / 4, t = l % 4;
    const uint32_t* al = x[l].a;
    A[g][2 * t] = emu_lo(al[0]), A[g][2 * t + 1] = emu_hi(al[0]);
    A[g + 8][2 * t] = emu_lo(al[1]), A[g + 8][2 * t + 1] = emu_hi(al[1]);
    A[g][2 * t + 8] = emu_lo(al[2]), A[g][2 * t + 9] = emu_hi(al[2]);
    A[g + 8][2 * t + 8] = emu_lo(al[3]), A[g + 8][2 * t + 9] = emu_hi(al[3]);
    B[2 * t][g] = emu_lo(x[l].b[0]), B[2 * t + 1][g] = emu_hi(x[l].b[0]);
    B[2 * t + 8][g] = emu_lo(x[l].b[1]), B[2 * t + 9][g] = emu_hi(x[l].b[1]);
  }
  emu_warp_barrier();
  const int g = lane / 4, t = lane % 4;
  for (int k = 0; k < 16; ++k) {
    c[0] += A[g][k] * B[k][2 * t];
    c[1] += A[g][k] * B[k][2 * t + 1];
    c[2] += A[g + 8][k] * B[k][2 * t];
    c[3] += A[g + 8][k] * B[k][2 * t + 1];
  }
}
