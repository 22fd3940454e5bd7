// Flash-attention backward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the two TPU kernels of mxnet_tpu/ops/flash_attention.py that
// `_flash_bwd_pallas` launches through pl.pallas_call:
//   K2 `_dq_kernel`:  per query tile, over the key tiles,
//        P  = exp(scale * Q K^T - LSE)   (masked entries exactly 0)
//        dP = dO V^T,   dS = P o (dP - Delta),   dQ += scale * dS K
//   K3 `_dkv_kernel`: per key tile, over the query tiles,
//        dV += P^T dO,  dK += scale * dS^T Q
// with Delta = rowsum(dO o O) in float32 and LSE the per-row log-sum-exp
// that the forward (flash_fwd.cu) writes. The JAX package computes Delta
// in XLA before its kernels; here K2 computes it for its own query rows
// from the dO tile it holds anyway, writes it out, and K3, launched after
// K2 on the same stream, reads it: no separate pass over dO and O.
//
// Semantics carried over from the TPU kernels, by every route below:
//   * end-aligned causal masking (query i sees keys <= i + S_k - S_q), the
//     sliding-window band (i+off-W, i+off], the key-padding mask (B, S_k)
//     kept where > 0;
//   * masked P is set to exactly 0, not exp of a huge negative, so a query
//     that sees no key gets an exactly zero dQ and a key that no query
//     sees gets exactly zero dK and dV;
//   * tiles wholly outside the causal band or below the window are
//     skipped for ANY causal offset (their P is exactly 0, so the skip
//     changes no result; the forward may skip only when S_k >= S_q);
//   * f32 inputs use f32 FMAs (never TF32); bf16 inputs accumulate in f32
//     and round P to bf16 before P^T dO and dS to bf16 before dS K and
//     dS^T Q, as the TPU kernels feed their matrix unit.
//
// Layout: q, O, dO (B, S_q, H, D), k, v (B, S_k, KV, D), read through
// their strides (the last dimension contiguous). dQ, dK, dV are contiguous in
// the same layouts, in the input type; LSE and Delta are (B*H, S_q) f32.
// Grouped-query attention is native: K3 runs one block per KV head and
// sums dK and dV over the H/KV query heads of its group inside the block,
// with no atomics and no repeated K/V (the JAX package repeats K/V before
// its kernels and lets XLA sum the repeat).
//
// Bound on the H100 SXM (989 TFLOP/s bf16 dense, 67 TFLOP/s f32 without
// tensor cores, 3.35 TB/s): five products of 2*S_q*S_k*D operations per
// (batch, head), scaled by the visible fraction of the mask, against the
// bytes of Q, K, V, O, dO and LSE read and dQ, dK, dV written. K3 alone
// does four of them (S^T, dP^T, P^T dO, dS^T Q) and moves Q, K, V, dO,
// LSE and Delta in and dK, dV out. At BERT's training shape (B=64, S=128,
// H=12, D=64, bf16) that is 6.4 GFLOP, 6.5 us of tensor-core time,
// against 76 MB, 23 us: the bound is the bytes.
//
// K3 in bf16 runs on the tensor cores (flash_bwd_dkv_tc_kernel), in the
// style of FlashAttention-2: one block of 4 warps per (64-key tile, KV
// head, batch row), each warp owning 16 key rows; a loop over the query
// heads of the group and the visible 64-query tiles, whose Q, dO, LSE and
// Delta come into shared memory by 16-byte cp.async, double-buffered (the
// next tile's copy in flight while the current one is computed). S^T =
// K Q^T and dP^T = V dO^T run as mma.sync m16n8k16 (bf16 in, f32
// accumulate), 32 queries a pass; K and V are A fragments held in
// registers at D <= 64 and read from shared memory by ldmatrix above it,
// where the dK and dV accumulators (two 16 x D f32 tiles a warp) leave no
// room. P^T and dS^T are formed on the accumulator fragments and packed
// straight into bf16 A fragments for dV += P^T dO and dK += dS^T Q, whose
// B operands come from the row-major Q and dO tiles through
// ldmatrix.trans. Head dims that are not a multiple of 16 are zero-padded
// in shared memory; the padding columns are never written out. What this
// removes, against the CUDA-core design: the f32 staging of bf16 tiles,
// one scalar shared-memory load per FMA, and the round trip of P^T and
// dS^T through shared memory.
//
// The other kernels keep the first, CUDA-core design (f32 FMAs):
//   * K2, both types: one block of 256 threads per (64-query tile, head,
//     batch row): Delta for its rows (one warp reduction a row), then a
//     loop over the 32-key tiles of KV head h / (H / KV); the dQ
//     accumulator stays in registers (4 rows x D/16 columns a thread);
//   * K3 in f32: one block of 256 threads per (32-key tile, KV head,
//     batch row), looping over every query head of the group and every
//     32-query tile; dK and dV stay in registers. The tensor cores take f32
//     only as TF32, which the kernel contract forbids, so f32 stays on the
//     CUDA cores;
//   * every tile is staged in shared memory as f32 with rows padded by one
//     word (column reads free of bank conflicts).
// Not done yet: K2 on the tensor cores (next), then wgmma with TMA loads
// and warp specialisation for whichever kernel stays below half its
// bound, and one fused pass for dQ, dK and dV.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tc.cuh"

namespace {

constexpr int NT = 256;        // threads per block: 8 warps
constexpr int BQ = 64;         // K2: query rows per block
constexpr int BK = 32;         // K2: keys per tile
constexpr int PS = BK + 1;     // K2: padded row stride of the dS tile
constexpr int BKV = 32;        // K3: keys per block
constexpr int BQ3 = 32;        // K3: queries per tile
constexpr int PS3 = BQ3 + 1;   // K3: padded row stride of the P^T, dS^T tiles

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;         // the forward's output
  const void* g;         // dO
  const float* lse;      // (B*H, S_q)
  float* delta;          // (B*H, S_q): K2 writes it, K3 reads it
  const float* kmask;    // nullable, (B, S_k) contiguous
  void* dq;
  void* dk;
  void* dv;
  int B, H, KV, Sq, Sk, D;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh, gsb, gss,
      gsh;
  float scale;
  int causal;
  int window;  // 0: no window
};

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// An operand of a product enters it in the input type: rounded to bf16 for
// bf16 inputs, unchanged for f32.
template <typename T>
__device__ __forceinline__ float round_op(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// The element mask: causal band, window and key padding.
__device__ __forceinline__ bool keep(const Params& p, int b, int qp, int kp, int off) {
  bool ok = true;
  if (p.causal) {
    ok = qp + off >= kp;
    if (p.window > 0) ok = ok && (kp > qp + off - p.window);
  }
  if (p.kmask) ok = ok && (p.kmask[(long long)b * p.Sk + kp] > 0.f);
  return ok;
}

// The tile skip of the TPU kernels: queries [q0, q0+nq) and keys
// [k0, k0+nk) share no visible pair. Uniform over the block.
__device__ __forceinline__ bool tile_visible(const Params& p, int q0, int nq, int k0, int nk,
                                             int off) {
  if (!p.causal) return true;
  bool vis = q0 + nq - 1 + off >= k0;
  if (p.window > 0) vis = vis && (k0 + nk - 1 > q0 + off - p.window);
  return vis;
}

template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long row_stride,
                                          int row0, int rows, int D, int DP) {
  for (int i = threadIdx.x; i < rows * D; i += NT) {
    const int r = i / D, d = i - r * D;
    dst[r * DP + d] = to_f32<T>(src[(long long)(row0 + r) * row_stride + d]);
  }
}

__host__ __device__ constexpr size_t dq_smem_floats(int D) {
  return 2 * (size_t)BQ * (D + 1) + 2 * (size_t)BK * (D + 1) + (size_t)BQ * PS + 2 * BQ;
}

__host__ __device__ constexpr size_t dkv_smem_floats(int D) {
  return 2 * (size_t)BKV * (D + 1) + 2 * (size_t)BQ3 * (D + 1) + 2 * (size_t)BKV * PS3 +
         2 * BQ3;
}

// K2: Delta and dQ for one (query tile, head, batch row).
template <typename T, int DMAX>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int DP = D + 1;
  float* Qs = smem;                // BQ x DP
  float* Gs = Qs + BQ * DP;        // BQ x DP (dO)
  float* Ks = Gs + BQ * DP;        // BK x DP
  float* Vs = Ks + BK * DP;        // BK x DP
  float* Ss = Vs + BK * DP;        // BQ x PS (dS, rounded)
  float* lse_s = Ss + BQ * PS;     // BQ
  float* del_s = lse_s + BQ;       // BQ

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int off = p.Sk - p.Sq;
  const long long row0 = ((long long)b * p.H + h) * p.Sq + q0;

  const T* qg = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
  const T* og = static_cast<const T*>(p.o) + b * p.osb + h * p.osh;
  const T* gg = static_cast<const T*>(p.g) + b * p.gsb + h * p.gsh;
  const T* kg = static_cast<const T*>(p.k) + b * p.ksb + kvh * p.ksh;
  const T* vg = static_cast<const T*>(p.v) + b * p.vsb + kvh * p.vsh;

  load_tile<T>(Qs, qg, p.qss, q0, BQ, D, DP);
  load_tile<T>(Gs, gg, p.gss, q0, BQ, D, DP);
  if (tid < BQ) lse_s[tid] = p.lse[row0 + tid];
  __syncthreads();

  // Delta = rowsum(dO o O) in f32: each warp owns BQ/8 rows, lanes split D
  for (int rr = 0; rr < BQ / 8; ++rr) {
    const int r = warp * (BQ / 8) + rr;
    float sum = 0.f;
    for (int d = lane; d < D; d += 32)
      sum = fmaf(Gs[r * DP + d], to_f32<T>(og[(long long)(q0 + r) * p.oss + d]), sum);
#pragma unroll
    for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      del_s[r] = sum;
      p.delta[row0 + r] = sum;
    }
  }

  // thread owns dQ rows ty + 16*i and head-dim columns tx + 16*j
  constexpr int NJ = DMAX / 16;
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int nkb = p.Sk / BK;
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BK;
    if (!tile_visible(p, q0, BQ, k0, BK, off)) continue;
    __syncthreads();  // Delta is in; the previous tile's readers are done
    load_tile<T>(Ks, kg, p.kss, k0, BK, D, DP);
    load_tile<T>(Vs, vg, p.vss, k0, BK, D, DP);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: rows ty + 16*i, keys tx + 16*j
    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], gv[4], kv[2], vv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty + 16 * i) * DP + d];
        gv[i] = Gs[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        kv[j] = Ks[(tx + 16 * j) * DP + d];
        vv[j] = Vs[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        float ds = 0.f;
        if (keep(p, b, q0 + r, k0 + c, off)) {
          const float pr = expf(s[i][j] * p.scale - lse_s[r]);
          ds = pr * (dp[i][j] - del_s[r]);
        }
        Ss[r * PS + c] = round_op<T>(ds);
      }
    }
    __syncthreads();

    // dQ += dS K
    for (int c = 0; c < BK; ++c) {
      float dsr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsr[i] = Ss[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          const float kk = Ks[c * DP + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dsr[i], kk, acc[i][j]);
        }
      }
    }
  }

  T* dqg = static_cast<T*>(p.dq) + ((long long)b * p.Sq * p.H + h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) dqg[(long long)(q0 + r) * p.H * D + d] = from_f32<T>(acc[i][j] * p.scale);
    }
  }
}

// K3: dK and dV for one (key tile, KV head, batch row), summed over the
// query heads of the group. The f32 route: f32 FMAs on the CUDA cores.
template <int DMAX>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int DP = D + 1;
  float* Ks = smem;                 // BKV x DP
  float* Vs = Ks + BKV * DP;        // BKV x DP
  float* Qs = Vs + BKV * DP;        // BQ3 x DP
  float* Gs = Qs + BQ3 * DP;        // BQ3 x DP (dO)
  float* Ps = Gs + BQ3 * DP;        // BKV x PS3 (P^T)
  float* Ds = Ps + BKV * PS3;       // BKV x PS3 (dS^T)
  float* lse_s = Ds + BKV * PS3;    // BQ3
  float* del_s = lse_s + BQ3;       // BQ3

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * BKV;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int group = p.H / p.KV;
  const int off = p.Sk - p.Sq;

  const float* kg = static_cast<const float*>(p.k) + b * p.ksb + kvh * p.ksh;
  const float* vg = static_cast<const float*>(p.v) + b * p.vsb + kvh * p.vsh;
  load_tile<float>(Ks, kg, p.kss, k0, BKV, D, DP);
  load_tile<float>(Vs, vg, p.vss, k0, BKV, D, DP);

  // thread owns dK/dV rows ty + 16*i and head-dim columns tx + 16*j
  constexpr int KR = BKV / 16;
  constexpr int NJ = DMAX / 16;
  float dk[KR][NJ], dv[KR][NJ];
#pragma unroll
  for (int i = 0; i < KR; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int nqb = p.Sq / BQ3;
  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const float* qg = static_cast<const float*>(p.q) + b * p.qsb + h * p.qsh;
    const float* gg = static_cast<const float*>(p.g) + b * p.gsb + h * p.gsh;
    const long long row0 = ((long long)b * p.H + h) * p.Sq;
    for (int qb = 0; qb < nqb; ++qb) {
      const int q0 = qb * BQ3;
      if (!tile_visible(p, q0, BQ3, k0, BKV, off)) continue;
      __syncthreads();  // K/V loaded; the previous tile's readers are done
      load_tile<float>(Qs, qg, p.qss, q0, BQ3, D, DP);
      load_tile<float>(Gs, gg, p.gss, q0, BQ3, D, DP);
      if (tid < BQ3) {
        lse_s[tid] = p.lse[row0 + q0 + tid];
        del_s[tid] = p.delta[row0 + q0 + tid];
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: key rows ty + 16*i, queries tx + 16*j
      float s[KR][2], dp[KR][2];
#pragma unroll
      for (int i = 0; i < KR; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
      for (int d = 0; d < D; ++d) {
        float kv[KR], vv[KR], qv[2], gv[2];
#pragma unroll
        for (int i = 0; i < KR; ++i) {
          kv[i] = Ks[(ty + 16 * i) * DP + d];
          vv[i] = Vs[(ty + 16 * i) * DP + d];
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          qv[j] = Qs[(tx + 16 * j) * DP + d];
          gv[j] = Gs[(tx + 16 * j) * DP + d];
        }
#pragma unroll
        for (int i = 0; i < KR; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < KR; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          float pr = 0.f, ds = 0.f;
          if (keep(p, b, q0 + c, k0 + r, off)) {
            pr = expf(s[i][j] * p.scale - lse_s[c]);
            ds = pr * (dp[i][j] - del_s[c]);
          }
          Ps[r * PS3 + c] = pr;
          Ds[r * PS3 + c] = ds;
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q
      for (int c = 0; c < BQ3; ++c) {
        float pv[KR], dsv[KR];
#pragma unroll
        for (int i = 0; i < KR; ++i) {
          pv[i] = Ps[(ty + 16 * i) * PS3 + c];
          dsv[i] = Ds[(ty + 16 * i) * PS3 + c];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int d = tx + 16 * j;
          if (d < D) {
            const float gd = Gs[c * DP + d];
            const float qd = Qs[c * DP + d];
#pragma unroll
            for (int i = 0; i < KR; ++i) {
              dv[i][j] = fmaf(pv[i], gd, dv[i][j]);
              dk[i][j] = fmaf(dsv[i], qd, dk[i][j]);
            }
          }
        }
      }
    }
  }

  const long long base = ((long long)b * p.Sk * p.KV + kvh) * D;
  float* dkg = static_cast<float*>(p.dk) + base;
  float* dvg = static_cast<float*>(p.dv) + base;
#pragma unroll
  for (int i = 0; i < KR; ++i) {
    const long long r = (long long)(k0 + ty + 16 * i) * p.KV * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        dkg[r + d] = dk[i][j] * p.scale;
        dvg[r + d] = dv[i][j];
      }
    }
  }
}

// ---- K3 in bf16 on the tensor cores ------------------------------------------

constexpr int TC_NT = 128;   // threads per block: 4 warps
constexpr int TC_BKV = 64;   // keys per block: 16 per warp
constexpr int TC_BQ = 64;    // queries per double-buffered tile
constexpr int TC_QC = 32;    // queries per pass over a tile (bounds S^T, dP^T registers)
constexpr float LOG2E = 1.4426950408889634f;

using flash_tc::bf16;

__host__ __device__ constexpr size_t dkv_tc_smem_bytes(int D) {
  return (size_t)(2 * TC_BKV + 4 * TC_BQ) * flash_tc::row_ld(D) * sizeof(bf16) +
         4 * TC_BQ * sizeof(float);
}

// K3 for bf16: dK and dV for one (64-key tile, KV head, batch row), summed
// over the query heads of the group. K and V stay in registers as A
// fragments for DMAX <= 64, and are read from shared memory per product
// above that (at D = 128 the dK and dV accumulators take 128 registers).
template <int DMAX>
__global__ void __launch_bounds__(TC_NT) flash_bwd_dkv_tc_kernel(Params p) {
  using namespace flash_tc;
  constexpr bool KV_REGS = DMAX <= 64;
  constexpr int NKD = DMAX / 16;   // 16-deep chunks of the head dim
  constexpr int NND = DMAX / 8;    // 8-wide column tiles of dK, dV
  constexpr int NNQ = TC_QC / 8;   // 8-wide query tiles of S^T, dP^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = p.D, DP = dpad(D), LD = row_ld(D);
  const int nkd = DP / 16;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // TC_BKV x LD
  bf16* Vs = Ks + TC_BKV * LD;                   // TC_BKV x LD
  bf16* Qs = Vs + TC_BKV * LD;                   // 2 x TC_BQ x LD
  bf16* Gs = Qs + 2 * TC_BQ * LD;                // 2 x TC_BQ x LD (dO)
  float* lse_s = reinterpret_cast<float*>(Gs + 2 * TC_BQ * LD);  // 2 x TC_BQ
  float* del_s = lse_s + 2 * TC_BQ;                              // 2 x TC_BQ

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * TC_BKV;  // causal: key tile 0 sees the most queries, and goes first
  const int group = p.H / p.KV;
  const int off = p.Sk - p.Sq;
  const int key0 = k0 + 16 * warp + g;  // this lane's keys: key0, key0 + 8

  // the query tiles that share a visible pair with this key tile (any
  // causal offset: a skipped tile's P is exactly 0)
  const int nqb = p.Sq / TC_BQ;
  int qb_lo = 0, qb_hi = nqb;
  if (p.causal) {
    qb_lo = nqb;
    qb_hi = 0;
    for (int qb = 0; qb < nqb; ++qb) {
      if (tile_visible(p, qb * TC_BQ, TC_BQ, k0, TC_BKV, off)) {
        qb_lo = min(qb_lo, qb);
        qb_hi = qb + 1;
      }
    }
  }
  const int nvis = max(qb_hi - qb_lo, 0);
  const int items = group * nvis;  // (query head, query tile) pairs

  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.ksb + kvh * p.ksh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.vsb + kvh * p.vsh;
  const TileSplit split = tile_split<TC_NT>(D);
  // item t's Q, dO, LSE and Delta into buffer buf
  auto stage = [&](int t, int buf) {
    const int h = kvh * group + t / nvis;
    const int q0 = (qb_lo + t % nvis) * TC_BQ;
    const bf16* qg = static_cast<const bf16*>(p.q) + b * p.qsb + h * p.qsh + q0 * p.qss;
    const bf16* gg = static_cast<const bf16*>(p.g) + b * p.gsb + h * p.gsh + q0 * p.gss;
    load_rows(Qs + buf * TC_BQ * LD, qg, p.qss, TC_BQ, LD, split);
    load_rows(Gs + buf * TC_BQ * LD, gg, p.gss, TC_BQ, LD, split);
    const long long row = ((long long)b * p.H + h) * p.Sq + q0;
    if (tid < TC_BQ / 4)
      cp_async16(lse_s + buf * TC_BQ + 4 * tid, p.lse + row + 4 * tid);
    else if (tid < TC_BQ / 2)
      cp_async16(del_s + buf * TC_BQ + 4 * (tid - TC_BQ / 4), p.delta + row + 4 * (tid - TC_BQ / 4));
  };

  zero_pad<TC_NT>(Ks, 2 * TC_BKV + 4 * TC_BQ, D, LD);
  load_rows(Ks, kg + (long long)k0 * p.kss, p.kss, TC_BKV, LD, split);
  load_rows(Vs, vg + (long long)k0 * p.vss, p.vss, TC_BKV, LD, split);
  if (items > 0) stage(0, 0);
  cp_async_commit();

  float dk[NND][4], dv[NND][4];
#pragma unroll
  for (int j = 0; j < NND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  uint32_t kf[KV_REGS ? NKD : 1][4], vf[KV_REGS ? NKD : 1][4];
  const bf16* kw = Ks + (16 * warp + a_row(lane)) * LD + a_col(lane);
  const bf16* vw = Vs + (16 * warp + a_row(lane)) * LD + a_col(lane);

  for (int t = 0; t < items; ++t) {
    const int buf = t & 1;
    if (t + 1 < items) {
      stage(t + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (KV_REGS && t == 0) {
#pragma unroll
      for (int kk = 0; kk < NKD; ++kk) {
        if (kk < nkd) {
          ldsm_x4(kf[KV_REGS ? kk : 0], kw + kk * 16);
          ldsm_x4(vf[KV_REGS ? kk : 0], vw + kk * 16);
        }
      }
    }
    const int q0 = (qb_lo + t % nvis) * TC_BQ;
    const bf16* Qb = Qs + buf * TC_BQ * LD;
    const bf16* Gb = Gs + buf * TC_BQ * LD;
    const float* lb = lse_s + buf * TC_BQ;
    const float* db = del_s + buf * TC_BQ;

#pragma unroll 1
    for (int qc0 = 0; qc0 < TC_BQ; qc0 += TC_QC) {
      if (!tile_visible(p, q0 + qc0, TC_QC, k0, TC_BKV, off)) continue;
      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x TC_QC queries
      float st[NNQ][4], dpt[NNQ][4];
#pragma unroll
      for (int j = 0; j < NNQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NKD; ++kk) {
        if (kk < nkd) {
          uint32_t ak[4], av[4];
          if (KV_REGS) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              ak[i] = kf[KV_REGS ? kk : 0][i];
              av[i] = vf[KV_REGS ? kk : 0][i];
            }
          } else {
            ldsm_x4(ak, kw + kk * 16);
            ldsm_x4(av, vw + kk * 16);
          }
#pragma unroll
          for (int np = 0; np < NNQ / 2; ++np) {
            const int r = (qc0 + np * 16 + bn_row(lane)) * LD + kk * 16 + bn_col(lane);
            uint32_t bq[4], bg[4];
            ldsm_x4(bq, Qb + r);
            mma(st[2 * np], ak, bq[0], bq[1]);
            mma(st[2 * np + 1], ak, bq[2], bq[3]);
            ldsm_x4(bg, Gb + r);
            mma(dpt[2 * np], av, bg[0], bg[1]);
            mma(dpt[2 * np + 1], av, bg[2], bg[3]);
          }
        }
      }

      // P^T = exp(scale S^T - LSE), exactly 0 where masked; dS^T = P^T o (dP^T - Delta)
      bool full = p.kmask == nullptr;
      if (p.causal) {
        full = full && k0 + TC_BKV - 1 <= q0 + qc0 + off;
        if (p.window > 0) full = full && k0 > q0 + qc0 + TC_QC - 1 + off - p.window;
      }
#pragma unroll
      for (int j = 0; j < NNQ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = qc0 + j * 8 + 2 * t4 + (e & 1);
          float pt = 0.f, ds = 0.f;
          if (full || keep(p, b, q0 + qi, key0 + (e >> 1) * 8, off)) {
            pt = exp2f((st[j][e] * p.scale - lb[qi]) * LOG2E);
            ds = pt * (dpt[j][e] - db[qi]);
          }
          st[j][e] = pt;
          dpt[j][e] = ds;
        }
      }

      // dV += P^T dO and dK += dS^T Q: P^T and dS^T rounded to bf16 as A
      // fragments, dO and Q through ldmatrix.trans
#pragma unroll
      for (int qc = 0; qc < TC_QC / 16; ++qc) {
        uint32_t ap[4], ads[4];
        c_to_a(ap, st[2 * qc], st[2 * qc + 1]);
        c_to_a(ads, dpt[2 * qc], dpt[2 * qc + 1]);
#pragma unroll
        for (int dp = 0; dp < NND / 2; ++dp) {
          if (dp < nkd) {
            const int r = (qc0 + qc * 16 + a_row(lane)) * LD + dp * 16 + a_col(lane);
            uint32_t bg[4], bq[4];
            ldsm_x4_t(bg, Gb + r);
            mma(dv[2 * dp], ap, bg[0], bg[1]);
            mma(dv[2 * dp + 1], ap, bg[2], bg[3]);
            ldsm_x4_t(bq, Qb + r);
            mma(dk[2 * dp], ads, bq[0], bq[1]);
            mma(dk[2 * dp + 1], ads, bq[2], bq[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  // a key tile below every query's window visits no tile: its K and V
  // copies must land before Ks and Vs are reused
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: dK * scale and dV, staged in this warp's rows of Ks and Vs,
  // written 16 bytes a store
  bf16* dks = Ks + 16 * warp * LD;
  bf16* dvs = Vs + 16 * warp * LD;
#pragma unroll
  for (int j = 0; j < NND; ++j) {
    if (j * 8 < D) {
      const int c = j * 8 + 2 * t4;
      *reinterpret_cast<__nv_bfloat162*>(dks + g * LD + c) =
          __floats2bfloat162_rn(dk[j][0] * p.scale, dk[j][1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dks + (g + 8) * LD + c) =
          __floats2bfloat162_rn(dk[j][2] * p.scale, dk[j][3] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvs + g * LD + c) =
          __floats2bfloat162_rn(dv[j][0], dv[j][1]);
      *reinterpret_cast<__nv_bfloat162*>(dvs + (g + 8) * LD + c) =
          __floats2bfloat162_rn(dv[j][2], dv[j][3]);
    }
  }
  __syncwarp();
  const long long base = (((long long)b * p.Sk + k0 + 16 * warp) * p.KV + kvh) * D;
  store_rows16(static_cast<bf16*>(p.dk) + base, (long long)p.KV * D, dks, D, LD, lane);
  store_rows16(static_cast<bf16*>(p.dv) + base, (long long)p.KV * D, dvs, D, LD, lane);
}

template <typename T, int DMAX>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  const size_t smem = dq_smem_floats(p.D) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DMAX>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(p.Sq / BQ, p.H, p.B);
  flash_bwd_dq_kernel<T, DMAX><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  const size_t smem = dkv_smem_floats(p.D) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<DMAX>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(p.Sk / BKV, p.KV, p.B);
  flash_bwd_dkv_kernel<DMAX><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_dkv_tc(const Params& p, cudaStream_t stream) {
  const size_t smem = dkv_tc_smem_bytes(p.D);
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_tc_kernel<DMAX>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(p.KV, p.B, p.Sk / TC_BKV);
  flash_bwd_dkv_tc_kernel<DMAX><<<grid, TC_NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dq(const Params& p, cudaStream_t s) {
  if (p.D <= 64) return launch_dq<T, 64>(p, s);
  if (p.D <= 128) return launch_dq<T, 128>(p, s);
  return launch_dq<T, 256>(p, s);
}

cudaError_t dispatch_dkv_f32(const Params& p, cudaStream_t s) {
  if (p.D <= 64) return launch_dkv<64>(p, s);
  if (p.D <= 128) return launch_dkv<128>(p, s);
  return launch_dkv<256>(p, s);
}

cudaError_t dispatch_dkv_tc(const Params& p, cudaStream_t s) {
  if (p.D <= 64) return launch_dkv_tc<64>(p, s);
  if (p.D <= 128) return launch_dkv_tc<128>(p, s);
  return launch_dkv_tc<256>(p, s);
}

bool aligned16(const void* ptr, long long s0, long long s1, long long s2) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && s0 % 8 == 0 && s1 % 8 == 0 &&
         s2 % 8 == 0;
}

int run(const Params& p, int dtype, bool dq, void* stream) {
  if (p.D < 8 || p.D > 256 || p.D % 8 || p.KV < 1 || p.H % p.KV || p.Sq % BQ ||
      p.Sq % BQ3 || p.Sq % TC_BQ || p.Sk % BK || p.Sk % BKV || p.Sk % TC_BKV || p.B < 1 ||
      p.Sq < 1 || p.Sk < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dq) return (int)(dtype == 0 ? dispatch_dq<float>(p, s) : dispatch_dq<__nv_bfloat16>(p, s));
  if (dtype == 0) return (int)dispatch_dkv_f32(p, s);
  // the bf16 K3 reads q, k, v, dO, LSE and Delta 16 bytes at a time
  if (!aligned16(p.q, p.qsb, p.qss, p.qsh) || !aligned16(p.k, p.ksb, p.kss, p.ksh) ||
      !aligned16(p.v, p.vsb, p.vss, p.vsh) || !aligned16(p.g, p.gsb, p.gss, p.gsh) ||
      !aligned16(p.lse, 0, 0, 0) || !aligned16(p.delta, 0, 0, 0))
    return (int)cudaErrorMisalignedAddress;
  return (int)dispatch_dkv_tc(p, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (K3 on the tensor cores: q, k, v, dO,
// LSE and Delta 16-byte aligned, strides multiples of 8). Strides are in
// elements, for q, k, v, O and dO in that order. mxtpu_flash_bwd_dq writes Delta (B*H, S_q) f32
// beside dQ; mxtpu_flash_bwd_dkv reads it (launch it after the dQ kernel
// on the same stream; O is not read). Each returns a cudaError_t: 0 when
// the launch was accepted.
extern "C" int mxtpu_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                  const void* g, const float* lse, float* delta,
                                  const float* kmask, void* dq, int dtype, int B, int H, int KV,
                                  int Sq, int Sk, int D, long long qsb, long long qss,
                                  long long qsh, long long ksb, long long kss, long long ksh,
                                  long long vsb, long long vss, long long vsh, long long osb,
                                  long long oss, long long osh, long long gsb, long long gss,
                                  long long gsh, float scale, int causal, int window,
                                  void* stream) {
  Params p{q,   k,   v,   o,   g,   lse, delta, kmask, dq,  nullptr, nullptr, B,   H,
           KV,  Sq,  Sk,  D,   qsb, qss, qsh,   ksb,   kss, ksh,     vsb,     vss, vsh,
           osb, oss, osh, gsb, gss, gsh, scale, causal, window};
  return run(p, dtype, true, stream);
}

extern "C" int mxtpu_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* o,
                                   const void* g, const float* lse, float* delta,
                                   const float* kmask, void* dk, void* dv, int dtype, int B,
                                   int H, int KV, int Sq, int Sk, int D, long long qsb,
                                   long long qss, long long qsh, long long ksb, long long kss,
                                   long long ksh, long long vsb, long long vss, long long vsh,
                                   long long osb, long long oss, long long osh, long long gsb,
                                   long long gss, long long gsh, float scale, int causal,
                                   int window, void* stream) {
  Params p{q,   k,   v,   o,   g,   lse, delta, kmask, nullptr, dk,  dv,  B,   H,
           KV,  Sq,  Sk,  D,   qsb, qss, qsh,   ksb,   kss,     ksh, vsb, vss, vsh,
           osb, oss, osh, gsb, gss, gsh, scale, causal, window};
  return run(p, dtype, false, stream);
}

// 1 when the dK/dV pass (K3) runs on the tensor cores for this dtype, 0
// when on the CUDA cores. The dQ pass (K2) runs on the CUDA cores for both.
extern "C" int mxtpu_flash_bwd_dkv_tc(int dtype) { return dtype == 1; }

// The tile sizes, for the wrapper's shape checks: S_q must be a multiple
// of block_q and S_k of block_k, the largest tiles of any of the kernels.
extern "C" int mxtpu_flash_bwd_block_q() { return TC_BQ; }
extern "C" int mxtpu_flash_bwd_block_k() { return TC_BKV; }
