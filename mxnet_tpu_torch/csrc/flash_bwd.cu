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
// bf16: both kernels run on the tensor cores, in the style of
// FlashAttention-2, with mma.sync m16n8k16 (bf16 in, f32 accumulate), tiles
// in shared memory as bf16 by 16-byte cp.async, and operand fragments by
// ldmatrix (csrc/flash_tc.cuh):
//   * K2 (flash_bwd_dq_tc_kernel): one block of 4 warps per (64-query tile,
//     head, batch row), each warp owning 16 query rows. The Q and dO tiles
//     are loaded once; Delta = rowsum(dO o O) is formed from the dO tile
//     and O read 16 bytes at a time, the four lanes of a row splitting it.
//     Q and dO are A fragments held in registers at D <= 64 and read from
//     shared memory by ldmatrix above it. The visible 64-key tiles of KV
//     head h / (H / KV) are double-buffered (the next tile's copy in flight
//     while the current one is computed); S = Q K^T and dP = dO V^T run 64
//     keys a pass (32 where that would spill), with K and V as B operands
//     of the row-major tiles; P and dS are formed on the accumulator
//     fragments and dS is packed straight into bf16 A fragments for
//     dQ += dS K, whose B operand is K through ldmatrix.trans. The 16 x D
//     f32 dQ accumulator of a warp is scaled, rounded and staged in the
//     warp's own shared rows, then written 16 bytes a store. K2 does three
//     products (S, dP, dS K); at BERT's training shape it moves Q, O, dO,
//     K, V and LSE in and dQ and Delta out, 76 MB, 23 us, against 4.8
//     GFLOP, 4.9 us of tensor-core time: the bound is the bytes.
//   * K3 (flash_bwd_dkv_tc_kernel): one block of 4 warps per (64-key tile,
//     KV head, batch row), each warp owning 16 key rows; a loop over the
//     query heads of the group and the visible 64-query tiles, whose Q, dO,
//     LSE and Delta are double-buffered. S^T = K Q^T and dP^T = V dO^T run
//     32 queries a pass; K and V are A fragments held in registers at
//     D <= 64 and read from shared memory above it, where the dK and dV
//     accumulators (two 16 x D f32 tiles a warp) leave no room. P^T and
//     dS^T go straight into bf16 A fragments for dV += P^T dO and
//     dK += dS^T Q, whose B operands come from the Q and dO tiles through
//     ldmatrix.trans.
// Head dims that are not a multiple of 16 are zero-padded in shared memory;
// the padding columns are never written out. What this removes, against
// the CUDA-core design: f32 FMAs for bf16 inputs, the f32 staging of bf16
// tiles by one element a thread, one scalar shared-memory load per FMA, the
// round trip of P and dS through shared memory, and the synchronous K/V
// loads with a barrier on each side.
//
// f32 keeps the first, CUDA-core design (f32 FMAs): the tensor cores take
// f32 only as TF32, which the kernel contract forbids.
//   * K2: one block of 256 threads per (64-query tile, head, batch row):
//     Delta for its rows (one warp reduction a row), then a loop over the
//     32-key tiles of KV head h / (H / KV); the dQ accumulator stays in
//     registers (4 rows x D/16 columns a thread);
//   * K3: one block of 256 threads per (32-key tile, KV head, batch row),
//     looping over every query head of the group and every 32-query tile;
//     dK and dV stay in registers;
//   * every tile is staged in shared memory as f32 with rows padded by one
//     word (column reads free of bank conflicts).
// Not done yet: wgmma with TMA loads and warp specialisation for whichever
// kernel stays below half its bound, and one fused pass for dQ, dK and dV.

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

__device__ __forceinline__ void load_tile(float* dst, const float* src, long long row_stride,
                                          int row0, int rows, int D, int DP) {
  for (int i = threadIdx.x; i < rows * D; i += NT) {
    const int r = i / D, d = i - r * D;
    dst[r * DP + d] = src[(long long)(row0 + r) * row_stride + d];
  }
}

__host__ __device__ constexpr size_t dq_smem_floats(int D) {
  return 2 * (size_t)BQ * (D + 1) + 2 * (size_t)BK * (D + 1) + (size_t)BQ * PS + 2 * BQ;
}

__host__ __device__ constexpr size_t dkv_smem_floats(int D) {
  return 2 * (size_t)BKV * (D + 1) + 2 * (size_t)BQ3 * (D + 1) + 2 * (size_t)BKV * PS3 +
         2 * BQ3;
}

// K2: Delta and dQ for one (query tile, head, batch row). The f32 route:
// f32 FMAs on the CUDA cores.
template <int DMAX>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int DP = D + 1;
  float* Qs = smem;                // BQ x DP
  float* Gs = Qs + BQ * DP;        // BQ x DP (dO)
  float* Ks = Gs + BQ * DP;        // BK x DP
  float* Vs = Ks + BK * DP;        // BK x DP
  float* Ss = Vs + BK * DP;        // BQ x PS (dS)
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

  const float* qg = static_cast<const float*>(p.q) + b * p.qsb + h * p.qsh;
  const float* og = static_cast<const float*>(p.o) + b * p.osb + h * p.osh;
  const float* gg = static_cast<const float*>(p.g) + b * p.gsb + h * p.gsh;
  const float* kg = static_cast<const float*>(p.k) + b * p.ksb + kvh * p.ksh;
  const float* vg = static_cast<const float*>(p.v) + b * p.vsb + kvh * p.vsh;

  load_tile(Qs, qg, p.qss, q0, BQ, D, DP);
  load_tile(Gs, gg, p.gss, q0, BQ, D, DP);
  if (tid < BQ) lse_s[tid] = p.lse[row0 + tid];
  __syncthreads();

  // Delta = rowsum(dO o O) in f32: each warp owns BQ/8 rows, lanes split D
  for (int rr = 0; rr < BQ / 8; ++rr) {
    const int r = warp * (BQ / 8) + rr;
    float sum = 0.f;
    for (int d = lane; d < D; d += 32)
      sum = fmaf(Gs[r * DP + d], og[(long long)(q0 + r) * p.oss + d], sum);
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
    load_tile(Ks, kg, p.kss, k0, BK, D, DP);
    load_tile(Vs, vg, p.vss, k0, BK, D, DP);
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
        Ss[r * PS + c] = ds;
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

  float* dqg = static_cast<float*>(p.dq) + ((long long)b * p.Sq * p.H + h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) dqg[(long long)(q0 + r) * p.H * D + d] = acc[i][j] * p.scale;
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
  load_tile(Ks, kg, p.kss, k0, BKV, D, DP);
  load_tile(Vs, vg, p.vss, k0, BKV, D, DP);

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
      load_tile(Qs, qg, p.qss, q0, BQ3, D, DP);
      load_tile(Gs, gg, p.gss, q0, BQ3, D, DP);
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

// ---- K2 and K3 in bf16 on the tensor cores -----------------------------------

constexpr int TC_NT = 128;   // threads per block: 4 warps
constexpr int TC_BKV = 64;   // keys per block (K3, 16 per warp) and per tile (K2)
constexpr int TC_BQ = 64;    // queries per block (K2, 16 per warp) and per tile (K3)
constexpr int TC_QC = 32;    // K3: queries per pass over a tile (bounds S^T, dP^T registers)
constexpr float LOG2E = 1.4426950408889634f;

using flash_tc::bf16;

__host__ __device__ constexpr size_t dq_tc_smem_bytes(int D) {
  return (size_t)(2 * TC_BQ + 4 * TC_BKV) * flash_tc::row_ld(D) * sizeof(bf16);
}

// K2 for bf16: Delta and dQ for one (64-query tile, head, batch row), over
// the visible 64-key tiles of KV head h / (H / KV). Q and dO stay in
// registers as A fragments for DMAX <= 64, and are read from shared memory
// per product above that (the dQ accumulator takes DMAX / 2 registers).
template <int DMAX>
__global__ void __launch_bounds__(TC_NT) flash_bwd_dq_tc_kernel(Params p) {
  using namespace flash_tc;
  constexpr bool QG_REGS = DMAX <= 64;
  constexpr int NKD = DMAX / 16;                // 16-deep chunks of the head dim
  constexpr int NND = DMAX / 8;                 // 8-wide column tiles of dQ
  // keys a pass: 64 where the S and dP fragments (KC / 2 registers each)
  // fit beside Q, dO and the dQ accumulator without a spill, 32 elsewhere
  constexpr int KC = (DMAX <= 128 && !QG_REGS) ? 64 : 32;
  constexpr int NNK = KC / 8;                   // 8-wide key tiles of S, dP
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = p.D, DP = dpad(D), LD = row_ld(D);
  const int nkd = DP / 16;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // TC_BQ x LD
  bf16* Gs = Qs + TC_BQ * LD;                    // TC_BQ x LD (dO)
  bf16* Ks = Gs + TC_BQ * LD;                    // 2 x TC_BKV x LD
  bf16* Vs = Ks + 2 * TC_BKV * LD;               // 2 x TC_BKV x LD

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * TC_BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int off = p.Sk - p.Sq;
  const int w0 = q0 + 16 * warp;  // this warp's queries: w0 .. w0 + 15
  const int row0 = w0 + g;        // this lane's: row0, row0 + 8

  // the key tiles that share a visible pair with this query tile (any
  // causal offset: a skipped tile's P is exactly 0)
  const int nkb = p.Sk / TC_BKV;
  int kb_lo = 0, kb_hi = nkb;
  if (p.causal) {
    kb_lo = nkb;
    kb_hi = 0;
    for (int kb = 0; kb < nkb; ++kb) {
      if (tile_visible(p, q0, TC_BQ, kb * TC_BKV, TC_BKV, off)) {
        kb_lo = min(kb_lo, kb);
        kb_hi = kb + 1;
      }
    }
  }
  const int nvis = max(kb_hi - kb_lo, 0);

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.qsb + h * p.qsh + q0 * p.qss;
  const bf16* gg = static_cast<const bf16*>(p.g) + b * p.gsb + h * p.gsh + q0 * p.gss;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.ksb + kvh * p.ksh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.vsb + kvh * p.vsh;
  const TileSplit split = tile_split<TC_NT>(D);
  // visible key tile t's K and V into buffer buf
  auto stage = [&](int t, int buf) {
    const long long k0 = (long long)(kb_lo + t) * TC_BKV;
    load_rows(Ks + buf * TC_BKV * LD, kg + k0 * p.kss, p.kss, TC_BKV, LD, split);
    load_rows(Vs + buf * TC_BKV * LD, vg + k0 * p.vss, p.vss, TC_BKV, LD, split);
  };

  zero_pad<TC_NT>(Qs, 2 * TC_BQ + 4 * TC_BKV, D, LD);
  load_rows(Qs, qg, p.qss, TC_BQ, LD, split);
  load_rows(Gs, gg, p.gss, TC_BQ, LD, split);
  cp_async_commit();
  if (nvis > 0) stage(0, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q and dO are in; the first K, V tile may still be in flight
  __syncthreads();

  // Delta = rowsum(dO o O) in f32 for rows row0 and row0 + 8, the four
  // lanes of a row splitting its 16-byte chunks; and this lane's LSE, in
  // base 2 like the exponent
  float del[2], lse2[2];
  {
    const bf16* og = static_cast<const bf16*>(p.o) + b * p.osb + h * p.osh;
    const long long lrow = ((long long)b * p.H + h) * p.Sq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qr = row0 + 8 * r;
      const bf16* orow = og + (long long)qr * p.oss;
      const bf16* grow = Gs + (qr - q0) * LD;
      float sum = 0.f;
      for (int c = t4; c < D / 8; c += 4) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c * 8);
        const uint4 gv = *reinterpret_cast<const uint4*>(grow + c * 8);
        const bf16* o8 = reinterpret_cast<const bf16*>(&ov);
        const bf16* g8 = reinterpret_cast<const bf16*>(&gv);
#pragma unroll
        for (int i = 0; i < 8; ++i) sum = fmaf(__bfloat162float(g8[i]), __bfloat162float(o8[i]), sum);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      del[r] = sum;
      if (t4 == 0) p.delta[lrow + qr] = sum;
      lse2[r] = p.lse[lrow + qr] * LOG2E;
    }
  }
  const float scale2 = p.scale * LOG2E;

  uint32_t qf[QG_REGS ? NKD : 1][4], gf[QG_REGS ? NKD : 1][4];
  const bf16* qw = Qs + (16 * warp + a_row(lane)) * LD + a_col(lane);
  const bf16* gw = Gs + (16 * warp + a_row(lane)) * LD + a_col(lane);
  if (QG_REGS) {
#pragma unroll
    for (int kk = 0; kk < NKD; ++kk) {
      if (kk < nkd) {
        ldsm_x4(qf[QG_REGS ? kk : 0], qw + kk * 16);
        ldsm_x4(gf[QG_REGS ? kk : 0], gw + kk * 16);
      }
    }
  }

  float dq[NND][4];
#pragma unroll
  for (int j = 0; j < NND; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int t = 0; t < nvis; ++t) {
    const int buf = t & 1;
    if (t + 1 < nvis) {
      stage(t + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = (kb_lo + t) * TC_BKV;
    const bf16* Kb = Ks + buf * TC_BKV * LD;
    const bf16* Vb = Vs + buf * TC_BKV * LD;

#pragma unroll 1
    for (int kc0 = 0; kc0 < TC_BKV; kc0 += KC) {
      if (!tile_visible(p, w0, 16, k0 + kc0, KC, off)) continue;  // uniform over the warp
      // S = Q K^T and dP = dO V^T: this warp's 16 queries x KC keys
      float s[NNK][4], dpv[NNK][4];
#pragma unroll
      for (int j = 0; j < NNK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dpv[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NKD; ++kk) {
        if (kk < nkd) {
          uint32_t aq[4], ag[4];
          if (QG_REGS) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              aq[i] = qf[QG_REGS ? kk : 0][i];
              ag[i] = gf[QG_REGS ? kk : 0][i];
            }
          } else {
            ldsm_x4(aq, qw + kk * 16);
            ldsm_x4(ag, gw + kk * 16);
          }
#pragma unroll
          for (int np = 0; np < NNK / 2; ++np) {
            const int r = (kc0 + np * 16 + bn_row(lane)) * LD + kk * 16 + bn_col(lane);
            uint32_t bk[4], bv[4];
            ldsm_x4(bk, Kb + r);
            mma(s[2 * np], aq, bk[0], bk[1]);
            mma(s[2 * np + 1], aq, bk[2], bk[3]);
            ldsm_x4(bv, Vb + r);
            mma(dpv[2 * np], ag, bv[0], bv[1]);
            mma(dpv[2 * np + 1], ag, bv[2], bv[3]);
          }
        }
      }

      // P = exp(scale S - LSE), exactly 0 where masked; dS = P o (dP - Delta),
      // left in s
      bool full = p.kmask == nullptr;
      if (p.causal) {
        full = full && k0 + kc0 + KC - 1 <= w0 + off;
        if (p.window > 0) full = full && k0 + kc0 > w0 + 15 + off - p.window;
      }
#pragma unroll
      for (int j = 0; j < NNK; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float ds = 0.f;
          if (full || keep(p, b, row0 + 8 * r, k0 + kc0 + j * 8 + 2 * t4 + (e & 1), off)) {
            const float pr = exp2f(fmaf(s[j][e], scale2, -lse2[r]));
            ds = pr * (dpv[j][e] - del[r]);
          }
          s[j][e] = ds;
        }
      }

      // dQ += dS K: dS rounded to bf16 as A fragments, K through ldmatrix.trans
#pragma unroll
      for (int kc = 0; kc < KC / 16; ++kc) {
        uint32_t ads[4];
        c_to_a(ads, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
        for (int dp = 0; dp < NND / 2; ++dp) {
          if (dp < nkd) {
            uint32_t bk[4];
            ldsm_x4_t(bk, Kb + (kc0 + kc * 16 + a_row(lane)) * LD + dp * 16 + a_col(lane));
            mma(dq[2 * dp], ads, bk[0], bk[1]);
            mma(dq[2 * dp + 1], ads, bk[2], bk[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  cp_async_wait<0>();  // a query tile that sees no key tile committed an empty group

  // epilogue: dQ * scale, staged in this warp's rows of Qs (only this warp
  // reads them), written 16 bytes a store
  bf16* dqs = Qs + 16 * warp * LD;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < NND; ++j) {
    if (j * 8 < D) {
      const int c = j * 8 + 2 * t4;
      *reinterpret_cast<__nv_bfloat162*>(dqs + g * LD + c) =
          __floats2bfloat162_rn(dq[j][0] * p.scale, dq[j][1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dqs + (g + 8) * LD + c) =
          __floats2bfloat162_rn(dq[j][2] * p.scale, dq[j][3] * p.scale);
    }
  }
  __syncwarp();
  const long long base = (((long long)b * p.Sq + w0) * p.H + h) * D;
  store_rows16(static_cast<bf16*>(p.dq) + base, (long long)p.H * D, dqs, D, LD, lane);
}

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

template <int DMAX>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  const size_t smem = dq_smem_floats(p.D) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<DMAX>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(p.Sq / BQ, p.H, p.B);
  flash_bwd_dq_kernel<DMAX><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_dq_tc(const Params& p, cudaStream_t stream) {
  const size_t smem = dq_tc_smem_bytes(p.D);
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<DMAX>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(p.Sq / TC_BQ, p.H, p.B);
  flash_bwd_dq_tc_kernel<DMAX><<<grid, TC_NT, smem, stream>>>(p);
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

cudaError_t dispatch_dq_f32(const Params& p, cudaStream_t s) {
  if (p.D <= 64) return launch_dq<64>(p, s);
  if (p.D <= 128) return launch_dq<128>(p, s);
  return launch_dq<256>(p, s);
}

cudaError_t dispatch_dq_tc(const Params& p, cudaStream_t s) {
  if (p.D <= 64) return launch_dq_tc<64>(p, s);
  if (p.D <= 128) return launch_dq_tc<128>(p, s);
  return launch_dq_tc<256>(p, s);
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
  if (dtype == 0) return (int)(dq ? dispatch_dq_f32(p, s) : dispatch_dkv_f32(p, s));
  // the bf16 kernels read q, k, v, dO (and K2 O) 16 bytes at a time, and
  // K3 LSE and Delta
  if (!aligned16(p.q, p.qsb, p.qss, p.qsh) || !aligned16(p.k, p.ksb, p.kss, p.ksh) ||
      !aligned16(p.v, p.vsb, p.vss, p.vsh) || !aligned16(p.g, p.gsb, p.gss, p.gsh) ||
      !aligned16(p.lse, 0, 0, 0) || !aligned16(p.delta, 0, 0, 0) ||
      (dq && !aligned16(p.o, p.osb, p.oss, p.osh)))
    return (int)cudaErrorMisalignedAddress;
  return (int)(dq ? dispatch_dq_tc(p, s) : dispatch_dkv_tc(p, s));
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores: q, k, v, dO,
// LSE and Delta, and for the dQ kernel O, 16-byte aligned, strides multiples
// of 8). Strides are in elements, for q, k, v, O and dO in that order.
// mxtpu_flash_bwd_dq writes Delta (B*H, S_q) f32 beside dQ;
// mxtpu_flash_bwd_dkv reads it (launch it after the dQ kernel on the same
// stream; O is not read). Each returns a cudaError_t: 0 when the launch was
// accepted.
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

// 1 when the dQ pass (K2) or the dK/dV pass (K3) runs on the tensor cores
// for this dtype, 0 when on the CUDA cores.
extern "C" int mxtpu_flash_bwd_dq_tc(int dtype) { return dtype == 1; }
extern "C" int mxtpu_flash_bwd_dkv_tc(int dtype) { return dtype == 1; }

// The tile sizes, for the wrapper's shape checks: S_q must be a multiple
// of block_q and S_k of block_k, the largest tiles of any of the kernels.
extern "C" int mxtpu_flash_bwd_block_q() { return TC_BQ; }
extern "C" int mxtpu_flash_bwd_block_k() { return TC_BKV; }
