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
// Semantics carried over from the TPU kernels:
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
// bytes of Q, K, V, O, dO and LSE read and dQ, dK, dV written. At BERT's
// training shape (B=64, S=128, H=12, D=64, bf16) that is 8.1 GFLOP
// against 101 MB: 8.1 us of tensor-core time against 30 us of memory
// time, so the bound is the bytes. This design runs on the CUDA cores and is
// compute-bound far above that.
//
// This first design is simple and right, not fast:
//   * K2: one block of 256 threads per (64-query tile, head, batch row):
//     Delta for its rows (one warp reduction a row), then a loop over the
//     32-key tiles of KV head h / (H / KV); the dQ accumulator stays in
//     registers (4 rows x D/16 columns a thread);
//   * K3: one block of 256 threads per (32-key tile, KV head, batch row),
//     looping over every query head of the group and every 32-query tile;
//     dK and dV stay in registers (2 rows x D/16 columns each a thread),
//     so even D=256 holds 64 accumulators a thread;
//   * every tile is staged in shared memory as f32 with rows padded by one
//     word (column reads free of bank conflicts); all four products run on
//     the CUDA cores in f32 FMAs.
// Not done yet: tensor cores (mma.sync / wgmma), TMA or cp.async loads
// overlapped with compute, and one fused pass for dQ, dK and dV.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
// query heads of the group.
template <typename T, int DMAX>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int DP = D + 1;
  float* Ks = smem;                 // BKV x DP
  float* Vs = Ks + BKV * DP;        // BKV x DP
  float* Qs = Vs + BKV * DP;        // BQ3 x DP
  float* Gs = Qs + BQ3 * DP;        // BQ3 x DP (dO)
  float* Ps = Gs + BQ3 * DP;        // BKV x PS3 (P^T, rounded)
  float* Ds = Ps + BKV * PS3;       // BKV x PS3 (dS^T, rounded)
  float* lse_s = Ds + BKV * PS3;    // BQ3
  float* del_s = lse_s + BQ3;       // BQ3

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * BKV;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int group = p.H / p.KV;
  const int off = p.Sk - p.Sq;

  const T* kg = static_cast<const T*>(p.k) + b * p.ksb + kvh * p.ksh;
  const T* vg = static_cast<const T*>(p.v) + b * p.vsb + kvh * p.vsh;
  load_tile<T>(Ks, kg, p.kss, k0, BKV, D, DP);
  load_tile<T>(Vs, vg, p.vss, k0, BKV, D, DP);

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
    const T* qg = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
    const T* gg = static_cast<const T*>(p.g) + b * p.gsb + h * p.gsh;
    const long long row0 = ((long long)b * p.H + h) * p.Sq;
    for (int qb = 0; qb < nqb; ++qb) {
      const int q0 = qb * BQ3;
      if (!tile_visible(p, q0, BQ3, k0, BKV, off)) continue;
      __syncthreads();  // K/V loaded; the previous tile's readers are done
      load_tile<T>(Qs, qg, p.qss, q0, BQ3, D, DP);
      load_tile<T>(Gs, gg, p.gss, q0, BQ3, D, DP);
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
          Ps[r * PS3 + c] = round_op<T>(pr);
          Ds[r * PS3 + c] = round_op<T>(ds);
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
  T* dkg = static_cast<T*>(p.dk) + base;
  T* dvg = static_cast<T*>(p.dv) + base;
#pragma unroll
  for (int i = 0; i < KR; ++i) {
    const long long r = (long long)(k0 + ty + 16 * i) * p.KV * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        dkg[r + d] = from_f32<T>(dk[i][j] * p.scale);
        dvg[r + d] = from_f32<T>(dv[i][j]);
      }
    }
  }
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

template <typename T, int DMAX>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  const size_t smem = dkv_smem_floats(p.D) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, DMAX>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(p.Sk / BKV, p.KV, p.B);
  flash_bwd_dkv_kernel<T, DMAX><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, bool dq, cudaStream_t s) {
  if (p.D <= 64) return dq ? launch_dq<T, 64>(p, s) : launch_dkv<T, 64>(p, s);
  if (p.D <= 128) return dq ? launch_dq<T, 128>(p, s) : launch_dkv<T, 128>(p, s);
  return dq ? launch_dq<T, 256>(p, s) : launch_dkv<T, 256>(p, s);
}

int run(const Params& p, int dtype, bool dq, void* stream) {
  if (p.D < 8 || p.D > 256 || p.D % 8 || p.KV < 1 || p.H % p.KV || p.Sq % BQ ||
      p.Sq % BQ3 || p.Sk % BK || p.Sk % BKV || p.B < 1 || p.Sq < 1 || p.Sk < 1 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0 ? dispatch<float>(p, dq, s) : dispatch<__nv_bfloat16>(p, dq, s);
  return (int)e;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, for q, k, v,
// O and dO in that order. mxtpu_flash_bwd_dq writes Delta (B*H, S_q) f32
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

// The tile sizes, for the wrapper's shape checks: S_q must be a multiple
// of the query tile and S_k of the key tile.
extern "C" int mxtpu_flash_bwd_block_q() { return BQ; }
extern "C" int mxtpu_flash_bwd_block_k() { return BK; }
