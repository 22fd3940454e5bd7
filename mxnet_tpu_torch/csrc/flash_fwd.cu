// Flash-attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel `_fwd_kernel` of mxnet_tpu/ops/flash_attention.py
// (launched by `_flash_fwd_pallas` through pl.pallas_call). It computes
//   O = softmax(scale * Q K^T + mask) V
// with an online softmax (running max m, running sum l, f32 accumulator),
// and optionally LSE = m + log(l) per query row, for the backward pass.
// Semantics carried over from the TPU kernel:
//   * end-aligned causal masking: query i sees keys <= i + (S_k - S_q);
//   * an optional sliding window: query i sees keys in (i+off-W, i+off];
//   * an optional key-padding mask (B, S_k), kept where > 0;
//   * masked scores are -1e30, not -inf, so a row that sees no key comes
//     out as the uniform average of V, not NaN;
//   * key tiles wholly outside the causal band (and below the window's
//     lower edge) are skipped, only when S_k >= S_q as on the TPU;
//   * f32 inputs use f32 FMAs (never TF32); bf16 inputs accumulate in f32
//     and round P to bf16 before P.V.
//
// Layout: q (B, S_q, H, D), k and v (B, S_k, KV, D), read through their
// strides (the last dimension contiguous), with no fold or transpose.
// Grouped-query attention reads KV head h / (H / KV) directly. The output
// is a contiguous (B, S_q, H, D) tensor in the input type; LSE is
// (B*H, S_q) float32.
//
// Bound on the H100 SXM (989 TFLOP/s bf16 dense, 67 TFLOP/s f32 without
// tensor cores, 3.35 TB/s): 4*B*H*S_q*S_k*D operations (about half of
// that when causal) against the bytes of Q, K, V and O. At the serving
// prefill's shapes (H=32, KV=8, D=128, S=512, causal, bf16) that is
// 2.2 GFLOP against 10.5 MB: 2.2 us of tensor-core time versus 3.1 us of
// memory time, so the bound is the bytes: about 3 us. This design runs
// on the CUDA cores and is compute-bound far above that (see below).
//
// This first design is simple and right, not fast:
//   * one block of 256 threads per (64-query tile, head, batch row);
//     a loop over 32-key tiles inside the block takes the place of the
//     TPU grid's sequential key axis;
//   * the Q tile and each K and V tile are staged in shared memory as f32
//     (rows padded by one word so column reads are free of bank
//     conflicts); m, l and the output accumulator stay in f32, the
//     accumulator in registers;
//   * both products run on the CUDA cores in f32 FMAs.
// Not done yet: tensor cores (mma.sync / wgmma), TMA or cp.async loads
// overlapped with compute, and a persistent schedule. Those are what
// close the gap to the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 32;   // keys per tile (one per lane in the row pass)
constexpr int NT = 256;  // threads per block: 8 warps
constexpr int PS = BK + 1;  // padded row stride of the score tile
constexpr float NEG = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;          // nullable
  const float* kmask;  // nullable, (B, S_k) contiguous
  int B, H, KV, Sq, Sk, D;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
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

// P enters P.V in the value type: rounded to bf16 for bf16 inputs.
template <typename T>
__device__ __forceinline__ float round_p(float p) {
  return to_f32<T>(from_f32<T>(p));
}

__host__ __device__ constexpr size_t smem_floats(int D) {
  return (size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D +
         (size_t)BQ * PS + 3 * BQ;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int DP = D + 1;
  float* Qs = smem;               // BQ x DP
  float* Ks = Qs + BQ * DP;       // BK x DP
  float* Vs = Ks + BK * DP;       // BK x D
  float* Ps = Vs + BK * D;        // BQ x PS
  float* m_s = Ps + BQ * PS;      // BQ
  float* l_s = m_s + BQ;          // BQ
  float* a_s = l_s + BQ;          // BQ

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int off = p.Sk - p.Sq;

  const T* qg = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
  const T* kg = static_cast<const T*>(p.k) + b * p.ksb + kvh * p.ksh;
  const T* vg = static_cast<const T*>(p.v) + b * p.vsb + kvh * p.vsh;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i - r * D;
    Qs[r * DP + d] = to_f32<T>(qg[(long long)(q0 + r) * p.qss + d]);
  }
  if (tid < BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  // thread owns output rows ty + 16*i and head-dim columns tx + 16*j
  constexpr int NJ = DMAX / 16;
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int nkb = p.Sk / BK;
  const bool skip = p.causal && off >= 0;
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BK;
    if (skip) {
      // same test as the TPU kernel: the tile's first key is past the
      // tile's last query's band, or its last key is below the first
      // query's window floor. Uniform over the block.
      bool visible = q0 + BQ - 1 + off >= k0;
      if (p.window > 0) visible = visible && (k0 + BK - 1 > q0 + off - p.window);
      if (!visible) continue;
    }
    __syncthreads();  // the previous tile's readers of Ks/Vs/Ps are done
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, d = i - r * D;
      Ks[r * DP + d] = to_f32<T>(kg[(long long)(k0 + r) * p.kss + d]);
      Vs[i] = to_f32<T>(vg[(long long)(k0 + r) * p.vss + d]);
    }
    __syncthreads();

    // scores: rows ty + 16*i, keys tx + 16*j
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int qp = q0 + r, kp = k0 + c;
        bool keep = true;
        if (p.causal) {
          keep = qp + off >= kp;
          if (p.window > 0) keep = keep && (kp > qp + off - p.window);
        }
        if (p.kmask) keep = keep && (p.kmask[(long long)b * p.Sk + kp] > 0.f);
        Ps[r * PS + c] = keep ? s[i][j] * p.scale : NEG;
      }
    }
    __syncthreads();

    // online softmax: each warp owns 8 rows, one key per lane
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      const float x = Ps[r * PS + lane];
      float mx = x;
#pragma unroll
      for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float pv = expf(x - m_new);
      float sum = pv;
#pragma unroll
      for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      Ps[r * PS + lane] = round_p<T>(pv);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        m_s[r] = m_new;
        l_s[r] = alpha * l_s[r] + sum;
      }
    }
    __syncthreads();

    // acc = alpha * acc + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    for (int c = 0; c < BK; ++c) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = Ps[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          const float vv = Vs[c * D + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pr[i], vv, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();

  T* og = static_cast<T*>(p.o) + ((long long)b * p.Sq * p.H + h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const float l = l_s[r];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) og[(long long)(q0 + r) * p.H * D + d] = from_f32<T>(acc[i][j] / l);
    }
  }
  if (p.lse != nullptr && tid < BQ)
    p.lse[((long long)b * p.H + h) * p.Sq + q0 + tid] = m_s[tid] + logf(l_s[tid]);
}

template <typename T, int DMAX>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_floats(p.D) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(p.Sq / BQ, p.H, p.B);
  flash_fwd_kernel<T, DMAX><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& p, cudaStream_t stream) {
  if (p.D <= 64) return launch<T, 64>(p, stream);
  if (p.D <= 128) return launch<T, 128>(p, stream);
  return launch<T, 256>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns a
// cudaError_t: 0 when the launch was accepted.
extern "C" int mxtpu_flash_fwd(const void* q, const void* k, const void* v, void* o,
                               float* lse, const float* kmask, int dtype, int B, int H,
                               int KV, int Sq, int Sk, int D, long long qsb,
                               long long qss, long long qsh, long long ksb, long long kss,
                               long long ksh, long long vsb, long long vss, long long vsh,
                               float scale, int causal, int window, void* stream) {
  if (D < 8 || D > 256 || D % 8 || KV < 1 || H % KV || Sq % BQ || Sk % BK || B < 1 ||
      Sq < 1 || Sk < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p{q,   k,   v,   o,   lse, kmask, B,     H,      KV,     Sq, Sk, D, qsb,
           qss, qsh, ksb, kss, ksh, vsb,   vss,   vsh,    scale,  causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0 ? dispatch_d<float>(p, s) : dispatch_d<__nv_bfloat16>(p, s);
  return (int)e;
}

// The block tile sizes, for the wrapper's shape checks.
extern "C" int mxtpu_flash_fwd_block_q() { return BQ; }
extern "C" int mxtpu_flash_fwd_block_k() { return BK; }
