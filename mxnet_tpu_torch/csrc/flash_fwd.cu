// Flash-attention forward (K1) for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel `_fwd_kernel` of mxnet_tpu/ops/flash_attention.py
// (launched by `_flash_fwd_pallas` through pl.pallas_call). It computes
//   O = softmax(scale * Q K^T + mask) V
// with an online softmax (running max m, running sum l, f32 accumulator),
// and optionally LSE = m + log(l) per query row, for the backward pass.
// Semantics carried over from the TPU kernel, by both routes below:
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
// that when causal) against the bytes of Q, K, V and O. At both shapes of
// the main path the bound is the bytes: BERT's training forward (B=64,
// S=128, H=12, D=64, bf16, with LSE) moves 50 MB, 15 us, against 3.2
// GFLOP, 3.3 us of tensor-core time; the serving prefill (S=512, H=32,
// KV=8, D=128, causal) 10.5 MB, 3.1 us, against 2.2 GFLOP, 2.2 us.
//
// Two routes, picked by the input type:
//
// bf16: tensor cores (flash_fwd_tc_kernel), in the style of
// FlashAttention-2. One block of 4 warps per (64-query tile, head, batch
// row); each warp owns 16 query rows. The Q tile is loaded once into
// mma A fragments (ldmatrix) and stays in registers (D <= 128). K and V
// tiles of 64 keys come into shared memory as bf16 by 16-byte cp.async,
// double-buffered: the next tile's copy is in flight while the current
// one is computed. S = Q K^T and O += P V run as mma.sync m16n8k16 (bf16
// in, f32 accumulate); the scale, the masks and the online softmax work
// on the accumulator fragments in registers (row max and sum over the
// four lanes of a row by shuffles), and P goes from the S fragments
// straight into bf16 A fragments, which is the rounding of the plain
// version; V comes through ldmatrix.trans. Head dims that are not a
// multiple of 16 are zero-padded in shared memory, and the padding
// columns are never written out. The output is staged through shared
// memory and written in 16-byte stores. Causal query tiles launch
// heaviest first. What this removes, against the CUDA-core design: the
// f32 staging of bf16 tiles (twice the shared memory, scalar 2-byte loads),
// the scalar shared-memory loads that paced the FMAs (6 loads per 8 FMAs),
// and the round trip of P through shared memory with its barriers.
//
// f32: CUDA cores (flash_fwd_kernel), the first design, unchanged. The
// tensor cores take f32 only as TF32, which the kernel contract forbids
// (f32 inputs get true f32 math), so f32 keeps f32 FMAs: one block of 256
// threads per (64-query tile, head, batch row), 32-key tiles staged in
// shared memory as f32 (rows padded by one word), both products as FMAs,
// m, l and the accumulator in f32.
//
// Not done yet: wgmma (the only path to the full bf16 tensor-core rate;
// mma.sync reaches a fraction of it), TMA loads with mbarriers in place
// of cp.async, warp specialisation (a producer warp feeding consumer
// warpgroups), and a persistent schedule over the tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tc.cuh"

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

__host__ __device__ constexpr size_t smem_floats(int D) {
  return (size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D +
         (size_t)BQ * PS + 3 * BQ;
}

// The f32 route: f32 FMAs on the CUDA cores.
template <int DMAX>
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

  const float* qg = static_cast<const float*>(p.q) + b * p.qsb + h * p.qsh;
  const float* kg = static_cast<const float*>(p.k) + b * p.ksb + kvh * p.ksh;
  const float* vg = static_cast<const float*>(p.v) + b * p.vsb + kvh * p.vsh;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i - r * D;
    Qs[r * DP + d] = qg[(long long)(q0 + r) * p.qss + d];
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
      Ks[r * DP + d] = kg[(long long)(k0 + r) * p.kss + d];
      Vs[i] = vg[(long long)(k0 + r) * p.vss + d];
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
      Ps[r * PS + lane] = pv;
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

  float* og = static_cast<float*>(p.o) + ((long long)b * p.Sq * p.H + h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const float l = l_s[r];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) og[(long long)(q0 + r) * p.H * D + d] = acc[i][j] / l;
    }
  }
  if (p.lse != nullptr && tid < BQ)
    p.lse[((long long)b * p.H + h) * p.Sq + q0 + tid] = m_s[tid] + logf(l_s[tid]);
}

// ---- bf16 on the tensor cores ----------------------------------------------

constexpr int TC_BQ = 64;   // query rows per block: 16 per warp
constexpr int TC_NT = 128;  // threads per block: 4 warps
constexpr int TC_BK = 64;   // keys per tile (64 beat 128 on the H100 at both headline shapes)
constexpr float LOG2E = 1.4426950408889634f;

using flash_tc::bf16;

__host__ __device__ constexpr size_t tc_smem_bytes(int D) {
  return (size_t)(TC_BQ + 4 * TC_BK) * flash_tc::row_ld(D) * sizeof(bf16);
}

// One (64-query tile, head, batch row); TC_BK keys a tile; head dims up to
// DMAX (a multiple of 16). Q stays in registers for DMAX <= 128 and is
// read again from shared memory per key tile above that.
template <int DMAX>
__global__ void __launch_bounds__(TC_NT) flash_fwd_tc_kernel(Params p) {
  using namespace flash_tc;
  constexpr bool Q_REGS = DMAX <= 128;
  constexpr int NKD = DMAX / 16;  // 16-deep chunks of the head dim
  constexpr int NND = DMAX / 8;   // 8-wide column tiles of O
  constexpr int NNK = TC_BK / 8;  // 8-wide key tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = p.D, DP = dpad(D), LD = row_ld(D);
  const int nkd = DP / 16;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // TC_BQ x LD
  bf16* Ks = Qs + TC_BQ * LD;                    // 2 x TC_BK x LD
  bf16* Vs = Ks + 2 * TC_BK * LD;                // 2 x TC_BK x LD

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int nqt = p.Sq / TC_BQ;
  // causal query tiles see the most keys last: launch them first
  const int q0 = (p.causal ? nqt - 1 - (int)blockIdx.z : (int)blockIdx.z) * TC_BQ;
  const int kvh = h / (p.H / p.KV);
  const int off = p.Sk - p.Sq;
  const int row0 = q0 + 16 * warp + g;  // this lane's rows: row0, row0 + 8

  // the key tiles this block visits: all, or (causal, S_k >= S_q) those
  // that the tile's band reaches, by the TPU kernel's test
  const int nkb = p.Sk / TC_BK;
  int kb_lo = 0, kb_hi = nkb;
  if (p.causal && off >= 0) {
    kb_lo = nkb;
    kb_hi = 0;
    for (int kb = 0; kb < nkb; ++kb) {
      const int k0 = kb * TC_BK;
      bool visible = q0 + TC_BQ - 1 + off >= k0;
      if (p.window > 0) visible = visible && (k0 + TC_BK - 1 > q0 + off - p.window);
      if (visible) {
        kb_lo = min(kb_lo, kb);
        kb_hi = kb + 1;
      }
    }
  }

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.qsb + h * p.qsh + q0 * p.qss;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.ksb + kvh * p.ksh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.vsb + kvh * p.vsh;

  const TileSplit split = tile_split<TC_NT>(D);
  zero_pad<TC_NT>(Qs, TC_BQ + 4 * TC_BK, D, LD);
  load_rows(Qs, qg, p.qss, TC_BQ, LD, split);
  load_rows(Ks, kg + (long long)kb_lo * TC_BK * p.kss, p.kss, TC_BK, LD, split);
  load_rows(Vs, vg + (long long)kb_lo * TC_BK * p.vss, p.vss, TC_BK, LD, split);
  cp_async_commit();

  uint32_t qf[Q_REGS ? NKD : 1][4];
  float o[NND][4];
#pragma unroll
  for (int j = 0; j < NND; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's share of each row's sum
  const bf16* qw = Qs + (16 * warp + a_row(lane)) * LD + a_col(lane);

  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int buf = (kb - kb_lo) & 1;
    if (kb + 1 < kb_hi) {
      const long long nk0 = (long long)(kb + 1) * TC_BK;
      load_rows(Ks + (buf ^ 1) * TC_BK * LD, kg + nk0 * p.kss, p.kss, TC_BK, LD, split);
      load_rows(Vs + (buf ^ 1) * TC_BK * LD, vg + nk0 * p.vss, p.vss, TC_BK, LD, split);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kb = Ks + buf * TC_BK * LD;
    const bf16* Vb = Vs + buf * TC_BK * LD;
    const int k0 = kb * TC_BK;
    if (Q_REGS && kb == kb_lo) {
#pragma unroll
      for (int kk = 0; kk < NKD; ++kk)
        if (kk < nkd) ldsm_x4(qf[Q_REGS ? kk : 0], qw + kk * 16);
    }

    // S = Q K^T for this warp's 16 rows and the tile's TC_BK keys
    float s[NNK][4];
#pragma unroll
    for (int j = 0; j < NNK; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NKD; ++kk) {
      if (kk < nkd) {
        uint32_t a[4];
        if (Q_REGS) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = qf[Q_REGS ? kk : 0][i];
        } else {
          ldsm_x4(a, qw + kk * 16);
        }
#pragma unroll
        for (int np = 0; np < NNK / 2; ++np) {
          uint32_t bk[4];
          ldsm_x4(bk, Kb + (np * 16 + bn_row(lane)) * LD + kk * 16 + bn_col(lane));
          mma(s[2 * np], a, bk[0], bk[1]);
          mma(s[2 * np + 1], a, bk[2], bk[3]);
        }
      }
    }

    // scale and mask in registers; masked scores are -1e30
    bool full = p.kmask == nullptr;
    if (p.causal) {
      full = full && k0 + TC_BK - 1 <= q0 + off;
      if (p.window > 0) full = full && k0 > q0 + TC_BQ - 1 + off - p.window;
    }
#pragma unroll
    for (int j = 0; j < NNK; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kp = k0 + j * 8 + 2 * t4 + c;
        const bool key_ok = full || p.kmask == nullptr || p.kmask[(long long)b * p.Sk + kp] > 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qp = row0 + 8 * r;
          bool keep = key_ok;
          if (!full && p.causal) {
            keep = keep && qp + off >= kp;
            if (p.window > 0) keep = keep && (kp > qp + off - p.window);
          }
          s[j][2 * r + c] = keep ? s[j][2 * r + c] * p.scale : NEG;
        }
      }
    }

    // online softmax on the fragments: rows row0 (e = 0, 1), row0 + 8 (e = 2, 3)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NNK; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = exp2f((m[r] - m_new) * LOG2E);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NNK; ++j) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float pv = exp2f((s[j][e] - m_new) * LOG2E);
          s[j][e] = pv;
          sum += pv;
        }
      }
      l[r] = alpha * l[r] + sum;
#pragma unroll
      for (int j = 0; j < NND; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
    }

    // O += P V: P rounded to bf16 as A fragments, V through ldmatrix.trans
#pragma unroll
    for (int kc = 0; kc < TC_BK / 16; ++kc) {
      uint32_t a[4];
      c_to_a(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int dp = 0; dp < NND / 2; ++dp) {
        if (dp < nkd) {
          uint32_t bv[4];
          ldsm_x4_t(bv, Vb + (kc * 16 + a_row(lane)) * LD + dp * 16 + a_col(lane));
          mma(o[2 * dp], a, bv[0], bv[1]);
          mma(o[2 * dp + 1], a, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  // epilogue: O / l, staged in this warp's rows of Qs, written 16 bytes a store
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
  bf16* Os = Qs + 16 * warp * LD;
#pragma unroll
  for (int j = 0; j < NND; ++j) {
    if (j * 8 < D) {
      const int c = j * 8 + 2 * t4;
      *reinterpret_cast<__nv_bfloat162*>(Os + g * LD + c) =
          __floats2bfloat162_rn(o[j][0] * inv[0], o[j][1] * inv[0]);
      *reinterpret_cast<__nv_bfloat162*>(Os + (g + 8) * LD + c) =
          __floats2bfloat162_rn(o[j][2] * inv[1], o[j][3] * inv[1]);
    }
  }
  __syncwarp();
  bf16* og = static_cast<bf16*>(p.o) +
             (((long long)b * p.Sq + q0 + 16 * warp) * p.H + h) * D;
  store_rows16(og, (long long)p.H * D, Os, D, LD, lane);
  if (p.lse != nullptr && t4 == 0) {
    float* lse = p.lse + ((long long)b * p.H + h) * p.Sq;
    lse[row0] = m[0] + logf(l[0]);
    lse[row0 + 8] = m[1] + logf(l[1]);
  }
}

template <int DMAX>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_floats(p.D) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(p.Sq / BQ, p.H, p.B);
  flash_fwd_kernel<DMAX><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_tc(const Params& p, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(p.D);
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_tc_kernel<DMAX>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(p.H, p.B, p.Sq / TC_BQ);
  flash_fwd_tc_kernel<DMAX><<<grid, TC_NT, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const Params& p, cudaStream_t stream) {
  if (p.D <= 64) return launch<64>(p, stream);
  if (p.D <= 128) return launch<128>(p, stream);
  return launch<256>(p, stream);
}

cudaError_t dispatch_tc(const Params& p, cudaStream_t stream) {
  if (p.D <= 64) return launch_tc<64>(p, stream);
  if (p.D <= 128) return launch_tc<128>(p, stream);
  return launch_tc<256>(p, stream);
}

bool aligned16(const void* ptr, long long s0, long long s1, long long s2) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && s0 % 8 == 0 && s1 % 8 == 0 &&
         s2 % 8 == 0;
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores). Strides
// are in elements. S_q and S_k must be multiples of the route's tiles
// (32 keys for f32, 64 queries and 64 keys for bf16). The bf16 route
// reads q, k and v 16 bytes at a time: their pointers must be 16-byte
// aligned and their strides multiples of 8. Returns a cudaError_t: 0 when
// the launch was accepted.
extern "C" int mxtpu_flash_fwd(const void* q, const void* k, const void* v, void* o,
                               float* lse, const float* kmask, int dtype, int B, int H,
                               int KV, int Sq, int Sk, int D, long long qsb,
                               long long qss, long long qsh, long long ksb, long long kss,
                               long long ksh, long long vsb, long long vss, long long vsh,
                               float scale, int causal, int window,
                               void* stream) {
  if (D < 8 || D > 256 || D % 8 || KV < 1 || H % KV || Sq % BQ || Sk % BK || B < 1 ||
      Sq < 1 || Sk < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p{q,   k,   v,   o,   lse, kmask, B,     H,      KV,     Sq, Sk, D, qsb,
           qss, qsh, ksb, kss, ksh, vsb,   vss,   vsh,    scale,  causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_f32(p, s);
  if (Sq % TC_BQ || Sk % TC_BK) return (int)cudaErrorInvalidValue;
  if (!aligned16(q, qsb, qss, qsh) || !aligned16(k, ksb, kss, ksh) ||
      !aligned16(v, vsb, vss, vsh))
    return (int)cudaErrorMisalignedAddress;
  return (int)dispatch_tc(p, s);
}

// 1 when inputs of this dtype run on the tensor cores, 0 on the CUDA cores.
extern "C" int mxtpu_flash_fwd_tc(int dtype) { return dtype == 1; }

// The tile sizes, for the wrapper's shape checks: the largest of either
// route's (S_q a multiple of block_q, S_k of block_k).
extern "C" int mxtpu_flash_fwd_block_q() { return BQ > TC_BQ ? BQ : TC_BQ; }
extern "C" int mxtpu_flash_fwd_block_k() { return BK > TC_BK ? BK : TC_BK; }
