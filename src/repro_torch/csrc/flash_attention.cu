// Flash attention for Hopper: forward, fused single-sweep backward, and the
// two-sweep backward (dQ sweep, dK/dV sweep).
//
// Replaces the TPU Pallas kernels
//   repro/kernels/flash_attention/kernel.py::flash_fwd        (pallas_call :119)
//   repro/kernels/flash_attention/kernel.py::flash_bwd_fused  (:464 partials,
//                                                               :481 alias)
//   repro/kernels/flash_attention/kernel.py::flash_bwd_dq     (:212)
//   repro/kernels/flash_attention/kernel.py::flash_bwd_dkv    (:269)
// with the same math: FA-2 online softmax over kv tiles, mask = causal AND
// window AND k_pos < kv_len (-1e30 sentinel, l clamped at 1e-30), optional
// tanh softcap on the scaled scores, GQA kv head = bh / group; the fused
// backward recomputes each P tile once and feeds dV, dK and dQ from it; the
// two-sweep backward recomputes P once in each sweep.
//
// Layouts (as the reference kernels): q, dout, dq (BH, Sq, hd) with
// BH = B * Hkv * G, kv-major; k, v, dk, dv (BKV, Skv, hd).  o, lse, dq, dk,
// dv, dout and delta are fp32; q, k, v are fp32 or bf16.
//
// What bounds it on the H100: at the main path's shapes (S = 512, hd = 128)
// attention is compute-bound (~2*S*hd flops per loaded q/k/v element).
// This first version computes every product with fp32 FMAs on the CUDA
// cores (no tensor cores), so it runs far below the bf16 tensor-core
// bound; PERF.md keeps its time beside that bound.  What the design does
// about it: tiles of Q/K/V/dO live in shared memory (converted to fp32 once
// per tile load), each thread owns a 16 x 16-strided block of every tile
// product, rows of padded stride hd + 1 keep the shared-memory walks
// bank-conflict free, and kv tiles that the mask removes entirely are
// skipped (causal upper triangle, outside the window, past kv_len), which
// the TPU's sequential grid could not do.
//
// Forward: one CTA per (bh, q tile); the kv loop runs inside the CTA with
// (m, l, acc) in registers.  A q tile holding a row with no valid key at all
// (only possible when Skv < S with a window) processes every kv tile, so
// such a row keeps the reference's result (uniform weights over the masked
// keys).  For every other row skipping is exact: a skipped tile adds
// exp(-1e30 - m) = 0 or is wiped by corr = 0 when the first valid tile
// arrives, as in the reference.
//
// Fused backward: one CTA per (bkv, kv tile), looping over the group's G
// heads and all q tiles with dK/dV accumulated in registers.  The TPU kernel
// carried dQ across kv tiles through an aliased HBM buffer that relies on
// the sequential grid; here the kv tiles of one q tile run in different
// CTAs, so dQ is accumulated with fp32 atomicAdd into a zeroed buffer (each
// dQ element receives at most nk = ceil(Skv / BK) adds).  It recomputes no
// P tile twice; the cost is run-to-run nondeterminism of dQ in the last
// bits (the summation order of the nk adds).
//
// Two-sweep backward, deterministic: the dK/dV sweep is the fused kernel
// without its dQ atomics (kDQ = false); the dQ sweep runs one CTA per
// (bh, q tile) that loops over the kv tiles the mask leaves, recomputes P
// and dS for each, keeps dQ in registers and writes it once.  Neither sweep
// has atomics, so both give bit-identical results run to run, at the price
// of recomputing P (and dP) twice.
#include "common.cuh"

namespace {

using rt::kNegInf;
using rt::kThreads;
using rt::to_f32;

// (BQ, BK) per head dim: shared memory stays under 227 KB and the
// per-thread register blocks stay small.
template <int HD> struct FaTiles { static constexpr int BQ = 64, BK = 64; };
template <> struct FaTiles<256> { static constexpr int BQ = 32, BK = 32; };

__device__ __forceinline__ bool fa_keep(int qp, int kp, int causal,
                                        int window, int kv_len) {
  bool ok = kp < kv_len;
  if (causal) ok = ok && qp >= kp;
  if (window) ok = ok && (qp - kp) < window;
  return ok;
}

// true when the mask removes every (q, k) pair of rows [qa, qb] x keys [ka, kb]
__device__ __forceinline__ bool fa_tile_masked(int qa, int qb, int ka, int kb,
                                               int causal, int window,
                                               int kv_len) {
  if (ka >= kv_len) return true;
  if (causal && ka > qb) return true;
  if (window && qa - kb >= window) return true;
  return false;
}

// true when query row q has no valid key in [0, Skv)
__device__ __forceinline__ bool fa_row_empty(int q, int Skv, int causal,
                                             int window, int kv_len) {
  int hi = min(kv_len, Skv) - 1;
  if (causal) hi = min(hi, q);
  const int lo = window ? max(0, q - window + 1) : 0;
  return lo > hi;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int Sq, int Skv, int group,
              int causal, int window, float softcap, float scale,
              int kv_len) {
  constexpr int BQ = FaTiles<HD>::BQ, BK = FaTiles<HD>::BK;
  constexpr int LD = HD + 1, LP = BK + 1;
  constexpr int RQ = BQ / 16, CK = BK / 16, CD = HD / 16;
  extern __shared__ float smem[];
  float* sQ = smem;            // BQ x LD, pre-scaled
  float* sK = sQ + BQ * LD;    // BK x LD
  float* sV = sK + BK * LD;    // BK x LD
  float* sP = sV + BK * LD;    // BQ x LP

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int qb = min(q0 + BQ, Sq) - 1;
  const T* qg = q + (size_t)bh * Sq * HD;
  const T* kg = k + (size_t)(bh / group) * Skv * HD;
  const T* vg = v + (size_t)(bh / group) * Skv * HD;

  for (int e = tid; e < BQ * HD; e += kThreads) {
    const int r = e / HD, c = e % HD;
    sQ[r * LD + c] =
        (q0 + r < Sq) ? to_f32(qg[(size_t)(q0 + r) * HD + c]) * scale : 0.f;
  }
  const bool empty = tid < BQ && q0 + tid < Sq &&
                     fa_row_empty(q0 + tid, Skv, causal, window, kv_len);
  const bool may_skip = !__syncthreads_or(empty);

  float m_i[RQ], l_i[RQ], acc[RQ][CD];
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    m_i[r] = kNegInf;
    l_i[r] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[r][c] = 0.f;
  }

  const int nk = (Skv + BK - 1) / BK;
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    if (may_skip && fa_tile_masked(q0, qb, k0, min(k0 + BK, Skv) - 1, causal,
                                   window, kv_len))
      continue;  // uniform over the block
    __syncthreads();  // the previous tile's sK/sV/sP reads are done
    for (int e = tid; e < BK * HD; e += kThreads) {
      const int r = e / HD, c = e % HD;
      const bool in = k0 + r < Skv;
      sK[r * LD + c] = in ? to_f32(kg[(size_t)(k0 + r) * HD + c]) : 0.f;
      sV[r * LD + c] = in ? to_f32(vg[(size_t)(k0 + r) * HD + c]) : 0.f;
    }
    __syncthreads();

    float s[RQ][CK];
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int c = 0; c < CK; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float kv[CK];
#pragma unroll
      for (int c = 0; c < CK; ++c) kv[c] = sK[(tx + 16 * c) * LD + d];
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const float qv = sQ[(ty * RQ + r) * LD + d];
#pragma unroll
        for (int c = 0; c < CK; ++c) s[r][c] += qv * kv[c];
      }
    }

#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const int qp = q0 + ty * RQ + r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const int kp = k0 + tx + 16 * c;
        float x = s[r][c];
        if (softcap != 0.f) x = tanhf(x / softcap) * softcap;
        // columns past the tensor's Skv are not keys at all (weight 0 even
        // for a row with no valid key); masked keys get the -1e30 sentinel
        x = kp >= Skv ? -INFINITY
                      : (fa_keep(qp, kp, causal, window, kv_len) ? x : kNegInf);
        s[r][c] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m_i[r], rt::row_max16(mx));
      const float corr = expf(m_i[r] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const float p = expf(s[r][c] - m_new);
        sP[(ty * RQ + r) * LP + tx + 16 * c] = p;
        ps += p;
      }
      l_i[r] = l_i[r] * corr + rt::row_sum16(ps);
      m_i[r] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[r][c] *= corr;
    }
    __syncthreads();  // sP complete

    for (int jj = 0; jj < BK; ++jj) {
      float vv[CD];
#pragma unroll
      for (int c = 0; c < CD; ++c) vv[c] = sV[jj * LD + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const float p = sP[(ty * RQ + r) * LP + jj];
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[r][c] += p * vv[c];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int row = q0 + ty * RQ + r;
    if (row < Sq) {
      const float l = fmaxf(l_i[r], 1e-30f);
      float* og = o + ((size_t)bh * Sq + row) * HD;
#pragma unroll
      for (int c = 0; c < CD; ++c) og[tx + 16 * c] = acc[r][c] / l;
      if (tx == 0) lse[(size_t)bh * Sq + row] = m_i[r] + logf(l);
    }
  }
}

// One (q tile, kv tile) of the backward: P = exp(softcap(scale * Q K^T) -
// lse), masked to exact zeros, into sP (when given) and dS = P * (dO V^T -
// delta) * softcap chain * scale into sS.  Thread (ty, tx) owns rows
// ty * RQ + r and columns tx + 16 c of both tiles.
template <int HD, int BQ, int BK>
__device__ __forceinline__ void bwd_p_ds(
    const float* sQ, const float* sO, const float* sK, const float* sV,
    const float* sL, const float* sD, float* sP, float* sS, int q0, int k0,
    int Sq, int causal, int window, int kv_len, float softcap, float scale) {
  constexpr int LD = HD + 1, LP = BK + 1, RQ = BQ / 16, CK = BK / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[RQ][CK], dp[RQ][CK];
#pragma unroll
  for (int r = 0; r < RQ; ++r)
#pragma unroll
    for (int c = 0; c < CK; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float kv[CK], vv[CK];
#pragma unroll
    for (int c = 0; c < CK; ++c) {
      kv[c] = sK[(tx + 16 * c) * LD + d];
      vv[c] = sV[(tx + 16 * c) * LD + d];
    }
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const float qv = sQ[(ty * RQ + r) * LD + d] * scale;
      const float ov = sO[(ty * RQ + r) * LD + d];
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        s[r][c] += qv * kv[c];
        dp[r][c] += ov * vv[c];  // dP = dO V^T
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int rl = ty * RQ + r;
    const int qp = q0 + rl;
#pragma unroll
    for (int c = 0; c < CK; ++c) {
      float x = s[r][c], chain = 1.f;
      if (softcap != 0.f) {
        x = tanhf(x / softcap) * softcap;
        const float u = x / softcap;
        chain = 1.f - u * u;  // d softcap / d s_raw
      }
      const bool ok =
          qp < Sq && fa_keep(qp, k0 + tx + 16 * c, causal, window, kv_len);
      const float p = ok ? expf(x - sL[rl]) : 0.f;
      if (sP) sP[rl * LP + tx + 16 * c] = p;
      sS[rl * LP + tx + 16 * c] = p * (dp[r][c] - sD[rl]) * chain * scale;
    }
  }
}

template <typename T, int HD, bool kDQ>
__global__ void __launch_bounds__(kThreads)
fa_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, float* __restrict__ dk,
              float* __restrict__ dv, int Sq, int Skv, int group, int causal,
              int window, float softcap, float scale, int kv_len) {
  constexpr int BQ = FaTiles<HD>::BQ, BK = FaTiles<HD>::BK;
  constexpr int LD = HD + 1, LP = BK + 1;
  constexpr int RQ = BQ / 16, RK = BK / 16, CD = HD / 16;
  extern __shared__ float smem[];
  float* sK = smem;            // BK x LD
  float* sV = sK + BK * LD;    // BK x LD
  float* sQ = sV + BK * LD;    // BQ x LD (unscaled)
  float* sO = sQ + BQ * LD;    // BQ x LD (dO)
  float* sP = sO + BQ * LD;    // BQ x LP
  float* sS = sP + BQ * LP;    // BQ x LP (dS)
  float* sL = sS + BQ * LP;    // BQ (lse)
  float* sD = sL + BQ;         // BQ (delta)

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bkv = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int kb = min(k0 + BK, Skv) - 1;
  const T* kg = k + (size_t)bkv * Skv * HD;
  const T* vg = v + (size_t)bkv * Skv * HD;
  for (int e = tid; e < BK * HD; e += kThreads) {
    const int r = e / HD, c = e % HD;
    const bool in = k0 + r < Skv;
    sK[r * LD + c] = in ? to_f32(kg[(size_t)(k0 + r) * HD + c]) : 0.f;
    sV[r * LD + c] = in ? to_f32(vg[(size_t)(k0 + r) * HD + c]) : 0.f;
  }

  float dk_acc[RK][CD], dv_acc[RK][CD];
#pragma unroll
  for (int r = 0; r < RK; ++r)
#pragma unroll
    for (int c = 0; c < CD; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  const int nq = (Sq + BQ - 1) / BQ;
  for (int g = 0; g < group; ++g) {
    const size_t bh = (size_t)bkv * group + g;
    const T* qg = q + bh * Sq * HD;
    const float* og = dout + bh * Sq * HD;
    float* dqg = kDQ ? dq + bh * Sq * HD : nullptr;
    for (int iq = 0; iq < nq; ++iq) {
      const int q0 = iq * BQ;
      if (fa_tile_masked(q0, min(q0 + BQ, Sq) - 1, k0, kb, causal, window,
                         kv_len))
        continue;  // uniform over the block; the tile adds exact zeros
      __syncthreads();  // previous smem reads done (and sK/sV loaded)
      for (int e = tid; e < BQ * HD; e += kThreads) {
        const int r = e / HD, c = e % HD;
        const bool in = q0 + r < Sq;
        sQ[r * LD + c] = in ? to_f32(qg[(size_t)(q0 + r) * HD + c]) : 0.f;
        sO[r * LD + c] = in ? og[(size_t)(q0 + r) * HD + c] : 0.f;
      }
      if (tid < BQ) {
        const bool in = q0 + tid < Sq;
        sL[tid] = in ? lse[bh * Sq + q0 + tid] : 0.f;
        sD[tid] = in ? delta[bh * Sq + q0 + tid] : 0.f;
      }
      __syncthreads();

      bwd_p_ds<HD, BQ, BK>(sQ, sO, sK, sV, sL, sD, sP, sS, q0, k0, Sq, causal,
                           window, kv_len, softcap, scale);
      __syncthreads();  // sP, sS complete

      // dV += P^T dO ; dK += dS^T Q
      for (int i = 0; i < BQ; ++i) {
        float ov[CD], qv[CD];
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          ov[c] = sO[i * LD + tx + 16 * c];
          qv[c] = sQ[i * LD + tx + 16 * c];
        }
#pragma unroll
        for (int r = 0; r < RK; ++r) {
          const float pv = sP[i * LP + ty * RK + r];
          const float sv = sS[i * LP + ty * RK + r];
#pragma unroll
          for (int c = 0; c < CD; ++c) {
            dv_acc[r][c] += pv * ov[c];
            dk_acc[r][c] += sv * qv[c];
          }
        }
      }

      if (!kDQ) continue;  // the dK/dV sweep of the two-sweep backward
      // dQ += dS K, summed across the kv-tile CTAs with atomics
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const int rl = ty * RQ + r;
        float dqv[CD];
#pragma unroll
        for (int c = 0; c < CD; ++c) dqv[c] = 0.f;
        for (int kk = 0; kk < BK; ++kk) {
          const float sv = sS[rl * LP + kk];
#pragma unroll
          for (int c = 0; c < CD; ++c) dqv[c] += sv * sK[kk * LD + tx + 16 * c];
        }
        if (q0 + rl < Sq) {
#pragma unroll
          for (int c = 0; c < CD; ++c)
            atomicAdd(&dqg[(size_t)(q0 + rl) * HD + tx + 16 * c], dqv[c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RK; ++r) {
    const int row = k0 + ty * RK + r;
    if (row < Skv) {
      float* dkg = dk + ((size_t)bkv * Skv + row) * HD;
      float* dvg = dv + ((size_t)bkv * Skv + row) * HD;
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        dkg[tx + 16 * c] = dk_acc[r][c];
        dvg[tx + 16 * c] = dv_acc[r][c];
      }
    }
  }
}

// dQ sweep of the two-sweep backward: one CTA per (bh, q tile) loops over
// the kv tiles the mask leaves, with dQ in registers; written once.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 int Sq, int Skv, int group, int causal, int window,
                 float softcap, float scale, int kv_len) {
  constexpr int BQ = FaTiles<HD>::BQ, BK = FaTiles<HD>::BK;
  constexpr int LD = HD + 1, LP = BK + 1;
  constexpr int RQ = BQ / 16, CD = HD / 16;
  extern __shared__ float smem[];
  float* sQ = smem;            // BQ x LD (unscaled)
  float* sO = sQ + BQ * LD;    // BQ x LD (dO)
  float* sK = sO + BQ * LD;    // BK x LD
  float* sV = sK + BK * LD;    // BK x LD
  float* sS = sV + BK * LD;    // BQ x LP (dS)
  float* sL = sS + BQ * LP;    // BQ (lse)
  float* sD = sL + BQ;         // BQ (delta)

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int qb = min(q0 + BQ, Sq) - 1;
  const T* qg = q + bh * Sq * HD;
  const float* og = dout + bh * Sq * HD;
  const T* kg = k + (bh / group) * Skv * HD;
  const T* vg = v + (bh / group) * Skv * HD;
  for (int e = tid; e < BQ * HD; e += kThreads) {
    const int r = e / HD, c = e % HD;
    const bool in = q0 + r < Sq;
    sQ[r * LD + c] = in ? to_f32(qg[(size_t)(q0 + r) * HD + c]) : 0.f;
    sO[r * LD + c] = in ? og[(size_t)(q0 + r) * HD + c] : 0.f;
  }
  if (tid < BQ) {
    const bool in = q0 + tid < Sq;
    sL[tid] = in ? lse[bh * Sq + q0 + tid] : 0.f;
    sD[tid] = in ? delta[bh * Sq + q0 + tid] : 0.f;
  }

  float dq_acc[RQ][CD];
#pragma unroll
  for (int r = 0; r < RQ; ++r)
#pragma unroll
    for (int c = 0; c < CD; ++c) dq_acc[r][c] = 0.f;

  const int nk = (Skv + BK - 1) / BK;
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    if (fa_tile_masked(q0, qb, k0, min(k0 + BK, Skv) - 1, causal, window,
                       kv_len))
      continue;  // uniform over the block; the tile adds exact zeros
    __syncthreads();  // previous tile's sK/sS reads done (and sQ/sO loaded)
    for (int e = tid; e < BK * HD; e += kThreads) {
      const int r = e / HD, c = e % HD;
      const bool in = k0 + r < Skv;
      sK[r * LD + c] = in ? to_f32(kg[(size_t)(k0 + r) * HD + c]) : 0.f;
      sV[r * LD + c] = in ? to_f32(vg[(size_t)(k0 + r) * HD + c]) : 0.f;
    }
    __syncthreads();
    bwd_p_ds<HD, BQ, BK>(sQ, sO, sK, sV, sL, sD, nullptr, sS, q0, k0, Sq,
                         causal, window, kv_len, softcap, scale);
    __syncthreads();  // sS complete

    // dQ += dS K
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const int rl = ty * RQ + r;
      for (int kk = 0; kk < BK; ++kk) {
        const float sv = sS[rl * LP + kk];
#pragma unroll
        for (int c = 0; c < CD; ++c)
          dq_acc[r][c] += sv * sK[kk * LD + tx + 16 * c];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int row = q0 + ty * RQ + r;
    if (row < Sq) {
      float* dqg = dq + (bh * Sq + row) * HD;
#pragma unroll
      for (int c = 0; c < CD; ++c) dqg[tx + 16 * c] = dq_acc[r][c];
    }
  }
}

struct FaArgs {
  const void *q, *k, *v, *dout, *lse_in, *delta;
  void *o, *lse, *dq, *dk, *dv;
  int BH, Sq, Skv, group, causal, window, kv_len;
  float softcap, scale;
  cudaStream_t stream;
};

template <typename T, int HD>
cudaError_t launch_fwd(const FaArgs& a) {
  constexpr int BQ = FaTiles<HD>::BQ, BK = FaTiles<HD>::BK;
  const size_t smem =
      ((size_t)(BQ + 2 * BK) * (HD + 1) + (size_t)BQ * (BK + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.BH);
  fa_fwd_kernel<T, HD><<<grid, kThreads, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (float*)a.o,
      (float*)a.lse, a.Sq, a.Skv, a.group, a.causal, a.window, a.softcap,
      a.scale, a.kv_len);
  return cudaGetLastError();
}

// the backward kernels: the fused one, and the two sweeps of the split one
enum BwdKind { kFused, kDq, kDkv };

template <typename T, int HD, BwdKind KIND>
cudaError_t launch_bwd(const FaArgs& a) {
  constexpr int BQ = FaTiles<HD>::BQ, BK = FaTiles<HD>::BK;
  cudaError_t err;
  if constexpr (KIND == kDq) {
    const size_t smem = ((size_t)(2 * BK + 2 * BQ) * (HD + 1) +
                         (size_t)BQ * (BK + 1) + 2 * BQ) * sizeof(float);
    err = cudaFuncSetAttribute(fa_bwd_dq_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Sq + BQ - 1) / BQ, a.BH);
    fa_bwd_dq_kernel<T, HD><<<grid, kThreads, smem, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const float*)a.dout,
        (const float*)a.lse_in, (const float*)a.delta, (float*)a.dq, a.Sq,
        a.Skv, a.group, a.causal, a.window, a.softcap, a.scale, a.kv_len);
  } else {
    constexpr bool kDQ = KIND == kFused;
    const size_t smem = ((size_t)(2 * BK + 2 * BQ) * (HD + 1) +
                         (size_t)2 * BQ * (BK + 1) + 2 * BQ) * sizeof(float);
    err = cudaFuncSetAttribute(fa_bwd_kernel<T, HD, kDQ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Skv + BK - 1) / BK, a.BH / a.group);
    fa_bwd_kernel<T, HD, kDQ><<<grid, kThreads, smem, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const float*)a.dout,
        (const float*)a.lse_in, (const float*)a.delta, (float*)a.dq,
        (float*)a.dk, (float*)a.dv, a.Sq, a.Skv, a.group, a.causal, a.window,
        a.softcap, a.scale, a.kv_len);
  }
  return cudaGetLastError();
}

// KIND: -1 the forward, else a BwdKind
template <typename T, int KIND>
cudaError_t launch(const FaArgs& a, int hd) {
  switch (hd) {
#define RT_FA_CASE(HD)                                                  \
    case HD:                                                            \
      if constexpr (KIND < 0) return launch_fwd<T, HD>(a);              \
      else return launch_bwd<T, HD, (BwdKind)KIND>(a);
    RT_FA_CASE(16) RT_FA_CASE(32) RT_FA_CASE(64) RT_FA_CASE(128)
    RT_FA_CASE(256)
#undef RT_FA_CASE
    default: return cudaErrorInvalidValue;
  }
}

template <int KIND>
int dispatch(int dtype, int hd, const FaArgs& a) {
  if (dtype == rt::kFloat32) return (int)launch<float, KIND>(a, hd);
  if (dtype == rt::kBFloat16) return (int)launch<__nv_bfloat16, KIND>(a, hd);
  return (int)cudaErrorInvalidValue;
}

FaArgs bwd_args(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dq, void* dk, void* dv, int BH, int Sq, int Skv,
                int group, int causal, int window, float softcap, float scale,
                int kv_len, void* stream) {
  FaArgs a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse_in = lse; a.delta = delta;
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.BH = BH; a.Sq = Sq; a.Skv = Skv; a.group = group; a.causal = causal;
  a.window = window; a.kv_len = kv_len; a.softcap = softcap; a.scale = scale;
  a.stream = (cudaStream_t)stream;
  return a;
}

}  // namespace

extern "C" int rt_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int dtype, int BH, int Sq,
                            int Skv, int hd, int group, int causal, int window,
                            float softcap, float scale, int kv_len,
                            void* stream) {
  FaArgs a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.lse = lse;
  a.BH = BH; a.Sq = Sq; a.Skv = Skv; a.group = group; a.causal = causal;
  a.window = window; a.kv_len = kv_len; a.softcap = softcap; a.scale = scale;
  a.stream = (cudaStream_t)stream;
  return dispatch<-1>(dtype, hd, a);
}

extern "C" int rt_flash_bwd(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, void* dk, void* dv,
                            int dtype, int BH, int Sq, int Skv, int hd,
                            int group, int causal, int window, float softcap,
                            float scale, int kv_len, void* stream) {
  return dispatch<kFused>(dtype, hd,
                          bwd_args(q, k, v, dout, lse, delta, dq, dk, dv, BH,
                                   Sq, Skv, group, causal, window, softcap,
                                   scale, kv_len, stream));
}

extern "C" int rt_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int dtype, int BH,
                               int Sq, int Skv, int hd, int group, int causal,
                               int window, float softcap, float scale,
                               int kv_len, void* stream) {
  return dispatch<kDq>(dtype, hd,
                       bwd_args(q, k, v, dout, lse, delta, dq, nullptr,
                                nullptr, BH, Sq, Skv, group, causal, window,
                                softcap, scale, kv_len, stream));
}

extern "C" int rt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv,
                                int dtype, int BH, int Sq, int Skv, int hd,
                                int group, int causal, int window,
                                float softcap, float scale, int kv_len,
                                void* stream) {
  return dispatch<kDkv>(dtype, hd,
                        bwd_args(q, k, v, dout, lse, delta, nullptr, dk, dv,
                                 BH, Sq, Skv, group, causal, window, softcap,
                                 scale, kv_len, stream));
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
