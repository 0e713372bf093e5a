// Fused vocabulary-tiled cross-entropy for Hopper: forward and backward.
//
// Replaces the TPU Pallas kernels
//   repro/kernels/xent/kernel.py::xent_fwd  (pallas_call :126)
//   repro/kernels/xent/kernel.py::xent_bwd  (:281 partials, :299 alias)
// with the same math: per token, online (max, sum-exp, correct logit) over
// vocabulary tiles of z = h @ w, optional final softcap s = cap*tanh(z/cap),
// vocabulary padding masked with -1e30; backward
// dlogits = (softmax - onehot) * g * (1 - (s/cap)^2).
//
// h (T, D) is fp32 or bf16 and contiguous; w (D, V) is fp32 or bf16 with
// arbitrary element strides, so the tied auxiliary head (a transposed view
// of the (V, D) embedding table) is read in place with no copy; dw is
// written with the strides the caller gives (the wrapper hands the tied
// case a (V, D) buffer, which reaches the embedding gradient untransposed).
//
// What bounds it on the H100: the three contractions (logits, dH, dW) carry
// 2*T*D*V flops each over operands that are read once, so every call is
// compute-bound by a wide margin.  This first version computes them with
// fp32 FMAs on the CUDA cores (the reference upcasts both operands to fp32),
// 64 x 64 output tiles per 256-thread CTA, 4 x 4 outputs per thread,
// 32-deep k chunks staged in shared memory with a loader that follows
// whichever operand stride is unit so global reads coalesce in both head
// layouts.  Tensor cores are left for a later PR; PERF.md keeps the gap.
//
// Forward: one CTA per (64-token tile, vocabulary split), looping over the
// split's vocabulary tiles with the row statistics in registers; a second
// small kernel merges the splits' (m, l, c) exactly as the online softmax
// merges tiles.  The split count is chosen by the wrapper so that short
// token counts still fill the 132 SMs.
//
// Backward: the TPU kernel summed dH across vocabulary tiles through an
// aliased HBM buffer (sequential grid) and kept the dW tile resident in
// VMEM.  Neither carries over: a dW tile (D x bv) does not fit one SM, and
// dH atomics would be revisited once per vocabulary tile.  Instead the
// tokens are processed in chunks of `chunk` rows: one kernel recomputes
// each logits tile of the chunk exactly once and writes dlogits into a
// bounded fp32 staging buffer (chunk x V), then two tiled products form
// dH[chunk] = dlogits @ w^T and dW += h[chunk]^T @ dlogits.  No atomics:
// the backward is deterministic.  Cost: the staging buffer (the wrapper
// bounds it at 512 MiB) and one write plus two reads of it per chunk.
#include "common.cuh"

namespace {

using rt::kNegInf;
using rt::kThreads;
using rt::to_f32;
typedef long long ll;

constexpr int BM = 64, BN = 64, BKK = 32;   // output tile, k chunk
constexpr int RM = BM / 16, RN = BN / 16;   // outputs per thread
constexpr int LA = BM + 1, LB = BN + 1;     // padded smem rows

// acc += A[m0:m0+BM, 0:K] @ B[0:K, n0:n0+BN]; element (m, k) of A sits at
// A[m*sa_m + k*sa_k], element (k, n) of B at B[k*sb_k + n*sb_n].
template <typename TA, typename TB>
__device__ __forceinline__ void mm_tile(const TA* __restrict__ A, ll sa_m,
                                        ll sa_k, const TB* __restrict__ B,
                                        ll sb_k, ll sb_n, int M, int N, int K,
                                        int m0, int n0, float (&acc)[RM][RN],
                                        float* sA, float* sB) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  for (int k0 = 0; k0 < K; k0 += BKK) {
    __syncthreads();  // the previous chunk's reads are done
    for (int e = tid; e < BM * BKK; e += kThreads) {
      int m, kk;
      if (sa_k == 1) { m = e / BKK; kk = e % BKK; }
      else { m = e % BM; kk = e / BM; }
      const int gm = m0 + m, gk = k0 + kk;
      sA[kk * LA + m] =
          (gm < M && gk < K) ? to_f32(A[gm * sa_m + gk * sa_k]) : 0.f;
    }
    for (int e = tid; e < BKK * BN; e += kThreads) {
      int n, kk;
      if (sb_n == 1) { n = e % BN; kk = e / BN; }
      else { n = e / BKK; kk = e % BKK; }
      const int gn = n0 + n, gk = k0 + kk;
      sB[kk * LB + n] =
          (gn < N && gk < K) ? to_f32(B[gk * sb_k + gn * sb_n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BKK; ++kk) {
      float a[RM], b[RN];
#pragma unroll
      for (int r = 0; r < RM; ++r) a[r] = sA[kk * LA + ty * RM + r];
#pragma unroll
      for (int c = 0; c < RN; ++c) b[c] = sB[kk * LB + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < RN; ++c) acc[r][c] += a[r] * b[c];
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[RM][RN]) {
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < RN; ++c) acc[r][c] = 0.f;
}

// Forward: partial (m, l, c) per token over one vocabulary split.
// part layout: (3, nsplit, T) = m, l, c.
template <typename TH, typename TW>
__global__ void __launch_bounds__(kThreads)
xent_fwd_kernel(const TH* __restrict__ h, const TW* __restrict__ w,
                const int* __restrict__ labels, float* __restrict__ part,
                int T, int D, int V, ll sw_d, ll sw_v, float softcap,
                int v_per_split) {
  __shared__ float sA[BKK * LA];
  __shared__ float sB[BKK * LB];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int t0 = blockIdx.x * BM;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int v_begin = split * v_per_split;
  const int v_end = min(V, v_begin + v_per_split);

  int lab[RM];
  float m_i[RM], l_i[RM], c_i[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int t = t0 + ty * RM + r;
    lab[r] = t < T ? labels[t] : -1;
    m_i[r] = kNegInf;
    l_i[r] = 0.f;
    c_i[r] = 0.f;
  }
  for (int v0 = v_begin; v0 < v_end; v0 += BN) {
    float acc[RM][RN];
    zero(acc);
    mm_tile(h, (ll)D, 1LL, w, sw_d, sw_v, T, V, D, t0, v0, acc, sA, sB);
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < RN; ++c) {
        float x = acc[r][c];
        if (softcap != 0.f) x = tanhf(x / softcap) * softcap;
        x = (v0 + tx + 16 * c < v_end) ? x : kNegInf;
        acc[r][c] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m_i[r], rt::row_max16(mx));
      float ps = 0.f, cs = 0.f;
#pragma unroll
      for (int c = 0; c < RN; ++c) {
        const int id = v0 + tx + 16 * c;
        ps += expf(acc[r][c] - m_new);
        if (id == lab[r] && id < v_end) cs += acc[r][c];
      }
      l_i[r] = l_i[r] * expf(m_i[r] - m_new) + rt::row_sum16(ps);
      c_i[r] += rt::row_sum16(cs);
      m_i[r] = m_new;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int t = t0 + ty * RM + r;
      if (t < T) {
        part[((ll)0 * nsplit + split) * T + t] = m_i[r];
        part[((ll)1 * nsplit + split) * T + t] = l_i[r];
        part[((ll)2 * nsplit + split) * T + t] = c_i[r];
      }
    }
  }
}

__global__ void xent_combine_kernel(const float* __restrict__ part,
                                    float* __restrict__ loss,
                                    float* __restrict__ lse, int T,
                                    int nsplit) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  float m = kNegInf;
  for (int s = 0; s < nsplit; ++s) m = fmaxf(m, part[(ll)s * T + t]);
  float l = 0.f, c = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    l += part[(ll)(nsplit + s) * T + t] * expf(part[(ll)s * T + t] - m);
    c += part[(ll)(2 * nsplit + s) * T + t];
  }
  const float ls = m + logf(fmaxf(l, 1e-30f));
  loss[t] = ls - c;
  lse[t] = ls;
}

// Backward step 1: dlogits of tokens [t_begin, t_begin + t_count) into
// stage (t_count, V), each logits tile recomputed once.
template <typename TH, typename TW>
__global__ void __launch_bounds__(kThreads)
xent_dlogits_kernel(const TH* __restrict__ h, const TW* __restrict__ w,
                    const int* __restrict__ labels,
                    const float* __restrict__ lse, const float* __restrict__ g,
                    float* __restrict__ stage, int t_begin, int t_count, int D,
                    int V, ll sw_d, ll sw_v, float softcap) {
  __shared__ float sA[BKK * LA];
  __shared__ float sB[BKK * LB];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int t0 = blockIdx.y * BM, v0 = blockIdx.x * BN;
  float acc[RM][RN];
  zero(acc);
  mm_tile(h + (ll)t_begin * D, (ll)D, 1LL, w, sw_d, sw_v, t_count, V, D, t0,
          v0, acc, sA, sB);
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int tl = t0 + ty * RM + r;
    if (tl >= t_count) continue;
    const int t = t_begin + tl;
    const float lt = lse[t], gt = g[t];
    const int lab = labels[t];
#pragma unroll
    for (int c = 0; c < RN; ++c) {
      const int id = v0 + tx + 16 * c;
      if (id >= V) continue;
      float x = acc[r][c], chain = 1.f;
      if (softcap != 0.f) {
        x = tanhf(x / softcap) * softcap;
        const float u = x / softcap;
        chain = 1.f - u * u;
      }
      float d = (expf(x - lt) - (id == lab ? 1.f : 0.f)) * gt;
      if (softcap != 0.f) d *= chain;
      stage[(ll)tl * V + id] = d;
    }
  }
}

// C[m, n] (+)= sum_k A[m, k] B[k, n], strided operands, fp32 result.
template <typename TA, typename TB>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const TA* __restrict__ A, ll sa_m, ll sa_k,
            const TB* __restrict__ B, ll sb_k, ll sb_n, float* __restrict__ C,
            ll sc_m, ll sc_n, int M, int N, int K, int accumulate) {
  __shared__ float sA[BKK * LA];
  __shared__ float sB[BKK * LB];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[RM][RN];
  zero(acc);
  mm_tile(A, sa_m, sa_k, B, sb_k, sb_n, M, N, K, m0, n0, acc, sA, sB);
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int m = m0 + ty * RM + r;
#pragma unroll
    for (int c = 0; c < RN; ++c) {
      const int n = n0 + tx + 16 * c;
      if (m < M && n < N) {
        float* p = C + m * sc_m + n * sc_n;
        *p = accumulate ? *p + acc[r][c] : acc[r][c];
      }
    }
  }
}

inline dim3 tiles(int rows, int cols) {
  return dim3((cols + BN - 1) / BN, (rows + BM - 1) / BM);
}

template <typename TH, typename TW>
cudaError_t xent_fwd_impl(const void* h, const void* w, const int* labels,
                          float* loss, float* lse, float* part, int T, int D,
                          int V, ll sw_d, ll sw_v, float softcap, int nsplit,
                          cudaStream_t st) {
  const int v_per_split = ((V + nsplit - 1) / nsplit + BN - 1) / BN * BN;
  const dim3 grid((T + BM - 1) / BM, nsplit);
  xent_fwd_kernel<TH, TW><<<grid, kThreads, 0, st>>>(
      (const TH*)h, (const TW*)w, labels, part, T, D, V, sw_d, sw_v, softcap,
      v_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  xent_combine_kernel<<<(T + 255) / 256, 256, 0, st>>>(part, loss, lse, T,
                                                       nsplit);
  return cudaGetLastError();
}

template <typename TH, typename TW>
cudaError_t xent_bwd_impl(const void* hv, const void* wv, const int* labels,
                          const float* lse, const float* g, float* dh,
                          float* dw, float* stage, int T, int D, int V,
                          ll sw_d, ll sw_v, ll sdw_d, ll sdw_v, float softcap,
                          int chunk, cudaStream_t st) {
  const TH* h = (const TH*)hv;
  const TW* w = (const TW*)wv;
  for (int t_begin = 0; t_begin < T; t_begin += chunk) {
    const int tc = min(chunk, T - t_begin);
    xent_dlogits_kernel<TH, TW><<<tiles(tc, V), kThreads, 0, st>>>(
        h, w, labels, lse, g, stage, t_begin, tc, D, V, sw_d, sw_v, softcap);
    // dH[chunk] = dlogits @ w^T   (M = tc, N = D, K = V)
    gemm_kernel<float, TW><<<tiles(tc, D), kThreads, 0, st>>>(
        stage, (ll)V, 1LL, w, sw_v, sw_d, dh + (ll)t_begin * D, (ll)D, 1LL,
        tc, D, V, 0);
    // dW (+)= h[chunk]^T @ dlogits, oriented so the output stride is unit
    const int acc = t_begin > 0;
    if (sdw_v != 1 && sdw_d == 1) {  // (V, D) storage: write dW^T tiles
      gemm_kernel<float, TH><<<tiles(V, D), kThreads, 0, st>>>(
          stage, 1LL, (ll)V, h + (ll)t_begin * D, (ll)D, 1LL, dw, sdw_v,
          sdw_d, V, D, tc, acc);
    } else {
      gemm_kernel<TH, float><<<tiles(D, V), kThreads, 0, st>>>(
          h + (ll)t_begin * D, 1LL, (ll)D, stage, (ll)V, 1LL, dw, sdw_d,
          sdw_v, D, V, tc, acc);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" int rt_xent_fwd(const void* h, const void* w, const void* labels,
                           void* loss, void* lse, void* part, int h_dtype,
                           int w_dtype, int T, int D, int V, long long sw_d,
                           long long sw_v, float softcap, int nsplit,
                           void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int* lab = (const int*)labels;
  float *lo = (float*)loss, *ls = (float*)lse, *pt = (float*)part;
  const bool hb = h_dtype == rt::kBFloat16, wb = w_dtype == rt::kBFloat16;
  if ((!hb && h_dtype != rt::kFloat32) || (!wb && w_dtype != rt::kFloat32))
    return (int)cudaErrorInvalidValue;
  if (hb && wb)
    return (int)xent_fwd_impl<__nv_bfloat16, __nv_bfloat16>(
        h, w, lab, lo, ls, pt, T, D, V, sw_d, sw_v, softcap, nsplit, st);
  if (hb)
    return (int)xent_fwd_impl<__nv_bfloat16, float>(
        h, w, lab, lo, ls, pt, T, D, V, sw_d, sw_v, softcap, nsplit, st);
  if (wb)
    return (int)xent_fwd_impl<float, __nv_bfloat16>(
        h, w, lab, lo, ls, pt, T, D, V, sw_d, sw_v, softcap, nsplit, st);
  return (int)xent_fwd_impl<float, float>(h, w, lab, lo, ls, pt, T, D, V,
                                          sw_d, sw_v, softcap, nsplit, st);
}

extern "C" int rt_xent_bwd(const void* h, const void* w, const void* labels,
                           const void* lse, const void* g, void* dh, void* dw,
                           void* stage, int h_dtype, int w_dtype, int T, int D,
                           int V, long long sw_d, long long sw_v,
                           long long sdw_d, long long sdw_v, float softcap,
                           int chunk, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int* lab = (const int*)labels;
  const float *ls = (const float*)lse, *gg = (const float*)g;
  float *dhp = (float*)dh, *dwp = (float*)dw, *sp = (float*)stage;
  const bool hb = h_dtype == rt::kBFloat16, wb = w_dtype == rt::kBFloat16;
  if ((!hb && h_dtype != rt::kFloat32) || (!wb && w_dtype != rt::kFloat32) ||
      chunk <= 0)
    return (int)cudaErrorInvalidValue;
  if (hb && wb)
    return (int)xent_bwd_impl<__nv_bfloat16, __nv_bfloat16>(
        h, w, lab, ls, gg, dhp, dwp, sp, T, D, V, sw_d, sw_v, sdw_d, sdw_v,
        softcap, chunk, st);
  if (hb)
    return (int)xent_bwd_impl<__nv_bfloat16, float>(
        h, w, lab, ls, gg, dhp, dwp, sp, T, D, V, sw_d, sw_v, sdw_d, sdw_v,
        softcap, chunk, st);
  if (wb)
    return (int)xent_bwd_impl<float, __nv_bfloat16>(
        h, w, lab, ls, gg, dhp, dwp, sp, T, D, V, sw_d, sw_v, sdw_d, sdw_v,
        softcap, chunk, st);
  return (int)xent_bwd_impl<float, float>(h, w, lab, ls, gg, dhp, dwp, sp, T,
                                          D, V, sw_d, sw_v, sdw_d, sdw_v,
                                          softcap, chunk, st);
}
