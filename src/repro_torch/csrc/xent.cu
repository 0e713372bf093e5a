// Fused vocabulary-tiled cross-entropy for Hopper: forward and backward.
//
// Replaces the TPU Pallas kernels
//   repro/kernels/xent/kernel.py::xent_fwd  (pallas_call :126)
//   repro/kernels/xent/kernel.py::xent_bwd  (:281 partials, :299 alias)
// with the same math: per token, online (max, sum-exp, correct logit) over
// vocabulary tiles of z = h @ w, optional final softcap s = cap*tanh(z/cap),
// vocabulary padding masked with -1e30; backward
// dlogits = (softmax - onehot) * g * (1 - (s/cap)^2),
// dH = dlogits @ w^T, dW = h^T @ dlogits.  The (T, V) logits are never
// materialized whole.
//
// h (T, D) is fp32 or bf16 and contiguous; w (D, V) is fp32 or bf16 with
// arbitrary element strides, so the tied auxiliary head (a transposed view
// of the (V, D) embedding table) is read in place with no copy; dw is
// written with the strides the caller gives (the wrapper hands the tied
// case a (V, D) buffer, which reaches the embedding gradient untransposed).
//
// What bounds it on the H100: the three contractions (logits, dH, dW) carry
// 2*T*D*V flops each over operands that are read once, so every call is
// bound by operations by a wide margin.  Two routes, chosen by h's dtype:
//
// bf16 h (the main path): the tensor cores (tensor_core.cuh), warp-level
// mma.sync m16n8k16 bf16 -> fp32.  A pre-pass (xent_split_kernel) turns w
// into W_hi = bf16(w) and, for an fp32 w, W_lo = bf16(w - W_hi), both
// (Vp, D) row-major with Vp = V rounded up to the 128-wide vocabulary tile
// and zeros past V, whatever w's strides: the tied and the untied head
// reach the products in one layout.  h is bf16 and exact, so the logits
// take two passes (h W_hi + h W_lo) into one fp32 fragment, which keeps the
// fp32 reference's 1e-4 checks (the pair carries w to ~2^-17 relative).
// Every product runs on one tile loop (tc_tile): a 128 x 128 output tile
// per 256-thread CTA, 8 warps as 2 x 4 of 64 x 32 outputs, 32-deep k
// chunks through a ring of three cp.async stages of bf16 rows padded by
// 16 B (conflict-free ldmatrix), one barrier per chunk.  Each 16-deep
// k-step's passes go into a fresh fragment that is then added to the fp32
// accumulator: the tensor cores round their sums toward zero, which over
// dH's K = V (~1e4 k-steps) drifted by ~3e-4 relative.  The forward's
// epilogue keeps each thread's online (max, sum-exp) over its own columns
// and merges the quad and the 4 column warps once per vocabulary split;
// the label's logit goes to shared memory from the one thread that holds
// it.  The backward's dlogits kernel is the forward's loop with an
// epilogue that writes dlogits already split, as bf16 hi and lo, into a
// staging buffer (the same bytes as an fp32 one); dH = dl W takes 3 passes
// (hi.hi, hi.lo, lo.hi; lo.lo is ~2^-16 relative and dropped), dW = h^T dl
// 2 (dl hi and lo against the exact h), both with the split operands
// through ldmatrix(.trans) from the same ring.  A bf16 w has no lo half:
// one pass fewer in the logits and in dH.  Pass counts: forward 2,
// backward 7 (fp32 w); 1 and 5 (bf16 w).  What bounds these kernels now is
// the per-warp operand work, not the tensor cores: without W_lo the
// forward keeps ~0.7 of its time (not 0.5), and a taller CTA tile, which
// cuts the L2 bytes per flop by a third, ran no faster.  Every B fragment
// is loaded twice (hi, lo) by ldmatrix, and every k-step's fresh fragment
// costs four fp32 adds; wgmma with TMA is the next lever.
//
// fp32 h (only the split step's fp32 pass): fp32 FMAs on the CUDA cores
// (the reference upcasts both operands to fp32), 64 x 64 output tiles per
// 256-thread CTA, 4 x 4 outputs per thread, 32-deep k chunks staged in
// shared memory with a loader that follows whichever operand stride is
// unit so global reads coalesce in both head layouts.
//
// Forward (both routes): one CTA per (token tile, vocabulary split),
// looping over the split's vocabulary tiles with the row statistics on
// chip; a second small kernel merges the splits' (m, l, c) exactly as
// the online softmax merges tiles.  The split count is chosen by the
// wrapper (CUDA cores) or by xent_tc_nsplit (tensor cores) so that the grid
// fills the 132 SMs in whole waves.
//
// Backward (both routes): the TPU kernel summed dH across vocabulary tiles
// through an aliased HBM buffer (sequential grid) and kept the dW tile
// resident in VMEM.  Neither carries over: a dW tile (D x bv) does not fit
// one SM, and dH atomics would be revisited once per vocabulary tile.
// Instead the tokens are processed in chunks of `chunk` rows: one kernel
// recomputes each logits tile of the chunk exactly once and writes
// dlogits into a bounded staging buffer (chunk x V), then two tiled
// products form dH[chunk] = dlogits @ w^T and dW += h[chunk]^T @ dlogits.
// No atomics: the backward is deterministic.  The wrapper bounds the
// staging buffer at 4 GiB, so both main paths' shapes run in one chunk.
#include <cstdint>

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

using rt::kNegInf;
using rt::kThreads;
using rt::to_f32;
typedef long long ll;

// ---------------------------------------------------------------------------
// fp32 h: the CUDA-core kernels
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// bf16 h: the tensor-core kernels
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int TBM = 128, TBN = 128, TBK = 32;  // CTA output tile, k chunk
constexpr int kStages = 3;                     // cp.async ring
constexpr int kTcCtasPerSm = 2;                // launch bounds and SMEM
constexpr int LDK = TBK + 8;   // [row][k] tiles: 128 rows of 40 bf16
constexpr int LDR = TBN + 8;   // [k][row] tiles: 32 rows of 136 bf16
constexpr int kTileRK = TBM * LDK, kTileKR = TBK * LDR;  // elements
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// Rows [r0, r0 + R) x columns [c0, c0 + C) of a row-major bf16 matrix
// (leading dimension ld, nrows x ncols, ncols % 8 == 0) into shared rows of
// stride LDS, 16 B a copy; elements outside the matrix read as zeros.
template <int R, int C, int LDS>
__device__ __forceinline__ void tc_load(bf16* dst, const bf16* src, ll ld,
                                        int r0, int c0, int nrows,
                                        int ncols) {
  constexpr int CH = C / 8;
  for (int e = threadIdx.x; e < R * CH; e += kThreads) {
    const int r = e / CH, c = e % CH * 8;
    const bool in = r0 + r < nrows && c0 + c < ncols;
    rt::cp_async16(dst + r * LDS + c,
                   in ? src + (ll)(r0 + r) * ld + c0 + c : src, in ? 16 : 0);
  }
}

// One operand of a product: hi (and lo) halves of a row-major bf16 matrix
// of rows x cols.  kKMajor: its rows run along k ([k][m] for A, [k][n] for
// B); otherwise along the output ([m][k] for A, [n][k] for B).
struct TcOperand {
  const bf16* hi;
  const bf16* lo;
  ll ld;
  int rows, cols;
};

template <bool kKMajor>
__host__ __device__ constexpr int tc_tile_elems() {
  return kKMajor ? kTileKR : kTileRK;
}

template <bool kAKM, bool kBKN, bool kALo, bool kBLo>
__host__ __device__ constexpr size_t tc_smem_bytes() {
  return (size_t)kStages *
         ((1 + kALo) * tc_tile_elems<kAKM>() +
          (1 + kBLo) * tc_tile_elems<kBKN>()) * sizeof(bf16);
}

// acc += A[m0 : m0 + 128, 0 : K] B[0 : K, n0 : n0 + 128] over bf16 hi/lo
// operands (lo.lo dropped), each warp's 64 x 32 block as 4 x 4 mma tiles:
// acc[i][n] is rows 16 i + (g, g + 8), columns 8 n + 2 t + (0, 1) of the
// warp's block.  Only the first m_valid rows and n_valid columns of the
// tile are wanted: a warp skips its 16-row blocks past them, and all of
// its products when its columns are.  Ends with every copy landed and
// every warp past its last read, so the caller may start another tile at
// once.
template <bool kAKM, bool kBKN, bool kALo, bool kBLo>
__device__ __forceinline__ void tc_tile(float (&acc)[4][4][4],
                                        const TcOperand& A,
                                        const TcOperand& B, int m0, int n0,
                                        int K, int m_valid, int n_valid,
                                        bf16* smem) {
  constexpr int EA = tc_tile_elems<kAKM>(), EB = tc_tile_elems<kBKN>();
  constexpr int STAGE = (1 + kALo) * EA + (1 + kBLo) * EB;
  const int warp = threadIdx.x / 32;
  const int wm = warp / 4 * 64, wn = warp % 4 * 32;
  const int nk = (K + TBK - 1) / TBK;
  // 16-row blocks of this warp with wanted rows (warp-uniform)
  const int m_blocks = wn < n_valid ? min(4, max(0, (m_valid - wm + 15) / 16))
                                    : 0;

  auto load = [&](int kc, int stage) {
    bf16* s = smem + stage * STAGE;
    const int k0 = kc * TBK;
    for (int h = 0; h < 1 + kALo; ++h, s += EA) {
      const bf16* src = h ? A.lo : A.hi;
      if (kAKM)
        tc_load<TBK, TBM, LDR>(s, src, A.ld, k0, m0, A.rows, A.cols);
      else
        tc_load<TBM, TBK, LDK>(s, src, A.ld, m0, k0, A.rows, A.cols);
    }
    for (int h = 0; h < 1 + kBLo; ++h, s += EB) {
      const bf16* src = h ? B.lo : B.hi;
      if (kBKN)
        tc_load<TBK, TBN, LDR>(s, src, B.ld, k0, n0, B.rows, B.cols);
      else
        tc_load<TBN, TBK, LDK>(s, src, B.ld, n0, k0, B.rows, B.cols);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    rt::cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    rt::cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk kc landed; every warp is done with kc - 1
    if (kc + kStages - 1 < nk) load(kc + kStages - 1, (kc + kStages - 1) %
                                                          kStages);
    rt::cp_async_commit();
    const bf16* sA = smem + kc % kStages * STAGE;
    const bf16* sB = sA + (1 + kALo) * EA;
    if (m_blocks == 0) continue;
#pragma unroll
    for (int kk = 0; kk < TBK / 16; ++kk) {
      uint32_t bh[2][4], bl[2][4];  // n-tiles (0, 1) and (2, 3)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int off = kBKN ? rt::tc_bkn_off(kk * 16, wn + 16 * j, LDR)
                             : rt::tc_bnk_off(wn + 16 * j, kk * 16, LDK);
        if (kBKN) rt::ldmatrix_x4_trans(bh[j], sB + off);
        else rt::ldmatrix_x4(bh[j], sB + off);
        if (kBLo) {
          if (kBKN) rt::ldmatrix_x4_trans(bl[j], sB + EB + off);
          else rt::ldmatrix_x4(bl[j], sB + EB + off);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i >= m_blocks) break;
        const int off = kAKM ? rt::tc_akm_off(kk * 16, wm + 16 * i, LDR)
                             : rt::tc_a_off(wm + 16 * i, kk * 16, LDK);
        uint32_t a[4], al[4];
        if (kAKM) rt::ldmatrix_x4_trans(a, sA + off);
        else rt::ldmatrix_x4(a, sA + off);
        if (kALo) {
          if (kAKM) rt::ldmatrix_x4_trans(al, sA + EA + off);
          else rt::ldmatrix_x4(al, sA + EA + off);
        }
        // this k-step's passes into a fresh fragment, then one fp32 add
        // each (rounded to nearest: see rt::mma_bf16_zc)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const uint32_t* b = bh[n / 2] + 2 * (n % 2);
          float t[4];
          rt::mma_bf16_zc(t, a, b[0], b[1]);
          if (kBLo) {
            const uint32_t* c = bl[n / 2] + 2 * (n % 2);
            rt::mma_bf16(t, a, c[0], c[1]);
          }
          if (kALo) rt::mma_bf16(t, al, b[0], b[1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][n][e] += t[e];
        }
      }
    }
  }
  rt::cp_async_wait<0>();
  __syncthreads();
}

__device__ __forceinline__ void tc_zero(float (&acc)[4][4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
}

// W_hi (and, kLo, W_lo) (Vp, D) row-major from w (D, V) of any strides,
// zeros past V; a 64 x 64 tile per CTA through shared memory, read along
// whichever stride of w is unit.
template <typename TW, bool kLo>
__global__ void __launch_bounds__(kThreads)
xent_split_kernel(const TW* __restrict__ w, ll sw_d, ll sw_v,
                  bf16* __restrict__ hi, bf16* __restrict__ lo, int D, int V) {
  __shared__ float tile[64][65];
  const int v0 = blockIdx.x * 64, d0 = blockIdx.y * 64;
  for (int e = threadIdx.x; e < 64 * 64; e += kThreads) {
    const int v = sw_v == 1 ? e % 64 : e / 64;
    const int d = sw_v == 1 ? e / 64 : e % 64;
    const int gv = v0 + v, gd = d0 + d;
    tile[v][d] = gv < V && gd < D ? to_f32(w[gd * sw_d + gv * sw_v]) : 0.f;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 64 * 32; e += kThreads) {
    const int v = e / 32, d = e % 32 * 2, gd = d0 + d;
    if (gd >= D) continue;
    uint32_t h, l;
    rt::split_bf16x2(tile[v][d], tile[v][d + 1], h, l);
    const ll at = (ll)(v0 + v) * D + gd;
    *reinterpret_cast<uint32_t*>(hi + at) = h;
    if (kLo) *reinterpret_cast<uint32_t*>(lo + at) = l;
  }
}

// Forward (kDlogits false): partial (m, l, c) per token over one vocabulary
// split into part (3, nsplit, T).  Backward step 1 (kDlogits true): the
// dlogits of tokens [t_begin, t_begin + t_count) into stage hi/lo
// (t_count, Vp), each logits tile recomputed once.  One CTA per (128-token
// tile, split of tiles_per_split vocabulary tiles).
template <bool kLo, bool kDlogits>
__global__ void __launch_bounds__(kThreads, kTcCtasPerSm)
xent_tc_logits_kernel(const bf16* __restrict__ h,
                      const bf16* __restrict__ w_hi,
                      const bf16* __restrict__ w_lo,
                      const int* __restrict__ labels,
                      const float* __restrict__ lse,
                      const float* __restrict__ g, float* __restrict__ part,
                      bf16* __restrict__ st_hi, bf16* __restrict__ st_lo,
                      int t_begin, int t_count, int D, int V, int Vp,
                      float softcap, int tiles_per_split) {
  extern __shared__ __align__(16) bf16 smem_bf[];
  __shared__ int s_lab[TBM];
  __shared__ float s_c[TBM];
  // forward: this thread's (max, sum-exp) of row 2 i + half over its own
  // columns, in base 2 (x log2 e), at [r][tid] and [8 + r][tid]; kept out
  // of the registers that the tile loop needs
  __shared__ float s_stat[kDlogits ? 1 : 16][kThreads];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g4 = lane / 4, t4 = lane % 4;
  const int wm = warp / 4 * 64, wn = warp % 4 * 32, wc = warp % 4;
  const int t0 = blockIdx.x * TBM, split = blockIdx.y;
  const int nv = Vp / TBN;
  const int vt_begin = split * tiles_per_split;
  const int vt_end = min(nv, vt_begin + tiles_per_split);
  for (int r = threadIdx.x; r < TBM; r += kThreads) {
    s_lab[r] = t0 + r < t_count ? labels[t_begin + t0 + r] : -1;
    s_c[r] = 0.f;
  }
  const TcOperand A{h + (ll)t_begin * D, nullptr, (ll)D, t_count, D};
  const TcOperand B{w_hi, w_lo, (ll)D, Vp, D};

  const int tid = threadIdx.x;
  if (!kDlogits)
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      s_stat[r][tid] = kNegInf * kLog2e;
      s_stat[8 + r][tid] = 0.f;
    }
  for (int vt = vt_begin; vt < vt_end; ++vt) {
    const int v0 = vt * TBN;
    float acc[4][4][4];
    tc_zero(acc);
    tc_tile<false, false, false, kLo>(acc, A, B, t0, v0, D, t_count - t0,
                                      V - v0, smem_bf);
    const bool whole = v0 + TBN <= V;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = wm + 16 * i + g4 + 8 * half;  // in the token tile
        const int lab = s_lab[row];
        if (kDlogits) {
          const int tl = t0 + row;
          if (tl >= t_count) continue;
          const float lse2 = lse[t_begin + tl] * kLog2e;
          const float gt = g[t_begin + tl];
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int col = v0 + wn + 8 * n + 2 * t4;
            float d[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              float x = acc[i][n][2 * half + c], chain = 1.f;
              if (softcap != 0.f) {
                const float u = tanhf(x / softcap);
                x = u * softcap;
                chain = 1.f - u * u;
              }
              const float p = exp2f(fmaf(x, kLog2e, -lse2));
              d[c] = col + c < V
                         ? (p - (col + c == lab ? 1.f : 0.f)) * gt * chain
                         : 0.f;
            }
            uint32_t hi, lo;
            rt::split_bf16x2(d[0], d[1], hi, lo);
            const ll at = (ll)tl * Vp + col;
            *reinterpret_cast<uint32_t*>(st_hi + at) = hi;
            *reinterpret_cast<uint32_t*>(st_lo + at) = lo;
          }
        } else {
          // statistics in base 2 (x log2 e), each exponential one exp2f of
          // a difference: an fma against a rounded product would leave
          // the ulp of -1e30 log2 e (~1e23) in the exponent
          const int r = 2 * i + half;
          const float m_old = s_stat[r][tid];
          float mx = m_old;
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int col = v0 + wn + 8 * n + 2 * t4 + c;
              float x = acc[i][n][2 * half + c];
              if (softcap != 0.f) x = tanhf(x / softcap) * softcap;
              if (!whole && col >= V) x = kNegInf;
              if (col == lab) s_c[row] = x;
              x *= kLog2e;
              acc[i][n][2 * half + c] = x;
              mx = fmaxf(mx, x);
            }
          float ps = 0.f;
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              ps += exp2f(acc[i][n][2 * half + c] - mx);
          s_stat[8 + r][tid] = s_stat[8 + r][tid] * exp2f(m_old - mx) + ps;
          s_stat[r][tid] = mx;
        }
      }
  }
  if (kDlogits) return;

  // merge this thread's statistics with its quad's, then the 4 column
  // warps' through the (now idle) pipeline buffers
  float* s_m = reinterpret_cast<float*>(smem_bf);  // [4][TBM]
  float* s_l = s_m + 4 * TBM;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    float m = s_stat[r][tid], l = s_stat[8 + r][tid];
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m, o);
      const float lo = __shfl_xor_sync(0xffffffffu, l, o);
      const float mn = fmaxf(m, mo);
      l = l * exp2f(m - mn) + lo * exp2f(mo - mn);
      m = mn;
    }
    if (t4 == 0) {
      const int row = wm + 16 * (r / 2) + g4 + 8 * (r % 2);
      s_m[wc * TBM + row] = m;
      s_l[wc * TBM + row] = l;
    }
  }
  __syncthreads();
  const int nsplit = gridDim.y, T = t_count;
  for (int row = threadIdx.x; row < TBM; row += kThreads) {
    const int t = t0 + row;
    if (t >= T) continue;
    float m = kNegInf * kLog2e, l = 0.f;
    for (int w = 0; w < 4; ++w) m = fmaxf(m, s_m[w * TBM + row]);
    for (int w = 0; w < 4; ++w)
      l += s_l[w * TBM + row] * exp2f(s_m[w * TBM + row] - m);
    part[((ll)0 * nsplit + split) * T + t] = m * kLn2;
    part[((ll)1 * nsplit + split) * T + t] = l;
    part[((ll)2 * nsplit + split) * T + t] = s_c[row];
  }
}

// C[m0 : m0 + 128, n0 : n0 + 128] (+)= A B over the split operands, written
// at C + m * sc_m + n * sc_n for m < M, n < N.  B is k-major ([k][n]); A is
// [k][m] (kAKM) or [m][k].
template <bool kAKM, bool kALo, bool kBLo>
__global__ void __launch_bounds__(kThreads, kTcCtasPerSm)
xent_tc_gemm_kernel(TcOperand A, TcOperand B, float* __restrict__ C,
                    ll sc_m, ll sc_n, int M, int N, int K, int accumulate) {
  extern __shared__ __align__(16) bf16 smem_bf[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g4 = lane / 4, t4 = lane % 4;
  const int m0 = blockIdx.y * TBM, n0 = blockIdx.x * TBN;
  const int wm = m0 + warp / 4 * 64, wn = n0 + warp % 4 * 32;
  float acc[4][4][4];
  tc_zero(acc);
  tc_tile<kAKM, true, kALo, kBLo>(acc, A, B, m0, n0, K, M - m0, N - n0,
                                  smem_bf);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = wm + 16 * i + g4 + 8 * (e >> 1);
      if (m >= M) continue;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = wn + 8 * n + 2 * t4 + (e & 1);
        if (col >= N) continue;
        float* p = C + m * sc_m + col * sc_n;
        *p = accumulate ? *p + acc[i][n][e] : acc[i][n][e];
      }
    }
}

// Vocabulary splits of a forward or dlogits grid over T tokens: at least
// about 4 waves of kTcCtasPerSm CTAs per SM where the vocabulary allows,
// with the last wave as full as a split count up to twice that can make it.
int xent_tc_nsplit_impl(int T, int V, int sms) {
  const int nt = (T + TBM - 1) / TBM, nv = (V + TBN - 1) / TBN;
  const int slots = max(1, sms) * kTcCtasPerSm;
  const int n0 = max(1, min(nv, (4 * slots + nt - 1) / nt));
  int best = n0;
  double best_eff = -1.0;
  for (int n = n0; n <= min(nv, 2 * n0); ++n) {
    const int per = (nv + n - 1) / n, used = (nv + per - 1) / per;
    const ll ctas = (ll)nt * used, waves = (ctas + slots - 1) / slots;
    const double eff = (double)nt * nv / ((double)waves * slots * per);
    if (eff > best_eff + 1e-9) {
      best_eff = eff;
      best = used;
    }
  }
  return best;
}

template <typename TK>
cudaError_t set_smem(TK kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

cudaError_t xent_split(const void* w, int w_dtype, ll sw_d, ll sw_v,
                       bf16* hi, bf16* lo, int D, int V, int Vp,
                       cudaStream_t st) {
  const dim3 grid(Vp / 64, (D + 63) / 64);
  if (w_dtype == rt::kBFloat16)
    xent_split_kernel<bf16, false><<<grid, kThreads, 0, st>>>(
        (const bf16*)w, sw_d, sw_v, hi, lo, D, V);
  else
    xent_split_kernel<float, true><<<grid, kThreads, 0, st>>>(
        (const float*)w, sw_d, sw_v, hi, lo, D, V);
  return cudaGetLastError();
}

template <bool kLo, bool kDlogits>
cudaError_t launch_tc_logits(const bf16* h, const bf16* w_hi,
                             const bf16* w_lo, const int* labels,
                             const float* lse, const float* g, float* part,
                             bf16* st_hi, bf16* st_lo, int t_begin,
                             int t_count, int D, int V, int Vp, float softcap,
                             int nsplit, cudaStream_t st) {
  constexpr size_t smem = tc_smem_bytes<false, false, false, kLo>();
  auto kernel = xent_tc_logits_kernel<kLo, kDlogits>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int nv = Vp / TBN, per = (nv + nsplit - 1) / nsplit;
  const dim3 grid((t_count + TBM - 1) / TBM, nsplit);
  kernel<<<grid, kThreads, smem, st>>>(h, w_hi, w_lo, labels, lse, g, part,
                                       st_hi, st_lo, t_begin, t_count, D, V,
                                       Vp, softcap, per);
  return cudaGetLastError();
}

template <bool kAKM, bool kALo, bool kBLo>
cudaError_t launch_tc_gemm(const TcOperand& A, const TcOperand& B, float* C,
                           ll sc_m, ll sc_n, int M, int N, int K,
                           int accumulate, cudaStream_t st) {
  constexpr size_t smem = tc_smem_bytes<kAKM, true, kALo, kBLo>();
  auto kernel = xent_tc_gemm_kernel<kAKM, kALo, kBLo>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TBN - 1) / TBN, (M + TBM - 1) / TBM);
  kernel<<<grid, kThreads, smem, st>>>(A, B, C, sc_m, sc_n, M, N, K,
                                       accumulate);
  return cudaGetLastError();
}

// the tensor-core route takes 16-B rows of h for cp.async
bool tc_rejects(const void* h, int D, int w_dtype) {
  return D % 8 != 0 || reinterpret_cast<uintptr_t>(h) % 16 != 0 ||
         (w_dtype != rt::kFloat32 && w_dtype != rt::kBFloat16);
}

}  // namespace

extern "C" int rt_xent_tc_nsplit(int T, int V, int sms) {
  return xent_tc_nsplit_impl(T, V, sms);
}

// fp32 h (CUDA cores): w fp32 or bf16
extern "C" int rt_xent_fwd(const void* h, const void* w, const void* labels,
                           void* loss, void* lse, void* part, int h_dtype,
                           int w_dtype, int T, int D, int V, long long sw_d,
                           long long sw_v, float softcap, int nsplit,
                           void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int* lab = (const int*)labels;
  float *lo = (float*)loss, *ls = (float*)lse, *pt = (float*)part;
  if (h_dtype != rt::kFloat32 ||
      (w_dtype != rt::kFloat32 && w_dtype != rt::kBFloat16))
    return (int)cudaErrorInvalidValue;
  if (w_dtype == rt::kBFloat16)
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
  if (h_dtype != rt::kFloat32 ||
      (w_dtype != rt::kFloat32 && w_dtype != rt::kBFloat16) || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  if (w_dtype == rt::kBFloat16)
    return (int)xent_bwd_impl<float, __nv_bfloat16>(
        h, w, lab, ls, gg, dhp, dwp, sp, T, D, V, sw_d, sw_v, sdw_d, sdw_v,
        softcap, chunk, st);
  return (int)xent_bwd_impl<float, float>(h, w, lab, ls, gg, dhp, dwp, sp, T,
                                          D, V, sw_d, sw_v, sdw_d, sdw_v,
                                          softcap, chunk, st);
}

// The split pre-pass alone: w (D, V) of any strides into W_hi (and, for an
// fp32 w, W_lo), (Vp, D) bf16 row-major.
extern "C" int rt_xent_split(const void* w, void* w_hi, void* w_lo,
                             int w_dtype, int D, int V, long long sw_d,
                             long long sw_v, void* stream) {
  if (w_dtype != rt::kFloat32 && w_dtype != rt::kBFloat16)
    return (int)cudaErrorInvalidValue;
  const int Vp = (V + TBN - 1) / TBN * TBN;
  return (int)xent_split(w, w_dtype, sw_d, sw_v, (bf16*)w_hi, (bf16*)w_lo, D,
                         V, Vp, (cudaStream_t)stream);
}

// bf16 h (tensor cores): w fp32 (split into W_hi, W_lo) or bf16 (W_hi
// only; w_lo unused).  w_hi, w_lo: (Vp, D) bf16 scratch; part (3, nsplit,
// T) with nsplit from rt_xent_tc_nsplit(T, V, sms).
extern "C" int rt_xent_fwd_tc(const void* h, const void* w,
                              const void* labels, void* loss, void* lse,
                              void* part, void* w_hi, void* w_lo, int w_dtype,
                              int T, int D, int V, long long sw_d,
                              long long sw_v, float softcap, int nsplit,
                              void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (tc_rejects(h, D, w_dtype) || nsplit <= 0)
    return (int)cudaErrorInvalidValue;
  const int Vp = (V + TBN - 1) / TBN * TBN;
  bf16 *hi = (bf16*)w_hi, *lo = (bf16*)w_lo;
  cudaError_t err = xent_split(w, w_dtype, sw_d, sw_v, hi, lo, D, V, Vp, st);
  if (err != cudaSuccess) return (int)err;
  const bf16* hb = (const bf16*)h;
  const int* lab = (const int*)labels;
  float* pt = (float*)part;
  err = w_dtype == rt::kFloat32
            ? launch_tc_logits<true, false>(hb, hi, lo, lab, nullptr, nullptr,
                                            pt, nullptr, nullptr, 0, T, D, V,
                                            Vp, softcap, nsplit, st)
            : launch_tc_logits<false, false>(hb, hi, lo, lab, nullptr,
                                             nullptr, pt, nullptr, nullptr, 0,
                                             T, D, V, Vp, softcap, nsplit, st);
  if (err != cudaSuccess) return (int)err;
  xent_combine_kernel<<<(T + 255) / 256, 256, 0, st>>>(
      pt, (float*)loss, (float*)lse, T, nsplit);
  return (int)cudaGetLastError();
}

// st_hi, st_lo: (chunk, Vp) bf16 staging of the split dlogits; dw with the
// strides (sdw_d, sdw_v) the caller gives ((V, D) storage when sdw_d == 1).
extern "C" int rt_xent_bwd_tc(const void* h, const void* w,
                              const void* labels, const void* lse,
                              const void* g, void* dh, void* dw, void* w_hi,
                              void* w_lo, void* st_hi, void* st_lo,
                              int w_dtype, int T, int D, int V,
                              long long sw_d, long long sw_v, long long sdw_d,
                              long long sdw_v, float softcap, int chunk,
                              int sms, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (tc_rejects(h, D, w_dtype) || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  const bool w_lo_used = w_dtype == rt::kFloat32;
  const int Vp = (V + TBN - 1) / TBN * TBN;
  bf16 *hi = (bf16*)w_hi, *lo = (bf16*)w_lo;
  bf16 *sh = (bf16*)st_hi, *sl = (bf16*)st_lo;
  cudaError_t err = xent_split(w, w_dtype, sw_d, sw_v, hi, lo, D, V, Vp, st);
  if (err != cudaSuccess) return (int)err;
  const bf16* hb = (const bf16*)h;
  const int* lab = (const int*)labels;
  const float *ls = (const float*)lse, *gg = (const float*)g;
  float *dhp = (float*)dh, *dwp = (float*)dw;
  const bool tied = sdw_d == 1 && sdw_v != 1;  // (V, D) storage
  for (int t_begin = 0; t_begin < T; t_begin += chunk) {
    const int tc = min(chunk, T - t_begin);
    const int nsplit = xent_tc_nsplit_impl(tc, V, sms);
    err = w_lo_used
              ? launch_tc_logits<true, true>(hb, hi, lo, lab, ls, gg, nullptr,
                                             sh, sl, t_begin, tc, D, V, Vp,
                                             softcap, nsplit, st)
              : launch_tc_logits<false, true>(hb, hi, lo, lab, ls, gg,
                                              nullptr, sh, sl, t_begin, tc, D,
                                              V, Vp, softcap, nsplit, st);
    if (err != cudaSuccess) return (int)err;
    // dH[chunk] = dl W: A = dl [t][v], B = W [v][d]
    const TcOperand dl_tv{sh, sl, (ll)Vp, tc, Vp};
    const TcOperand w_vd{hi, lo, (ll)D, Vp, D};
    err = w_lo_used
              ? launch_tc_gemm<false, true, true>(dl_tv, w_vd,
                                                  dhp + (ll)t_begin * D, D, 1,
                                                  tc, D, Vp, 0, st)
              : launch_tc_gemm<false, true, false>(dl_tv, w_vd,
                                                   dhp + (ll)t_begin * D, D,
                                                   1, tc, D, Vp, 0, st);
    if (err != cudaSuccess) return (int)err;
    // dW (+)= h[chunk]^T dl over the chunk's tokens, oriented so the
    // output's unit stride runs along the tile's columns
    const TcOperand h_td{hb + (ll)t_begin * D, nullptr, (ll)D, tc, D};
    const int acc = t_begin > 0;
    err = tied ? launch_tc_gemm<true, true, false>(dl_tv, h_td, dwp, sdw_v,
                                                   sdw_d, V, D, tc, acc, st)
               : launch_tc_gemm<true, false, true>(h_td, dl_tv, dwp, sdw_d,
                                                   sdw_v, D, V, tc, acc, st);
    if (err != cudaSuccess) return (int)err;
  }
  return cudaSuccess;
}
