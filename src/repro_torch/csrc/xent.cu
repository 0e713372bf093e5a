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
// bound by operations by a wide margin.  Every product runs on the tensor
// cores (tensor_core.cuh), warp-level mma.sync m16n8k16 bf16 -> fp32, over
// fp32 operands split into bf16 hi + lo planes (x = hi + lo to ~2^-17
// relative; the lo.lo pass, ~2^-16 relative, is dropped).  Pre-passes make
// the planes: xent_split_kernel turns w into W_hi = bf16(w) and, for an fp32
// w, W_lo = bf16(w - W_hi), both (Vp, Dp) row-major with Vp = V rounded up
// to the 128-wide vocabulary tile, Dp = D rounded up to 8 and zeros past V
// and D, whatever w's strides: the tied and the untied head reach the
// products in one layout.  A bf16 h is exact and is read in place (D must
// be a multiple of 8: the copies move 16-B rows); xent_split_h_kernel turns
// an fp32 h into H_hi, H_lo (T, Dp), so an fp32 h of any D takes the same
// tile loop.  h's dtype chooses only whether h has a lo plane.
//
// Every product runs on one tile loop (tc_tile): a 128 x 128 output tile
// per 256-thread CTA, 8 warps as 2 x 4 of 64 x 32 outputs, 32-deep k
// chunks through a ring of cp.async stages (three, or two where three
// would keep a second CTA off the SM) of bf16 rows padded by 16 B
// (conflict-free ldmatrix), one barrier per chunk.  Each 16-deep k-step's
// passes go into a fresh fragment that is then added to the fp32
// accumulator: the tensor cores round their sums toward zero, which over
// dH's K = V (~1e4 k-steps) drifted by ~3e-4 relative.  The forward's
// epilogue keeps each thread's online (max, sum-exp) over its own columns
// and merges the quad and the 4 column warps once per vocabulary split;
// the label's logit goes to shared memory from the one thread that holds
// it.  The backward's dlogits kernel is the forward's loop with an
// epilogue that writes dlogits already split, as bf16 hi and lo, into a
// staging buffer (the same bytes as an fp32 one); dH = dl W and
// dW = h^T dl take the same passes, both with the split operands through
// ldmatrix(.trans) from the same ring.  Passes (logits, dH, dW), the
// forward's being the logits': fp32 h and fp32 w 3, 3, 3 (hi.hi, hi.lo,
// lo.hi); fp32 h and bf16 w 2, 2, 3; bf16 h and fp32 w 2, 3, 2; bf16 h
// and bf16 w 1, 2, 2.  What bounds these kernels now is the per-warp
// operand work, not the tensor cores: without W_lo the bf16-h forward
// keeps ~0.7 of its time (not 0.5), and a taller CTA tile, which cuts the
// L2 bytes per flop by a third, ran no faster.  Every B fragment is loaded
// twice (hi, lo) by ldmatrix, and every k-step's fresh fragment costs
// four fp32 adds; wgmma with TMA is the next lever.
//
// Forward: one CTA per (token tile, vocabulary split), looping over the
// split's vocabulary tiles with the row statistics on chip; a second
// small kernel merges the splits' (m, l, c) exactly as the online softmax
// merges tiles.  xent_tc_nsplit chooses the split count so that the grid
// fills the 132 SMs in whole waves.
//
// Backward: the TPU kernel summed dH across vocabulary tiles through an
// aliased HBM buffer (sequential grid) and kept the dW tile resident in
// VMEM.  Neither carries over: a dW tile (D x bv) does not fit one SM, and
// dH atomics would be revisited once per vocabulary tile.  Instead the
// tokens are processed in chunks of `chunk` rows: one kernel recomputes
// each logits tile of the chunk exactly once and writes dlogits into a
// bounded staging buffer (chunk x Vp), then two tiled products form
// dH[chunk] = dlogits @ w^T and dW += h[chunk]^T @ dlogits.  No atomics:
// the backward is deterministic.  The wrapper bounds the staging buffer
// at 4 GiB, so both main paths' shapes run in one chunk.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

using rt::kNegInf;
using rt::kThreads;
using rt::to_f32;
typedef long long ll;

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

using bf16 = __nv_bfloat16;

constexpr int TBM = 128, TBN = 128, TBK = 32;  // CTA output tile, k chunk
constexpr int kTcCtasPerSm = 2;                // launch bounds and SMEM
constexpr int kSmemPerSm = 228 * 1024, kSmemPerCta = 1024;  // + reserved
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

// bytes of one stage of the cp.async ring
template <bool kAKM, bool kBKN, bool kALo, bool kBLo>
__host__ __device__ constexpr size_t tc_stage_bytes() {
  return ((1 + kALo) * tc_tile_elems<kAKM>() +
          (1 + kBLo) * tc_tile_elems<kBKN>()) * sizeof(bf16);
}

// The ring's depth: three stages where kTcCtasPerSm CTAs of a kernel with
// stage_bytes a stage and static_bytes of static shared memory fit one SM,
// else two (only the logits with both operands split: hi and lo of h and
// of W, 40 KiB a stage).
__host__ __device__ constexpr int tc_stages(size_t stage_bytes,
                                            size_t static_bytes) {
  return kTcCtasPerSm * (3 * stage_bytes + static_bytes + kSmemPerCta) <=
                 (size_t)kSmemPerSm
             ? 3
             : 2;
}

// acc += A[m0 : m0 + 128, 0 : K] B[0 : K, n0 : n0 + 128] over bf16 hi/lo
// operands (lo.lo dropped) through a ring of kStages stages, each warp's
// 64 x 32 block as 4 x 4 mma tiles:
// acc[i][n] is rows 16 i + (g, g + 8), columns 8 n + 2 t + (0, 1) of the
// warp's block.  Only the first m_valid rows and n_valid columns of the
// tile are wanted: a warp skips its 16-row blocks past them, and all of
// its products when its columns are.  Ends with every copy landed and
// every warp past its last read, so the caller may start another tile at
// once.
template <bool kAKM, bool kBKN, bool kALo, bool kBLo, int kStages>
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

// W_hi (and, kLo, W_lo) (Vp, Dp) row-major from w (D, V) of any strides,
// zeros past V and D; a 64 x 64 tile per CTA through shared memory, read
// along whichever stride of w is unit.
template <typename TW, bool kLo>
__global__ void __launch_bounds__(kThreads)
xent_split_kernel(const TW* __restrict__ w, ll sw_d, ll sw_v,
                  bf16* __restrict__ hi, bf16* __restrict__ lo, int D,
                  int Dp, int V) {
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
    if (gd >= Dp) continue;
    uint32_t h, l;
    rt::split_bf16x2(tile[v][d], tile[v][d + 1], h, l);
    const ll at = (ll)(v0 + v) * Dp + gd;
    *reinterpret_cast<uint32_t*>(hi + at) = h;
    if (kLo) *reinterpret_cast<uint32_t*>(lo + at) = l;
  }
}

// H_hi, H_lo (T, Dp) row-major from a contiguous fp32 h (T, D), zeros past
// D: one pair of columns a thread.
__global__ void __launch_bounds__(kThreads)
xent_split_h_kernel(const float* __restrict__ h, bf16* __restrict__ hi,
                    bf16* __restrict__ lo, int T, int D, int Dp) {
  const int pairs = Dp / 2;
  const ll e = (ll)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (ll)T * pairs) return;
  const int t = (int)(e / pairs), d = (int)(e % pairs) * 2;
  const float* row = h + (ll)t * D;
  uint32_t x, y;
  rt::split_bf16x2(d < D ? row[d] : 0.f, d + 1 < D ? row[d + 1] : 0.f, x, y);
  const ll at = (ll)t * Dp + d;
  *reinterpret_cast<uint32_t*>(hi + at) = x;
  *reinterpret_cast<uint32_t*>(lo + at) = y;
}

// the logits kernel's static shared memory (s_lab, s_c, s_stat)
__host__ __device__ constexpr size_t logits_static_bytes(bool dlogits) {
  return (2 * TBM + (dlogits ? 1 : 16) * kThreads) * 4;
}

// Forward (kDlogits false): partial (m, l, c) per token over one vocabulary
// split into part (3, nsplit, T).  Backward step 1 (kDlogits true): the
// dlogits of tokens [t_begin, t_begin + t_count) into stage hi/lo
// (t_count, Vp), each logits tile recomputed once.  One CTA per (128-token
// tile, split of tiles_per_split vocabulary tiles).  h (and, kHLo, its lo
// plane) is (T, Dp), W_hi (and, kLo, W_lo) (Vp, Dp).
template <bool kHLo, bool kLo, bool kDlogits>
__global__ void __launch_bounds__(kThreads, kTcCtasPerSm)
xent_tc_logits_kernel(const bf16* __restrict__ h,
                      const bf16* __restrict__ h_lo,
                      const bf16* __restrict__ w_hi,
                      const bf16* __restrict__ w_lo,
                      const int* __restrict__ labels,
                      const float* __restrict__ lse,
                      const float* __restrict__ g, float* __restrict__ part,
                      bf16* __restrict__ st_hi, bf16* __restrict__ st_lo,
                      int t_begin, int t_count, int Dp, int V, int Vp,
                      float softcap, int tiles_per_split) {
  constexpr int kS = tc_stages(tc_stage_bytes<false, false, kHLo, kLo>(),
                               logits_static_bytes(kDlogits));
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
  const TcOperand A{h + (ll)t_begin * Dp, kHLo ? h_lo + (ll)t_begin * Dp
                                                : nullptr,
                    (ll)Dp, t_count, Dp};
  const TcOperand B{w_hi, w_lo, (ll)Dp, Vp, Dp};

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
    tc_tile<false, false, kHLo, kLo, kS>(acc, A, B, t0, v0, Dp, t_count - t0,
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
  constexpr int kS = tc_stages(tc_stage_bytes<kAKM, true, kALo, kBLo>(), 0);
  float acc[4][4][4];
  tc_zero(acc);
  tc_tile<kAKM, true, kALo, kBLo, kS>(acc, A, B, m0, n0, K, M - m0, N - n0,
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
                       bf16* hi, bf16* lo, int D, int Dp, int V, int Vp,
                       cudaStream_t st) {
  const dim3 grid(Vp / 64, (Dp + 63) / 64);
  if (w_dtype == rt::kBFloat16)
    xent_split_kernel<bf16, false><<<grid, kThreads, 0, st>>>(
        (const bf16*)w, sw_d, sw_v, hi, lo, D, Dp, V);
  else
    xent_split_kernel<float, true><<<grid, kThreads, 0, st>>>(
        (const float*)w, sw_d, sw_v, hi, lo, D, Dp, V);
  return cudaGetLastError();
}

cudaError_t xent_split_h(const float* h, bf16* hi, bf16* lo, int T, int D,
                         int Dp, cudaStream_t st) {
  const unsigned blocks = (unsigned)(((ll)T * (Dp / 2) + kThreads - 1) /
                                     kThreads);
  xent_split_h_kernel<<<blocks, kThreads, 0, st>>>(h, hi, lo, T, D, Dp);
  return cudaGetLastError();
}

// Calls f(std::bool_constant<a>{}, std::bool_constant<b>{}): a template
// instantiation chosen at run time.
template <typename F>
cudaError_t dispatch2(bool a, bool b, F&& f) {
  using Y = std::true_type;
  using N = std::false_type;
  return a ? (b ? f(Y{}, Y{}) : f(Y{}, N{})) : (b ? f(N{}, Y{}) : f(N{}, N{}));
}

template <bool kHLo, bool kLo, bool kDlogits>
cudaError_t launch_tc_logits(const bf16* h, const bf16* h_lo,
                             const bf16* w_hi, const bf16* w_lo,
                             const int* labels, const float* lse,
                             const float* g, float* part, bf16* st_hi,
                             bf16* st_lo, int t_begin, int t_count, int Dp,
                             int V, int Vp, float softcap, int nsplit,
                             cudaStream_t st) {
  constexpr size_t stage = tc_stage_bytes<false, false, kHLo, kLo>();
  constexpr size_t smem =
      tc_stages(stage, logits_static_bytes(kDlogits)) * stage;
  auto kernel = xent_tc_logits_kernel<kHLo, kLo, kDlogits>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int nv = Vp / TBN, per = (nv + nsplit - 1) / nsplit;
  const dim3 grid((t_count + TBM - 1) / TBM, nsplit);
  kernel<<<grid, kThreads, smem, st>>>(h, h_lo, w_hi, w_lo, labels, lse, g,
                                       part, st_hi, st_lo, t_begin, t_count,
                                       Dp, V, Vp, softcap, per);
  return cudaGetLastError();
}

template <bool kAKM, bool kALo, bool kBLo>
cudaError_t launch_tc_gemm(const TcOperand& A, const TcOperand& B, float* C,
                           ll sc_m, ll sc_n, int M, int N, int K,
                           int accumulate, cudaStream_t st) {
  constexpr size_t stage = tc_stage_bytes<kAKM, true, kALo, kBLo>();
  constexpr size_t smem = tc_stages(stage, 0) * stage;
  auto kernel = xent_tc_gemm_kernel<kAKM, kALo, kBLo>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TBN - 1) / TBN, (M + TBM - 1) / TBM);
  kernel<<<grid, kThreads, smem, st>>>(A, B, C, sc_m, sc_n, M, N, K,
                                       accumulate);
  return cudaGetLastError();
}

// The products' operands after the split pre-passes: h's planes (T, Dp)
// and w's (Vp, Dp), lo null where the input was bf16.
struct Planes {
  const bf16 *h_hi, *h_lo, *w_hi, *w_lo;
  int Dp, Vp;
};

// Runs both pre-passes: an fp32 h into h_hi, h_lo; a bf16 h read in place
// (16-B rows: D % 8 == 0 and a 16-B aligned base); w into w_hi (and, fp32,
// w_lo).  cudaErrorInvalidValue for what the route does not take.
cudaError_t split_operands(const void* h, const void* w, void* h_hi,
                           void* h_lo, void* w_hi, void* w_lo, int h_dtype,
                           int w_dtype, int T, int D, int V, ll sw_d, ll sw_v,
                           Planes& p, cudaStream_t st) {
  p.Dp = (D + 7) / 8 * 8;
  p.Vp = (V + TBN - 1) / TBN * TBN;
  if (w_dtype != rt::kFloat32 && w_dtype != rt::kBFloat16)
    return cudaErrorInvalidValue;
  if (h_dtype == rt::kBFloat16) {
    if (D % 8 != 0 || reinterpret_cast<uintptr_t>(h) % 16 != 0)
      return cudaErrorInvalidValue;
    p.h_hi = (const bf16*)h;
    p.h_lo = nullptr;
  } else {
    if (h_dtype != rt::kFloat32 || !h_hi || !h_lo)
      return cudaErrorInvalidValue;
    cudaError_t err = xent_split_h((const float*)h, (bf16*)h_hi, (bf16*)h_lo,
                                   T, D, p.Dp, st);
    if (err != cudaSuccess) return err;
    p.h_hi = (const bf16*)h_hi;
    p.h_lo = (const bf16*)h_lo;
  }
  p.w_hi = (const bf16*)w_hi;
  p.w_lo = w_dtype == rt::kFloat32 ? (const bf16*)w_lo : nullptr;
  return xent_split(w, w_dtype, sw_d, sw_v, (bf16*)w_hi, (bf16*)w_lo, D,
                    p.Dp, V, p.Vp, st);
}

// Every kernel instantiation the entry points can reach: the split
// pre-passes, the logits / dlogits kernel for each (h lo, w lo) pair, the
// GEMMs of dH (w lo or not) and of dW (tied or not, h lo or not), and the
// combine.
const rt::KernelEntry kKernels[] = {
    {"xent_split_kernel<__nv_bfloat16, false>",
     (const void*)xent_split_kernel<bf16, false>},
    {"xent_split_kernel<float, true>",
     (const void*)xent_split_kernel<float, true>},
    {"xent_split_h_kernel", (const void*)xent_split_h_kernel},
    {"xent_tc_logits_kernel<false, false, false>",
     (const void*)xent_tc_logits_kernel<false, false, false>},
    {"xent_tc_logits_kernel<false, true, false>",
     (const void*)xent_tc_logits_kernel<false, true, false>},
    {"xent_tc_logits_kernel<true, false, false>",
     (const void*)xent_tc_logits_kernel<true, false, false>},
    {"xent_tc_logits_kernel<true, true, false>",
     (const void*)xent_tc_logits_kernel<true, true, false>},
    {"xent_tc_logits_kernel<false, false, true>",
     (const void*)xent_tc_logits_kernel<false, false, true>},
    {"xent_tc_logits_kernel<false, true, true>",
     (const void*)xent_tc_logits_kernel<false, true, true>},
    {"xent_tc_logits_kernel<true, false, true>",
     (const void*)xent_tc_logits_kernel<true, false, true>},
    {"xent_tc_logits_kernel<true, true, true>",
     (const void*)xent_tc_logits_kernel<true, true, true>},
    {"xent_tc_gemm_kernel<false, true, true>",
     (const void*)xent_tc_gemm_kernel<false, true, true>},
    {"xent_tc_gemm_kernel<false, true, false>",
     (const void*)xent_tc_gemm_kernel<false, true, false>},
    {"xent_tc_gemm_kernel<true, true, true>",
     (const void*)xent_tc_gemm_kernel<true, true, true>},
    {"xent_tc_gemm_kernel<true, true, false>",
     (const void*)xent_tc_gemm_kernel<true, true, false>},
    {"xent_tc_gemm_kernel<true, false, true>",
     (const void*)xent_tc_gemm_kernel<true, false, true>},
    {"xent_combine_kernel", (const void*)xent_combine_kernel}};

}  // namespace

RT_KERNEL_TABLE(xent, kKernels)

extern "C" int rt_xent_tc_nsplit(int T, int V, int sms) {
  return xent_tc_nsplit_impl(T, V, sms);
}

// The w split pre-pass alone: w (D, V) of any strides into W_hi (and, for
// an fp32 w, W_lo), (Vp, Dp) bf16 row-major.
extern "C" int rt_xent_split(const void* w, void* w_hi, void* w_lo,
                             int w_dtype, int D, int V, long long sw_d,
                             long long sw_v, void* stream) {
  if (w_dtype != rt::kFloat32 && w_dtype != rt::kBFloat16)
    return (int)cudaErrorInvalidValue;
  const int Dp = (D + 7) / 8 * 8, Vp = (V + TBN - 1) / TBN * TBN;
  return (int)xent_split(w, w_dtype, sw_d, sw_v, (bf16*)w_hi, (bf16*)w_lo, D,
                         Dp, V, Vp, (cudaStream_t)stream);
}

// The h split pre-pass alone: a contiguous fp32 h (T, D) into H_hi, H_lo,
// (T, Dp) bf16 row-major.
extern "C" int rt_xent_split_h(const void* h, void* h_hi, void* h_lo, int T,
                               int D, void* stream) {
  return (int)xent_split_h((const float*)h, (bf16*)h_hi, (bf16*)h_lo, T, D,
                           (D + 7) / 8 * 8, (cudaStream_t)stream);
}

// h fp32 (split into h_hi, h_lo: (T, Dp) bf16 scratch) or bf16 (read in
// place; h_hi, h_lo unused); w fp32 (split into w_hi, w_lo) or bf16 (w_hi
// only): (Vp, Dp) bf16 scratch.  part (3, nsplit, T) with nsplit from
// rt_xent_tc_nsplit(T, V, sms).
extern "C" int rt_xent_fwd_tc(const void* h, const void* w,
                              const void* labels, void* loss, void* lse,
                              void* part, void* h_hi, void* h_lo, void* w_hi,
                              void* w_lo, int h_dtype, int w_dtype, int T,
                              int D, int V, long long sw_d, long long sw_v,
                              float softcap, int nsplit, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (nsplit <= 0) return (int)cudaErrorInvalidValue;
  Planes p;
  cudaError_t err = split_operands(h, w, h_hi, h_lo, w_hi, w_lo, h_dtype,
                                   w_dtype, T, D, V, sw_d, sw_v, p, st);
  if (err != cudaSuccess) return (int)err;
  const int* lab = (const int*)labels;
  float* pt = (float*)part;
  err = dispatch2(p.h_lo, p.w_lo, [&](auto hlo, auto wlo) {
    return launch_tc_logits<decltype(hlo)::value, decltype(wlo)::value,
                            false>(p.h_hi, p.h_lo, p.w_hi, p.w_lo, lab,
                                   nullptr, nullptr, pt, nullptr, nullptr, 0,
                                   T, p.Dp, V, p.Vp, softcap, nsplit, st);
  });
  if (err != cudaSuccess) return (int)err;
  xent_combine_kernel<<<(T + 255) / 256, 256, 0, st>>>(
      pt, (float*)loss, (float*)lse, T, nsplit);
  return (int)cudaGetLastError();
}

// Scratch as rt_xent_fwd_tc's; st_hi, st_lo: (chunk, Vp) bf16 staging of
// the split dlogits; dw with the strides (sdw_d, sdw_v) the caller gives
// ((V, D) storage when sdw_d == 1).
extern "C" int rt_xent_bwd_tc(const void* h, const void* w,
                              const void* labels, const void* lse,
                              const void* g, void* dh, void* dw, void* h_hi,
                              void* h_lo, void* w_hi, void* w_lo, void* st_hi,
                              void* st_lo, int h_dtype, int w_dtype, int T,
                              int D, int V, long long sw_d, long long sw_v,
                              long long sdw_d, long long sdw_v, float softcap,
                              int chunk, int sms, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (chunk <= 0) return (int)cudaErrorInvalidValue;
  Planes p;
  cudaError_t err = split_operands(h, w, h_hi, h_lo, w_hi, w_lo, h_dtype,
                                   w_dtype, T, D, V, sw_d, sw_v, p, st);
  if (err != cudaSuccess) return (int)err;
  const int Dp = p.Dp, Vp = p.Vp;
  bf16 *sh = (bf16*)st_hi, *sl = (bf16*)st_lo;
  const int* lab = (const int*)labels;
  const float *ls = (const float*)lse, *gg = (const float*)g;
  float *dhp = (float*)dh, *dwp = (float*)dw;
  const bool tied = sdw_d == 1 && sdw_v != 1;  // (V, D) storage
  for (int t_begin = 0; t_begin < T; t_begin += chunk) {
    const int tc = min(chunk, T - t_begin);
    const int nsplit = xent_tc_nsplit_impl(tc, V, sms);
    err = dispatch2(p.h_lo, p.w_lo, [&](auto hlo, auto wlo) {
      return launch_tc_logits<decltype(hlo)::value, decltype(wlo)::value,
                              true>(p.h_hi, p.h_lo, p.w_hi, p.w_lo, lab, ls,
                                    gg, nullptr, sh, sl, t_begin, tc, Dp, V,
                                    Vp, softcap, nsplit, st);
    });
    if (err != cudaSuccess) return (int)err;
    // dH[chunk] = dl W: A = dl [t][v], B = W [v][d]
    const TcOperand dl_tv{sh, sl, (ll)Vp, tc, Vp};
    const TcOperand w_vd{p.w_hi, p.w_lo, (ll)Dp, Vp, Dp};
    err = p.w_lo ? launch_tc_gemm<false, true, true>(dl_tv, w_vd,
                                                     dhp + (ll)t_begin * D, D,
                                                     1, tc, D, Vp, 0, st)
                 : launch_tc_gemm<false, true, false>(dl_tv, w_vd,
                                                      dhp + (ll)t_begin * D,
                                                      D, 1, tc, D, Vp, 0, st);
    if (err != cudaSuccess) return (int)err;
    // dW (+)= h[chunk]^T dl over the chunk's tokens, oriented so the
    // output's unit stride runs along the tile's columns
    const ll off = (ll)t_begin * Dp;
    const TcOperand h_td{p.h_hi + off, p.h_lo ? p.h_lo + off : nullptr,
                         (ll)Dp, tc, Dp};
    const int acc = t_begin > 0;
    err = dispatch2(tied, p.h_lo, [&](auto kt, auto hlo) {
      constexpr bool kHLo = decltype(hlo)::value;
      return decltype(kt)::value
                 ? launch_tc_gemm<true, true, kHLo>(dl_tv, h_td, dwp, sdw_v,
                                                    sdw_d, V, D, tc, acc, st)
                 : launch_tc_gemm<true, kHLo, true>(h_td, dl_tv, dwp, sdw_d,
                                                    sdw_v, D, V, tc, acc, st);
    });
    if (err != cudaSuccess) return (int)err;
  }
  return cudaSuccess;
}
