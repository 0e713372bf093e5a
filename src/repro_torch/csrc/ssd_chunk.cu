// Mamba-2 SSD intra-chunk dual form for Hopper.
//
// Replaces the TPU Pallas kernel
//   repro/kernels/ssd_chunk/kernel.py::ssd_intra_pallas  (pallas_call :70)
// with the same math, per (b·chunk, head):
//   y[q] = sum_{j<=q} (C_q . B_j) * exp(acum_q - acum_j) * dt_j * x_j
//   S    = sum_j x_j (x) (B_j * exp(acum_last - acum_j) * dt_j)
// in fp32 throughout (the model casts to fp32 before the kernel), with the
// mask applied before the exponential as in the reference.
//
// Layouts, as the reference's public ones (the TPU wrapper transposed them
// head-major; here the kernels read them in place with strides):
// x, y (BC, Q, H, P); dt, acum (BC, Q, H); B, C (BC, Q, N); S (BC, H, P, N);
// BC = batch * chunks.  Q <= 256, N <= 128, P <= 64.
//
// What bounds it on the H100: at the main path's shape (BC 64, Q 256, H 32,
// P 64, N 128) the call moves ~0.36 GB and does ~18 GFLOP (C.B^T once per
// (b·chunk), the causal half of the (Q, Q) x (Q, P) products, and the
// (P, Q) x (Q, N) state products), so it is bound by fp32 operations
// (~0.27 ms at 67 TFLOP/s) more than by bytes (~0.11 ms).  This first
// version runs every product as fp32 FMAs on the CUDA cores (TF32 tensor
// cores would change the rounding).  What its design does about the bound:
// - The (Q, Q) score tile (256 KB at Q 256) does not fit a block, so the y
//   part tiles q into 64-row tiles against 64-column j tiles and skips the
//   tiles above the diagonal, which the TPU kernel computed and masked.
// - C.B^T is shared by all heads of a (b·chunk): a CTA computes its 64-row
//   strip of it once (N streamed in chunks of 32) into shared memory and
//   reuses it for a group of 8 heads, so the product is recomputed H / 8
//   times instead of H times.
// - Diagonal-heavy q tiles (more j tiles) are scheduled first.
// - The chunk state S is a second, small kernel: one CTA per (b·chunk,
//   head) keeps the (P, N) sum in registers (4 x 8 per thread) while it
//   streams Q in 32-row tiles of x and of B scaled by its decay weight.
// rt_ssd_intra launches both kernels, one after the other, on the
// caller's stream; the Python wrapper counts that as one launch.
//
// Backward (rt_ssd_intra_bwd): the VJP that the reference takes by
// differentiating the quadratic oracle (repro/kernels/ssd_chunk/ops.py::
// _bwd), from explicit formulas.  Per (b·chunk, head), with the mask
// M = [j <= q], L = exp(acum_q - acum_j), CB = C.B^T, A = CB L dt_j and
// w_j = exp(acum_last - acum_j) dt_j:
//   dA = M (dy . x_j), G = dA L, E = dA A, U = B dS^T, Z_j = x_j . U_j
//   dx_j   = sum_q A[q,j] dy_q + w_j U_j
//   ddt_j  = sum_q G[q,j] CB[q,j] + exp(acum_last - acum_j) Z_j
//   dacum  = rowsum(E) - colsum(E) - w Z, plus sum_j w_j Z_j at the last row
// and, summed over the heads, dCB = sum_h G dt_j, dC = dCB B,
// dB = dCB^T C + sum_h (w x) dS.  Nothing new is saved by the forward: CB
// and L are recomputed from the inputs.
//
// Every product runs on the tensor cores (tensor_core.cuh): warp-level
// mma.sync m16n8k16 bf16 -> fp32, each fp32 operand split into bf16 hi +
// lo (rt::split_bf16x2) as it is staged in shared memory, three passes
// (hi.hi, hi.lo, lo.hi) per k-step into a fresh fragment that is then
// added in fp32 (the tensor cores round their sums toward zero, which
// dB's K = H P chain would accumulate).  The elementwise work between the
// products (L masked before the exponential, G, A, E, the dCB sum in head
// order, the column sums) stays in fp32 on the CUDA cores.
//
// What bounds it: at the main shape (8, 8, 256, 32, 64, N 128) the
// products are ~36 GFLOP (~108 at 3 passes, 0.109 ms at 989 TFLOP/s), the
// elementwise work ~0.74 GFLOP, and the call moves ~0.51 GB (0.153 ms),
// so bytes bound it on paper.  In practice neither does: cutting parts
// of ssd_bwd_dx_kernel on the H100 (scripts/torch_ssd_bwd_probe.py,
// PERF.md) saves about a quarter of its time for the fp32 elementwise
// stage, another quarter for the dA and dx products together, a ninth
// for the next head's loads; the rest is the other products, the loads
// and hi/lo splits of the operand tiles and the barriers between them,
// at 8 warps per SM (a CTA holds 231 KB of shared memory; 16 warps of
// smaller tiles ran slower).  What the design does about it:
// - ssd_bwd_dx_kernel: one CTA per (b·chunk, 64-column j tile, group of 8
//   heads), j tile 0 (the most q tiles) first.  C.B^T is computed once per
//   CTA and kept, with the group's dCB, as fp32 fragments in shared
//   memory that only their own thread reads (no barriers on them); B_j
//   stays split for the whole CTA.  dA^T is formed with j as its rows, so
//   that its accumulator fragment, weighted into A^T and split in
//   registers, is the A operand of dx_j += A^T dy_q as it stands: A never
//   goes through shared memory, the dy tiles are double-buffered, and a q
//   tile needs one barrier.  Each warp sums dx over its q half; the two
//   halves are added in a fixed order.  A head's x and dS load during the
//   last q tile of the head before, the next dy tile during the current
//   one; off-diagonal tiles skip the mask.
// - ssd_bwd_dcb_sum_kernel: sums the groups' dCB partials, in group order,
//   into group 0's slot, once, on and below the diagonal (with one group
//   it is not launched).
// - ssd_bwd_dbc_kernel: one CTA per (b·chunk, 64-row tile, 64-column N
//   tile), 2 per SM: dC and dB as products with that dCB sum, then the
//   state part of dB over (head, p), K = H P, head h + 1's tiles loading
//   (and its w_j formed once per row) while head h multiplies; the CTAs
//   of N tile 0 also add the row sums to dacum.
// No atomics: every sum runs in a fixed order and mma.sync is
// deterministic, so two calls give bit-identical gradients.
#include <cstdint>

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

using rt::kThreads;

constexpr int kMaxQ = 256, kMaxN = 128, kMaxP = 64;
constexpr int kBQ = 64;   // q rows per CTA (y part)
constexpr int kBK = 64;   // j columns per tile (y part)
constexpr int kNK = 32;   // N chunk of the C.B^T product
constexpr int kHG = 8;    // heads per CTA sharing one C.B^T strip
constexpr int kBJ = 32;   // Q rows per tile (state part)
constexpr int kLNK = kNK + 1, kLX = kMaxP + 1, kLA = kBK + 1;
constexpr int kT = 64;    // backward: q, j, p and N tile
constexpr int kBHG = 8;   // backward: heads per CTA sharing C.B^T and dCB

__host__ __device__ constexpr int cb_stride(int Q) {
  return ((Q + kBK - 1) / kBK) * kBK + 1;
}

// y part: grid (nqt * nhg, BC), 256 threads as a 16 x 16 grid.
__global__ void __launch_bounds__(kThreads)
ssd_y_kernel(const float* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ acum, const float* __restrict__ Bm,
             const float* __restrict__ Cm, float* __restrict__ y, int Q,
             int H, int P, int N) {
  extern __shared__ float smem[];
  const int LCB = cb_stride(Q);
  float* sCB = smem;                      // kBQ x LCB: C.B^T strip
  float* work = sCB + kBQ * LCB;          // phase 1: sC, sB; phase 2: sX, sA
  float* sC = work;                       // kBQ x kLNK
  float* sB = sC + kBQ * kLNK;            // kBK x kLNK
  float* sX = work;                       // kBK x kLX
  float* sA = sX + kBK * kLX;             // kBQ x kLA
  float* sAcQ = work + kBK * kLX + kBQ * kLA;  // kBQ
  float* sAcJ = sAcQ + kBQ;               // kBK
  float* sDtJ = sAcJ + kBK;               // kBK

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int nqt = (Q + kBQ - 1) / kBQ;
  const int qt = nqt - 1 - (int)(blockIdx.x % nqt);   // heavy tiles first
  const int h0 = (int)(blockIdx.x / nqt) * kHG;
  const int h1 = min(h0 + kHG, H);
  const size_t bc = blockIdx.y;
  const int q0 = qt * kBQ;
  const int nkt = (min(q0 + kBQ, Q) - 1) / kBK + 1;  // j tiles to the diagonal
  const float* Cg = Cm + bc * Q * N;
  const float* Bg = Bm + bc * Q * N;

  // phase 1: sCB[r][j] = C[q0 + r] . B[j] for j < nkt * kBK
  for (int jt = 0; jt < nkt; ++jt) {
    const int j0 = jt * kBK;
    float cb[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) cb[r][c] = 0.f;
    for (int n0 = 0; n0 < N; n0 += kNK) {
      __syncthreads();  // previous chunk's reads done
      for (int e = tid; e < kBQ * kNK; e += kThreads) {
        const int r = e / kNK, c = e % kNK;
        const bool in = n0 + c < N;
        sC[r * kLNK + c] =
            (in && q0 + r < Q) ? Cg[(size_t)(q0 + r) * N + n0 + c] : 0.f;
        sB[r * kLNK + c] =
            (in && j0 + r < Q) ? Bg[(size_t)(j0 + r) * N + n0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int n = 0; n < kNK; ++n) {
        float bv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = sB[(tx + 16 * c) * kLNK + n];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float cv = sC[(ty * 4 + r) * kLNK + n];
#pragma unroll
          for (int c = 0; c < 4; ++c) cb[r][c] += cv * bv[c];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        sCB[(ty * 4 + r) * LCB + j0 + tx + 16 * c] = cb[r][c];
  }

  // phase 2, per head: y = (C.B^T * decay * dt) x, over the j tiles <= q
  for (int h = h0; h < h1; ++h) {
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    for (int jt = 0; jt < nkt; ++jt) {
      const int j0 = jt * kBK;
      __syncthreads();  // sCB written / previous tile's sX, sA reads done
      for (int e = tid; e < kBK * kMaxP; e += kThreads) {
        const int r = e / kMaxP, p = e % kMaxP;
        sX[r * kLX + p] = (j0 + r < Q && p < P)
                              ? x[((bc * Q + j0 + r) * H + h) * P + p]
                              : 0.f;
      }
      if (tid < kBK) {
        const bool in = j0 + tid < Q;
        const size_t i = (bc * Q + j0 + tid) * H + h;
        sAcJ[tid] = in ? acum[i] : 0.f;
        sDtJ[tid] = in ? dt[i] : 0.f;
      } else if (tid < kBK + kBQ) {
        const int r = tid - kBK;
        sAcQ[r] = q0 + r < Q ? acum[(bc * Q + q0 + r) * H + h] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int rr = ty * 4 + r, q = q0 + rr;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int cc = tx + 16 * c, j = j0 + cc;
          // masked before the exponential: exp(-inf) = 0 above the diagonal
          sA[rr * kLA + cc] =
              (j <= q && q < Q)
                  ? sCB[rr * LCB + j] * expf(sAcQ[rr] - sAcJ[cc]) * sDtJ[cc]
                  : 0.f;
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int jj = 0; jj < kBK; ++jj) {
        float xv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) xv[c] = sX[jj * kLX + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float a = sA[(ty * 4 + r) * kLA + jj];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] += a * xv[c];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int q = q0 + ty * 4 + r;
      if (q >= Q) continue;
      float* yg = y + ((bc * Q + q) * H + h) * P;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (tx + 16 * c < P) yg[tx + 16 * c] = acc[r][c];
    }
  }
}

// state part: grid (H, BC), 256 threads; thread (ty, tx) owns
// S[p = ty + 16 r][n = tx + 16 c], r < 4, c < 8.
__global__ void __launch_bounds__(kThreads)
ssd_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ acum, const float* __restrict__ Bm,
                 float* __restrict__ S, int Q, int H, int P, int N) {
  extern __shared__ float smem[];
  float* sX = smem;                   // kBJ x kMaxP
  float* sBw = sX + kBJ * kMaxP;      // kBJ x kMaxN: B_j * w_j
  float* sW = sBw + kBJ * kMaxN;      // kBJ

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int h = blockIdx.x;
  const size_t bc = blockIdx.y;
  const float* Bg = Bm + bc * Q * N;
  const float ac_last = acum[(bc * Q + Q - 1) * H + h];

  float acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  for (int j0 = 0; j0 < Q; j0 += kBJ) {
    __syncthreads();  // previous tile's reads done
    for (int e = tid; e < kBJ * kMaxP; e += kThreads) {
      const int r = e / kMaxP, p = e % kMaxP;
      sX[e] = (j0 + r < Q && p < P) ? x[((bc * Q + j0 + r) * H + h) * P + p]
                                    : 0.f;
    }
    if (tid < kBJ) {
      const size_t i = (bc * Q + j0 + tid) * H + h;
      sW[tid] = j0 + tid < Q ? expf(ac_last - acum[i]) * dt[i] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < kBJ * kMaxN; e += kThreads) {
      const int r = e / kMaxN, n = e % kMaxN;
      sBw[e] = (j0 + r < Q && n < N) ? Bg[(size_t)(j0 + r) * N + n] * sW[r]
                                     : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < kBJ; ++jj) {
      float xv[4], bv[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) xv[r] = sX[jj * kMaxP + ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 8; ++c) bv[c] = sBw[jj * kMaxN + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] += xv[r] * bv[c];
    }
  }

  float* Sg = S + (bc * H + h) * (size_t)P * N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = ty + 16 * r;
    if (p >= P) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int n = tx + 16 * c;
      if (n < N) Sg[(size_t)p * N + n] = acc[r][c];
    }
  }
}

// ---------------------------------------------------------------------------
// Backward: every product on the tensor cores (tensor_core.cuh)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kLH = kT + 8;        // bf16 row stride of a split tile: 144 B
constexpr int kTileH = kT * kLH;   // elements of one half (hi or lo)
constexpr int kSplit = 2 * kTileH; // elements of a split tile
constexpr int kFrag = 16;          // fp32 per thread of a 64 x 64 tile

__device__ __forceinline__ int ksteps(int k) { return (min(k, kT) + 15) / 16; }

__device__ __forceinline__ void zero_frag(float (&a)[4][4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[n][e] = 0.f;
}

// This thread's share of a 64 x 64 fp32 tile: pair i is row
// (tid + 256 i) / 32, columns 2 ((tid + 256 i) % 32) + (0, 1), so each
// warp reads one 256-B row.  at(r, c) gives the element, or 0 outside
// the data (the zero padding of ragged Q, P and N).
template <class F>
__device__ __forceinline__ void tile_load(float (&v)[kFrag], F at) {
#pragma unroll
  for (int i = 0; i < kFrag / 2; ++i) {
    const int e = threadIdx.x + kThreads * i, r = e / 32, c = e % 32 * 2;
    v[2 * i] = at(r, c);
    v[2 * i + 1] = at(r, c + 1);
  }
}

// rows [r0, r0 + 64) x columns [c0, c0 + 64) of a row-major fp32 matrix
// (row stride ld) of nrows x ncols
__device__ __forceinline__ void tile_load_rm(float (&v)[kFrag],
                                             const float* m, size_t ld,
                                             int r0, int c0, int nrows,
                                             int ncols) {
  tile_load(v, [&](int r, int c) {
    return r0 + r < nrows && c0 + c < ncols
               ? m[(size_t)(r0 + r) * ld + c0 + c]
               : 0.f;
  });
}

// The loaded share split into bf16 hi (at t) and lo (at t + kTileH),
// rows of kLH elements: conflict-free stores and ldmatrix reads.
__device__ __forceinline__ void tile_store(bf16* t, const float (&v)[kFrag]) {
#pragma unroll
  for (int i = 0; i < kFrag / 2; ++i) {
    const int e = threadIdx.x + kThreads * i, r = e / 32, c = e % 32 * 2;
    uint32_t hi, lo;
    rt::split_bf16x2(v[2 * i], v[2 * i + 1], hi, lo);
    *reinterpret_cast<uint32_t*>(t + r * kLH + c) = hi;
    *reinterpret_cast<uint32_t*>(t + kTileH + r * kLH + c) = lo;
  }
}

// acc += A B on this warp's 16 x 32 block at (m0, n0) of a 64 x 64
// output, for k-step kk of split tiles A (stored [m][k], or [k][m] with
// kAT) and B (stored [n][k], or [k][n] with kBT).  The passes hi.hi,
// hi.lo and lo.hi (lo.lo, ~2^-16 relative, is dropped) go into a fresh
// fragment, which is then added to acc in fp32: the tensor cores round
// their sums toward zero, the fp32 add to nearest, so the long chain of
// dB's state part (K = H P) does not drift.
template <bool kAT, bool kBT>
__device__ __forceinline__ void mma3_kstep(float (&acc)[4][4], const bf16* A,
                                           const bf16* B, int m0, int n0,
                                           int kk) {
  const int ao = kAT ? rt::tc_akm_off(16 * kk, m0, kLH)
                     : rt::tc_a_off(m0, 16 * kk, kLH);
  uint32_t ah[4], al[4], bh[2][4], bl[2][4];
  if (kAT) {
    rt::ldmatrix_x4_trans(ah, A + ao);
    rt::ldmatrix_x4_trans(al, A + kTileH + ao);
  } else {
    rt::ldmatrix_x4(ah, A + ao);
    rt::ldmatrix_x4(al, A + kTileH + ao);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int bo = kBT ? rt::tc_bkn_off(16 * kk, n0 + 16 * j, kLH)
                       : rt::tc_bnk_off(n0 + 16 * j, 16 * kk, kLH);
    if (kBT) {
      rt::ldmatrix_x4_trans(bh[j], B + bo);
      rt::ldmatrix_x4_trans(bl[j], B + kTileH + bo);
    } else {
      rt::ldmatrix_x4(bh[j], B + bo);
      rt::ldmatrix_x4(bl[j], B + kTileH + bo);
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const uint32_t* b = bh[n / 2] + 2 * (n % 2);
    const uint32_t* c = bl[n / 2] + 2 * (n % 2);
    float f[4];
    rt::mma_bf16_zc(f, ah, b[0], b[1]);
    rt::mma_bf16(f, ah, c[0], c[1]);
    rt::mma_bf16(f, al, b[0], b[1]);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += f[e];
  }
}

// k-steps [0, ks) of mma3_kstep: unrolled (ks <= 4) for part 1, where the
// independent k-steps overlap; a plain loop for part 2, whose 128
// registers (2 CTAs per SM) leave no room for that.
template <bool kAT, bool kBT, bool kUnrolled = true>
__device__ __forceinline__ void warp_mma3(float (&acc)[4][4], const bf16* A,
                                          const bf16* B, int m0, int n0,
                                          int ks) {
  if (kUnrolled) {
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk)
      if (kk < ks) mma3_kstep<kAT, kBT>(acc, A, B, m0, n0, kk);
  } else {
    for (int kk = 0; kk < ks; ++kk)
      mma3_kstep<kAT, kBT>(acc, A, B, m0, n0, kk);
  }
}

// This warp's fragment of a 64 x 64 output tile at (r0, c0) of a
// row-major fp32 matrix (row stride ld) of nrows x ncols.  Fragment
// element (n, e) of lane (g, t) is row m0 + g + 8 (e / 2), column
// n0 + 8 n + 2 t + e % 2 of the tile.
__device__ __forceinline__ void frag_store(float* m, size_t ld, int r0,
                                           int c0, int nrows, int ncols,
                                           int m0, int n0,
                                           const float (&acc)[4][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + m0 + g + 8 * (e / 2), c = c0 + n0 + 8 * n + 2 * t
                                                   + e % 2;
      if (r < nrows && c < ncols) m[(size_t)r * ld + c] = acc[n][e];
    }
}

// Backward, part 1: grid (njt * nhg * BC) with the j tile slowest, so the
// CTAs of j tile 0 (the most q tiles) run first.  8 warps: warp w owns j
// rows m0 = 16 (w / 2) and the q half qh = 32 (w % 2) of every (j, q)
// tile (dA^T, C.B^T, dCB), and so the p half qh of U.  dA^T is formed
// with j as its rows so that its accumulator fragment, once weighted
// into A^T and split, is already the A operand of dx_j += A^T dy_q: A
// never goes through shared memory, and each warp sums dx over its q half
// (the two halves are added in a fixed order at the head's end).
// Writes dx, ddt, dacum's column and state parts, the group's dCB partial
// (dcbp, (BC, nhg, Q, Q), rows q >= j0 of the tile's columns) and the
// tile's row sums of E (rowp, (BC, njt, Q, H)).
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_dx_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ acum, const float* __restrict__ Bm,
                  const float* __restrict__ Cm, const float* __restrict__ dy,
                  const float* __restrict__ dS, float* __restrict__ dx,
                  float* __restrict__ ddt, float* __restrict__ dacum,
                  float* __restrict__ dcbp, float* __restrict__ rowp, int BC,
                  int Q, int H, int P, int N) {
  extern __shared__ __align__(16) float smem[];
  const int njt = (Q + kT - 1) / kT, nhg = (H + kBHG - 1) / kBHG;
  // this thread's fragments of C.B^T and of the group's dCB, per q tile
  // on and below the diagonal: [qt - jt][4 n + e][tid], each element
  // written and read by its own thread only
  float* sCB = smem;
  float* sDCB = sCB + njt * kFrag * kThreads;
  // B_j's N chunks, split, for the whole CTA
  bf16* sBj = reinterpret_cast<bf16*>(sDCB + njt * kFrag * kThreads);
  bf16* sX = sBj + 2 * kSplit;
  // two split tiles: C or dS chunks, or dy_q in turns; at a head's end the
  // q half 1 warps' dx partials (32 x 128 floats)
  bf16* sOp = sX + kSplit;
  float* sXch = reinterpret_cast<float*>(sOp);
  float* sAcJ = reinterpret_cast<float*>(sOp + 2 * kSplit);  // kT each
  float* sDtJ = sAcJ + kT;
  float* sAcQ = sDtJ + kT;      // 2 x kT, with dy_q's buffer
  float* sWZ = sAcQ + 2 * kT;
  float* sDdt = sWZ + kT;
  float* sDac = sDdt + kT;
  float* sZ = sDac + kT;        // 2 x kT: Z per p half
  float* sRedG = sZ + 2 * kT;   // 2 x kT: G CB's row sums per q half
  float* sRedE = sRedG + 2 * kT;
  float* sRowP = sRedE + 2 * kT;  // njt x 4 x kT: E's column sums per j block

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = warp / 2 * 16, half = warp % 2, qh = half * 32;
  const int jt = (int)(blockIdx.x / (nhg * BC));
  const int rem = (int)(blockIdx.x % (nhg * BC));
  const size_t bc = rem / nhg;
  const int hg = rem % nhg;
  const int h0 = hg * kBHG, h1 = min(h0 + kBHG, H);
  const int j0 = jt * kT;
  const int nch = (N + kT - 1) / kT;  // N chunks: 1 or 2
  const size_t HP = (size_t)H * P;
  const float* Cg = Cm + bc * Q * N;
  const float* Bg = Bm + bc * Q * N;
  float v[kFrag], vc[kMaxN / kT][kFrag];

  // C.B^T, transposed: (j rows, q columns) on the q tiles on and below the
  // diagonal, both N chunks at once; the next q tile's C loads while this
  // one multiplies
#pragma unroll
  for (int c = 0; c < kMaxN / kT; ++c)
    if (c < nch) {
      tile_load_rm(v, Bg, N, j0, c * kT, Q, N);
      tile_load_rm(vc[c], Cg, N, j0, c * kT, Q, N);
      tile_store(sBj + c * kSplit, v);
    }
  for (int qt = jt; qt < njt; ++qt) {
    if (qt > jt) __syncthreads();  // previous tile's reads done
#pragma unroll
    for (int c = 0; c < kMaxN / kT; ++c)
      if (c < nch) tile_store(sOp + c * kSplit, vc[c]);
    __syncthreads();
    if (qt + 1 < njt)
#pragma unroll
      for (int c = 0; c < kMaxN / kT; ++c)
        if (c < nch) tile_load_rm(vc[c], Cg, N, (qt + 1) * kT, c * kT, Q, N);
    float acc[4][4];
    zero_frag(acc);
#pragma unroll
    for (int c = 0; c < kMaxN / kT; ++c)
      if (c < nch)
        warp_mma3<false, false>(acc, sBj + c * kSplit, sOp + c * kSplit, m0,
                                qh, ksteps(N - c * kT));
    float* cb = sCB + (qt - jt) * kFrag * kThreads + tid;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) cb[(4 * n + e) * kThreads] = acc[n][e];
  }

  // a head's x_j (v) and dS chunks (vc): the first head's here, each
  // next one's during the last q tile of the head before
  auto load_head = [&](int h) {
#pragma unroll
    for (int c = 0; c < kMaxN / kT; ++c)
      if (c < nch)
        tile_load_rm(vc[c], dS + (bc * H + h) * (size_t)P * N, N, 0, c * kT,
                     P, N);
    tile_load_rm(v, x + bc * Q * HP + (size_t)h * P, HP, j0, 0, Q, P);
  };
  load_head(h0);
  for (int h = h0; h < h1; ++h) {
    const float ac_last = acum[(bc * Q + Q - 1) * H + h];
    const float* dyh = dy + bc * Q * HP + (size_t)h * P;  // row q at q HP
    __syncthreads();  // previous head's (or C.B^T's) reads done
    tile_store(sX, v);
#pragma unroll
    for (int c = 0; c < kMaxN / kT; ++c)
      if (c < nch) tile_store(sOp + c * kSplit, vc[c]);
    tile_load_rm(v, dyh, HP, j0, 0, Q, P);
    if (tid < kT) {
      const bool in = j0 + tid < Q;
      const size_t i = (bc * Q + j0 + tid) * H + h;
      sAcJ[tid] = in ? acum[i] : 0.f;
      sDtJ[tid] = in ? dt[i] : 0.f;
    }
    __syncthreads();
    // this thread's rows' a_cum and dt
    const float acj[2] = {sAcJ[m0 + g], sAcJ[m0 + g + 8]};
    const float dtj[2] = {sDtJ[m0 + g], sDtJ[m0 + g + 8]};

    // state part: U = B_j dS^T on this warp's p half
    float u[4][4];
    zero_frag(u);
#pragma unroll
    for (int c = 0; c < kMaxN / kT; ++c)
      if (c < nch)
        warp_mma3<false, false>(u, sBj + c * kSplit, sOp + c * kSplit, m0,
                                qh, ksteps(N - c * kT));
    // Z_j = x_j . U_j (x from its split halves); U becomes w_j U_j
    float z[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int at = (m0 + g + 8 * (e / 2)) * kLH + qh + 8 * n + 2 * t
                       + e % 2;
        const float xv = __bfloat162float(sX[at]) +
                         __bfloat162float(sX[kTileH + at]);
        z[e / 2] += xv * u[n][e];
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int jj = m0 + g + 8 * hh;
      z[hh] = rt::quad_sum(z[hh]);
      if (t == 0) sZ[half * kT + jj] = z[hh];
      const float w = j0 + jj < Q ? expf(ac_last - acj[hh]) * dtj[hh] : 0.f;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        u[n][2 * hh] *= w;
        u[n][2 * hh + 1] *= w;
      }
    }
    __syncthreads();  // sZ complete; every warp's reads of sOp done
    if (tid < kT) {
      const float zz = sZ[tid] + sZ[kT + tid];
      const float ed = j0 + tid < Q ? expf(ac_last - sAcJ[tid]) : 0.f;
      const float w = ed * sDtJ[tid];
      sDdt[tid] = ed * zz;
      sDac[tid] = -w * zz;
      sWZ[tid] = w * zz;
    }

    // dx_j partial over this warp's q half (16 j rows x 64 p columns),
    // starting from w U on this warp's p half
    float dxa[8][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dxa[n][e] = half ? 0.f : u[n][e];
        dxa[4 + n][e] = half ? u[n][e] : 0.f;
      }
    float colG[2] = {0.f, 0.f}, colE[2] = {0.f, 0.f};
    for (int qt = jt; qt < njt; ++qt) {
      const int q0 = qt * kT, b = (qt - jt) & 1;
      // dy_q into buffer b: its readers two tiles ago are past the
      // barrier of the tile between
      bf16* sDY = sOp + b * kSplit;
      tile_store(sDY, v);
      if (tid < kT)
        sAcQ[b * kT + tid] =
            q0 + tid < Q ? acum[(bc * Q + q0 + tid) * H + h] : 0.f;
      __syncthreads();
      if (qt + 1 < njt) tile_load_rm(v, dyh, HP, q0 + kT, 0, Q, P);
      else if (h + 1 < h1) load_head(h + 1);
      // dA^T = x_j dy_q^T (j rows, q columns)
      float da[4][4];
      zero_frag(da);
      warp_mma3<false, false>(da, sX, sDY, m0, qh, ksteps(P));
      const float* cb = sCB + (qt - jt) * kFrag * kThreads + tid;
      float* dcb = sDCB + (qt - jt) * kFrag * kThreads + tid;
      const bool full = qt > jt && q0 + kT <= Q;  // no pair masked
      float acq[4][2], rowE[4][2];  // this thread's columns' a_cum
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          acq[n][c] = sAcQ[b * kT + qh + 8 * n + 2 * t + c];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jj = m0 + g + 8 * (e / 2), qq = qh + 8 * n + 2 * t + e % 2;
          const int q = q0 + qq;
          float a = 0.f, gv = 0.f, ev = 0.f;
          // masked before the exponential: exp(-inf) = 0 above the diagonal
          if (full || (j0 + jj <= q && q < Q)) {
            const float l = expf(acq[n][e % 2] - acj[e / 2]);
            const float cbv = cb[(4 * n + e) * kThreads];
            gv = da[n][e] * l;
            a = cbv * l * dtj[e / 2];
            ev = da[n][e] * a;
            colG[e / 2] += gv * cbv;
            colE[e / 2] += ev;
          }
          if (e < 2) rowE[n][e] = ev;
          else rowE[n][e - 2] += ev;
          da[n][e] = a;
          const float d = gv * dtj[e / 2];
          float& s = dcb[(4 * n + e) * kThreads];
          s = h == h0 ? d : s + d;
        }
      // E's column sums (its rows q) over this warp's 16 j rows
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float s = rowE[n][c];
          for (int o = 4; o < 32; o <<= 1)
            s += __shfl_xor_sync(0xffffffffu, s, o);
          if (g == 0)
            sRowP[((qt - jt) * 4 + warp / 2) * kT + qh + 8 * n + 2 * t + c] =
                s;
        }
      // dx_j += A^T dy_q over this warp's q half: A^T's fragment is the
      // A operand of k-steps (n-tiles 2 kk, 2 kk + 1) as it stands
      if (q0 + qh < Q) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t ah[4], al[4];
          rt::split_bf16x2(da[2 * kk][0], da[2 * kk][1], ah[0], al[0]);
          rt::split_bf16x2(da[2 * kk][2], da[2 * kk][3], ah[1], al[1]);
          rt::split_bf16x2(da[2 * kk + 1][0], da[2 * kk + 1][1], ah[2],
                           al[2]);
          rt::split_bf16x2(da[2 * kk + 1][2], da[2 * kk + 1][3], ah[3],
                           al[3]);
#pragma unroll
          for (int jb = 0; jb < 4; ++jb) {
            const int bo = rt::tc_bkn_off(qh + 16 * kk, 16 * jb, kLH);
            uint32_t bh[4], bl[4];
            rt::ldmatrix_x4_trans(bh, sDY + bo);
            rt::ldmatrix_x4_trans(bl, sDY + kTileH + bo);
#pragma unroll
            for (int s = 0; s < 2; ++s) {
              float f[4];
              rt::mma_bf16_zc(f, ah, bh[2 * s], bh[2 * s + 1]);
              rt::mma_bf16(f, ah, bl[2 * s], bl[2 * s + 1]);
              rt::mma_bf16(f, al, bh[2 * s], bh[2 * s + 1]);
#pragma unroll
              for (int e = 0; e < 4; ++e) dxa[2 * jb + s][e] += f[e];
            }
          }
        }
      }
    }

    __syncthreads();  // every warp's reads of the dy buffers done
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float gs = rt::quad_sum(colG[hh]), es = rt::quad_sum(colE[hh]);
      if (t == 0) {
        sRedG[half * kT + m0 + g + 8 * hh] = gs;
        sRedE[half * kT + m0 + g + 8 * hh] = es;
      }
    }
    // dx = the q half 0 partial + the q half 1 partial
    float* xch = sXch + (warp / 2) * 32 + lane;
    if (half == 1)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) xch[(4 * n + e) * 128] = dxa[n][e];
    __syncthreads();
    if (half == 0) {
      float* dxh = dx + bc * Q * HP + (size_t)h * P;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + m0 + g + 8 * (e / 2), p = 8 * n + 2 * t + e % 2;
          if (j < Q && p < P)
            dxh[(size_t)j * HP + p] = dxa[n][e] + xch[(4 * n + e) * 128];
        }
    }
    if (tid < kT && j0 + tid < Q) {
      const size_t i = (bc * Q + j0 + tid) * H + h;
      ddt[i] = (sRedG[tid] + sRedG[kT + tid]) + sDdt[tid];
      dacum[i] = sDac[tid] - (sRedE[tid] + sRedE[kT + tid]);
    }
    for (int k = tid; k < (njt - jt) * kT; k += kThreads) {
      const int q = j0 + k;
      if (q >= Q) break;
      const float* rp = sRowP + (k / kT * 4) * kT + k % kT;
      float r = ((rp[0] + rp[kT]) + rp[2 * kT]) + rp[3 * kT];
      if (q == Q - 1)  // dacum_last += sum_j w_j Z_j over this j tile
        for (int kk = 0; kk < kT; ++kk) r += sWZ[kk];
      rowp[(((size_t)bc * njt + jt) * Q + q) * H + h] = r;
    }
  }

  // the group's dCB, transposed back: element (n, e) is row
  // q = qt 64 + qh + 8 n + 2 t + e % 2, column j0 + m0 + g + 8 (e / 2)
  float* dg = dcbp + (bc * nhg + hg) * (size_t)Q * Q;
  for (int qt = jt; qt < njt; ++qt) {
    const float* dcb = sDCB + (qt - jt) * kFrag * kThreads + tid;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = qt * kT + qh + 8 * n + 2 * t + e % 2;
        const int j = j0 + m0 + g + 8 * (e / 2);
        if (q < Q && j < Q)
          dg[(size_t)q * Q + j] = dcb[(4 * n + e) * kThreads];
      }
  }
}

// Backward, between the parts: dCB[q][j] for j <= q < Q, the groups'
// partials summed in group order into group 0's slot; one thread per
// (b·chunk, q, j), grid (ceil(Q * Q / kThreads), BC).
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dcb_sum_kernel(float* __restrict__ dcbp, int Q, int nhg) {
  const int e = (int)blockIdx.x * kThreads + threadIdx.x;
  const int q = e / Q, j = e % Q;
  if (q >= Q || j > q) return;
  float* dg = dcbp + (size_t)blockIdx.y * nhg * Q * Q + (size_t)q * Q + j;
  float s = 0.f;
  for (int g = 0; g < nhg; ++g) s += dg[(size_t)g * Q * Q];
  dg[0] = s;
}

// Backward, part 2: grid (nrt * nnt, BC), one CTA per 64-row tile (r0)
// and 64-column N tile (n0), 8 warps as in part 1; 2 CTAs per SM.
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_dbc_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ acum,
                   const float* __restrict__ Bm, const float* __restrict__ Cm,
                   const float* __restrict__ dS,
                   const float* __restrict__ dcbp,
                   const float* __restrict__ rowp, float* __restrict__ dacum,
                   float* __restrict__ dB, float* __restrict__ dC, int Q,
                   int H, int P, int N) {
  extern __shared__ __align__(16) float smem[];
  bf16* sP = reinterpret_cast<bf16*>(smem);  // A: dCB, dCB^T, w x_h
  bf16* sQ = sP + kSplit;                     // B: B, C, dS_h
  float* sW = reinterpret_cast<float*>(sQ + kSplit);  // 2 x kT: w_j

  const int tid = threadIdx.x, warp = tid / 32;
  const int m0 = warp / 2 * 16, n0 = warp % 2 * 32;
  const int nnt = (N + kT - 1) / kT, nhg = (H + kBHG - 1) / kBHG;
  const int rt_ = (int)(blockIdx.x / nnt), nt = (int)(blockIdx.x % nnt);
  const size_t bc = blockIdx.y;
  const int r0 = rt_ * kT, c0 = nt * kT;
  const size_t HP = (size_t)H * P;
  const float* Bg = Bm + bc * Q * N;
  const float* Cg = Cm + bc * Q * N;
  const float* dg = dcbp + bc * nhg * (size_t)Q * Q;  // group 0: the sum
  auto dcb_at = [&](int q, int j) {
    return q < Q && j <= q ? dg[(size_t)q * Q + j] : 0.f;
  };
  float v[kFrag], acc[4][4];

  // dC[q] = sum_{j <= q} dCB[q][j] B[j]
  zero_frag(acc);
  for (int jc = 0; jc < min(r0 + kT, Q); jc += kT) {
    __syncthreads();  // previous chunk's reads done
    tile_load(v, [&](int r, int c) { return dcb_at(r0 + r, jc + c); });
    tile_store(sP, v);
    tile_load_rm(v, Bg, N, jc, c0, Q, N);
    tile_store(sQ, v);
    __syncthreads();
    warp_mma3<false, true, false>(acc, sP, sQ, m0, n0, ksteps(Q - jc));
  }
  frag_store(dC + bc * Q * N, N, r0, c0, Q, N, m0, n0, acc);

  // dB[j] = sum_{q >= j} dCB[q][j] C[q] + sum_h w_hj sum_p x_h[j][p] dS_h[p]
  zero_frag(acc);
  for (int qc = r0; qc < Q; qc += kT) {
    __syncthreads();
    tile_load(v, [&](int r, int c) { return dcb_at(qc + r, r0 + c); });
    tile_store(sP, v);
    tile_load_rm(v, Cg, N, qc, c0, Q, N);
    tile_store(sQ, v);
    __syncthreads();
    warp_mma3<true, true, false>(acc, sP, sQ, m0, n0, ksteps(Q - qc));
  }
  // the state part, K = H P: head h + 1's tiles load (and its w_j is
  // formed, once per row) while h's multiply
  float vs[kFrag];
  auto load_head = [&](int h) {
    if (tid < kT) {
      const int j = r0 + tid;
      float w = 0.f;
      if (j < Q) {
        const size_t k = (bc * Q + j) * H + h;
        w = expf(acum[(bc * Q + Q - 1) * H + h] - acum[k]) * dt[k];
      }
      sW[(h & 1) * kT + tid] = w;
    }
    tile_load_rm(v, x + bc * Q * HP + (size_t)h * P, HP, r0, 0, Q, P);
    tile_load_rm(vs, dS + (bc * H + h) * (size_t)P * N, N, 0, c0, P, N);
  };
  load_head(0);
  for (int h = 0; h < H; ++h) {
    // previous head's (or dCB's) reads done; w_j formed: its buffer's
    // readers two heads ago are past the barrier of the head between
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kFrag / 2; ++i) {  // x_h [j][p] times w_j
      const float w = sW[(h & 1) * kT + (tid + kThreads * i) / 32];
      v[2 * i] *= w;
      v[2 * i + 1] *= w;
    }
    tile_store(sP, v);
    tile_store(sQ, vs);
    __syncthreads();
    if (h + 1 < H) load_head(h + 1);
    warp_mma3<false, true, false>(acc, sP, sQ, m0, n0, ksteps(P));
  }
  frag_store(dB + bc * Q * N, N, r0, c0, Q, N, m0, n0, acc);

  // dacum += the row sums of E over the j tiles on and left of the diagonal
  if (nt != 0) return;
  const int njt = (Q + kT - 1) / kT;
  const float* rp = rowp + bc * njt * (size_t)Q * H;
  for (int e = tid; e < kT * H; e += kThreads) {
    const int k = r0 + e / H, h = e % H;
    if (k >= Q) break;
    const size_t i = (bc * Q + k) * H + h;
    float s = dacum[i];
    for (int jt = 0; jt <= rt_; ++jt) s += rp[((size_t)jt * Q + k) * H + h];
    dacum[i] = s;
  }
}

}  // namespace

extern "C" int rt_ssd_intra(const void* x, const void* dt, const void* acum,
                            const void* Bm, const void* Cm, void* y, void* S,
                            int BC, int Q, int H, int P, int N,
                            void* stream) {
  if (Q < 1 || Q > kMaxQ || N < 1 || N > kMaxN || P < 1 || P > kMaxP ||
      H < 1 || BC < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem_y =
      ((size_t)kBQ * cb_stride(Q) + kBK * kLX + kBQ * kLA + kBQ + 2 * kBK) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_y_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_y);
  if (err != cudaSuccess) return (int)err;
  const int nqt = (Q + kBQ - 1) / kBQ, nhg = (H + kHG - 1) / kHG;
  ssd_y_kernel<<<dim3(nqt * nhg, BC), kThreads, smem_y, st>>>(
      (const float*)x, (const float*)dt, (const float*)acum,
      (const float*)Bm, (const float*)Cm, (float*)y, Q, H, P, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem_s = ((size_t)kBJ * (kMaxP + kMaxN) + kBJ) * sizeof(float);
  ssd_state_kernel<<<dim3(H, BC), kThreads, smem_s, st>>>(
      (const float*)x, (const float*)dt, (const float*)acum,
      (const float*)Bm, (float*)S, Q, H, P, N);
  return (int)cudaGetLastError();
}

// The backward's fp32 scratch: dcbp (BC, nhg, Q, Q) then rowp
// (BC, njt, Q, H).  The caller allocates this many floats.
extern "C" long long rt_ssd_intra_bwd_scratch_floats(int BC, int Q, int H) {
  const int njt = (Q + kT - 1) / kT, nhg = (H + kBHG - 1) / kBHG;
  return (long long)BC * Q * ((long long)nhg * Q + (long long)njt * H);
}

// scratch: at least rt_ssd_intra_bwd_scratch_floats(BC, Q, H) floats
extern "C" int rt_ssd_intra_bwd(const void* x, const void* dt,
                                const void* acum, const void* Bm,
                                const void* Cm, const void* dy, const void* dS,
                                void* dx, void* ddt, void* dacum, void* dB,
                                void* dC, void* scratch,
                                long long scratch_floats, int BC, int Q, int H,
                                int P, int N, void* stream) {
  if (Q < 1 || Q > kMaxQ || N < 1 || N > kMaxN || P < 1 || P > kMaxP ||
      H < 1 || BC < 1)
    return (int)cudaErrorInvalidValue;
  const int njt = (Q + kT - 1) / kT, nhg = (H + kBHG - 1) / kBHG;
  const int nnt = (N + kT - 1) / kT;
  const long long dcb_floats = (long long)BC * nhg * Q * Q;
  if (scratch_floats < rt_ssd_intra_bwd_scratch_floats(BC, Q, H))
    return (int)cudaErrorInvalidValue;
  float* dcbp = (float*)scratch;
  float* rowp = dcbp + dcb_floats;
  const cudaStream_t st = (cudaStream_t)stream;
  // the C.B^T and dCB fragments, five split tiles (B_j's two N chunks,
  // x_j, two operands) and 13 + 4 njt vectors of kT floats: 230,656 B at
  // Q 256, within the 232,448 B a block may have
  const size_t smem_dx = (size_t)2 * njt * kFrag * kThreads * sizeof(float) +
                         (size_t)5 * kSplit * sizeof(bf16) +
                         (size_t)(13 + 4 * njt) * kT * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_dx);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_dx_kernel<<<njt * nhg * BC, kThreads, smem_dx, st>>>(
      (const float*)x, (const float*)dt, (const float*)acum,
      (const float*)Bm, (const float*)Cm, (const float*)dy,
      (const float*)dS, (float*)dx, (float*)ddt, (float*)dacum, dcbp, rowp,
      BC, Q, H, P, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (nhg > 1) {
    const dim3 grid_sum((Q * Q + kThreads - 1) / kThreads, BC);
    ssd_bwd_dcb_sum_kernel<<<grid_sum, kThreads, 0, st>>>(dcbp, Q, nhg);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem_bc =
      (size_t)2 * kSplit * sizeof(bf16) + (size_t)2 * kT * sizeof(float);
  ssd_bwd_dbc_kernel<<<dim3(njt * nnt, BC), kThreads, smem_bc, st>>>(
      (const float*)x, (const float*)dt, (const float*)acum,
      (const float*)Bm, (const float*)Cm, (const float*)dS, dcbp, rowp,
      (float*)dacum, (float*)dB, (float*)dC, Q, H, P, N);
  return (int)cudaGetLastError();
}
