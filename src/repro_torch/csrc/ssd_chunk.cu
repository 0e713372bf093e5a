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
// What bounds it: at the main shape the call does ~37 GFLOP (per head the
// causal halves of dA and of A^T dy, the state products U and (w x)^T dS;
// per (b·chunk) C.B^T once and dB, dC against dCB) and moves ~0.51 GB,
// so fp32 operations bound it (~0.55 ms at 67 TFLOP/s), by ~3.6x over
// bytes.  All of it runs as fp32 FMAs on the CUDA cores, as the forward.
// What the design does about the bound:
// - ssd_bwd_dx_kernel: one CTA per (b·chunk, 64-column j tile, group of 8
//   heads).  It computes the (Q - j0) x 64 strip of C.B^T once into shared
//   memory and reuses it for its heads; per head it keeps x_j and the dx_j
//   accumulator resident while it walks the q tiles on and below the
//   diagonal (tiles above it are skipped), so each dA tile is formed once
//   and feeds dx, ddt and dacum's column sums in registers.  dCB for the
//   group is summed over its heads in shared memory, in head order, and
//   written once to a (b·chunk, group, Q, Q) scratch; the rows of E are
//   summed per j tile into a second scratch.  The CTAs of j tile 0 (the
//   most q tiles) are scheduled first.
// - ssd_bwd_dcb_sum_kernel: sums the groups' dCB partials, in group order,
//   into group 0's slot, once, on and below the diagonal (with one group
//   it is not launched).
// - ssd_bwd_dbc_kernel: one CTA per (b·chunk, 64-row tile, 64-column N
//   tile) forms dC and dB as products with that dCB sum and the state part
//   of dB over (head, p); the CTAs of N tile 0 also add the row sums to
//   dacum.
// No atomics: every sum runs in a fixed order, so two calls give
// bit-identical gradients.
#include "common.cuh"

namespace {

using rt::kThreads;

constexpr int kMaxQ = 256, kMaxN = 128, kMaxP = 64;
constexpr int kBQ = 64;   // q rows per CTA (y part)
constexpr int kBK = 64;   // j columns per tile (y part)
constexpr int kNK = 32;   // N chunk of the C.B^T product
constexpr int kHG = 8;    // heads per CTA sharing one C.B^T strip
constexpr int kBJ = 32;   // Q rows per tile (state part)
constexpr int kLNK = kNK + 1, kLX = kMaxP + 1, kLA = kBK + 1;
constexpr int kBT = 64;   // backward: q and j tile (= kBK)
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

// Backward, part 1: grid (njt * nhg * BC) with the j tile slowest, so the
// CTAs of j tile 0 (the most q tiles) run first; 256 threads as 16 x 16.
// Writes dx, ddt, dacum's column and state parts, the group's dCB partial
// (dcbp, (BC, nhg, Q, Q), rows q >= j0 of the tile's columns) and the
// tile's row sums of E (rowp, (BC, njt, Q, H)).
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dx_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ acum, const float* __restrict__ Bm,
                  const float* __restrict__ Cm, const float* __restrict__ dy,
                  const float* __restrict__ dS, float* __restrict__ dx,
                  float* __restrict__ ddt, float* __restrict__ dacum,
                  float* __restrict__ dcbp, float* __restrict__ rowp, int BC,
                  int Q, int H, int P, int N) {
  extern __shared__ float smem[];
  const int R = ((Q + kBT - 1) / kBT) * kBT;
  float* sCB = smem;                  // R x kLA: C[j0 + i] . B[j0 + jj]
  float* sDCB = sCB + R * kLA;        // R x kLA: sum over heads of G dt_j
  float* work = sDCB + R * kLA;
  float* sC = work;                   // C.B^T: kBT x kLNK each
  float* sB = sC + kBT * kLNK;
  float* sX = work;                   // per head: x_j, kBT x kLX
  float* sDY = sX + kBT * kLX;        // dy_q tile, kBT x kLX
  float* sA = sDY + kBT * kLX;        // A[q][j] tile, kBT x kLA
  float* sBn = sDY;                   // state part: B_j chunk, kBT x kLNK
  float* sDS = sA;                    // state part: dS chunk, kBT x kLNK
  float* sRedG = sDY;                 // column sums: 16 x kBT each
  float* sRedE = sA;
  float* sAcJ = sA + kBT * kLA;       // kBT each
  float* sDtJ = sAcJ + kBT;
  float* sAcQ = sDtJ + kBT;
  float* sWZ = sAcQ + kBT;
  float* sDdt = sWZ + kBT;
  float* sDac = sDdt + kBT;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int njt = (Q + kBT - 1) / kBT, nhg = (H + kBHG - 1) / kBHG;
  const int jt = (int)(blockIdx.x / (nhg * BC));
  const int rem = (int)(blockIdx.x % (nhg * BC));
  const size_t bc = rem / nhg;
  const int hg = rem % nhg;
  const int h0 = hg * kBHG, h1 = min(h0 + kBHG, H);
  const int j0 = jt * kBT;
  const float* Cg = Cm + bc * Q * N;
  const float* Bg = Bm + bc * Q * N;

  // sCB[q - j0][jj] = C[q] . B[j0 + jj] for the q tiles on and below the
  // diagonal
  for (int qt = jt; qt < njt; ++qt) {
    const int q0 = qt * kBT;
    float cb[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) cb[r][c] = 0.f;
    for (int n0 = 0; n0 < N; n0 += kNK) {
      __syncthreads();  // previous chunk's reads done
      for (int e = tid; e < kBT * kNK; e += kThreads) {
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
        sCB[(q0 - j0 + ty * 4 + r) * kLA + tx + 16 * c] = cb[r][c];
  }

  for (int h = h0; h < h1; ++h) {
    const float ac_last = acum[(bc * Q + Q - 1) * H + h];
    __syncthreads();  // previous head's (or C.B^T's) reads done
    for (int e = tid; e < kBT * kMaxP; e += kThreads) {
      const int r = e / kMaxP, p = e % kMaxP;
      sX[r * kLX + p] = (j0 + r < Q && p < P)
                            ? x[((bc * Q + j0 + r) * H + h) * P + p]
                            : 0.f;
    }
    if (tid < kBT) {
      const bool in = j0 + tid < Q;
      const size_t i = (bc * Q + j0 + tid) * H + h;
      sAcJ[tid] = in ? acum[i] : 0.f;
      sDtJ[tid] = in ? dt[i] : 0.f;
    }

    // state part: U[j][p] = B_j . dS[p] (thread: j = ty*4 + r, p = tx + 16c)
    const float* dSg = dS + (bc * H + h) * (size_t)P * N;
    float dxa[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) dxa[r][c] = 0.f;
    for (int n0 = 0; n0 < N; n0 += kNK) {
      __syncthreads();
      for (int e = tid; e < kBT * kNK; e += kThreads) {
        const int r = e / kNK, c = e % kNK;
        const bool in = n0 + c < N;
        sBn[r * kLNK + c] =
            (in && j0 + r < Q) ? Bg[(size_t)(j0 + r) * N + n0 + c] : 0.f;
        sDS[r * kLNK + c] =
            (in && r < P) ? dSg[(size_t)r * N + n0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int n = 0; n < kNK; ++n) {
        float dv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) dv[c] = sDS[(tx + 16 * c) * kLNK + n];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float bv = sBn[(ty * 4 + r) * kLNK + n];
#pragma unroll
          for (int c = 0; c < 4; ++c) dxa[r][c] += bv * dv[c];
        }
      }
    }
    // Z_j = x_j . U_j; dx starts as w_j U_j
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int jj = ty * 4 + r;
      const float ed = j0 + jj < Q ? expf(ac_last - sAcJ[jj]) : 0.f;
      const float w = ed * sDtJ[jj];
      float z = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        z += sX[jj * kLX + tx + 16 * c] * dxa[r][c];
        dxa[r][c] *= w;
      }
      z = rt::row_sum16(z);
      if (tx == 0) {
        sDdt[jj] = ed * z;
        sDac[jj] = -w * z;
        sWZ[jj] = w * z;
      }
    }

    float colG[4], colE[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) colG[c] = colE[c] = 0.f;
    for (int qt = jt; qt < njt; ++qt) {
      const int q0 = qt * kBT;
      __syncthreads();  // previous tile's (or the state part's) reads done
      for (int e = tid; e < kBT * kMaxP; e += kThreads) {
        const int r = e / kMaxP, p = e % kMaxP;
        sDY[r * kLX + p] = (q0 + r < Q && p < P)
                               ? dy[((bc * Q + q0 + r) * H + h) * P + p]
                               : 0.f;
      }
      if (tid < kBT)
        sAcQ[tid] = q0 + tid < Q ? acum[(bc * Q + q0 + tid) * H + h] : 0.f;
      __syncthreads();
      // dA[q][j] = dy_q . x_j (thread: q = ty*4 + r, j = tx + 16c)
      float da[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) da[r][c] = 0.f;
#pragma unroll 8
      for (int p = 0; p < P; ++p) {
        float xv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) xv[c] = sX[(tx + 16 * c) * kLX + p];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float dv = sDY[(ty * 4 + r) * kLX + p];
#pragma unroll
          for (int c = 0; c < 4; ++c) da[r][c] += dv * xv[c];
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int qq = ty * 4 + r, q = q0 + qq;
        float rowE = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int jj = tx + 16 * c;
          const int i = (q0 - j0 + qq) * kLA + jj;
          float a = 0.f, g = 0.f;
          // masked before the exponential: exp(-inf) = 0 above the diagonal
          if (j0 + jj <= q && q < Q) {
            const float l = expf(sAcQ[qq] - sAcJ[jj]);
            const float cb = sCB[i];
            g = da[r][c] * l;
            a = cb * l * sDtJ[jj];
            const float e = da[r][c] * a;
            colG[c] += g * cb;
            colE[c] += e;
            rowE += e;
          }
          sA[qq * kLA + jj] = a;
          const float dcb = g * sDtJ[jj];
          sDCB[i] = h == h0 ? dcb : sDCB[i] + dcb;
        }
        rowE = rt::row_sum16(rowE);
        if (tx == 0 && q < Q) {
          if (q == Q - 1)  // dacum_last += sum_j w_j Z_j over this j tile
            for (int k = 0; k < kBT; ++k) rowE += sWZ[k];
          rowp[(((size_t)bc * njt + jt) * Q + q) * H + h] = rowE;
        }
      }
      __syncthreads();  // sA complete
      // dx[j][p] += sum_q A[q][j] dy[q][p] (thread: j = ty*4 + r, p = tx+16c)
#pragma unroll 8
      for (int qq = 0; qq < kBT; ++qq) {
        float dv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) dv[c] = sDY[qq * kLX + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float a = sA[qq * kLA + ty * 4 + r];
#pragma unroll
          for (int c = 0; c < 4; ++c) dxa[r][c] += a * dv[c];
        }
      }
    }

    __syncthreads();  // last tile's reads done: sDY, sA hold the column sums
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      sRedG[ty * kBT + tx + 16 * c] = colG[c];
      sRedE[ty * kBT + tx + 16 * c] = colE[c];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + ty * 4 + r;
      if (j >= Q) continue;
      float* o = dx + ((bc * Q + j) * H + h) * P;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (tx + 16 * c < P) o[tx + 16 * c] = dxa[r][c];
    }
    __syncthreads();
    if (tid < kBT && j0 + tid < Q) {
      float g = 0.f, e = 0.f;
      for (int k = 0; k < 16; ++k) {
        g += sRedG[k * kBT + tid];
        e += sRedE[k * kBT + tid];
      }
      const size_t i = (bc * Q + j0 + tid) * H + h;
      ddt[i] = g + sDdt[tid];
      dacum[i] = sDac[tid] - e;
    }
  }

  __syncthreads();  // sDCB complete
  float* dg = dcbp + (bc * nhg + hg) * (size_t)Q * Q;
  for (int e = tid; e < (Q - j0) * kBT; e += kThreads) {
    const int i = e / kBT, jj = e % kBT;
    if (j0 + jj < Q) dg[(size_t)(j0 + i) * Q + j0 + jj] = sDCB[i * kLA + jj];
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

// Backward, part 2: grid (nrt * nnt, BC), 256 threads as 16 x 16; thread
// (ty, tx) owns rows ty*4 + r and columns n0 + tx + 16c of its tile.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dbc_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ acum,
                   const float* __restrict__ Bm, const float* __restrict__ Cm,
                   const float* __restrict__ dS,
                   const float* __restrict__ dcbp,
                   const float* __restrict__ rowp, float* __restrict__ dacum,
                   float* __restrict__ dB, float* __restrict__ dC, int Q,
                   int H, int P, int N) {
  extern __shared__ float smem[];
  float* sL = smem;                // kBT x kLNK: dCB[q][j], w x[j][p]
  float* sR = sL + kBT * kLNK;     // kNK x kLX: B[j][n], C[q][n], dS[p][n]
  float* sT = sR + kNK * kLX;      // kNK x kLA: dCB[q chunk][j]
  float* sW = sT + kNK * kLA;      // kBT: w_j

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int nnt = (N + kBT - 1) / kBT, nhg = (H + kBHG - 1) / kBHG;
  const int t = (int)(blockIdx.x / nnt), nt = (int)(blockIdx.x % nnt);
  const size_t bc = blockIdx.y;
  const int r0 = t * kBT, n0 = nt * kBT;
  const float* Bg = Bm + bc * Q * N;
  const float* Cg = Cm + bc * Q * N;
  const float* dg = dcbp + bc * nhg * (size_t)Q * Q;  // group 0: the sum
  float acc[4][4];

  // dC[q] = sum_{j <= q} dCB[q][j] B[j]
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  for (int jc = 0; jc < min(r0 + kBT, Q); jc += kNK) {
    __syncthreads();  // previous chunk's reads done
    for (int e = tid; e < kBT * kNK; e += kThreads) {
      const int r = e / kNK, c = e % kNK, q = r0 + r, j = jc + c;
      sL[r * kLNK + c] = (q < Q && j <= q) ? dg[(size_t)q * Q + j] : 0.f;
    }
    for (int e = tid; e < kNK * kBT; e += kThreads) {
      const int r = e / kBT, c = e % kBT, j = jc + r;
      sR[r * kLX + c] =
          (j < Q && n0 + c < N) ? Bg[(size_t)j * N + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int jj = 0; jj < kNK; ++jj) {
      float bv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = sR[jj * kLX + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float d = sL[(ty * 4 + r) * kLNK + jj];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] += d * bv[c];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int q = r0 + ty * 4 + r;
    if (q >= Q) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (n0 + tx + 16 * c < N)
        dC[(bc * Q + q) * N + n0 + tx + 16 * c] = acc[r][c];
  }

  // dB[j] = sum_{q >= j} dCB[q][j] C[q] + sum_h w_hj sum_p x_h[j][p] dS_h[p]
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  for (int qc = r0; qc < Q; qc += kNK) {
    __syncthreads();
    for (int e = tid; e < kNK * kBT; e += kThreads) {
      const int r = e / kBT, c = e % kBT, q = qc + r, j = r0 + c;
      sT[r * kLA + c] = (q < Q && j <= q) ? dg[(size_t)q * Q + j] : 0.f;
      sR[r * kLX + c] =
          (q < Q && n0 + c < N) ? Cg[(size_t)q * N + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int qq = 0; qq < kNK; ++qq) {
      float cv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) cv[c] = sR[qq * kLX + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float d = sT[qq * kLA + ty * 4 + r];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] += d * cv[c];
      }
    }
  }
  for (int h = 0; h < H; ++h) {
    const float ac_last = acum[(bc * Q + Q - 1) * H + h];
    __syncthreads();  // previous reads of sW, sL, sR done
    if (tid < kBT) {
      const size_t i = (bc * Q + r0 + tid) * H + h;
      sW[tid] = r0 + tid < Q ? expf(ac_last - acum[i]) * dt[i] : 0.f;
    }
    for (int pc = 0; pc < P; pc += kNK) {
      __syncthreads();  // sW written / previous chunk's reads done
      for (int e = tid; e < kBT * kNK; e += kThreads) {
        const int r = e / kNK, c = e % kNK, j = r0 + r, p = pc + c;
        sL[r * kLNK + c] =
            (j < Q && p < P) ? x[((bc * Q + j) * H + h) * P + p] * sW[r] : 0.f;
      }
      const float* dSg = dS + ((bc * H + h) * (size_t)P + pc) * N;
      for (int e = tid; e < kNK * kBT; e += kThreads) {
        const int r = e / kBT, c = e % kBT;
        sR[r * kLX + c] =
            (pc + r < P && n0 + c < N) ? dSg[(size_t)r * N + n0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int pp = 0; pp < kNK; ++pp) {
        float dv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) dv[c] = sR[pp * kLX + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float xw = sL[(ty * 4 + r) * kLNK + pp];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] += xw * dv[c];
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = r0 + ty * 4 + r;
    if (j >= Q) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (n0 + tx + 16 * c < N)
        dB[(bc * Q + j) * N + n0 + tx + 16 * c] = acc[r][c];
  }

  // dacum += the row sums of E over the j tiles on and left of the diagonal
  if (nt != 0) return;
  const int njt = (Q + kBT - 1) / kBT;
  const float* rp = rowp + bc * njt * (size_t)Q * H;
  for (int e = tid; e < kBT * H; e += kThreads) {
    const int k = r0 + e / H, h = e % H;
    if (k >= Q) break;
    const size_t i = (bc * Q + k) * H + h;
    float s = dacum[i];
    for (int jt = 0; jt <= t; ++jt) s += rp[((size_t)jt * Q + k) * H + h];
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
  const int njt = (Q + kBT - 1) / kBT, nhg = (H + kBHG - 1) / kBHG;
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
  const int njt = (Q + kBT - 1) / kBT, nhg = (H + kBHG - 1) / kBHG;
  const int nnt = (N + kBT - 1) / kBT;
  const long long dcb_floats = (long long)BC * nhg * Q * Q;
  if (scratch_floats < rt_ssd_intra_bwd_scratch_floats(BC, Q, H))
    return (int)cudaErrorInvalidValue;
  float* dcbp = (float*)scratch;
  float* rowp = dcbp + dcb_floats;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem_dx =
      ((size_t)2 * njt * kBT * kLA + 2 * kBT * kLX + kBT * kLA + 6 * kBT) *
      sizeof(float);
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
      ((size_t)kBT * kLNK + kNK * kLX + kNK * kLA + kBT) * sizeof(float);
  ssd_bwd_dbc_kernel<<<dim3(njt * nnt, BC), kThreads, smem_bc, st>>>(
      (const float*)x, (const float*)dt, (const float*)acum,
      (const float*)Bm, (const float*)Cm, (const float*)dS, dcbp, rowp,
      (float*)dacum, (float*)dB, (float*)dC, Q, H, P, N);
  return (int)cudaGetLastError();
}
