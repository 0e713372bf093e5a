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
