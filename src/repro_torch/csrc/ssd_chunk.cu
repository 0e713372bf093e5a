// Mamba-2 SSD intra-chunk dual form for Hopper.
//
// Replaces the TPU Pallas kernel
//   repro/kernels/ssd_chunk/kernel.py::ssd_intra_pallas  (pallas_call :70)
// with the same math, per (b·chunk, head):
//   y[q] = sum_{j<=q} (C_q . B_j) * exp(acum_q - acum_j) * dt_j * x_j
//   S    = sum_j x_j (x) (B_j * exp(acum_last - acum_j) * dt_j)
// on fp32 inputs and outputs (the model casts to fp32 before the kernel),
// with the mask applied before the exponential as in the reference.
//
// Layouts, as the reference's public ones (the TPU wrapper transposed them
// head-major; here the kernels read them in place with strides):
// x, y (BC, Q, H, P); dt, acum (BC, Q, H); B, C (BC, Q, N); S (BC, H, P, N);
// BC = batch * chunks.  Q <= 256, N <= 128, P <= 64.
//
// Every product, forward and backward, runs on the tensor cores
// (tensor_core.cuh): warp-level mma.sync m16n8k16 bf16 -> fp32, each fp32
// operand split into bf16 planes as it is staged in shared memory or, for
// an operand formed in registers, where it is formed; each k-step's
// passes go into a fresh fragment that is then added in fp32 (the tensor
// cores round their sums toward zero, which a long K chain would
// accumulate).  The backward splits into hi + lo (rt::split_bf16x2) and
// runs three passes (hi.hi, hi.lo, lo.hi); the forward, held to 1e-5 of
// scale where the backward is held to 1e-4, splits into hi + mid + lo
// (rt::split_bf16x3, exact) and runs six (i + j <= 2): with two planes its
// chain of two products missed 1e-5 (1.4e-5 of scale; each operand's
// hi + lo keeps ~2^-17 of it).  The elementwise work between the products
// (the decays, masked before the exponential, dt, w) stays in fp32 on the
// CUDA cores.
//
// Forward (rt_ssd_intra: ssd_y_kernel, then ssd_state_kernel).  What
// bounds it: at the main path's shape (BC 64, Q 256, H 32, P 64, N 128)
// the products are ~17.8 GFLOP (C.B^T once per b·chunk over the causal
// pairs, A x per head, the state product; ~107 at 6 passes, 0.108 ms at
// 989 TFLOP/s), the elementwise work ~0.24 GFLOP, and the call moves
// ~0.36 GB (0.106 ms), so the passes bound it on paper.  In practice
// mma.sync runs the passes at about half that rate, and at 8 warps per SM
// (the C.B^T strip and the split tiles fill a block's shared memory) the
// phases between barriers add up rather than overlap: cutting parts on
// the H100 (scripts/torch_ssd_probe.py, PERF.md) saves about two fifths
// of ssd_y_kernel's time for the A x products, a fifth for the x tiles'
// loads and splits, a fifth for forming A, and two fifths of
// ssd_state_kernel's for its product.  What the design does about it:
// - ssd_y_kernel: one CTA per (b·chunk, 64-row q tile, group of 8 heads),
//   the heaviest q tiles (most j tiles) first, the j tiles above the
//   diagonal skipped.  Part 1: the CTA's 64-row strip of C.B^T (C_q split
//   once, B_j split per j tile, the next B_j loading while this one
//   multiplies), kept as fp32 fragments in shared memory in the layout of
//   part 2's accumulators.  Part 2 is flash-attention's forward without
//   the softmax: the two halves of the CTA (4 warps each) take two heads
//   at a time, each warp 16 q rows and all P columns, so A = CB L dt_j is
//   formed once per (q, j, head), masked only on the diagonal tile, in
//   the accumulator layout, and split in registers into the A operand of
//   y_q += A x_j (rt::tc_c_to_a3): A never goes through shared memory.
//   Each phase multiplies one x_j tile while the next is split into the
//   other buffer and the one after loads into registers (the next head's
//   first during the current one's last), so a j tile needs one barrier;
//   on the diagonal tile each warp stops at its own last row.
// - ssd_state_kernel: S_h = (w x_h)^T B with K = Q, one CTA per (b·chunk,
//   64-column N tile, group of 8 heads).  B's N tile is split once and
//   serves the group's heads, two at a time (warp tiles of 32 x 32, so
//   one B fragment serves two m-tiles); w_j is formed once per row (by a
//   lane of the warp that stages the row, handed on by shuffle) and folded
//   into x as x is split; phases as above.
// The passes of a k-step run pass by pass over its n-tiles, so that
// consecutive mma's are independent.  rt_ssd_intra launches both kernels,
// one after the other, on the caller's stream; the Python wrapper counts
// that as one launch.
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
// and L are recomputed from the inputs.  Its elementwise work: L masked
// before the exponential, G, A, E, the dCB sum in head order, the column
// sums.
//
// What bounds it: at the main shape (8, 8, 256, 32, 64, N 128) the
// products are ~36 GFLOP (~108 at 3 passes, 0.109 ms at 989 TFLOP/s), the
// elementwise work ~0.74 GFLOP, and the call moves ~0.51 GB (0.153 ms),
// so bytes bound it on paper.  In practice neither does: cutting parts
// of ssd_bwd_dx_kernel on the H100 (scripts/torch_ssd_probe.py,
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
// No atomics in either direction: every sum runs in a fixed order and
// mma.sync is deterministic, so two calls give bit-identical outputs and
// gradients.
#include <cstdint>

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

using rt::kThreads;
using bf16 = __nv_bfloat16;

constexpr int kMaxQ = 256, kMaxN = 128, kMaxP = 64;
constexpr int kT = 64;             // q, j, p and N tile
constexpr int kHG = 8;             // heads per CTA sharing C.B^T (and dCB)
constexpr int kLH = kT + 8;        // bf16 row stride of a split tile: 144 B
constexpr int kTileH = kT * kLH;   // elements of one plane (hi, mid or lo)
constexpr int kFrag = 16;          // fp32 per thread of a 64 x 64 tile
constexpr int kHalf = kThreads / 2;  // the forward's y part: threads a head
constexpr float kLog2e = 1.4426950408889634f;
// The forward splits each fp32 operand into three bf16 planes (six
// passes), the backward into two (three passes): the forward is held to
// 1e-5 of scale, which two planes miss on its two-product chain
// (split_bf16x3), the backward to 1e-4.
constexpr int kFwd = 3, kBwd = 2;
constexpr int kSplit = kBwd * kTileH;  // elements of a backward split tile

__device__ __forceinline__ int ksteps(int k) { return (min(k, kT) + 15) / 16; }

__device__ __forceinline__ void zero_frag(float (&a)[4][4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[n][e] = 0.f;
}

// this thread's index among the NT threads that share a tile
template <int NT>
__device__ __forceinline__ int tile_tid() {
  return NT == kThreads ? (int)threadIdx.x : (int)threadIdx.x % NT;
}

// This thread's share of a 64 x 64 fp32 tile, which NT threads load
// together: pair i is row (tid + NT i) / 32, columns 2 ((tid + NT i) % 32)
// + (0, 1) with tid = threadIdx.x % NT, so each warp reads one 256-B row.
// at(r, c) gives the element, or 0 outside the data (the zero padding of
// ragged Q, P and N).
template <int NT = kThreads, class F>
__device__ __forceinline__ void tile_load(float (&v)[kT * kT / NT], F at) {
#pragma unroll
  for (int i = 0; i < kT * kT / NT / 2; ++i) {
    const int e = tile_tid<NT>() + NT * i, r = e / 32, c = e % 32 * 2;
    v[2 * i] = at(r, c);
    v[2 * i + 1] = at(r, c + 1);
  }
}

// rows [r0, r0 + 64) x columns [c0, c0 + 64) of a row-major fp32 matrix
// (row stride ld) of nrows x ncols
template <int NT = kThreads>
__device__ __forceinline__ void tile_load_rm(float (&v)[kT * kT / NT],
                                             const float* m, size_t ld,
                                             int r0, int c0, int nrows,
                                             int ncols) {
  tile_load<NT>(v, [&](int r, int c) {
    return r0 + r < nrows && c0 + c < ncols
               ? m[(size_t)(r0 + r) * ld + c0 + c]
               : 0.f;
  });
}

// The loaded share split into NP bf16 planes (plane i at t + i kTileH),
// rows of kLH elements: conflict-free stores and ldmatrix reads.
template <int NT = kThreads, int NP = kBwd>
__device__ __forceinline__ void tile_store(bf16* t,
                                           const float (&v)[kT * kT / NT]) {
#pragma unroll
  for (int i = 0; i < kT * kT / NT / 2; ++i) {
    const int e = tile_tid<NT>() + NT * i, r = e / 32, c = e % 32 * 2;
    uint32_t w[NP];
    if constexpr (NP == 2)
      rt::split_bf16x2(v[2 * i], v[2 * i + 1], w[0], w[1]);
    else
      rt::split_bf16x3(v[2 * i], v[2 * i + 1], w[0], w[1], w[2]);
#pragma unroll
    for (int k = 0; k < NP; ++k)
      *reinterpret_cast<uint32_t*>(t + k * kTileH + r * kLH + c) = w[k];
  }
}

// f[n] = A B_n for the 2 NB n-tiles of 16 x 8 of one k-step, from
// NP-plane fragments (B_n: registers 2 (n % 2), 2 (n % 2) + 1 of
// b[n / 2][plane], one ldmatrix.x4 per plane): the passes (i, j) with
// i + j < NP, largest first, each over all n-tiles before the next, so
// that consecutive mma's are independent.  Each f is a fresh fragment
// that the caller adds in fp32: the tensor cores round their sums toward
// zero, the fp32 add to nearest, so the long chain of dB's state part
// (K = H P) does not drift.  Two planes: hi.hi, hi.lo, lo.hi (lo.lo,
// ~2^-16 relative, is dropped); three: the six passes of split_bf16x3.
template <int NP, int NB>
__device__ __forceinline__ void mma_passes(float (&f)[2 * NB][4],
                                           const uint32_t (&a)[NP][4],
                                           const uint32_t (&b)[NB][NP][4]) {
#pragma unroll
  for (int n = 0; n < 2 * NB; ++n)
    rt::mma_bf16_zc(f[n], a[0], b[n / 2][0][2 * (n % 2)],
                    b[n / 2][0][2 * (n % 2) + 1]);
#pragma unroll
  for (int s = 1; s < NP; ++s)
#pragma unroll
    for (int i = 0; i <= s; ++i)
#pragma unroll
      for (int n = 0; n < 2 * NB; ++n)
        rt::mma_bf16(f[n], a[i], b[n / 2][s - i][2 * (n % 2)],
                     b[n / 2][s - i][2 * (n % 2) + 1]);
}

// acc += A B on this warp's 16 x 32 block at (m0, n0) of a 64 x 64
// output, for k-step kk of NP-plane split tiles A (stored [m][k], or
// [k][m] with kAT) and B (stored [n][k], or [k][n] with kBT).
template <bool kAT, bool kBT, int NP>
__device__ __forceinline__ void mma_kstep(float (&acc)[4][4], const bf16* A,
                                          const bf16* B, int m0, int n0,
                                          int kk) {
  const int ao = kAT ? rt::tc_akm_off(16 * kk, m0, kLH)
                     : rt::tc_a_off(m0, 16 * kk, kLH);
  uint32_t a[NP][4], b[2][NP][4];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    if (kAT) rt::ldmatrix_x4_trans(a[k], A + k * kTileH + ao);
    else rt::ldmatrix_x4(a[k], A + k * kTileH + ao);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int bo = kBT ? rt::tc_bkn_off(16 * kk, n0 + 16 * j, kLH)
                       : rt::tc_bnk_off(n0 + 16 * j, 16 * kk, kLH);
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      if (kBT) rt::ldmatrix_x4_trans(b[j][k], B + k * kTileH + bo);
      else rt::ldmatrix_x4(b[j][k], B + k * kTileH + bo);
    }
  }
  float f[4][4];
  mma_passes<NP, 2>(f, a, b);
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += f[n][e];
}

// k-steps [0, ks) of mma_kstep: unrolled (ks <= 4) where the independent
// k-steps overlap; a plain loop for the backward's dbc kernel, whose 128
// registers (2 CTAs per SM) leave no room for that.
template <bool kAT, bool kBT, int NP = kBwd, bool kUnrolled = true>
__device__ __forceinline__ void warp_mma(float (&acc)[4][4], const bf16* A,
                                         const bf16* B, int m0, int n0,
                                         int ks) {
  if (kUnrolled) {
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk)
      if (kk < ks) mma_kstep<kAT, kBT, NP>(acc, A, B, m0, n0, kk);
  } else {
    for (int kk = 0; kk < ks; ++kk)
      mma_kstep<kAT, kBT, NP>(acc, A, B, m0, n0, kk);
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

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// y part: grid (njt * nhg, BC), the q tile fastest and heaviest first.
// Part 1, warp w a 16 x 32 block (m0, n0) of each C_q B_j^T tile, stored
// as part 2 reads it: [jt][n8][tq][e], part 2's n-tile n8 of 8 columns,
// thread tq of a half and fragment element e (a float4 a thread).
// Part 2: half hf = warp / 4 takes heads h0 + 2 i + hf, its warp 16 q
// rows (r0) and all P columns.
__global__ void __launch_bounds__(kThreads, 1)
ssd_y_kernel(const float* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ acum, const float* __restrict__ Bm,
             const float* __restrict__ Cm, float* __restrict__ y, int Q,
             int H, int P, int N) {
  constexpr int kTile = kFwd * kTileH;  // a split tile
  extern __shared__ __align__(16) float smem[];
  const int njt = (Q + kT - 1) / kT;
  float* sCB = smem;  // njt * kFrag * kThreads floats
  // four split tiles: part 1's C_q and B_j N chunks, part 2's x_j tiles
  // [half][buffer]
  bf16* sOp = reinterpret_cast<bf16*>(sCB + njt * kFrag * kThreads);
  // a_cum_j, dt_j, a_cum_q of the step: [half][buffer][3][kT]
  float* sVec = reinterpret_cast<float*>(sOp + 4 * kTile);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int qt = njt - 1 - (int)(blockIdx.x % njt);
  const int h0 = (int)(blockIdx.x / njt) * kHG, h1 = min(h0 + kHG, H);
  const size_t bc = blockIdx.y;
  const int q0 = qt * kT, nch = (N + kT - 1) / kT;
  const size_t HP = (size_t)H * P;

  // part 1: C_q B_j^T for the j tiles 0..qt, both N chunks at once
  {
    const float* Cg = Cm + bc * Q * N;
    const float* Bg = Bm + bc * Q * N;
    const int m0 = warp % 4 * 16, n0 = warp / 4 * 32;
    float v[kMaxN / kT][kFrag];
#pragma unroll
    for (int c = 0; c < kMaxN / kT; ++c)
      if (c < nch) {
        tile_load_rm(v[c], Cg, N, q0, c * kT, Q, N);
        tile_store<kThreads, kFwd>(sOp + c * kTile, v[c]);
        tile_load_rm(v[c], Bg, N, 0, c * kT, Q, N);
      }
    for (int jt = 0; jt <= qt; ++jt) {
      if (jt > 0) __syncthreads();  // previous tile's reads done
#pragma unroll
      for (int c = 0; c < kMaxN / kT; ++c)
        if (c < nch) tile_store<kThreads, kFwd>(sOp + (2 + c) * kTile, v[c]);
      __syncthreads();
      if (jt < qt)
#pragma unroll
        for (int c = 0; c < kMaxN / kT; ++c)
          if (c < nch) tile_load_rm(v[c], Bg, N, (jt + 1) * kT, c * kT, Q, N);
      float acc[4][4];
      zero_frag(acc);
#pragma unroll
      for (int c = 0; c < kMaxN / kT; ++c)
        if (c < nch)
          warp_mma<false, false, kFwd>(acc, sOp + c * kTile,
                                       sOp + (2 + c) * kTile, m0, n0,
                                       ksteps(N - c * kT));
      float4* cb = reinterpret_cast<float4*>(sCB + jt * kFrag * kThreads) +
                   (n0 / 8) * kHalf + (warp % 4) * 32 + lane;
#pragma unroll
      for (int n = 0; n < 4; ++n)
        cb[n * kHalf] = make_float4(acc[n][0], acc[n][1], acc[n][2],
                                    acc[n][3]);
    }
  }

  // part 2: steps s = (head pair i, j tile jt).  Phase s multiplies step
  // s (buffer s & 1), stages step s + 1 into the other buffer (its last
  // readers, step s - 1's products, are past the barrier of the phase
  // between) and loads step s + 2 into registers, so the split stores
  // overlap the products; one barrier a phase.
  const int hf = warp / 4, tq = tid % kHalf, r0 = warp % 4 * 16;
  const int nst = (qt + 1) * ((h1 - h0 + 1) / 2);
  // a half with no head left (an odd group's last pair) runs on its
  // group's last head and stores nothing
  auto head = [&](int s) {
    return min(h0 + 2 * (s / (qt + 1)) + hf, h1 - 1);
  };
  // x_j, and (tq < kT) a_cum_j, dt_j and a_cum_q of row tq
  float v[2 * kFrag], acj = 0.f, dtj = 0.f, acq = 0.f;
  auto load_step = [&](int s) {
    const int h = head(s), j0 = s % (qt + 1) * kT;
    tile_load_rm<kHalf>(v, x + bc * Q * HP + (size_t)h * P, HP, j0, 0, Q, P);
    if (tq < kT) {
      const size_t i = (bc * Q + j0 + tq) * H + h;
      const bool in = j0 + tq < Q;
      acj = in ? acum[i] : 0.f;
      dtj = in ? dt[i] : 0.f;
      acq = q0 + tq < Q ? acum[(bc * Q + q0 + tq) * H + h] : 0.f;
    }
  };
  auto store_step = [&](int s) {
    const int b = s & 1;
    tile_store<kHalf, kFwd>(sOp + (2 * hf + b) * kTile, v);
    if (tq < kT) {
      float* vec = sVec + (2 * hf + b) * 3 * kT;
      vec[tq] = acj;
      vec[kT + tq] = dtj;
      vec[2 * kT + tq] = acq;
    }
  };
  load_step(0);
  __syncthreads();  // part 1's reads of the staging tiles done
  store_step(0);
  if (nst > 1) load_step(1);
  __syncthreads();
  float acc[8][4];
  for (int s = 0; s < nst; ++s) {
    const int jt = s % (qt + 1), b = s & 1, h = head(s);
    const bf16* sX = sOp + (2 * hf + b) * kTile;
    const float* aj = sVec + (2 * hf + b) * 3 * kT;  // then dt_j, a_cum_q
    const float* dj = aj + kT;
    const float acq2[2] = {aj[2 * kT + r0 + g], aj[2 * kT + r0 + g + 8]};
    if (jt == 0)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    const int j0 = jt * kT;
    const bool full = jt < qt && q0 + kT <= Q;  // no pair masked
    // k-steps within Q and, on the diagonal tile, up to this warp's rows
    const int ks = jt < qt ? ksteps(Q - j0) : min(ksteps(Q - j0), r0 / 16 + 1);
    const float4* cb =
        reinterpret_cast<const float4*>(sCB + jt * kFrag * kThreads) + tq;
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      if (kk >= ks) break;
      // A = CB L dt_j on columns [16 kk, 16 kk + 16): n-tiles 2 kk + u
      float a[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int n8 = 2 * kk + u, jj = 8 * n8 + 2 * t;
        const float2 ac = *reinterpret_cast<const float2*>(aj + jj);
        const float2 dv = *reinterpret_cast<const float2*>(dj + jj);
        const float4 c4 = cb[n8 * kHalf];
        const float cbv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qq = r0 + g + 8 * (e / 2);
          float av = 0.f;
          // masked before the exponential: exp(-inf) = 0 above the diagonal
          if (full || (j0 + jj + e % 2 <= q0 + qq && q0 + qq < Q))
            av = cbv[e] *
                 exp2f((acq2[e / 2] - (e % 2 ? ac.y : ac.x)) * kLog2e) *
                 (e % 2 ? dv.y : dv.x);
          a[u][e] = av;
        }
      }
      uint32_t af[kFwd][4];
      rt::tc_c_to_a3(a, 0, af);
      // y += A x_j over the P columns, 32 at a time
#pragma unroll
      for (int c = 0; c < kMaxP / 32; ++c) {
        if (32 * c >= P) break;
        uint32_t bf[2][kFwd][4];
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int k = 0; k < kFwd; ++k)
            rt::ldmatrix_x4_trans(
                bf[nb][k],
                sX + k * kTileH + rt::tc_bkn_off(16 * kk, 32 * c + 16 * nb,
                                                 kLH));
        float f[4][4];
        mma_passes<kFwd, 2>(f, af, bf);
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[4 * c + n][e] += f[n][e];
      }
    }
    if (jt == qt && h0 + 2 * (s / (qt + 1)) + hf < h1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = q0 + r0 + g + 8 * r;
        if (q >= Q) continue;
        float* yr = y + (bc * Q + q) * HP + (size_t)h * P;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int p = 8 * n + 2 * t;
          if (p < P) yr[p] = acc[n][2 * r];
          if (p + 1 < P) yr[p + 1] = acc[n][2 * r + 1];
        }
      }
    }
    if (s + 1 < nst) {
      store_step(s + 1);
      if (s + 2 < nst) load_step(s + 2);
    }
    __syncthreads();
  }
}

// acc[mt] += A B on this warp's block of m-tiles m0 + 16 mt (mt < mts, at
// most 2) x 32 columns at n0, k-steps [0, ks) of three-plane split tiles
// A [k][m] and B [k][n]: B's fragments serve both m-tiles.
__device__ __forceinline__ void warp_mma_2x(float (&acc)[2][4][4],
                                            const bf16* A, const bf16* B,
                                            int m0, int n0, int ks,
                                            int mts) {
  for (int kk = 0; kk < ks; ++kk) {
    uint32_t b[2][kFwd][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < kFwd; ++k)
        rt::ldmatrix_x4_trans(
            b[j][k], B + k * kTileH + rt::tc_bkn_off(16 * kk, n0 + 16 * j,
                                                     kLH));
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (mt >= mts) break;
      uint32_t a[kFwd][4];
#pragma unroll
      for (int k = 0; k < kFwd; ++k)
        rt::ldmatrix_x4_trans(
            a[k], A + k * kTileH + rt::tc_akm_off(16 * kk, m0 + 16 * mt,
                                                  kLH));
      float f[4][4];
      mma_passes<kFwd, 2>(f, a, b);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][n][e] += f[n][e];
    }
  }
}

// state part: grid (nnt * nhg, BC), the N tile fastest.  Steps s = (head
// pair i, j tile) in phases as in the y part; a step's output is S of
// heads h0 + 2 i + k (k < 2) at N column c0 as one 128 x 64 tile, 8 warps
// of 32 x 32: warp w takes head k = w / 4, p rows p0 = 32 ((w / 2) % 2),
// columns n0 = 32 (w % 2).
__global__ void __launch_bounds__(kThreads, 1)
ssd_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ acum, const float* __restrict__ Bm,
                 float* __restrict__ S, int Q, int H, int P, int N) {
  constexpr int kTile = kFwd * kTileH;
  extern __shared__ __align__(16) float smem[];
  const int njt = (Q + kT - 1) / kT, nnt = (N + kT - 1) / kT;
  bf16* sB = reinterpret_cast<bf16*>(smem);  // njt split tiles: B [j][n]
  bf16* sX = sB + njt * kTile;  // [buffer][k] split tiles: w x [j][p]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hk = warp / 4, p0 = warp / 2 % 2 * 32, n0 = warp % 2 * 32;
  const int c0 = (int)(blockIdx.x % nnt) * kT;
  const int h0 = (int)(blockIdx.x / nnt) * kHG, h1 = min(h0 + kHG, H);
  const size_t bc = blockIdx.y;
  const size_t HP = (size_t)H * P;
  const int nst = (h1 - h0 + 1) / 2 * njt;
  // this warp's m-tiles inside P (warp-uniform)
  const int mts = c0 + n0 < N ? max(0, min(2, (P - p0 + 15) / 16)) : 0;
  // head k of step s's pair (an odd group's last pair has one: its second
  // half runs on the group's last head and stores nothing)
  auto head = [&](int s, int k) {
    return min(h0 + 2 * (s / njt) + k, h1 - 1);
  };

  // step s's two x tiles and, for w_j of this thread's rows j0 + warp +
  // 8 i (i < 8), lane l's row j0 + warp + 8 (l % 8): a_cum_last, a_cum_j
  // and dt_j of each head
  float v[2][kFrag], al[2], ajl[2], dtl[2];
  auto load_step = [&](int s) {
    const int j0 = s % njt * kT, j = j0 + warp + 8 * (lane % 8);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int h = head(s, k);
      tile_load_rm(v[k], x + bc * Q * HP + (size_t)h * P, HP, j0, 0, Q, P);
      al[k] = acum[(bc * Q + Q - 1) * H + h];
      ajl[k] = j < Q ? acum[(bc * Q + j) * H + h] : al[k];
      dtl[k] = j < Q ? dt[(bc * Q + j) * H + h] : 0.f;
    }
  };
  // w x into buffer s & 1, split: w_j formed once per row (four lanes
  // each), handed on by lane i
  auto store_step = [&](int s) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float w = exp2f((al[k] - ajl[k]) * kLog2e) * dtl[k];
#pragma unroll
      for (int i = 0; i < kFrag / 2; ++i) {
        const float wi = __shfl_sync(0xffffffffu, w, i);
        v[k][2 * i] *= wi;
        v[k][2 * i + 1] *= wi;
      }
      tile_store<kThreads, kFwd>(sX + (2 * (s & 1) + k) * kTile, v[k]);
    }
  };
  for (int jt = 0; jt < njt; ++jt) {
    tile_load_rm(v[0], Bm + bc * Q * N, N, jt * kT, c0, Q, N);
    tile_store<kThreads, kFwd>(sB + jt * kTile, v[0]);
  }
  load_step(0);
  store_step(0);
  if (nst > 1) load_step(1);
  __syncthreads();
  float acc[2][4][4];
  for (int s = 0; s < nst; ++s) {
    const int jt = s % njt;
    if (jt == 0)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) zero_frag(acc[mt]);
    warp_mma_2x(acc, sX + (2 * (s & 1) + hk) * kTile, sB + jt * kTile, p0,
                n0, ksteps(Q - jt * kT), mts);
    const int h = h0 + 2 * (s / njt) + hk;
    if (jt == njt - 1 && h < h1)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        if (mt < mts)
          frag_store(S + (bc * H + h) * (size_t)P * N, N, 0, c0, P, N,
                     p0 + 16 * mt, n0, acc[mt]);
    if (s + 1 < nst) {
      store_step(s + 1);
      if (s + 2 < nst) load_step(s + 2);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

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
  const int njt = (Q + kT - 1) / kT, nhg = (H + kHG - 1) / kHG;
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
  const int h0 = hg * kHG, h1 = min(h0 + kHG, H);
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
        warp_mma<false, false>(acc, sBj + c * kSplit, sOp + c * kSplit, m0,
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
        warp_mma<false, false>(u, sBj + c * kSplit, sOp + c * kSplit, m0,
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
      warp_mma<false, false>(da, sX, sDY, m0, qh, ksteps(P));
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
          uint32_t a[kBwd][4];
          rt::tc_c_to_a(da, kk, a[0], a[1]);
#pragma unroll
          for (int jb = 0; jb < 4; ++jb) {
            const int bo = rt::tc_bkn_off(qh + 16 * kk, 16 * jb, kLH);
            uint32_t b[1][kBwd][4];
            rt::ldmatrix_x4_trans(b[0][0], sDY + bo);
            rt::ldmatrix_x4_trans(b[0][1], sDY + kTileH + bo);
            float f[2][4];
            mma_passes<kBwd, 1>(f, a, b);
#pragma unroll
            for (int s = 0; s < 2; ++s)
#pragma unroll
              for (int e = 0; e < 4; ++e) dxa[2 * jb + s][e] += f[s][e];
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
  const int nnt = (N + kT - 1) / kT, nhg = (H + kHG - 1) / kHG;
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
    warp_mma<false, true, kBwd, false>(acc, sP, sQ, m0, n0, ksteps(Q - jc));
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
    warp_mma<true, true, kBwd, false>(acc, sP, sQ, m0, n0, ksteps(Q - qc));
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
    warp_mma<false, true, kBwd, false>(acc, sP, sQ, m0, n0, ksteps(P));
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

const rt::KernelEntry kKernels[] = {
    {"ssd_y_kernel", (const void*)ssd_y_kernel},
    {"ssd_state_kernel", (const void*)ssd_state_kernel},
    {"ssd_bwd_dx_kernel", (const void*)ssd_bwd_dx_kernel},
    {"ssd_bwd_dcb_sum_kernel", (const void*)ssd_bwd_dcb_sum_kernel},
    {"ssd_bwd_dbc_kernel", (const void*)ssd_bwd_dbc_kernel}};

}  // namespace

RT_KERNEL_TABLE(ssd, kKernels)

extern "C" int rt_ssd_intra(const void* x, const void* dt, const void* acum,
                            const void* Bm, const void* Cm, void* y, void* S,
                            int BC, int Q, int H, int P, int N,
                            void* stream) {
  if (Q < 1 || Q > kMaxQ || N < 1 || N > kMaxN || P < 1 || P > kMaxP ||
      H < 1 || BC < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int njt = (Q + kT - 1) / kT, nnt = (N + kT - 1) / kT;
  const int nhg = (H + kHG - 1) / kHG;
  // the C.B^T strip's fragments, four three-plane split tiles and 12
  // vectors of kT floats: 179,200 B at Q 256, one CTA per SM
  const size_t smem_y = (size_t)njt * kFrag * kThreads * sizeof(float) +
                        (size_t)4 * kFwd * kTileH * sizeof(bf16) +
                        (size_t)12 * kT * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_y_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_y);
  if (err != cudaSuccess) return (int)err;
  ssd_y_kernel<<<dim3(njt * nhg, BC), kThreads, smem_y, st>>>(
      (const float*)x, (const float*)dt, (const float*)acum,
      (const float*)Bm, (const float*)Cm, (float*)y, Q, H, P, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // B's N tile over Q and two buffers of a head pair's w x tiles, split
  // in three planes: 221,184 B at Q 256, one CTA per SM
  const size_t smem_s = (size_t)(njt + 4) * kFwd * kTileH * sizeof(bf16);
  err = cudaFuncSetAttribute(ssd_state_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_s);
  if (err != cudaSuccess) return (int)err;
  ssd_state_kernel<<<dim3(nnt * nhg, BC), kThreads, smem_s, st>>>(
      (const float*)x, (const float*)dt, (const float*)acum,
      (const float*)Bm, (float*)S, Q, H, P, N);
  return (int)cudaGetLastError();
}

// The backward's fp32 scratch: dcbp (BC, nhg, Q, Q) then rowp
// (BC, njt, Q, H).  The caller allocates this many floats.
extern "C" long long rt_ssd_intra_bwd_scratch_floats(int BC, int Q, int H) {
  const int njt = (Q + kT - 1) / kT, nhg = (H + kHG - 1) / kHG;
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
  const int njt = (Q + kT - 1) / kT, nhg = (H + kHG - 1) / kHG;
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
