// Warp-level tensor-core and copy helpers for the bf16 kernels (sm_80+ PTX,
// run here on sm_90a): mma.sync m16n8k16 bf16 -> fp32, ldmatrix (plain and
// transposed), cp.async with commit/wait, the hi/lo bf16 split of fp32
// operands, and the turn counters that order a sum across CTAs.  Each PTX instruction sits in one small helper so that the
// CPU emulator (repro_torch/staticcheck/emu) can stand in for it: it
// defines RT_HOST_EMULATION and its own host versions of the helpers
// below.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16"), with
// g = lane / 4 and t = lane % 4:
//   A (16 x 16, row): a[0] = A[g][2t..2t+1], a[1] = A[g+8][2t..],
//                     a[2] = A[g][2t+8..],   a[3] = A[g+8][2t+8..]
//   B (16 x 8, col):  b0 = B[2t..2t+1][g],   b1 = B[2t+8..2t+9][g]
//   C, D (16 x 8):    d[0..1] = D[g][2t..2t+1], d[2..3] = D[g+8][2t..]
// (the lower 16 bits of a register hold the first of its two elements).
// ldmatrix.x4: lanes 8i..8i+7 give the row addresses of matrix i; register
// i of every lane receives row g, columns 2t, 2t+1 of matrix i (with
// .trans: rows 2t, 2t+1 of column g).
#pragma once

#include <cstdint>
#include <cstring>

#include "common.cuh"

namespace rt {

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}

// (a, b) ~ hi + lo with hi = bf16(x) and lo = bf16(x - hi): the pair keeps
// about 16 significant bits, so two mma passes (hi, lo) against an exact
// bf16 operand carry an fp32 operand to ~2^-17 relative error.
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

__device__ __forceinline__ uint32_t f32_bits(float x) {
  uint32_t u;
  memcpy(&u, &x, 4);
  return u;
}

__device__ __forceinline__ float bits_f32(uint32_t u) {
  float x;
  memcpy(&x, &u, 4);
  return x;
}

// (a, b) = hi + mid + lo exactly, each term bf16: hi keeps the top 8
// significant bits (the upper half of the fp32 pattern), mid the top 8 of
// what is left, lo the rest (at most 8 bits); each difference is exact in
// fp32.  Bit masks and fp32 adds only, no conversions (2-3% faster in
// the SSD forward than rounding to nearest: scripts/torch_ssd_probe.py's
// split_rn).  The six mma passes with i + j <= 2 of (hi, mid, lo) x
// (hi, mid, lo) then carry an fp32 product to ~2^-21 relative (the
// dropped mid.lo, lo.mid, lo.lo), where hi + lo leaves ~2^-17 (~1e-5 of
// scale on a two-product chain).
__device__ __forceinline__ void split_bf16x3(float a, float b, uint32_t& hi,
                                             uint32_t& mid, uint32_t& lo) {
  constexpr uint32_t kTop = 0xffff0000u;
  const uint32_t ua = f32_bits(a), ub = f32_bits(b);
  hi = (ua >> 16) | (ub & kTop);
  const float ra = a - bits_f32(ua & kTop), rb = b - bits_f32(ub & kTop);
  const uint32_t va = f32_bits(ra), vb = f32_bits(rb);
  mid = (va >> 16) | (vb & kTop);
  const float sa = ra - bits_f32(va & kTop), sb = rb - bits_f32(vb & kTop);
  lo = (f32_bits(sa) >> 16) | (f32_bits(sb) & kTop);
}

// The A fragments (hi, lo) of k-step kk of a 16-row C tile held as n-tiles
// of 8 columns: columns [16 kk, 16 kk + 16) are n-tiles 2 kk and 2 kk + 1.
// An accumulator becomes the A operand of the next product in registers.
template <int N>
__device__ __forceinline__ void tc_c_to_a(const float (&c)[N][4], int kk,
                                          uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  split_bf16x2(c[2 * kk][0], c[2 * kk][1], hi[0], lo[0]);
  split_bf16x2(c[2 * kk][2], c[2 * kk][3], hi[1], lo[1]);
  split_bf16x2(c[2 * kk + 1][0], c[2 * kk + 1][1], hi[2], lo[2]);
  split_bf16x2(c[2 * kk + 1][2], c[2 * kk + 1][3], hi[3], lo[3]);
}

// The same split into three planes (split_bf16x3): a[plane][register].
template <int N>
__device__ __forceinline__ void tc_c_to_a3(const float (&c)[N][4], int kk,
                                           uint32_t (&a)[3][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float* v = c[2 * kk + r / 2] + 2 * (r % 2);
    split_bf16x3(v[0], v[1], a[0][r], a[1][r], a[2][r]);
  }
}

// reductions over the 4 lanes of a quad (the lanes that share a C row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Lane addresses of ldmatrix.x4 over a 16 x 16 block at (r0, c0) of a
// shared tile with row stride ld, for each fragment role: A row-major, B
// stored [n][k] (both plain), B stored [k][n] and A stored [k][m] (both
// .trans).
__device__ __forceinline__ int tc_a_off(int r0, int c0, int ld) {
  const int l = threadIdx.x % 32;
  return (r0 + (l & 7) + ((l >> 3) & 1) * 8) * ld + c0 + (l >> 4) * 8;
}
__device__ __forceinline__ int tc_bnk_off(int n0, int k0, int ld) {
  const int l = threadIdx.x % 32;
  return (n0 + (l & 7) + (l >> 4) * 8) * ld + k0 + ((l >> 3) & 1) * 8;
}
__device__ __forceinline__ int tc_bkn_off(int k0, int n0, int ld) {
  const int l = threadIdx.x % 32;
  return (k0 + (l & 7) + ((l >> 3) & 1) * 8) * ld + n0 + (l >> 4) * 8;
}
__device__ __forceinline__ int tc_akm_off(int k0, int m0, int ld) {
  const int l = threadIdx.x % 32;
  return (k0 + (l & 7) + (l >> 4) * 8) * ld + m0 + ((l >> 3) & 1) * 8;
}

#ifndef RT_HOST_EMULATION

// d += A B on the warp's fragments
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = A B (a zero accumulator).  The tensor cores round each sum toward
// zero, so a product chained over thousands of k-steps drifts (~1e-4
// relative at K = 1.5e5); a caller that sums d into its own fp32
// registers per k-step keeps the fp32 adder's round-to-nearest instead.
__device__ __forceinline__ void mma_bf16_zc(float (&d)[4],
                                            const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 bf16 matrices from shared memory; p is this lane's row address
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// asynchronous global -> shared copies of 16 (or 4) bytes; the source's
// first src_bytes are read and the rest of the destination is zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Turn counters (gpu-scope acquire / release): one thread of a CTA waits
// until *ctr reads `turn`, and hands the turn on once the CTA's stores are
// done (after a block barrier).  The turns must follow the grid's linear
// block order, which the hardware dispatches in, so a waiting CTA only
// ever waits for CTAs that were dispatched before it (the CUTLASS serial
// split-K semaphore's rule).  A turn that never comes traps (after at
// least ~8 s) instead of hanging the card.
__device__ __forceinline__ void wait_turn(const int* ctr, int turn) {
  for (unsigned n = 0;; ++n) {
    int v;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
                 : "=r"(v) : "l"(ctr) : "memory");
    if (v == turn) return;
    if (n == (1u << 26)) __trap();
    __nanosleep(128);
  }
}

__device__ __forceinline__ void pass_turn(int* ctr, int next) {
  __threadfence();
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n"
               :: "l"(ctr), "r"(next) : "memory");
}

#endif  // RT_HOST_EMULATION

}  // namespace rt
