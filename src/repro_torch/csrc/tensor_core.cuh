// Warp-level tensor-core and copy helpers for the bf16 kernels (sm_80+ PTX,
// run here on sm_90a): mma.sync m16n8k16 bf16 -> fp32, ldmatrix (plain and
// transposed), cp.async with commit/wait, and the hi/lo bf16 split of fp32
// operands.  Each PTX instruction sits in one small helper so that the
// CPU harness (tests/cuda_emu) can stand in for it: it defines
// RT_HOST_EMULATION and its own host versions of the helpers below.
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

#endif  // RT_HOST_EMULATION

}  // namespace rt
