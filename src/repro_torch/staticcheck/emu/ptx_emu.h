// Host versions of the PTX helpers in src/repro_torch/csrc/tensor_core.cuh
// (the emulator's: nvcc never sees this file).  A warp-level instruction
// becomes a warp-wide slot exchange: every lane posts its operands into
// this call's slot set, waits at its warp's barrier and reads its warp's
// operands back in the PTX ISA's fragment layout (two sets alternate, so
// one barrier a call suffices: cuda_runtime.h).  That is valid because
// every kernel calls these helpers with all lanes of the warp, the same
// number of times.  cp.async copies at once, so its
// commit and wait are no-ops; a turn counter is read and written plainly
// (one block runs at a time).  Each helper also records what the card
// would fault on or the analyzer checks (cuda_runtime.h): a cp.async
// address off its 16 (or 4) bytes on either side, an ldmatrix row address
// off 16 bytes, and every turn awaited or handed on.
#pragma once
#define RT_HOST_EMULATION 1

namespace rt {

inline float emu_bf16(uint32_t w, int half) {
  const uint32_t u = half ? (w & 0xffff0000u) : (w << 16);
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

inline unsigned emu_warp0() { return threadIdx.x & ~31u; }

// x rounded to fp32 toward zero (the card's tensor cores truncate)
inline float emu_f32_rz(double x) {
  const float f = static_cast<float>(x);  // to nearest
  return std::fabs(static_cast<double>(f)) > std::fabs(x)
             ? std::nextafter(f, 0.f)
             : f;
}

// d += A B: this lane's four D elements from the warp's A and B fragments.
// The bf16 products are exact; their sum with d is formed in double and
// rounded to fp32 toward zero once an instruction, as the card's tensor
// cores truncate each accumulation.
inline void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                     uint32_t b1) {
  uint32_t* set = emu_uslots + 6 * emu_set();
  uint32_t* mine = set + 6 * threadIdx.x;
  for (int i = 0; i < 4; ++i) mine[i] = a[i];
  mine[4] = b0;
  mine[5] = b1;
  emu_syncwarp();
  const unsigned lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t* w = set + 6 * emu_warp0();
  float arow[2][16], bcol[2][16];  // A rows g, g+8; B columns 2t, 2t+1
  for (unsigned tt = 0; tt < 4; ++tt) {
    const uint32_t* f = w + 6 * (4 * g + tt);  // lane (g, tt) holds row g
    for (int h = 0; h < 2; ++h) {
      arow[0][2 * tt + h] = emu_bf16(f[0], h);
      arow[1][2 * tt + h] = emu_bf16(f[1], h);
      arow[0][2 * tt + 8 + h] = emu_bf16(f[2], h);
      arow[1][2 * tt + 8 + h] = emu_bf16(f[3], h);
    }
  }
  for (int c = 0; c < 2; ++c) {
    const uint32_t* f = w + 6 * (4 * (2 * t + c));  // lanes of column n
    for (unsigned tt = 0; tt < 4; ++tt, f += 6)
      for (int h = 0; h < 2; ++h) {
        bcol[c][2 * tt + h] = emu_bf16(f[4], h);
        bcol[c][2 * tt + 8 + h] = emu_bf16(f[5], h);
      }
  }
  for (int i = 0; i < 4; ++i) {
    double s = d[i];
    for (int k = 0; k < 16; ++k)
      s += static_cast<double>(arow[i >> 1][k]) * bcol[i & 1][k];
    d[i] = emu_f32_rz(s);
  }
}

inline void mma_bf16_zc(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                        uint32_t b1) {
  for (int i = 0; i < 4; ++i) d[i] = 0.f;
  mma_bf16(d, a, b0, b1);
}

inline void emu_ldmatrix(uint32_t (&r)[4], const void* p, bool trans) {
  emu_check_align(kLdmatrixRow, p, 16);
  const void** set = emu_pslots + emu_set();
  set[threadIdx.x] = p;
  emu_syncwarp();
  const unsigned lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const void* const* w = set + emu_warp0();
  for (int i = 0; i < 4; ++i) {
    uint16_t e[2];
    for (int h = 0; h < 2; ++h) {
      const unsigned row = trans ? 2 * t + h : g, col = trans ? g : 2 * t + h;
      e[h] = static_cast<const uint16_t*>(w[8 * i + row])[col];
    }
    r[i] = uint32_t(e[0]) | (uint32_t(e[1]) << 16);
  }
}

inline void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  emu_ldmatrix(r, p, false);
}

inline void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  emu_ldmatrix(r, p, true);
}

inline void emu_cp(void* dst, const void* src, int n, int src_bytes) {
  std::memcpy(dst, src, src_bytes);
  std::memset(static_cast<char*>(dst) + src_bytes, 0, n - src_bytes);
}

inline void cp_async16(void* dst, const void* src, int src_bytes) {
  emu_check_align(kCpAsync16Dst, dst, 16);
  emu_check_align(kCpAsync16Src, src, 16);
  emu_cp(dst, src, 16, src_bytes);
}

inline void cp_async4(void* dst, const void* src, int src_bytes) {
  emu_check_align(kCpAsync4Dst, dst, 4);
  emu_check_align(kCpAsync4Src, src, 4);
  emu_cp(dst, src, 4, src_bytes);
}

inline void cp_async_commit() {}

template <int N>
inline void cp_async_wait() {}

// Blocks run one after another in linear order (cuda_runtime.h), so a
// turn that has not come when its CTA asks for it never will: that is a
// wrong turn, and it aborts at once rather than hanging (or, for the
// analyzer, is logged and passed over).
inline void wait_turn(const int* ctr, int turn) {
  emu_turn(0, ctr, turn, *ctr == turn);
  if (*ctr != turn && emu_turn_abort) {
    std::fprintf(stderr, "wait_turn: counter %d, turn %d (block %u, %u)\n",
                 *ctr, turn, blockIdx.x, blockIdx.y);
    std::abort();
  }
}

inline void pass_turn(int* ctr, int next) {
  emu_turn(1, ctr, next, true);
  *ctr = next;
}

}  // namespace rt
