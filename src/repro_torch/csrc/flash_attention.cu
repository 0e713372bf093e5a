// Flash attention for Hopper: forward, fused single-sweep backward, and the
// two-sweep backward (dQ sweep, dK/dV sweep).
//
// Replaces the TPU Pallas kernels
//   repro/kernels/flash_attention/kernel.py::flash_fwd        (pallas_call :119)
//   repro/kernels/flash_attention/kernel.py::flash_bwd_fused  (:464 partials,
//                                                               :481 alias)
//   repro/kernels/flash_attention/kernel.py::flash_bwd_dq     (:212)
//   repro/kernels/flash_attention/kernel.py::flash_bwd_dkv    (:269)
// with the same math: FA-2 online softmax over kv tiles, mask = causal AND
// window AND k_pos < kv_len (-1e30 sentinel, l clamped at 1e-30), optional
// tanh softcap on the scaled scores, GQA kv head = bh / group; the fused
// backward recomputes each P tile once and feeds dV, dK and dQ from it; the
// two-sweep backward recomputes P once in each sweep.
//
// Layouts (as the reference kernels): q, dout, dq (BH, Sq, hd) with
// BH = B * Hkv * G, kv-major; k, v, dk, dv (BKV, Skv, hd).  o, lse, dq, dk,
// dv and delta are fp32; q, k, v are
// fp32 or bf16; dout is fp32 for the fused backward and in q's dtype for
// the two sweeps.
//
// What bounds it on the H100: at the main path's shapes (S = 512, hd = 128)
// attention does ~2*S*hd flops per loaded q/k/v element, so its floor is
// the bf16 tensor cores' rate together with the bytes it must move (for
// bf16 the bytes bound is the larger at this shape; fp32's passes, below,
// make the operations the larger).  Every kernel runs on the tensor cores
// for both dtypes; no attention product runs as fp32 FMAs:
//
// bf16 q, k, v (the main path): the three tensor-core kernels
// (fa_fwd_tc_kernel, fa_bwd_tc_kernel, fa_bwd_dq_tc_kernel;
// tensor_core.cuh): warp-level mma.sync m16n8k16 bf16 -> fp32 with
// operands read from shared memory by ldmatrix (.trans for V, dO, Q and K
// where they are B operands along their rows, and for dS^T as dQ's A
// operand); tiles kept in shared memory as bf16 in rows padded by 16 B so
// that ldmatrix has no bank conflicts; the next K/V tile (forward, dQ
// sweep) or Q/dO/lse/delta tile (fused backward, dK/dV sweep) copied by
// cp.async into a second stage while the current one computes.  Products
// of two bf16 operands are exact in fp32, so S = Q K^T takes one pass and
// is scaled afterwards.  P and dS are fp32, and so is the fused kernel's
// dO; each is split into hi = bf16(x) and lo = bf16(x - hi) (residual
// <= 2^-17 |x|) and every product over them sums its passes into one fp32
// fragment.  Fused: O += P V 2 passes, dP = dO V^T 2, dV += P^T dO 3
// (hi.hi, hi.lo, lo.hi), dK += dS^T Q 2, dQ += dS K 2.  The sweeps read dO
// in bf16 (on the training path it is the grad of a bf16 output, so an
// fp32 copy would carry a zero lo half): dQ sweep S 1, dP 1, dQ += dS K 2;
// dK/dV sweep S^T 1, dP^T 1, dV += P^T dO 2, dK += dS^T Q 2.  That keeps
// the kernels within the fp32 reference's 1e-4 checks, which one bf16
// rounding of P (~2^-9) would not.  P, dS (and their transposes) stay in
// registers from the score product to the next product (the C fragment
// of two n-tiles is the A fragment of one k-step); the fused kernel's
// dS^T goes through shared memory once, for dQ.
//
// fp32 q, k, v: the same three kernels, with every fp32 operand in bf16
// planes (TF32 would miss the fp32 checks).  A
// pre-pass (fa_split_kernel) writes each of q, k and v as three planes,
// x = p0 + p1 + p2 exactly, each the round to nearest of what the planes
// before it leave, so p0 + p1 is split_bf16x2's hi + lo (~2^-17 |x|); the
// kernels load planes as they load bf16 tensors.  The scores S = Q K^T
// take the six passes (i, j) with i + j <= 2 (~2^-22 relative per
// product), each k-step's into a fresh fragment added in fp32 (the tensor
// cores round each sum toward zero); with two planes (three passes) the
// scores' error, which the exponential carries into P, missed the
// forward's 1e-5 check on o (PERF.md, scripts/torch_emu_fa_error.py).
// The forward's O += P V takes five passes (P hi/lo against V's three
// planes, i + j <= 2), into a fresh fragment per kv tile: V in hi/lo
// alone left ~2^-17 of V in o, within 1.5x of the check.  The backward's
// other products take three passes (hi.hi, hi.lo, lo.hi) of planes 0 and
// 1 of both operands: dP = dO V^T, dV += P^T dO, dK += dS^T Q, dQ += dS K,
// with the fp32 dO (the sweeps read it in q's dtype) split into hi and lo
// in the kernel: fused S 6 + 4 x 3 = 18 passes, dQ sweep S 6 + dP 3 + dQ 3
// = 12, dK/dV sweep S 6 + 3 x 3 = 15.  The planes fill shared memory, so
// the fp32 tiles differ (TcFwd, TcBwd, TcDq).  What bounds them: at the
// main shape the passes (11 forward, 18 fused, 12 and 15 the sweeps, each
// over 2 hd flops an unmasked pair: 0.048, 0.078, 0.052 and 0.065 ms at
// the bf16 rate) outweigh the bytes (0.030, 0.050, 0.040 and 0.040 ms).
//
// All skip kv tiles that the mask removes entirely (causal upper
// triangle, outside the window, past kv_len), which the TPU's sequential
// grid could not do.  They order their grids so that the
// heaviest CTAs under the causal mask start first (last q tiles in the
// forward and the dQ sweep, first kv tiles in the backward).
//
// Forward: one CTA per (bh, q tile); the kv loop runs inside the CTA with
// (m, l, acc) in registers.  A q tile holding a row with no valid key at all
// (only possible when Skv < S with a window) processes every kv tile, so
// such a row keeps the reference's result (uniform weights over the masked
// keys).  For every other row skipping is exact: a skipped tile adds
// exp(-1e30 - m) = 0 or is wiped by corr = 0 when the first valid tile
// arrives, as in the reference.
//
// Fused backward: one CTA per (bkv, kv tile), looping over the group's G
// heads and all q tiles with dK/dV accumulated in registers.  The kv tiles
// of one q tile run in different CTAs, and their dQ contributions are
// summed in place, in kv-tile order, as the reference's dq_strategy="alias"
// carries dQ through its sequential grid: each (bh, q tile) has a turn
// counter (zeroed by the caller, as dQ is), and the CTA of kv tile j waits
// until it reads j's place among the tiles the mask leaves that q tile,
// adds its dS K to dQ with plain loads and stores, and hands the turn on
// (tensor_core.cuh::wait_turn / pass_turn).  The kv tile is the slowest
// dimension of the grid's block order, so every CTA waits only for CTAs
// dispatched before it.  It recomputes no P tile twice, has no atomics and
// needs no scratch: dQ repeats bit for bit (0 + c_0 + c_1 + ... in fp32,
// the sum the reference's partials strategy forms).
//
// Two-sweep backward, deterministic: the dK/dV sweep is the fused kernel's
// loop without its dQ (fa_bwd_tc_kernel with kDQ = false: no dS^T tiles,
// no turns, dO read in q's dtype); the dQ sweep runs one CTA per (bh, q
// tile) that loops over the kv tiles the mask leaves, recomputes P and dS
// for each, keeps dQ in registers and writes it once.  Neither sweep has atomics, so
// both give bit-identical results run to run, at the price of recomputing
// P (and dP) twice.  In the backward a masked P is exactly zero, so
// skipping a fully masked tile is exact for every row, rows with no valid
// key included.
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

using rt::kNegInf;
using rt::kThreads;

__device__ __forceinline__ bool fa_keep(int qp, int kp, int causal,
                                        int window, int kv_len) {
  bool ok = kp < kv_len;
  if (causal) ok = ok && qp >= kp;
  if (window) ok = ok && (qp - kp) < window;
  return ok;
}

// true when the mask removes every (q, k) pair of rows [qa, qb] x keys [ka, kb]
__device__ __forceinline__ bool fa_tile_masked(int qa, int qb, int ka, int kb,
                                               int causal, int window,
                                               int kv_len) {
  if (ka >= kv_len) return true;
  if (causal && ka > qb) return true;
  if (window && qa - kb >= window) return true;
  return false;
}

// Work item u of a (bkv, kv tile) backward CTA: q tile nq - 1 - u / group,
// head u % group.  From the last q tile down, the group's heads inside,
// every kv tile meets a given item at the same place in its own order (a
// later kv tile, with fewer q tiles under the causal mask, at the same
// place or later), so in the fused kernel the tile before has taken its
// dQ turn there about one item earlier: a CTA waits about one item once,
// not at every item.
__device__ __forceinline__ int fa_bwd_item_q(int u, int group, int nq) {
  return nq - 1 - u / group;
}

// kv tile j's turn on the q tile starting at row q0 in the fused backward:
// the mask leaves a q tile one run of kv tiles (causal and kv_len cut its
// end, the window its start), so the turn is j less the run's first tile,
// the first one whose last key kb = (j + 1) BK - 1 passes the window
// (kb > q0 - window)
__device__ __forceinline__ int fa_dq_turn(int q0, int j, int BK, int window) {
  return window ? j - max(0, (q0 - window + 1) / BK) : j;
}

// true when query row q has no valid key in [0, Skv)
__device__ __forceinline__ bool fa_row_empty(int q, int Skv, int causal,
                                             int window, int kv_len) {
  int hi = min(kv_len, Skv) - 1;
  if (causal) hi = min(hi, q);
  const int lo = window ? max(0, q - window + 1) : 0;
  return lo > hi;
}

// ---------------------------------------------------------------------------
// Tensor-core kernels: the forward, the fused backward and the two sweeps
// of the split backward, over bf16 q, k, v or the bf16 planes of fp32 ones
// (see the note at the head of the file)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// Rows of ROWS x HD bf16 from global rows [row0, row0 + ROWS) (rows at or
// past nrows read as zeros) into shared rows of stride LD, 16 B a copy.
template <int ROWS, int HD, int LD, int NT>
__device__ __forceinline__ void tc_load_rows(bf16* dst, const bf16* src,
                                             int row0, int nrows) {
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < ROWS * CH; e += NT) {
    const int r = e / CH, c = e % CH * 8;
    const bool in = row0 + r < nrows;
    rt::cp_async16(dst + r * LD + c, src + (size_t)(in ? row0 + r : 0) * HD + c,
                   in ? 16 : 0);
  }
}

using rt::tc_a_off;
using rt::tc_akm_off;
using rt::tc_bkn_off;
using rt::tc_bnk_off;
using rt::tc_c_to_a;

constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// true when the mask keeps every pair of rows [qa, qb] x keys [ka, kb] and
// every one of them lies inside the tensors (no masking needed)
__device__ __forceinline__ bool tc_tile_whole(int qa, int qb, int ka, int kb,
                                              int Skv, int causal, int window,
                                              int kv_len) {
  if (kb >= min(kv_len, Skv)) return false;
  if (causal && kb > qa) return false;
  if (window && qb - ka >= window) return false;
  return true;
}

// The fp32 route's planes (see the head of the file): of q and k, and of v
// (the forward's; the backward reads v's first two); one plane for bf16,
// the tensor itself.
constexpr int kQkPlanes = 3, kVPlanes = 3;
template <typename T>
constexpr int planes_of = std::is_same_v<T, bf16> ? 1 : kQkPlanes;

// One fp32 tensor of n elements (n % 4 == 0, 16-B aligned) into np bf16
// planes, plane p at planes + p n: x = p0 + p1 + p2 with each plane the
// round to nearest of what the planes before it leave, each difference
// exact in fp32, so three planes give x back exactly and the first two
// are split_bf16x2's hi + lo.
struct FaSplit {
  const float* x;
  bf16* planes;
  long long n;
  int np;
};
struct FaSplitQkv { FaSplit t[3]; };

// blockIdx.y picks the tensor (q, k, v; selected with constant indices, as
// a parameter array indexed at run time goes through local memory); four
// elements a thread, one 16-B load and one 8-B store a plane
__global__ void __launch_bounds__(kThreads) fa_split_kernel(FaSplitQkv a) {
  const FaSplit s = blockIdx.y == 0 ? a.t[0] : blockIdx.y == 1 ? a.t[1]
                                                               : a.t[2];
  const long long e = ((long long)blockIdx.x * kThreads + threadIdx.x) * 4;
  if (e >= s.n) return;
  const float4 x = *reinterpret_cast<const float4*>(s.x + e);
  float r[4] = {x.x, x.y, x.z, x.w};
  for (int p = 0; p < s.np; ++p) {
    uint32_t w[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(r[2 * i], r[2 * i + 1]);
      const float2 hf = __bfloat1622float2(h);
      r[2 * i] -= hf.x;
      r[2 * i + 1] -= hf.y;
      w[i] = rt::bf16x2_bits(h);
    }
    *reinterpret_cast<uint2*>(s.planes + p * s.n + e) = make_uint2(w[0], w[1]);
  }
}

cudaError_t fa_split(const FaSplitQkv& a, cudaStream_t st) {
  long long n = 0;
  for (const FaSplit& s : a.t) n = s.n > n ? s.n : n;
  const dim3 grid((unsigned)((n / 4 + kThreads - 1) / kThreads), 3);
  fa_split_kernel<<<grid, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

// d += A B over NP-plane fragments of a 16 x 16 A and two 8-column B
// n-tiles (b[plane]: registers 0-1 and 2-3), the passes (i, j) with
// i + j < NP, largest first: one pass for bf16, hi.hi, hi.lo, lo.hi for
// two planes, six for three.
template <int NP>
__device__ __forceinline__ void mma_planes(float (&d0)[4], float (&d1)[4],
                                           const uint32_t (&a)[NP][4],
                                           const uint32_t (&b)[NP][4]) {
#pragma unroll
  for (int s = 0; s < NP; ++s)
#pragma unroll
    for (int i = 0; i <= s; ++i) {
      rt::mma_bf16(d0, a[i], b[s - i][0], b[s - i][1]);
      rt::mma_bf16(d1, a[i], b[s - i][2], b[s - i][3]);
    }
}

// Forward tiling: each warp owns 16 q rows and HD / NSPLIT columns of O
// (at hd 256 two warps share a row block and both compute its scores).
// fp32 (NP > 1): Q's planes stay for the whole kv loop and each stage
// holds K's and V's, so the tiles shrink to fit (hd 128: BQ 128, BK 32,
// 208,896 B, one CTA of 8 warps an SM; hd 256: BQ 64, BK 16, 202,752 B).
template <int HD, int NP> struct TcFwd {
  static constexpr int NV = NP > 1 ? kVPlanes : 1;  // planes of V
  static constexpr int NSPLIT = HD > 128 ? 2 : 1;
  static constexpr int BQ = NP > 1 && HD <= 128 ? 128 : 64;
  static constexpr int BK = (HD > 128 ? 32 : 64) / (NP > 1 ? 2 : 1);
  static constexpr int THREADS = 32 * (BQ / 16) * NSPLIT;
  static constexpr int LD = HD + 8;  // padded rows: ldmatrix conflict-free
  // Q's planes, then two stages of (K's planes, V's planes)
  static constexpr size_t SMEM =
      (size_t)(NP * BQ + 2 * (NP + NV) * BK) * LD * sizeof(bf16);
};

// NP planes of q and k, TcFwd::NV of v; plane p of q lies p BH Sq HD
// elements on, of k and v p BKV Skv HD
template <int HD, int NP>
__global__ void __launch_bounds__(TcFwd<HD, NP>::THREADS)
fa_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Skv, int group,
                 int causal, int window, float softcap, float scale,
                 int kv_len) {
  using C = TcFwd<HD, NP>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, NT = C::THREADS;
  constexpr int NV = C::NV;
  constexpr int DW = HD / C::NSPLIT;      // O columns per warp
  constexpr int NS = BK / 8, NO = DW / 8;  // n-tiles of S and of O
  extern __shared__ __align__(16) bf16 smem_bf[];
  bf16* sQ = smem_bf;              // NP planes of BQ x LD
  bf16* sKV = sQ + NP * BQ * LD;   // stage s: K's planes, then V's

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rb = warp % (BQ / 16) * 16, d0 = warp / (BQ / 16) * DW;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const int qb = min(q0 + BQ, Sq) - 1;
  const size_t qps = (size_t)gridDim.x * Sq * HD;
  const size_t kps = (size_t)(gridDim.x / group) * Skv * HD;
  const bf16* qg = q + (size_t)bh * Sq * HD;
  const bf16* kg = k + (size_t)(bh / group) * Skv * HD;
  const bf16* vg = v + (size_t)(bh / group) * Skv * HD;

#pragma unroll
  for (int p = 0; p < NP; ++p)
    tc_load_rows<BQ, HD, LD, NT>(sQ + p * BQ * LD, qg + p * qps, q0, Sq);
  const int tid = threadIdx.x;
  const bool empty = tid < BQ && q0 + tid < Sq &&
                     fa_row_empty(q0 + tid, Skv, causal, window, kv_len);
  const bool may_skip = !__syncthreads_or(empty);
  const int nk = (Skv + BK - 1) / BK;
  auto next_tile = [&](int j) {  // first kv tile >= j that is visited
    for (; j < nk; ++j)
      if (!(may_skip && fa_tile_masked(q0, qb, j * BK,
                                       min(j * BK + BK, Skv) - 1, causal,
                                       window, kv_len)))
        break;
    return j;
  };
  auto load_kv = [&](int j, int stage) {
    bf16* sK = sKV + stage * (NP + NV) * BK * LD;
#pragma unroll
    for (int p = 0; p < NP; ++p)
      tc_load_rows<BK, HD, LD, NT>(sK + p * BK * LD, kg + p * kps, j * BK,
                                   Skv);
#pragma unroll
    for (int p = 0; p < NV; ++p)
      tc_load_rows<BK, HD, LD, NT>(sK + (NP + p) * BK * LD, vg + p * kps,
                                   j * BK, Skv);
  };

  const float scale2 = scale * kLog2e;
  float m_i[2] = {kNegInf * kLog2e, kNegInf * kLog2e}, l_i[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int j = next_tile(0), stage = 0;
  if (j < nk) load_kv(j, 0);
  rt::cp_async_commit();
  while (j < nk) {
    const int jn = next_tile(j + 1);
    if (jn < nk) {
      load_kv(jn, stage ^ 1);
      rt::cp_async_commit();
      rt::cp_async_wait<1>();
    } else {
      rt::cp_async_wait<0>();
    }
    __syncthreads();  // tile j (and Q) landed for every thread
    const bf16* sK = sKV + stage * (NP + NV) * BK * LD;
    const bf16* sV = sK + NP * BK * LD;

    // S = Q K^T: bf16 products are exact in fp32, one pass; fp32 the
    // planes' six passes, each k-step's into a fresh fragment
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[NP][4];
#pragma unroll
      for (int p = 0; p < NP; ++p)
        rt::ldmatrix_x4(a[p], sQ + p * BQ * LD + tc_a_off(rb, kk * 16, LD));
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t b[NP][4];
#pragma unroll
        for (int p = 0; p < NP; ++p)
          rt::ldmatrix_x4(b[p],
                          sK + p * BK * LD + tc_bnk_off(n * 8, kk * 16, LD));
        if constexpr (NP == 1) {
          mma_planes<NP>(s[n], s[n + 1], a, b);
        } else {
          float f[2][4] = {};
          mma_planes<NP>(f[0], f[1], a, b);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[n][e] += f[0][e];
            s[n + 1][e] += f[1][e];
          }
        }
      }
    }

    // online softmax over rows g and g + 8 of the warp's block, in base 2:
    // scores carry a factor log2(e), so each exponential is one exp2f
    const int k0 = j * BK;
    const bool whole = tc_tile_whole(q0, qb, k0, k0 + BK - 1, Skv, causal,
                                     window, kv_len);
    float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = softcap != 0.f
                      ? tanhf(s[n][e] * scale / softcap) * softcap * kLog2e
                      : s[n][e] * scale2;
        if (!whole) {  // uniform over the block
          const int qp = q0 + rb + g + 8 * (e >> 1);
          const int kp = k0 + n * 8 + 2 * t + (e & 1);
          // columns past the tensor's Skv are not keys at all (weight 0
          // even for a row with no valid key); masked keys get the -1e30
          // sentinel (times log2(e): lse comes back as -1e30 + log l)
          x = kp >= Skv ? -INFINITY
                        : (fa_keep(qp, kp, causal, window, kv_len)
                               ? x : kNegInf * kLog2e);
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = rt::quad_max(mx[r]);
      corr[r] = exp2f(m_i[r] - m_new);
      m_i[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m_i[e >> 1]);
        s[n][e] = p;
        ps[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_i[r] = l_i[r] * corr[r] + rt::quad_sum(ps[r]);
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];

    // O += P V with P = P_hi + P_lo: two passes against a bf16 V (exact)
    // into O; against V's planes the passes (i, j) of (P_hi, P_lo) x V's
    // planes with i + j < NV (five: V's three planes carry it exactly, so
    // only P's residual remains), into a fresh fragment per kv tile that is
    // added to O in fp32, so that the tensor cores' rounding toward zero
    // does not build up over the kv loop
    if constexpr (NV == 1) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t ph[4], pl[4];
        tc_c_to_a(s, kk, ph, pl);
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          uint32_t b[4];
          rt::ldmatrix_x4_trans(b, sV + tc_bkn_off(kk * 16, d0 + n * 8, LD));
          rt::mma_bf16(acc[n], ph, b[0], b[1]);
          rt::mma_bf16(acc[n], pl, b[0], b[1]);
          rt::mma_bf16(acc[n + 1], ph, b[2], b[3]);
          rt::mma_bf16(acc[n + 1], pl, b[2], b[3]);
        }
      }
    } else {
      uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) tc_c_to_a(s, kk, ph[kk], pl[kk]);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        float f[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          uint32_t b[NV][4];
#pragma unroll
          for (int p = 0; p < NV; ++p)
            rt::ldmatrix_x4_trans(
                b[p], sV + p * BK * LD + tc_bkn_off(kk * 16, d0 + n * 8, LD));
#pragma unroll
          for (int p = 0; p < NV; ++p)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              rt::mma_bf16(f[h], ph[kk], b[p][2 * h], b[p][2 * h + 1]);
              if (p + 1 < NV)
                rt::mma_bf16(f[h], pl[kk], b[p][2 * h], b[p][2 * h + 1]);
            }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[n][e] += f[0][e];
          acc[n + 1][e] += f[1][e];
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before its reload
    stage ^= 1;
    j = jn;
  }
  rt::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rb + g + 8 * r;
    if (row < Sq) {
      const float l = fmaxf(l_i[r], 1e-30f);
      float* og = o + ((size_t)bh * Sq + row) * HD + d0;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<float2*>(og + n * 8 + 2 * t) =
            make_float2(acc[n][2 * r] / l, acc[n][2 * r + 1] / l);
      if (t == 0 && d0 == 0)
        lse[(size_t)bh * Sq + row] = m_i[r] * kLn2 + logf(l);
    }
  }
}

// Backward tiling, one CTA per (bkv, kv tile) looping over the group's G
// heads and all q tiles: each warp owns 16 keys of the kv tile and
// HD / NSPLIT columns of dK and dV (at hd 256 two warps share 16 keys and
// both compute their S^T and dP^T).  For dQ = dS K (the fused backward)
// the same warps split the BQ x HD tile into 16-row blocks x DQW columns.
// fp32 q, k, v (NP > 1): K's and Q's planes and V's first two fill shared
// memory (hd 128: 183,808 B with dQ, 173,568 B for the dK/dV sweep, one
// CTA an SM); at hd 256 the tiles shrink to BK 32, BQ 16 (171,776 B with
// dQ).
template <int HD, int NP> struct TcBwd {
  // planes of V, and of Q and K outside the score product
  static constexpr int NV = NP > 1 ? 2 : 1;
  static constexpr int NSPLIT = HD > 128 ? 2 : 1;
  static constexpr bool kSmall = NP > 1 && HD > 128;
  static constexpr int BK = kSmall ? 32 : 64;
  static constexpr int BQ = kSmall ? 16 : (HD > 64 ? 32 : 64);
  static constexpr int WARPS = BK / 16 * NSPLIT, THREADS = 32 * WARPS;
  static constexpr int DQW = HD / (WARPS / (BQ / 16));
  static constexpr int LD = HD + 8, LDS = BQ + 8;  // padded bf16 rows
  // bf16: K's and V's planes, two stages of Q's planes, two dO tiles (hi
  // and lo of an fp32 dO, or two stages of a bf16 one) and, with dQ, dS^T
  // hi and lo; fp32: the staging tile of an fp32 dO, two stages of (lse,
  // delta)
  template <typename TO, bool kDQ>
  static constexpr size_t smem() {
    return (size_t)((NP + NV) * BK * LD + 2 * NP * BQ * LD + 2 * BQ * LD +
                    (kDQ ? 2 * BK * LDS : 0)) *
               sizeof(bf16) +
           (size_t)((std::is_same_v<TO, float> ? BQ * HD : 0) + 4 * BQ) *
               sizeof(float);
  }
};

// kDQ: the fused backward (an fp32 dO split into hi + lo, dQ summed in
// kv-tile order through the turn counters); !kDQ: the dK/dV sweep of the
// two-sweep backward (dO in q's dtype; no dS^T tiles, no dQ).  Over bf16
// q, k, v (NP 1) or the planes of fp32 ones (NP planes of q and k, of
// which dK and dQ read the first two, and the first two of v's, laid out
// as for the forward), which need an fp32 dO.
template <int HD, typename TO, bool kDQ, int NP>
__global__ void __launch_bounds__(TcBwd<HD, NP>::THREADS)
fa_bwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const TO* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 int* __restrict__ turns, float* __restrict__ dk,
                 float* __restrict__ dv, int Sq, int Skv, int group,
                 int causal, int window, float softcap, float scale,
                 int kv_len) {
  using C = TcBwd<HD, NP>;
  constexpr bool kSplitO = std::is_same_v<TO, float>;
  static_assert(kSplitO || std::is_same_v<TO, bf16>, "dO is fp32 or bf16");
  static_assert(NP == 1 || kSplitO, "planes need an fp32 dO");
  constexpr int NV = C::NV;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, LDS = C::LDS;
  constexpr int NT = C::THREADS, DW = HD / C::NSPLIT, DQW = C::DQW;
  constexpr int NS = BQ / 8, NO = DW / 8, NQ = DQW / 8;
  extern __shared__ __align__(16) bf16 smem_bf[];
  bf16* sK = smem_bf;             // NP planes of BK x LD
  bf16* sV = sK + NP * BK * LD;   // NV planes of BK x LD
  bf16* sQ = sV + NV * BK * LD;   // 2 stages of NP planes of BQ x LD
  bf16* sOh = sQ + 2 * NP * BQ * LD;  // dO hi (fp32 dO) or dO stage 0
  bf16* sOl = sOh + BQ * LD;      // dO lo (fp32 dO) or dO stage 1
  bf16* sSh = sOl + BQ * LD;      // dS^T hi, BK x LDS (with dQ)
  bf16* sSl = sSh + (kDQ ? BK * LDS : 0);  // dS^T lo
  // dO, BQ x HD (fp32 dO)
  float* sOf = reinterpret_cast<float*>(sSl + (kDQ ? BK * LDS : 0));
  // stage s: lse at 2 s BQ, delta after it
  float* sLD = sOf + (kSplitO ? BQ * HD : 0);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kr = warp % (BK / 16) * 16, d0 = warp / (BK / 16) * DW;
  const int qr = warp % (BQ / 16) * 16, dq0 = warp / (BQ / 16) * DQW;
  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * BK;  // kv tile 0 (most q tiles) first
  const int kb = min(k0 + BK, Skv) - 1;
  const int nq = (Sq + BQ - 1) / BQ, nu = group * nq;
  // plane strides of k and v, and of q
  const size_t kps = (size_t)gridDim.x * Skv * HD;
  const size_t qps = (size_t)gridDim.x * group * Sq * HD;

#pragma unroll
  for (int p = 0; p < NP; ++p)
    tc_load_rows<BK, HD, LD, NT>(sK + p * BK * LD,
                                 k + p * kps + (size_t)bkv * Skv * HD, k0,
                                 Skv);
#pragma unroll
  for (int p = 0; p < NV; ++p)
    tc_load_rows<BK, HD, LD, NT>(sV + p * BK * LD,
                                 v + p * kps + (size_t)bkv * Skv * HD, k0,
                                 Skv);
  // work items (fa_bwd_item_q), skipping the tiles the mask removes
  auto item_q = [&](int u) { return fa_bwd_item_q(u, group, nq); };
  auto next_item = [&](int u) {
    for (; u < nu; ++u) {
      const int q0 = item_q(u) * BQ;
      if (!fa_tile_masked(q0, min(q0 + BQ, Sq) - 1, k0, kb, causal, window,
                          kv_len))
        break;
    }
    return u;
  };
  auto load_q = [&](int u, int stage) {
    const size_t bh = (size_t)bkv * group + u % group;
    const int q0 = item_q(u) * BQ;
#pragma unroll
    for (int p = 0; p < NP; ++p)
      tc_load_rows<BQ, HD, LD, NT>(sQ + (stage * NP + p) * BQ * LD,
                                   q + p * qps + bh * Sq * HD, q0, Sq);
    const TO* og = dout + bh * Sq * HD;
    if constexpr (kSplitO) {
      for (int e = threadIdx.x; e < BQ * HD / 4; e += NT) {
        const int r = e / (HD / 4), c = e % (HD / 4) * 4;
        const bool in = q0 + r < Sq;
        rt::cp_async16(sOf + r * HD + c,
                       og + (size_t)(in ? q0 + r : 0) * HD + c, in ? 16 : 0);
      }
    } else {
      tc_load_rows<BQ, HD, LD, NT>(sOh + stage * BQ * LD, og, q0, Sq);
    }
    float* sl = sLD + stage * 2 * BQ;
    for (int e = threadIdx.x; e < 2 * BQ; e += NT) {
      const int r = e % BQ;
      const bool in = q0 + r < Sq;
      const float* src = (e < BQ ? lse : delta) + bh * Sq + (in ? q0 + r : 0);
      rt::cp_async4(sl + e, src, in ? 4 : 0);
    }
  };

  const float scale2 = scale * kLog2e;
  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  int u = next_item(0), stage = 0;
  if (u < nu) load_q(u, 0);
  rt::cp_async_commit();
  while (u < nu) {
    const size_t bh = (size_t)bkv * group + u % group;
    const int q0 = item_q(u) * BQ;
    rt::cp_async_wait<0>();
    if constexpr (kSplitO) {
      __syncthreads();  // this item's tiles landed; the last item is done
      // dO (fp32) -> dO hi + dO lo (bf16)
      for (int e = threadIdx.x; e < BQ * HD / 2; e += NT) {
        const int r = e / (HD / 2), c = e % (HD / 2) * 2;
        uint32_t hi, lo;
        rt::split_bf16x2(sOf[r * HD + c], sOf[r * HD + c + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(sOh + r * LD + c) = hi;
        *reinterpret_cast<uint32_t*>(sOl + r * LD + c) = lo;
      }
      for (int e = threadIdx.x; e < BQ; e += NT)
        sLD[stage * 2 * BQ + e] *= kLog2e;
      __syncthreads();  // dO hi/lo and lse * log2(e) ready, the staging free
    } else {
      // each thread scales the lse entries it copied itself (its wait made
      // them visible to it), so one barrier serves
      for (int e = threadIdx.x; e < BQ; e += NT)
        sLD[stage * 2 * BQ + e] *= kLog2e;
      __syncthreads();  // this item's tiles landed; the last item is done
    }
    const int un = next_item(u + 1);
    if (un < nu) load_q(un, stage ^ 1);  // lands while this item computes
    rt::cp_async_commit();
    const bf16* sQs = sQ + stage * NP * BQ * LD;
    const bf16* sOs = sOh + stage * BQ * LD;  // bf16 dO
    const float* sL = sLD + stage * 2 * BQ;
    const float* sD = sL + BQ;

    // S^T = K Q^T (one pass; fp32: the planes' six, each k-step's into a
    // fresh fragment) and dP^T = V dO^T (dO hi and lo, and with V's planes
    // vl.oh too, or the bf16 dO in one pass) for the warp's 16 keys x BQ
    // queries
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t ak[NP][4], av[NV][4];
#pragma unroll
      for (int p = 0; p < NP; ++p)
        rt::ldmatrix_x4(ak[p], sK + p * BK * LD + tc_a_off(kr, kk * 16, LD));
#pragma unroll
      for (int p = 0; p < NV; ++p)
        rt::ldmatrix_x4(av[p], sV + p * BK * LD + tc_a_off(kr, kk * 16, LD));
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        const int off = tc_bnk_off(n * 8, kk * 16, LD);
        uint32_t bq[NP][4];
#pragma unroll
        for (int p = 0; p < NP; ++p)
          rt::ldmatrix_x4(bq[p], sQs + p * BQ * LD + off);
        if constexpr (kSplitO) {
          uint32_t bh_[4], bl[4];
          rt::ldmatrix_x4(bh_, sOh + off);
          rt::ldmatrix_x4(bl, sOl + off);
          if constexpr (NP == 1) {
            mma_planes<NP>(s[n], s[n + 1], ak, bq);
          } else {
            float f[2][4] = {};
            mma_planes<NP>(f[0], f[1], ak, bq);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              s[n][e] += f[0][e];
              s[n + 1][e] += f[1][e];
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            rt::mma_bf16(dp[n + h], av[0], bh_[2 * h], bh_[2 * h + 1]);
            rt::mma_bf16(dp[n + h], av[0], bl[2 * h], bl[2 * h + 1]);
            if constexpr (NV > 1)
              rt::mma_bf16(dp[n + h], av[1], bh_[2 * h], bh_[2 * h + 1]);
          }
        } else {
          uint32_t bo[4];
          rt::ldmatrix_x4(bo, sOs + off);
          mma_planes<NP>(s[n], s[n + 1], ak, bq);
          rt::mma_bf16(dp[n], av[0], bo[0], bo[1]);
          rt::mma_bf16(dp[n + 1], av[0], bo[2], bo[3]);
        }
      }
    }
    // P^T into s, dS^T into dp (exponentials in base 2: sL holds lse
    // times log2(e))
    const bool whole = q0 + BQ <= Sq &&
                       tc_tile_whole(q0, q0 + BQ - 1, k0, k0 + BK - 1, Skv,
                                     causal, window, kv_len);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = n * 8 + 2 * t + (e & 1);
        float x2, chain = 1.f;
        if (softcap != 0.f) {
          const float x = tanhf(s[n][e] * scale / softcap) * softcap;
          const float uu = x / softcap;
          chain = 1.f - uu * uu;  // d softcap / d s_raw
          x2 = x * kLog2e - sL[qc];
        } else {
          x2 = fmaf(s[n][e], scale2, -sL[qc]);
        }
        float p = exp2f(x2);
        if (!whole) {  // uniform over the block
          const int kp = k0 + kr + g + 8 * (e >> 1), qp = q0 + qc;
          if (!(qp < Sq && fa_keep(qp, kp, causal, window, kv_len))) p = 0.f;
        }
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - sD[qc]) * chain * scale;
      }

    // dV += P^T dO (fp32 dO: hi.hi, hi.lo, lo.hi; bf16 dO: P hi, P lo);
    // dK += dS^T Q (dS hi, lo; with Q's planes sh.ql too); with dQ, dS^T
    // hi/lo to shared memory
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      tc_c_to_a(s, kk, ph, pl);
      tc_c_to_a(dp, kk, sh, sl);
      if (kDQ && d0 == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int off = (kr + g + 8 * (i & 1)) * LDS + kk * 16 +
                          8 * (i >> 1) + 2 * t;
          *reinterpret_cast<uint32_t*>(sSh + off) = sh[i];
          *reinterpret_cast<uint32_t*>(sSl + off) = sl[i];
        }
      }
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        const int off = tc_bkn_off(kk * 16, d0 + n * 8, LD);
        if constexpr (kSplitO) {
          uint32_t oh[4], ol[4], bq[NV][4];
          rt::ldmatrix_x4_trans(oh, sOh + off);
          rt::ldmatrix_x4_trans(ol, sOl + off);
#pragma unroll
          for (int p = 0; p < NV; ++p)
            rt::ldmatrix_x4_trans(bq[p], sQs + p * BQ * LD + off);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float(&dvn)[4] = dv_acc[n + h];
            float(&dkn)[4] = dk_acc[n + h];
            rt::mma_bf16(dvn, ph, oh[2 * h], oh[2 * h + 1]);
            rt::mma_bf16(dvn, ph, ol[2 * h], ol[2 * h + 1]);
            rt::mma_bf16(dvn, pl, oh[2 * h], oh[2 * h + 1]);
            rt::mma_bf16(dkn, sh, bq[0][2 * h], bq[0][2 * h + 1]);
            rt::mma_bf16(dkn, sl, bq[0][2 * h], bq[0][2 * h + 1]);
            if constexpr (NV > 1)
              rt::mma_bf16(dkn, sh, bq[1][2 * h], bq[1][2 * h + 1]);
          }
        } else {
          uint32_t bo[4], bq[4];
          rt::ldmatrix_x4_trans(bo, sOs + off);
          rt::ldmatrix_x4_trans(bq, sQs + off);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float(&dvn)[4] = dv_acc[n + h];
            float(&dkn)[4] = dk_acc[n + h];
            rt::mma_bf16(dvn, ph, bo[2 * h], bo[2 * h + 1]);
            rt::mma_bf16(dvn, pl, bo[2 * h], bo[2 * h + 1]);
            rt::mma_bf16(dkn, sh, bq[2 * h], bq[2 * h + 1]);
            rt::mma_bf16(dkn, sl, bq[2 * h], bq[2 * h + 1]);
          }
        }
      }
    }

    if constexpr (kDQ) {
      __syncthreads();  // dS^T complete

      // this kv tile's dQ contribution dS K for the warp's 16 q rows x DQW
      // columns (dS hi, lo; with K's planes ah.kl too), added to dQ in its
      // turn
      float dqa[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t ah[4], al[4];
        rt::ldmatrix_x4_trans(ah, sSh + tc_akm_off(kk * 16, qr, LDS));
        rt::ldmatrix_x4_trans(al, sSl + tc_akm_off(kk * 16, qr, LDS));
#pragma unroll
        for (int n = 0; n < NQ; n += 2) {
          uint32_t b[NV][4];
#pragma unroll
          for (int p = 0; p < NV; ++p)
            rt::ldmatrix_x4_trans(
                b[p], sK + p * BK * LD + tc_bkn_off(kk * 16, dq0 + n * 8, LD));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            rt::mma_bf16(dqa[n + h], ah, b[0][2 * h], b[0][2 * h + 1]);
            rt::mma_bf16(dqa[n + h], al, b[0][2 * h], b[0][2 * h + 1]);
            if constexpr (NV > 1)
              rt::mma_bf16(dqa[n + h], ah, b[1][2 * h], b[1][2 * h + 1]);
          }
        }
      }
      int* turn = turns + bh * nq + item_q(u);
      const int mine = fa_dq_turn(q0, blockIdx.y, BK, window);
      if (threadIdx.x == 0) rt::wait_turn(turn, mine);
      __syncthreads();  // the earlier kv tiles' sums are in dQ
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + qr + g + 8 * r;
        if (row < Sq) {
          float* dqg = dq + (bh * Sq + row) * HD + dq0;
#pragma unroll
          for (int n = 0; n < NQ; ++n) {
            float2* d = reinterpret_cast<float2*>(dqg + n * 8 + 2 * t);
            const float2 x = __ldcg(d);
            __stcg(d, make_float2(x.x + dqa[n][2 * r],
                                  x.y + dqa[n][2 * r + 1]));
          }
        }
      }
      __syncthreads();  // every warp's sum stored
      if (threadIdx.x == 0) rt::pass_turn(turn, mine + 1);
    }
    stage ^= 1;
    u = un;
  }
  rt::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + kr + g + 8 * r;
    if (row < Skv) {
      float* dkg = dk + ((size_t)bkv * Skv + row) * HD + d0;
      float* dvg = dv + ((size_t)bkv * Skv + row) * HD + d0;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        *reinterpret_cast<float2*>(dkg + n * 8 + 2 * t) =
            make_float2(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
        *reinterpret_cast<float2*>(dvg + n * 8 + 2 * t) =
            make_float2(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
      }
    }
  }
}

// dQ sweep tiling: each warp owns 16 q rows and HD / NSPLIT columns of dQ
// (at hd 256 two warps share a row block and both compute its S and dP).
// bf16: the forward's tiles; Q, dO, then two stages of (K, V).  fp32 (NP >
// 1): Q's planes and dO's hi and lo stay for the whole kv loop, and each of
// the two stages holds K's planes and V's first two (hd 128: BQ 128, BK
// 16, 217,600 B, one CTA of 8 warps an SM, 4% faster on the card than BQ
// 64, BK 32 with 4 warps; hd 256: BQ 32, BK 16, 168,960 B).
template <int HD, int NP> struct TcDq {
  using TO = std::conditional_t<(NP > 1), float, bf16>;  // dO, q's dtype
  // planes of V, and of dO and of K outside the score product
  static constexpr int NV = NP > 1 ? 2 : 1;
  static constexpr int NSPLIT = HD > 128 ? 2 : 1;
  static constexpr int BQ = NP > 1 ? (HD > 128 ? 32 : 128) : 64;
  static constexpr int BK = NP > 1 ? 16 : (HD > 128 ? 32 : 64);
  static constexpr int THREADS = 32 * (BQ / 16) * NSPLIT;
  static constexpr int LD = HD + 8;  // padded rows: ldmatrix conflict-free
  static constexpr size_t SMEM =
      (size_t)((NP + NV) * BQ + 2 * (NP + NV) * BK) * LD * sizeof(bf16);
};

// dQ sweep of the two-sweep backward: one CTA per (bh, q tile) keeps Q and
// dO in shared memory and dQ in registers, streams the kv tiles that the
// mask leaves through two cp.async stages, and writes dQ once (no
// atomics).  Per kv tile, bf16 q, k, v, dO: S = Q K^T and dP = dO V^T in
// one pass each, P and dS in registers, dQ += dS K in two (dS hi, lo).
// fp32 (NP planes of q, k and v, laid out as for the forward; dO split
// into hi and lo once per CTA as it is loaded, since every kv tile reads
// it): S in the planes' six passes, each k-step's into a fresh fragment;
// dP = dO V^T and dQ += dS K in three (hi.hi, hi.lo, lo.hi), dQ into a
// fresh fragment per kv tile that is added in fp32, so that the tensor
// cores' rounding toward zero does not build up over the kv loop.  A
// masked P is exactly zero here, so skipping fully masked tiles is exact
// for every row.
template <int HD, int NP>
__global__ void __launch_bounds__(TcDq<HD, NP>::THREADS)
fa_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const typename TcDq<HD, NP>::TO* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int Sq, int Skv, int group, int causal, int window,
                    float softcap, float scale, int kv_len) {
  using C = TcDq<HD, NP>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, NT = C::THREADS;
  constexpr int NV = C::NV;
  constexpr int DW = HD / C::NSPLIT;       // dQ columns per warp
  constexpr int NS = BK / 8, NO = DW / 8;  // n-tiles of S and of dQ
  extern __shared__ __align__(16) bf16 smem_bf[];
  bf16* sQ = smem_bf;              // NP planes of BQ x LD
  bf16* sO = sQ + NP * BQ * LD;    // dO (bf16), or its hi and lo, BQ x LD
  bf16* sKV = sO + NV * BQ * LD;   // stage s: K's planes, then V's

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rb = warp % (BQ / 16) * 16, d0 = warp / (BQ / 16) * DW;
  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const int qb = min(q0 + BQ, Sq) - 1;
  // plane strides of q, and of k and v
  const size_t qps = (size_t)gridDim.x * Sq * HD;
  const size_t kps = (size_t)(gridDim.x / group) * Skv * HD;
  const bf16* kg = k + (bh / group) * Skv * HD;
  const bf16* vg = v + (bh / group) * Skv * HD;

#pragma unroll
  for (int p = 0; p < NP; ++p)
    tc_load_rows<BQ, HD, LD, NT>(sQ + p * BQ * LD, q + p * qps + bh * Sq * HD,
                                 q0, Sq);
  if constexpr (NP == 1) {
    tc_load_rows<BQ, HD, LD, NT>(sO, dout + bh * Sq * HD, q0, Sq);
  } else {
    // dO (fp32) -> dO hi + dO lo, four elements a thread
    const float* og = dout + bh * Sq * HD;
    for (int e = threadIdx.x; e < BQ * HD / 4; e += NT) {
      const int r = e / (HD / 4), c = e % (HD / 4) * 4;
      const float4 x =
          q0 + r < Sq
              ? *reinterpret_cast<const float4*>(og + (size_t)(q0 + r) * HD + c)
              : make_float4(0.f, 0.f, 0.f, 0.f);
      uint32_t hi[2], lo[2];
      rt::split_bf16x2(x.x, x.y, hi[0], lo[0]);
      rt::split_bf16x2(x.z, x.w, hi[1], lo[1]);
      *reinterpret_cast<uint2*>(sO + r * LD + c) = make_uint2(hi[0], hi[1]);
      *reinterpret_cast<uint2*>(sO + (BQ + r) * LD + c) =
          make_uint2(lo[0], lo[1]);
    }
  }
  // lse (times log2(e)) and delta of the thread's rows g and g + 8
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rb + g + 8 * r;
    const bool in = row < Sq;
    lse2[r] = in ? lse[bh * Sq + row] * kLog2e : 0.f;
    dlt[r] = in ? delta[bh * Sq + row] : 0.f;
  }
  const int nk = (Skv + BK - 1) / BK;
  auto next_tile = [&](int j) {  // first kv tile >= j that the mask leaves
    for (; j < nk; ++j)
      if (!fa_tile_masked(q0, qb, j * BK, min(j * BK + BK, Skv) - 1, causal,
                          window, kv_len))
        break;
    return j;
  };
  auto load_kv = [&](int j, int stage) {
    bf16* sK = sKV + stage * (NP + NV) * BK * LD;
#pragma unroll
    for (int p = 0; p < NP; ++p)
      tc_load_rows<BK, HD, LD, NT>(sK + p * BK * LD, kg + p * kps, j * BK,
                                   Skv);
#pragma unroll
    for (int p = 0; p < NV; ++p)
      tc_load_rows<BK, HD, LD, NT>(sK + (NP + p) * BK * LD, vg + p * kps,
                                   j * BK, Skv);
  };

  const float scale2 = scale * kLog2e;
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int j = next_tile(0), stage = 0;
  if (j < nk) load_kv(j, 0);
  rt::cp_async_commit();
  while (j < nk) {
    const int jn = next_tile(j + 1);
    if (jn < nk) {
      load_kv(jn, stage ^ 1);
      rt::cp_async_commit();
      rt::cp_async_wait<1>();
    } else {
      rt::cp_async_wait<0>();
    }
    __syncthreads();  // tile j (and Q, dO) landed for every thread
    const bf16* sK = sKV + stage * (NP + NV) * BK * LD;
    const bf16* sV = sK + NP * BK * LD;

    // S = Q K^T and dP = dO V^T: bf16 products are exact in fp32, one pass
    // each; fp32 S the planes' six passes, each k-step's into a fresh
    // fragment, and dP three (oh.v0, ol.v0, oh.v1)
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t aq[NP][4], ao[NV][4];
#pragma unroll
      for (int p = 0; p < NP; ++p)
        rt::ldmatrix_x4(aq[p], sQ + p * BQ * LD + tc_a_off(rb, kk * 16, LD));
#pragma unroll
      for (int p = 0; p < NV; ++p)
        rt::ldmatrix_x4(ao[p], sO + p * BQ * LD + tc_a_off(rb, kk * 16, LD));
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        const int off = tc_bnk_off(n * 8, kk * 16, LD);
        uint32_t bk[NP][4], bv[NV][4];
#pragma unroll
        for (int p = 0; p < NP; ++p)
          rt::ldmatrix_x4(bk[p], sK + p * BK * LD + off);
#pragma unroll
        for (int p = 0; p < NV; ++p)
          rt::ldmatrix_x4(bv[p], sV + p * BK * LD + off);
        if constexpr (NP == 1) {
          mma_planes<NP>(s[n], s[n + 1], aq, bk);
          rt::mma_bf16(dp[n], ao[0], bv[0][0], bv[0][1]);
          rt::mma_bf16(dp[n + 1], ao[0], bv[0][2], bv[0][3]);
        } else {
          float f[2][4] = {};
          mma_planes<NP>(f[0], f[1], aq, bk);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[n][e] += f[0][e];
            s[n + 1][e] += f[1][e];
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            rt::mma_bf16(dp[n + h], ao[0], bv[0][2 * h], bv[0][2 * h + 1]);
            rt::mma_bf16(dp[n + h], ao[1], bv[0][2 * h], bv[0][2 * h + 1]);
            rt::mma_bf16(dp[n + h], ao[0], bv[1][2 * h], bv[1][2 * h + 1]);
          }
        }
      }
    }
    // dS into dp: P in base 2 (lse2 holds lse times log2(e)), exact zeros
    // where masked
    const int k0 = j * BK;
    const bool whole = tc_tile_whole(q0, qb, k0, k0 + BK - 1, Skv, causal,
                                     window, kv_len);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x2, chain = 1.f;
        if (softcap != 0.f) {
          const float x = tanhf(s[n][e] * scale / softcap) * softcap;
          const float uu = x / softcap;
          chain = 1.f - uu * uu;  // d softcap / d s_raw
          x2 = x * kLog2e - lse2[r];
        } else {
          x2 = fmaf(s[n][e], scale2, -lse2[r]);
        }
        float p = exp2f(x2);
        if (!whole) {  // uniform over the block
          const int qp = q0 + rb + g + 8 * r;
          const int kp = k0 + n * 8 + 2 * t + (e & 1);
          if (!fa_keep(qp, kp, causal, window, kv_len)) p = 0.f;
        }
        dp[n][e] = p * (dp[n][e] - dlt[r]) * chain * scale;
      }

    // dQ += dS K with dS = dS hi + dS lo: two passes against a bf16 K
    // (exact); three against K's planes (sh.k0, sl.k0, sh.k1)
    if constexpr (NP == 1) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t sh[4], sl[4];
        tc_c_to_a(dp, kk, sh, sl);
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          uint32_t b[4];
          rt::ldmatrix_x4_trans(b, sK + tc_bkn_off(kk * 16, d0 + n * 8, LD));
          rt::mma_bf16(acc[n], sh, b[0], b[1]);
          rt::mma_bf16(acc[n], sl, b[0], b[1]);
          rt::mma_bf16(acc[n + 1], sh, b[2], b[3]);
          rt::mma_bf16(acc[n + 1], sl, b[2], b[3]);
        }
      }
    } else {
      uint32_t sh[BK / 16][4], sl[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) tc_c_to_a(dp, kk, sh[kk], sl[kk]);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        float f[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          uint32_t b[NV][4];
#pragma unroll
          for (int p = 0; p < NV; ++p)
            rt::ldmatrix_x4_trans(
                b[p], sK + p * BK * LD + tc_bkn_off(kk * 16, d0 + n * 8, LD));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            rt::mma_bf16(f[h], sh[kk], b[0][2 * h], b[0][2 * h + 1]);
            rt::mma_bf16(f[h], sl[kk], b[0][2 * h], b[0][2 * h + 1]);
            rt::mma_bf16(f[h], sh[kk], b[1][2 * h], b[1][2 * h + 1]);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[n][e] += f[0][e];
          acc[n + 1][e] += f[1][e];
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before its reload
    stage ^= 1;
    j = jn;
  }
  rt::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rb + g + 8 * r;
    if (row < Sq) {
      float* dqg = dq + (bh * Sq + row) * HD + d0;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<float2*>(dqg + n * 8 + 2 * t) =
            make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
}

struct FaArgs {
  const void *q, *k, *v, *dout, *lse_in, *delta;
  void *o, *lse, *dq, *dk, *dv;
  void* planes;  // fp32 q, k, v: the scratch of their planes
  int* turns;    // the fused backward's, one per (bh, q tile)
  int BH, Sq, Skv, group, causal, window, kv_len;
  float softcap, scale;
  cudaStream_t stream;
};

// the tensor-core kernels and the split copy 16 B at a time: their tensors
// must be so aligned
bool tc_aligned(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// bf16 elements of the planes of fp32 q (nq elements) and k, v (nkv each)
long long plane_elems(long long nq, long long nkv) {
  return kQkPlanes * (nq + nkv) + kVPlanes * nkv;
}

// fp32 q, k, v into their planes in a.planes (q's, then k's, then v's),
// which a then points at in their place
cudaError_t split_qkv(FaArgs& a, int hd) {
  if (!a.planes) return cudaErrorInvalidValue;
  const long long nq = (long long)a.BH * a.Sq * hd;
  const long long nkv = (long long)(a.BH / a.group) * a.Skv * hd;
  bf16* pq = static_cast<bf16*>(a.planes);
  bf16* pk = pq + kQkPlanes * nq;
  bf16* pv = pk + kQkPlanes * nkv;
  const FaSplitQkv s{{{(const float*)a.q, pq, nq, kQkPlanes},
                      {(const float*)a.k, pk, nkv, kQkPlanes},
                      {(const float*)a.v, pv, nkv, kVPlanes}}};
  a.q = pq;
  a.k = pk;
  a.v = pv;
  return fa_split(s, a.stream);
}

template <typename T, int HD>
cudaError_t launch_fwd(FaArgs a) {
  constexpr int NP = planes_of<T>;
  using C = TcFwd<HD, NP>;
  if (!tc_aligned({a.q, a.k, a.v, a.planes}))
    return cudaErrorMisalignedAddress;
  cudaError_t err;
  if constexpr (NP > 1) {
    if ((err = split_qkv(a, HD)) != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(fa_fwd_tc_kernel<HD, NP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.BH, (a.Sq + C::BQ - 1) / C::BQ);
  fa_fwd_tc_kernel<HD, NP><<<grid, C::THREADS, C::SMEM, a.stream>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v, (float*)a.o,
      (float*)a.lse, a.Sq, a.Skv, a.group, a.causal, a.window, a.softcap,
      a.scale, a.kv_len);
  return cudaGetLastError();
}

// the backward kernels: the fused one, and the two sweeps of the split one
enum BwdKind { kFused, kDq, kDkv };

template <typename T, int HD, BwdKind KIND>
cudaError_t launch_bwd(FaArgs a) {
  constexpr int NP = planes_of<T>;
  if (!tc_aligned({a.q, a.k, a.v, a.dout, a.planes}))
    return cudaErrorMisalignedAddress;
  cudaError_t err;
  if constexpr (NP > 1) {
    if ((err = split_qkv(a, HD)) != cudaSuccess) return err;
  }
  if constexpr (KIND == kDq) {
    using C = TcDq<HD, NP>;
    err = cudaFuncSetAttribute(fa_bwd_dq_tc_kernel<HD, NP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)C::SMEM);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.BH, (a.Sq + C::BQ - 1) / C::BQ);
    fa_bwd_dq_tc_kernel<HD, NP><<<grid, C::THREADS, C::SMEM, a.stream>>>(
        (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
        (const typename C::TO*)a.dout, (const float*)a.lse_in,
        (const float*)a.delta, (float*)a.dq, a.Sq, a.Skv, a.group, a.causal,
        a.window, a.softcap, a.scale, a.kv_len);
  } else {
    // the fused backward reads dO in fp32, the dK/dV sweep in q's dtype
    constexpr bool kDQ = KIND == kFused;
    using TO = std::conditional_t<kDQ, float, T>;
    using C = TcBwd<HD, NP>;
    constexpr size_t smem = C::template smem<TO, kDQ>();
    err = cudaFuncSetAttribute(fa_bwd_tc_kernel<HD, TO, kDQ, NP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.BH / a.group, (a.Skv + C::BK - 1) / C::BK);
    fa_bwd_tc_kernel<HD, TO, kDQ, NP><<<grid, C::THREADS, smem, a.stream>>>(
        (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
        (const TO*)a.dout, (const float*)a.lse_in, (const float*)a.delta,
        (float*)a.dq, a.turns, (float*)a.dk, (float*)a.dv, a.Sq, a.Skv,
        a.group, a.causal, a.window, a.softcap, a.scale, a.kv_len);
  }
  return cudaGetLastError();
}

// KIND: -1 the forward, else a BwdKind
template <typename T, int KIND>
cudaError_t launch(const FaArgs& a, int hd) {
  switch (hd) {
#define RT_FA_CASE(HD)                                                  \
    case HD:                                                            \
      if constexpr (KIND < 0) return launch_fwd<T, HD>(a);              \
      else return launch_bwd<T, HD, (BwdKind)KIND>(a);
    RT_FA_CASE(16) RT_FA_CASE(32) RT_FA_CASE(64) RT_FA_CASE(128)
    RT_FA_CASE(256)
#undef RT_FA_CASE
    default: return cudaErrorInvalidValue;
  }
}

// the fused backward's (q tile, kv tile) for one dtype and head dim
// (false: a head dim it does not take)
template <typename T>
bool fused_tiles(int hd, int* bq, int* bk) {
  switch (hd) {
#define RT_FA_CASE(HD)                                                  \
    case HD:                                                            \
      *bq = TcBwd<HD, planes_of<T>>::BQ;                                \
      *bk = TcBwd<HD, planes_of<T>>::BK;                                \
      return true;
    RT_FA_CASE(16) RT_FA_CASE(32) RT_FA_CASE(64) RT_FA_CASE(128)
    RT_FA_CASE(256)
#undef RT_FA_CASE
    default: return false;
  }
}

template <int KIND>
int dispatch(int dtype, int hd, const FaArgs& a) {
  if (dtype == rt::kFloat32) return (int)launch<float, KIND>(a, hd);
  if (dtype == rt::kBFloat16) return (int)launch<__nv_bfloat16, KIND>(a, hd);
  return (int)cudaErrorInvalidValue;
}

FaArgs bwd_args(const void* q, const void* k, const void* v, void* planes,
                const void* dout, const void* lse, const void* delta,
                void* dq, void* dk, void* dv, int BH, int Sq, int Skv,
                int group, int causal, int window, float softcap, float scale,
                int kv_len, void* stream) {
  FaArgs a{};
  a.q = q; a.k = k; a.v = v; a.planes = planes;
  a.dout = dout; a.lse_in = lse; a.delta = delta;
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.BH = BH; a.Sq = Sq; a.Skv = Skv; a.group = group; a.causal = causal;
  a.window = window; a.kv_len = kv_len; a.softcap = softcap; a.scale = scale;
  a.stream = (cudaStream_t)stream;
  return a;
}

// Every kernel instantiation launch() and fa_split() can reach: each head
// dim with bf16 q, k, v (NP 1) and fp32 ones (kQkPlanes, 3 in the names: a
// source with another count fails the tests' and phase 19's lookups of the
// launched names); the fused backward reads dO in fp32, the dK/dV sweep in
// q's dtype.
#define RT_FA_KERNELS(HD)                                                    \
  {"fa_fwd_tc_kernel<" #HD ", 1>", (const void*)fa_fwd_tc_kernel<HD, 1>},    \
  {"fa_fwd_tc_kernel<" #HD ", 3>",                                           \
   (const void*)fa_fwd_tc_kernel<HD, kQkPlanes>},                            \
  {"fa_bwd_dq_tc_kernel<" #HD ", 1>",                                        \
   (const void*)fa_bwd_dq_tc_kernel<HD, 1>},                                 \
  {"fa_bwd_dq_tc_kernel<" #HD ", 3>",                                        \
   (const void*)fa_bwd_dq_tc_kernel<HD, kQkPlanes>},                         \
  {"fa_bwd_tc_kernel<" #HD ", float, true, 1>",                              \
   (const void*)fa_bwd_tc_kernel<HD, float, true, 1>},                       \
  {"fa_bwd_tc_kernel<" #HD ", float, true, 3>",                              \
   (const void*)fa_bwd_tc_kernel<HD, float, true, kQkPlanes>},               \
  {"fa_bwd_tc_kernel<" #HD ", __nv_bfloat16, false, 1>",                     \
   (const void*)fa_bwd_tc_kernel<HD, bf16, false, 1>},                       \
  {"fa_bwd_tc_kernel<" #HD ", float, false, 3>",                             \
   (const void*)fa_bwd_tc_kernel<HD, float, false, kQkPlanes>},
const rt::KernelEntry kKernels[] = {
    {"fa_split_kernel", (const void*)fa_split_kernel},
    RT_FA_KERNELS(16) RT_FA_KERNELS(32) RT_FA_KERNELS(64) RT_FA_KERNELS(128)
    RT_FA_KERNELS(256)};
#undef RT_FA_KERNELS

}  // namespace

RT_KERNEL_TABLE(flash, kKernels)

// the most shared memory a block may opt into (cudaFuncSetAttribute), in
// bytes, on the current device
extern "C" int rt_smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// bf16 elements of the plane scratch that rt_flash_fwd and the backwards
// take for q (nq elements) and k, v (nkv elements each) of a dtype: none
// for bf16
extern "C" long long rt_flash_plane_elems(int dtype, long long nq,
                                          long long nkv) {
  return dtype == rt::kFloat32 ? plane_elems(nq, nkv) : 0;
}

// One fp32 tensor x of n elements (n % 4 == 0, 16-B aligned) into np
// (1-3) bf16 planes, plane p at planes + p n (fa_split_kernel)
extern "C" int rt_flash_split(const void* x, void* planes, long long n,
                              int np, void* stream) {
  if (n % 4 || np < 1 || np > 3) return (int)cudaErrorInvalidValue;
  if (!tc_aligned({x, planes})) return (int)cudaErrorMisalignedAddress;
  const FaSplitQkv s{{{(const float*)x, (bf16*)planes, n, np},
                      {nullptr, nullptr, 0, 0},
                      {nullptr, nullptr, 0, 0}}};
  return (int)fa_split(s, (cudaStream_t)stream);
}

// planes: rt_flash_plane_elems bf16 elements (null for bf16)
extern "C" int rt_flash_fwd(const void* q, const void* k, const void* v,
                            void* planes, void* o, void* lse, int dtype,
                            int BH, int Sq, int Skv, int hd, int group,
                            int causal, int window, float softcap,
                            float scale, int kv_len, void* stream) {
  FaArgs a{};
  a.q = q; a.k = k; a.v = v; a.planes = planes; a.o = o; a.lse = lse;
  a.BH = BH; a.Sq = Sq; a.Skv = Skv; a.group = group; a.causal = causal;
  a.window = window; a.kv_len = kv_len; a.softcap = softcap; a.scale = scale;
  a.stream = (cudaStream_t)stream;
  return dispatch<-1>(dtype, hd, a);
}

// The fused backward's tiles (BQ, BK): its turn counters are one int per
// (bh, q tile), BH x ceil(Sq / BQ).  Nonzero: a dtype or head dim it does
// not take.
extern "C" int rt_flash_bwd_tiles(int dtype, int hd, int* bq, int* bk) {
  const bool ok = dtype == rt::kFloat32    ? fused_tiles<float>(hd, bq, bk)
                  : dtype == rt::kBFloat16 ? fused_tiles<bf16>(hd, bq, bk)
                                           : false;
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

// dq and turns (at least BH x ceil(Sq / BQ) ints) zeroed by the caller:
// the kernel adds each kv tile's dQ into dq in its turn; planes as for
// rt_flash_fwd
extern "C" int rt_flash_bwd(const void* q, const void* k, const void* v,
                            void* planes, const void* dout, const void* lse,
                            const void* delta, void* dq, void* dk, void* dv,
                            void* turns, long long n_turns, int dtype, int BH,
                            int Sq, int Skv, int hd, int group, int causal,
                            int window, float softcap, float scale, int kv_len,
                            void* stream) {
  int bq, bk;
  if (rt_flash_bwd_tiles(dtype, hd, &bq, &bk) != 0 ||
      n_turns < (long long)BH * ((Sq + bq - 1) / bq))
    return (int)cudaErrorInvalidValue;
  FaArgs a = bwd_args(q, k, v, planes, dout, lse, delta, dq, dk, dv, BH, Sq,
                      Skv, group, causal, window, softcap, scale, kv_len,
                      stream);
  a.turns = static_cast<int*>(turns);
  return dispatch<kFused>(dtype, hd, a);
}

// The two sweeps of the split backward: dout in q's dtype; planes as for
// rt_flash_fwd (each sweep splits fp32 q, k, v itself)
extern "C" int rt_flash_bwd_dq(const void* q, const void* k, const void* v,
                               void* planes, const void* dout,
                               const void* lse, const void* delta, void* dq,
                               int dtype, int BH, int Sq, int Skv, int hd,
                               int group, int causal, int window,
                               float softcap, float scale, int kv_len,
                               void* stream) {
  return dispatch<kDq>(dtype, hd,
                       bwd_args(q, k, v, planes, dout, lse, delta, dq,
                                nullptr, nullptr, BH, Sq, Skv, group, causal,
                                window, softcap, scale, kv_len, stream));
}

extern "C" int rt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                void* planes, const void* dout,
                                const void* lse, const void* delta, void* dk,
                                void* dv, int dtype, int BH, int Sq, int Skv,
                                int hd, int group, int causal, int window,
                                float softcap, float scale, int kv_len,
                                void* stream) {
  return dispatch<kDkv>(dtype, hd,
                        bwd_args(q, k, v, planes, dout, lse, delta, nullptr,
                                 dk, dv, BH, Sq, Skv, group, causal, window,
                                 softcap, scale, kv_len, stream));
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
