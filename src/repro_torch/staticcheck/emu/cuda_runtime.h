// Host stand-in for the subset of the CUDA runtime that the port's kernels
// use, so that src/repro_torch/csrc/*.cu compile with a C++20 host compiler
// (repro_torch/staticcheck/host_build.py) and the kernels run on the CPU,
// for the emulated kernel tests and the kernel analyzer: each block runs as
// blockDim.x
// fibers on the calling thread, which switch only where a lane waits at a
// barrier (emu_next), so no lane waits on the OS scheduler however busy
// the machine is; blocks run one after another.
// __syncthreads_or becomes a block-wide barrier exchange, valid because
// every kernel calls it with all threads of the block; __shfl_xor_sync
// and __shfl_sync (a broadcast from one lane) become warp-wide ones (each
// warp of 32 threads has a barrier of its own), valid because every kernel
// calls them with all lanes of the warp; so do the warp-level tensor-core
// helpers of csrc/tensor_core.cuh (ptx_emu.h).
// A warp-wide exchange posts into one of two slot sets, alternating per
// call, and waits at the warp's barrier once: a lane writes a set again
// only two calls later, after every lane of its warp has passed the
// barrier of the call between, so no lane still reads it.
#pragma once
#include <cxxabi.h>
#include <dlfcn.h>
#include <sys/mman.h>

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#if !defined(__x86_64__)
#include <ucontext.h>
#endif
using std::max;
using std::min;
// The emulator's state and helpers stay inside the library that includes
// them: exported, an inline variable is one object for every library of
// the process (a GNU unique symbol), so a second library loaded beside a
// first would share its mode and records.
#pragma GCC visibility push(hidden)
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
#define __restrict__
#define __shared__ static
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 { unsigned x, y, z; };
// a barrier of `expected` lanes; gen counts the times it has opened
struct EmuBarrier {
  unsigned expected, count = 0, gen = 0;
};
// the running lane's view: emu_launch and emu_next set it
inline thread_local uint3 threadIdx, blockIdx;
inline thread_local dim3 blockDim, gridDim;
inline thread_local EmuBarrier* emu_bar;
inline thread_local EmuBarrier* emu_warp_bar;  // this thread's warp
inline thread_local float* emu_fslots;        // 2 sets of 1 per thread
inline thread_local int* emu_islots;
inline thread_local char* emu_dyn;
inline thread_local uint32_t* emu_uslots;     // 2 sets of 6 per thread
inline thread_local const void** emu_pslots;  // 2 sets of 1 per thread
inline thread_local unsigned emu_calls;       // warp-wide exchanges so far
void emu_yield(bool in_warp);
inline void emu_wait(EmuBarrier* b, bool in_warp) {
  const unsigned gen = b->gen;
  if (++b->count == b->expected) {
    b->count = 0;
    ++b->gen;
    return;
  }
  while (b->gen == gen) emu_yield(in_warp);
}

// What the kernel analyzer reads (the extern "C" functions at the end of
// this file): every launch's kernel, launch site, grid, block, dynamic
// shared memory and the kernel's last cudaFuncSetAttribute(
// MaxDynamicSharedMemorySize) value (-1: never set); every turn awaited or
// handed on (tensor_core.cuh's wait_turn / pass_turn); every misaligned
// cp.async or ldmatrix address.  In record-only mode kernel bodies and
// copies do not run, so the entry points can be called at full shapes with
// fake pointers.  One OS thread runs a launch (its lanes are fibers), so
// the records need no lock.
struct EmuLaunchRec {
  const void* fn;
  const char* site;
  long long dims[6];  // grid x, y, z, block x, y, z
  long long smem, attr;
};
struct EmuTurnRec {
  long long launch, block, pass;  // pass: 1 pass_turn, 0 wait_turn
  const void* ctr;
  long long value, ok;            // ok: the counter read `value` (waits)
};
struct EmuFaultRec {
  long long launch, block, lane, kind;  // kind: EmuFault
  const void* addr;
};
enum EmuFault { kCpAsync16Dst, kCpAsync16Src, kCpAsync4Dst, kCpAsync4Src,
                kLdmatrixRow };
inline std::vector<EmuLaunchRec> emu_launches;
inline std::vector<std::pair<const void*, long long>> emu_attr_set;
inline std::vector<EmuTurnRec> emu_turns;
inline std::vector<EmuFaultRec> emu_faults;  // the first kEmuFaultsKept
inline long long emu_fault_total = 0;
inline int emu_record_only = 0;
inline int emu_turn_abort = 1;  // a wrong turn aborts (else it is logged)
constexpr size_t kEmuFaultsKept = 256;

inline long long emu_attr_of(const void* fn) {
  for (auto it = emu_attr_set.rbegin(); it != emu_attr_set.rend(); ++it)
    if (it->first == fn) return it->second;
  return -1;
}
inline long long emu_block_linear() {
  return (long long)blockIdx.y * gridDim.x + blockIdx.x;
}
inline void emu_fault(int kind, const void* addr) {
  ++emu_fault_total;
  if (emu_faults.size() < kEmuFaultsKept)
    emu_faults.push_back({(long long)emu_launches.size() - 1,
                          emu_block_linear(), (long long)threadIdx.x, kind,
                          addr});
}
inline void emu_check_align(int kind, const void* p, uintptr_t n) {
  if (reinterpret_cast<uintptr_t>(p) % n) emu_fault(kind, p);
}
inline void emu_turn(int pass, const void* ctr, int value, bool ok) {
  emu_turns.push_back({(long long)emu_launches.size() - 1,
                       emu_block_linear(), pass, ctr, value, ok});
}

typedef int cudaError_t;
const int cudaSuccess = 0;
const int cudaErrorInvalidValue = 1;
const int cudaErrorMisalignedAddress = 716;
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
cudaError_t cudaFuncSetAttribute(F f, cudaFuncAttribute, int value) {
  emu_attr_set.push_back({reinterpret_cast<const void*>(f), value});
  return 0;
}
struct cudaFuncAttributes {
  size_t sharedSizeBytes, constSizeBytes, localSizeBytes;
  int maxThreadsPerBlock, numRegs, ptxVersion, binaryVersion, cacheModeCA,
      maxDynamicSharedSizeBytes, preferredShmemCarveout;
};
// the card's compiler output has no host counterpart: zeros, the attribute
// as set, one block an SM
inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a,
                                         const void* fn) {
  *a = {};
  a->maxThreadsPerBlock = 1024;
  a->maxDynamicSharedSizeBytes = (int)std::max(emu_attr_of(fn), 0LL);
  return 0;
}
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, const void*, int, size_t) {
  *n = 1;
  return 0;
}
enum cudaDeviceAttr { cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return 0;
}
// the H100's opt-in limit (232,448 B): the analyzer's budget
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 232448;
  return 0;
}
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n,
                                   cudaStream_t = nullptr) {
  if (!emu_record_only) std::memset(p, v, n);
  return 0;
}
enum cudaMemcpyKind { cudaMemcpyDefault = 4 };
inline cudaError_t cudaMemcpyAsync(void* d, const void* s, size_t n,
                                   cudaMemcpyKind, cudaStream_t = nullptr) {
  if (!emu_record_only) std::memcpy(d, s, n);
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
inline void __syncthreads() { emu_wait(emu_bar, false); }
inline void emu_syncwarp() { emu_wait(emu_warp_bar, true); }
// the first slot of this call's set, in slots of one thread's width
inline unsigned emu_set() { return (emu_calls++ & 1u) * blockDim.x; }
inline float __shfl_xor_sync(unsigned, float v, int o) {
  float* s = emu_fslots + emu_set();
  s[threadIdx.x] = v;
  emu_syncwarp();
  return s[threadIdx.x ^ o];
}
inline float __shfl_sync(unsigned, float v, int src) {
  float* s = emu_fslots + emu_set();
  s[threadIdx.x] = v;
  emu_syncwarp();
  return s[(threadIdx.x & ~31u) + (src & 31)];
}
inline int __syncthreads_or(int p) {
  emu_islots[threadIdx.x] = p ? 1 : 0;
  __syncthreads();
  int any = 0;
  for (unsigned i = 0; i < blockDim.x; ++i) any |= emu_islots[i];
  __syncthreads();
  return any;
}
inline float fmaxf(float a, float b) { return a > b ? a : b; }
// L2-only (.cg) loads and stores: plain ones on the host
template <class T> inline T __ldcg(const T* p) { return *p; }
template <class T> inline void __stcg(T* p, T v) { *p = v; }

// Fibers.  x86-64: emu_switch saves the callee-saved registers and the
// SSE / x87 control words on the running stack, stores its stack pointer
// in *save and resumes the stack at load (no system call); elsewhere
// ucontext.
#if defined(__x86_64__)
extern "C" [[gnu::naked, gnu::noipa]] inline void emu_switch(void**,
                                                                void*) {
  asm("pushq %rbp\n pushq %rbx\n pushq %r12\n pushq %r13\n pushq %r14\n"
      " pushq %r15\n subq $8, %rsp\n stmxcsr (%rsp)\n fnstcw 4(%rsp)\n"
      " movq %rsp, (%rdi)\n movq %rsi, %rsp\n ldmxcsr (%rsp)\n"
      " fldcw 4(%rsp)\n addq $8, %rsp\n popq %r15\n popq %r14\n"
      " popq %r13\n popq %r12\n popq %rbx\n popq %rbp\n ret");
}
struct EmuContext {
  void* sp;
};
#else
struct EmuContext {
  ucontext_t uc;
};
#endif

struct EmuLane {
  EmuContext ctx;
  unsigned calls;  // emu_calls
  bool done;
};

// the running block: its lanes, their barriers, and the kernel call
struct EmuBlock {
  std::vector<EmuLane> lanes;
  std::vector<EmuBarrier> warp_bars;
  EmuBarrier bar;
  EmuContext host;  // the launching thread, resumed once every lane is done
  unsigned cur, live;
  void (*run)(void*);
  void* call;
};
inline thread_local EmuBlock* emu_blk;

inline void emu_jump(EmuContext* from, EmuContext* to) {
#if defined(__x86_64__)
  emu_switch(&from->sp, to->sp);
#else
  swapcontext(&from->uc, &to->uc);
#endif
}

// Leave the running lane (saving it in `from`) for the next live lane of
// its warp (in_warp) or of the block.  A warp thus runs in lockstep from
// one block barrier to the next while the other warps wait at it: the
// warps drift as far apart as the barriers let them, so a missing block
// barrier shows as a wrong result.
inline void emu_next(EmuContext* from, bool in_warp) {
  EmuBlock* b = emu_blk;
  unsigned n = b->cur;
  b->lanes[n].calls = emu_calls;
  if (b->live == 0) return emu_jump(from, &b->host);
  const unsigned w0 = in_warp ? n & ~31u : 0;
  const unsigned size = in_warp ? b->warp_bars[n / 32].expected
                                : (unsigned)b->lanes.size();
  do n = w0 + (n - w0 + 1) % size; while (b->lanes[n].done);
  if (n == b->cur) {
    std::fprintf(stderr, "emu: lane %u waits at a barrier no other lane "
                 "can reach (block %u, %u)\n", n, blockIdx.x, blockIdx.y);
    std::abort();
  }
  b->cur = n;
  threadIdx = {n, 0, 0};
  emu_warp_bar = &b->warp_bars[n / 32];
  emu_calls = b->lanes[n].calls;
  emu_jump(from, &b->lanes[n].ctx);
}

inline void emu_yield(bool in_warp) {
  emu_next(&emu_blk->lanes[emu_blk->cur].ctx, in_warp);
}

[[noreturn]] inline void emu_lane_main() {
  EmuBlock* b = emu_blk;
  b->run(b->call);
  b->lanes[b->cur].done = true;
  --b->live;
  EmuContext gone;
  emu_next(&gone, false);
  __builtin_unreachable();
}

// The lanes' stacks, kEmuStack bytes each above a guard page: mapped once
// per OS thread and remapped when a launch has more lanes (pages are
// touched only as used).
constexpr size_t kEmuStack = 256 << 10, kEmuGuard = 4096;
inline char* emu_stacks(unsigned lanes) {
  static thread_local char* base = nullptr;
  static thread_local unsigned n = 0;
  constexpr size_t step = kEmuGuard + kEmuStack;
  if (lanes > n) {
    if (base) munmap(base, n * step);
    void* p = mmap(nullptr, lanes * step, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
    if (p == MAP_FAILED) std::abort();
    base = static_cast<char*>(p);
    for (unsigned i = 0; i < lanes; ++i)
      mprotect(base + i * step, kEmuGuard, PROT_NONE);
    n = lanes;
  }
  return base;
}

// a lane's first switch enters emu_lane_main at the top of its stack
inline void emu_start(EmuContext* c, char* stack) {
#if defined(__x86_64__)
  auto* top = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uintptr_t>(stack + kEmuStack) & ~uintptr_t(15));
  uint64_t* sp = top - 9;
  std::memset(sp, 0, 9 * sizeof(uint64_t));
  top[-2] = reinterpret_cast<uint64_t>(&emu_lane_main);  // emu_switch's ret
  uint32_t csr;
  uint16_t cw;
  asm volatile("stmxcsr %0\n fnstcw %1" : "=m"(csr), "=m"(cw));
  std::memcpy(sp, &csr, 4);
  std::memcpy(reinterpret_cast<char*>(sp) + 4, &cw, 2);
  c->sp = sp;
#else
  getcontext(&c->uc);
  c->uc.uc_stack.ss_sp = stack;
  c->uc.uc_stack.ss_size = kEmuStack;
  c->uc.uc_link = nullptr;
  makecontext(&c->uc, emu_lane_main, 0);
#endif
}

// host_build.py rewrites `kern<<<grid, block, smem, stream>>>(args)` into
// emu_launch("file.cu:line", kern, grid, block, smem, stream, args)
template <class F, class... Args>
void emu_launch(const char* site, F kern, dim3 grid, dim3 block, size_t smem,
                cudaStream_t, Args... args) {
  const void* fn = reinterpret_cast<const void*>(kern);
  emu_launches.push_back({fn, site,
                          {grid.x, grid.y, grid.z, block.x, block.y, block.z},
                          (long long)smem, emu_attr_of(fn)});
  if (emu_record_only) return;
  auto call = [&] { kern(args...); };
  EmuBlock b;
  b.run = [](void* c) { (*static_cast<decltype(call)*>(c))(); };
  b.call = &call;
  b.lanes.resize(block.x);
  for (unsigned w = 0; w < block.x; w += 32)
    b.warp_bars.push_back({std::min(32u, block.x - w)});
  std::vector<float> fs(2 * block.x);
  std::vector<int> is(block.x);
  std::vector<uint32_t> us(2 * 6 * block.x);
  std::vector<const void*> ps(2 * block.x);
  char* stacks = emu_stacks(block.x);
  emu_blk = &b;
  blockDim = block;
  gridDim = grid;
  emu_bar = &b.bar;
  emu_fslots = fs.data();
  emu_islots = is.data();
  emu_uslots = us.data();
  emu_pslots = ps.data();
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::vector<char> dyn(smem + 16);
      emu_dyn = dyn.data();
      blockIdx = {bx, by, 0};
      b.bar = {block.x};
      for (unsigned t = 0; t < block.x; ++t) {
        b.lanes[t] = {{}, 0, false};
        emu_start(&b.lanes[t].ctx,
                  stacks + t * (kEmuGuard + kEmuStack) + kEmuGuard);
      }
      b.cur = 0;
      b.live = block.x;
      threadIdx = {0, 0, 0};
      emu_warp_bar = &b.warp_bars[0];
      emu_calls = 0;
      emu_jump(&b.host, &b.lanes[0].ctx);
    }
  emu_blk = nullptr;
}

#pragma GCC visibility pop

// The analyzer's view of the records (host_build.py binds these)
extern "C" {
[[gnu::used]] inline void emu_reset(int record_only, int turn_abort) {
  emu_launches.clear();
  emu_attr_set.clear();
  emu_turns.clear();
  emu_faults.clear();
  emu_fault_total = 0;
  emu_record_only = record_only;
  emu_turn_abort = turn_abort;
}
[[gnu::used]] inline long long emu_launch_count() {
  return (long long)emu_launches.size();
}
// dims[6], smem, attr
[[gnu::used]] inline void emu_launch_get(long long i, long long* out) {
  const EmuLaunchRec& r = emu_launches[i];
  for (int d = 0; d < 6; ++d) out[d] = r.dims[d];
  out[6] = r.smem;
  out[7] = r.attr;
}
[[gnu::used]] inline const char* emu_launch_site(long long i) {
  return emu_launches[i].site;
}
// the kernel's demangled symbol into buf (n bytes); 0, or -1 if unknown
[[gnu::used]] inline int emu_launch_name(long long i, char* buf, int n) {
  Dl_info info;
  if (!dladdr(emu_launches[i].fn, &info) || !info.dli_sname ||
      info.dli_saddr != emu_launches[i].fn)
    return -1;
  int status = 0;
  char* d = abi::__cxa_demangle(info.dli_sname, nullptr, nullptr, &status);
  std::snprintf(buf, n, "%s", status == 0 && d ? d : info.dli_sname);
  std::free(d);
  return 0;
}
[[gnu::used]] inline long long emu_turn_count() {
  return (long long)emu_turns.size();
}
// launch, block, pass, counter address, value, ok
[[gnu::used]] inline void emu_turn_get(long long i, long long* out) {
  const EmuTurnRec& r = emu_turns[i];
  long long v[6] = {r.launch, r.block, r.pass, (long long)r.ctr, r.value,
                    r.ok};
  for (int k = 0; k < 6; ++k) out[k] = v[k];
}
[[gnu::used]] inline long long emu_fault_count() { return emu_fault_total; }
// launch, block, lane, kind, address (of the first kEmuFaultsKept)
[[gnu::used]] inline long long emu_fault_get(long long i, long long* out) {
  if (i >= (long long)emu_faults.size()) return -1;
  const EmuFaultRec& r = emu_faults[i];
  long long v[5] = {r.launch, r.block, r.lane, r.kind, (long long)r.addr};
  for (int k = 0; k < 5; ++k) out[k] = v[k];
  return 0;
}
}

#include "ptx_emu.h"
