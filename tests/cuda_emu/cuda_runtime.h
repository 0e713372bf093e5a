// Host stand-in for the subset of the CUDA runtime that the port's kernels
// use, so tests can compile src/repro_torch/csrc/*.cu with a C++20 host
// compiler and run the kernels on the CPU: each block runs as blockDim.x
// std::threads sharing one barrier, blocks run one after another.
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
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
using std::max;
using std::min;
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
inline thread_local uint3 threadIdx, blockIdx;
inline thread_local dim3 blockDim, gridDim;
inline thread_local std::barrier<>* emu_bar;
inline thread_local std::barrier<>* emu_warp_bar;  // this thread's warp
inline thread_local float* emu_fslots;        // 2 sets of 1 per thread
inline thread_local int* emu_islots;
inline thread_local char* emu_dyn;
inline thread_local uint32_t* emu_uslots;     // 2 sets of 6 per thread
inline thread_local const void** emu_pslots;  // 2 sets of 1 per thread
inline thread_local unsigned emu_calls;       // warp-wide exchanges so far
typedef int cudaError_t;
const int cudaSuccess = 0;
const int cudaErrorInvalidValue = 1;
const int cudaErrorMisalignedAddress = 716;
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
inline void __syncthreads() { emu_bar->arrive_and_wait(); }
inline void emu_syncwarp() { emu_warp_bar->arrive_and_wait(); }
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
template <class F, class... Args>
void emu_launch(F kern, dim3 grid, dim3 block, size_t smem, cudaStream_t,
                Args... args) {
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::vector<char> dyn(smem + 16);
      std::vector<float> fs(2 * block.x);
      std::vector<int> is(block.x);
      std::vector<uint32_t> us(2 * 6 * block.x);
      std::vector<const void*> ps(2 * block.x);
      std::barrier<> bar(block.x);
      std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
      for (unsigned w = 0; w < block.x; w += 32)
        warp_bars.push_back(std::make_unique<std::barrier<>>(
            std::min<std::ptrdiff_t>(32, block.x - w)));
      std::vector<std::thread> ts;
      for (unsigned t = 0; t < block.x; ++t)
        ts.emplace_back([&, t] {
          threadIdx = {t, 0, 0};
          blockIdx = {bx, by, 0};
          blockDim = block;
          gridDim = grid;
          emu_bar = &bar;
          emu_warp_bar = warp_bars[t / 32].get();
          emu_fslots = fs.data();
          emu_islots = is.data();
          emu_dyn = dyn.data();
          emu_uslots = us.data();
          emu_pslots = ps.data();
          emu_calls = 0;
          kern(args...);
        });
      for (auto& th : ts) th.join();
    }
}
#include "ptx_emu.h"
