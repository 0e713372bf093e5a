// Host stand-in for the subset of the CUDA runtime that the port's kernels
// use, so tests can compile src/repro_torch/csrc/*.cu with a C++20 host
// compiler and run the kernels on the CPU: each block runs as blockDim.x
// std::threads sharing one barrier, blocks run one after another.
// __shfl_xor_sync and __syncthreads_or become barrier exchanges, which is
// valid because every kernel calls them with all threads of the block.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
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
inline thread_local float* emu_fslots;
inline thread_local int* emu_islots;
inline thread_local char* emu_dyn;
typedef int cudaError_t;
const int cudaSuccess = 0;
const int cudaErrorInvalidValue = 1;
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
inline void __syncthreads() { emu_bar->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int o) {
  emu_fslots[threadIdx.x] = v;
  __syncthreads();
  const float r = emu_fslots[threadIdx.x ^ o];
  __syncthreads();
  return r;
}
inline int __syncthreads_or(int p) {
  emu_islots[threadIdx.x] = p ? 1 : 0;
  __syncthreads();
  int any = 0;
  for (unsigned i = 0; i < blockDim.x; ++i) any |= emu_islots[i];
  __syncthreads();
  return any;
}
inline float atomicAdd(float* a, float v) {
  return std::atomic_ref<float>(*a).fetch_add(v);
}
inline float fmaxf(float a, float b) { return a > b ? a : b; }
template <class F, class... Args>
void emu_launch(F kern, dim3 grid, dim3 block, size_t smem, cudaStream_t,
                Args... args) {
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::vector<char> dyn(smem + 16);
      std::vector<float> fs(block.x);
      std::vector<int> is(block.x);
      std::barrier<> bar(block.x);
      std::vector<std::thread> ts;
      for (unsigned t = 0; t < block.x; ++t)
        ts.emplace_back([&, t] {
          threadIdx = {t, 0, 0};
          blockIdx = {bx, by, 0};
          blockDim = block;
          gridDim = grid;
          emu_bar = &bar;
          emu_fslots = fs.data();
          emu_islots = is.data();
          emu_dyn = dyn.data();
          kern(args...);
        });
      for (auto& th : ts) th.join();
    }
}
