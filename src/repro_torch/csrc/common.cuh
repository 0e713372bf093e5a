// Shared helpers for the hand-written Hopper kernels of repro_torch.
//
// Every kernel is exported through a plain C function (no PyTorch headers)
// that launches on the caller's stream and returns cudaGetLastError(); the
// Python wrappers (repro_torch/kernels/*/kernel.py) load the shared library
// with ctypes and raise on a non-zero return.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rt {

// dtype codes shared with the Python side (kernels/build.py::DTYPE_CODES)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// masked-score sentinel of the reference kernels (finite, not -inf)
constexpr float kNegInf = -1e30f;

constexpr int kThreads = 256;  // every kernel: 16 x 16 thread grid

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One kernel instantiation a source can launch, named as the host
// toolchain's demangler names it (without namespace and parameters), so
// that repro_torch.staticcheck matches the launches it records to it.
struct KernelEntry {
  const char* name;
  const void* fn;
};

// What the card makes of kernel k launched with `threads` threads and
// `smem` bytes of dynamic shared memory, after its launch site's
// cudaFuncSetAttribute(MaxDynamicSharedMemorySize, attr) (none when attr <
// 0): out = numRegs, localSizeBytes (spills), sharedSizeBytes (static),
// maxDynamicSharedSizeBytes, maxThreadsPerBlock, blocks an SM.
inline int kernel_attrs(const KernelEntry& k, int threads, long long smem,
                        long long attr, long long* out) {
  cudaError_t err;
  if (attr >= 0 &&
      (err = cudaFuncSetAttribute(k.fn,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)attr)) != cudaSuccess)
    return (int)err;
  cudaFuncAttributes a;
  if ((err = cudaFuncGetAttributes(&a, k.fn)) != cudaSuccess) return (int)err;
  int blocks = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &blocks, k.fn, threads, (size_t)smem)) != cudaSuccess)
    return (int)err;
  const long long v[6] = {a.numRegs, (long long)a.localSizeBytes,
                          (long long)a.sharedSizeBytes,
                          a.maxDynamicSharedSizeBytes, a.maxThreadsPerBlock,
                          blocks};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

}  // namespace rt

// A source's table of kernel instantiations as extern "C" entries
// rt_<prefix>_kernel_count(), rt_<prefix>_kernel_name(i) and
// rt_<prefix>_kernel_attrs(i, threads, smem, attr, out) (rt::kernel_attrs).
// Each source has its own prefix: the three link into one library.
#define RT_KERNEL_TABLE(prefix, table)                                       \
  extern "C" int rt_##prefix##_kernel_count() {                             \
    return (int)(sizeof(table) / sizeof(table[0]));                         \
  }                                                                          \
  extern "C" const char* rt_##prefix##_kernel_name(int i) {                 \
    return table[i].name;                                                    \
  }                                                                          \
  extern "C" int rt_##prefix##_kernel_attrs(int i, int threads,             \
                                            long long smem, long long attr,  \
                                            long long* out) {                \
    return rt::kernel_attrs(table[i], threads, smem, attr, out);             \
  }
