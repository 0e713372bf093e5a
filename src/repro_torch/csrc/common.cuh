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

// reductions over the 16 lanes that share a row (lanes 0-15 or 16-31)
__device__ __forceinline__ float row_max16(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace rt
