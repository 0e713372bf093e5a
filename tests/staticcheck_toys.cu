// Toy kernels, each with one fault the kernel analyzer must flag
// (tests/test_torch_staticcheck.py compiles them for the host with
// repro_torch.staticcheck.host_build).
#include "common.cuh"
#include "tensor_core.cuh"

namespace {

// a 16-B cp.async into shared memory 4 B past a 16-B boundary
__global__ void toy_misaligned_kernel(const float* src, float* out) {
  extern __shared__ __align__(16) float buf[];
  rt::cp_async16(buf + 1, src, 16);
  rt::cp_async_commit();
  rt::cp_async_wait<0>();
  __syncthreads();
  out[threadIdx.x] = buf[1 + threadIdx.x % 4];
}

// adds into its output: reads it before any write
__global__ void toy_accumulate_kernel(const float* x, float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] += x[i];
}

// block b takes turn gridDim.x - 1 - b: the last block's turn comes
// first, against the block order the card dispatches in
__global__ void toy_turn_kernel(int* turn, float* out) {
  if (threadIdx.x == 0) {
    const int mine = (int)gridDim.x - 1 - (int)blockIdx.x;
    rt::wait_turn(turn, mine);
    out[blockIdx.x] = (float)mine;
    rt::pass_turn(turn, mine + 1);
  }
}

__global__ void toy_smem_kernel(float* out) {
  extern __shared__ __align__(16) float big[];
  big[threadIdx.x] = (float)threadIdx.x;
  __syncthreads();
  out[threadIdx.x] = big[threadIdx.x];
}

}  // namespace

extern "C" int toy_misaligned(const void* src, void* out, void* stream) {
  toy_misaligned_kernel<<<1, 32, 64, (cudaStream_t)stream>>>(
      (const float*)src, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int toy_accumulate(const void* x, void* out, int n,
                              void* stream) {
  toy_accumulate_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int toy_turns(void* turn, void* out, int blocks, void* stream) {
  toy_turn_kernel<<<blocks, 32, 0, (cudaStream_t)stream>>>((int*)turn,
                                                          (float*)out);
  return (int)cudaGetLastError();
}

// `bytes` of dynamic shared memory, the attribute raised to it when
// set_attr; `threads` a block
extern "C" int toy_smem(void* out, int bytes, int set_attr, int threads,
                        void* stream) {
  if (set_attr)
    cudaFuncSetAttribute(toy_smem_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  toy_smem_kernel<<<1, threads, bytes, (cudaStream_t)stream>>>((float*)out);
  return (int)cudaGetLastError();
}
