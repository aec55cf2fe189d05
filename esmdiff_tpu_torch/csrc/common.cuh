// Shared by every kernel library of the port: the error-string entry point
// (each .cu is built into its own shared library and includes this once)
// and small bf16 helpers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* esmdiff_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

namespace esmdiff {

// Sum over the 32 lanes of a warp; every lane gets the total.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 16-byte asynchronous copy from device to shared memory (cp.async, L2
// only); both addresses 16-byte aligned.  With `valid` false nothing is
// read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Allows `smem` bytes of dynamic shared memory for `kernel`.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace esmdiff
