// Shared device helpers for the port's CUDA kernels: bf16 conversions, warp
// reductions, the 256-thread block of the element-wise and reduction passes,
// and the launch-side helpers. The matrix kernels' TMA + wgmma building
// blocks are in hopper.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace uav {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf(float v) { return __bfloat162float(__float2bfloat16(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <class K>
inline cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace uav

#define UAV_RETURN_IF(expr)                 \
  do {                                      \
    cudaError_t _e = (expr);                \
    if (_e != cudaSuccess) return (int)_e;  \
  } while (0)
