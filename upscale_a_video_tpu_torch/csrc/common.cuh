// Shared device helpers for the port's Hopper kernels.
//
// The kernels of the first design are "simple and right" first: one thread
// block (8 warps) per row tile, operands staged in shared memory, products on
// the tensor cores through WMMA 16x16x16 bf16 fragments with fp32
// accumulation, and all normalisation / softmax arithmetic in fp32. Weights
// are read as WMMA operands straight from global memory; every block reads
// the same weights, so after the first blocks they come from L2. The
// redesigned kernels (TMA + wgmma) add hopper.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace uav {

using bf16 = __nv_bfloat16;
namespace wm = nvcuda::wmma;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 to_bf(float v) { return __float2bfloat16(v); }
__device__ __forceinline__ float round_bf(float v) { return __bfloat162float(__float2bfloat16(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Element (k, n) of a K x N operand B.
struct RowMajor {
  using Layout = wm::row_major;
  static __device__ __forceinline__ const bf16* at(const bf16* B, int ldb, int k0, int n0) {
    return B + (size_t)k0 * ldb + n0;
  }
};
struct ColMajor {  // a torch Linear weight (out, in) used as B = W^T
  using Layout = wm::col_major;
  static __device__ __forceinline__ const bf16* at(const bf16* B, int ldb, int k0, int n0) {
    return B + (size_t)n0 * ldb + k0;
  }
};

// C[16*MT x N] = (accumulate ? C : 0) + A[16*MT x K] @ B[K x N].
// A (bf16, row-major, lda) and C (fp32, row-major, ldc) live in shared memory;
// B may be anywhere. N and K are multiples of 16 and every pointer handed to
// a fragment load is 32-byte aligned. The warps take column tiles in turn and
// each keeps MT accumulators, so one B fragment serves MT row tiles.
template <int MT, class BL>
__device__ void block_gemm(const bf16* A, int lda, const bf16* B, int ldb, float* C, int ldc,
                           int N, int K, bool accumulate) {
  const int warp = threadIdx.x / 32;
  for (int nt = warp; nt < N / 16; nt += kWarps) {
    wm::fragment<wm::accumulator, 16, 16, 16, float> acc[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (accumulate)
        wm::load_matrix_sync(acc[m], C + (size_t)m * 16 * ldc + nt * 16, ldc, wm::mem_row_major);
      else
        wm::fill_fragment(acc[m], 0.0f);
    }
    for (int k = 0; k < K; k += 16) {
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, typename BL::Layout> b;
      wm::load_matrix_sync(b, BL::at(B, ldb, k, nt * 16), ldb);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> a;
        wm::load_matrix_sync(a, A + (size_t)m * 16 * lda + k, lda);
        wm::mma_sync(acc[m], a, b, acc[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
      wm::store_matrix_sync(C + (size_t)m * 16 * ldc + nt * 16, acc[m], ldc, wm::mem_row_major);
  }
}

// One warp normalises one row of C values into bf16 (fp32 statistics,
// var = E[x^2] - E[x]^2 as the reference computes it).
__device__ __forceinline__ void warp_layernorm(const bf16* src, bf16* dst, const bf16* g,
                                               const bf16* b, int C, float eps) {
  const int lane = threadIdx.x & 31;
  float s = 0.f, s2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = to_f(src[c]);
    s += v;
    s2 += v * v;
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mu = s / C;
  const float rs = rsqrtf(s2 / C - mu * mu + eps);
  for (int c = lane; c < C; c += 32)
    dst[c] = to_bf((to_f(src[c]) - mu) * rs * to_f(g[c]) + to_f(b[c]));
}

// Bytes of shared memory rounded up so every carved region stays aligned.
__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

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
