// GroupNorm statistics on channels-last (N, rows, C) activations, shared by the
// temporal resblock (csrc/fused_temporal_resblock.cu) and the standalone
// GroupNorm (csrc/fused_groupnorm.cu).
//
// Hopper blocks run in no order, so a sum across blocks is two passes: each
// block writes per-channel partial sums of its rows, and one small kernel
// reduces them per (sample, group) in a fixed order (double accumulation), so
// the result does not change from run to run.
#pragma once

#include "common.cuh"

namespace uav {
namespace {

// Element i of an fp32 (F32) or bf16 array. The kernels take untyped pointers
// and a flag rather than an element type as template argument.
template <bool F32>
__device__ __forceinline__ float ldf(const void* p, size_t i) {
  if constexpr (F32)
    return static_cast<const float*>(p)[i];
  else
    return __bfloat162float(static_cast<const bf16*>(p)[i]);
}

// part[b, blk, c] = (sum x, sum x^2) over rows [blk*rpb, (blk+1)*rpb) of sample b.
// The threads split the channels; where C divides the block, the spare threads
// take every (kThreads/C)-th row and their sums are added in a fixed order.
template <bool F32>
__global__ void __launch_bounds__(kThreads)
gn_partials_kernel(const void* __restrict__ x, float* __restrict__ part, int rows, int C,
                   int rows_per_block) {
  __shared__ float red[2][kThreads];
  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x, tid = threadIdx.x;
  const int r0 = blk * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  const size_t xb = (size_t)b * rows * C;
  float* pb = part + ((size_t)b * nblk + blk) * C * 2;
  const int phases = (C < kThreads && kThreads % C == 0) ? kThreads / C : 1;
  if (phases == 1) {
    for (int c = tid; c < C; c += kThreads) {
      float s = 0.f, s2 = 0.f;
#pragma unroll 4
      for (int r = r0; r < r1; ++r) {
        const float v = ldf<F32>(x, xb + (size_t)r * C + c);
        s += v;
        s2 += v * v;
      }
      pb[2 * c] = s;
      pb[2 * c + 1] = s2;
    }
    return;
  }
  const int c = tid % C, ph = tid / C;
  float s = 0.f, s2 = 0.f;
#pragma unroll 4
  for (int r = r0 + ph; r < r1; r += phases) {
    const float v = ldf<F32>(x, xb + (size_t)r * C + c);
    s += v;
    s2 += v * v;
  }
  red[0][tid] = s;
  red[1][tid] = s2;
  __syncthreads();
  if (tid < C) {
    float a = 0.f, a2 = 0.f;
    for (int p = 0; p < phases; ++p) {
      a += red[0][p * C + tid];
      a2 += red[1][p * C + tid];
    }
    pb[2 * tid] = a;
    pb[2 * tid + 1] = a2;
  }
}

// part: (B, nblk, C, 2) -> a, d: (B, C) fp32 with GN(x) = x * a + d
// (var = E[x^2] - E[x]^2; gamma/beta fp32 (F32) or bf16).
template <bool F32>
__global__ void gn_finalize_kernel(const float* __restrict__ part, const void* __restrict__ gamma,
                                   const void* __restrict__ beta, float* __restrict__ a,
                                   float* __restrict__ d, int nblk, int C, int groups,
                                   float count, float eps) {
  const int b = blockIdx.x, cg = C / groups;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    double s = 0.0, s2 = 0.0;
    for (int blk = 0; blk < nblk; ++blk) {
      const float* pp = part + (((size_t)b * nblk + blk) * C + g * cg) * 2;
      for (int c = 0; c < cg; ++c) {
        s += pp[2 * c];
        s2 += pp[2 * c + 1];
      }
    }
    const float mean = (float)(s / count);
    const float var = (float)(s2 / count) - mean * mean;
    const float rstd = rsqrtf(var + eps);
    for (int c = g * cg; c < (g + 1) * cg; ++c) {
      const float gm = ldf<F32>(gamma, c);
      a[(size_t)b * C + c] = rstd * gm;
      d[(size_t)b * C + c] = ldf<F32>(beta, c) - mean * rstd * gm;
    }
  }
}

// x: (B, rows, C) fp32 (f32) or bf16 -> part: (B, nblk, C, 2) fp32.
inline cudaError_t launch_gn_partials(bool f32, const void* x, void* part, int B, int rows,
                                      int C, int nblk, cudaStream_t stream) {
  const int rpb = (rows + nblk - 1) / nblk;
  const dim3 grid(nblk, B);
  if (f32)
    gn_partials_kernel<true><<<grid, kThreads, 0, stream>>>(x, (float*)part, rows, C, rpb);
  else
    gn_partials_kernel<false><<<grid, kThreads, 0, stream>>>(x, (float*)part, rows, C, rpb);
  return cudaGetLastError();
}

// gamma, beta: (C,) fp32 (f32) or bf16.
inline cudaError_t launch_gn_finalize(bool f32, const void* part, const void* gamma,
                                      const void* beta, void* a, void* d, int B, int nblk, int C,
                                      int groups, float count, float eps, cudaStream_t stream) {
  if (groups < 1 || C % groups != 0) return cudaErrorInvalidValue;
  if (f32)
    gn_finalize_kernel<true><<<B, 128, 0, stream>>>((const float*)part, gamma, beta, (float*)a,
                                                     (float*)d, nblk, C, groups, count, eps);
  else
    gn_finalize_kernel<false><<<B, 128, 0, stream>>>((const float*)part, gamma, beta, (float*)a,
                                                      (float*)d, nblk, C, groups, count, eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace uav
