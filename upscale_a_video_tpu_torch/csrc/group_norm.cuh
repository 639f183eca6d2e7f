// GroupNorm statistics on channels-last (N, rows, C) activations, shared by the
// temporal resblock (csrc/fused_temporal_resblock.cu) and the standalone
// GroupNorm (csrc/fused_groupnorm.cu).
//
// Hopper blocks run in no order, so a sum across blocks is two passes: each
// block writes per-channel partial sums of its rows (the resblock's first
// conv writes them for its output tiles), and one small kernel reduces them
// per (sample, group) in a fixed order (double accumulation), so the result
// does not change from run to run.
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

// part: (B, nblk, C, 2) -> a, d: (B, C) fp32 with scale * GN(x) = x * a + d
// (var = E[x^2] - E[x]^2; gamma/beta fp32 (F32) or bf16). One block per
// (group, sample): the threads take the group's nblk x C/G partials in
// turn, summing in double, then a fixed shared-memory tree adds the
// threads' sums, so the result is the same on every run.
template <bool F32>
__global__ void __launch_bounds__(kThreads)
gn_finalize_kernel(const float* __restrict__ part, const void* __restrict__ gamma,
                   const void* __restrict__ beta, float* __restrict__ a, float* __restrict__ d,
                   int nblk, int C, int groups, float count, float eps, float scale) {
  __shared__ double red[2][kThreads];
  __shared__ float stat[2];
  const int g = blockIdx.x, b = blockIdx.y, cg = C / groups, tid = threadIdx.x;
  const float* pg = part + ((size_t)b * nblk * C + (size_t)g * cg) * 2;
  double s = 0.0, s2 = 0.0;
  for (int i = tid; i < nblk * cg; i += kThreads) {
    const int blk = i / cg;
    const float2 v = *reinterpret_cast<const float2*>(pg + ((size_t)blk * C + (i - blk * cg)) * 2);
    s += v.x;
    s2 += v.y;
  }
  red[0][tid] = s;
  red[1][tid] = s2;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (tid < w) {
      red[0][tid] += red[0][tid + w];
      red[1][tid] += red[1][tid + w];
    }
    __syncthreads();
  }
  if (tid == 0) {
    const float mean = (float)(red[0][0] / count);
    const float var = (float)(red[1][0] / count) - mean * mean;
    stat[0] = mean;
    stat[1] = rsqrtf(var + eps);
  }
  __syncthreads();
  const float mean = stat[0], rstd = stat[1];
  for (int c = g * cg + tid; c < (g + 1) * cg; c += kThreads) {
    const float gm = ldf<F32>(gamma, c);
    a[(size_t)b * C + c] = scale * (rstd * gm);
    d[(size_t)b * C + c] = scale * (ldf<F32>(beta, c) - mean * rstd * gm);
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

// gamma, beta: (C,) fp32 (f32) or bf16. scale is a power of two (exact).
inline cudaError_t launch_gn_finalize(bool f32, const void* part, const void* gamma,
                                      const void* beta, void* a, void* d, int B, int nblk, int C,
                                      int groups, float count, float eps, float scale,
                                      cudaStream_t stream) {
  if (groups < 1 || C % groups != 0) return cudaErrorInvalidValue;
  const dim3 grid(groups, B);
  if (f32)
    gn_finalize_kernel<true><<<grid, kThreads, 0, stream>>>(
        (const float*)part, gamma, beta, (float*)a, (float*)d, nblk, C, groups, count, eps,
        scale);
  else
    gn_finalize_kernel<false><<<grid, kThreads, 0, stream>>>(
        (const float*)part, gamma, beta, (float*)a, (float*)d, nblk, C, groups, count, eps,
        scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace uav
