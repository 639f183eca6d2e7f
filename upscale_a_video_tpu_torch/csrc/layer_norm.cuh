// LayerNorm of one bf16 token row into bf16, the first pass of the
// feed-forward (fused_feedforward.cu) and of the temporal attention block
// (temporal_attention_block.cu): hn = bf16((x - mean) * rstd * w + b) with
// fp32 statistics, var = E[x^2] - E[x]^2 as the reference computes it. One
// warp per row, 8 bf16 (16 bytes) per lane and step; C % 8 == 0.
#pragma once

#include "hopper.cuh"

namespace uav {
namespace {

__device__ __forceinline__ void layernorm_row(const bf16* __restrict__ x,
                                              const bf16* __restrict__ w,
                                              const bf16* __restrict__ b, bf16* __restrict__ hn,
                                              int row, int C, float eps) {
  const int lane = threadIdx.x % 32;
  const uint4* xr = (const uint4*)(x + (size_t)row * C);
  uint4* hr = (uint4*)(hn + (size_t)row * C);
  float s = 0.f, s2 = 0.f;
  for (int v = lane; v < C / 8; v += 32) {
    const uint4 u = xr[v];
    const uint32_t p[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = unpack_bf16(p[i]);
      s += f.x + f.y;
      s2 += f.x * f.x + f.y * f.y;
    }
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mu = s / C;
  const float rs = rsqrtf(s2 / C - mu * mu + eps);
  for (int v = lane; v < C / 8; v += 32) {
    const uint4 u = xr[v], wu = ((const uint4*)w)[v], bu = ((const uint4*)b)[v];
    const uint32_t p[4] = {u.x, u.y, u.z, u.w}, pw[4] = {wu.x, wu.y, wu.z, wu.w},
                   pb[4] = {bu.x, bu.y, bu.z, bu.w};
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = unpack_bf16(p[i]), fw = unpack_bf16(pw[i]), fb = unpack_bf16(pb[i]);
      o[i] = pack_bf16((f.x - mu) * rs * fw.x + fb.x, (f.y - mu) * rs * fw.y + fb.y);
    }
    hr[v] = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

}  // namespace
}  // namespace uav
