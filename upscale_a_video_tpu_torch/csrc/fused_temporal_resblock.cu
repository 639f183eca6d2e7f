// Temporal resblock out = x + conv2(silu(gn2(conv1(silu(gn1(x))) + b1 + temb))) + b2
// with conv1 (k,1,1) and conv2 (3,1,1), in five launches:
//   gn_partials(x)        per-(block, channel) sums of x and x^2
//   gn_finalize           per-(sample, group) mean/rstd, folded into a per-(sample,
//                         channel) affine a, d (fixed summation order: deterministic)
//   temporal_conv K1      h1 = conv1(silu(x*a1 + d1)) + b1 + temb, and the
//                         per-(block, channel) sums of h1 and h1^2 for GN2
//   gn_finalize           GN2 affine from those sums (no second read of h1)
//   temporal_conv K2      out = x + conv2(silu(h1*a2 + d2)) + b2
//
// Replaces upscale_a_video_tpu/ops/fused_temporal_resblock.py::
// fused_temporal_resblock (Pallas K1 _k1_kernel and K2 _k2_kernel; there the
// GN statistics of x came from XLA and the GN2 sums were carried in order
// across the sequential grid). Hopper blocks run in no order, so each block
// writes its own partial sums and a second small kernel reduces them in a
// fixed order. Bound on this card: operations at C = 512 and C = 256
// (2 * k * C per element per conv).
//
// The statistics and finalize kernels live in group_norm.cuh, the conv in
// temporal_conv.cuh (shared with the standalone GroupNorm and temporal conv).
#include "group_norm.cuh"
#include "temporal_conv.cuh"

using namespace uav;

// x: (B, rows, C) bf16 -> part: (B, nblk, C, 2) fp32.
extern "C" int uav_gn_partials(const void* x, void* part, int B, int rows, int C, int nblk,
                               void* stream) {
  return (int)launch_gn_partials(false, x, part, B, rows, C, nblk, (cudaStream_t)stream);
}

// part: (B, nblk, C, 2) -> a, d: (B, C) fp32 with GN(x) = x * a + d; gamma, beta bf16.
extern "C" int uav_gn_finalize(const void* part, const void* gamma, const void* beta, void* a,
                               void* d, int B, int nblk, int C, int G, float count, float eps,
                               void* stream) {
  return (int)launch_gn_finalize(false, part, gamma, beta, a, d, B, nblk, C, G, count, eps,
                                 (cudaStream_t)stream);
}

// in, res, out: (B, T, HW, C) bf16; a, d: (B, C) fp32; w: (K, C, C) bf16, tap
// major, each tap a (Cout, Cin) matrix; bias: (C,) bf16; temb: (B, C) fp32 or
// null; res: residual or null; part: (B, HW/16, C, 2) fp32 or null.
extern "C" int uav_temporal_conv(const void* in, const void* a, const void* d, const void* w,
                                 int K, const void* bias, const void* temb, const void* res,
                                 void* out, void* part, int B, int T, int HW, int C,
                                 void* stream) {
  return (int)launch_tconv(in, a, d, w, K, bias, temb, res, out, part, B, T, HW, C, C,
                           (cudaStream_t)stream);
}
