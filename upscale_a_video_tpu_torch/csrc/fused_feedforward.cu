// Transformer feed-forward: LayerNorm -> Dense(C -> 8C) -> GEGLU h * gelu(g)
// (tanh form, as jax.nn.gelu) -> Dense(4C -> C) (+ residual), in three
// launches:
//   ln      hn = bf16(LN(x)), fp32 statistics, one warp per row
//   GEMM1   m = bf16(h * gelu_tanh(g)), h, g = hn @ w1^T + b1 (halves of 8C)
//   GEMM2   out = bf16(m @ w2^T + b2 (+ x))
//
// Replaces upscale_a_video_tpu/ops/fused_feedforward.py::fused_feedforward
// (Pallas _kernel). Bound on this card: operations (24 C^2 per token; at
// C = 512 about 3,000 per byte of x).
//
// Design: both products run on the GEMM core of gemm_core.cuh (TMA ring,
// wgmma, persistent grid), a plain GEMM being its k = 1 conv over one frame
// of M rows. The Pallas kernel keeps the (rows, 8C) intermediate in VMEM; on
// this card a 128-row tile's fp32 output at C >= 512 needs more registers
// than two warpgroups have beside the first product's tile, so the
// intermediate goes through device memory once, as bf16 m (M x 4C), never as
// h and g. GEMM1 loads each B tile as boxes of h rows and of the matching g
// rows of the same w1 (the core's kGeglu), so each thread holds h and g of
// one output column in its own accumulators and its epilogue writes m. The
// weights are torch Linear weights, (N, K) and K-major, which is what the
// core's B map reads; no reorder. Any number of rows: TMA zero-fills the last
// tile and its stores are masked.
#include "gemm_core.cuh"

namespace uav {
namespace {

__device__ __forceinline__ float gelu_tanh(float g) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * g * (1.f + tanh_fast(k * (g + 0.044715f * g * g * g)));
}

// hn = bf16((x - mean) * rstd * w + b), var = E[x^2] - E[x]^2 as the reference;
// one warp per row, 8 bf16 (16 bytes) per lane and step.
__global__ void __launch_bounds__(kThreads)
layernorm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const bf16* __restrict__ b, bf16* __restrict__ hn, int M, int C, float eps) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
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

// GEMM1's epilogue: the tile's columns [n0, n0 + BN) of hn @ w1^T are the
// m columns [n0/2, n0/2 + BN/2), h in the first half of each warpgroup's
// accumulators and g in the second.
struct GegluEpilogue {
  static constexpr bool kPrologue = false, kGeglu = true;
  static constexpr size_t kSmem = 0;
  const bf16* b1;  // (8C,): h's bias, then g's
  bf16* m;         // (M, 4C)

  template <int NA>
  __device__ __forceinline__ void operator()(const ConvShape& s, const Tile& tl,
                                             float (&acc)[NA], const Frag& fr,
                                             unsigned char*) const {
    constexpr int kJ = NA / 8;  // column groups of h, then as many of g
    const int half = s.Cout / 2;
    const int r0 = tl.m0 + fr.row;
    const int mc0 = (tl.n0 + fr.col_off) / 2 + fr.quad;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int mc = mc0 + 8 * j;
      const float2 bh = __bfloat1622float2(*(const __nv_bfloat162*)(b1 + mc));
      const float2 bg = __bfloat1622float2(*(const __nv_bfloat162*)(b1 + half + mc));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (r < s.HW) {
          const float h0 = acc[4 * j + 2 * h] + bh.x, h1 = acc[4 * j + 2 * h + 1] + bh.y;
          const float g0 = acc[4 * (j + kJ) + 2 * h] + bg.x;
          const float g1 = acc[4 * (j + kJ) + 2 * h + 1] + bg.y;
          *(__nv_bfloat162*)(m + (size_t)r * half + mc) =
              __floats2bfloat162_rn(h0 * gelu_tanh(g0), h1 * gelu_tanh(g1));
        }
      }
    }
  }
};

}  // namespace
}  // namespace uav

using namespace uav;

// x, out: (M, C) bf16 token rows; lnw, lnb: (C,); w1: (8C, C) and w2: (C, 4C)
// torch Linear weights; b1: (8C,), b2: (C,); hn: (M, C) and m: (M, 4C) bf16
// scratch. All bf16 and 16-byte aligned; C % 64 == 0.
extern "C" int uav_fused_feedforward(const void* x, const void* lnw, const void* lnb,
                                     const void* w1, const void* b1, const void* w2,
                                     const void* b2, void* hn, void* m, void* out, int M, int C,
                                     float eps, int add_res, void* stream) {
  if (M < 1 || C < 64 || C % 64 != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  layernorm_kernel<<<(M + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      (const bf16*)x, (const bf16*)lnw, (const bf16*)lnb, (bf16*)hn, M, C, eps);
  UAV_RETURN_IF(cudaGetLastError());
  const GegluEpilogue geglu{(const bf16*)b1, (bf16*)m};
  int e = small_tiles(1, M, 8 * C, 256)
              ? launch_gemm<64, 128>(hn, w1, 1, 1, M, C, 8 * C, 1, geglu, st)
              : launch_gemm<128, 256>(hn, w1, 1, 1, M, C, 8 * C, 1, geglu, st);
  if (e) return e;
  const BiasEpilogue proj{(const bf16*)b2, add_res ? (const bf16*)x : nullptr, (bf16*)out};
  return small_tiles(1, M, C, 256) ? launch_gemm<64, 128>(m, w2, 1, 1, M, 4 * C, C, 1, proj, st)
                                   : launch_gemm<128, 256>(m, w2, 1, 1, M, 4 * C, C, 1, proj, st);
}
