// Temporal resblock out = x + conv2(silu(gn2(conv1(silu(gn1(x))) + b1 + temb))) + b2
// with conv1 (k,1,1) and conv2 (3,1,1), in five launches:
//   gn_partials(x)   per-(block, channel) sums of x and x^2
//   gn_finalize      per-(sample, group) mean/rstd, folded into a per-(sample,
//                    channel) affine a1, d1 (fixed summation order: deterministic)
//   K1               h1 = conv1(silu(x*a1 + d1)) + b1 + temb, and the
//                    per-(tile, channel) sums of the rounded h1 and h1^2 for GN2
//   gn_finalize      GN2 affine from those sums (no second read of h1)
//   K2               out = x + conv2(silu(h1*a2 + d2)) + b2
//
// Replaces upscale_a_video_tpu/ops/fused_temporal_resblock.py::
// fused_temporal_resblock (Pallas K1 _k1_kernel and K2 _k2_kernel; there the
// GN statistics of x came from XLA and the GN2 sums were carried in order
// across the sequential grid). Bound on this card: operations (2 * k * C per
// element per conv; at C = 256 and 512 about 60-100x the bytes).
//
// Design: K1 and K2 are the GEMM core of gemm_core.cuh, the implicit GEMM of
// the temporal conv, with the GroupNorm + SiLU prologue: each consumer
// applies silu(bf16(v * a + d)) to its A fragments between the swizzled ring
// and the register-A wgmma, so the normalised activation never reaches
// device memory. Taps outside the clip are skipped by the core's tap range,
// which is SAME zero padding after silu(gn(.)), as the reference pads. TMA
// zero-fills rows past HW, which the prologue turns into silu(d) and the
// epilogue into bias + temb: K1's GN2 sums leave those rows out, not only
// its stores. The sums of a tile are reduced over its warps in shared
// memory in a fixed order and written once per (tile, channel); blocks run
// in no order, so the finalize (group_norm.cuh) reduces them in a second,
// fixed-order pass.
#include "gemm_core.cuh"
#include "group_norm.cuh"

namespace uav {
namespace {

constexpr int kResblockBN = 256;  // the big tile's channels (128 x kResblockBN)

struct GnPrologue {
  const float* a;  // (B, C) fp32, halved: silu(2 (v * a + d)) of the conv's input
  const float* d;
  int C;
  __device__ __forceinline__ void prologue(int b, const float*& av, const float*& dv) const {
    av = a + (size_t)b * C;
    dv = d + (size_t)b * C;
  }
};

// K1: h1 = acc + b1 + temb (bf16), and per-(tile, channel) sums of the rounded
// h1 and h1^2 over the tile's rows inside the frame.
struct K1Epilogue : GnPrologue {
  static constexpr bool kPrologue = true, kGeglu = false;
  static constexpr size_t kSmem = 8 * 256 * 2 * sizeof(float);  // [warp][column][sum, sum sq]
  const bf16* bias;
  const float* temb;  // (B, C) or null
  bf16* out;
  float* part;  // (B, T * m_tiles, C, 2)

  template <int NA>
  __device__ __forceinline__ void operator()(const ConvShape& s, const Tile& tl,
                                             float (&acc)[NA], const Frag& fr,
                                             unsigned char* scratch) const {
    const int b = tl.f / s.T;
    const int r0 = tl.m0 + fr.row;
    const bool in0 = r0 < s.HW, in1 = r0 + 8 < s.HW;
    bf16* ob = out + (size_t)tl.f * s.HW * s.Cout;
    float* red = (float*)scratch;
#pragma unroll
    for (int j = 0; j < NA / 4; ++j) {
      const int tc = fr.col_off + j * 8 + fr.quad;  // column in the tile
      const int col = tl.n0 + tc;
      float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
      if (col < s.Cout) {
        float add0 = to_f(bias[col]), add1 = to_f(bias[col + 1]);
        if (temb) {
          add0 += temb[(size_t)b * s.Cout + col];
          add1 += temb[(size_t)b * s.Cout + col + 1];
        }
        const __nv_bfloat162 h0 =
            __floats2bfloat162_rn(acc[4 * j] + add0, acc[4 * j + 1] + add1);
        const __nv_bfloat162 h1 =
            __floats2bfloat162_rn(acc[4 * j + 2] + add0, acc[4 * j + 3] + add1);
        if (in0) {
          *(__nv_bfloat162*)(ob + (size_t)r0 * s.Cout + col) = h0;
          const float2 v = __bfloat1622float2(h0);
          s0 += v.x;
          s1 += v.y;
          q0 += v.x * v.x;
          q1 += v.y * v.y;
        }
        if (in1) {
          *(__nv_bfloat162*)(ob + (size_t)(r0 + 8) * s.Cout + col) = h1;
          const float2 v = __bfloat1622float2(h1);
          s0 += v.x;
          s1 += v.y;
          q0 += v.x * v.x;
          q1 += v.y * v.y;
        }
      }
      // the lanes of one quad position hold the same two columns: add their rows
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        q0 += __shfl_xor_sync(0xffffffffu, q0, o);
        q1 += __shfl_xor_sync(0xffffffffu, q1, o);
      }
      if (fr.lane < 4)
        *(float4*)(red + ((size_t)fr.slot * 256 + tc) * 2) = make_float4(s0, q0, s1, q1);
    }
    named_bar_sync(1, 256);
    // consumer thread c adds column c over the warps that hold it, in order
    const int c = fr.slot * 32 + fr.lane;
    if (c < fr.bn && tl.n0 + c < s.Cout) {
      const int first = fr.bn == fr.wn ? 0 : (c / fr.wn) * 4;
      const int n = fr.bn == fr.wn ? 8 : 4;
      float sum = 0.f, sq = 0.f;
      for (int w = first; w < first + n; ++w) {
        sum += red[((size_t)w * 256 + c) * 2];
        sq += red[((size_t)w * 256 + c) * 2 + 1];
      }
      const int t = tl.f - b * s.T;
      const size_t p = (size_t)b * s.T * s.m_tiles + (size_t)t * s.m_tiles + tl.m0 / fr.bm;
      float* pp = part + (p * s.Cout + tl.n0 + c) * 2;
      pp[0] = sum;
      pp[1] = sq;
    }
    named_bar_sync(1, 256);  // the next tile's sums reuse red
  }
};

// K2: out = res + acc + b2 (bf16).
struct K2Epilogue : BiasEpilogue, GnPrologue {
  static constexpr bool kPrologue = true;
};

template <class Epi>
int launch_resblock_conv(const void* in, const void* w, int K, int B, int T, int HW, int C,
                         const Epi& epi, cudaStream_t stream) {
  if (small_tiles(B * T, HW, C, kResblockBN))
    return launch_gemm<64, 128>(in, w, B * T, T, HW, C, C, K, epi, stream);
  return launch_gemm<128, kResblockBN>(in, w, B * T, T, HW, C, C, K, epi, stream);
}

}  // namespace
}  // namespace uav

using namespace uav;

// x: (B, rows, C) bf16 -> part: (B, nblk, C, 2) fp32.
extern "C" int uav_gn_partials(const void* x, void* part, int B, int rows, int C, int nblk,
                               void* stream) {
  return (int)launch_gn_partials(false, x, part, B, rows, C, nblk, (cudaStream_t)stream);
}

// part: (B, nblk, C, 2) -> a, d: (B, C) fp32 with GN(x) / 2 = x * a + d, the
// halves the convs' prologue takes (silu_affine2); gamma, beta bf16.
extern "C" int uav_gn_finalize(const void* part, const void* gamma, const void* beta, void* a,
                               void* d, int B, int nblk, int C, int G, float count, float eps,
                               void* stream) {
  return (int)launch_gn_finalize(false, part, gamma, beta, a, d, B, nblk, C, G, count, eps, 0.5f,
                                 (cudaStream_t)stream);
}

// One conv of the resblock, out = conv(silu(2 (in * a + d))) + bias, then
//   K1 (part given): + temb, and the GN2 sums into part (B, T * m_tiles, C, 2);
//   K2 (res given):  + res.
// in, res, out: (B, T, HW, C) bf16, 16-byte aligned; a, d: (B, C) fp32 from
// uav_gn_finalize;
// w: (K, C, C) bf16, tap major, each tap a (Cout, Cin) matrix; bias: (C,)
// bf16; temb: (B, C) fp32 or null. C a multiple of 64. tile_rows is the
// caller's m-tile height (64 or 128, which sizes part); the call is refused
// if it is not the tile this kernel takes.
extern "C" int uav_resblock_conv(const void* in, const void* a, const void* d, const void* w,
                                 int K, const void* bias, const void* temb, const void* res,
                                 void* out, void* part, int B, int T, int HW, int C,
                                 int tile_rows, void* stream) {
  if (B < 1 || T < 1 || HW < 1 || K % 2 != 1 || C % 64 != 0 ||
      (part == nullptr) == (res == nullptr))
    return (int)cudaErrorInvalidValue;
  if (tile_rows != (small_tiles(B * T, HW, C, kResblockBN) ? 64 : 128))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const GnPrologue pro{(const float*)a, (const float*)d, C};
  if (part) {
    const K1Epilogue epi{pro, (const bf16*)bias, (const float*)temb, (bf16*)out, (float*)part};
    return launch_resblock_conv(in, w, K, B, T, HW, C, epi, st);
  }
  const K2Epilogue epi{{(const bf16*)bias, (const bf16*)res, (bf16*)out}, pro};
  return launch_resblock_conv(in, w, K, B, T, HW, C, epi, st);
}
