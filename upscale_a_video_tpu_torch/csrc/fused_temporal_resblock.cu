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
// Design of temporal_conv: one block per (sample, 16 pixels) holds those
// pixels of all T frames, normalised and activated, in shared memory
// (T*16 x C bf16). A conv tap shifts by whole frames, i.e. by whole 16-row
// WMMA tiles, so each tap is a product of frame-shifted A tiles with that
// tap's (C x C) weight; taps that fall outside [0, T) are skipped.
#include "common.cuh"

using namespace uav;

namespace {

constexpr int kMaxT = 8;
constexpr int PX = 16;  // pixels per block

__global__ void __launch_bounds__(kThreads)
gn_partials_kernel(const bf16* __restrict__ x, float* __restrict__ part, int rows, int C,
                   int rows_per_block) {
  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const int r0 = blk * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  const bf16* xb = x + (size_t)b * rows * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s = 0.f, s2 = 0.f;
    for (int r = r0; r < r1; ++r) {
      const float v = to_f(xb[(size_t)r * C + c]);
      s += v;
      s2 += v * v;
    }
    float* pp = part + (((size_t)b * nblk + blk) * C + c) * 2;
    pp[0] = s;
    pp[1] = s2;
  }
}

__global__ void gn_finalize_kernel(const float* __restrict__ part, const bf16* __restrict__ gamma,
                                   const bf16* __restrict__ beta, float* __restrict__ a,
                                   float* __restrict__ d, int nblk, int C, int G, float count,
                                   float eps) {
  const int b = blockIdx.x, cg = C / G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
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
      const float gm = to_f(gamma[c]);
      a[(size_t)b * C + c] = rstd * gm;
      d[(size_t)b * C + c] = to_f(beta[c]) - mean * rstd * gm;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
tconv_kernel(const bf16* __restrict__ in, const float* __restrict__ a, const float* __restrict__ d,
             const bf16* __restrict__ w, int K, const bf16* __restrict__ bias,
             const float* __restrict__ temb, const bf16* __restrict__ res, bf16* __restrict__ out,
             float* __restrict__ part, int T, int HW, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = (bf16*)smem;
  float* scratch = (float*)(smem + align128((size_t)T * PX * C * 2));

  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x, p0 = blk * PX;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const float* ab = a + (size_t)b * C;
  const float* db = d + (size_t)b * C;

  for (int i = tid; i < T * PX * C; i += kThreads) {
    const int t = i / (PX * C), rem = i - t * PX * C, px = rem / C, c = rem - px * C;
    float v = to_f(in[((size_t)(b * T + t) * HW + p0 + px) * C + c]) * ab[c] + db[c];
    v = v / (1.f + expf(-v));
    xs[i] = to_bf(v);
  }
  __syncthreads();

  const int pad = (K - 1) / 2;
  float* ws = scratch + warp * 256;
  for (int nt = warp; nt < C / 16; nt += kWarps) {
    wm::fragment<wm::accumulator, 16, 16, 16, float> acc[kMaxT];
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) wm::fill_fragment(acc[t], 0.0f);
    for (int i = 0; i < K; ++i) {
      const bf16* wi = w + (size_t)i * C * C;  // tap i: (Cout, Cin)
      for (int k0 = 0; k0 < C; k0 += 16) {
        wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major> bfr;
        wm::load_matrix_sync(bfr, ColMajor::at(wi, C, k0, nt * 16), C);
#pragma unroll
        for (int t = 0; t < kMaxT; ++t) {
          const int src = t + i - pad;
          if (t < T && src >= 0 && src < T) {
            wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> afr;
            wm::load_matrix_sync(afr, xs + (size_t)src * PX * C + k0, C);
            wm::mma_sync(acc[t], afr, bfr, acc[t]);
          }
        }
      }
    }
    // epilogue: lane owns column (lane % 16) of the tile, rows lane/16 + 2j
    const int col = nt * 16 + (lane & 15);
    const float add = to_f(bias[col]) + (temb ? temb[(size_t)b * C + col] : 0.f);
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      if (t < T) {
        wm::store_matrix_sync(ws, acc[t], 16, wm::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int px = e >> 4;
          const size_t off = ((size_t)(b * T + t) * HW + p0 + px) * C + col;
          float v = ws[e] + add;
          if (res) v += to_f(res[off]);
          const bf16 vb = to_bf(v);
          out[off] = vb;
          const float vr = to_f(vb);
          s += vr;
          s2 += vr * vr;
        }
        __syncwarp();
      }
    }
    if (part) {
      s += __shfl_down_sync(0xffffffffu, s, 16);
      s2 += __shfl_down_sync(0xffffffffu, s2, 16);
      if (lane < 16) {
        float* pp = part + (((size_t)b * nblk + blk) * C + col) * 2;
        pp[0] = s;
        pp[1] = s2;
      }
    }
  }
}

}  // namespace

// x: (B, rows, C) bf16 -> part: (B, nblk, C, 2) fp32.
extern "C" int uav_gn_partials(const void* x, void* part, int B, int rows, int C, int nblk,
                               void* stream) {
  const int rpb = (rows + nblk - 1) / nblk;
  gn_partials_kernel<<<dim3(nblk, B), kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (float*)part, rows, C, rpb);
  return (int)cudaGetLastError();
}

// part: (B, nblk, C, 2) -> a, d: (B, C) fp32 with GN(x) = x * a + d.
extern "C" int uav_gn_finalize(const void* part, const void* gamma, const void* beta, void* a,
                               void* d, int B, int nblk, int C, int G, float count, float eps,
                               void* stream) {
  if (C % G != 0) return (int)cudaErrorInvalidValue;
  gn_finalize_kernel<<<B, 128, 0, (cudaStream_t)stream>>>(
      (const float*)part, (const bf16*)gamma, (const bf16*)beta, (float*)a, (float*)d, nblk, C,
      G, count, eps);
  return (int)cudaGetLastError();
}

// in, res, out: (B, T, HW, C) bf16; a, d: (B, C) fp32; w: (K, C, C) bf16, tap
// major, each tap a (Cout, Cin) matrix; bias: (C,) bf16; temb: (B, C) fp32 or
// null; res: residual or null; part: (B, HW/16, C, 2) fp32 or null.
extern "C" int uav_temporal_conv(const void* in, const void* a, const void* d, const void* w,
                                 int K, const void* bias, const void* temb, const void* res,
                                 void* out, void* part, int B, int T, int HW, int C,
                                 void* stream) {
  if (T > kMaxT || T < 1 || HW % PX != 0 || C % 16 != 0 || K % 2 != 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = align128((size_t)T * PX * C * 2) + kWarps * 256 * 4;
  UAV_RETURN_IF(set_smem(tconv_kernel, smem));
  tconv_kernel<<<dim3(HW / PX, B), kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)in, (const float*)a, (const float*)d, (const bf16*)w, K, (const bf16*)bias,
      (const float*)temb, (const bf16*)res, (bf16*)out, (float*)part, T, HW, C);
  return (int)cudaGetLastError();
}
