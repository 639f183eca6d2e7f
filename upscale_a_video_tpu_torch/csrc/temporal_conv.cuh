// The (k,1,1) temporal convolution on channels-last (B, T, H*W, C) bf16 video
// as k frame-shifted GEMMs: the conv of the temporal resblock
// (csrc/fused_temporal_resblock.cu, both convs with a GroupNorm + SiLU
// prologue). The standalone temporal conv (csrc/temporal_conv.cu) no longer
// uses it: that one is an implicit GEMM on TMA + wgmma, the core the
// resblock is to move to.
//
// Design: one block per (sample, 16 pixels) holds those pixels of all T frames
// (T*16 x Cin bf16) in shared memory, after the optional prologue
// silu(x * a + d). A conv tap shifts by whole frames, i.e. by whole 16-row WMMA
// tiles, so each tap is a product of frame-shifted A tiles with that tap's
// (Cout x Cin) weight; taps that fall outside [0, T) are skipped (SAME-T zero
// padding). Each warp owns 16-column output tiles and keeps one fp32
// accumulator per frame. The epilogue adds the bias (and a per-sample
// embedding and a residual where given), rounds to bf16 and optionally writes
// per-(block, channel) sums of the rounded output for a following GroupNorm.
#pragma once

#include "common.cuh"

namespace uav {
namespace {

constexpr int kConvMaxT = 8;
constexpr int kConvPx = 16;  // pixels per block
constexpr size_t kMaxSmem = 232448;

__global__ void __launch_bounds__(kThreads)
tconv_kernel(const bf16* __restrict__ in, const float* __restrict__ a,
             const float* __restrict__ d, const bf16* __restrict__ w, int K,
             const bf16* __restrict__ bias, const float* __restrict__ temb,
             const bf16* __restrict__ res, bf16* __restrict__ out, float* __restrict__ part,
             int T, int HW, int Cin, int Cout) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = (bf16*)smem;
  float* scratch = (float*)(smem + align128((size_t)T * kConvPx * Cin * 2));

  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x, p0 = blk * kConvPx;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;

  for (int i = tid; i < T * kConvPx * Cin; i += kThreads) {
    const int t = i / (kConvPx * Cin), rem = i - t * kConvPx * Cin, px = rem / Cin,
              c = rem - px * Cin;
    const bf16 v = in[((size_t)(b * T + t) * HW + p0 + px) * Cin + c];
    if (a) {
      float f = to_f(v) * a[(size_t)b * Cin + c] + d[(size_t)b * Cin + c];
      f = f / (1.f + expf(-f));
      xs[i] = to_bf(f);
    } else {
      xs[i] = v;
    }
  }
  __syncthreads();

  const int pad = (K - 1) / 2;
  float* ws = scratch + warp * 256;
  for (int nt = warp; nt < Cout / 16; nt += kWarps) {
    wm::fragment<wm::accumulator, 16, 16, 16, float> acc[kConvMaxT];
#pragma unroll
    for (int t = 0; t < kConvMaxT; ++t) wm::fill_fragment(acc[t], 0.0f);
    for (int i = 0; i < K; ++i) {
      const bf16* wi = w + (size_t)i * Cout * Cin;  // tap i: (Cout, Cin)
      for (int k0 = 0; k0 < Cin; k0 += 16) {
        wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major> bfr;
        wm::load_matrix_sync(bfr, ColMajor::at(wi, Cin, k0, nt * 16), Cin);
#pragma unroll
        for (int t = 0; t < kConvMaxT; ++t) {
          const int src = t + i - pad;
          if (t < T && src >= 0 && src < T) {
            wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> afr;
            wm::load_matrix_sync(afr, xs + (size_t)src * kConvPx * Cin + k0, Cin);
            wm::mma_sync(acc[t], afr, bfr, acc[t]);
          }
        }
      }
    }
    // epilogue: lane owns column (lane % 16) of the tile, rows lane/16 + 2j
    const int col = nt * 16 + (lane & 15);
    const float add = (bias ? to_f(bias[col]) : 0.f) + (temb ? temb[(size_t)b * Cout + col] : 0.f);
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int t = 0; t < kConvMaxT; ++t) {
      if (t < T) {
        wm::store_matrix_sync(ws, acc[t], 16, wm::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int px = e >> 4;
          const size_t off = ((size_t)(b * T + t) * HW + p0 + px) * Cout + col;
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
        float* pp = part + (((size_t)b * nblk + blk) * Cout + col) * 2;
        pp[0] = s;
        pp[1] = s2;
      }
    }
  }
}

inline size_t tconv_smem(int T, int Cin) {
  return align128((size_t)T * kConvPx * Cin * 2) + kWarps * 256 * 4;
}

// in: (B, T, HW, Cin) bf16; a, d: (B, Cin) fp32 or both null (no prologue);
// w: (K, Cout, Cin) bf16, tap major; bias: (Cout,) bf16 or null; temb: (B, Cout)
// fp32 or null; res, out: (B, T, HW, Cout) bf16 (res may be null);
// part: (B, HW/16, Cout, 2) fp32 or null.
inline cudaError_t launch_tconv(const void* in, const void* a, const void* d, const void* w,
                                int K, const void* bias, const void* temb, const void* res,
                                void* out, void* part, int B, int T, int HW, int Cin, int Cout,
                                cudaStream_t stream) {
  if (T > kConvMaxT || T < 1 || HW % kConvPx != 0 || Cin % 16 != 0 || Cout % 16 != 0 ||
      K % 2 != 1 || (a == nullptr) != (d == nullptr) || tconv_smem(T, Cin) > kMaxSmem)
    return cudaErrorInvalidValue;
  const size_t smem = tconv_smem(T, Cin);
  const cudaError_t e = set_smem(tconv_kernel, smem);
  if (e != cudaSuccess) return e;
  tconv_kernel<<<dim3(HW / kConvPx, B), kThreads, smem, stream>>>(
      (const bf16*)in, (const float*)a, (const float*)d, (const bf16*)w, K, (const bf16*)bias,
      (const float*)temb, (const bf16*)res, (bf16*)out, (float*)part, T, HW, Cin, Cout);
  return cudaGetLastError();
}

}  // namespace
}  // namespace uav
