// Attention over the T <= 16 frames of each (row, head): out[b, i, h] =
// softmax_j(q[b, i, h] . k[b, j, h] + bias[h, i, j]) @ v[b, :, h], with q
// already scaled and q/k already rotated (RoPE). Scores and softmax in fp32
// with max subtraction; the probabilities are rounded to bf16 before the
// product with v, as the plain bf16 version rounds them.
//
// Replaces upscale_a_video_tpu/ops/fused_temporal_attention.py::
// fused_temporal_attention (Pallas _kernel: 128-row packed score tiles with a
// block-diagonal bias-plus-mask map, a TPU matrix-unit layout). Here the
// attention of one (row, head, query) is one warp's work and needs no mask.
// Bound on this card: bytes (q, k, v read once and out written once; about
// 4 * T operations per element).
//
// Design: one block per row b' of the (B', T, H, D) layout stages that row's
// q, k and v (3 * T * H * D bf16, contiguous in memory) in shared memory with
// 16-byte loads. Warp w then takes the (query frame, head) pairs w, w + 8, ...:
// lanes split D in bf16 pairs, each of the T scores is a warp sum kept in a
// register, and the output pair of each lane is written straight back.
#include "common.cuh"

using namespace uav;

namespace {

constexpr int kMaxT = 16;

__global__ void __launch_bounds__(kThreads)
fta_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           const float* __restrict__ bias, bf16* __restrict__ out, int T, int H, int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t n = (size_t)T * H * D;  // elements of one row of q (a multiple of 8)
  bf16* qs = (bf16*)smem;
  bf16* ks = qs + n;
  bf16* vs = ks + n;
  const size_t base = (size_t)blockIdx.x * n;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;

  const uint4* qg = reinterpret_cast<const uint4*>(q + base);
  const uint4* kg = reinterpret_cast<const uint4*>(k + base);
  const uint4* vg = reinterpret_cast<const uint4*>(v + base);
  for (size_t i = tid; i < n / 8; i += kThreads) {
    reinterpret_cast<uint4*>(qs)[i] = qg[i];
    reinterpret_cast<uint4*>(ks)[i] = kg[i];
    reinterpret_cast<uint4*>(vs)[i] = vg[i];
  }
  __syncthreads();

  const int D2 = D / 2;
  for (int task = warp; task < T * H; task += kWarps) {
    const int i = task / H, h = task - i * H;
    const __nv_bfloat162* qr =
        reinterpret_cast<const __nv_bfloat162*>(qs + ((size_t)i * H + h) * D);
    float sc[kMaxT];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxT; ++j) {
      if (j < T) {
        const __nv_bfloat162* kr =
            reinterpret_cast<const __nv_bfloat162*>(ks + ((size_t)j * H + h) * D);
        float part = 0.f;
        for (int e = lane; e < D2; e += 32) {
          const float2 a = __bfloat1622float2(qr[e]);
          const float2 b = __bfloat1622float2(kr[e]);
          part += a.x * b.x + a.y * b.y;
        }
        sc[j] = warp_sum(part) + (bias ? bias[((size_t)h * T + i) * T + j] : 0.f);
        mx = fmaxf(mx, sc[j]);
      }
    }
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxT; ++j)
      if (j < T) {
        sc[j] = expf(sc[j] - mx);
        l += sc[j];
      }
#pragma unroll
    for (int j = 0; j < kMaxT; ++j)
      if (j < T) sc[j] = round_bf(sc[j] / l);
    __nv_bfloat162* orow = reinterpret_cast<__nv_bfloat162*>(out + base + ((size_t)i * H + h) * D);
    for (int e = lane; e < D2; e += 32) {
      float ox = 0.f, oy = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxT; ++j)
        if (j < T) {
          const float2 vv = __bfloat1622float2(
              reinterpret_cast<const __nv_bfloat162*>(vs + ((size_t)j * H + h) * D)[e]);
          ox += sc[j] * vv.x;
          oy += sc[j] * vv.y;
        }
      orow[e] = __floats2bfloat162_rn(ox, oy);
    }
  }
}

}  // namespace

// q, k, v, out: (Bp, T, H, D) bf16, contiguous, 16-byte aligned; bias: (H, T, T)
// fp32 or null. T <= 16, D % 16 == 0, 3 * T * H * D * 2 bytes of shared memory.
extern "C" int uav_fused_temporal_attention(const void* q, const void* k, const void* v,
                                            const void* bias, void* out, int Bp, int T, int H,
                                            int D, void* stream) {
  const size_t smem = (size_t)3 * T * H * D * 2;
  if (Bp < 1 || T < 1 || T > kMaxT || H < 1 || D < 16 || D % 16 != 0 || smem > 232448)
    return (int)cudaErrorInvalidValue;
  UAV_RETURN_IF(set_smem(fta_kernel, smem));
  fta_kernel<<<Bp, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)bias, (bf16*)out, T, H, D);
  return (int)cudaGetLastError();
}
