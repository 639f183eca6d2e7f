// Transformer feed-forward in one pass: LayerNorm -> Dense(C -> 8C) ->
// GEGLU h * gelu(g) (tanh form, as jax.nn.gelu) -> Dense(4C -> C) (+ residual).
//
// Replaces upscale_a_video_tpu/ops/fused_feedforward.py::fused_feedforward
// (Pallas _kernel): the tokens are read once and written once; the (rows, 8C)
// intermediate never reaches device memory. Bound on this card: operations
// (24 C^2 per token).
//
// Design: one block per 16*MT token rows (32 rows at C <= 512, 16 at
// C = 1024). LN(x) (bf16) and the fp32 (rows x C) output accumulator stay in
// shared memory; the hidden dimension is walked in 128-wide chunks: h and g
// chunks by WMMA, GEGLU in fp32, the bf16 product chunk multiplied straight
// into the accumulator.
#include "common.cuh"

using namespace uav;

namespace {

constexpr int HC = 128;

template <int MT>
size_t ff_smem(int C) {
  const int R = 16 * MT;
  return align128((size_t)R * C * 2) + align128((size_t)R * C * 4) +
         2 * align128((size_t)R * HC * 4) + align128((size_t)R * HC * 2);
}

__device__ __forceinline__ float gelu_tanh(float g) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * g * (1.f + tanhf(k * (g + 0.044715f * g * g * g)));
}

template <int MT>
__global__ void __launch_bounds__(kThreads)
ff_kernel(const bf16* __restrict__ x, const bf16* __restrict__ lnw, const bf16* __restrict__ lnb,
          const bf16* __restrict__ w1, const bf16* __restrict__ b1, const bf16* __restrict__ w2,
          const bf16* __restrict__ b2, bf16* __restrict__ out, int C, float eps, int add_res) {
  constexpr int R = 16 * MT;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  bf16* hn_s = (bf16*)p;    p += align128((size_t)R * C * 2);
  float* acc_s = (float*)p; p += align128((size_t)R * C * 4);
  float* h_s = (float*)p;   p += align128((size_t)R * HC * 4);
  float* g_s = (float*)p;   p += align128((size_t)R * HC * 4);
  bf16* m_s = (bf16*)p;

  const int tid = threadIdx.x, warp = tid / 32;
  const bf16* xb = x + (size_t)blockIdx.x * R * C;
  const int hid = 4 * C;

  for (int row = warp; row < R; row += kWarps)
    warp_layernorm(xb + (size_t)row * C, hn_s + (size_t)row * C, lnw, lnb, C, eps);
  __syncthreads();

  for (int n0 = 0; n0 < hid; n0 += HC) {
    block_gemm<MT, ColMajor>(hn_s, C, w1 + (size_t)n0 * C, C, h_s, HC, HC, C, false);
    block_gemm<MT, ColMajor>(hn_s, C, w1 + (size_t)(hid + n0) * C, C, g_s, HC, HC, C, false);
    __syncthreads();
    for (int i = tid; i < R * HC; i += kThreads) {
      const int j = i % HC;
      const float hv = h_s[i] + to_f(b1[n0 + j]);
      const float gv = g_s[i] + to_f(b1[hid + n0 + j]);
      m_s[i] = to_bf(hv * gelu_tanh(gv));
    }
    __syncthreads();
    block_gemm<MT, ColMajor>(m_s, HC, w2 + n0, hid, acc_s, C, C, HC, n0 > 0);
    __syncthreads();
  }

  bf16* ob = out + (size_t)blockIdx.x * R * C;
  for (int i = tid; i < R * C; i += kThreads) {
    float val = acc_s[i] + to_f(b2[i % C]);
    if (add_res) val += to_f(xb[i]);
    ob[i] = to_bf(val);
  }
}

template <int MT>
int launch(const void* x, const void* lnw, const void* lnb, const void* w1, const void* b1,
           const void* w2, const void* b2, void* out, int N, int C, float eps, int add_res,
           cudaStream_t stream) {
  const size_t smem = ff_smem<MT>(C);
  UAV_RETURN_IF(set_smem(ff_kernel<MT>, smem));
  ff_kernel<MT><<<N / (16 * MT), kThreads, smem, stream>>>(
      (const bf16*)x, (const bf16*)lnw, (const bf16*)lnb, (const bf16*)w1, (const bf16*)b1,
      (const bf16*)w2, (const bf16*)b2, (bf16*)out, C, eps, add_res);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (N, C) bf16 token rows; w1: (8C, C) and w2: (C, 4C) torch Linear
// weights; b1: (8C,), b2, lnw, lnb: (C,). C % 128 == 0, C <= 1024;
// N % 32 == 0 (C <= 512) or N % 16 == 0 (C = 1024).
extern "C" int uav_fused_feedforward(const void* x, const void* lnw, const void* lnb,
                                     const void* w1, const void* b1, const void* w2,
                                     const void* b2, void* out, int N, int C, float eps,
                                     int add_res, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C % 128 != 0 || C > 1024) return (int)cudaErrorInvalidValue;
  if (C <= 512) {
    if (N % 32 != 0) return (int)cudaErrorInvalidValue;
    return launch<2>(x, lnw, lnb, w1, b1, w2, b2, out, N, C, eps, add_res, st);
  }
  if (N % 16 != 0) return (int)cudaErrorInvalidValue;
  return launch<1>(x, lnw, lnb, w1, b1, w2, b2, out, N, C, eps, add_res, st);
}
