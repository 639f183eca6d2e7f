// Whole temporal-attention step of a UNet transformer block in one pass:
// LayerNorm -> q/k/v (C x C, no bias) -> q * D^-1/2 -> RoPE on the first
// `rot` dims of each head (interleaved pairs, position = frame) -> attention
// over the T frames of each pixel with the T5 relative-position bias ->
// out-projection + bias (+ residual).
//
// Replaces upscale_a_video_tpu/ops/temporal_attention_block.py::
// fused_temporal_attention_block (Pallas _kernel). The tokens stay in their
// (B, T, S, C) layout: a block takes r pixels of all T frames (T*r rows), so
// the two transposes of the module path never happen. Bound on this card:
// operations (4 C x C products per token) at every slice shape.
//
// Design: the normalised rows (bf16) and the per-head outputs (bf16) stay in
// shared memory for the whole block. Head by head, q/k/v (T*r x D, fp32) are
// projected with WMMA, rounded to bf16 as the plain bf16 version rounds them,
// rotated, and attended by one warp per query row (T <= 16 keys: the scores
// stay in registers). The out-projection runs in 64-column chunks.
#include "common.cuh"

using namespace uav;

namespace {

constexpr int kMaxT = 16;

template <int MT>
size_t tab_smem(int C, int D) {
  const int rows = 16 * MT;
  const size_t qkv = 3 * align128((size_t)rows * D * 4);
  const size_t out_chunk = align128((size_t)rows * 64 * 4);
  return 2 * align128((size_t)rows * C * 2) + (qkv > out_chunk ? qkv : out_chunk);
}

template <int MT>
__global__ void __launch_bounds__(kThreads)
tab_kernel(const bf16* __restrict__ x, const bf16* __restrict__ lnw, const bf16* __restrict__ lnb,
           const bf16* __restrict__ wq, const bf16* __restrict__ wk, const bf16* __restrict__ wv,
           const bf16* __restrict__ wo, const bf16* __restrict__ bo,
           const float* __restrict__ bias, const float* __restrict__ cos_t,
           const float* __restrict__ sin_t, bf16* __restrict__ out, int T, int S, int C, int H,
           int rot, int r, float eps, int add_res) {
  constexpr int rows = 16 * MT;
  const int D = C / H, half = rot / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  bf16* hn_s = (bf16*)p; p += align128((size_t)rows * C * 2);
  bf16* o_s = (bf16*)p;  p += align128((size_t)rows * C * 2);
  float* q_s = (float*)p; p += align128((size_t)rows * D * 4);
  float* k_s = (float*)p; p += align128((size_t)rows * D * 4);
  float* v_s = (float*)p;
  float* chunk_s = q_s;  // reused by the out-projection

  const int b = blockIdx.y, p0 = blockIdx.x * r;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const float qscale = rsqrtf((float)D);
  auto row_off = [&](int row) -> size_t {
    const int t = row / r, px = row - t * r;
    return ((size_t)(b * T + t) * S + p0 + px) * C;
  };

  for (int row = warp; row < rows; row += kWarps)
    warp_layernorm(x + row_off(row), hn_s + (size_t)row * C, lnw, lnb, C, eps);
  __syncthreads();

  for (int h = 0; h < H; ++h) {
    block_gemm<MT, ColMajor>(hn_s, C, wq + (size_t)h * D * C, C, q_s, D, D, C, false);
    block_gemm<MT, ColMajor>(hn_s, C, wk + (size_t)h * D * C, C, k_s, D, D, C, false);
    block_gemm<MT, ColMajor>(hn_s, C, wv + (size_t)h * D * C, C, v_s, D, D, C, false);
    __syncthreads();
    for (int i = tid; i < rows * D; i += kThreads) {
      q_s[i] = round_bf(round_bf(q_s[i]) * qscale);
      k_s[i] = round_bf(k_s[i]);
      v_s[i] = round_bf(v_s[i]);
    }
    __syncthreads();
    for (int i = tid; i < rows * half; i += kThreads) {
      const int row = i / half, j = i - row * half, t = row / r;
      const float c = cos_t[t * half + j], s = sin_t[t * half + j];
      float* qp = q_s + (size_t)row * D + 2 * j;
      float* kp = k_s + (size_t)row * D + 2 * j;
      const float q0 = qp[0], q1 = qp[1], k0 = kp[0], k1 = kp[1];
      qp[0] = round_bf(q0 * c - q1 * s);
      qp[1] = round_bf(q1 * c + q0 * s);
      kp[0] = round_bf(k0 * c - k1 * s);
      kp[1] = round_bf(k1 * c + k0 * s);
    }
    __syncthreads();
    for (int row = warp; row < rows; row += kWarps) {
      const int t = row / r, px = row - t * r;
      const float* qr = q_s + (size_t)row * D;
      float sc[kMaxT];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kMaxT; ++j) {
        if (j < T) {
          const float* kr = k_s + (size_t)(j * r + px) * D;
          float part = 0.f;
          for (int d = lane; d < D; d += 32) part += qr[d] * kr[d];
          sc[j] = warp_sum(part) + bias[(h * T + t) * T + j];
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
      for (int d = lane; d < D; d += 32) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxT; ++j)
          if (j < T) acc += sc[j] * v_s[(size_t)(j * r + px) * D + d];
        o_s[(size_t)row * C + h * D + d] = to_bf(acc);
      }
    }
    __syncthreads();
  }

  for (int n0 = 0; n0 < C; n0 += 64) {
    block_gemm<MT, ColMajor>(o_s, C, wo + (size_t)n0 * C, C, chunk_s, 64, 64, C, false);
    __syncthreads();
    for (int i = tid; i < rows * 64; i += kThreads) {
      const int row = i / 64, c = n0 + (i - row * 64);
      const size_t off = row_off(row) + c;
      float val = chunk_s[i] + to_f(bo[c]);
      if (add_res) val += to_f(x[off]);
      out[off] = to_bf(val);
    }
    __syncthreads();
  }
}

template <int MT>
int launch(const void* x, const void* lnw, const void* lnb, const void* wq, const void* wk,
           const void* wv, const void* wo, const void* bo, const void* bias, const void* cos_t,
           const void* sin_t, void* out, int B, int T, int S, int C, int H, int rot, int r,
           float eps, int add_res, cudaStream_t stream) {
  const size_t smem = tab_smem<MT>(C, C / H);
  UAV_RETURN_IF(set_smem(tab_kernel<MT>, smem));
  dim3 grid(S / r, B);
  tab_kernel<MT><<<grid, kThreads, smem, stream>>>(
      (const bf16*)x, (const bf16*)lnw, (const bf16*)lnb, (const bf16*)wq, (const bf16*)wk,
      (const bf16*)wv, (const bf16*)wo, (const bf16*)bo, (const float*)bias,
      (const float*)cos_t, (const float*)sin_t, (bf16*)out, T, S, C, H, rot, r, eps, add_res);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (B, T, S, C) bf16; wq/wk/wv/wo: torch Linear weights (C, C) bf16;
// lnw, lnb, bo: (C,) bf16; bias: (H, T, T) fp32; cos_t, sin_t: (T, rot/2) fp32.
// r pixels per block with T*r a multiple of 16 in {16, 32, 64, 128}.
extern "C" int uav_temporal_attention_block(const void* x, const void* lnw, const void* lnb,
                                            const void* wq, const void* wk, const void* wv,
                                            const void* wo, const void* bo, const void* bias,
                                            const void* cos_t, const void* sin_t, void* out,
                                            int B, int T, int S, int C, int H, int rot, int r,
                                            float eps, int add_res, void* stream) {
  const int rows = T * r;
  if (T > kMaxT || C % H != 0 || (C / H) % 16 != 0 || C % 64 != 0 || S % r != 0 ||
      rot % 2 != 0 || rot > C / H)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (rows) {
    case 16: return launch<1>(x, lnw, lnb, wq, wk, wv, wo, bo, bias, cos_t, sin_t, out, B, T, S, C, H, rot, r, eps, add_res, st);
    case 32: return launch<2>(x, lnw, lnb, wq, wk, wv, wo, bo, bias, cos_t, sin_t, out, B, T, S, C, H, rot, r, eps, add_res, st);
    case 64: return launch<4>(x, lnw, lnb, wq, wk, wv, wo, bo, bias, cos_t, sin_t, out, B, T, S, C, H, rot, r, eps, add_res, st);
    case 128: return launch<8>(x, lnw, lnb, wq, wk, wv, wo, bo, bias, cos_t, sin_t, out, B, T, S, C, H, rot, r, eps, add_res, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
