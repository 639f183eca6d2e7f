// LayerNorm -> attention over the (<= 128) text keys -> out-projection + bias
// (+ residual), on the folded form of the reference:
//   scores_h = LN(x) @ M_h,  M = Wq * K^T per head, padded to 128 keys
//   delta    = sum_h softmax(scores_h) @ Vo_h,  Vo = blockdiag(V) * Wo
//
// Replaces upscale_a_video_tpu/ops/cross_attention_block.py::
// fused_cross_attention_block (Pallas _kernel). M and Vo are per clip and
// small; the wrapper builds them. The per-frame repeat of the text context
// (t_repeat) is an index: block row bt reads M[bt / t_repeat]. Bound on this
// card: operations (2 * 2 * C * 128 * H per token) at C = 512.
//
// Design: one block per 16*MT tokens. LN(x) (bf16) and the fp32 (16*MT x C)
// accumulator stay in shared memory; head by head the 128 scores are made
// with WMMA, softmaxed by one warp per row (keys >= skv masked), and the
// bf16 probabilities are multiplied into the accumulator with WMMA.
#include "common.cuh"

using namespace uav;

namespace {

constexpr int KP = 128;  // padded keys per head

template <int MT>
size_t cab_smem(int C) {
  const int R = 16 * MT;
  return align128((size_t)R * C * 2) + align128((size_t)R * C * 4) +
         align128((size_t)R * KP * 4) + align128((size_t)R * KP * 2);
}

template <int MT>
__global__ void __launch_bounds__(kThreads)
cab_kernel(const bf16* __restrict__ x, const bf16* __restrict__ lnw, const bf16* __restrict__ lnb,
           const bf16* __restrict__ m, const bf16* __restrict__ vo, const bf16* __restrict__ bo,
           bf16* __restrict__ out, int S, int C, int H, int skv, int t_repeat, float eps,
           int add_res) {
  constexpr int R = 16 * MT;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  bf16* hn_s = (bf16*)p;    p += align128((size_t)R * C * 2);
  float* acc_s = (float*)p; p += align128((size_t)R * C * 4);
  float* s_s = (float*)p;   p += align128((size_t)R * KP * 4);
  bf16* p_s = (bf16*)p;

  const int bt = blockIdx.y, row0 = blockIdx.x * R, bb = bt / t_repeat;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const bf16* xb = x + ((size_t)bt * S + row0) * C;
  const int HK = H * KP;
  const bf16* mb = m + (size_t)bb * C * HK;
  const bf16* vb = vo + (size_t)bb * HK * C;

  for (int row = warp; row < R; row += kWarps)
    warp_layernorm(xb + (size_t)row * C, hn_s + (size_t)row * C, lnw, lnb, C, eps);
  __syncthreads();

  for (int h = 0; h < H; ++h) {
    block_gemm<MT, RowMajor>(hn_s, C, mb + h * KP, HK, s_s, KP, KP, C, false);
    __syncthreads();
    for (int row = warp; row < R; row += kWarps) {
      float e[KP / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < KP / 32; ++i) {
        const int c = lane + 32 * i;
        e[i] = c < skv ? s_s[row * KP + c] : -INFINITY;
        mx = fmaxf(mx, e[i]);
      }
      mx = warp_max(mx);
      float l = 0.f;
#pragma unroll
      for (int i = 0; i < KP / 32; ++i) {
        const int c = lane + 32 * i;
        e[i] = c < skv ? expf(e[i] - mx) : 0.f;
        l += e[i];
      }
      l = warp_sum(l);
#pragma unroll
      for (int i = 0; i < KP / 32; ++i) p_s[row * KP + lane + 32 * i] = to_bf(e[i] / l);
    }
    __syncthreads();
    block_gemm<MT, RowMajor>(p_s, KP, vb + (size_t)h * KP * C, C, acc_s, C, C, KP, h > 0);
    __syncthreads();
  }

  bf16* ob = out + ((size_t)bt * S + row0) * C;
  for (int i = tid; i < R * C; i += kThreads) {
    const int c = i % C;
    float val = acc_s[i] + to_f(bo[c]);
    if (add_res) val += to_f(xb[i]);
    ob[i] = to_bf(val);
  }
}

template <int MT>
int launch(const void* x, const void* lnw, const void* lnb, const void* m, const void* vo,
           const void* bo, void* out, int BT, int S, int C, int H, int skv, int t_repeat,
           float eps, int add_res, cudaStream_t stream) {
  const size_t smem = cab_smem<MT>(C);
  UAV_RETURN_IF(set_smem(cab_kernel<MT>, smem));
  dim3 grid(S / (16 * MT), BT);
  cab_kernel<MT><<<grid, kThreads, smem, stream>>>((const bf16*)x, (const bf16*)lnw,
                                                    (const bf16*)lnb, (const bf16*)m,
                                                    (const bf16*)vo, (const bf16*)bo, (bf16*)out,
                                                    S, C, H, skv, t_repeat, eps, add_res);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (BT, S, C) bf16; m: (BT / t_repeat, C, H*128); vo: (BT / t_repeat,
// H*128, C); lnw, lnb, bo: (C,). S % (16*MT) == 0 with MT = 2 for C <= 512,
// else 1.
extern "C" int uav_cross_attention_block(const void* x, const void* lnw, const void* lnb,
                                         const void* m, const void* vo, const void* bo, void* out,
                                         int BT, int S, int C, int H, int skv, int t_repeat,
                                         float eps, int add_res, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C % 16 != 0 || skv > KP || skv < 1 || BT % t_repeat != 0) return (int)cudaErrorInvalidValue;
  if (C <= 512) {
    if (S % 32 != 0) return (int)cudaErrorInvalidValue;
    return launch<2>(x, lnw, lnb, m, vo, bo, out, BT, S, C, H, skv, t_repeat, eps, add_res, st);
  }
  if (S % 16 != 0 || C > 1024) return (int)cudaErrorInvalidValue;
  return launch<1>(x, lnw, lnb, m, vo, bo, out, BT, S, C, H, skv, t_repeat, eps, add_res, st);
}
