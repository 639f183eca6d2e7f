// Tiled online-softmax attention, no bias, head_dim up to 512.
//
// Replaces upscale_a_video_tpu/ops/flash_attention.py::flash_attention (the
// Pallas _flash_kernel). Same algorithm: scores never reach device memory;
// running max m, sum l and the output accumulator stay in fp32; keys past Sk
// are masked. Bound on this card: operations (4*Sq*Sk*D per head is far
// above the bytes for every shape it serves).
//
// Design: one block per (batch*head, 16*MT query rows). The fp32 accumulator
// for D = 512 does not fit in registers, so it lives in shared memory
// (MT = 2, 32 rows: 64 KB) and is rescaled in place by each key tile's
// correction factor. Q is staged once; K and V tiles of 64 keys are WMMA
// operands read from global memory (the wrapper pads K/V to a multiple of 64
// rows so no tile reads past the buffer).
#include "common.cuh"

using namespace uav;

namespace {

constexpr int BK = 64;

template <int MT>
size_t flash_smem(int D) {
  const int BQ = 16 * MT;
  return align128((size_t)BQ * D * 2) + align128((size_t)BQ * D * 4) +
         align128((size_t)BQ * BK * 4) + align128((size_t)BQ * BK * 2) + 2 * align128(BQ * 4);
}

template <int MT>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
             bf16* __restrict__ o, int Sq, int Sk, int Skp, int D, float scale) {
  constexpr int BQ = 16 * MT;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  bf16* q_s = (bf16*)p;  p += align128((size_t)BQ * D * 2);
  float* o_s = (float*)p; p += align128((size_t)BQ * D * 4);
  float* s_s = (float*)p; p += align128((size_t)BQ * BK * 4);
  bf16* p_s = (bf16*)p;  p += align128((size_t)BQ * BK * 2);
  float* m_s = (float*)p; p += align128(BQ * 4);
  float* l_s = (float*)p;

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const bf16* qb = q + (size_t)bh * Sq * D;
  const bf16* kb = k + (size_t)bh * Skp * D;
  const bf16* vb = v + (size_t)bh * Skp * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D;
    q_s[i] = (q0 + r < Sq) ? qb[(size_t)(q0 + r) * D + (i - r * D)] : to_bf(0.f);
    o_s[i] = 0.f;
  }
  for (int r = tid; r < BQ; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  __syncthreads();

  const int n_tiles = (Sk + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    block_gemm<MT, ColMajor>(q_s, D, kb + (size_t)kt * BK * D, D, s_s, BK, BK, D, false);
    __syncthreads();
    for (int r = warp; r < BQ; r += kWarps) {
      const int c0 = lane, c1 = lane + 32;
      const bool v0 = kt * BK + c0 < Sk, v1 = kt * BK + c1 < Sk;
      const float a0 = s_s[r * BK + c0] * scale, a1 = s_s[r * BK + c1] * scale;
      const float mx = warp_max(fmaxf(v0 ? a0 : -INFINITY, v1 ? a1 : -INFINITY));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float e0 = v0 ? expf(a0 - m_new) : 0.f;
      const float e1 = v1 ? expf(a1 - m_new) : 0.f;
      const float sum = warp_sum(e0 + e1);
      const float alpha = expf(m_old - m_new);
      p_s[r * BK + c0] = to_bf(e0);
      p_s[r * BK + c1] = to_bf(e1);
      for (int d = lane; d < D; d += 32) o_s[r * D + d] *= alpha;
      __syncwarp();
      if (lane == 0) {
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    block_gemm<MT, RowMajor>(p_s, BK, vb + (size_t)kt * BK * D, D, o_s, D, D, BK, true);
    __syncthreads();
  }

  bf16* ob = o + (size_t)bh * Sq * D;
  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D;
    if (q0 + r < Sq) {
      const float l = l_s[r];
      ob[(size_t)(q0 + r) * D + (i - r * D)] = to_bf(l == 0.f ? 0.f : o_s[i] / l);
    }
  }
}

template <int MT>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int Sq, int Sk,
           int Skp, int D, float scale, cudaStream_t stream) {
  const size_t smem = flash_smem<MT>(D);
  UAV_RETURN_IF(set_smem(flash_kernel<MT>, smem));
  dim3 grid((Sq + 16 * MT - 1) / (16 * MT), BH);
  flash_kernel<MT><<<grid, kThreads, smem, stream>>>((const bf16*)q, (const bf16*)k,
                                                      (const bf16*)v, (bf16*)o, Sq, Sk, Skp, D,
                                                      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (BH, Sq, D); k, v: (BH, Skp, D) with Skp a multiple of 64 and >= Sk;
// o: (BH, Sq, D). All bf16, contiguous. D % 16 == 0, D <= 512.
extern "C" int uav_flash_attention(const void* q, const void* k, const void* v, void* o, int BH,
                                   int Sq, int Sk, int Skp, int D, float scale, void* stream) {
  if (D % 16 != 0 || D > 512 || Skp % BK != 0 || Skp < Sk) return (int)cudaErrorInvalidValue;
  if (D <= 128)
    return launch<4>(q, k, v, o, BH, Sq, Sk, Skp, D, scale, (cudaStream_t)stream);
  return launch<2>(q, k, v, o, BH, Sq, Sk, Skp, D, scale, (cudaStream_t)stream);
}

extern "C" const char* uav_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
