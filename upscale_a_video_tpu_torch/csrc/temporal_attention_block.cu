// Whole temporal-attention step of a UNet transformer block: LayerNorm ->
// q/k/v (C x C, no bias) -> q * D^-1/2 -> RoPE on the first `rot` dims of
// each head (interleaved pairs, position = frame) -> attention over the T
// frames of each pixel with the T5 relative-position bias -> out-projection
// + bias (+ residual), in three launches on the tokens' own (B, T, S, C)
// layout (the two transposes of the module path never happen):
//   ln     hn = bf16(LN(x)), one warp per row (layer_norm.cuh)
//   qkv    [q_h | k_h | v_h] = hn @ Wqkv_h^T on the GEMM core (gemm_core.cuh)
//          for tiles of r pixels x all T frames (one TMA box of 64 x r x T of
//          hn) and one head h (three boxes of Wqkv, the (3C, C) stack of Wq,
//          Wk, Wv); its epilogue (QkvAttnEpilogue) rounds, scales and rotates
//          q, k and v in registers, stages them in shared memory and runs the
//          T-frame attention of the tile's pixels for head h there, writing
//          o_h: q, k and v never reach device memory
//   proj   out = bf16(o @ Wo^T + bo (+ x)) on the GEMM core
//
// Replaces upscale_a_video_tpu/ops/temporal_attention_block.py::
// fused_temporal_attention_block (Pallas _kernel, which keeps everything in
// VMEM). Bound on this card: operations (8 C^2 per token for the four
// products, about 3,000 per byte of x at C = 512). hn and o make one round
// trip through device memory each: the out-projection needs all heads of a
// row, a tile here has one.
#include "gemm_core.cuh"
#include "layer_norm.cuh"

namespace uav {
namespace {

__global__ void __launch_bounds__(kThreads)
tab_layernorm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     const bf16* __restrict__ b, bf16* __restrict__ hn, int M, int C,
                     float eps) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row < M) layernorm_row(x, w, b, hn, row, C, eps);
}

constexpr int kMaxT = 16;

// 8 bf16 (16 bytes) of shared memory as fp32.
__device__ __forceinline__ void load8(float (&f)[8], const bf16* p) {
  const uint4 u = *(const uint4*)p;
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 t = unpack_bf16(w[e]);
    f[2 * e] = t.x;
    f[2 * e + 1] = t.y;
  }
}

// The q/k/v product's epilogue: the attention itself. A tile is r = BM / T
// pixels of all T frames of one sample (rows t * r + p) by one head's q | k |
// v columns (3D; head h = n0 / 3D).
// (1) Each thread rounds its q, k, v to bf16 as the plain version does (q,
//     then q * scale, then the rotated pair), rotates the first rot dims of q
//     and k (a pair is columns 2i, 2i + 1 of one thread's accumulators; the
//     frame is row / r) and stages them in shared memory.
// (2) Once both warpgroups have, D / 32 threads per (pixel, query frame) take
//     32 dims each: partial scores against the T frames of the pixel, summed
//     across the threads by shuffles, + bias, softmax (max subtracted, fp32),
//     probabilities rounded to bf16, then their 32 dims of o_h, written in x's
//     (B*T*S, C) layout (pixels past S are TMA's zero fill, not stored).
// D = 64 takes 128-row tiles (each warpgroup 64 rows x 192 columns), D = 128
// 64-row tiles (the warpgroups split the 384 columns); both give 256 threads
// of work in (2).
template <int D>
struct QkvAttnEpilogue {
  static constexpr bool kPrologue = false, kGeglu = false, kPixelTiles = true;
  static constexpr int kBParts = 3;
  static constexpr int kBM = D == 64 ? 128 : 64;
  static constexpr int kLd = 3 * D + 8;  // a staged row, bf16, padded by 16 bytes
  static constexpr size_t kSmem = (size_t)kBM * kLd * 2;
  const float* cos_t;  // (T, rot / 2)
  const float* sin_t;
  const float* bias;   // (H, T, T)
  bf16* o;             // (B*T*S, C)
  int rot;
  float scale;

  template <int NA>
  __device__ __forceinline__ void operator()(const ConvShape& s, const Tile& tl,
                                             float (&acc)[NA], const Frag& fr,
                                             unsigned char* scratch) const {
    bf16* st = (bf16*)scratch;
    const int T = s.T, r = s.mrows, h = tl.n0 / (3 * D), half = rot / 2;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = fr.row + 8 * hh, t = row / r;
#pragma unroll
      for (int j = 0; j < NA / 4; ++j) {
        const int c = fr.col_off + j * 8 + fr.quad, part = c / D, dd = c % D;
        float a0 = round_bf(acc[4 * j + 2 * hh]), a1 = round_bf(acc[4 * j + 2 * hh + 1]);
        if (part == 0) {
          a0 = round_bf(a0 * scale);
          a1 = round_bf(a1 * scale);
        }
        if (part < 2 && dd < rot) {
          const int i = t * half + dd / 2;
          const float cs = __ldg(cos_t + i), sn = __ldg(sin_t + i);
          const float b0 = a0 * cs - a1 * sn, b1 = a1 * cs + a0 * sn;
          a0 = b0;
          a1 = b1;
        }
        *(uint32_t*)(st + row * kLd + c) = pack_bf16(a0, a1);
      }
    }
    named_bar_sync(1, 256);

    constexpr int kParts = D / 32;  // threads per (pixel, query frame)
    const int tid = fr.slot * 32 + fr.lane, task = tid / kParts, part = tid % kParts;
    const int i = task / r, p = task - i * r;
    const bf16* q = st + task * kLd + part * 32;
    const bf16* k = st + p * kLd + D + part * 32;  // frame j: + j * r * kLd
    const bf16* v = k + D;
    float sc[kMaxT];
#pragma unroll
    for (int j = 0; j < kMaxT; ++j) sc[j] = 0.f;
#pragma unroll
    for (int d = 0; d < 32; d += 8) {
      float qf[8];
      load8(qf, q + d);
#pragma unroll
      for (int j = 0; j < kMaxT; ++j)
        if (j < T) {
          float kf[8];
          load8(kf, k + j * r * kLd + d);
#pragma unroll
          for (int e = 0; e < 8; ++e) sc[j] = fmaf(qf[e], kf[e], sc[j]);
        }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxT; ++j)
      if (j < T) {
#pragma unroll
        for (int m = 1; m < kParts; m <<= 1) sc[j] += __shfl_xor_sync(0xffffffffu, sc[j], m);
        sc[j] += __ldg(bias + ((size_t)h * T + i) * T + j);
        mx = fmaxf(mx, sc[j]);
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
    const int px = tl.m0 + p;
    if (px < s.HW) {
      bf16* orow = o + ((size_t)(tl.f + i) * s.HW + px) * (s.Cout / 3) + h * D + part * 32;
#pragma unroll
      for (int d = 0; d < 32; d += 8) {
        float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < kMaxT; ++j)
          if (j < T) {
            float vf[8];
            load8(vf, v + j * r * kLd + d);
#pragma unroll
            for (int e = 0; e < 8; ++e) a[e] = fmaf(sc[j], vf[e], a[e]);
          }
        *(uint4*)(orow + d) = make_uint4(pack_bf16(a[0], a[1]), pack_bf16(a[2], a[3]),
                                         pack_bf16(a[4], a[5]), pack_bf16(a[6], a[7]));
      }
    }
    named_bar_sync(1, 256);  // the staging is free for the next tile
  }
};

// The out-projection's epilogue: the core's bias epilogue, its own type so
// that a profile tells this product from the feed-forward's.
struct OutProjEpilogue : BiasEpilogue {};

int out_projection(const void* o, const void* wo, const OutProjEpilogue& epi, int M, int C,
                   cudaStream_t st) {
  return small_tiles(1, M, C, 256) ? launch_gemm<64, 128>(o, wo, 1, 1, M, C, C, 1, epi, st)
                                   : launch_gemm<128, 256>(o, wo, 1, 1, M, C, C, 1, epi, st);
}

template <int D>
int qkv_attention(const void* hn, const void* wqkv, const QkvAttnEpilogue<D>& epi, int B, int T,
                  int S, int C, cudaStream_t st) {
  constexpr int BM = QkvAttnEpilogue<D>::kBM;
  return launch_gemm<BM, 3 * D>(hn, wqkv, B * T, T, S, C, 3 * C, 1, epi, st);
}

}  // namespace
}  // namespace uav

using namespace uav;

// x, out: (B, T, S, C) bf16 tokens; lnw, lnb, bo: (C,); wqkv: (3C, C), the
// torch Linear weights of q, k and v stacked; wo: (C, C); bias: (H, T, T)
// fp32; cos_t, sin_t: (T, rot/2) fp32; hn, o: (B*T*S, C) and qkv:
// (B*T*S, 3C) bf16 scratch. All 16-byte aligned. C % 64 == 0, D = C / H a
// multiple of 8, rot a multiple of 8 up to min(D, 32), T <= 16, T * H <= 1024.
extern "C" int uav_temporal_attention_block(const void* x, const void* lnw, const void* lnb,
                                            const void* wqkv, const void* wo, const void* bo,
                                            const void* bias, const void* cos_t,
                                            const void* sin_t, void* hn, void* o, void* out,
                                            int B, int T, int S, int C, int H, int rot, float eps,
                                            int add_res, void* stream) {
  const int D = C / H;
  if (B < 1 || S < 1 || T < 1 || T > kMaxT || 64 % T != 0 || H < 1 || C % H != 0 ||
      (D != 64 && D != 128) || C % 64 != 0 || rot % 2 != 0 || rot > D)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int M = B * T * S;
  tab_layernorm_kernel<<<(M + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      (const bf16*)x, (const bf16*)lnw, (const bf16*)lnb, (bf16*)hn, M, C, eps);
  UAV_RETURN_IF(cudaGetLastError());
  const float scale = (float)(1.0 / sqrt((double)D));
  int e;
  if (D == 64) {
    const QkvAttnEpilogue<64> qe{(const float*)cos_t, (const float*)sin_t, (const float*)bias,
                                 (bf16*)o, rot, scale};
    e = qkv_attention<64>(hn, wqkv, qe, B, T, S, C, st);
  } else {
    const QkvAttnEpilogue<128> qe{(const float*)cos_t, (const float*)sin_t, (const float*)bias,
                                  (bf16*)o, rot, scale};
    e = qkv_attention<128>(hn, wqkv, qe, B, T, S, C, st);
  }
  if (e) return e;
  const OutProjEpilogue pe{{(const bf16*)bo, add_res ? (const bf16*)x : nullptr, (bf16*)out}};
  return out_projection(o, wo, pe, M, C, st);
}
