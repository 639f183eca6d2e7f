// Tiled online-softmax attention with fp32 operands, no bias, head_dim 256 or
// 512 (the wrapper zero-pads narrower heads).
//
// Replaces upscale_a_video_tpu/ops/flash_attention.py::flash_attention (the
// Pallas _flash_kernel) where it runs with fp32 q, k and v: the VAE's
// mid-block attention under --decode_attn fp32 (JAX UAV_VAE_ATTN_F32). That
// kernel is dtype-generic, so with fp32 operands both of its products and p
// stay in fp32; so do they here: every product is an FFMA on the CUDA cores,
// no TF32 and no rounding of p. The scores never reach device memory; the
// running max m, the running sum l and the output accumulator stay in fp32;
// keys past Sk are masked to -inf.
//
// Bound on this card: operations, 4*Sq*Sk*D per head at the fp32 rate of the
// CUDA cores (67 TFLOP/s), far above the bytes at every shape it serves.
//
// Design (a simple one; a 3xTF32 split on wgmma is the faster route): one
// block of 256 threads per 32 query rows of one head. Q (32 x D), a K tile
// and a V tile (32 keys x D each) live in shared memory, rows padded by 4
// floats so that neighbouring rows start 4 banks apart (202.9 KB at D = 512,
// one block per SM). The K and V tiles arrive by cp.async: the next K tile
// loads while the softmax and P V run, the V tile while S = Q K^T runs.
// - S = Q K^T: each warp owns 8 rows x 16 keys, each thread 2 x 2 of them over
//   the whole depth (2 + 2 float4 loads per 16 FFMAs; the 8 lanes of a
//   quarter warp read one Q row, broadcast, and 8 different keys).
// - softmax: 8 threads per row, 4 keys each, shuffles for the row max and
//   sum; P goes back to shared memory over the scores, the row's rescale
//   factor beside it.
// - O = O * alpha + P V: each warp owns 8 rows x D/2 columns, each thread 8
//   rows x D/64 columns in float4 groups 128 columns apart (P read as
//   broadcast float4s, V as whole-warp contiguous float4 rows).
#include "common.cuh"

namespace uav {
namespace {

constexpr int kF32Threads = 256;
constexpr int kF32Rows = 32;  // query rows per block
constexpr int kF32Keys = 32;  // keys per tile
constexpr int kSStride = 36;  // floats per row of the score tile (16-byte aligned rows)

template <int D>
struct FlashF32 {
  static constexpr int kStride = D + 4;  // floats per shared row of Q, K and V
  static constexpr int kJ = D / 256;     // float4 column groups a thread owns in O
  static constexpr size_t kTile = (size_t)kF32Rows * kStride;  // floats of one tile
  static constexpr size_t kSmem = (3 * kTile + kF32Rows * kSStride + kF32Rows) * 4;
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most one of this thread's committed groups is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// rows r0 .. r0 + 31 of a (n, D) fp32 matrix into a padded tile; rows past n
// are zero-filled (cp.async with no source bytes)
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int r0, int n) {
  constexpr int kVec = D / 4;
  for (int i = threadIdx.x; i < kF32Rows * kVec; i += kF32Threads) {
    const int r = i / kVec, c = (i % kVec) * 4;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * FlashF32<D>::kStride + c, src + (size_t)(ok ? r0 + r : 0) * D + c, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk,
                 float scale) {
  using C = FlashF32<D>;
  constexpr int S = C::kStride, J = C::kJ;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + C::kTile;
  float* v_s = k_s + C::kTile;
  float* s_s = v_s + C::kTile;             // [32][kSStride]: the scores, then P
  float* a_s = s_s + kF32Rows * kSStride;  // [32]: each row's rescale of O, then 1 / l

  const int bh = blockIdx.y, q0 = blockIdx.x * kF32Rows;
  const float* kh = k + (size_t)bh * Sk * D;
  const float* vh = v + (size_t)bh * Sk * D;
  const int n_tiles = (Sk + kF32Keys - 1) / kF32Keys;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile<D>(q_s, q + (size_t)bh * Sq * D, q0, Sq);
  load_tile<D>(k_s, kh, 0, Sk);
  cp_async_commit();
  load_tile<D>(v_s, vh, 0, Sk);
  cp_async_commit();

  // S: rows sr, sr + 4 and keys sk, sk + 8 of the tile
  const int sr = (warp / 2) * 8 + lane / 8, sk = (warp % 2) * 16 + lane % 8;
  // softmax: row mr, keys mk .. mk + 3
  const int mr = threadIdx.x / 8, mk = (threadIdx.x % 8) * 4;
  float m_run = -INFINITY, l_run = 0.f;
  // O: rows orow .. orow + 7, columns ocol + 128 j + 0..3
  const int orow = (warp / 2) * 8, ocol = (warp % 2) * (D / 2) + 4 * lane;
  float acc[8][4 * J];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4 * J; ++c) acc[i][c] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int key0 = kt * kF32Keys;
    cp_async_wait_one();  // Q and this K tile (the V tile may still be in flight)
    __syncthreads();

    float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
    const float* qa = q_s + sr * S;
    const float* qb = qa + 4 * S;
    const float* ka = k_s + sk * S;
    const float* kb = ka + 8 * S;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 a = *reinterpret_cast<const float4*>(qa + d);
      const float4 b = *reinterpret_cast<const float4*>(qb + d);
      const float4 x = *reinterpret_cast<const float4*>(ka + d);
      const float4 y = *reinterpret_cast<const float4*>(kb + d);
      s00 = fmaf(a.x, x.x, s00); s00 = fmaf(a.y, x.y, s00);
      s00 = fmaf(a.z, x.z, s00); s00 = fmaf(a.w, x.w, s00);
      s01 = fmaf(a.x, y.x, s01); s01 = fmaf(a.y, y.y, s01);
      s01 = fmaf(a.z, y.z, s01); s01 = fmaf(a.w, y.w, s01);
      s10 = fmaf(b.x, x.x, s10); s10 = fmaf(b.y, x.y, s10);
      s10 = fmaf(b.z, x.z, s10); s10 = fmaf(b.w, x.w, s10);
      s11 = fmaf(b.x, y.x, s11); s11 = fmaf(b.y, y.y, s11);
      s11 = fmaf(b.z, y.z, s11); s11 = fmaf(b.w, y.w, s11);
    }
    const bool in0 = key0 + sk < Sk, in1 = key0 + sk + 8 < Sk;
    s_s[sr * kSStride + sk] = in0 ? s00 * scale : -INFINITY;
    s_s[sr * kSStride + sk + 8] = in1 ? s01 * scale : -INFINITY;
    s_s[(sr + 4) * kSStride + sk] = in0 ? s10 * scale : -INFINITY;
    s_s[(sr + 4) * kSStride + sk + 8] = in1 ? s11 * scale : -INFINITY;
    __syncthreads();
    if (kt + 1 < n_tiles) load_tile<D>(k_s, kh, key0 + kF32Keys, Sk);  // K is read
    cp_async_commit();

    {  // online softmax of the tile (every tile holds at least one real key)
      float* row = s_s + mr * kSStride + mk;
      const float4 s4 = *reinterpret_cast<const float4*>(row);
      float mx = fmaxf(fmaxf(s4.x, s4.y), fmaxf(s4.z, s4.w));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_run, mx);
      float4 p;
      p.x = expf(s4.x - m_new);
      p.y = expf(s4.y - m_new);
      p.z = expf(s4.z - m_new);
      p.w = expf(s4.w - m_new);
      float sum = (p.x + p.y) + (p.z + p.w);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      const float alpha = expf(m_run - m_new);  // 0 at the first tile
      l_run = l_run * alpha + sum;
      m_run = m_new;
      *reinterpret_cast<float4*>(row) = p;
      if (mk == 0) a_s[mr] = alpha;
    }
    cp_async_wait_one();  // this V tile (the next K tile may still be in flight)
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float alpha = a_s[orow + i];
#pragma unroll
      for (int c = 0; c < 4 * J; ++c) acc[i][c] *= alpha;
    }
#pragma unroll 2
    for (int kk = 0; kk < kF32Keys; kk += 4) {
      float4 p[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        p[i] = *reinterpret_cast<const float4*>(s_s + (orow + i) * kSStride + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 vv[J];
#pragma unroll
        for (int j = 0; j < J; ++j)
          vv[j] = *reinterpret_cast<const float4*>(v_s + (kk + u) * S + ocol + 128 * j);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float pu = u == 0 ? p[i].x : u == 1 ? p[i].y : u == 2 ? p[i].z : p[i].w;
#pragma unroll
          for (int j = 0; j < J; ++j) {
            acc[i][4 * j + 0] = fmaf(pu, vv[j].x, acc[i][4 * j + 0]);
            acc[i][4 * j + 1] = fmaf(pu, vv[j].y, acc[i][4 * j + 1]);
            acc[i][4 * j + 2] = fmaf(pu, vv[j].z, acc[i][4 * j + 2]);
            acc[i][4 * j + 3] = fmaf(pu, vv[j].w, acc[i][4 * j + 3]);
          }
        }
      }
    }
    __syncthreads();  // V, P and the rescale are read
    if (kt + 1 < n_tiles) load_tile<D>(v_s, vh, key0 + kF32Keys, Sk);
    cp_async_commit();
  }

  if (mk == 0) a_s[mr] = 1.f / l_run;
  __syncthreads();
  float* ob = o + (size_t)bh * Sq * D;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = q0 + orow + i;
    if (r >= Sq) break;
    const float inv = a_s[orow + i];
#pragma unroll
    for (int j = 0; j < J; ++j)
      *reinterpret_cast<float4*>(ob + (size_t)r * D + ocol + 128 * j) =
          make_float4(acc[i][4 * j] * inv, acc[i][4 * j + 1] * inv, acc[i][4 * j + 2] * inv,
                      acc[i][4 * j + 3] * inv);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int BH, int Sq, int Sk,
               float scale, cudaStream_t stream) {
  constexpr size_t smem = FlashF32<D>::kSmem;
  UAV_RETURN_IF(set_smem(flash_f32_kernel<D>, smem));
  const dim3 grid((Sq + kF32Rows - 1) / kF32Rows, BH);
  flash_f32_kernel<D><<<grid, kF32Threads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, Sq, Sk, scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace uav

// q: (BH, Sq, D); k, v: (BH, Sk, D); o: (BH, Sq, D). All fp32, contiguous,
// 16-byte aligned. D is 256 or 512 (the wrapper zero-pads others).
extern "C" int uav_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                       int BH, int Sq, int Sk, int D, float scale,
                                       void* stream) {
  if (BH < 1 || Sq < 1 || Sk < 1 || BH > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 256: return uav::launch_f32<256>(q, k, v, o, BH, Sq, Sk, scale, s);
    case 512: return uav::launch_f32<512>(q, k, v, o, BH, Sq, Sk, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
