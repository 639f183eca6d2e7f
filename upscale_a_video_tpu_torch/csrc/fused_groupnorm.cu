// Channels-last GroupNorm with an optional SiLU, y = act((x - mean) * rstd * gamma + beta),
// statistics per (sample, group) over every non-channel axis (torch's 4-D/5-D
// GroupNorm), in three launches:
//   gn_partials   per-(block, channel) sums of x and x^2 (one read of x)
//   gn_finalize   per-(sample, group) mean and rstd in a fixed order, folded
//                 into a per-(sample, channel) affine a, d
//   gn_apply      y = act(x * a + d) (one read of x, one write of y)
//
// Replaces upscale_a_video_tpu/ops/fused_groupnorm.py::fused_group_norm
// (Pallas _stats_kernel and _apply_kernel; there the statistics were carried
// across the sequential row grid in scratch memory). Blocks on this card run
// in no order, hence the partial sums and the finalize pass (group_norm.cuh).
// Bound on this card: bytes (two reads of x and one write of y, at a few
// operations per element).
//
// x and y are bf16 or fp32 (the UNet's and the fp32 VAE decoder's sites);
// statistics and the affine are fp32. The apply pass moves 4 elements per
// thread per step (8 bytes of bf16, 16 bytes of fp32).
#include "group_norm.cuh"

// One anonymous namespace per file, inside uav as the shared header's is: a
// second one at file scope makes nvcc's registration stub ambiguous.
namespace uav {
namespace {

// Elements e..e+3 of an fp32 (F32) or bf16 array, 16 or 8 bytes at once.
template <bool F32>
__device__ __forceinline__ void load4(const void* p, long long e, float v[4]) {
  if constexpr (F32) {
    const float4 t = reinterpret_cast<const float4*>(p)[e / 4];
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    const uint2 t = reinterpret_cast<const uint2*>(p)[e / 4];
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  }
}

template <bool F32>
__device__ __forceinline__ void store4(void* p, long long e, const float v[4]) {
  if constexpr (F32) {
    reinterpret_cast<float4*>(p)[e / 4] = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 t;
    t.x = *reinterpret_cast<const unsigned int*>(&lo);
    t.y = *reinterpret_cast<const unsigned int*>(&hi);
    reinterpret_cast<uint2*>(p)[e / 4] = t;
  }
}

// x, y: (N, per_sample) with per_sample = rows * C; a, d: (N, C).
template <bool F32, bool SILU>
__global__ void __launch_bounds__(kThreads)
gn_apply_kernel(const void* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ d, void* __restrict__ y, long long per_sample, int C,
                long long total) {
  const long long stride = (long long)gridDim.x * kThreads * 4;
  for (long long e = ((long long)blockIdx.x * kThreads + threadIdx.x) * 4; e < total;
       e += stride) {
    const long long b = e / per_sample;
    const int c = (int)(e % C);
    const float* ab = a + b * C + c;
    const float* db = d + b * C + c;
    float v[4];
    load4<F32>(x, e, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float f = v[j] * ab[j] + db[j];
      if (SILU) f = f / (1.f + expf(-f));
      v[j] = f;
    }
    store4<F32>(y, e, v);
  }
}

template <bool F32>
cudaError_t run(const void* x, const void* gamma, const void* beta, void* part, void* a,
                void* d, void* y, int N, int rows, int C, int G, int nblk, float eps, int silu,
                cudaStream_t stream) {
  cudaError_t e = launch_gn_partials(F32, x, part, N, rows, C, nblk, stream);
  if (e != cudaSuccess) return e;
  e = launch_gn_finalize(true, part, gamma, beta, a, d, N, nblk, C, G,
                         (float)rows * (float)(C / G), eps, 1.f, stream);
  if (e != cudaSuccess) return e;
  const long long per_sample = (long long)rows * C, total = per_sample * N;
  const long long want = (total / 4 + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  if (silu)
    gn_apply_kernel<F32, true><<<blocks, kThreads, 0, stream>>>(
        x, (const float*)a, (const float*)d, y, per_sample, C, total);
  else
    gn_apply_kernel<F32, false><<<blocks, kThreads, 0, stream>>>(
        x, (const float*)a, (const float*)d, y, per_sample, C, total);
  return cudaGetLastError();
}

}  // namespace
}  // namespace uav

using namespace uav;

// x, y: (N, rows, C), bf16 (fp32 == 0) or fp32 (fp32 == 1), 16-byte aligned;
// gamma, beta: (C,) fp32; part: (N, nblk, C, 2) fp32 scratch; a, d: (N, C) fp32
// scratch. C % 4 == 0 and C % G == 0.
extern "C" int uav_fused_group_norm(const void* x, const void* gamma, const void* beta,
                                    void* part, void* a, void* d, void* y, int N, int rows,
                                    int C, int G, int nblk, float eps, int fp32, int silu,
                                    void* stream) {
  if (N < 1 || rows < 1 || C % 4 != 0 || G < 1 || C % G != 0 || nblk < 1 || nblk > rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (fp32)
    return (int)run<true>(x, gamma, beta, part, a, d, y, N, rows, C, G, nblk, eps, silu, st);
  return (int)run<false>(x, gamma, beta, part, a, d, y, N, rows, C, G, nblk, eps, silu, st);
}
