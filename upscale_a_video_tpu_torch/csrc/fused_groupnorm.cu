// Channels-last GroupNorm with an optional SiLU, y = act((x - mean) * rstd * gamma + beta),
// statistics per (sample, group) over every non-channel axis (torch's 4-D/5-D
// GroupNorm), in two launches:
//   gn_stats   per-(sample, group) sums of x and x^2 (one read of x), and in
//              each sample's last block the finalize: mean and rstd in a fixed
//              order, folded into a per-(sample, channel) affine a, d
//              (group_norm.cuh)
//   gn_apply   y = act(x * a + d) (one read of x, one write of y)
//
// Replaces upscale_a_video_tpu/ops/fused_groupnorm.py::fused_group_norm
// (Pallas _stats_kernel and _apply_kernel; there the statistics were carried
// across the sequential row grid in scratch memory). Blocks on this card run
// in no order, hence the per-block partials and the last block's finalize.
//
// Bound on this card: bytes. x does not stay on chip (94-377 MB at the video
// VAE's fp32 sites, beyond the 50 MB L2), so two reads of x and one write of
// y are inherent. The apply pass takes the statistics pass's blocks and rows
// (the same plan) but walks each block's rows from the end back to the start,
// so its first reads find what the statistics pass read last still in L2;
// it reads with evict-first loads and writes y with streaming stores, so y
// does not push those rows out. Each thread keeps one chunk of channels, so
// its a and d stay in registers; loads and stores are 16 bytes (8 for bf16
// with C % 8 != 0), kGnUnroll rows in flight; the SiLU uses the fast
// exponential and division.
#include "group_norm.cuh"

// One anonymous namespace per file, inside uav as the shared header's is: a
// second one at file scope makes nvcc's registration stub ambiguous.
namespace uav {
namespace {

template <class Raw>
__device__ __forceinline__ Raw ld_stream(const Raw* p) {
  return __ldcs(p);
}

template <class Raw>
__device__ __forceinline__ void st_stream(Raw* p, const Raw& v) {
  __stcs(p, v);
}

template <int VEC, bool SILU>
__device__ __forceinline__ void affine(float (&v)[VEC], const float (&a)[VEC],
                                       const float (&d)[VEC]) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const float f = fmaf(v[e], a[e], d[e]);
    v[e] = SILU ? __fdividef(f, 1.f + __expf(-f)) : f;
  }
}

// x, y: (N, rows, C); a, d: (N, C) fp32. The block and row plan of gn_stats,
// each thread's rows walked from its last one back.
template <bool F32, int VEC, bool SILU>
__global__ void __launch_bounds__(kGnThreads)
gn_apply_kernel(const void* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ d, void* __restrict__ y, int rows, int C, int rpb) {
  using V = GnVec<F32, VEC>;
  using Raw = typename V::Raw;
  const GnMap m(C, VEC, rows, rpb);
  if (m.rs >= m.rps || m.r0 + m.rs >= m.r1) return;
  const int n = blockIdx.y;
  const size_t sample = (size_t)n * rows * m.chunks;
  const Raw* xs = reinterpret_cast<const Raw*>(x) + sample;
  Raw* ys = reinterpret_cast<Raw*>(y) + sample;
  const int r_last = m.r0 + m.rs + (m.r1 - 1 - m.r0 - m.rs) / m.rps * m.rps;
  for (int ch = m.cc; ch < m.chunks; ch += m.tpr) {
    float av[VEC], dv[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      av[e] = a[(size_t)n * C + ch * VEC + e];
      dv[e] = d[(size_t)n * C + ch * VEC + e];
    }
    for (int r = r_last; r >= m.r0; r -= kGnUnroll * m.rps) {
      Raw raw[kGnUnroll];
#pragma unroll
      for (int u = 0; u < kGnUnroll; ++u)
        if (r - u * m.rps >= m.r0) raw[u] = ld_stream(xs + (size_t)(r - u * m.rps) * m.chunks + ch);
#pragma unroll
      for (int u = 0; u < kGnUnroll; ++u) {
        const int ru = r - u * m.rps;
        if (ru < m.r0) continue;
        float v[VEC];
        V::unpack(raw[u], v);
        affine<VEC, SILU>(v, av, dv);
        st_stream(ys + (size_t)ru * m.chunks + ch, V::pack(v));
      }
    }
  }
}

template <bool F32, int VEC>
cudaError_t launch_apply(const void* x, const void* a, const void* d, void* y, int N, int rows,
                         int C, int nb, int rpb, int silu, cudaStream_t stream) {
  const dim3 grid(nb, N);
  if (silu)
    gn_apply_kernel<F32, VEC, true><<<grid, kGnThreads, 0, stream>>>(
        x, (const float*)a, (const float*)d, y, rows, C, rpb);
  else
    gn_apply_kernel<F32, VEC, false><<<grid, kGnThreads, 0, stream>>>(
        x, (const float*)a, (const float*)d, y, rows, C, rpb);
  return cudaGetLastError();
}

}  // namespace
}  // namespace uav

using namespace uav;

// x, y: (N, rows, C), bf16 (fp32 == 0) or fp32 (fp32 == 1), 16-byte aligned;
// gamma, beta: (C,) fp32; part: (N, G, nb) double2 scratch; ticket: N
// unsigned, zero (and zero again after the call); a, d: (N, C) fp32 scratch.
// nb blocks of rpb rows per sample (ops/fused_groupnorm.py::stats_plan).
// C % 4 == 0 and C % G == 0.
extern "C" int uav_fused_group_norm(const void* x, const void* gamma, const void* beta,
                                    void* part, void* ticket, void* a, void* d, void* y, int N,
                                    int rows, int C, int G, int nb, int rpb, float eps, int fp32,
                                    int silu, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const GnStatsArgs p{x, (double2*)part, (unsigned*)ticket, gamma, beta, (float*)a, (float*)d,
                      rows, C, G, rpb, eps, 1.f, 1};
  UAV_RETURN_IF(launch_gn_stats(fp32, p, N, nb, st));
  if (fp32) return (int)launch_apply<true, 4>(x, a, d, y, N, rows, C, nb, rpb, silu, st);
  if (gn_vec(false, C) == 8)
    return (int)launch_apply<false, 8>(x, a, d, y, N, rows, C, nb, rpb, silu, st);
  return (int)launch_apply<false, 4>(x, a, d, y, N, rows, C, nb, rpb, silu, st);
}

// x: (N, rows, C) bf16 -> a, d: (N, C) fp32 with scale * GN(x) = x * a + d;
// gamma, beta bf16 (the temporal resblock's first GroupNorm, scale 1/2: the
// halves its convs' prologue takes). part, ticket, nb, rpb as above.
extern "C" int uav_gn_stats(const void* x, const void* gamma, const void* beta, void* part,
                            void* ticket, void* a, void* d, int N, int rows, int C, int G, int nb,
                            int rpb, float eps, float scale, void* stream) {
  const GnStatsArgs p{x, (double2*)part, (unsigned*)ticket, gamma, beta, (float*)a, (float*)d,
                      rows, C, G, rpb, eps, scale, 0};
  return (int)launch_gn_stats(false, p, N, nb, (cudaStream_t)stream);
}
