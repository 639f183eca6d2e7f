// GroupNorm statistics on channels-last (N, rows, C) activations, shared by the
// temporal resblock (csrc/fused_temporal_resblock.cu) and the standalone
// GroupNorm (csrc/fused_groupnorm.cu).
//
// Bound on this card: bytes (one read of x at two operations an element).
// gn_stats_kernel reads x once with 16-byte loads (fp32 x 4 or bf16 x 8;
// bf16 x 4 in 8 bytes where C % 8 != 0), kGnUnroll rows in flight per
// thread, over a grid of about two blocks per SM (the caller's plan,
// ops/fused_groupnorm.py::stats_plan). Block `blk` of sample n takes rows
// [blk * rpb, (blk + 1) * rpb); each thread owns one chunk of VEC channels
// (the same chunk on every row it reads) and every rps-th row of the block's
// range, summing x and x^2 in fp32. The block then reduces its threads' sums
// per (sample, group, block) in double, in a fixed order, and each sample's
// last block to finish (an atomic ticket per sample after __threadfence)
// reduces that sample's partials per group, again in a fixed order, into the
// affine a, d of scale * GN(x) = x * a + d. So statistics and finalize are
// one launch, and two runs give the same bits.
//
// gn_finalize_kernel is the same finalize over the per-(tile, channel) sums
// that the resblock's first conv writes for its second GroupNorm.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace uav {
namespace {

constexpr int kGnThreads = 512;
constexpr int kGnWarps = kGnThreads / 32;
constexpr int kGnUnroll = 4;

// Element i of an fp32 (F32) or bf16 array.
template <bool F32>
__device__ __forceinline__ float ldf(const void* p, size_t i) {
  if constexpr (F32)
    return static_cast<const float*>(p)[i];
  else
    return __bfloat162float(static_cast<const bf16*>(p)[i]);
}

// VEC consecutive elements of an fp32 (F32, VEC = 4) or bf16 (VEC = 8 or 4)
// array as one 16- or 8-byte word.
template <bool F32, int VEC>
struct GnVec {
  static_assert(!F32 || VEC == 4, "fp32 chunks are 4 elements");
  using Raw = typename std::conditional<(F32 ? 4 : 2) * VEC == 16, uint4, uint2>::type;

  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[VEC]) {
    if constexpr (F32) {
      const float* f = reinterpret_cast<const float*>(&r);
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = f[e];
    } else {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
      for (int e = 0; e < VEC / 2; ++e) {
        const float2 t = __bfloat1622float2(h[e]);
        v[2 * e] = t.x;
        v[2 * e + 1] = t.y;
      }
    }
  }

  static __device__ __forceinline__ Raw pack(const float (&v)[VEC]) {
    Raw r;
    if constexpr (F32) {
      float* f = reinterpret_cast<float*>(&r);
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = v[e];
    } else {
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
      for (int e = 0; e < VEC / 2; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    }
    return r;
  }
};

// A thread's place in its block: channel chunk cc of the tpr chunks one pass
// covers, row offset rs of the rps rows one step covers (rs >= rps: idle).
// Channels past kGnThreads chunks are taken in further passes. Block b of a
// sample takes its rows [r0, r1) = [b * rpb, (b + 1) * rpb).
struct GnMap {
  int chunks, tpr, rps, cc, rs, r0, r1;
  __device__ __forceinline__ GnMap(int C, int vec, int rows, int rpb) {
    chunks = C / vec;
    tpr = min(chunks, kGnThreads);
    rps = kGnThreads / tpr;
    cc = threadIdx.x % tpr;
    rs = threadIdx.x / tpr;
    r0 = blockIdx.x * rpb;
    r1 = min(rows, r0 + rpb);
  }
};

// The sums of a and b over each aligned group of `lanes` lanes (a power of
// two up to 32), in a butterfly: every lane of a group ends with the same bits.
__device__ __forceinline__ void lane_sum2(double& a, double& b, int lanes = 32) {
  for (int o = lanes / 2; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

// Lanes per group in the finalize: all of a sample's groups in one round of
// the block's threads where they fit (ops/fused_groupnorm.py::finalize_lanes).
__device__ __forceinline__ int finalize_lanes(int groups) {
  int lanes = 32;
  while (lanes > 1 && groups * lanes > kGnThreads) lanes >>= 1;
  return lanes;
}

// Mean and 1/std of a (sample, group) from its sums of v and v^2 over
// `count` elements.
struct GnStat {
  float mean, rstd;
  __device__ __forceinline__ GnStat(double s, double s2, float count, float eps) {
    mean = (float)(s / count);
    rstd = rsqrtf((float)(s2 / count) - mean * mean + eps);
  }
  // a[i], d[i] of scale * GN(v) = v * a + d for a channel's gamma and beta
  __device__ __forceinline__ void put(float gm, float bt, float scale, float* a, float* d,
                                      size_t i) const {
    a[i] = scale * (rstd * gm);
    d[i] = scale * (bt - mean * rstd * gm);
  }
};

__device__ __forceinline__ float gn_param(const void* p, int c, bool f32) {
  return f32 ? ldf<true>(p, c) : ldf<false>(p, c);
}

struct GnStatsArgs {
  const void* x;       // (N, rows, C)
  double2* part;       // (N, G, nb) per-block (sum, sum of squares) scratch
  unsigned* ticket;    // (N,) zero before the launch; zero again after it
  const void* gamma;   // (C,)
  const void* beta;
  float* a;            // (N, C)
  float* d;
  int rows, C, G, rpb;
  float eps, scale;
  int gamma_f32;
};

template <bool F32, int VEC>
__global__ void __launch_bounds__(kGnThreads) gn_stats_kernel(GnStatsArgs p) {
  using V = GnVec<F32, VEC>;
  __shared__ float red[kGnThreads * VEC * 2];  // [rs][cc][channel][sum, sum sq]
  __shared__ bool last;
  const GnMap m(p.C, VEC, p.rows, p.rpb);
  const int n = blockIdx.y, nb = gridDim.x, warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int cg = p.C / p.G;
  using Raw = typename V::Raw;
  const Raw* xs = reinterpret_cast<const Raw*>(p.x) + (size_t)n * p.rows * m.chunks;
  for (int p0 = 0; p0 < m.chunks; p0 += m.tpr) {
    const int ch = p0 + m.cc;
    float s[VEC], q[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) s[e] = q[e] = 0.f;
    if (m.rs < m.rps && ch < m.chunks) {
      // kGnUnroll rows a step, their loads issued together; rows past the
      // block's range load zeros, which add nothing
      for (int r = m.r0 + m.rs; r < m.r1; r += kGnUnroll * m.rps) {
        Raw raw[kGnUnroll];
#pragma unroll
        for (int u = 0; u < kGnUnroll; ++u) {
          const int ru = r + u * m.rps;
          raw[u] = ru < m.r1 ? xs[(size_t)ru * m.chunks + ch] : Raw{};
        }
#pragma unroll
        for (int u = 0; u < kGnUnroll; ++u) {
          float v[VEC];
          V::unpack(raw[u], v);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            s[e] += v[e];
            q[e] = fmaf(v[e], v[e], q[e]);
          }
        }
      }
    }
    if (m.rs < m.rps) {
      float* rr = red + (size_t)(m.rs * m.tpr + m.cc) * VEC * 2;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        rr[2 * e] = s[e];
        rr[2 * e + 1] = q[e];
      }
    }
    __syncthreads();
    // a warp per group of this pass's channels [c0, c1): the channels in order,
    // each over the rps row offsets, lane-strided, then the butterfly
    const int c0 = p0 * VEC, c1 = min(m.chunks, p0 + m.tpr) * VEC;
    for (int g = c0 / cg + warp; g * cg < c1; g += kGnWarps) {
      const int lo = max(g * cg, c0), hi = min((g + 1) * cg, c1);
      double a = 0.0, b = 0.0;
      for (int i = lane; i < (hi - lo) * m.rps; i += 32) {
        const int c = lo - c0 + i / m.rps, r = i % m.rps;
        const float* e = red + ((size_t)(r * m.tpr + c / VEC) * VEC + c % VEC) * 2;
        a += e[0];
        b += e[1];
      }
      lane_sum2(a, b);
      if (lane == 0) {
        double2* pp = p.part + ((size_t)n * p.G + g) * nb + blockIdx.x;
        if (lo == g * cg) {
          *pp = make_double2(a, b);
        } else {  // the rest of a group that the previous pass began
          pp->x += a;
          pp->y += b;
        }
      }
    }
    __syncthreads();
  }

  // the sample's last block to finish: `lanes` lanes per group sum the
  // blocks' partials, lane-strided in block order, then the butterfly; every
  // group in one round where the block's threads suffice (the round's loads
  // are latency, not bytes), the samples' last blocks side by side
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(p.ticket + n, 1u) == (unsigned)(nb - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int lanes = finalize_lanes(p.G), sub = lane & (lanes - 1);
  // the loop runs alike in all lanes of a warp (the butterfly needs them all)
  for (int base = warp * (32 / lanes); base < p.G; base += kGnThreads / lanes) {
    const int g = base + lane / lanes, pair = n * p.G + g;
    const bool live = g < p.G;
    // the lane's first channel's gamma and beta, on their way while the
    // partials load; 8 partials in flight a lane
    const int c0 = g * cg + sub;
    float gm = 0.f, bt = 0.f;
    if (live && sub < cg) {
      gm = gn_param(p.gamma, c0, p.gamma_f32);
      bt = gn_param(p.beta, c0, p.gamma_f32);
    }
    double a = 0.0, b = 0.0;
    if (live) {
      const double2* pp = p.part + (size_t)pair * nb;
      int i = sub;
      for (; i + 7 * lanes < nb; i += 8 * lanes) {
        double2 v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = __ldcg(pp + i + u * lanes);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          a += v[u].x;
          b += v[u].y;
        }
      }
      for (; i < nb; i += lanes) {
        const double2 v = __ldcg(pp + i);
        a += v.x;
        b += v.y;
      }
    }
    lane_sum2(a, b, lanes);
    if (!live) continue;
    const GnStat st(a, b, (float)p.rows * (float)cg, p.eps);
    const size_t row = (size_t)n * p.C;
    for (int c = c0; c < (g + 1) * cg; c += lanes) {
      if (c != c0) {
        gm = gn_param(p.gamma, c, p.gamma_f32);
        bt = gn_param(p.beta, c, p.gamma_f32);
      }
      st.put(gm, bt, p.scale, p.a, p.d, row + c);
    }
  }
  if (threadIdx.x == 0) p.ticket[n] = 0u;
}

// The chunk width of x: 16 bytes where C allows it.
inline int gn_vec(bool f32, int C) { return f32 || C % 8 ? 4 : 8; }

// x: (N, rows, C) fp32 (f32) or bf16 -> a, d: (N, C) fp32, in one launch of
// (nb, N) blocks; nb and rpb from the caller's plan (nb * rpb covers rows, no
// block empty).
inline cudaError_t launch_gn_stats(bool f32, const GnStatsArgs& p, int N, int nb,
                                   cudaStream_t stream) {
  if (N < 1 || p.rows < 1 || p.C % 4 != 0 || p.G < 1 || p.C % p.G != 0 || nb < 1 ||
      p.rpb < 1 || (long long)nb * p.rpb < p.rows || (long long)(nb - 1) * p.rpb >= p.rows)
    return cudaErrorInvalidValue;
  const dim3 grid(nb, N);
  if (f32)
    gn_stats_kernel<true, 4><<<grid, kGnThreads, 0, stream>>>(p);
  else if (gn_vec(false, p.C) == 8)
    gn_stats_kernel<false, 8><<<grid, kGnThreads, 0, stream>>>(p);
  else
    gn_stats_kernel<false, 4><<<grid, kGnThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// part: (B, nblk, C, 2) fp32 per-(block, channel) sums -> a, d: (B, C) fp32
// with scale * GN(x) = x * a + d (gamma, beta bf16). One block per (group,
// sample): the threads take the group's nblk x C/G partials in turn, summing
// in double, then a fixed shared-memory tree adds the threads' sums.
__global__ void __launch_bounds__(kThreads)
gn_finalize_kernel(const float* __restrict__ part, const void* __restrict__ gamma,
                   const void* __restrict__ beta, float* __restrict__ a, float* __restrict__ d,
                   int nblk, int C, int groups, float count, float eps, float scale) {
  __shared__ double red[2][kThreads];
  const int g = blockIdx.x, b = blockIdx.y, cg = C / groups, tid = threadIdx.x;
  const float* pg = part + ((size_t)b * nblk * C + (size_t)g * cg) * 2;
  double s = 0.0, s2 = 0.0;
  for (int i = tid; i < nblk * cg; i += kThreads) {
    const int blk = i / cg;
    const float2 v = *reinterpret_cast<const float2*>(pg + ((size_t)blk * C + (i - blk * cg)) * 2);
    s += v.x;
    s2 += v.y;
  }
  red[0][tid] = s;
  red[1][tid] = s2;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (tid < w) {
      red[0][tid] += red[0][tid + w];
      red[1][tid] += red[1][tid + w];
    }
    __syncthreads();
  }
  const GnStat st(red[0][0], red[1][0], count, eps);
  for (int c = g * cg + tid; c < (g + 1) * cg; c += kThreads)
    st.put(gn_param(gamma, c, false), gn_param(beta, c, false), scale, a, d, (size_t)b * C + c);
}

inline cudaError_t launch_gn_finalize(const void* part, const void* gamma, const void* beta,
                                      void* a, void* d, int B, int nblk, int C, int groups,
                                      float count, float eps, float scale, cudaStream_t stream) {
  if (groups < 1 || C % groups != 0) return cudaErrorInvalidValue;
  gn_finalize_kernel<<<dim3(groups, B), kThreads, 0, stream>>>(
      (const float*)part, gamma, beta, (float*)a, (float*)d, nblk, C, groups, count, eps, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace uav
