// Attention over the T <= 16 frames of each (row, head): out[b, i, h] =
// softmax_j(q[b, i, h] . k[b, j, h] + bias[h, i, j]) @ v[b, :, h], with q
// already scaled and q/k already rotated (RoPE). Scores and softmax in fp32
// with max subtraction; the probabilities are rounded to bf16 before the
// product with v, as the plain bf16 version rounds them.
//
// Replaces upscale_a_video_tpu/ops/fused_temporal_attention.py::
// fused_temporal_attention (Pallas _kernel: 128-row packed score tiles with a
// block-diagonal bias-plus-mask map, a TPU matrix-unit layout). Here the
// attention of one (row, head) is the work of a group of lanes and needs no
// mask.
//
// Bound on this card: bytes. q, k and v are read once and out is written
// once; at T = 5 that is about 10 operations a byte, far below the ~295 at
// which the tensor cores would matter, so the math stays on the CUDA cores
// and the design is about keeping bytes in flight:
// - a (row, head) belongs to a group of L = pow2ceil(D / 8) lanes (8 at
//   D = 64, 16 at D = 128), each lane owning 8 channels: one 16-byte load
//   per frame and tensor, a group's lanes on one contiguous D * 2 bytes;
// - fta_regs_kernel<T> (T <= 8, D <= 256, every shape a path gives it)
//   issues all 3T loads of a lane before its first FMA, then forms the T x T
//   scores from 8-channel partial dot products reduced in log2(L) shuffles
//   inside the group, the softmax in registers with exp2f, and the output
//   frames as 16-byte stores;
// - a persistent grid, sized to the blocks the card holds at once, walks
//   the (row, head) groups; the other resident warps overlap one warp's
//   loads with their math;
// - the (H, T, T) bias is staged once per block in shared memory (per-head
//   stride T * T + 1, so the heads of one warp read different banks).
// fta_smem_kernel serves what the registers cannot hold (T > 8, or D > 256),
// on no path: the first design, one block per row staging its q, k and v in
// shared memory (which is what the gate's 227 KB per row bounds).
#include "common.cuh"

namespace uav {
namespace {

constexpr int kMaxT = 16;
constexpr int kRegT = 8;  // largest T whose q, k and v a lane holds in registers
constexpr float kLog2e = 1.4426950408889634f;

struct FtaArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const void* bias;  // (H, T, T) fp32 or bf16, or null
  bf16* out;
  long long groups;  // B' * H
  int T, H, D;
  int lanes_log2;  // lanes per (row, head) group
  int bias_bf16;
};

__device__ __forceinline__ float dot8(const uint4& a, const uint4& b) {
  const uint32_t* pa = reinterpret_cast<const uint32_t*>(&a);
  const uint32_t* pb = reinterpret_cast<const uint32_t*>(&b);
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(pa + e));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(pb + e));
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
  }
  return s;
}

__device__ __forceinline__ void fma8(float (&acc)[8], float p, const uint4& v) {
  const uint32_t* pv = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(pv + e));
    acc[2 * e] = fmaf(p, x.x, acc[2 * e]);
    acc[2 * e + 1] = fmaf(p, x.y, acc[2 * e + 1]);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

__device__ __forceinline__ uint4 pack8(const float (&acc)[8]) {
  return make_uint4(pack2(acc[0], acc[1]), pack2(acc[2], acc[3]), pack2(acc[4], acc[5]),
                    pack2(acc[6], acc[7]));
}

// bias[h, i, j] (zero without a bias).
__device__ __forceinline__ float bias_at(const FtaArgs& p, size_t e) {
  if (!p.bias) return 0.f;
  return p.bias_bf16 ? to_f(static_cast<const bf16*>(p.bias)[e])
                     : static_cast<const float*>(p.bias)[e];
}

// The bias of every head into shared memory, head stride T * T + 1. Ends
// with a barrier.
__device__ __forceinline__ void stage_bias(const FtaArgs& p, float* sb) {
  const int tt = p.T * p.T;
  for (int e = threadIdx.x; e < p.H * tt; e += kThreads)
    sb[(e / tt) * (tt + 1) + e % tt] = bias_at(p, e);
  __syncthreads();
}

// Scores of one query, bias added -> the bf16-rounded probabilities, in place.
template <int N>
__device__ __forceinline__ void softmax_bf(float (&s)[N], int T) {
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < T) mx = fmaxf(mx, s[j]);
  float l = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < T) {
      s[j] = exp2f((s[j] - mx) * kLog2e);
      l += s[j];
    }
  const float inv = 1.f / l;
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < T) s[j] = round_bf(s[j] * inv);
}

// Each score summed over the `lanes` lanes of its group (a butterfly).
template <int N>
__device__ __forceinline__ void group_sum(float (&s)[N], int lanes) {
  for (int o = lanes / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int j = 0; j < N; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
  }
}

// T <= 8 and D <= 256: one 8-channel chunk per lane, all frames in registers.
// The group loop runs the same number of times in every lane of a warp (the
// shuffles need the whole warp); groups past the end load zeros and store
// nothing.
template <int T>
__global__ void __launch_bounds__(kThreads) fta_regs_kernel(FtaArgs p) {
  extern __shared__ float sb[];
  stage_bias(p, sb);
  const int lanes = 1 << p.lanes_log2, per_block = kThreads >> p.lanes_log2;
  const int lane = threadIdx.x & (lanes - 1), chunks = p.D / 8;
  const size_t frame = (size_t)p.H * p.D;  // elements between two frames of one row
  const long long step = (long long)gridDim.x * per_block;
  const long long first = (long long)blockIdx.x * per_block + (threadIdx.x >> p.lanes_log2);
  const long long warp_first = first - ((threadIdx.x & 31) >> p.lanes_log2);
  for (long long g0 = warp_first; g0 < p.groups; g0 += step) {
    const long long g = g0 + (first - warp_first);
    const bool live = g < p.groups && lane < chunks;
    const int h = (int)(g % p.H);
    const size_t base = (size_t)(g / p.H) * T * frame + (size_t)h * p.D + lane * 8;
    uint4 q[T], k[T], v[T];
#pragma unroll
    for (int j = 0; j < T; ++j) {
      if (live) {
        q[j] = *reinterpret_cast<const uint4*>(p.q + base + j * frame);
        k[j] = *reinterpret_cast<const uint4*>(p.k + base + j * frame);
        v[j] = *reinterpret_cast<const uint4*>(p.v + base + j * frame);
      } else {
        q[j] = k[j] = v[j] = make_uint4(0, 0, 0, 0);
      }
    }
    const float* sbh = sb + h * (T * T + 1);
#pragma unroll
    for (int i = 0; i < T; ++i) {
      float s[T];
#pragma unroll
      for (int j = 0; j < T; ++j) s[j] = dot8(q[i], k[j]);
      group_sum(s, lanes);
#pragma unroll
      for (int j = 0; j < T; ++j) s[j] += sbh[i * T + j];
      softmax_bf(s, T);
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < T; ++j) fma8(acc, s[j], v[j]);
      if (live) *reinterpret_cast<uint4*>(p.out + base + i * frame) = pack8(acc);
    }
  }
}

// The shapes the registers cannot hold (T > 8, or D > 256): one block per row
// b' stages that row's q, k and v (3 * T * H * D bf16, contiguous) in shared
// memory with 16-byte loads; warp w then takes the (query, head) pairs w,
// w + 8, ...: lanes split D in bf16 pairs, each of the T scores a warp sum.
__global__ void __launch_bounds__(kThreads) fta_smem_kernel(FtaArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = p.T, H = p.H, D = p.D;
  const size_t n = (size_t)T * H * D;  // elements of one row of q (a multiple of 8)
  bf16* qs = (bf16*)smem;
  bf16* ks = qs + n;
  bf16* vs = ks + n;
  const size_t base = (size_t)blockIdx.x * n;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  for (size_t i = tid; i < n / 8; i += kThreads) {
    reinterpret_cast<uint4*>(qs)[i] = reinterpret_cast<const uint4*>(p.q + base)[i];
    reinterpret_cast<uint4*>(ks)[i] = reinterpret_cast<const uint4*>(p.k + base)[i];
    reinterpret_cast<uint4*>(vs)[i] = reinterpret_cast<const uint4*>(p.v + base)[i];
  }
  __syncthreads();
  const int D2 = D / 2;
  for (int task = warp; task < T * H; task += kWarps) {
    const int i = task / H, h = task - i * H;
    const __nv_bfloat162* qr =
        reinterpret_cast<const __nv_bfloat162*>(qs + ((size_t)i * H + h) * D);
    float sc[kMaxT];
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
        sc[j] = warp_sum(part) + bias_at(p, ((size_t)h * T + i) * T + j);
      }
    }
    softmax_bf(sc, T);
    __nv_bfloat162* orow =
        reinterpret_cast<__nv_bfloat162*>(p.out + base + ((size_t)i * H + h) * D);
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

// fta_regs_kernel<T> on the persistent grid: as many blocks as the card
// holds at once, no more than the groups need (the shared-memory limit set
// and the card asked once per shared-memory size: host time per call).
template <int T>
int launch_regs(const FtaArgs& p, cudaStream_t stream) {
  static size_t fill_smem = 0;
  static int fill = 0;
  const size_t smem = (size_t)p.H * (T * T + 1) * sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (fill == 0 || fill_smem != smem) {
    UAV_RETURN_IF(set_smem(fta_regs_kernel<T>, smem));
    int dev = 0, sms = 0, per_sm = 0;
    UAV_RETURN_IF(cudaGetDevice(&dev));
    UAV_RETURN_IF(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
    UAV_RETURN_IF(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fta_regs_kernel<T>, kThreads, smem));
    fill = sms * (per_sm > 0 ? per_sm : 1);
    fill_smem = smem;
  }
  const long long per_block = kThreads >> p.lanes_log2;
  const long long want = (p.groups + per_block - 1) / per_block;
  fta_regs_kernel<T><<<(int)(want < fill ? want : fill), kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace uav

using namespace uav;

// q, k, v, out: (Bp, T, H, D) bf16, contiguous, 16-byte aligned; bias: (H, T, T)
// fp32 (bias_bf16 == 0) or bf16, or null. T <= 16, D % 16 == 0, q/k/v of one
// row within 227 KB where T > 8 or D > 256; lanes_log2 =
// log2 of the lanes per (row, head) (ops/fused_temporal_attention.py::
// group_lanes), which the call refuses if it disagrees.
extern "C" int uav_fused_temporal_attention(const void* q, const void* k, const void* v,
                                            const void* bias, void* out, int Bp, int T, int H,
                                            int D, int bias_bf16, int lanes_log2, void* stream) {
  if (Bp < 1 || T < 1 || T > kMaxT || H < 1 || D < 16 || D % 16 != 0)
    return (int)cudaErrorInvalidValue;
  int want = 0;
  while ((8 << want) < D && want < 5) ++want;
  if (lanes_log2 != want) return (int)cudaErrorInvalidValue;
  const FtaArgs p{(const bf16*)q, (const bf16*)k, (const bf16*)v, bias, (bf16*)out,
                  (long long)Bp * H, T, H, D, lanes_log2, bias_bf16};
  const cudaStream_t st = (cudaStream_t)stream;
  if (D > 256 || T > kRegT) {
    const size_t smem = (size_t)3 * T * H * D * 2;
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    UAV_RETURN_IF(set_smem(fta_smem_kernel, smem));
    fta_smem_kernel<<<Bp, kThreads, smem, st>>>(p);
    return (int)cudaGetLastError();
  }
  switch (T) {
    case 1: return launch_regs<1>(p, st);
    case 2: return launch_regs<2>(p, st);
    case 3: return launch_regs<3>(p, st);
    case 4: return launch_regs<4>(p, st);
    case 5: return launch_regs<5>(p, st);
    case 6: return launch_regs<6>(p, st);
    case 7: return launch_regs<7>(p, st);
    default: return launch_regs<8>(p, st);
  }
}
