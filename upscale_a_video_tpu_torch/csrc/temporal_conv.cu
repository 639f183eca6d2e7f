// SAME-T (k,1,1) temporal convolution with bias on channels-last bf16 video,
// out[b, t] = bias + sum_i x[b, t + i - (k-1)/2] @ W_i, taps outside [0, T) skipped.
//
// Replaces upscale_a_video_tpu/ops/temporal_conv.py::temporal_conv (Pallas
// _kernel: K frame-shifted (R, Cin) @ (Cin, Cout) GEMMs over row blocks, the
// out-of-range taps masked by a scalar factor). Bound on this card:
// operations (2 * Cin * Cout per valid tap and output element; at the UNet's
// widths about 100x the bytes).
//
// Design: an implicit GEMM, M = the pixel rows of one (b, t) frame, N = Cout,
// K = (valid taps) x Cin. A tile is BM rows of one frame x BN output
// channels, so its valid tap range [max(0, pad - t), min(k, T + pad - t)) is
// one range for the whole tile and taps outside it are skipped, not
// multiplied by zero. Tiles are 128 x 256 (the two consumer warpgroups take
// 64 rows each, wgmma m64n256k16), or 64 x 128 (the warpgroups split the
// channels, m64n64k16) for frames of at most 64 pixels, which then multiply
// no rows of zero fill, and for calls with fewer 128 x 256 tiles than SMs,
// which then get four times the tiles. Both
// operands come by TMA in 64-channel slices into a 4-stage ring of
// 128-byte-swizzled shared memory guarded by mbarriers: the A slice from x
// viewed as (B*T, HW, Cin) at frame b*T + t + i - pad, the B slice from the
// tap-major weights (k, Cout, Cin). Rows past HW and columns past Cin or
// Cout are TMA's zero fill, so ragged frames (HW = 240) need no padding. One
// producer warp issues the loads; the two consumer warpgroups run wgmma from
// shared memory with fp32 accumulators in registers, keeping one group of
// products in flight. The epilogue adds the bias, rounds to bf16 and stores
// with the rows past HW masked. The grid is persistent (one block per SM
// walks tiles n-fastest), so one tile's epilogue overlaps the next tile's
// first loads.
//
// Room for the temporal resblock: its GroupNorm-affine + SiLU prologue goes
// between the A slice's arrival and the products (a shared -> register pass
// feeding wgmma's register-A form), its temb / residual / GroupNorm-partial
// epilogue beside the bias. Not added here: the resblock keeps its own conv
// (temporal_conv.cuh).
#include "hopper.cuh"

namespace uav {
namespace {

constexpr int kBK = 64;        // input channels per stage: one 128-byte swizzled row
constexpr int kStages = 4;
constexpr int kConsumers = 2;  // warpgroups
constexpr int kConvThreads = 128 * kConsumers + 32;  // and one producer warp

template <int BM, int BN>
struct ConvTile {
  static constexpr int kWN = BM == 128 ? BN : BN / 2;  // channels of one warpgroup
  static constexpr uint32_t kABytes = BM * kBK * 2;
  static constexpr uint32_t kBBytes = BN * kBK * 2;
  static constexpr size_t kSmem = 1024 + kStages * (kABytes + kBBytes) + 2 * kStages * 8;
};

struct ConvShape {
  int T, HW, Cout, K, m_tiles, n_tiles, k_chunks, tiles;
};

struct Tile {
  int f, m0, n0, lo, hi;  // frame b*T + t, first row, first channel, valid taps [lo, hi)
};

template <int BM, int BN>
__device__ __forceinline__ Tile tile_at(const ConvShape& s, int idx) {
  Tile tl;
  const int rest = idx / s.n_tiles;
  tl.n0 = (idx - rest * s.n_tiles) * BN;
  tl.f = rest / s.m_tiles;
  tl.m0 = (rest - tl.f * s.m_tiles) * BM;
  const int t = tl.f % s.T, pad = (s.K - 1) / 2;
  tl.lo = max(0, pad - t);
  tl.hi = min(s.K, s.T + pad - t);
  return tl;
}

template <int BM, int BN>
__global__ void __launch_bounds__(kConvThreads, 1)
tconv_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap, const bf16* __restrict__ bias,
                   bf16* __restrict__ out, const ConvShape s) {
  using C = ConvTile<BM, BN>;
  constexpr uint32_t kABytes = C::kABytes, kBBytes = C::kBBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* a_s = (unsigned char*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  unsigned char* b_s = a_s + kStages * kABytes;
  uint64_t* full = (uint64_t*)(b_s + kStages * kBBytes);
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x / 128;
  const int pad = (s.K - 1) / 2;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers * 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {  // producer warp: one thread issues every load
    if (threadIdx.x == kConsumers * 128) {
      int it = 0;
      for (int idx = blockIdx.x; idx < s.tiles; idx += gridDim.x) {
        const Tile tl = tile_at<BM, BN>(s, idx);
        for (int i = tl.lo; i < tl.hi; ++i) {
          for (int kc = 0; kc < s.k_chunks; ++kc, ++it) {
            const int st = it % kStages;
            mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
            mbar_expect_tx(&full[st], kABytes + kBBytes);
            tma_load_3d(a_s + st * kABytes, &xmap, &full[st], kc * kBK, tl.m0, tl.f + i - pad);
            tma_load_3d(b_s + st * kBBytes, &wmap, &full[st], kc * kBK, tl.n0, i);
          }
        }
      }
    }
  } else {  // consumer warpgroups
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int row_off = BM == 128 ? wg * 64 : 0;    // this warpgroup's rows of the tile
    const int col_off = BM == 128 ? 0 : wg * C::kWN;  // and its channels
    const uint64_t da0 = sw128_desc(a_s + row_off * 128, 16, 1024);
    const uint64_t db0 = sw128_desc(b_s + col_off * 128, 16, 1024);
    float acc[C::kWN / 2];
    int it = 0;
    for (int idx = blockIdx.x; idx < s.tiles; idx += gridDim.x) {
      const Tile tl = tile_at<BM, BN>(s, idx);
      const int nk = (tl.hi - tl.lo) * s.k_chunks;
      for (int step = 0; step < nk; ++step, ++it) {
        const int st = it % kStages;
        mbar_wait(&full[st], (it / kStages) & 1);
        const uint64_t da = opaque(da0 + st * (kABytes >> 4));
        const uint64_t db = opaque(db0 + st * (kBBytes >> 4));
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kBK / 16; ++k)
          Wgmma<C::kWN>::ss(acc, da + 2 * k, db + 2 * k, (step > 0 || k > 0) ? 1 : 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's products are done: release its stage
        if (step > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);

      const int r0 = tl.m0 + row_off + warp * 16 + lane / 4;
      bf16* ob = out + (size_t)tl.f * s.HW * s.Cout;
#pragma unroll
      for (int j = 0; j < C::kWN / 8; ++j) {
        const int col = tl.n0 + col_off + j * 8 + (lane % 4) * 2;
        if (col < s.Cout) {
          const float b0 = bias ? to_f(bias[col]) : 0.f, b1 = bias ? to_f(bias[col + 1]) : 0.f;
          if (r0 < s.HW)
            *(__nv_bfloat162*)(ob + (size_t)r0 * s.Cout + col) =
                __floats2bfloat162_rn(acc[4 * j] + b0, acc[4 * j + 1] + b1);
          if (r0 + 8 < s.HW)
            *(__nv_bfloat162*)(ob + (size_t)(r0 + 8) * s.Cout + col) =
                __floats2bfloat162_rn(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
        }
      }
    }
  }
}

template <int BM, int BN>
int launch_tconv_wgmma(const void* x, const void* w, int K, const void* bias, void* out, int B,
                       int T, int HW, int Cin, int Cout, cudaStream_t stream) {
  using C = ConvTile<BM, BN>;
  CUtensorMap xmap, wmap;
  int e = make_map_3d(&xmap, x, Cin, HW, (uint64_t)B * T, (uint64_t)Cin * 2,
                      (uint64_t)HW * Cin * 2, BM);
  if (e) return e;
  e = make_map_3d(&wmap, w, Cin, Cout, K, (uint64_t)Cin * 2, (uint64_t)Cout * Cin * 2, BN);
  if (e) return e;
  ConvShape s;
  s.T = T;
  s.HW = HW;
  s.Cout = Cout;
  s.K = K;
  s.m_tiles = (HW + BM - 1) / BM;
  s.n_tiles = (Cout + BN - 1) / BN;
  s.k_chunks = (Cin + kBK - 1) / kBK;
  s.tiles = B * T * s.m_tiles * s.n_tiles;
  UAV_RETURN_IF(set_smem(tconv_wgmma_kernel<BM, BN>, C::kSmem));
  const int grid = s.tiles < sm_count() ? s.tiles : sm_count();
  tconv_wgmma_kernel<BM, BN><<<grid, kConvThreads, C::kSmem, stream>>>(
      xmap, wmap, (const bf16*)bias, (bf16*)out, s);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace uav

using namespace uav;

// x: (B, T, HW, Cin) bf16; w: (K, Cout, Cin) bf16, tap major; bias: (Cout,) bf16
// or null; out: (B, T, HW, Cout) bf16. Cin and Cout multiples of 16, K odd,
// x and w 16-byte aligned.
extern "C" int uav_temporal_conv_bias(const void* x, const void* w, int K, const void* bias,
                                      void* out, int B, int T, int HW, int Cin, int Cout,
                                      void* stream) {
  if (B < 1 || T < 1 || HW < 1 || K % 2 != 1 || Cin % 16 != 0 || Cout % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int big_tiles = B * T * ((HW + 127) / 128) * ((Cout + 255) / 256);
  if (HW <= 64 || big_tiles < sm_count())
    return launch_tconv_wgmma<64, 128>(x, w, K, bias, out, B, T, HW, Cin, Cout, st);
  return launch_tconv_wgmma<128, 256>(x, w, K, bias, out, B, T, HW, Cin, Cout, st);
}
