// The GEMM core of the port's TMA + wgmma matrix kernels: the temporal conv
// (temporal_conv.cu), the temporal resblock's two convs
// (fused_temporal_resblock.cu), the feed-forward's two products
// (fused_feedforward.cu) and the temporal attention block's two
// (temporal_attention_block.cu).
//
// The problem is a SAME-T (k,1,1) temporal convolution on channels-last bf16
// rows, out[f] = sum_i A[f + i - pad] @ W_i^T for the frames f = b*T + t of
// A (frames, HW, Cin), W tap-major (k, Cout, Cin), the taps that fall outside
// [0, T) skipped. A plain (M, K) x (N, K)^T product is the case k = 1, T = 1,
// one frame of M rows.
//
// Design: an implicit GEMM, M = the pixel rows of one frame, N = Cout,
// K = (valid taps) x Cin. A tile is BM rows of one frame x BN output
// channels, so its valid tap range [max(0, pad - t), min(k, T + pad - t)) is
// one range for the whole tile and taps outside it are skipped, not
// multiplied by zero. Tiles are 128 x BN (the two consumer warpgroups take
// 64 rows each, wgmma m64nBNk16), or 64 x 128 (the warpgroups split the
// channels, m64n64k16) for frames of at most 64 pixels, which then multiply
// no rows of zero fill, and for calls with fewer big tiles than SMs, which
// then get four times the tiles; the caller picks. Both operands come by TMA
// in 64-channel slices into a 4-stage ring of 128-byte-swizzled shared
// memory guarded by mbarriers: the A slice from frame f + i - pad, the B
// slice from tap i. Rows past HW and columns past Cin or Cout are TMA's zero
// fill, so ragged frames need no padding. One producer warp issues the
// loads (with the prologue, consumer thread 0 does: see gemm_threads); the
// two consumer warpgroups run wgmma with fp32 accumulators in registers.
// The grid is persistent (one block per SM walks tiles n-fastest), so one
// tile's epilogue overlaps the next tile's first loads.
//
// Policies, members of the Epi class the kernel is templated on:
//   kPrologue  A goes through silu(2 (A * a + d)), a and d per (sample,
//              input channel) in fp32 and halved, on its way from the ring
//              to registers: each consumer reads its 64 x 16 slices with
//              ldmatrix on the swizzled addresses, applies the affine, rounds
//              to bf16 (the GroupNorm's output), applies SiLU in fp32, packs
//              to bf16 and issues the register-A wgmma, the prologue of one
//              half of a stage overlapping the other half's products.
//              Without it both operands stay in shared memory and one group
//              of products is kept in flight.
//   kGeglu     B is loaded as pairs of half-width boxes, rows n0/2 + j of the
//              first half of W and Cout/2 + n0/2 + j of the second, so each
//              thread holds h and g of the same output column (the
//              feed-forward's h * gelu(g)); each warpgroup's WN columns are
//              WN/2 of h, then WN/2 of g.
//   kBParts    (optional, 1 if absent) B is loaded as kBParts boxes of
//              BN / kBParts rows, rows p * Cout / kBParts + n0 / kBParts + j
//              of W for part p: the tile's columns are the same columns of
//              each part (the temporal attention block's q, k and v of one
//              head).
//   kPixelTiles (optional, false if absent) a tile is BM / T pixels of all T
//              frames of one sample, one TMA box of 64 x BM/T x T, frame-major
//              rows (the temporal attention block's frame attention needs all
//              frames of a pixel); tl.f is the sample's first frame, tl.m0 its
//              first pixel. k must be 1.
//   kSmem      bytes of shared scratch the epilogue uses.
//   prologue(b, a, d)  the sample's affine (kPrologue only).
//   operator()         the epilogue: each consumer thread's kWN / 2
//              accumulators and where they sit (Frag); rows past HW must not
//              be stored. It may synchronise the 256 consumer threads (named
//              barrier 1): every consumer walks the same tiles.
#pragma once

#include <type_traits>

#include "hopper.cuh"

namespace uav {
namespace {

constexpr int kBK = 64;        // input channels per stage: one 128-byte swizzled row
constexpr int kConsumers = 2;  // warpgroups

// The optional policies of an Epi class (see above), with their defaults.
template <class E, class = void>
struct BParts {
  static constexpr int value = 1;
};
template <class E>
struct BParts<E, std::void_t<decltype(E::kBParts)>> {
  static constexpr int value = E::kBParts;
};
template <class E, class = void>
struct PixelTiles {
  static constexpr bool value = false;
};
template <class E>
struct PixelTiles<E, std::void_t<decltype(E::kPixelTiles)>> {
  static constexpr bool value = E::kPixelTiles;
};

// Threads of a block: the two consumer warpgroups, and one producer warp
// unless the A operand goes through the prologue. ptxas sizes a block for
// its count at entry, per four warps: with a producer warp a thread gets 168
// registers, which the register-A products (128 accumulators, 16 A
// registers) exceed, and it then spills and serialises the wgmmas; without
// one it gets 255, and consumer thread 0 issues the loads.
template <class Epi>
constexpr int gemm_threads() {
  return 128 * kConsumers + (Epi::kPrologue ? 0 : 32);
}

template <int BM, int BN>
struct GemmTile {
  static constexpr int kWN = BM == 128 ? BN : BN / 2;  // channels of one warpgroup
  static constexpr uint32_t kABytes = BM * kBK * 2;
  static constexpr uint32_t kBBytes = BN * kBK * 2;
  // four stages, or three where four would leave an epilogue too little room
  static constexpr int kStages = 4 * (kABytes + kBBytes) <= 200 * 1024 ? 4 : 3;
  static constexpr size_t kRing = 1024 + kStages * (kABytes + kBBytes) + 2 * kStages * 8;
};

struct ConvShape {
  int T, HW, Cin, Cout, K, m_tiles, n_tiles, k_chunks, tiles;
  int mrows, fstep;  // rows of a frame per tile, frames per tile step (1, or T: pixel tiles)
};

struct Tile {
  int f, m0, n0, lo, hi;  // frame b*T + t, first row, first channel, valid taps [lo, hi)
};

// Where a consumer thread's accumulators sit: acc[4j + e] is tile row
// row + 8 (e / 2), tile column col_off + 8j + quad + e % 2.
struct Frag {
  int row, col_off, quad;
  int slot;  // consumer warp 0..7
  int lane;
  int bm, bn, wn;  // the tile, and the columns of one warpgroup
};

template <int BM, int BN>
__device__ __forceinline__ Tile tile_at(const ConvShape& s, int idx) {
  Tile tl;
  const int rest = idx / s.n_tiles;
  tl.n0 = (idx - rest * s.n_tiles) * BN;
  tl.f = rest / s.m_tiles;
  tl.m0 = (rest - tl.f * s.m_tiles) * s.mrows;
  tl.f *= s.fstep;
  const int t = tl.f % s.T, pad = (s.K - 1) / 2;
  tl.lo = max(0, pad - t);
  tl.hi = min(s.K, s.T + pad - t);
  return tl;
}

// The block's walk over its loads: tiles blockIdx.x, + gridDim.x, ..., each
// over its valid taps x input-channel slices. n counts the loads issued.
template <int BM, int BN>
struct LoadCursor {
  Tile tl;
  int idx, i, kc, n;
  bool more;

  __device__ __forceinline__ void start(const ConvShape& s) {
    idx = blockIdx.x;
    n = 0;
    more = idx < s.tiles;
    if (more) begin_tile(s);
  }
  __device__ __forceinline__ void begin_tile(const ConvShape& s) {
    tl = tile_at<BM, BN>(s, idx);
    i = tl.lo;
    kc = 0;
  }
  __device__ __forceinline__ void advance(const ConvShape& s) {
    ++n;
    if (++kc < s.k_chunks) return;
    kc = 0;
    if (++i < tl.hi) return;
    idx += gridDim.x;
    more = idx < s.tiles;
    if (more) begin_tile(s);
  }
};

// Issue the cursor's load into its ring stage, once the consumers have
// released the stage, and move the cursor on.
template <int BM, int BN, class Epi>
__device__ __forceinline__ void issue_load(LoadCursor<BM, BN>& c, const ConvShape& s,
                                           const CUtensorMap* amap, const CUtensorMap* bmap,
                                           unsigned char* a_s, unsigned char* b_s,
                                           uint64_t* full, uint64_t* empty) {
  using G = GemmTile<BM, BN>;
  constexpr int kStages = G::kStages, kParts = BParts<Epi>::value;
  const int st = c.n % kStages;
  mbar_wait(&empty[st], ((c.n / kStages) & 1) ^ 1);
  mbar_expect_tx(&full[st], G::kABytes + G::kBBytes);
  tma_load_3d(a_s + st * G::kABytes, amap, &full[st], c.kc * kBK, c.tl.m0,
              c.tl.f + c.i - (s.K - 1) / 2);
  unsigned char* b_dst = b_s + st * G::kBBytes;
  if constexpr (Epi::kGeglu) {
    constexpr int kWN = G::kWN, kH = kWN / 2;  // one box: kH rows of h or of g
#pragma unroll
    for (int sl = 0; sl < BN / kWN; ++sl) {
      const int row = c.tl.n0 / 2 + sl * kH;
      tma_load_3d(b_dst + sl * kWN * 128, bmap, &full[st], c.kc * kBK, row, c.i);
      tma_load_3d(b_dst + (sl * kWN + kH) * 128, bmap, &full[st], c.kc * kBK, s.Cout / 2 + row,
                  c.i);
    }
  } else if constexpr (kParts > 1) {
    constexpr int kR = BN / kParts;
#pragma unroll
    for (int p = 0; p < kParts; ++p)
      tma_load_3d(b_dst + p * kR * 128, bmap, &full[st], c.kc * kBK,
                  p * (s.Cout / kParts) + c.tl.n0 / kParts, c.i);
  } else {
    tma_load_3d(b_dst, bmap, &full[st], c.kc * kBK, c.tl.n0, c.i);
  }
  c.advance(s);
}

// silu(bf16(x * a + d)) of the two bf16 in v, packed back to bf16, given
// a / 2 and d / 2: silu(y) = y * sigmoid(y) = h + h * tanh(h) with h = y / 2,
// and halving commutes with the rounding.
__device__ __forceinline__ uint32_t silu_affine2(uint32_t v, float2 a, float2 d) {
  const float2 x = unpack_bf16(v);
  const float2 h = unpack_bf16(pack_bf16(fmaf(x.x, a.x, d.x), fmaf(x.y, a.y, d.y)));
  return pack_bf16(fmaf(h.x, tanh_fast(h.x), h.x), fmaf(h.y, tanh_fast(h.y), h.y));
}

// The prologue of 16 input channels: the lane's A fragment of one 64 x 16
// slice, read from the swizzled ring, through silu_affine2. ah and dh point
// at the channel pair of the fragment's first two columns.
__device__ __forceinline__ void prologue_slice(uint32_t (&af)[4], uint32_t addr, const float* ah,
                                               const float* dh) {
  ldmatrix_x4(af, addr);
  const float2 a_lo = __ldg((const float2*)ah), a_hi = __ldg((const float2*)(ah + 8));
  const float2 d_lo = __ldg((const float2*)dh), d_hi = __ldg((const float2*)(dh + 8));
  af[0] = silu_affine2(af[0], a_lo, d_lo);
  af[1] = silu_affine2(af[1], a_lo, d_lo);
  af[2] = silu_affine2(af[2], a_hi, d_hi);
  af[3] = silu_affine2(af[3], a_hi, d_hi);
}

template <int BM, int BN, class Epi>
__global__ void __launch_bounds__(gemm_threads<Epi>(), 1)
gemm_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
            const Epi epi, const ConvShape s) {
  using G = GemmTile<BM, BN>;
  constexpr uint32_t kABytes = G::kABytes, kBBytes = G::kBBytes;
  constexpr int kWN = G::kWN, kStages = G::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* a_s = (unsigned char*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  unsigned char* b_s = a_s + kStages * kABytes;
  uint64_t* full = (uint64_t*)(b_s + kStages * kBBytes);
  uint64_t* empty = full + kStages;
  unsigned char* scratch = (unsigned char*)(empty + kStages);
  const int wg = threadIdx.x / 128;

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
      LoadCursor<BM, BN> c;
      for (c.start(s); c.more;)
        issue_load<BM, BN, Epi>(c, s, &amap, &bmap, a_s, b_s, full, empty);
    }
    return;
  }

  // consumer warpgroups
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int row_off = BM == 128 ? wg * 64 : 0;  // this warpgroup's rows of the tile
  const int col_off = BM == 128 ? 0 : wg * kWN;  // and its channels
  const uint64_t da0 = sw128_desc(a_s + row_off * 128, 16, 1024);
  const uint64_t db0 = sw128_desc(b_s + col_off * 128, 16, 1024);
  const Frag fr{row_off + warp * 16 + lane / 4, col_off, 2 * (lane % 4), wg * 4 + warp, lane,
                BM, BN, kWN};
  // ldmatrix rows of this lane (the prologue): matrices 0-3 are rows 0-7 and
  // 8-15 of the warp's 16, at k 0-7, then the same rows at k 8-15
  const int ldm_r = row_off + warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t ldm_base = smem_u32(a_s) + ldm_r * 128;
  const int ldm_k = lane >> 4, ldm_sw = lane & 7;
  int it = 0;
  const bool loader = Epi::kPrologue && threadIdx.x == 0;
  LoadCursor<BM, BN> ld;
  if (loader) ld.start(s);
  for (int idx = blockIdx.x; idx < s.tiles; idx += gridDim.x) {
    const Tile tl = tile_at<BM, BN>(s, idx);
    const int nk = (tl.hi - tl.lo) * s.k_chunks;
    // per tile, so that the accumulators are dead once the epilogue has read
    // them (the wgmma operands are read-write: one array across tiles would
    // stay live through every epilogue)
    float acc[kWN / 2];
#pragma unroll
    for (int i = 0; i < kWN / 2; ++i) acc[i] = 0.f;
    if constexpr (Epi::kPrologue) {
      // no producer warp: thread 0 keeps the ring filled, one step behind the
      // products so that both warpgroups have released the stage it refills
      if (loader && idx == blockIdx.x)
        while (ld.more && ld.n < kStages)
          issue_load<BM, BN, Epi>(ld, s, &amap, &bmap, a_s, b_s, full, empty);
      const float *av, *dv;
      epi.prologue(tl.f / s.T, av, dv);
      av += fr.quad;
      dv += fr.quad;
      // Each step runs as two halves of 32 channels, A registers af[0] for
      // the first and af[1] for the second: the prologue of one half runs
      // while the other half's products are in flight, and a half's
      // registers are written again only after its products are done.
      int kc = 0;
      uint32_t af[2][2][4];
      for (int step = 0; step < nk; ++step, ++it) {
        const int st = it % kStages;
        const float* ap = av + kc * kBK;
        const float* dp = dv + kc * kBK;
        const uint32_t abase = ldm_base + st * kABytes;
        const uint64_t db = opaque(db0 + st * (kBBytes >> 4));
        mbar_wait(&full[st], (it / kStages) & 1);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int kk = 2 * half + q;
            prologue_slice(af[half][q], abase + (((2 * kk + ldm_k) ^ ldm_sw) << 4), ap + kk * 16,
                           dp + kk * 16);
          }
          wgmma_fence();
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int kk = 2 * half + q;
            Wgmma<kWN>::template rs<0>(acc, af[half][q], db + 2 * kk,
                                       (step > 0 || kk > 0) ? 1 : 0);
          }
          wgmma_commit();
          wgmma_wait<1>();  // the other half's products are done
          fence_regs(af[half ^ 1]);
          if (half == 0 && step > 0) {  // the previous step's stage is free
            if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
            if (loader && ld.more && ld.n <= it + kStages - 1)
              issue_load<BM, BN, Epi>(ld, s, &amap, &bmap, a_s, b_s, full, empty);
          }
        }
        if (++kc == s.k_chunks) kc = 0;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
      if (loader && ld.more && ld.n <= it + kStages - 1)
        issue_load<BM, BN, Epi>(ld, s, &amap, &bmap, a_s, b_s, full, empty);
    } else {
      for (int step = 0; step < nk; ++step, ++it) {
        const int st = it % kStages;
        mbar_wait(&full[st], (it / kStages) & 1);
        const uint64_t da = opaque(da0 + st * (kABytes >> 4));
        const uint64_t db = opaque(db0 + st * (kBBytes >> 4));
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kBK / 16; ++k)
          Wgmma<kWN>::ss(acc, da + 2 * k, db + 2 * k, (step > 0 || k > 0) ? 1 : 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's products are done: release its stage
        if (step > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
    }
    epi(s, tl, acc, fr, scratch);
  }
}

// A: (frames, HW, Cin) bf16; B: (K, Cout, Cin) bf16, tap major; both
// 16-byte aligned with Cin a multiple of 8. frames = batch * T.
// With kPixelTiles, T must divide BM and K be 1.
template <int BM, int BN, class Epi>
int launch_gemm(const void* a, const void* b, int frames, int T, int HW, int Cin, int Cout, int K,
                const Epi& epi, cudaStream_t stream) {
  using G = GemmTile<BM, BN>;
  constexpr bool kPixels = PixelTiles<Epi>::value;
  const int depth = kPixels ? T : 1, mrows = BM / depth;
  CUtensorMap amap, bmap;
  int e = make_map_3d(&amap, a, Cin, HW, frames, (uint64_t)Cin * 2, (uint64_t)HW * Cin * 2, mrows,
                      depth);
  if (e) return e;
  e = make_map_3d(&bmap, b, Cin, Cout, K, (uint64_t)Cin * 2, (uint64_t)Cout * Cin * 2,
                  Epi::kGeglu ? G::kWN / 2 : BN / BParts<Epi>::value);
  if (e) return e;
  ConvShape s;
  s.T = T;
  s.HW = HW;
  s.Cin = Cin;
  s.Cout = Cout;
  s.K = K;
  s.mrows = mrows;
  s.fstep = depth;
  s.m_tiles = (HW + mrows - 1) / mrows;
  s.n_tiles = (Cout + BN - 1) / BN;
  s.k_chunks = (Cin + kBK - 1) / kBK;
  s.tiles = frames / depth * s.m_tiles * s.n_tiles;
  const size_t smem = G::kRing + Epi::kSmem;
  UAV_RETURN_IF(set_smem(gemm_kernel<BM, BN, Epi>, smem));
  const int grid = s.tiles < sm_count() ? s.tiles : sm_count();
  gemm_kernel<BM, BN, Epi><<<grid, gemm_threads<Epi>(), smem, stream>>>(amap, bmap, epi, s);
  return (int)cudaGetLastError();
}

// The plain epilogue: out = acc + bias (+ res), rounded once to bf16, rows
// past HW masked; bias and res may be null. out and res: (frames, HW, Cout).
// The bias and residual of four column groups are loaded before any of
// their stores: a store could alias a later load, so loads placed between
// stores would each wait out the one before (four: more spill at 128 x 256
// under the producer warp's 168 registers).
struct BiasEpilogue {
  static constexpr bool kPrologue = false, kGeglu = false;
  static constexpr size_t kSmem = 0;
  const bf16* bias;
  const bf16* res;
  bf16* out;

  template <int NA>
  __device__ __forceinline__ void operator()(const ConvShape& s, const Tile& tl,
                                             float (&acc)[NA], const Frag& fr,
                                             unsigned char*) const {
    constexpr int kJ = NA / 4, kChunk = 4;
    const int r0 = tl.m0 + fr.row;
    const size_t base = (size_t)tl.f * s.HW * s.Cout;
#pragma unroll
    for (int j0 = 0; j0 < kJ; j0 += kChunk) {
      uint32_t bv[kChunk], xv[kChunk][2];  // bf16 pairs
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int col = tl.n0 + fr.col_off + (j0 + jj) * 8 + fr.quad;
        const bool ok = col < s.Cout;
        bv[jj] = bias && ok ? *(const uint32_t*)(bias + col) : 0u;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          xv[jj][h] = res && ok && r < s.HW
                          ? *(const uint32_t*)(res + base + (size_t)r * s.Cout + col)
                          : 0u;
        }
      }
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = j0 + jj;
        const int col = tl.n0 + fr.col_off + j * 8 + fr.quad;
        if (col < s.Cout) {
          const float2 b = unpack_bf16(bv[jj]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h;
            if (r < s.HW) {
              const float2 x = unpack_bf16(xv[jj][h]);
              *(__nv_bfloat162*)(out + base + (size_t)r * s.Cout + col) = __floats2bfloat162_rn(
                  acc[4 * j + 2 * h] + b.x + x.x, acc[4 * j + 2 * h + 1] + b.y + x.y);
            }
          }
        }
      }
    }
  }
};

// The tile rule: 64 x 128 tiles for frames of at most 64 pixels or when
// fewer big tiles (128 x big_bn) than SMs would cover the output. The
// resblock's wrapper repeats it (ops/temporal_conv.py::conv_tile) to size
// the per-tile GroupNorm partials, and the kernel refuses a disagreement.
inline bool small_tiles(int frames, int HW, int Cout, int big_bn) {
  const long long big = (long long)frames * ((HW + 127) / 128) * ((Cout + big_bn - 1) / big_bn);
  return HW <= 64 || big < sm_count();
}

}  // namespace
}  // namespace uav
