// Tiled online-softmax attention with fp32 operands, no bias, head_dim 256 or
// 512 (the wrapper zero-pads narrower heads), both products on the tensor
// cores as three TF32 products each (3xTF32).
//
// Replaces upscale_a_video_tpu/ops/flash_attention.py::flash_attention (the
// Pallas _flash_kernel) where it runs with fp32 q, k and v: the VAE's
// mid-block attention under --decode_attn fp32 (JAX UAV_VAE_ATTN_F32). That
// kernel is dtype-generic, so with fp32 operands both of its products and p
// stay in fp32. Here each fp32 operand x is split into two TF32 words, hi =
// x rounded to TF32 (cvt.rna) and lo = (x - hi) rounded to TF32, and a
// product a*b runs as a_hi*b_hi + a_hi*b_lo + a_lo*b_hi on TF32 wgmma: about
// 2^-21 of a product off, where one TF32 product is 2^-11 off (and fails the
// 1e-4 gate the port holds this kernel to). The scores never reach device
// memory; the running max m, the running sum l and the output accumulator
// stay in fp32; keys past Sk are masked to -inf.
//
// Bound on this card: operations. Three TF32 products per product make the
// least time 3 * 4*Sq*Sk*D per head at the dense TF32 rate (495 TFLOP/s),
// i.e. 165 TFLOP/s of fp32 work (against 67 for FFMA on the CUDA cores); the
// bytes (each input read once) are far below it at every shape it serves.
//
// Design. A block owns 64 query rows and 256 columns of D: at D = 512 the two
// halves of D run on a cluster of two blocks (one per SM), because 64 rows of
// fp32 Q, the hi and lo parts of a K and a V tile and the 64 x 512 output
// accumulator do not fit one SM. Each block's partial scores (its half of the
// sum over D) go to the other block's shared memory (st.async, counted in the
// bytes of its mbarrier) and both blocks add the same two partials, so both
// take the same softmax.
// - Warpgroup 0 computes; warpgroup 1 feeds it. One thread of warpgroup 1
//   loads 32-key tiles of K (32 keys x 256 columns) and of the value layout
//   (256 columns x 32 keys) by TMA into 128-byte-swizzled shared memory (one
//   buffer each: K of the next tile loads while this tile's softmax and P V
//   run, V while S runs). Warpgroup 1 then splits each tile in place: the
//   fp32 words become hi, and lo goes to a twin buffer at the same offsets.
// - The tensor core rounds toward zero when it adds into its accumulators,
//   so a long sum in one accumulator drifts (over 15360 keys, O by about 1e-4
//   of its largest value). Every sum on wgmma is therefore short and starts
//   from zero, and the sums are added in registers in fp32: S as two sums of
//   128 columns, P V as one sum per tile and 128 columns.
// - S = Q K^T: Q (64 x 256 fp32, loaded once, stored in the order of the
//   tf32 register fragments) is the register-A operand, split into hi and lo
//   in registers at each 8-column k-step; K hi and lo are the B operands.
//   Two k-steps run per batch, the registers of two batches alternating, the
//   next batch's fragments loading while this one's products run.
// - softmax in registers (a row's max and sum across the four threads that
//   hold it, in the exp2 domain); P is split into hi and lo in registers and
//   is the register-A operand of P V.
// - tf32 wgmma reads B only K-major, so V comes as V^T: the wrapper lays the
//   values out as (BH, D, Sk rounded up to 8) and permutes the keys inside
//   each group of 8 to 0 2 4 6 1 3 5 7. The score accumulator holds columns
//   2t and 2t+1 of each group of 8 in thread t of a quad, where an A fragment
//   wants k-indices t and t+4: with that order both are the same keys, and
//   the accumulators become P's fragments with no shuffle.
// - O (64 x 256 fp32) stays in the warpgroup's registers (128 a thread), and
//   a tile's P V (64 a thread per 128 columns) is added to it as O * alpha +
//   P V.
// The grid runs the query tiles of one head together, so they read its K and
// V from L2.
#include "hopper.cuh"

namespace uav {
namespace {

constexpr int kF32Rows = 64;      // query rows per block (one wgmma M)
constexpr int kF32Keys = 32;      // keys per tile
constexpr int kF32Slice = 256;    // columns of D per block
constexpr int kF32Threads = 256;  // warpgroup 0 computes, warpgroup 1 loads and splits
constexpr int kSBatch = 2;        // k-steps of S per batch of products
constexpr int kSSets = 2;         // batches whose Q fragments are in flight

// byte offsets from the 1024-aligned base of shared memory
struct F32Smem {
  static constexpr uint32_t kTile = kF32Keys * kF32Slice * 4;  // one K or V tile: 32 KB
  static constexpr uint32_t kQ = 0;                            // 64 x 256 fp32
  static constexpr uint32_t kKHi = kQ + kF32Rows * kF32Slice * 4;
  static constexpr uint32_t kKLo = kKHi + kTile;
  static constexpr uint32_t kVHi = kKLo + kTile;
  static constexpr uint32_t kVLo = kVHi + kTile;
  static constexpr uint32_t kX = kVLo + kTile;  // [2][4][128] float4: the peer block's scores
  static constexpr uint32_t kBar = kX + 2 * kF32Rows * kF32Keys * 4;
  static constexpr size_t kBytes = 1024 + kBar + 8 * 9;
};

// hi over the fp32 words of a tile, lo into its twin (one warpgroup)
__device__ __forceinline__ void split_tile(float* hi, float* lo, int tid) {
  float4* h4 = reinterpret_cast<float4*>(hi);
  float4* l4 = reinterpret_cast<float4*>(lo);
#pragma unroll 4
  for (int i = 0; i < (int)F32Smem::kTile / 16 / 128; ++i) {
    const int j = i * 128 + tid;
    const float4 x = h4[j];
    uint32_t a[4], b[4];
    split_tf32(x.x, a[0], b[0]);
    split_tf32(x.y, a[1], b[1]);
    split_tf32(x.z, a[2], b[2]);
    split_tf32(x.w, a[3], b[3]);
    h4[j] = make_float4(__uint_as_float(a[0]), __uint_as_float(a[1]), __uint_as_float(a[2]),
                        __uint_as_float(a[3]));
    l4[j] = make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]), __uint_as_float(b[2]),
                        __uint_as_float(b[3]));
  }
}

// C blocks (a cluster) share 64 query rows, one 256-column slice of D each.
template <int C>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_tf32x3_kernel(const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, const float* __restrict__ q,
                    float* __restrict__ o, int Sq, int Sk, float scale) {
  constexpr int D = C * kF32Slice;
  using L = F32Smem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = (unsigned char*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  float* q_s = (float*)(base + L::kQ);
  float* khi = (float*)(base + L::kKHi);
  float* klo = (float*)(base + L::kKLo);
  float* vhi = (float*)(base + L::kVHi);
  float* vlo = (float*)(base + L::kVLo);
  float* xch = (float*)(base + L::kX);
  uint64_t* bar = (uint64_t*)(base + L::kBar);
  uint64_t *qfull = bar, *kland = bar + 1, *kfull = bar + 2, *kempty = bar + 3;
  uint64_t *vland = bar + 4, *vfull = bar + 5, *vempty = bar + 6, *xfull = bar + 7;  // xfull[2]

  const int rank = C > 1 ? (int)cluster_rank() : 0;
  const int bh = blockIdx.y, q0 = (blockIdx.x / C) * kF32Rows, d0 = rank * kF32Slice;
  const int n_tiles = (Sk + kF32Keys - 1) / kF32Keys;
  const int tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(qfull, 128);
    mbar_init(kland, 1);
    mbar_init(kfull, 128);
    mbar_init(kempty, 4);  // one arrival per computing warp
    mbar_init(vland, 1);
    mbar_init(vfull, 128);
    mbar_init(vempty, 4);
    mbar_init(&xfull[0], 1);  // an arrival with the byte count, then the peer's bytes
    mbar_init(&xfull[1], 1);
    mbar_fence_init();
  }
  if constexpr (C > 1)
    cluster_sync();  // both blocks' barriers exist before either writes to the other
  else
    __syncthreads();

  if (threadIdx.x >= 128) {
    // ------------------------------------------------ warpgroup 1: loads, splits
    const bool issuer = tid == 0;
    auto load_k = [&](int kt) {
      mbar_expect_tx(kland, L::kTile);
      for (int b = 0; b < kF32Slice / 32; ++b)  // boxes of 32 columns x 32 keys
        tma_load_3d(khi + b * kF32Keys * 32, &kmap, kland, d0 + 32 * b, kt * kF32Keys, bh);
    };
    auto load_v = [&](int kt) {  // one box: 256 columns x 32 keys of the value layout
      mbar_expect_tx(vland, L::kTile);
      tma_load_3d(vhi, &vmap, vland, kt * kF32Keys, d0, bh);
    };
    if (issuer) {
      load_k(0);
      load_v(0);
    }
    // Q: element (row, d) of this block's 64 x 256 goes to k-step d/8, warp
    // row/16, lane 4 (row%8) + d%4, register (row%16)/8 + 2 ((d%8)/4): each
    // computing thread reads one float4 a k-step. Rows past Sq are zeros.
    const float* qb = q + ((size_t)bh * Sq + q0) * D + d0;
    for (int i = 0; i < kF32Rows * kF32Slice / 4 / 128; ++i) {
      const int f = i * 128 + tid, row = f / (kF32Slice / 4), c = (f % (kF32Slice / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + row < Sq) x = *reinterpret_cast<const float4*>(qb + (size_t)row * D + c);
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = c + e, lane = (row % 8) * 4 + d % 4;
        const int reg = (row % 16) / 8 + 2 * ((d % 8) / 4);
        q_s[(((d / 8) * 4 + row / 16) * 32 + lane) * 4 + reg] = xs[e];
      }
    }
    mbar_arrive(qfull);
    for (int kt = 0; kt < n_tiles; ++kt) {
      const uint32_t ph = kt & 1;
      mbar_wait(kland, ph);
      split_tile(khi, klo, tid);
      fence_proxy_async();
      mbar_arrive(kfull);
      if (issuer && kt > 0) {
        mbar_wait(vempty, ph ^ 1);  // P V of tile kt - 1 is done with the V buffer
        load_v(kt);
      }
      mbar_wait(vland, ph);
      split_tile(vhi, vlo, tid);
      fence_proxy_async();
      mbar_arrive(vfull);
      if (issuer && kt + 1 < n_tiles) {
        mbar_wait(kempty, ph);  // S of tile kt is done with the K buffer
        load_k(kt + 1);
      }
    }
  } else {
    // ------------------------------------------------ warpgroup 0: computes
    const int warp = tid / 32, lane = tid % 32;
    const float sl2 = scale * 1.4426950408889634f;
    float acc_o[kF32Slice / 2];
#pragma unroll
    for (int i = 0; i < kF32Slice / 2; ++i) acc_o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows r and r + 8
    const float4* qf = reinterpret_cast<const float4*>(q_s) + warp * 32 + lane;
    const uint64_t kh0 = sw128_desc(khi, 16, 1024), kl0 = sw128_desc(klo, 16, 1024);
    const uint64_t vh0 = sw128_desc(vhi, 16, 1024), vl0 = sw128_desc(vlo, 16, 1024);
    uint32_t x_peer = 0, xbar_peer = 0;
    if constexpr (C > 1) {
      x_peer = peer_addr(xch, rank ^ 1);
      xbar_peer = peer_addr(xfull, rank ^ 1);
    }
    mbar_wait(qfull, 0);

    for (int kt = 0; kt < n_tiles; ++kt) {
      const uint32_t ph = kt & 1;

      // S = Q[:, slice] K[:, slice]^T, 32 k-steps of 8 columns, 3 products
      // each, as two sums of 128 columns (in s0, then s) added in registers
      float s[kF32Keys / 2], s0[kF32Keys / 2];
      uint32_t af[kSSets][kSBatch][2][4];  // [set][k-step][hi, lo][fragment]
      float4 xn[kSBatch];                  // the next batch's Q fragments
      mbar_wait(kfull, ph);
      const uint64_t kh = opaque(kh0), kl = opaque(kl0);
#pragma unroll
      for (int j = 0; j < kSBatch; ++j) xn[j] = qf[j * 128];
#pragma unroll
      for (int kp = 0; kp < kF32Slice / 8 / kSBatch; ++kp) {
        const int h = kp % kSSets;
#pragma unroll
        for (int j = 0; j < kSBatch; ++j) {
          split_tf32(xn[j].x, af[h][j][0][0], af[h][j][1][0]);
          split_tf32(xn[j].y, af[h][j][0][1], af[h][j][1][1]);
          split_tf32(xn[j].z, af[h][j][0][2], af[h][j][1][2]);
          split_tf32(xn[j].w, af[h][j][0][3], af[h][j][1][3]);
        }
        if (kp + 1 < kF32Slice / 8 / kSBatch) {
#pragma unroll
          for (int j = 0; j < kSBatch; ++j) xn[j] = qf[((kp + 1) * kSBatch + j) * 128];
        }
        auto products = [&](float(&acc)[kF32Keys / 2]) {
#pragma unroll
          for (int j = 0; j < kSBatch; ++j) {
            const int ks = kp * kSBatch + j;
            // box of 32 columns (32 keys x 128 bytes), then a 32-byte step in it
            const uint64_t off = (ks / 4) * (kF32Keys * 128 >> 4) + (ks % 4) * 2;
            WgmmaTf32<kF32Keys>::rs(acc, af[h][j][0], kh + off, ks % 16 ? 1 : 0);
            WgmmaTf32<kF32Keys>::rs(acc, af[h][j][0], kl + off, 1);
            WgmmaTf32<kF32Keys>::rs(acc, af[h][j][1], kh + off, 1);
          }
        };
        wgmma_fence();
        if (kp * kSBatch < kF32Slice / 16)
          products(s0);
        else
          products(s);
        wgmma_commit();
        wgmma_wait<kSSets - 1>();  // the batch whose registers come next is done
#pragma unroll
        for (int j = 0; j < kSBatch; ++j) fence_regs(af[(kp + 1) % kSSets][j]);
      }
      wgmma_wait<0>();
      fence_regs(s0);
      fence_regs(s);
      if (lane == 0) mbar_arrive(kempty);
#pragma unroll
      for (int i = 0; i < kF32Keys / 2; ++i) s[i] += s0[i];

      if constexpr (C > 1) {  // add the other block's half of the sum over D
        const int xb = kt & 1;
        if (tid == 0) mbar_expect_tx(&xfull[xb], 128 * kF32Keys / 2 * 4);
#pragma unroll
        for (int g = 0; g < 4; ++g)
          st_async_peer_v4(x_peer + (uint32_t)(((xb * 4 + g) * 128 + tid) * 16),
                           make_float4(s[4 * g], s[4 * g + 1], s[4 * g + 2], s[4 * g + 3]),
                           xbar_peer + xb * 8);
        mbar_wait_cluster(&xfull[xb], (kt >> 1) & 1);
        const float4* xin = reinterpret_cast<const float4*>(xch) + xb * 4 * 128 + tid;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float4 y = xin[g * 128];
          s[4 * g] += y.x;
          s[4 * g + 1] += y.y;
          s[4 * g + 2] += y.z;
          s[4 * g + 3] += y.w;
        }
      }

      // online softmax over this tile's keys, in the exp2 domain
      const int col0 = kt * kF32Keys + (lane % 4) * 2;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < kF32Keys / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = col0 + j * 8 + e < Sk;
          s[4 * j + e] = ok ? s[4 * j + e] * sl2 : -INFINITY;
          s[4 * j + 2 + e] = ok ? s[4 * j + 2 + e] * sl2 : -INFINITY;
          mx0 = fmaxf(mx0, s[4 * j + e]);
          mx1 = fmaxf(mx1, s[4 * j + 2 + e]);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite: a tile has a valid key
      const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      // P's fragments: k-index t of a k-step is key 2t of its group of 8 and
      // k-index t + 4 key 2t + 1 (the value layout's order)
      uint32_t p[kF32Keys / 8][2][4];  // [k-step][hi, lo][fragment]
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int kk = 0; kk < kF32Keys / 8; ++kk) {
        const float e00 = exp2f(s[4 * kk] - mn0), e01 = exp2f(s[4 * kk + 1] - mn0);
        const float e10 = exp2f(s[4 * kk + 2] - mn1), e11 = exp2f(s[4 * kk + 3] - mn1);
        rs0 += e00 + e01;
        rs1 += e10 + e11;
        split_tf32(e00, p[kk][0][0], p[kk][1][0]);
        split_tf32(e10, p[kk][0][1], p[kk][1][1]);
        split_tf32(e01, p[kk][0][2], p[kk][1][2]);
        split_tf32(e11, p[kk][0][3], p[kk][1][3]);
      }
      l0 = l0 * a0 + rs0;  // this thread's columns; the row's four threads sum at the end
      l1 = l1 * a1 + rs1;

      // O = O * alpha + P V[:, slice]: this tile's sum (4 k-steps of 8 keys,
      // 3 products each) in a fresh accumulator per 128 columns, added in
      // registers
      mbar_wait(vfull, ph);
      const uint64_t vh = opaque(vh0), vl = opaque(vl0);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float ot[kF32Slice / 4];
        // rows 128 hf.. of the value tile (128 bytes each), a 32-byte step a k-step
        const uint64_t off = hf * (128 * 128 >> 4);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kF32Keys / 8; ++kk) {
          WgmmaTf32<128>::rs(ot, p[kk][0], vh + off + 2 * kk, kk > 0 ? 1 : 0);
          WgmmaTf32<128>::rs(ot, p[kk][0], vl + off + 2 * kk, 1);
          WgmmaTf32<128>::rs(ot, p[kk][1], vh + off + 2 * kk, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(ot);
        float* oh = acc_o + hf * (kF32Slice / 4);
#pragma unroll
        for (int c = 0; c < kF32Slice / 16; ++c) {  // 8 columns a step
          oh[4 * c] = fmaf(oh[4 * c], a0, ot[4 * c]);
          oh[4 * c + 1] = fmaf(oh[4 * c + 1], a0, ot[4 * c + 1]);
          oh[4 * c + 2] = fmaf(oh[4 * c + 2], a1, ot[4 * c + 2]);
          oh[4 * c + 3] = fmaf(oh[4 * c + 3], a1, ot[4 * c + 3]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < kF32Keys / 8; ++kk) fence_regs(p[kk]);
      if (lane == 0) mbar_arrive(vempty);
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const int r0 = q0 + warp * 16 + lane / 4;
    float* ob = o + (size_t)bh * Sq * D + d0 + (lane % 4) * 2;
#pragma unroll
    for (int c = 0; c < kF32Slice / 8; ++c) {
      if (r0 < Sq)
        *reinterpret_cast<float2*>(ob + (size_t)r0 * D + c * 8) =
            make_float2(acc_o[4 * c] * inv0, acc_o[4 * c + 1] * inv0);
      if (r0 + 8 < Sq)
        *reinterpret_cast<float2*>(ob + (size_t)(r0 + 8) * D + c * 8) =
            make_float2(acc_o[4 * c + 2] * inv1, acc_o[4 * c + 3] * inv1);
    }
  }
  if constexpr (C > 1) cluster_sync();  // neither block leaves while the other may write to it
}

template <int C>
int launch_f32(const void* q, const void* k, const void* vt, void* o, int BH, int Sq, int Sk,
               float scale, cudaStream_t stream) {
  constexpr int D = C * kF32Slice;
  constexpr auto f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const uint64_t skp = (uint64_t)(Sk + 7) / 8 * 8;  // keys of the value layout
  CUtensorMap km, vm;
  int e = make_map_3d(&km, k, D, Sk, BH, D * 4, (uint64_t)Sk * D * 4, kF32Keys, 1, f32);
  if (e) return e;
  e = make_map_3d(&vm, vt, skp, D, BH, skp * 4, skp * D * 4, kF32Slice, 1, f32);
  if (e) return e;
  UAV_RETURN_IF(set_smem(flash_tf32x3_kernel<C>, F32Smem::kBytes));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * ((Sq + kF32Rows - 1) / kF32Rows), BH);
  cfg.blockDim = dim3(kF32Threads);
  cfg.dynamicSmemBytes = F32Smem::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  UAV_RETURN_IF(cudaLaunchKernelEx(&cfg, flash_tf32x3_kernel<C>, km, vm, (const float*)q,
                                   (float*)o, Sq, Sk, scale));
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace uav

// q, k: (BH, Sq, D), (BH, Sk, D); vt: the values laid out as (BH, D, Skp),
// Skp = Sk rounded up to 8, keys permuted to 0 2 4 6 1 3 5 7 inside each
// group of 8, zeros past Sk (ops/flash_attention.py::f32_value_layout);
// o: (BH, Sq, D). All fp32, contiguous, 16-byte aligned. D is 256 or 512 (the
// wrapper zero-pads others).
extern "C" int uav_flash_attention_f32(const void* q, const void* k, const void* vt, void* o,
                                       int BH, int Sq, int Sk, int D, float scale,
                                       void* stream) {
  if (BH < 1 || Sq < 1 || Sk < 1 || BH > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 256: return uav::launch_f32<1>(q, k, vt, o, BH, Sq, Sk, scale, s);
    case 512: return uav::launch_f32<2>(q, k, vt, o, BH, Sq, Sk, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
