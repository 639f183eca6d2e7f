// Tiled online-softmax attention, no bias, head_dim 64, 128, 256 or 512.
//
// Replaces upscale_a_video_tpu/ops/flash_attention.py::flash_attention (the
// Pallas _flash_kernel). Same algorithm: scores never reach device memory;
// the running max m, the running sum l and the output accumulator stay in
// fp32; keys past Sk are masked. Bound on this card: operations (4*Sq*Sk*D
// per head is far above the bytes for every shape it serves).
//
// Design, in the shape of FlashAttention-3: TMA loads of K and V tiles (BK
// keys x D) into a 2-stage ring of 128-byte-swizzled shared memory guarded
// by mbarriers, Q loaded once. The block is just the two warpgroups (256
// threads, 255 registers each: the 64 x 256 fp32 O of D = 256 and 512 does
// not fit the 168 of a block with a producer warp), so one consumer thread
// issues the loads, two tiles ahead. The warpgroups run both products on
// wgmma: S = Q K^T from shared
// memory into registers, the online softmax in registers (a row's max and
// sum across the four threads that hold it, in the exp2 domain), then
// P, rounded to bf16 in registers, is the register-A operand of O += P V with
// V read N-major from shared memory. O stays in registers. Keys past Sk are
// TMA's zero fill, masked to -inf in the softmax, so K/V need no padding.
// - D <= 256: each warpgroup owns 64 query rows and the whole 64 x D of O.
// - D = 512: O is 64 x 512 fp32, too much for one warpgroup's registers, so
//   the two warpgroups share 64 query rows and each owns half of D: each
//   computes a partial S over its half of D, the partials are summed through
//   shared memory (double-buffered, one named barrier per key tile), both
//   apply the same softmax, and each accumulates P V[:, its half].
// Every K/V byte is read again by every 64- or 128-row query tile (from L2).
#include "hopper.cuh"

namespace uav {
namespace {

constexpr int kFlashThreads = 256;  // two consumer warpgroups
constexpr int kFlashStages = 2;

template <int D>
struct Flash {
  static constexpr bool kSplit = D > 256;          // the warpgroups split D, not the rows
  static constexpr int kRows = kSplit ? 64 : 128;  // query rows per block
  static constexpr int kBK = D == 512 ? 32 : D == 256 ? 64 : 128;  // keys per tile
  static constexpr int kDW = kSplit ? D / 2 : D;   // D-width of one warpgroup's S and O
  static constexpr uint32_t kQBytes = kRows * D * 2;
  static constexpr uint32_t kKVBytes = kBK * D * 2;  // one K or V tile
  static constexpr size_t kXBytes = kSplit ? 2 * 2 * (kBK / 2) * 128 * 4 : 0;
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kFlashStages * kKVBytes + kXBytes + 8 * (1 + 3 * kFlashStages);
};

template <int D>
__global__ void __launch_bounds__(kFlashThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o, int Sq,
                   int Sk, float scale) {
  using C = Flash<D>;
  constexpr int kBK = C::kBK, kDW = C::kDW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = (unsigned char*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  unsigned char* k_s = q_s + C::kQBytes;                 // [stage][D/64][kBK][128 B]
  unsigned char* v_s = k_s + kFlashStages * C::kKVBytes;  // same
  float* xch = (float*)(v_s + kFlashStages * C::kKVBytes);  // [parity][wg][kBK/2][128]
  uint64_t* full_q = (uint64_t*)((unsigned char*)xch + C::kXBytes);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + kFlashStages;
  uint64_t* empty = full_v + kFlashStages;

  const int bh = blockIdx.y, q0 = blockIdx.x * C::kRows;
  const int wg = threadIdx.x / 128;
  const int n_tiles = (Sk + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int i = 0; i < kFlashStages; ++i) {
      mbar_init(&full_k[i], 1);
      mbar_init(&full_v[i], 1);
      mbar_init(&empty[i], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Thread 0 also issues every load: Q and the first two K/V tiles now,
  // then tile kt + 2 into the stage that tile kt frees.
  const bool loader = threadIdx.x == 0;
  auto load_kv = [&](int kt) {
    const int st = kt % kFlashStages;
    unsigned char* ks = k_s + st * C::kKVBytes;
    unsigned char* vs = v_s + st * C::kKVBytes;
    mbar_expect_tx(&full_k[st], C::kKVBytes);
    for (int b = 0; b < D / 64; ++b)
      tma_load_3d(ks + b * kBK * 128, &kmap, &full_k[st], b * 64, kt * kBK, bh);
    mbar_expect_tx(&full_v[st], C::kKVBytes);
    for (int b = 0; b < D / 64; ++b)
      tma_load_3d(vs + b * kBK * 128, &vmap, &full_v[st], b * 64, kt * kBK, bh);
  };
  if (loader) {
    mbar_expect_tx(full_q, C::kQBytes);
    for (int b = 0; b < D / 64; ++b)
      tma_load_3d(q_s + b * C::kRows * 128, &qmap, full_q, b * 64, q0, bh);
    for (int kt = 0; kt < kFlashStages && kt < n_tiles; ++kt) load_kv(kt);
  }

  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int row_off = C::kSplit ? 0 : wg * 64;  // this warpgroup's first query row
  const int d_off = C::kSplit ? wg * kDW : 0;   // and its first column of D
  const float sl2 = scale * 1.4426950408889634f;
  float acc_o[kDW / 2];
#pragma unroll
  for (int i = 0; i < kDW / 2; ++i) acc_o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows r and r + 8
  // descriptors of this warpgroup's first 16 columns of Q, and of stage 0's
  // K and V tiles at its columns of D
  const uint64_t qd0 =
      sw128_desc(q_s + (d_off / 64) * C::kRows * 128 + row_off * 128, 16, 1024);
  const uint64_t kd0 = sw128_desc(k_s + (d_off / 64) * kBK * 128, 16, 1024);
  const uint64_t vd0 = sw128_desc(v_s + (d_off / 64) * kBK * 128, kBK * 128, 1024);

  mbar_wait(full_q, 0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt % kFlashStages;
    const uint32_t ph = (kt / kFlashStages) & 1;

    // S = Q[:, d_off : d_off + kDW] K[:, same]^T
    float s[kBK / 2];
    mbar_wait(&full_k[st], ph);
    const uint64_t qd = opaque(qd0), kd = opaque(kd0 + st * (C::kKVBytes >> 4));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDW / 16; ++kk) {  // 16 columns of D: (box, 32-byte step) offsets
      const int box = kk / 4, step = (kk % 4) * 2;
      Wgmma<kBK>::ss(s, qd + box * (C::kRows * 8) + step, kd + box * (kBK * 8) + step,
                     kk > 0 ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    if constexpr (C::kSplit) {  // add the other warpgroup's half of the sum over D
      float* xb = xch + (kt & 1) * 2 * (kBK / 2) * 128;
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) xb[(wg * (kBK / 2) + i) * 128 + tid] = s[i];
      named_bar_sync(1, 256);
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) s[i] += xb[((1 - wg) * (kBK / 2) + i) * 128 + tid];
    }

    // online softmax over this tile's keys, in the exp2 domain
    const int col0 = kt * kBK + (lane % 4) * 2;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
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
    uint32_t p[kBK / 16][4];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * kk + h;
        const float e00 = exp2f(s[4 * j] - mn0), e01 = exp2f(s[4 * j + 1] - mn0);
        const float e10 = exp2f(s[4 * j + 2] - mn1), e11 = exp2f(s[4 * j + 3] - mn1);
        rs0 += e00 + e01;
        rs1 += e10 + e11;
        p[kk][2 * h] = pack_bf16(e00, e01);
        p[kk][2 * h + 1] = pack_bf16(e10, e11);
      }
    }
    l0 = l0 * a0 + rs0;  // this thread's columns; the row's four threads sum at the end
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int c = 0; c < kDW / 8; ++c) {
      acc_o[4 * c] *= a0;
      acc_o[4 * c + 1] *= a0;
      acc_o[4 * c + 2] *= a1;
      acc_o[4 * c + 3] *= a1;
    }

    // O += P V[:, d_off : d_off + kDW]
    mbar_wait(&full_v[st], ph);
    const uint64_t vd = opaque(vd0 + st * (C::kKVBytes >> 4));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)  // 16 keys: 2048 bytes
      Wgmma<kDW>::rs_t(acc_o, p[kk], vd + kk * 128, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_o);
    fence_regs(p);
    if (lane == 0) mbar_arrive(&empty[st]);
    if (loader && kt + kFlashStages < n_tiles) {
      mbar_wait(&empty[st], ph);  // all eight warps are done with tile kt
      load_kv(kt + kFlashStages);
    }
    __syncwarp();
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = q0 + row_off + warp * 16 + lane / 4;
  bf16* ob = o + (size_t)bh * Sq * D + d_off + (lane % 4) * 2;
#pragma unroll
  for (int c = 0; c < kDW / 8; ++c) {
    if (r0 < Sq)
      *(__nv_bfloat162*)(ob + (size_t)r0 * D + c * 8) =
          __floats2bfloat162_rn(acc_o[4 * c] * inv0, acc_o[4 * c + 1] * inv0);
    if (r0 + 8 < Sq)
      *(__nv_bfloat162*)(ob + (size_t)(r0 + 8) * D + c * 8) =
          __floats2bfloat162_rn(acc_o[4 * c + 2] * inv1, acc_o[4 * c + 3] * inv1);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int Sq, int Sk,
           float scale, cudaStream_t stream) {
  using C = Flash<D>;
  CUtensorMap qm, km, vm;
  int e = make_map_3d(&qm, q, D, Sq, BH, D * 2, (uint64_t)Sq * D * 2, C::kRows);
  if (e) return e;
  e = make_map_3d(&km, k, D, Sk, BH, D * 2, (uint64_t)Sk * D * 2, C::kBK);
  if (e) return e;
  e = make_map_3d(&vm, v, D, Sk, BH, D * 2, (uint64_t)Sk * D * 2, C::kBK);
  if (e) return e;
  UAV_RETURN_IF(set_smem(flash_wgmma_kernel<D>, C::kSmem));
  const dim3 grid((Sq + C::kRows - 1) / C::kRows, BH);
  flash_wgmma_kernel<D><<<grid, kFlashThreads, C::kSmem, stream>>>(qm, km, vm, (bf16*)o, Sq,
                                                                    Sk, scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace uav

using namespace uav;

// q: (BH, Sq, D); k, v: (BH, Sk, D); o: (BH, Sq, D). All bf16, contiguous,
// 16-byte aligned. D is 64, 128, 256 or 512 (the wrapper zero-pads others).
extern "C" int uav_flash_attention(const void* q, const void* k, const void* v, void* o, int BH,
                                   int Sq, int Sk, int D, float scale, void* stream) {
  if (BH < 1 || Sq < 1 || Sk < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 64: return launch<64>(q, k, v, o, BH, Sq, Sk, scale, s);
    case 128: return launch<128>(q, k, v, o, BH, Sq, Sk, scale, s);
    case 256: return launch<256>(q, k, v, o, BH, Sq, Sk, scale, s);
    case 512: return launch<512>(q, k, v, o, BH, Sq, Sk, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* uav_error_string(int code) {
  if (code >= kTmaEncodeError)
    return "cuTensorMapEncodeTiled is missing or refused the tensor map";
  return cudaGetErrorString((cudaError_t)code);
}
