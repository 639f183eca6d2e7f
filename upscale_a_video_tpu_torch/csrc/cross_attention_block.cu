// LayerNorm -> attention over the (<= 128) text keys -> out-projection + bias
// (+ residual), on the folded form of the reference:
//   scores_h = bf16(LN(x)) @ Mt_h^T,  Mt_h = scale * K_h Wq_h  (KP x C)
//   delta    = sum_h bf16(softmax(scores_h)) @ Vo_h,  Vo_h = V_h Wo_h^T  (KP x C)
// with the keys of each head padded to KP = 80 (<= 80 keys) or 128 and the
// padding masked in the softmax.
//
// Replaces upscale_a_video_tpu/ops/cross_attention_block.py::
// fused_cross_attention_block (Pallas _kernel). Mt and Vo are per clip and
// small; the wrapper folds them (ops/cross_attention_block.py::fold_keys) as
// (H, clips, skv, C), and a head's KP-row box past skv is TMA's zero fill.
// The per-frame repeat of the text context (t_repeat) is an index: token row
// bt reads clip bt / t_repeat. Bound on this card: operations (4 * C * skv * H
// per token) at C = 512.
//
// Design: flash attention (flash_attention.cu at D = 512) with the channels
// as its head dim and one key tile per head. A block is one 64-row tile of
// one frame
// (the grid runs frame-major, so the tiles of one clip run together and
// share its Mt and Vo in L2) and its two warpgroups:
// - LN in the kernel: the x tile comes by TMA into the 128-byte-swizzled
//   layout the score product reads, is normalised there in place (fp32
//   statistics, bf16 result) and stays for all H heads.
// - Per head, both warpgroups compute the whole 64 x KP score tile on wgmma
//   (K = C), each for itself: the softmax is then local to a warpgroup, with
//   no exchange of partial sums (which would need 20 KB of shared memory
//   beside the 224 KB of the x tile and the two operand buffers at
//   C = 512). A head has one key tile, so the softmax is exact (no online
//   rescale). P, rounded to bf16, is the register-A operand of O += P Vo_h,
//   and each warpgroup owns half of the C columns of O (64 x C fp32 is too
//   much for one warpgroup's registers), in 64-column chunks. Heads add into
//   O without a rescale.
// - Mt_h and Vo_h (KP x C each, from L2) come by TMA into a ring of one or
//   two buffers, in the order Mt_0, Vo_0, Mt_1, ...: with two, Mt_{h+1}
//   loads during head h's P Vo product and Vo_{h+1} during head h+1's
//   scores. One consumer thread issues every load (a block of 256 threads
//   gets 255 registers; O alone is 128 of them).
// - Epilogue: + bo (+ x, read again from global) in fp32, one rounding to
//   bf16, rows past S masked.
#include "hopper.cuh"

namespace uav {
namespace {

constexpr int kCabThreads = 256;  // two warpgroups
constexpr int kCabRows = 64;      // token rows per block

template <int NCH, int KP>
struct Cab {
  static constexpr int C = 128 * NCH;  // channels; each warpgroup owns NCH 64-column chunks of O
  static constexpr uint32_t kXBytes = kCabRows * C * 2;
  static constexpr uint32_t kOpBytes = KP * C * 2;  // one Mt_h or Vo_h
  static constexpr int kBufs = 1024 + kXBytes + 2 * kOpBytes + 8 * 5 <= 232448 ? 2 : 1;
  static constexpr size_t kSmem = 1024 + kXBytes + kBufs * kOpBytes + 8 * (1 + 2 * kBufs);
};

template <int NCH, int KP>
__global__ void __launch_bounds__(kCabThreads, 1)
cab_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap mmap,
           const __grid_constant__ CUtensorMap vmap, const bf16* __restrict__ x,
           const bf16* __restrict__ lnw, const bf16* __restrict__ lnb,
           const bf16* __restrict__ bo, bf16* __restrict__ out, int S, int H, int skv,
           int t_repeat, int clips, int s_tiles, float eps, int add_res) {
  using G = Cab<NCH, KP>;
  constexpr int C = G::C, kBufs = G::kBufs;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* h_s = (unsigned char*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  unsigned char* op_s = h_s + G::kXBytes;  // [buffer][C / 64][KP][128 B]
  uint64_t* full_x = (uint64_t*)(op_s + kBufs * G::kOpBytes);
  uint64_t* full = full_x + 1;
  uint64_t* empty = full + kBufs;

  const int bt = blockIdx.x / s_tiles, s0 = (blockIdx.x - bt * s_tiles) * kCabRows;
  const int clip = bt / t_repeat;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int n_loads = 2 * H;  // Mt_0, Vo_0, Mt_1, Vo_1, ...

  if (threadIdx.x == 0) {
    mbar_init(full_x, 1);
    for (int i = 0; i < kBufs; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);  // one arrival per warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const bool loader = threadIdx.x == 0;
  auto issue = [&](int i) {  // load i into buffer i % kBufs
    const int b = i % kBufs;
    unsigned char* dst = op_s + b * G::kOpBytes;
    const CUtensorMap* map = (i & 1) ? &vmap : &mmap;
    mbar_expect_tx(&full[b], G::kOpBytes);
    for (int bx = 0; bx < C / 64; ++bx)
      tma_load_3d(dst + bx * (KP * 128), map, &full[b], bx * 64, 0, (i / 2) * clips + clip);
  };
  // load i is consumed: every warp arrives, and the loader refills the
  // buffer with load i + kBufs once all eight have
  auto release = [&](int i) {
    if (lane == 0) mbar_arrive(&empty[i % kBufs]);
    if (loader && i + kBufs < n_loads) {
      mbar_wait(&empty[i % kBufs], (i / kBufs) & 1);
      issue(i + kBufs);
    }
    __syncwarp();
  };
  if (loader) {
    mbar_expect_tx(full_x, G::kXBytes);
    for (int bx = 0; bx < C / 64; ++bx)
      tma_load_3d(h_s + bx * (kCabRows * 128), &xmap, full_x, bx * 64, s0, bt);
    for (int i = 0; i < kBufs; ++i) issue(i);
  }

  // LayerNorm in place, one warp per row: physical 16-byte chunk p of row r
  // in a 64-channel box holds channels 8 (p ^ (r % 8)) .. + 7 of that box
  mbar_wait(full_x, 0);
  {
    constexpr int kChunks = C / 8, kPer = (kChunks + 31) / 32;
    for (int r = threadIdx.x / 32; r < kCabRows; r += kCabThreads / 32) {
      uint4 v[kPer];
      int ch[kPer];
      float s = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int q = lane + 32 * i;
        if (q < kChunks) {
          const int box = q / 8, p = q % 8;
          ch[i] = box * 64 + (p ^ (r % 8)) * 8;
          v[i] = *(const uint4*)(h_s + box * (kCabRows * 128) + r * 128 + p * 16);
          const uint32_t w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = unpack_bf16(w[e]);
            s += f.x + f.y;
            s2 += f.x * f.x + f.y * f.y;
          }
        }
      }
      s = warp_sum(s);
      s2 = warp_sum(s2);
      const float mu = s / C, rs = rsqrtf(s2 / C - mu * mu + eps);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int q = lane + 32 * i;
        if (q < kChunks) {
          const uint4 gw = *(const uint4*)(lnw + ch[i]), gb = *(const uint4*)(lnb + ch[i]);
          const uint32_t w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
          const uint32_t pw[4] = {gw.x, gw.y, gw.z, gw.w}, pb[4] = {gb.x, gb.y, gb.z, gb.w};
          uint32_t o[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = unpack_bf16(w[e]), fw = unpack_bf16(pw[e]), fb = unpack_bf16(pb[e]);
            o[e] = pack_bf16((f.x - mu) * rs * fw.x + fb.x, (f.y - mu) * rs * fw.y + fb.y);
          }
          *(uint4*)(h_s + (q / 8) * (kCabRows * 128) + r * 128 + (q % 8) * 16) =
              make_uint4(o[0], o[1], o[2], o[3]);
        }
      }
    }
  }
  fence_proxy_async();  // the normalised tile is read by wgmma next
  __syncthreads();

  const float l2e = 1.4426950408889634f;
  float acc[NCH][32];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  const uint64_t hd0 = sw128_desc(h_s, 16, 1024);
  const uint64_t md0 = sw128_desc(op_s, 16, 1024);
  const uint64_t vd0 = sw128_desc(op_s + wg * NCH * (KP * 128), KP * 128, 1024);
  const int col0 = (lane % 4) * 2;

  for (int h = 0; h < H; ++h) {
    // S = hn Mt_h^T over all C channels (both warpgroups, all 64 rows)
    const int im = 2 * h, iv = 2 * h + 1;
    float s[KP / 2];
    mbar_wait(&full[im % kBufs], (im / kBufs) & 1);
    {
      const uint64_t hd = opaque(hd0), md = opaque(md0 + (im % kBufs) * (G::kOpBytes >> 4));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk) {  // 16 channels: (box, 32-byte step) offsets
        const int box = kk / 4, step = (kk % 4) * 2;
        Wgmma<KP>::ss(s, hd + box * (kCabRows * 8) + step, md + box * (KP * 8) + step,
                      kk > 0 ? 1 : 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
    }
    release(im);

    // exact softmax over the head's keys, keys >= skv masked
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < KP / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = j * 8 + col0 + e < skv;
        s[4 * j + e] = ok ? s[4 * j + e] * l2e : -INFINITY;
        s[4 * j + 2 + e] = ok ? s[4 * j + 2 + e] * l2e : -INFINITY;
        mx0 = fmaxf(mx0, s[4 * j + e]);
        mx1 = fmaxf(mx1, s[4 * j + 2 + e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int j = 0; j < KP / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * j + e] = exp2f(s[4 * j + e] - mx0);
        s[4 * j + 2 + e] = exp2f(s[4 * j + 2 + e] - mx1);
        l0 += s[4 * j + e];
        l1 += s[4 * j + 2 + e];
      }
    }
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    uint32_t p[KP / 16][4];
#pragma unroll
    for (int kk = 0; kk < KP / 16; ++kk) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = 2 * kk + hf;
        p[kk][2 * hf] = pack_bf16(s[4 * j] * inv0, s[4 * j + 1] * inv0);
        p[kk][2 * hf + 1] = pack_bf16(s[4 * j + 2] * inv1, s[4 * j + 3] * inv1);
      }
    }

    // O[:, this warpgroup's columns] += P Vo_h[:, same]
    mbar_wait(&full[iv % kBufs], (iv / kBufs) & 1);
    {
      const uint64_t vd = opaque(vd0 + (iv % kBufs) * (G::kOpBytes >> 4));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KP / 16; ++kk)  // 16 keys: 2048 bytes
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          Wgmma<64>::rs<1>(acc[c], p[kk], vd + c * (KP * 8) + kk * 128, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(p);
    }
    release(iv);
  }

  // out = O + bo (+ x), rows past S masked; a chunk's residual is loaded
  // before its stores (a store could alias a later load)
  const int r0 = s0 + warp * 16 + lane / 4;
  const size_t row_base = (size_t)bt * S;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    uint32_t xv[8][2];  // bf16 pairs
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + 8 * hh, col = (wg * NCH + c) * 64 + j * 8 + col0;
        xv[j][hh] = add_res && r < S ? *(const uint32_t*)(x + (row_base + r) * C + col) : 0u;
      }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = (wg * NCH + c) * 64 + j * 8 + col0;
      const float2 b = __bfloat1622float2(*(const __nv_bfloat162*)(bo + col));
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + 8 * hh;
        if (r < S) {
          const float2 xf = unpack_bf16(xv[j][hh]);
          *(__nv_bfloat162*)(out + (row_base + r) * C + col) = __floats2bfloat162_rn(
              acc[c][4 * j + 2 * hh] + b.x + xf.x, acc[c][4 * j + 2 * hh + 1] + b.y + xf.y);
        }
      }
    }
  }
}

struct CabArgs {
  const void *x, *lnw, *lnb, *mt, *vo, *bo;
  void* out;
  int BT, S, H, skv, t_repeat;
  float eps;
  int add_res;
};

template <int NCH, int KP>
int launch(const CabArgs& a, cudaStream_t stream) {
  using G = Cab<NCH, KP>;
  constexpr int C = G::C;
  const int clips = a.BT / a.t_repeat;
  CUtensorMap xm, mm, vm;
  int e = make_map_3d(&xm, a.x, C, a.S, a.BT, C * 2, (uint64_t)a.S * C * 2, kCabRows);
  if (e) return e;
  e = make_map_3d(&mm, a.mt, C, a.skv, (uint64_t)a.H * clips, C * 2, (uint64_t)a.skv * C * 2, KP);
  if (e) return e;
  e = make_map_3d(&vm, a.vo, C, a.skv, (uint64_t)a.H * clips, C * 2, (uint64_t)a.skv * C * 2, KP);
  if (e) return e;
  UAV_RETURN_IF(set_smem(cab_kernel<NCH, KP>, G::kSmem));
  const int s_tiles = (a.S + kCabRows - 1) / kCabRows;
  cab_kernel<NCH, KP><<<a.BT * s_tiles, kCabThreads, G::kSmem, stream>>>(
      xm, mm, vm, (const bf16*)a.x, (const bf16*)a.lnw, (const bf16*)a.lnb, (const bf16*)a.bo,
      (bf16*)a.out, a.S, a.H, a.skv, a.t_repeat, clips, s_tiles, a.eps, a.add_res);
  return (int)cudaGetLastError();
}

template <int KP>
int launch_c(int C, const CabArgs& a, cudaStream_t st) {
  switch (C) {
    case 128: return launch<1, KP>(a, st);
    case 256: return launch<2, KP>(a, st);
    case 384: return launch<3, KP>(a, st);
    case 512: return launch<4, KP>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace uav

using namespace uav;

// x, out: (BT, S, C) bf16; mt, vo: (H, BT / t_repeat, skv, C) bf16; lnw,
// lnb, bo: (C,) bf16. All 16-byte aligned. C in {128, 256, 384, 512},
// 1 <= skv <= 128; a head's keys are a tile of 80 rows (skv <= 80) or 128.
extern "C" int uav_cross_attention_block(const void* x, const void* lnw, const void* lnb,
                                         const void* mt, const void* vo, const void* bo,
                                         void* out, int BT, int S, int C, int H, int skv,
                                         int t_repeat, float eps, int add_res, void* stream) {
  if (BT < 1 || S < 1 || H < 1 || skv < 1 || skv > 128 || t_repeat < 1 || BT % t_repeat != 0)
    return (int)cudaErrorInvalidValue;
  const CabArgs a{x, lnw, lnb, mt, vo, bo, out, BT, S, H, skv, t_repeat, eps, add_res};
  const cudaStream_t st = (cudaStream_t)stream;
  return skv <= 80 ? launch_c<80>(C, a, st) : launch_c<128>(C, a, st);
}
