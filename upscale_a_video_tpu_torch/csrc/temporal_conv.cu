// SAME-T (k,1,1) temporal convolution with bias on channels-last bf16 video,
// out[b, t] = bias + sum_i x[b, t + i - (k-1)/2] @ W_i, taps outside [0, T) skipped.
//
// Replaces upscale_a_video_tpu/ops/temporal_conv.py::temporal_conv (Pallas
// _kernel: K frame-shifted (R, Cin) @ (Cin, Cout) GEMMs over row blocks, the
// out-of-range taps masked by a scalar factor). Bound on this card:
// operations (2 * Cin * Cout per valid tap and output element; at the UNet's
// widths about 100x the bytes).
//
// Design: the GEMM core of gemm_core.cuh (an implicit GEMM on TMA-fed wgmma
// tiles, the tile's valid taps only) with no prologue and a bias epilogue:
// add the bias, round to bf16, store with the rows past HW masked. The
// temporal resblock runs the same core with its GroupNorm + SiLU prologue
// and its temb / residual / GroupNorm-partial epilogues
// (fused_temporal_resblock.cu).
#include "gemm_core.cuh"

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
  const BiasEpilogue epi{(const bf16*)bias, nullptr, (bf16*)out};
  if (small_tiles(B * T, HW, Cout, 256))
    return launch_gemm<64, 128>(x, w, B * T, T, HW, Cin, Cout, K, epi, st);
  return launch_gemm<128, 256>(x, w, B * T, T, HW, Cin, Cout, K, epi, st);
}
