// SAME-T (k,1,1) temporal convolution with bias on channels-last bf16 video,
// out[b, t] = bias + sum_i x[b, t + i - (k-1)/2] @ W_i, taps outside [0, T) skipped.
//
// Replaces upscale_a_video_tpu/ops/temporal_conv.py::temporal_conv (Pallas
// _kernel: K frame-shifted (R, Cin) @ (Cin, Cout) GEMMs over row blocks, the
// out-of-range taps masked by a scalar factor). Here the same frame-shifted
// GEMMs run on WMMA bf16 tiles with fp32 accumulation: the tile code is the
// temporal resblock's conv (temporal_conv.cuh) without its GroupNorm + SiLU
// prologue, with Cin and Cout free. Bound on this card: operations
// (2 * Cin * Cout per valid tap and output element) at the UNet's widths.
#include "temporal_conv.cuh"

using namespace uav;

// x: (B, T, HW, Cin) bf16; w: (K, Cout, Cin) bf16, tap major; bias: (Cout,) bf16
// or null; out: (B, T, HW, Cout) bf16. T <= 8, HW % 16 == 0, Cin and Cout
// multiples of 16, K odd.
extern "C" int uav_temporal_conv_bias(const void* x, const void* w, int K, const void* bias,
                                      void* out, int B, int T, int HW, int Cin, int Cout,
                                      void* stream) {
  return (int)launch_tconv(x, nullptr, nullptr, w, K, bias, nullptr, nullptr, out, nullptr, B,
                           T, HW, Cin, Cout, (cudaStream_t)stream);
}
