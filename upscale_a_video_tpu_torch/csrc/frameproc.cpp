// Host-side pixel conversions of the CLI's frames, multithreaded over frames.
//
// Copy of the three pixel functions of native/frameproc.cpp (the JAX
// package's library), built separately for the port by
// upscale_a_video_tpu_torch/utils/native_frameproc.py with the host C++
// compiler (no CUDA: decode and encode stay on the host, the frames cross to
// the card once per clip). The decoded-frame ring buffer of that file serves
// the streaming ingest path, which the port does not have yet.
//
// Exposed C ABI (ctypes):
//   fp_normalize_u8    : uint8 HWC → float32 [-1, 1], (x / 255 - 0.5) * 2
//   fp_denormalize_f32 : float32 [-1, 1] → uint8: clamp(x / 2 + 0.5, 0, 1) * 255,
//                        then truncated toward zero (numpy's astype(uint8)),
//                        not rounded
//   fp_area_downsample4: float32 HWC → /4 area-averaged float32
// Each result equals, bit for bit, the numpy expression beside it in
// native_frameproc.py (*_plain): the same float32 operations in the same
// order, built without -ffast-math (the one multiply-add, x * 0.5 + 0.5,
// rounds once whether or not it is contracted, since x * 0.5 is exact).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// Run fn(i) for i in [0, n) across up to `threads` workers.
template <typename F>
void parallel_for(int64_t n, int threads, F fn) {
  if (n <= 0) return;
  int workers = static_cast<int>(std::min<int64_t>(std::max(threads, 1), n));
  if (workers == 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> pool;
  pool.reserve(workers);
  for (int w = 0; w < workers; ++w) {
    pool.emplace_back([&]() {
      for (int64_t i = next.fetch_add(1); i < n; i = next.fetch_add(1)) fn(i);
    });
  }
  for (auto& t : pool) t.join();
}

}  // namespace

extern "C" {

// frames: (T, H, W, C) uint8 → out: (T, H, W, C) float32 in [-1, 1]
void fp_normalize_u8(const uint8_t* frames, float* out, int64_t t, int64_t hwc,
                     int threads) {
  float lut[256];
  for (int i = 0; i < 256; ++i) {
    lut[i] = (static_cast<float>(i) / 255.0f - 0.5f) * 2.0f;
  }
  parallel_for(t, threads, [&](int64_t fi) {
    const uint8_t* src = frames + fi * hwc;
    float* dst = out + fi * hwc;
    for (int64_t j = 0; j < hwc; ++j) dst[j] = lut[src[j]];
  });
}

// frames: (T, H, W, C) float32 [-1, 1] → out uint8
void fp_denormalize_f32(const float* frames, uint8_t* out, int64_t t,
                        int64_t hwc, int threads) {
  parallel_for(t, threads, [&](int64_t fi) {
    const float* src = frames + fi * hwc;
    uint8_t* dst = out + fi * hwc;
    for (int64_t j = 0; j < hwc; ++j) {
      float v = src[j] * 0.5f + 0.5f;
      v = std::min(1.0f, std::max(0.0f, v)) * 255.0f;
      dst[j] = static_cast<uint8_t>(v);  // truncation, as numpy astype(uint8)
    }
  });
}

// frames: (T, H, W, C) float32 → out (T, H/4, W/4, C): 4×4 box average, the
// rows of each box summed in order, each row's four pixels left to right
void fp_area_downsample4(const float* frames, float* out, int64_t t, int64_t h,
                         int64_t w, int64_t c, int threads) {
  const int64_t oh = h / 4, ow = w / 4;
  parallel_for(t * oh, threads, [&](int64_t job) {
    const int64_t fi = job / oh;
    const int64_t oy = job % oh;
    const float* src = frames + fi * h * w * c;
    float* dst = out + fi * oh * ow * c + oy * ow * c;
    for (int64_t ox = 0; ox < ow; ++ox) {
      for (int64_t ch = 0; ch < c; ++ch) {
        float acc = 0.0f;
        for (int64_t dy = 0; dy < 4; ++dy) {
          const float* row = src + ((oy * 4 + dy) * w + ox * 4) * c + ch;
          acc += row[0] + row[c] + row[2 * c] + row[3 * c];
        }
        dst[ox * c + ch] = acc * (1.0f / 16.0f);
      }
    }
  });
}

}  // extern "C"
