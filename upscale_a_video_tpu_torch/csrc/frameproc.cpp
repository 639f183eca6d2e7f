// Host-side pixel conversions of the CLI's frames, multithreaded over frames,
// and the decoded-frame ring of the serving stream.
//
// Copy of the three pixel functions and the ring buffer of
// native/frameproc.cpp (the JAX package's library), built separately for the
// port by upscale_a_video_tpu_torch/utils/native_frameproc.py with the host
// C++ compiler (no CUDA: decode and encode stay on the host, the frames cross
// to the card once per clip or segment).
//
// Exposed C ABI (ctypes):
//   fp_normalize_u8    : uint8 HWC → float32 [-1, 1], (x / 255 - 0.5) * 2
//   fp_denormalize_f32 : float32 [-1, 1] → uint8: clamp(x / 2 + 0.5, 0, 1) * 255,
//                        then truncated toward zero (numpy's astype(uint8)),
//                        not rounded
//   fp_area_downsample4: float32 HWC → /4 area-averaged float32
//   fp_ring_*          : the fixed-slot frame ring (utils/stream.py::FrameRing)
// Each result equals, bit for bit, the numpy expression beside it in
// native_frameproc.py (*_plain): the same float32 operations in the same
// order, built without -ffast-math (the one multiply-add, x * 0.5 + 0.5,
// rounds once whether or not it is contracted, since x * 0.5 is exact).

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <mutex>
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

// ---------------------------------------------------------------------------
// Decoded-frame ring buffer: fixed-size slots, multi-producer / single-or-multi
// consumer, FIFO in *reservation* order. Producers reserve a ticket, fill the
// slot, commit; commits become visible strictly in ticket order (a watermark
// advances over contiguously committed tickets), so frame order survives an
// out-of-order decode pool. Consumers pop the oldest committed ticket and
// release its slot after copying it out. The serving predictor's streaming
// mode decodes segment k + 1 into the ring while the card runs segment k.

namespace {

struct Ring {
  std::mutex mu;
  std::condition_variable cv;
  std::vector<uint8_t> buf;
  std::vector<uint8_t> committed;  // per-slot flag for the in-flight window
  std::vector<uint8_t> released;   // popped slots given back, maybe out of order
  int64_t slots = 0;
  int64_t slot_bytes = 0;
  int64_t write_ticket = 0;      // next ticket to hand out
  int64_t commit_watermark = 0;  // all tickets < this are committed
  int64_t read_ticket = 0;       // oldest ticket whose slot is not yet released
  int64_t popped_ticket = 0;     // next ticket to pop
  bool closed = false;
};

template <typename Pred>
bool wait_on(Ring* r, std::unique_lock<std::mutex>& lk, int timeout_ms, Pred pred) {
  if (timeout_ms < 0) {
    r->cv.wait(lk, pred);
    return true;
  }
  return r->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms), pred);
}

}  // namespace

extern "C" {

void* fp_ring_create(int64_t slots, int64_t slot_bytes) {
  if (slots <= 0 || slot_bytes <= 0) return nullptr;
  Ring* r = new Ring();
  r->slots = slots;
  r->slot_bytes = slot_bytes;
  r->buf.resize(static_cast<size_t>(slots * slot_bytes));
  r->committed.assign(static_cast<size_t>(slots), 0);
  r->released.assign(static_cast<size_t>(slots), 0);
  return r;
}

void fp_ring_destroy(void* h) { delete static_cast<Ring*>(h); }

// The producers will reserve no more slots; blocked calls wake up.
void fp_ring_close(void* h) {
  Ring* r = static_cast<Ring*>(h);
  std::lock_guard<std::mutex> lk(r->mu);
  r->closed = true;
  r->cv.notify_all();
}

// Reserve a slot for writing. Returns a ticket >= 0, -1 on timeout, -2 if closed.
int64_t fp_ring_reserve(void* h, int timeout_ms) {
  Ring* r = static_cast<Ring*>(h);
  std::unique_lock<std::mutex> lk(r->mu);
  bool ok = wait_on(r, lk, timeout_ms,
                    [&] { return r->closed || r->write_ticket - r->read_ticket < r->slots; });
  if (r->closed) return -2;
  if (!ok) return -1;
  return r->write_ticket++;
}

// Slot memory of a ticket (valid between reserve and commit, pop and release).
void* fp_ring_slot(void* h, int64_t ticket) {
  Ring* r = static_cast<Ring*>(h);
  return r->buf.data() + (ticket % r->slots) * r->slot_bytes;
}

void fp_ring_commit(void* h, int64_t ticket) {
  Ring* r = static_cast<Ring*>(h);
  std::lock_guard<std::mutex> lk(r->mu);
  r->committed[ticket % r->slots] = 1;
  while (r->commit_watermark < r->write_ticket && r->committed[r->commit_watermark % r->slots]) {
    ++r->commit_watermark;
  }
  r->cv.notify_all();
}

// Pop the oldest committed ticket. -1 on timeout, -2 if closed AND drained.
int64_t fp_ring_pop(void* h, int timeout_ms) {
  Ring* r = static_cast<Ring*>(h);
  std::unique_lock<std::mutex> lk(r->mu);
  wait_on(r, lk, timeout_ms, [&] {
    return r->popped_ticket < r->commit_watermark ||
           (r->closed && r->popped_ticket >= r->write_ticket);
  });
  if (r->popped_ticket < r->commit_watermark) return r->popped_ticket++;
  if (r->closed && r->popped_ticket >= r->write_ticket) return -2;
  return -1;
}

// Release a popped ticket's slot for reuse. Releases may arrive out of order
// (several consumers); a slot is recycled only once every older ticket's slot
// is back too, which keeps reserve's ticket-to-slot mapping unambiguous.
void fp_ring_release(void* h, int64_t ticket) {
  Ring* r = static_cast<Ring*>(h);
  std::lock_guard<std::mutex> lk(r->mu);
  r->released[ticket % r->slots] = 1;
  while (r->read_ticket < r->popped_ticket && r->released[r->read_ticket % r->slots]) {
    r->released[r->read_ticket % r->slots] = 0;
    r->committed[r->read_ticket % r->slots] = 0;
    ++r->read_ticket;
  }
  r->cv.notify_all();
}

// Committed but not yet popped slots.
int64_t fp_ring_pending(void* h) {
  Ring* r = static_cast<Ring*>(h);
  std::lock_guard<std::mutex> lk(r->mu);
  return r->commit_watermark - r->popped_ticket;
}

}  // extern "C"
