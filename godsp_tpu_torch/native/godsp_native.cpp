// godsp_tpu_torch native host ops (the port's own copy of
// godsp_tpu/native/godsp_native.cpp; the C ABI is the same).
//
// The host-side hot loops of the reference: sample decode/normalization
// (wav/wav.go:138-161 does it per-sample in Go) and overlapped frame
// extraction (spectral/spectral.go:36-44 copies per segment).  These
// feed the device pipeline from the host, so they are plain single-pass
// C++ running on the CPU — device compute stays in torch and the CUDA
// kernels of csrc/.
//
// Also a growable FIFO byte-stream buffer (StreamBuffer) backing the
// streaming Pwelch driver's chunk assembly: the numpy fallback
// re-concatenates the tail on every update (O(n^2) over a long run);
// this keeps a compacting ring with amortized O(1) push/consume.
//
// Exposed as a C ABI for ctypes; built by godsp_tpu_torch/native/__init__.py
// at first use (g++ -O3 -shared) into the package's _build/ directory.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <algorithm>

extern "C" {

// ---- sample decode (quirk parity: [0,1] ranges, wav.go:144-159) ----

// True division (not reciprocal multiply): bit-identical to the numpy
// fallback and the reference's float64-rounded-to-float32 results.
void gdsp_decode_u8(const uint8_t* in, float* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i)
    out[i] = static_cast<float>(in[i]) / 255.0f;
}

void gdsp_decode_i16(const int16_t* in, float* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i)
    out[i] = (static_cast<float>(in[i]) + 32768.0f) / 65535.0f;
}

// ---- overlapped framing (spectral.Segment copy semantics) ----

void gdsp_frame_f32(const float* x, float* out, int64_t nsegs,
                    int64_t nfft, int64_t stride) {
  for (int64_t s = 0; s < nsegs; ++s)
    std::memcpy(out + s * nfft, x + s * stride, nfft * sizeof(float));
}

void gdsp_frame_f64(const double* x, double* out, int64_t nsegs,
                    int64_t nfft, int64_t stride) {
  for (int64_t s = 0; s < nsegs; ++s)
    std::memcpy(out + s * nfft, x + s * stride, nfft * sizeof(double));
}

// ---- growable FIFO stream buffer (raw bytes; dtype-agnostic) ----

struct GdspStreamBuf {
  uint8_t* data;
  int64_t cap;    // allocated bytes
  int64_t head;   // first live byte
  int64_t tail;   // one past last live byte
};

void* gdsp_sbuf_new(int64_t capacity_bytes) {
  auto* b = static_cast<GdspStreamBuf*>(std::malloc(sizeof(GdspStreamBuf)));
  if (!b) return nullptr;
  b->cap = std::max<int64_t>(capacity_bytes, 4096);
  b->data = static_cast<uint8_t*>(std::malloc(b->cap));
  if (!b->data) { std::free(b); return nullptr; }
  b->head = b->tail = 0;
  return b;
}

void gdsp_sbuf_free(void* h) {
  if (!h) return;
  auto* b = static_cast<GdspStreamBuf*>(h);
  std::free(b->data);
  std::free(b);
}

int64_t gdsp_sbuf_size(void* h) {
  auto* b = static_cast<GdspStreamBuf*>(h);
  return b->tail - b->head;
}

// Append n bytes; grows (doubling) and compacts as needed. Returns 0
// on success, -1 on allocation failure.
int gdsp_sbuf_push(void* h, const uint8_t* in, int64_t n) {
  auto* b = static_cast<GdspStreamBuf*>(h);
  const int64_t live = b->tail - b->head;
  if (b->tail + n > b->cap) {
    if (live + n <= b->cap && b->head > 0) {
      // compact in place
      std::memmove(b->data, b->data + b->head, live);
    } else {
      int64_t ncap = b->cap;
      while (live + n > ncap) ncap *= 2;
      auto* nd = static_cast<uint8_t*>(std::malloc(ncap));
      if (!nd) return -1;
      std::memcpy(nd, b->data + b->head, live);
      std::free(b->data);
      b->data = nd;
      b->cap = ncap;
    }
    b->head = 0;
    b->tail = live;
  }
  std::memcpy(b->data + b->tail, in, n);
  b->tail += n;
  return 0;
}

// Copy the first n live bytes into out WITHOUT consuming (the streaming
// driver peeks chunk+halo, then consumes chunk). Returns bytes copied
// (< n if fewer are buffered).
int64_t gdsp_sbuf_peek(void* h, uint8_t* out, int64_t n) {
  auto* b = static_cast<GdspStreamBuf*>(h);
  const int64_t m = std::min(n, b->tail - b->head);
  std::memcpy(out, b->data + b->head, m);
  return m;
}

// Drop the first n live bytes.
void gdsp_sbuf_consume(void* h, int64_t n) {
  auto* b = static_cast<GdspStreamBuf*>(h);
  b->head = std::min(b->head + n, b->tail);
  if (b->head == b->tail) b->head = b->tail = 0;
}

}  // extern "C"
