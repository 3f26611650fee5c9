// K14a: the fused-Welch floor twins for Hopper (sm_90a).  Each is one
// variant of K4's own body (pwelch_kernel.cu: pwelch_partials_kernel) with
// only the part under test changed, so each time is a floor of K4's.
//
// They replace the Pallas elimination twins of tools/probe_pwfloor.py
// (build_variant):
//   loadonly  (:189, _kern_loadonly)  reads the tile's samples, its halo,
//             its mask and the window once and sums them: 1 float a tile
//             (the TPU twin broadcast it over a row);
//   frameonly (:189, _kern_frameonly) K4's framing and window into shared
//             memory, then the mask-weighted sum of the windowed frames,
//             no FFT: pad floats a tile, time order;
//   noframe   (:264, _kern_noframe)   input already framed as (S, pad)
//             rows (K3's layout): window, FFT, |X|^2, masked sum;
//   staged    (:229, _frames_2d / _kern_full2d) the Hopper counterpart of
//             the TPU's 2-D framing: the tile's span of samples,
//             (bt - 1) * stride + nfft of them, comes into shared memory
//             ONCE and the frames are cut from there, where K4 re-reads
//             each sample nfft/stride times through L2; then what K4 does.
// loadonly keeps K4's first design (a grid of tiles x rows).  The
// spectral twins give pad/2 + 1 bins a tile in natural order, as K4.
//
// frameonly_partials_kernel, the frameonly twin redesigned, is K4's body as
// it is today with the transform taken out: K4's tiles, CTA, slots, frame
// order and register cap (K4Plan), each frame a warp read by
// frame_regs.cuh's load_frame (windowed pairs t + r T in lane t's
// registers, pad <= 2048; a CTA a frame from 4096 on), mask[s] times each
// pair summed in registers in frame order, a warp's Q slots by a shuffle
// butterfly, then the CTA's groups in a fixed order through shared memory
// into the tile's pad floats, 16 bytes a thread.  K4 less frameonly prices
// K4's transform, split and |X|^2 (probes/i8full_frameonly.py).  Its
// result is the plain version's sums in another order.  Its first design,
// frameonly_kernel (gdsp_pwfloor_frameonly_shared, kept as the yardstick),
// is K4's first design's framing: a CTA of pad/2 threads a segment at a
// time, each sample loaded 4 bytes a thread with w re-read, scattered
// bit-reversed into shared memory and read back in time order behind two
// block barriers, 0.149 ms by chain at the probe's geometry (NVIDIA H100
// 80GB HBM3, 700.00 W), 13x its bound.
//
// noframe_partials_kernel and staged_partials_kernel, the noframe and
// staged twins redesigned, are K4's body as it is today (frame_regs.cuh: a
// frame a warp at pad <= 2048, K3's half-length transform on fft_regs.cuh,
// the masked sums in registers, store_partials' fixed-order sum; K4's
// tiles, CTA, slots, frame order and register cap (K4Plan); pad >= 4096 a
// CTA a frame) with one change each: where a frame's samples come from.
// Each result equals K4's bit for bit.
//   noframe reads frame s of a row as the pad contiguous floats at s pad
// (load_row): 16 bytes a lane, every load of the frame issued before its
// transform, two pairs a load handed across each even/odd lane pair by one
// shuffle, so that lane t ends with pairs t + r T as load_frame leaves them
// (8-byte pairs ran 3-4 % faster at pad 1024 but spilled at pad 512:
// kNoframeVec); the window product as K4's.  It
// reads the frames' 67.1 MB where K4 reads 33.6 MB and re-reads each
// sample through L2, so the two stand side by side as the probe's answer:
// what K4 costs when framing costs nothing.  The other load, each tile's
// frames brought by one 1-D TMA copy, is the staged twin run on the frames
// flattened (probes/noframe_sdif.py times it).  Its first design,
// spectral_twin_kernel<false> (gdsp_pwfloor_noframe_radix2, kept as the
// yardstick), was K4's first design on the frames: a segment at a time, a
// bit-reversed load and ten radix-2 stages behind barriers, 0.341 ms by
// chain at the probe's geometry, where its frames loaded and summed with
// no transform took 0.094 and its transforms of frames made in registers
// 0.328 (probes/noframe_sdif.py, NVIDIA H100 80GB HBM3, 700.00 W).
//   staged stages each tile's span first, its
// 16-byte units by one 1-D TMA copy on an mbarrier (hopper_async.cuh:
// bulk_load), the up to 3 floats before and after them by thread loads,
// sample a0 of the row at span word a0 mod 4 so that the row's units land
// on the span's (a row starts anywhere: r L floats, any hop), and every
// frame is read from the span (load_staged: pairs as load_frame reads them,
// 8 bytes at once where aligned, zeros past L).  Its result equals K4's
// bit for bit.  Shared memory: K4's slots, the span and 16 bytes
// (staged_smem; 67,616 bytes at the probe's tiles of 16), so three CTAs
// share a SM and one CTA's copy lands while the others transform.  Its
// first design, spectral_twin_kernel<true> (gdsp_pwfloor_staged_radix2,
// kept as the yardstick), was K4's first design on the span: a segment at
// a time, a bit-reversed load and ten radix-2 stages behind barriers,
// 0.341 ms by chain at the probe's geometry where staging the span alone
// took 0.020 (probes/anat_staged.py, NVIDIA H100 80GB HBM3, 700.00 W).
//
// Bound on the H100 at the probe's geometry (nfft = pad = 1024, stride
// 512, 16384 segments): bytes.  loadonly, frameonly, staged and K4 read
// the 33.6 MB of samples once (0.010 ms at 3.35 TB/s; frameonly also
// writes 4.2 MB, 1024 tiles of 1024 floats: 0.0113 ms); noframe reads the
// 67.1 MB of frames (0.020 ms); the FFTs' 4.2e8 float32 operations take
// 0.006 ms at 67 TFLOP/s.  At hop 160 (52,428 segments) the operations
// bound K4 and staged (0.022 ms), the 215 MB of frames noframe (0.065).

#include <cstdint>

#include "fft_block.cuh"
#include "frame_regs.cuh"
#include "hopper_async.cuh"

namespace {

namespace hp = gdsp::hopper;

constexpr int kLoadThreads = 256;
constexpr long long kStagedMaxSmem = 232448;  // bytes of shared memory one block may use

__global__ void loadonly_kernel(const float* __restrict__ ext, const float* __restrict__ mask,
                                const float* __restrict__ w, float* __restrict__ out,
                                long long rows, long long L, long long S, int nfft, int stride,
                                int pad, int bt, int n_tiles) {
  __shared__ float warp_sums[kLoadThreads / 32];
  const long long row = gdsp::block_row();
  if (row >= rows) return;
  const int tile = blockIdx.x;
  const long long s0 = static_cast<long long>(tile) * bt;
  const long long s1 = s0 + bt < S ? s0 + bt : S;
  const float* x = ext + row * L;
  const float* m = mask + row * S;
  const long long lo = s0 * stride;
  const long long end = (s1 - 1) * stride + nfft;
  const long long hi = end < L ? end : L;
  float acc = 0.f;
  for (long long j = lo + threadIdx.x; j < hi; j += blockDim.x) acc += x[j];
  for (long long sg = s0 + threadIdx.x; sg < s1; sg += blockDim.x) acc += m[sg];
  for (int i = threadIdx.x; i < pad; i += blockDim.x) acc += w[i];
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int k = 0; k < static_cast<int>(blockDim.x >> 5); ++k) t += warp_sums[k];
    out[row * n_tiles + tile] = t;
  }
}

__global__ void frameonly_kernel(const float* __restrict__ ext, const float* __restrict__ mask,
                                 const float* __restrict__ w, float* __restrict__ out,
                                 long long rows, long long L, long long S, int nfft, int stride,
                                 int log2pad, int bt, int n_tiles) {
  extern __shared__ float2 s[];
  const long long row = gdsp::block_row();
  if (row >= rows) return;
  const int pad = 1 << log2pad;
  float* acc = reinterpret_cast<float*>(s + pad);
  const int tile = blockIdx.x;
  const float* x = ext + row * L;
  const float* m = mask + row * S;
  for (int i = threadIdx.x; i < pad; i += blockDim.x) acc[i] = 0.f;
  const long long s0 = static_cast<long long>(tile) * bt;
  const long long s1 = s0 + bt < S ? s0 + bt : S;
  for (long long sg = s0; sg < s1; ++sg) {
    const float ms = m[sg];
    if (ms == 0.f) continue;
    const long long base = sg * stride;
    __syncthreads();
    for (int i = threadIdx.x; i < pad; i += blockDim.x) {
      float v = 0.f;
      if (i < nfft && base + i < L) v = x[base + i] * w[i];
      s[gdsp::bit_reverse(i, log2pad)] = make_float2(v, 0.f);
    }
    __syncthreads();
    // Each thread reads back the positions it will own: the frame in
    // time order, from K4's bit-reversed layout.
    for (int i = threadIdx.x; i < pad; i += blockDim.x)
      acc[i] += ms * s[gdsp::bit_reverse(i, log2pad)].x;
  }
  float* o = out + (row * n_tiles + tile) * pad;
  for (int i = threadIdx.x; i < pad; i += blockDim.x) o[i] = acc[i];
}

// noframe's first design (kStaged false): frame s of a row is
// frames[s * pad : (s + 1) * pad].  staged's first design (kStaged true):
// the tile's span of ext is staged in shared memory first, frames are cut
// from it.
template <bool kStaged>
__global__ void spectral_twin_kernel(const float* __restrict__ src, const float* __restrict__ mask,
                                     const float* __restrict__ w, float* __restrict__ out,
                                     const float2* __restrict__ tw, long long rows, long long L,
                                     long long S, int nfft, int stride, int log2pad, int bt,
                                     int n_tiles) {
  extern __shared__ float2 s[];
  const long long row = gdsp::block_row();
  if (row >= rows) return;
  const int pad = 1 << log2pad;
  const int lp = (pad >> 1) + 1;
  float* acc = reinterpret_cast<float*>(s + pad);
  float* span = acc + lp;
  const int tile = blockIdx.x;
  const float* x = src + row * L;
  const float* m = mask + row * S;
  for (int k = threadIdx.x; k < lp; k += blockDim.x) acc[k] = 0.f;

  const long long s0 = static_cast<long long>(tile) * bt;
  const long long s1 = s0 + bt < S ? s0 + bt : S;
  if (kStaged) {
    const long long lo = s0 * stride;
    const int n_span = static_cast<int>((s1 - 1 - s0) * stride + nfft);
    for (int j = threadIdx.x; j < n_span; j += blockDim.x)
      span[j] = lo + j < L ? x[lo + j] : 0.f;
  }
  for (long long sg = s0; sg < s1; ++sg) {
    const float ms = m[sg];
    if (ms == 0.f) continue;
    __syncthreads();  // the span is staged; the previous segment's readers are done
    for (int i = threadIdx.x; i < pad; i += blockDim.x) {
      float v;
      if (kStaged) {
        v = i < nfft ? span[(sg - s0) * stride + i] * w[i] : 0.f;
      } else {
        v = x[sg * pad + i] * w[i];
      }
      s[gdsp::bit_reverse(i, log2pad)] = make_float2(v, 0.f);
    }
    __syncthreads();
    gdsp::block_fft_rows(s, 1, pad, log2pad, tw);
    for (int k = threadIdx.x; k < lp; k += blockDim.x) {
      const float2 c = s[k];
      acc[k] += ms * (c.x * c.x + c.y * c.y);
    }
  }
  float* o = out + (row * n_tiles + tile) * lp;
  for (int k = threadIdx.x; k < lp; k += blockDim.x) o[k] = acc[k];
}

template <bool kStaged>
int launch_spectral(const float* src, const float* mask, const float* w, float* out,
                    const float2* tw, long long rows, long long L, long long S, int nfft,
                    int stride, int log2pad, int bt, int n_tiles, void* stream) {
  const int pad = 1 << log2pad;
  const int lp = (pad >> 1) + 1;
  size_t smem = static_cast<size_t>(pad) * sizeof(float2) + static_cast<size_t>(lp) * 4;
  if (kStaged) smem += static_cast<size_t>((bt - 1) * static_cast<long long>(stride) + nfft) * 4;
  cudaError_t e = gdsp::allow_smem(spectral_twin_kernel<kStaged>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid = gdsp::row_grid(static_cast<unsigned>(n_tiles), rows);
  spectral_twin_kernel<kStaged><<<grid, gdsp::block_threads(pad >> 1), smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      src, mask, w, out, tw, rows, L, S, nfft, stride, log2pad, bt, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// staged redesigned: K4's body, each frame cut from the tile's span in
// shared memory
// ---------------------------------------------------------------------------

using gdsp::frames::frames_per_cta;
using gdsp::frames::opaque;
using gdsp::frames::spectrum;
using gdsp::frames::store_partials;
using gdsp::regs::Cta;
using gdsp::regs::Row;
using gdsp::regs::Slot;
using gdsp::regs::cta_shape;
using gdsp::regs::default_rows;
using gdsp::regs::slot_of;
using gdsp::regs::unroll;
using gdsp::regs::with_log2;

// K4's CTA at pad = 2^(LOG2M + 1) and its register cap, as pwelch_kernel.cu's
// Plan<LOG2M, false> sets them (the same body, spill-free there): the staged
// and noframe redesigns' launch bounds.
template <int LOG2M>
struct K4Plan {
  static constexpr int kThreads = cta_shape<LOG2M>(default_rows<LOG2M>()).threads;
  static constexpr int kMinBlocks = LOG2M == 10 || LOG2M == 13 ? 1
                                  : LOG2M == 11 ? 6
                                  : (LOG2M >= 4 && LOG2M <= 8) || LOG2M == 12 ? 2
                                  : 3;
};

// Floats of a staged CTA's shared memory before its span (its slots, whole
// 16-byte units) and of the span for tiles of bt segments (the samples and
// up to 3 floats before them, so that the span and the row agree mod 16
// bytes; whole units), then 16 bytes for its mbarrier.
__host__ __device__ constexpr long long staged_slot_floats(int slots, int m) {
  return (2LL * slots * m + 3) / 4 * 4;
}
__host__ __device__ constexpr long long staged_span_floats(int bt, int nfft, long long stride) {
  return ((bt - 1) * stride + nfft + 3 + 3) / 4 * 4;
}

// The frame at local sample a of the span sp (sample a0 of the row at
// sp[0]) into v, as frame_regs.cuh's load_frame reads it from the row:
// pairs (x[a + e] w[e], x[a + e + 1] w[e + 1]), e = 2 (t + r T), zeros at or
// past lx = min(nfft, L - (a0 + a)) samples or where live is false.  Where
// the pair's first word is 8-byte aligned in shared memory it is one 8-byte
// read.  Samples at or past lx are not read: the span may end there.
template <int LOG2M>
__device__ __forceinline__ void load_staged(float2* v, int t, const float* sp, long long a,
                                            long long ex, int nfft,
                                            const float2* __restrict__ w, bool live) {
  using R = Row<LOG2M>;
  w = opaque(w);
  const int lx = !live || ex <= 0 ? 0 : ex < nfft ? static_cast<int>(ex) : nfft;
  const float* xa = sp + a;
  const bool even = (reinterpret_cast<uintptr_t>(xa) & 7) == 0;
  unroll<R::kP>([&](auto rr) {
    constexpr int r = GDSP_IDX(rr);
    const int e = 2 * (t + r * R::kT);
    const float2 wp = __ldg(&w[e >> 1]);  // w[e], w[e + 1]: even e, 8-byte aligned
    float2 x;
    if (even && e + 1 < lx) {
      x = *reinterpret_cast<const float2*>(xa + e);
    } else {
      x = make_float2(e < lx ? xa[e] : 0.f, e + 1 < lx ? xa[e + 1] : 0.f);
    }
    v[r] = make_float2(e < lx ? x.x * wp.x : 0.f, e + 1 < lx ? x.y * wp.y : 0.f);
  });
}

// K4's sums (pwelch_kernel.cu: pwelch_partials_kernel<LOG2M, false>) over
// the same tiles, slots and frame order, each tile's span staged first:
// samples s0 stride .. min(L, (s0 + n - 1) stride + nfft) of the row, the
// 16-byte units among them by one 1-D TMA copy on an mbarrier, the up to 3
// floats before the first unit and after the last by thread loads.  Each
// frame's samples are then read from the span (load_staged), not the row.
template <int LOG2M>
__global__ void __launch_bounds__(K4Plan<LOG2M>::kThreads, K4Plan<LOG2M>::kMinBlocks)
staged_partials_kernel(const float* __restrict__ ext, long long L,
                       const float* __restrict__ mask, const float2* __restrict__ w,
                       const float2* __restrict__ tw, float* __restrict__ out, long long S,
                       int nfft, long long stride, int bt, int n_tiles, int fpc, int slots) {
  using R = Row<LOG2M>;
  constexpr int m = R::kN;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sp = smem + staged_slot_floats(slots, m);  // the span: 16-byte aligned
  uint64_t* bar = reinterpret_cast<uint64_t*>(sp + staged_span_floats(bt, nfft, stride));
  const int slot = threadIdx.x / R::kT;
  const int t = threadIdx.x % R::kT;
  const long long row = blockIdx.x / n_tiles;
  const long long s0 = (static_cast<long long>(blockIdx.x) - row * n_tiles) * bt;
  const int n = static_cast<int>(S - s0 < bt ? S - s0 : bt);  // the tile's segments
  const float* __restrict__ x = ext + row * L;
  const float* __restrict__ mr = mask + row * S;

  // The span [a0, a1) of the row, sample a0 at sp[o]: o is a0's float in
  // its 16-byte unit, so the row's units land on the span's.
  const long long a0 = s0 * stride;
  const long long end = (s0 + n - 1) * stride + nfft;
  const long long a1 = end < L ? end : L;
  const int o = static_cast<int>((reinterpret_cast<uintptr_t>(x + a0) >> 2) & 3);
  sp += o;
  const long long u0 = a0 < a1 ? (o == 0 ? 0 : 4 - o) : 0;          // first float of a unit
  const long long u1 = a0 < a1 ? u0 + (a1 - a0 - u0) / 4 * 4 : 0;   // past the last unit
  const bool bulk = u1 > u0;
  if (threadIdx.x == 0 && bulk) {
    hp::mbar_init(bar, 1);
    hp::mbar_init_fence();
    hp::mbar_arrive_expect_tx(bar, static_cast<uint32_t>(4 * (u1 - u0)));
    hp::bulk_load(sp + u0, x + a0 + u0, static_cast<uint32_t>(4 * (u1 - u0)), bar);
  }
  if (!bulk) {  // fewer samples than a unit past the first boundary: all by threads
    for (long long j = threadIdx.x; j < a1 - a0; j += blockDim.x) sp[j] = __ldg(&x[a0 + j]);
  } else if (threadIdx.x < u0) {  // the head: threads 0 .. u0 - 1
    sp[threadIdx.x] = __ldg(&x[a0 + threadIdx.x]);
  } else if (threadIdx.x >= 4 && threadIdx.x - 4 < a1 - a0 - u1) {  // the tail: threads 4 ..
    sp[u1 + threadIdx.x - 4] = __ldg(&x[a0 + u1 + threadIdx.x - 4]);
  }
  __syncthreads();  // the head and tail, the barrier's init
  if (bulk) hp::mbar_wait(bar, 0);

  const Slot<LOG2M> s = slot_of<LOG2M>(smem, slots, slot);
  float part[R::kP];
  float top_sum = 0.f;
  unroll<R::kP>([&](auto ii) { part[GDSP_IDX(ii)] = 0.f; });
  const int steps = (n + fpc - 1) / fpc;
#pragma unroll 1  // one frame's registers at a time
  for (int it = 0; it < steps; ++it) {
    const int j = it * fpc + slot;
    const bool live = slot < fpc && j < n;
    const float ms = live ? __ldg(&mr[s0 + j]) : 0.f;
    const int tl = opaque(t);  // the frame's addresses are computed a frame
    float2 v[R::kP];
    const long long a = static_cast<long long>(j) * stride;
    load_staged<LOG2M>(v, tl, sp, a, L - (a0 + a), nfft, w, live);
    if constexpr (R::kWarp) {
      if (!__any_sync(0xffffffffu, ms != 0.f)) continue;  // warp-uniform
    } else {
      if (ms == 0.f) continue;  // one frame a CTA: CTA-uniform
    }
    const float top = spectrum<LOG2M>(v, tl, s, tw);
    unroll<R::kP>([&](auto ii) {
      constexpr int i = GDSP_IDX(ii);
      part[i] += ms * (v[i].x * v[i].x + v[i].y * v[i].y);
    });
    top_sum += ms * (top * top);
  }
  float* const o_row = out + static_cast<long long>(blockIdx.x) * (m + 1);
  store_partials<LOG2M, R::kP>(part, 0, R::kP, true, top_sum, t, threadIdx.x >> 5,
                               blockDim.x >> 5, smem, o_row);
}

// Bytes of a staged CTA's shared memory at pad = 2^(LOG2M + 1) for tiles of
// bt segments (fpc, slots: K4's CTA for that tile).
template <int LOG2M>
long long staged_smem(int bt, int nfft, long long stride, int* fpc, Cta* c) {
  *fpc = frames_per_cta<LOG2M>(bt, 1);
  *c = cta_shape<LOG2M>(*fpc);
  return 4 * (staged_slot_floats(c->slots, Row<LOG2M>::kN) + staged_span_floats(bt, nfft, stride))
         + 16;
}

int launch_staged(const float* ext, const float* mask, const float* w, float* out,
                  const float2* tw, long long rows, long long L, long long S, int nfft,
                  long long stride, int log2pad, int bt, int n_tiles, void* stream) {
  return with_log2<0, 13>(log2pad - 1, [&](auto lg) {
    constexpr int LM = decltype(lg)::value;
    int fpc;
    Cta c;
    const long long smem = staged_smem<LM>(S < bt ? static_cast<int>(S) : bt, nfft, stride,
                                           &fpc, &c);
    const long long blocks = rows * n_tiles;
    if (blocks > 0x7fffffffLL || smem > kStagedMaxSmem)
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = gdsp::allow_smem(staged_partials_kernel<LM>, static_cast<size_t>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    staged_partials_kernel<LM><<<static_cast<unsigned>(blocks), c.threads,
                                 static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
        ext, L, mask, reinterpret_cast<const float2*>(w), tw, out, S, nfft, stride,
        S < bt ? static_cast<int>(S) : bt, n_tiles, fpc, c.slots);
    return static_cast<int>(cudaGetLastError());
  });
}

// ---------------------------------------------------------------------------
// noframe redesigned: K4's body, frame s of a row the pad floats at s pad
// ---------------------------------------------------------------------------

// Bytes a lane reads from a frame row at once: 16 (two pairs, handed
// across each even/odd lane pair by one shuffle) or 8 (one pair, each warp
// access 8 T contiguous bytes).  8 ran 3-4 % faster by chain at pad 1024
// (probes/noframe_sdif.py: the shuffles and selects cost more than the
// loads they save) but spilled 4 bytes a thread at pad 512 under K4Plan's
// register cap (tests/test_torch_cuda.py: the no-spill test); 16 spills at
// no pad.
constexpr int kNoframeVec = 16;

// The frame at xa (pad = 2m contiguous floats, kNoframeVec-byte aligned at
// pad >= 4) into v as frame_regs.cuh's load_frame lays it out: v[r] =
// (x[e] w[e], x[e + 1] w[e + 1]), e = 2 (t + r T); zeros where live is
// false.  Every load of the frame is issued before the first product.  A
// 16-byte load holds two pairs of one T-lane row of the frame: in each
// block of 2T pairs lane 2k reads unit k (pairs 2k, 2k + 1: register 2u
// of lanes 2k and 2k + 1) and lane 2k + 1 unit k + T/2 (pairs 2k + T,
// 2k + 1 + T: register 2u + 1 of both), so the T lanes read the block's
// 16T bytes and one __shfl_xor_sync a register hands each lane its other
// pair (ops/cuda_probes.py: noframe_load_map).  The window product is
// __fmul_rn: load_frame's x w, which a select keeps out of any fused
// multiply-add, so the frame's values equal K4's.
template <int LOG2M>
__device__ __forceinline__ void load_row(float2* v, int t, const float* __restrict__ xa,
                                         const float2* __restrict__ w, bool live) {
  using R = Row<LOG2M>;
  w = opaque(w);
  if constexpr (kNoframeVec == 8 || R::kP == 1) {  // pad 2: one pair, 8 bytes
    const float2* x2 = reinterpret_cast<const float2*>(xa);
    unroll<R::kP>([&](auto rr) {
      constexpr int r = GDSP_IDX(rr);
      v[r] = live ? __ldg(&x2[t + r * R::kT]) : make_float2(0.f, 0.f);
    });
  } else if constexpr (R::kT == 1) {  // one lane a frame (pad <= 32): pairs 2u, 2u + 1
    const float4* x4 = reinterpret_cast<const float4*>(xa);
    unroll<R::kP / 2>([&](auto uu) {
      constexpr int u = GDSP_IDX(uu);
      const float4 q = live ? __ldg(&x4[u]) : make_float4(0.f, 0.f, 0.f, 0.f);
      v[2 * u] = make_float2(q.x, q.y);
      v[2 * u + 1] = make_float2(q.z, q.w);
    });
  } else {
    const float4* x4 = reinterpret_cast<const float4*>(xa);
    const bool odd = t & 1;
    const int unit = (t >> 1) + (odd ? R::kT / 2 : 0);
    float4 q[R::kP / 2];
    unroll<R::kP / 2>([&](auto uu) {
      constexpr int u = GDSP_IDX(uu);
      q[u] = live ? __ldg(&x4[u * R::kT + unit]) : make_float4(0.f, 0.f, 0.f, 0.f);
    });
    unroll<R::kP / 2>([&](auto uu) {
      constexpr int u = GDSP_IDX(uu);
      const float2 a = make_float2(q[u].x, q[u].y);
      const float2 b = make_float2(q[u].z, q[u].w);
      const float2 send = odd ? a : b;  // the partner's pair
      const float2 got = make_float2(__shfl_xor_sync(0xffffffffu, send.x, 1),
                                     __shfl_xor_sync(0xffffffffu, send.y, 1));
      v[2 * u] = odd ? got : a;
      v[2 * u + 1] = odd ? b : got;
    });
  }
  unroll<R::kP>([&](auto rr) {
    constexpr int r = GDSP_IDX(rr);
    const float2 wp = __ldg(&w[t + r * R::kT]);  // w[e], w[e + 1]
    v[r] = make_float2(__fmul_rn(v[r].x, wp.x), __fmul_rn(v[r].y, wp.y));
  });
}

// K4's sums (pwelch_kernel.cu: pwelch_partials_kernel<LOG2M, false>) over
// the same tiles, slots and frame order, frame s0 + j of a row read from
// frames[(row S + s0 + j) pad ..] (load_row) instead of cut from a signal.
template <int LOG2M>
__global__ void __launch_bounds__(K4Plan<LOG2M>::kThreads, K4Plan<LOG2M>::kMinBlocks)
noframe_partials_kernel(const float* __restrict__ frames, const float* __restrict__ mask,
                        const float2* __restrict__ w, const float2* __restrict__ tw,
                        float* __restrict__ out, long long S, int bt, int n_tiles, int fpc,
                        int slots) {
  using R = Row<LOG2M>;
  constexpr int m = R::kN;
  extern __shared__ float smem[];
  const int slot = threadIdx.x / R::kT;
  const int t = threadIdx.x % R::kT;
  const long long row = blockIdx.x / n_tiles;
  const long long s0 = (static_cast<long long>(blockIdx.x) - row * n_tiles) * bt;
  const int n = static_cast<int>(S - s0 < bt ? S - s0 : bt);  // the tile's segments
  const float* __restrict__ x = frames + (row * S + s0) * (2 * m);
  const float* __restrict__ mr = mask + row * S;
  const Slot<LOG2M> s = slot_of<LOG2M>(smem, slots, slot);
  float part[R::kP];
  float top_sum = 0.f;
  unroll<R::kP>([&](auto ii) { part[GDSP_IDX(ii)] = 0.f; });
  const int steps = (n + fpc - 1) / fpc;
#pragma unroll 1  // one frame's registers at a time
  for (int it = 0; it < steps; ++it) {
    const int j = it * fpc + slot;
    const bool live = slot < fpc && j < n;
    const float ms = live ? __ldg(&mr[s0 + j]) : 0.f;
    const int tl = opaque(t);  // the frame's addresses are computed a frame
    float2 v[R::kP];
    load_row<LOG2M>(v, tl, x + static_cast<long long>(j) * (2 * m), w, live);
    if constexpr (R::kWarp) {
      if (!__any_sync(0xffffffffu, ms != 0.f)) continue;  // warp-uniform
    } else {
      if (ms == 0.f) continue;  // one frame a CTA: CTA-uniform
    }
    const float top = spectrum<LOG2M>(v, tl, s, tw);
    unroll<R::kP>([&](auto ii) {
      constexpr int i = GDSP_IDX(ii);
      part[i] += ms * (v[i].x * v[i].x + v[i].y * v[i].y);
    });
    top_sum += ms * (top * top);
  }
  float* const o_row = out + static_cast<long long>(blockIdx.x) * (m + 1);
  store_partials<LOG2M, R::kP>(part, 0, R::kP, true, top_sum, t, threadIdx.x >> 5,
                               blockDim.x >> 5, smem, o_row);
}

int launch_noframe(const float* frames, const float* mask, const float* w, float* out,
                   const float2* tw, long long rows, long long S, int log2pad, int bt,
                   int n_tiles, void* stream) {
  return with_log2<0, 13>(log2pad - 1, [&](auto lg) {
    constexpr int LM = decltype(lg)::value;
    const int fpc = frames_per_cta<LM>(S < bt ? static_cast<int>(S) : bt, 1);
    const Cta c = cta_shape<LM>(fpc);
    const size_t smem = static_cast<size_t>(c.slots) * Row<LM>::kN * 2 * sizeof(float);
    const long long blocks = rows * n_tiles;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = gdsp::allow_smem(noframe_partials_kernel<LM>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    noframe_partials_kernel<LM><<<static_cast<unsigned>(blocks), c.threads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
        frames, mask, reinterpret_cast<const float2*>(w), tw, out, S, bt, n_tiles, fpc, c.slots);
    return static_cast<int>(cudaGetLastError());
  });
}

// ---------------------------------------------------------------------------
// frameonly redesigned: K4's body without the transform
// ---------------------------------------------------------------------------

using gdsp::frames::Samples;
using gdsp::frames::load_frame;

// K4's sums (pwelch_kernel.cu: pwelch_partials_kernel<LOG2M, false>) with
// the transform taken out: over the same tiles, slots and frame order, each
// frame read by load_frame (pairs (x w) t + r T of lane t, zeros past nfft
// and L), mask[s] times each pair summed in registers in frame order, the
// Q slots a warp holds (pad <= 512) summed by a __shfl_xor_sync butterfly
// over the lane bits above T, then the CTA's groups (its warps; the one
// CTA of the block route) in order through shared memory into the tile's
// pad floats, 16 bytes a thread.  smem: K4's slots, which hold every
// group's pad floats.
template <int LOG2M>
__global__ void __launch_bounds__(K4Plan<LOG2M>::kThreads, K4Plan<LOG2M>::kMinBlocks)
frameonly_partials_kernel(Samples src, const float* __restrict__ mask,
                          const float2* __restrict__ w, float* __restrict__ out, long long S,
                          int nfft, long long stride, int bt, int n_tiles, int fpc, int slots) {
  using R = Row<LOG2M>;
  constexpr int pad = 2 * R::kN;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int slot = threadIdx.x / R::kT;
  const int t = threadIdx.x % R::kT;
  const long long row = blockIdx.x / n_tiles;
  const long long s0 = (static_cast<long long>(blockIdx.x) - row * n_tiles) * bt;
  const int n = static_cast<int>(S - s0 < bt ? S - s0 : bt);  // the tile's segments
  const float* __restrict__ x = src.x + row * src.x_stride;
  const float* __restrict__ mr = mask + row * S;
  const Slot<LOG2M> s = slot_of<LOG2M>(smem, slots, slot);  // load_frame's, unused without a halo
  float2 part[R::kP];
  unroll<R::kP>([&](auto ii) { part[GDSP_IDX(ii)] = make_float2(0.f, 0.f); });
  const int steps = (n + fpc - 1) / fpc;
#pragma unroll 1  // one frame's registers at a time
  for (int it = 0; it < steps; ++it) {
    const int j = it * fpc + slot;
    const bool live = slot < fpc && j < n;
    const float ms = live ? __ldg(&mr[s0 + j]) : 0.f;
    const int tl = opaque(t);  // the frame's addresses are computed a frame
    float2 v[R::kP];
    load_frame<LOG2M, false>(v, tl, x, nullptr, (s0 + j) * stride, src, nfft, w, live, s);
    unroll<R::kP>([&](auto ii) {
      constexpr int i = GDSP_IDX(ii);
      part[i].x += ms * v[i].x;
      part[i].y += ms * v[i].y;
    });
  }
  if constexpr (R::kWarp) {
#pragma unroll
    for (int d = R::kT; d < 32; d <<= 1) {
      unroll<R::kP>([&](auto ii) {
        constexpr int i = GDSP_IDX(ii);
        part[i].x += __shfl_xor_sync(0xffffffffu, part[i].x, d);
        part[i].y += __shfl_xor_sync(0xffffffffu, part[i].y, d);
      });
    }
  }
  // Group g's sums at smem[g pad ..], pair p at words 2 p, 2 p + 1: the
  // first slot's lanes of each warp write them (the block route's one slot
  // all of its threads).
  const int group = R::kWarp ? static_cast<int>(threadIdx.x >> 5) : 0;
  const int groups = R::kWarp ? static_cast<int>(blockDim.x >> 5) : 1;
  if (!R::kWarp || (threadIdx.x & 31) < R::kT) {
    float2* red = reinterpret_cast<float2*>(smem + group * pad);
    unroll<R::kP>([&](auto ii) {
      constexpr int i = GDSP_IDX(ii);
      red[t + i * R::kT] = part[i];
    });
  }
  __syncthreads();
  float* const o = out + static_cast<long long>(blockIdx.x) * pad;
  if constexpr (pad % 4 == 0) {
    const float4* red4 = reinterpret_cast<const float4*>(smem);
    for (int u = threadIdx.x; u < pad / 4; u += blockDim.x) {
      float4 sum = red4[u];
      for (int g = 1; g < groups; ++g) {
        const float4 q = red4[g * (pad / 4) + u];
        sum = make_float4(sum.x + q.x, sum.y + q.y, sum.z + q.z, sum.w + q.w);
      }
      reinterpret_cast<float4*>(o)[u] = sum;
    }
  } else {
    for (int k = threadIdx.x; k < pad; k += blockDim.x) {
      float sum = smem[k];
      for (int g = 1; g < groups; ++g) sum += smem[g * pad + k];
      o[k] = sum;
    }
  }
}

int launch_frameonly(const float* ext, const float* mask, const float* w, float* out,
                     long long rows, long long L, long long S, int nfft, long long stride,
                     int log2pad, int bt, int n_tiles, void* stream) {
  return with_log2<0, 13>(log2pad - 1, [&](auto lg) {
    constexpr int LM = decltype(lg)::value;
    const int fpc = frames_per_cta<LM>(S < bt ? static_cast<int>(S) : bt, 1);
    const Cta c = cta_shape<LM>(fpc);
    const size_t smem = static_cast<size_t>(c.slots) * Row<LM>::kN * 2 * sizeof(float);
    const long long blocks = rows * n_tiles;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = gdsp::allow_smem(frameonly_partials_kernel<LM>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const Samples src{ext, L, L, nullptr, 0, 0};
    frameonly_partials_kernel<LM><<<static_cast<unsigned>(blocks), c.threads, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
        src, mask, reinterpret_cast<const float2*>(w), out, S, nfft, stride, bt, n_tiles, fpc,
        c.slots);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

extern "C" {

// loadonly: out[r, t] = the sum of ext[r, t*bt*stride : end of the tile's
// last frame] (clipped to L_ext), mask[r, tile's segments] and w[:pad].
int gdsp_pwfloor_loadonly(const float* ext, const float* mask, const float* w, float* out,
                          long long rows, long long L_ext, long long S, int nfft, int stride,
                          int pad, int bt, int n_tiles, void* stream) {
  const dim3 grid = gdsp::row_grid(static_cast<unsigned>(n_tiles), rows);
  loadonly_kernel<<<grid, kLoadThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ext, mask, w, out, rows, L_ext, S, nfft, stride, pad, bt, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// frameonly: out[r, t, i] = sum over segments s of tile t of
// mask[r, s] * w[i] * ext[r, s*stride + i] (i < nfft, zero to pad), on K4's
// body without the transform (frameonly_partials_kernel): K4's tiles, CTA
// and frame order, the sums in registers, the groups in a fixed order.  w
// 8-byte aligned (read as float2 pairs, as K4).  Returns
// cudaErrorInvalidValue for a pad out of range or a grid past 2^31 - 1
// blocks, else cudaGetLastError().
int gdsp_pwfloor_frameonly(const float* ext, const float* mask, const float* w, float* out,
                           long long rows, long long L_ext, long long S, int nfft, int stride,
                           int log2pad, int bt, int n_tiles, void* stream) {
  return launch_frameonly(ext, mask, w, out, rows, L_ext, S, nfft, stride, log2pad, bt, n_tiles,
                          stream);
}

// frameonly's first design, the yardstick: the same sums, a segment at a
// time through a bit-reversed round trip in shared memory behind two block
// barriers.
int gdsp_pwfloor_frameonly_shared(const float* ext, const float* mask, const float* w, float* out,
                                  long long rows, long long L_ext, long long S, int nfft,
                                  int stride, int log2pad, int bt, int n_tiles, void* stream) {
  const int pad = 1 << log2pad;
  const size_t smem = static_cast<size_t>(pad) * (sizeof(float2) + 4);
  cudaError_t e = gdsp::allow_smem(frameonly_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid = gdsp::row_grid(static_cast<unsigned>(n_tiles), rows);
  frameonly_kernel<<<grid, gdsp::block_threads(pad >> 1), smem,
                     static_cast<cudaStream_t>(stream)>>>(ext, mask, w, out, rows, L_ext, S, nfft,
                                                          stride, log2pad, bt, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// noframe's first design, the yardstick: out[r, t, k] = sum over segments
// s of tile t of mask[r, s] * |FFT_pad(w * frames[r, s, :])|^2_k, k <=
// pad/2, a segment at a time by K4's first design (a bit-reversed load and
// radix-2 stages behind barriers); tw is twiddle_table(pad).
int gdsp_pwfloor_noframe_radix2(const float* frames, const float* mask, const float* w,
                                float* out, const float2* tw, long long rows, long long S,
                                int log2pad, int bt, int n_tiles, void* stream) {
  const int pad = 1 << log2pad;
  return launch_spectral<false>(frames, mask, w, out, tw, rows, S * pad, S, pad, pad, log2pad,
                                bt, n_tiles, stream);
}

// staged's first design, the yardstick: K4's sums with each tile's span
// staged once in shared memory, then K4's first design (a bit-reversed
// load and radix-2 stages behind barriers) on each segment.
int gdsp_pwfloor_staged_radix2(const float* ext, const float* mask, const float* w, float* out,
                               const float2* tw, long long rows, long long L_ext, long long S,
                               int nfft, int stride, int log2pad, int bt, int n_tiles,
                               void* stream) {
  return launch_spectral<true>(ext, mask, w, out, tw, rows, L_ext, S, nfft, stride, log2pad, bt,
                               n_tiles, stream);
}

// staged redesigned: K4's sums (gdsp_pwelch_partials) over K4's tiles, CTA
// and frame order, each tile's span staged once in shared memory by the TMA
// and every frame cut from there; equal to gdsp_pwelch_partials bit for
// bit.  Returns cudaErrorInvalidValue for a pad out of range, a grid past
// 2^31 - 1 blocks or a tile whose span does not fit (gdsp_pwfloor_staged_geometry).
int gdsp_pwfloor_staged(const float* ext, const float* mask, const float* w, float* out,
                        const float2* tw, long long rows, long long L_ext, long long S, int nfft,
                        int stride, int log2pad, int bt, int n_tiles, void* stream) {
  return launch_staged(ext, mask, w, out, tw, rows, L_ext, S, nfft, stride, log2pad, bt, n_tiles,
                       stream);
}

// The staged CTA at pad = 2^log2pad (1..14) for tiles of `tile` segments:
// out[0] segments it holds at once, [1] threads, [2] slots, [3] bytes of
// shared memory.  ops/cuda_probes.py's staged_cta holds the same; the GPU
// tests compare.
int gdsp_pwfloor_staged_geometry(int log2pad, int tile, int nfft, int stride, long long* out) {
  return with_log2<0, 13>(log2pad - 1, [&](auto lg) {
    int fpc;
    Cta c;
    out[3] = staged_smem<decltype(lg)::value>(tile, nfft, stride, &fpc, &c);
    out[0] = fpc;
    out[1] = c.threads;
    out[2] = c.slots;
    return 0;
  });
}

// noframe redesigned: K4's sums over frames given as (rows, S, pad) rows,
// on K4's tiles, CTA and frame order: equal to gdsp_pwelch_partials on the
// frames flattened to (rows, S pad) at nfft = stride = pad, bit for bit.
// frames kNoframeVec-byte aligned (8-byte at pad 2), w 8-byte aligned; tw is
// ops/cuda_fft.py's rfft_table(pad).  Returns cudaErrorInvalidValue for a
// pad out of range or a grid past 2^31 - 1 blocks, else cudaGetLastError().
int gdsp_pwfloor_noframe(const float* frames, const float* mask, const float* w, float* out,
                         const float2* tw, long long rows, long long S, int log2pad, int bt,
                         int n_tiles, void* stream) {
  return launch_noframe(frames, mask, w, out, tw, rows, S, log2pad, bt, n_tiles, stream);
}

}  // extern "C"
