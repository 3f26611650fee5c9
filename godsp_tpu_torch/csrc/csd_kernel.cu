// Fused cross-spectral (Welch CSD) partial sums for Hopper (sm_90a): K7.
//
// Replaces godsp_tpu/ops/pallas_csd.py: csd_power_partials (inner kernel
// _csd_kernel), the two-signal sibling of pwelch_kernel.cu (K4).  Segment
// s of a row frames both signals, x and y, at s*stride (read through L2,
// never materialized as frames), windowed by w[:nfft] and zero-extended
// to pad; the kernel sums mask[s] * conj(X_k) Y_k, k = 0..pad/2,
//   re += xr*yr + xi*yi,   im += xr*yi - xi*yr,
// over the segments of a tile and writes one partial row per tile of re
// and of im, (rows, tiles, pad/2 + 1) each in natural order; the sum over
// tiles is a torch reduction in the wrapper's caller.  No atomics: two
// calls on the same input are bit-equal.
//
// Bound on the H100: each segment costs two real pad-point FFTs, 2 x 2.5
// pad log2 pad flops, against 2 x 4 x stride bytes of new samples: at pad
// 1024, hop 512 ~13 flops a byte, so device memory bounds it (51,678
// segments: 215 MB, 0.064 ms); at hop 160 the flops per byte triple and
// the float32 rate bounds it.
//
// Design (the redesign; the first design, both frames bit-reversed
// into one shared buffer and transformed by fft_block.cuh's radix-2 stages
// behind a block barrier each, stays in radix2_probe_kernels.cu as the
// yardstick csd_radix2): K4's body (frame_regs.cuh: load_frame and
// spectrum) on two frames a segment, x's and y's, each in a slot of its
// own, run side by side: a segment takes a pair of warps (the x frame's
// warp and the y frame's next to it; Q segments a pair at pad <= 512) or,
// at pad >= 4096, a CTA of two frames.  x + i y is not packed into one
// complex transform: that would halve the work but scale the error of Y
// by |X| / |Y|, and coherence's 120 dB bar rides on it.
//
// Registers are what is hard: one warp running both transforms of a
// segment in turn holds the points, the X_k and the sums, 4 x 32 floats a
// lane at pad 1024 before any addressing, and ptxas reuses the first
// transform's twiddle and window loads in the second, so it spilled
// 0.7-1.2 KB a thread at every cap tried (PERF.md §6).  Two warps a
// segment keep K4's registers (where the passes leave too few for the
// sums, at pads 64..512, 8192 and 16384, the sums live in each lane's own
// words of shared memory): after its transform each frame's lanes
// write the half of their bins that the other frame sums (the x frame
// sums the bins of registers i < H = P/2, and X[pad/2], the y frame the
// rest) into their own, now free, slot; a barrier of the pair (bar.sync
// of 64 threads; the CTA's barrier in the block route); each frame reads
// its partner's half and adds mask[s] conj(X) Y into H + H register sums;
// a second barrier frees the slots.  The sums go through frame_regs.cuh's
// store_partials, a warp pair a group, re then im.  The one-warp design
// it was compared with (X_k in registers while y is transformed, the sums
// in each lane's own words of shared memory, two CTAs a SM; pad 1024
// only) spilled about 1 KB a thread and, over 51,678 segments of
// 1024/512 on an H100 80GB HBM3 at 700 W, took 0.93 ms by chain against
// this design's 0.28 in one chip_smoke.py call (the sums in registers
// instead were slower still); it was then removed.

#include <cstdint>

#include "launch.cuh"
#include "frame_regs.cuh"

namespace {

using gdsp::frames::Samples;
using gdsp::frames::frames_per_cta;
using gdsp::frames::load_frame;
using gdsp::frames::opaque;
using gdsp::frames::spectrum;
using gdsp::frames::store_partials;
using gdsp::regs::Cta;
using gdsp::regs::Row;
using gdsp::regs::Slot;
using gdsp::regs::cta_shape;
using gdsp::regs::default_rows;
using gdsp::regs::out_index;
using gdsp::regs::slot_of;
using gdsp::regs::unroll;
using gdsp::regs::with_log2;

// K7's CTA at pad = 2^(LOG2M + 1): the default eight warps (four segments'
// pairs, 4 Q segments) in the warp route, two frames in the block route;
// and the CTAs a SM its launch bound asks for, a register cap: K4's
// (pwelch_kernel.cu: Plan) but where the CTA's twice the threads leave
// fewer (ptxas, PERF.md §6).
template <int LOG2M>
struct Plan {
  using R = Row<LOG2M>;
  static constexpr int kThreads = R::kWarp ? cta_shape<LOG2M>(default_rows<LOG2M>()).threads
                                           : 2 * R::kT;
  static constexpr int kMinBlocks = LOG2M == 5 || LOG2M == 6 || LOG2M >= 12 || LOG2M == 10 ? 1
                                  : LOG2M == 11 ? 3
                                  : LOG2M == 4 || LOG2M == 7 || LOG2M == 8 ? 2
                                  : 3;
  // Where the passes leave too few registers for 2 H sums (pads 64..512,
  // 8192 and 16384; at 16384 a CTA of 1024 threads has 64 registers each)
  // the sums go to each lane's own words of shared memory (sum_word).
  static constexpr bool kSumsInSmem = (LOG2M >= 5 && LOG2M <= 8) || LOG2M >= 12;
};

// Where segment slot `seg`'s sum of bin k lives (kSumsInSmem), counted
// from the start of the sums' re plane: the Q segment slots of a warp
// interleaved word by word as the exchange's, m + 1 words a slot.
template <int LOG2M>
__device__ __forceinline__ int sum_word(int seg, int k) {
  using R = Row<LOG2M>;
  return (seg / R::kQ) * R::kQ * (R::kN + 1) + seg % R::kQ + k * R::kQ;
}

// The pair's barrier: its two warps (kWarp), or the CTA's two frames.
template <bool kWarp>
__device__ __forceinline__ void pair_sync(int pair) {
  if constexpr (kWarp) {
    asm volatile("bar.sync %0, 64;" ::"r"(pair + 1) : "memory");
  } else {
    __syncthreads();
  }
}

template <int LOG2M>
__global__ void __launch_bounds__(Plan<LOG2M>::kThreads, Plan<LOG2M>::kMinBlocks)
csd_partials_kernel(const float* __restrict__ ext_x, const float* __restrict__ ext_y,
                    const float* __restrict__ mask, const float2* __restrict__ w,
                    const float2* __restrict__ tw, float* __restrict__ out_re,
                    float* __restrict__ out_im, long long L, long long S, int nfft,
                    long long stride, int bt, int n_tiles, int fpc, int slots) {
  using R = Row<LOG2M>;
  constexpr int m = R::kN;
  constexpr int lp = m + 1;
  constexpr int P = R::kP;
  constexpr int H = (P + 1) / 2;            // bins (registers i < H) the x frame sums
  constexpr int kSide = R::kWarp ? R::kQ : 1;  // slots between a pair's frames
  extern __shared__ float smem[];
  const int slot = threadIdx.x / R::kT;
  const int t = threadIdx.x % R::kT;
  const bool is_y = (slot / kSide) & 1;
  const int pair = slot / (2 * kSide);                 // the warp pair (block route: 0)
  const int seg = pair * kSide + slot % kSide;         // the segment slot, < fpc when live
  const long long row = blockIdx.x / n_tiles;
  const long long s0 = (static_cast<long long>(blockIdx.x) - row * n_tiles) * bt;
  const int n = static_cast<int>(S - s0 < bt ? S - s0 : bt);  // the tile's segments
  const float* __restrict__ src = (is_y ? ext_y : ext_x) + row * L;
  const float* __restrict__ mr = mask + row * S;
  const Samples edges{nullptr, 0, L, nullptr, 0, 0};
  const Slot<LOG2M> s = slot_of<LOG2M>(smem, slots, slot);
  const Slot<LOG2M> other = slot_of<LOG2M>(smem, slots, slot ^ kSide);
  float* const tops = smem + 2 * slots * m;  // Y[m] of each y frame's slot
  constexpr bool kSmem = Plan<LOG2M>::kSumsInSmem;
  // kSmem: the re plane of the sums of the slots/2 segment slots, then im.
  float* const sums_re = tops + slots;
  float* const sums_im = sums_re + (slots / 2) * lp;
  const int i0 = is_y ? H : 0;               // this frame's share: registers i0 ..
  const int count = is_y ? P - H : H;
  float sum_re[H], sum_im[H];
  float top_sum = 0.f;
  unroll<H>([&](auto ii) {
    constexpr int i = GDSP_IDX(ii);
    sum_re[i] = sum_im[i] = 0.f;
    if constexpr (kSmem) {
      const int w = sum_word<LOG2M>(seg, t + out_index<LOG2M>(i0 + i) * R::kT);
      if (i < count) sums_re[w] = sums_im[w] = 0.f;
    }
  });
  const int steps = (n + fpc - 1) / fpc;
#pragma unroll 1  // one frame's registers at a time
  for (int it = 0; it < steps; ++it) {
    const int j = it * fpc + seg;
    const bool live = seg < fpc && j < n;
    const float ms = live ? __ldg(&mr[s0 + j]) : 0.f;
    const int tl = opaque(t);  // the frame's addresses are computed a frame
    float2 v[P];
    load_frame<LOG2M, false>(v, tl, src, nullptr, (s0 + j) * stride, edges, nfft, w, live, s);
    if constexpr (R::kWarp) {
      if (!__any_sync(0xffffffffu, ms != 0.f)) continue;  // the pair's two warps agree
    } else {
      if (ms == 0.f) continue;  // one segment a CTA: CTA-uniform
    }
    const float top = spectrum<LOG2M>(v, tl, s, tw);
    // The partner's share of this frame's bins into this frame's slot.
    unroll<P>([&](auto ii) {
      constexpr int i = GDSP_IDX(ii);
      if ((i < H) == is_y) s.put(tl + out_index<LOG2M>(i) * R::kT, v[i]);
    });
    if (is_y && tl == 0) tops[slot] = top;
    pair_sync<R::kWarp>(pair);
    unroll<H>([&](auto ii) {
      constexpr int i = GDSP_IDX(ii);
      if (i < count) {
        const int r = i0 + i;
        // X and Y of bin t + out_index(r) T: one is v[r], the other the partner's.
        const float2 mine = is_y ? v[H + i < P ? H + i : 0] : v[i];
        const float2 theirs = other.get(tl + out_index<LOG2M>(r) * R::kT);
        const float2 X = is_y ? theirs : mine;
        const float2 Y = is_y ? mine : theirs;
        const float re = ms * (X.x * Y.x + X.y * Y.y);
        const float im = ms * (X.x * Y.y - X.y * Y.x);
        if constexpr (kSmem) {
          const int w = sum_word<LOG2M>(seg, tl + out_index<LOG2M>(r) * R::kT);
          sums_re[w] += re;
          sums_im[w] += im;
        } else {
          sum_re[i] += re;
          sum_im[i] += im;
        }
      }
    });
    if (!is_y) top_sum += ms * (top * tops[slot ^ kSide]);  // X[m], Y[m] real
    pair_sync<R::kWarp>(pair);  // the partner's reads done before the slot is written again
  }
  if constexpr (kSmem) {
    unroll<H>([&](auto ii) {
      constexpr int i = GDSP_IDX(ii);
      const int w = sum_word<LOG2M>(seg, t + out_index<LOG2M>(i0 + i) * R::kT);
      if (i < count) {
        sum_re[i] = sums_re[w];
        sum_im[i] = sums_im[w];
      }
    });
  }
  const long long o = static_cast<long long>(blockIdx.x) * lp;
  const int groups = R::kWarp ? blockDim.x >> 6 : 1;
  store_partials<LOG2M, H>(sum_re, i0, count, !is_y, top_sum, t, pair, groups, smem, out_re + o);
  store_partials<LOG2M, H>(sum_im, i0, count, !is_y, 0.f, t, pair, groups, smem, out_im + o);
}

// K7's CTA for tiles of `tile` segments: the segments it holds at once,
// its threads and slots (two frames a segment: the x frames' Q-slot warps
// and the y frames'), and its shared memory in floats.  The launch and
// gdsp_csd_geometry both read it.
struct Geometry {
  int fpc;
  Cta c;
  bool sums_in_smem;
  size_t words;
};

template <int LOG2M>
Geometry geometry(int tile) {
  Geometry g;
  g.fpc = frames_per_cta<LOG2M>(tile, 2);
  g.c = cta_shape<LOG2M>(2 * g.fpc);  // fpc: whole warps' Q segments, or 1
  g.sums_in_smem = Plan<LOG2M>::kSumsInSmem;
  g.words = 2 * static_cast<size_t>(g.c.slots) * Row<LOG2M>::kN + g.c.slots +
            (g.sums_in_smem ? static_cast<size_t>(g.c.slots) * (Row<LOG2M>::kN + 1) : 0);
  return g;
}

}  // namespace

extern "C" {

// out_re[r, t, k] + i out_im[r, t, k] = sum over segments s of tile t (bt
// segments a tile) of mask[r, s] * conj(X_s[k]) Y_s[k], X_s =
// FFT_pad(w * ext_x[r, s*stride:]), Y_s likewise of ext_y, for k <=
// pad/2, samples past L_ext zero.  w (pad floats) is read as float2 pairs:
// 8-byte aligned.  tw is ops/cuda_fft.py's rfft_table(pad).  Returns
// cudaErrorInvalidValue for a pad out of range or a grid past 2^31 - 1
// blocks, else cudaGetLastError().
int gdsp_csd_partials(const float* ext_x, const float* ext_y, const float* mask, const float* w,
                      float* out_re, float* out_im, const float2* tw, long long rows,
                      long long L_ext, long long S, int nfft, int stride, int log2pad, int bt,
                      int n_tiles, void* stream) {
  return with_log2<0, 13>(log2pad - 1, [&](auto lg) {
    constexpr int LM = decltype(lg)::value;
    const Geometry g = geometry<LM>(S < bt ? static_cast<int>(S) : bt);
    const size_t smem = g.words * sizeof(float);
    const long long blocks = rows * n_tiles;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = gdsp::allow_smem(csd_partials_kernel<LM>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    csd_partials_kernel<LM><<<static_cast<unsigned>(blocks), g.c.threads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        ext_x, ext_y, mask, reinterpret_cast<const float2*>(w), tw, out_re, out_im, L_ext, S,
        nfft, stride, bt, n_tiles, g.fpc, g.c.slots);
    return static_cast<int>(cudaGetLastError());
  });
}

// K7's CTA at pad = 2^log2pad (1..14) for tiles of `tile` segments, as
// gdsp_csd_partials launches it: out[0] segments it holds at once, [1]
// threads, [2] slots, [3] 1 where the sums live in shared memory.
// ops/cuda_pwelch.py's partials_cta and ops/cuda_csd.py's sums_in_smem
// hold the same; the GPU tests compare.
int gdsp_csd_geometry(int log2pad, int tile, int* out) {
  return with_log2<0, 13>(log2pad - 1, [&](auto lg) {
    const Geometry g = geometry<decltype(lg)::value>(tile);
    out[0] = g.fpc;
    out[1] = g.c.threads;
    out[2] = g.c.slots;
    out[3] = g.sums_in_smem ? 1 : 0;
    return 0;
  });
}

}  // extern "C"
