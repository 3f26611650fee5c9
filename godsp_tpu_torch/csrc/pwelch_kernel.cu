// Fused Welch-periodogram partial sums for Hopper (sm_90a): K4, and K11
// (the same body reading a neighbour shard's head past its block's end).
//
// K4 replaces godsp_tpu/ops/pallas_pwelch.py: pwelch_power_partials (inner
// kernel _pwelch_kernel).  Segment s of a row reads ext[s*stride :
// s*stride + nfft] (the overlap re-read through L2, never materialized as
// frames in device memory), windowed by w[:nfft] and zero-extended to pad;
// the kernel sums mask[s] * |X_k|^2, k = 0..pad/2, over the segments of a
// tile and writes one partial row per tile, (rows, tiles, pad/2 + 1) in
// natural order; the sum over tiles is a torch reduction in the wrapper's
// caller.  No atomics: two calls on the same input are bit-equal.
//
// K11 replaces godsp_tpu/parallel/fused_halo.py: pwelch_power_partials_rdma
// (inner kernel _kernel).  On the TPU one kernel per shard started a
// remote DMA of its block head to its left neighbour at grid step 0 and
// waited for it at the last tile, whose frames cross the block's end.  On
// Hopper no copy is needed: sample j of a segment is the shard's block
// x[j] for j < L and the halo source h[j - L] beyond, where h is the right
// neighbour's block itself (the same card, or a peer card once peer access
// is on) or, on the last shard, the injected tail; the wrapper picks the
// pointer, as the TPU kernel's SMEM `islast` flag did.  Both sources take
// a row stride, so shard blocks stay views of the whole signal: no
// concatenation of block and halo is ever written to device memory.
//
// Bound on the H100: each sample is read nfft/stride times (twice at 50 %
// overlap, the re-reads from L2) and each segment costs a real pad-point
// FFT of 2.5 pad log2 pad flops: at pad 1024, hop 512 that is ~13 flops a
// byte of device memory, below the 20 at which 67 TFLOP/s and 3.35 TB/s
// meet, so device memory bounds it (16384 segments: 33.6 MB, 0.010 ms);
// the output is a few partial rows.  Nothing but the samples need cross
// device memory, so the design keeps every intermediate on chip and the
// per-segment work (the exchanges, fences, twiddle reads) short.
//
// Design (the redesign; the first design, a bit-reversed load into
// shared memory and log2 pad radix-2 stages of fft_block.cuh behind a
// block barrier each, ten at pad 1024, stays in radix2_probe_kernels.cu as
// the yardstick pwelch_radix2): K5's framing load and K3's packed
// half-length transform (frame_regs.cuh: load_frame, spectrum), then the
// masked power sum in registers.  A frame of pad <= 2048 lives in one
// warp (Q frames a warp at pad <= 512), its exchanges fenced by __syncwarp
// alone; pad >= 4096 takes a CTA a frame (fft_regs.cuh's block route).
// Lane t owns bins t + out_index(i) T, the same for every frame, and adds
// mask[s] |X_k|^2 into P registers (bin pad/2 in lane 0's one more),
// under a register cap of Plan's CTAs a SM.  A CTA is one tile of one
// row (one flat index over rows x tiles: any row count, past grid.y's
// 65535); its fpc slots take the tile's segments in turn, segment s0 + it
// fpc + slot at step it; a segment's loads go out beside its mask's
// (samples past the signal read zeros, so a masked-out segment's stay
// inside the rows), then a masked-out segment is skipped by the warp (a
// Q-frame warp skips a step only when all its frames are masked; the
// others add 0).  After the tile, frame_regs.cuh's store_partials sums
// the slots in a fixed order and stores the row.  fpc is the host's: the
// CTA's default eight warps' frames, or fewer when the tile has fewer
// segments (one warp at the streaming chunk's one segment a tile).

#include <cstdint>

#include "fft_block.cuh"
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
using gdsp::regs::slot_of;
using gdsp::regs::unroll;
using gdsp::regs::with_log2;

// K4's CTA at pad = 2^(LOG2M + 1) and the CTAs a SM its launch bound asks
// for, a register cap: the passes' registers (stft_kernel.cu: Frames) and
// P + 1 sums, with no spill (ptxas, PERF.md §6); K11's staging of a frame
// that crosses the block's end takes a few more at pads 1024 and 4096.
template <int LOG2M, bool kHalo>
struct Plan {
  static constexpr int kThreads = cta_shape<LOG2M>(default_rows<LOG2M>()).threads;
  static constexpr int kMinBlocks = LOG2M == 10 || LOG2M == 13 ? 1
                                  : LOG2M == 11 ? (kHalo ? 4 : 6)
                                  : (LOG2M >= 4 && LOG2M <= 8) || LOG2M == 12 ? 2
                                  : LOG2M == 9 && kHalo ? 2
                                  : 3;
};

template <int LOG2M, bool kHalo>
__global__ void __launch_bounds__(Plan<LOG2M, kHalo>::kThreads, Plan<LOG2M, kHalo>::kMinBlocks)
pwelch_partials_kernel(Samples src, const float* __restrict__ mask, long long mask_stride,
                       const float2* __restrict__ w, const float2* __restrict__ tw,
                       float* __restrict__ out, long long S, int nfft, long long stride, int bt,
                       int n_tiles, int fpc, int slots) {
  using R = Row<LOG2M>;
  constexpr int m = R::kN;
  extern __shared__ float smem[];
  const int slot = threadIdx.x / R::kT;
  const int t = threadIdx.x % R::kT;
  const long long row = blockIdx.x / n_tiles;
  const long long s0 = (static_cast<long long>(blockIdx.x) - row * n_tiles) * bt;
  const int n = static_cast<int>(S - s0 < bt ? S - s0 : bt);  // the tile's segments
  const float* __restrict__ x = src.x + row * src.x_stride;
  const float* __restrict__ h = kHalo ? src.h + row * src.h_stride : nullptr;
  const float* __restrict__ mr = mask + row * mask_stride;
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
    load_frame<LOG2M, kHalo>(v, tl, x, h, (s0 + j) * stride, src, nfft, w, live, s);
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
  float* const o = out + static_cast<long long>(blockIdx.x) * (m + 1);
  store_partials<LOG2M, R::kP>(part, 0, R::kP, true, top_sum, t, threadIdx.x >> 5,
                               blockDim.x >> 5, smem, o);
}

// K4's (and K11's) CTA for tiles of `tile` segments: the segments it
// holds at once and its threads and slots.  The launch and
// gdsp_pwelch_geometry both read it.
template <int LOG2M>
Cta geometry(int tile, int* fpc) {
  *fpc = frames_per_cta<LOG2M>(tile, 1);
  return cta_shape<LOG2M>(*fpc);
}

template <bool kHalo>
int launch(const Samples& src, const float* mask, long long mask_stride, const float* w,
           float* out, const float2* tw, long long rows, long long S, int nfft, long long stride,
           int log2pad, int bt, int n_tiles, void* stream) {
  return with_log2<0, 13>(log2pad - 1, [&](auto lg) {
    constexpr int LM = decltype(lg)::value;
    int fpc;
    const Cta c = geometry<LM>(S < bt ? static_cast<int>(S) : bt, &fpc);
    const size_t smem = static_cast<size_t>(c.slots) * Row<LM>::kN * 2 * sizeof(float);
    const long long blocks = rows * n_tiles;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = gdsp::allow_smem(pwelch_partials_kernel<LM, kHalo>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    pwelch_partials_kernel<LM, kHalo><<<static_cast<unsigned>(blocks), c.threads, smem,
                                        static_cast<cudaStream_t>(stream)>>>(
        src, mask, mask_stride, reinterpret_cast<const float2*>(w), tw, out, S, nfft, stride, bt,
        n_tiles, fpc, c.slots);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

extern "C" {

// K4: out[r, t, k] = sum over segments s of tile t (bt segments a tile) of
// mask[r, s] * |FFT_pad(w * ext[r, s*stride:])|^2_k for k <= pad/2, ext
// and mask contiguous rows, samples past L_ext zero.  w (pad floats) is
// read as float2 pairs: 8-byte aligned.  tw is ops/cuda_fft.py's
// rfft_table(pad).  Returns cudaErrorInvalidValue for a pad out of range
// or a grid past 2^31 - 1 blocks, else cudaGetLastError().
int gdsp_pwelch_partials(const float* ext, const float* mask, const float* w, float* out,
                         const float2* tw, long long rows, long long L_ext, long long S, int nfft,
                         int stride, int log2pad, int bt, int n_tiles, void* stream) {
  const Samples src{ext, L_ext, L_ext, nullptr, 0, 0};
  return launch<false>(src, mask, S, w, out, tw, rows, S, nfft, stride, log2pad, bt, n_tiles,
                       stream);
}

// K11: the same sums over a shard block x (rows of L samples, row stride
// x_stride) whose frames continue into h (rows of H samples, row stride
// h_stride); mask rows at mask_stride (0: one mask for every row).
int gdsp_pwelch_partials_halo(const float* x, long long x_stride, long long L, const float* h,
                              long long h_stride, long long H, const float* mask,
                              long long mask_stride, const float* w, float* out,
                              const float2* tw, long long rows, long long S, int nfft, int stride,
                              int log2pad, int bt, int n_tiles, void* stream) {
  const Samples src{x, x_stride, L, h, h_stride, H};
  return launch<true>(src, mask, mask_stride, w, out, tw, rows, S, nfft, stride, log2pad, bt,
                      n_tiles, stream);
}

// K4's and K11's CTA at pad = 2^log2pad (1..14) for tiles of `tile`
// segments, as they launch it: out[0] segments it holds at once, [1]
// threads, [2] slots.  ops/cuda_pwelch.py's partials_cta holds the same;
// the GPU tests compare.
int gdsp_pwelch_geometry(int log2pad, int tile, int* out) {
  return with_log2<0, 13>(log2pad - 1, [&](auto lg) {
    const Cta c = geometry<decltype(lg)::value>(tile, &out[0]);
    out[1] = c.threads;
    out[2] = c.slots;
    return 0;
  });
}

}  // extern "C"
