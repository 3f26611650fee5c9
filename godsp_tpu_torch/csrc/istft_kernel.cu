// Fused inverse STFT (windowed overlap-add of inverse FFTs) for Hopper
// (sm_90a): K6.
//
// Replaces godsp_tpu/ops/pallas_istft.py: istft_overlap_add (inner kernel
// _istft_kernel).  For each row of spectra (F frames of bins complex
// values, natural order) the kernel writes
//   y[t] = sum_f w[t - f hop] * scale * real(IDFT_pad(spec_f))[t - f hop]
// (un-normalized; the caller divides by the window-energy sum), one-sided
// (bins = pad/2 + 1) or full (bins = pad), any pad = 2^k in 2..16384,
// nfft <= pad, 0 < hop <= nfft.
//
// Bound on the H100: each frame reads its bins once (8 bytes each) and
// the row's samples are written once (4 bytes each): at 4096 frames x 513
// bins, hop 256, 21 MB, 0.0063 ms at 3.35 TB/s, against 2.5 pad log2 pad
// flops a frame.  Device memory bounds it, so a frame makes one trip from
// device memory to registers, and its samples one trip back summed.
//
// Design (the redesign; the first design, one frame at a time a
// block, a bit-reversed load completing the pad-point spectrum and log2
// pad radix-2 stages of fft_block.cuh, stays in radix2_probe_kernels.cu as
// the yardstick istft_radix2):
//   * one-sided input: K3's split run backwards (frame_regs.cuh: unsplit)
//     forms the m = pad/2 complex inputs Z[k] from bins k and m - k, read
//     from device memory; the m-point inverse runs on fft_regs.cuh's
//     register-radix passes (row_dft, conjugate table) and its output
//     z[j] = (x[2j], x[2j+1]) holds the frame's real samples in pairs:
//     half the arithmetic and half the exchanges of the pad-point complex
//     inverse.  Full input: the pad-point inverse on the same passes, its
//     real part.  A frame a warp at pad <= 2048 (one-sided; <= 1024 full),
//     a frame a CTA above, as K5.
//   * the window, read as float2 pairs through __ldg, and `scale` are
//     applied in registers; each frame's samples go to its own run of a
//     frame buffer in shared memory (the passes' exchange words, free once
//     every frame of the round is transformed), float2 pairs a lane,
//     the runs' stride chosen so that no warp access meets a bank twice
//     (at pad <= 256 one-sided, <= 512 full, where a store spans several
//     frames, the sums may: tests/test_torch_istft_regs.py counts them).
//   * overlap-add without atomics, in frame order: a CTA transforms its
//     frames a round at a time (eight warps' worth), then each output
//     sample of the round's span is one thread's: it takes its partial
//     sum from the round before (a window of W words, W a power of 2, in
//     shared memory), adds the round's frames that cover it in frame
//     order, and either stores the sample, once no later frame reaches
//     it, or keeps the partial.  Two calls on the same input are bit-equal.
//   * the samples at the row's two ends where the window is below
//     kEdgeTau of its largest magnitude (frame 0's leading run, frame F -
//     1's trailing run, each at most nfft/2; Hann: 15 at nfft 1024, 59 at
//     4096) are then summed again directly in float64 from the frame's bins
//     and a float64 twiddle table (edge_samples): the caller's window-energy division scales their
//     float32 error by 1/w, which there is up to 1e5 (Hann, nfft 1024), and
//     the half-length transform carries about 1.5 dB more error than the
//     pad-point one whose imaginary half was thrown away (PERF.md §6).
//   * a tile of bt frames a CTA: the CTA first recomputes the E =
//     ceil(nfft / hop) - 1 frames before its tile that reach into it, so
//     that it writes its own samples of the signal whole, and the wrapper
//     has nothing to add.  The other way, each CTA writing its tile's span
//     and the wrapper adding each span's nfft - hop tail onto the next
//     one's head (pallas_istft.py:274-296), took 0.0221 ms alone against
//     0.0324 at 4096 frames, 1024/256, but 0.1404 ms by chain against
//     0.0451 (the wrapper's copies and adds), and lost by chain at the
//     Griffin-Lim and hop-160 shapes too (PERF.md §6), so it went.
//
// Precision: the tables are built in float64 on the host and rounded once
// to float32; float32 FMA on CUDA cores; no TF32, no atomics.

#include <cstdint>

#include "frame_regs.cuh"
#include "launch.cuh"

namespace {

using gdsp::frames::opaque;
using gdsp::frames::unsplit;
using gdsp::regs::Row;
using gdsp::regs::Slot;
using gdsp::regs::cta_shape;
using gdsp::regs::default_rows;
using gdsp::regs::out_index;
using gdsp::regs::row_dft;
using gdsp::regs::slot_of;
using gdsp::regs::unroll;
using gdsp::regs::with_log2;

// K6's CTA for a row transform of 2^LOG2R points (HALF: the one-sided
// input's half-length transform, pad = 2^(LOG2R + 1); else pad = 2^LOG2R);
// ops/cuda_istft.py: istft_cta holds the same.
template <int LOG2R, bool HALF>
struct Ola {
  using R = Row<LOG2R>;
  static constexpr int kPad = HALF ? 2 * R::kN : R::kN;
  static constexpr int kFrames = default_rows<LOG2R>();  // frames a round
  static constexpr int kThreads = cta_shape<LOG2R>(kFrames).threads;
  static constexpr int kSlots = cta_shape<LOG2R>(kFrames).slots;
  // Words of a frame's run in the frame buffer.  Where a warp's store (a
  // half-warp's, for HALF's 8-byte pairs) spans several frames, padded so
  // that their runs start on distinct banks; else pad + (hop mod 32)
  // (stride(hop); even for HALF's pairs), so that a warp of the sums that
  // reads two frames at one step, lanes on both sides of a frame's start,
  // reads them on distinct banks.
  static constexpr bool kOneFrameAStore = HALF ? R::kT >= 16 : R::kT >= 32;
  static constexpr int kStride = kOneFrameAStore ? kPad
                               : HALF ? (R::kP >= 2 ? kPad + 2 * R::kT : kPad)
                                      : (R::kP >= 2 ? kPad + R::kT : kPad);
  static __device__ __forceinline__ int stride(int hop) {
    return kOneFrameAStore ? kPad + (hop & (HALF ? 30 : 31)) : kStride;
  }
  static constexpr int kExchange = R::kPasses >= 2 ? kSlots * R::kN * 2 : 0;
  static constexpr int kFbuf = kFrames * (kOneFrameAStore ? kPad + 31 : kStride);
  static constexpr int kRegion = kExchange > kFbuf ? kExchange : kFbuf;  // words
  // CTAs a SM the launch bound asks for, a register cap: K5's at the same
  // row transform (stft_kernel.cu: Frames), whose passes fit it with no
  // spill.
  static constexpr int kMinBlocks = LOG2R == 10 || (LOG2R >= 5 && LOG2R <= 8) ? 2
                                  : LOG2R == 4 || LOG2R == 12 ? 3
                                  : 1024 / kThreads;
};

// The window's samples below kEdgeTau max|w| at each end of a row are
// summed again in float64.  The caller divides the signal by its
// window-energy sum, which at the row's ends is the one frame's w^2 (w[1]^2
// ~ 1e-10 for Hann at nfft 1024): that scales those samples' float32 error
// by 1/w, and it would rule the whole signal's accuracy.  The samples left
// in float32 carry scaled errors whose energy grows as nfft / tau^1.5
// (Hann), about as the signal's own float32 error does, so one relative
// threshold holds the margin across nfft (PERF.md §6: whole-signal margins
// at nfft 1024..4096); ops/cuda_istft.py: EDGE_TAU holds the same.
constexpr float kEdgeTau = 2e-3f;

// Samples of w's leading (or, tail, trailing) run below thr, at most half
// = nfft / 2; the same in every lane.
__device__ __forceinline__ int edge_run(const float* __restrict__ w, int nfft, float thr,
                                        bool tail) {
  const int lane = threadIdx.x & 31;
  const int half = nfft / 2;
  for (int base = 0; base < half; base += 32) {
    const int n = base + lane;
    const bool stop = n >= half || fabsf(__ldg(&w[tail ? nfft - 1 - n : n])) >= thr;
    const unsigned b = __ballot_sync(0xffffffffu, stop);
    if (b) return base + __ffs(b) - 1;
  }
  return half;
}

// The row's edge samples (edge_run's at each end: the first eh of frame 0,
// the last et of frame F - 1), each the inverse DFT of its frame's bins
// summed directly in float64 (a warp a sample, W_pad^{-k n} from the
// float64 table tw64), windowed and scaled, over the float32 transform's
// values in the frame runs.
template <bool HALF, int PAD>
__device__ __forceinline__ void edge_samples(const float2* __restrict__ srow, int bins, int F,
                                             int fa, int fb, int nfft, int stride, float scale,
                                             const float* __restrict__ w,
                                             const double2* __restrict__ tw64, float* fbuf) {
  constexpr int kTop = HALF ? PAD / 2 : PAD - 1;  // the last bin
  const int lane = threadIdx.x & 31;
  float wmax = 0.f;
  for (int n = lane; n < nfft; n += 32) wmax = fmaxf(wmax, fabsf(__ldg(&w[n])));
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) wmax = fmaxf(wmax, __shfl_xor_sync(0xffffffffu, wmax, d));
  const float thr = kEdgeTau * wmax;
  const int eh = fa == 0 ? edge_run(w, nfft, thr, false) : 0;
  const int et = fb == F ? edge_run(w, nfft, thr, true) : 0;
  for (int task = threadIdx.x >> 5; task < eh + et; task += blockDim.x >> 5) {  // whole warps
    const bool head = task < eh;
    const int n = head ? task : nfft - et + (task - eh);
    const int f = head ? 0 : F - 1;
    const float2* x = srow + static_cast<long long>(f) * bins;
    double acc = 0.0;
    for (int k = lane; k <= kTop; k += 32) {
      const float2 v = __ldg(&x[k]);
      const double2 t = __ldg(&tw64[(k * n) & (PAD - 1)]);  // W_pad^{-k n}
      const double re = static_cast<double>(v.x) * t.x - static_cast<double>(v.y) * t.y;
      acc += HALF && k > 0 && k < kTop ? 2.0 * re : re;  // a one-sided spectrum's mirror bins
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, d);
    if (lane == 0) {
      fbuf[(f - fa) * stride + n] =
          static_cast<float>(acc * static_cast<double>(scale) * static_cast<double>(__ldg(&w[n])));
    }
  }
}

template <int LOG2R, bool HALF>
__global__ void __launch_bounds__(Ola<LOG2R, HALF>::kThreads, Ola<LOG2R, HALF>::kMinBlocks)
    istft_kernel(const float2* __restrict__ spec, const float* __restrict__ w,
                 const float2* __restrict__ tw, const double2* __restrict__ tw64,
                 float* __restrict__ out, int F, int bins,
                 int nfft, int hop, int bt, int n_tiles, int win_words, float scale) {
  using K = Ola<LOG2R, HALF>;
  using R = typename K::R;
  extern __shared__ float smem[];
  float* fbuf = smem;                 // frame runs (aliasing the exchange words)
  float* wbuf = smem + K::kRegion;    // partial sums carried to the next round
  // Frame and sample indices within a row are 32-bit (the host checks a
  // row's length); only the row's base offsets are 64-bit.
  const int tile = blockIdx.x % n_tiles;
  const long long row = blockIdx.x / n_tiles;
  const float2* srow = spec + row * F * bins;
  const int f0 = tile * bt;
  const int f1 = f0 + bt < F ? f0 + bt : F;
  const int recompute = (nfft + hop - 1) / hop - 1;  // the frames before f0 that reach it
  const int fs = f0 - recompute > 0 ? f0 - recompute : 0;
  const int slot = threadIdx.x / R::kT;
  const Slot<LOG2R> s = slot_of<LOG2R>(smem, K::kSlots, slot);
  const int stride = K::stride(hop);
  int prev_end = fs * hop;  // samples below it hold a partial sum in wbuf
  for (int fa = fs; fa < f1; fa += K::kFrames) {  // uniform: barriers inside
    const int fb = fa + K::kFrames < f1 ? fa + K::kFrames : f1;
    const int f = fa + slot;
    const bool live = slot < K::kFrames && f < fb;
    const float2* x = srow + static_cast<long long>(live ? f : 0) * bins;
    const float2* twp = opaque(tw);
    const int t = opaque(static_cast<int>(threadIdx.x % R::kT));  // addresses made anew a round
    float2 v[R::kP];
    if constexpr (HALF) {
      unsplit<LOG2R>(v, t, x, twp, live);
    } else {
      unroll<R::kP>([&](auto rr) {
        v[GDSP_IDX(rr)] = live ? __ldg(&x[t + GDSP_IDX(rr) * R::kT]) : make_float2(0.f, 0.f);
      });
    }
    row_dft<LOG2R, true>(v, t, s, twp);
    __syncthreads();  // every frame's exchange reads done: the words become frame runs
    if (live) {
      float* run = fbuf + slot * stride;
      const float* wl = opaque(w);
      unroll<R::kP>([&](auto ii) {
        constexpr int i = GDSP_IDX(ii);
        const int j = t + out_index<LOG2R>(i) * R::kT;
        if constexpr (HALF) {
          if (2 * j < nfft) {
            const float2 wp = 2 * j + 1 < nfft ? __ldg(reinterpret_cast<const float2*>(wl) + j)
                                               : make_float2(__ldg(&wl[2 * j]), 0.f);
            reinterpret_cast<float2*>(run)[j] =
                make_float2(v[i].x * scale * wp.x, v[i].y * scale * wp.y);
          }
        } else {
          if (j < nfft) run[j] = v[i].x * scale * __ldg(&wl[j]);
        }
      });
    }
    __syncthreads();
    if (fa == 0 || fb == F) {  // the round holds the row's first or last frame
      edge_samples<HALF, K::kPad>(srow, bins, F, fa, fb, nfft, stride, scale, w, tw64, fbuf);
      __syncthreads();
    }
    // Each sample of the round's span: its partial, then the round's frames
    // that cover it, in frame order; stored once no later frame reaches it,
    // if it is one of this CTA's samples [lo, hi).
    const int lo = f0 * hop;
    const int hi = f1 < F ? f1 * hop : (f1 - 1) * hop + nfft;
    float* o = out + row * ((F - 1) * static_cast<long long>(hop) + nfft);
    const int s_end = (fb - 1) * hop + nfft;
    const int done = fb == f1 ? s_end : fb * hop;  // samples below it are final
    for (int smp = fa * hop + threadIdx.x; smp < s_end; smp += blockDim.x) {
      float acc = smp < prev_end ? wbuf[smp & (win_words - 1)] : 0.f;
      const int top = smp / hop;                         // the last frame that starts at or before
      const int first = top - (nfft - 1 - (smp - top * hop)) / hop;  // the first that reaches
      const int fl = first > fa ? first : fa;
      const int fh = top < fb - 1 ? top : fb - 1;
      for (int g = fl; g <= fh; ++g) acc += fbuf[(g - fa) * stride + (smp - g * hop)];
      if (smp < done) {
        if (smp >= lo && smp < hi) o[smp] = acc;
      } else {
        wbuf[smp & (win_words - 1)] = acc;
      }
    }
    prev_end = s_end;
    __syncthreads();  // the round's reads done before the next round's exchanges
  }
}

template <int LOG2R, bool HALF>
int launch(const float2* spec, const float* w, const float2* tw, const double2* tw64, float* out,
           long long rows,
           long long F, int bins, int nfft, int hop, int bt, long long n_tiles, int win_words,
           float scale, cudaStream_t stream) {
  using K = Ola<LOG2R, HALF>;
  const long long blocks = rows * n_tiles;
  if (blocks > 0x7fffffffLL || (F - 1) * hop + nfft > 0x7fffffffLL ||
      win_words < (K::kFrames - 1) * hop + nfft || (win_words & (win_words - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(K::kRegion + win_words) * sizeof(float);
  cudaError_t e = gdsp::allow_smem(istft_kernel<LOG2R, HALF>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  istft_kernel<LOG2R, HALF><<<static_cast<unsigned>(blocks), K::kThreads, smem, stream>>>(
      spec, w, tw, tw64, out, static_cast<int>(F), bins, nfft, hop, bt, static_cast<int>(n_tiles),
      win_words, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The overlap-add above over `rows` rows of F frames (spec (rows, F,
// bins) float2; onesided: bins = pad/2 + 1, else pad = bins), pad =
// 2^log2pad (1..14), into out (rows, (F - 1) hop + nfft): tiles of bt
// frames, n_tiles of them a row, each CTA writing the samples [tile bt
// hop, (tile + 1) bt hop) of its row (the last tile to the end) after
// recomputing the ceil(nfft / hop) - 1 frames before its tile.  w is the
// (nfft,) window, 8-byte aligned; tw the conjugate of rfft_table(pad)
// (onesided) or of stockham_table(pad); tw64 the (pad,) float64 W_pad^{-k}
// of the edge samples; win_words a power of 2 at least
// (frames a round - 1) hop + nfft.  Returns cudaErrorInvalidValue for a
// pad out of range, a window too short, a row of 2^31 samples or more or
// a grid past 2^31 - 1 blocks, else cudaGetLastError().
int gdsp_istft_ola(const float2* spec, const float* w, const float2* tw, const double2* tw64,
                   float* out,
                   long long rows, long long F, int bins, int onesided, int nfft, int hop,
                   int log2pad, int bt, long long n_tiles, int win_words, float scale,
                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (onesided) {
    return with_log2<0, 13>(log2pad - 1, [&](auto lg) {
      return launch<decltype(lg)::value, true>(spec, w, tw, tw64, out, rows, F, bins, nfft, hop, bt,
                                               n_tiles, win_words, scale, st);
    });
  }
  return with_log2<1, 14>(log2pad, [&](auto lg) {
    return launch<decltype(lg)::value, false>(spec, w, tw, tw64, out, rows, F, bins, nfft, hop, bt,
                                              n_tiles, win_words, scale, st);
  });
}

// The CTA of pad = 2^log2pad (1..14), one-sided or full, as the kernel
// runs it: out[0] points of the row transform, [1] threads, [2] frames a
// round, [3] words of a frame's run (pad + (hop mod 32) where it is pad),
// [4] exchange words, [5] words before the window of partial sums.
// ops/cuda_istft.py: istft_cta holds the same; the GPU tests compare.
int gdsp_istft_geometry(int log2pad, int onesided, int* out) {
  auto fill = [&](auto k) {
    using K = decltype(k);
    out[0] = K::R::kN;
    out[1] = K::kThreads;
    out[2] = K::kFrames;
    out[3] = K::kStride;
    out[4] = K::kExchange;
    out[5] = K::kRegion;
    return 0;
  };
  if (onesided) {
    return with_log2<0, 13>(log2pad - 1,
                            [&](auto lg) { return fill(Ola<decltype(lg)::value, true>{}); });
  }
  return with_log2<1, 14>(log2pad,
                          [&](auto lg) { return fill(Ola<decltype(lg)::value, false>{}); });
}

}  // extern "C"
