// Fused short-time Fourier transform for Hopper (sm_90a): K5.
//
// Replaces godsp_tpu/ops/pallas_stft.py: stft_pallas (inner kernel
// _stft_kernel).  Frame s of row r of x (rows, L) is
//   x[r, s*stride : s*stride + nfft] * w[:nfft], zero-extended to pad = 2^k,
// and the kernel writes, per frame, one of
//   mode 0 (complex): bins 0..pad/2 as float2 straight into a complex64
//                     output viewed as real, natural order;
//   mode 1 (power):   |X_k|^2, k = 0..pad/2, as float32;
//   mode 2 (mel):     m[j] = sum_k |X_k|^2 fb[j, k] over filter j's band
//                     [band[j].x, band[j].y] of nonzero bins: the power
//                     spectrum never leaves shared memory, and the zeros
//                     outside a triangle add nothing, so the sum is the
//                     dense product's.
//
// Bound on the H100: every frame stores its result, 8 bytes a bin in
// mode 0 and 4 in mode 1, against stride new samples of 4 bytes: at pad =
// 1024, hop 256 the output alone (424 MB over 103,356 frames of the 10-min
// recording) takes 0.127 ms at 3.35 TB/s, the input once 0.032.  At hop <
// nfft each sample is read by nfft / hop frames; the re-reads come from
// L2, so device memory sees each sample about once.  The FFT is 2.5 pad
// log2 pad flops a frame, about 2 flops a byte moved: device memory
// bounds it.  So each frame makes one trip from device memory to
// registers and its result one trip back; what is left on chip (the
// exchanges, barriers, twiddle reads, mel sums) has to hide under it.
//
// Design (PR 15's redesign; the first design, a bit-reversed load into
// shared memory and log2 pad radix-2 stages of fft_block.cuh behind a
// block barrier each, stays in radix2_probe_kernels.cu as the yardstick):
// K3's packed half-length transform (fft_kernels.cu: rfft_pow2_kernel)
// behind a framing load, both in frame_regs.cuh (load_frame, spectrum),
// which K4/K11 and K7 share.  The frame is read as m = pad/2 complex pairs
// z[j] = (x[a+2j] w[2j], x[a+2j+1] w[2j+1]), a = s*stride, as two float
// loads (an odd hop makes a odd: an 8-byte load would be misaligned), the
// window through __ldg, a pair's sample past nfft or past L zero.  Its
// m-point transform runs on fft_regs.cuh's register-radix Stockham passes
// (row_dft) with rfft_table(pad); a frame of m <= 1024 (pad <= 2048) lives
// in one warp and its exchanges are fenced by __syncwarp alone (pad = 1024:
// passes [16, 16, 2], two exchanges, where the radix-2 design ran ten
// block barriers), pad >= 4096 takes a CTA a frame.  K3's split then gives
// bins 0..m from the registers and one more trip through the frame's slot,
// and the mode's epilogue stores from registers, consecutive lanes on
// consecutive bins.  The mel mode writes |X|^2 into the frame's own slot
// (bins k < m in its re plane, bin m at im's first word: the same banks a
// longer re plane would give), then sums each filter over its band along
// k, fb read coalesced through __ldg, reduced by __shfl_xor_sync.  Where a
// frame fills a warp (pad 1024, 2048) a sum of 32 lanes a filter a frame
// would cost more than the band's products, so the CTA's eight frames are
// summed side by side, 4 lanes a frame, each slot rotated by 4 words a
// frame so that the eight frames' runs hit distinct banks
// (tests/test_torch_stft_regs.py counts every access).  Frames of all rows
// are one flat index, f = row * S + s, a CTA taking 8 warps' worth of
// frames (fft_regs.cuh's default rows): any row count, past grid.y's
// 65535.  The mode is a runtime argument: one instantiation a pad (14),
// and the epilogue's registers stay below the passes'.

#include <cstdint>

#include "fft_block.cuh"
#include "frame_regs.cuh"

namespace {

using gdsp::frames::Samples;
using gdsp::frames::load_frame;
using gdsp::frames::spectrum;
using gdsp::regs::Cta;
using gdsp::regs::Row;
using gdsp::regs::Slot;
using gdsp::regs::cta_shape;
using gdsp::regs::default_rows;
using gdsp::regs::out_index;
using gdsp::regs::slot_of;
using gdsp::regs::unroll;
using gdsp::regs::with_log2;

// K5's CTA at pad = 2^(LOG2M + 1): eight warps' frames in the warp route,
// one frame in the block route; and the CTAs a SM its launch bound asks
// for, a register cap.  At pad 1024 the passes fit 64 registers with no
// spill: four CTAs a SM in place of two at 109 registers, faster in a
// same-call comparison on the H100 (PERF.md §6).
template <int LOG2M>
struct Frames {
  static constexpr int kThreads = cta_shape<LOG2M>(default_rows<LOG2M>()).threads;
  // The cap: 64 registers where the passes fit them with no spill (pad <=
  // 16, 1024, 4096 and 16384), 85 (three CTAs a SM) at pad 32 and 8192,
  // 128 where those spilled (pad 64..512) and at pad 2048 (P = 32).
  static constexpr int kMinBlocks = LOG2M == 10 || (LOG2M >= 5 && LOG2M <= 8) ? 2
                                  : LOG2M == 4 || LOG2M == 12 ? 3
                                  : 1024 / kThreads;
};

// Frames of pad = 2m points, m = 2^LOG2M; tw is rfft_table(pad): the
// m-point Stockham table, then W_pad^k, k < m.
template <int LOG2M>
__global__ void __launch_bounds__(Frames<LOG2M>::kThreads, Frames<LOG2M>::kMinBlocks)
stft_kernel(const float* __restrict__ x, const float2* __restrict__ w,
            const float2* __restrict__ tw, float* __restrict__ out,
            const float* __restrict__ fb, const int2* __restrict__ band, long long frames,
            long long S, long long L, int nfft, long long stride, int frames_per_cta, int slots,
            int mode, int n_mels) {
  using R = Row<LOG2M>;
  constexpr int m = R::kN;
  constexpr long long lp = m + 1;
  extern __shared__ float smem[];
  const int slot = threadIdx.x / R::kT;
  const int t = threadIdx.x % R::kT;
  const long long f = static_cast<long long>(blockIdx.x) * frames_per_cta + slot;
  const bool live = slot < frames_per_cta && f < frames;
  const long long row = live ? f / S : 0;
  const long long a = (live ? f - row * S : 0) * stride;
  const Samples edges{nullptr, 0, L, nullptr, 0, 0};  // samples past L read zeros
  const Slot<LOG2M> s = slot_of<LOG2M>(smem, slots, slot);
  float2 v[R::kP];
  load_frame<LOG2M, false>(v, t, x + row * L, nullptr, a, edges, nfft, w, live, s);
  const float top = spectrum<LOG2M>(v, t, s, tw);  // X[t + out_index(i) T] in v[i]
  if (mode == 0) {
    if (!live) return;
    float2* o = reinterpret_cast<float2*>(out) + f * lp;
    unroll<R::kP>([&](auto ii) {
      constexpr int i = GDSP_IDX(ii);
      o[t + out_index<LOG2M>(i) * R::kT] = v[i];
    });
    if (t == 0) o[m] = make_float2(top, 0.f);
    return;
  }
  if (mode == 1) {
    if (!live) return;
    float* o = out + f * lp;
    unroll<R::kP>([&](auto ii) {
      constexpr int i = GDSP_IDX(ii);
      o[t + out_index<LOG2M>(i) * R::kT] = v[i].x * v[i].x + v[i].y * v[i].y;
    });
    if (t == 0) o[m] = top * top;
    return;
  }
  // mel: |X_k|^2 into the frame's slot (k < m: re plane, k = m: im plane),
  // then each filter summed over its band along k (spectrum left the slot
  // free).  Every thread runs every loop to its shuffles (frames past the
  // end sum zeros).
  constexpr int kQ = R::kQ;
  if constexpr (R::kWarp && kQ == 1) {
    // A frame a warp (m = 512, 1024): the CTA's eight frames are summed
    // side by side, 4 lanes along k a frame, warp w taking filters
    // j = w mod 8.  Slot f keeps bin k at (k + 4 f) mod m of its re plane
    // (k = m: im word 4 f), so the eight frames' 4-word runs at one k0 = 0
    // mod 4 fall in eight distinct bank quads.
    const int rot = 4 * slot;
    unroll<R::kP>([&](auto ii) {
      constexpr int i = GDSP_IDX(ii);
      const int k = t + out_index<LOG2M>(i) * R::kT;
      s.re[s.base + ((k + rot) & (m - 1))] = v[i].x * v[i].x + v[i].y * v[i].y;
    });
    if (t == 0) s.im[s.base + rot] = top * top;
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const int fs = lane >> 2;  // the slot this lane sums
    const int kl = lane & 3;
    const long long fg = static_cast<long long>(blockIdx.x) * frames_per_cta + fs;
    const bool flive = fs < frames_per_cta && fg < frames;
    const float* pre = smem + fs * m;
    const float* pim = smem + slots * m + fs * m;
    const int frot = 4 * fs;
    for (int j = threadIdx.x >> 5; j < n_mels; j += 8) {
      const int2 b = __ldg(&band[j]);
      const float* __restrict__ fj = fb + static_cast<long long>(j) * lp;
      float acc = 0.f;
#pragma unroll 4  // four chunks' loads in flight (a few % faster)
      for (int k0 = b.x & ~3; k0 <= b.y; k0 += 4) {
        const int k = k0 + kl;
        if (k >= b.x && k <= b.y) {
          const float p = k < m ? pre[(k + frot) & (m - 1)] : pim[frot];
          acc = fmaf(p, __ldg(&fj[k]), acc);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (flive && kl == 0) out[fg * n_mels + j] = acc;
    }
  } else {
    // Q frames a warp (m <= 256: each frame's T lanes along k, the Q frames
    // interleaved word by word) or a CTA a frame (m >= 2048: each warp of
    // the frame a filter at a time, 32 lanes along k).
    unroll<R::kP>([&](auto ii) {
      constexpr int i = GDSP_IDX(ii);
      s.re[s.base + (t + out_index<LOG2M>(i) * R::kT) * kQ] = v[i].x * v[i].x + v[i].y * v[i].y;
    });
    if (t == 0) s.im[s.base] = top * top;
    s.fence();
    constexpr int G = R::kT < 32 ? R::kT : 32;  // lanes a filter
    constexpr int W = R::kT / G;                // filters summed side by side a frame
    const int lane = t % G;
    const float* pre = s.re + s.base;
    const float* pim = s.im + s.base;
    for (int j = t / G; j < n_mels; j += W) {
      const int2 b = __ldg(&band[j]);
      const float* __restrict__ fj = fb + static_cast<long long>(j) * lp;
      float acc = 0.f;
      for (int k = b.x + lane; k <= b.y; k += G) {
        const float p = k < m ? pre[k * kQ] : pim[(k - m) * kQ];
        acc = fmaf(p, __ldg(&fj[k]), acc);
      }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (live && lane == 0) out[f * n_mels + j] = acc;
    }
  }
}

}  // namespace

extern "C" {

// out = per-frame results of frames s in [0, S) of each of `rows` rows of
// x (rows, L): frame s reads x[s*stride : s*stride + nfft] * w[:nfft],
// zero-extended to pad = 2^log2pad (2..16384).  mode 0: (rows, S,
// pad/2+1) float2; mode 1: (rows, S, pad/2+1) float; mode 2: (rows, S,
// n_mels) float with fb (n_mels, pad/2+1) and band (n_mels) = first and
// last nonzero bin of each filter.  tw is ops/cuda_fft.py's
// rfft_table(pad).  Returns cudaErrorInvalidValue for a pad out of range
// or a grid past 2^31 - 1 blocks, else cudaGetLastError().
int gdsp_stft(const float* x, const float* w, const float2* tw, float* out, const float* fb,
              const int2* band, long long rows, long long L, long long S, int nfft,
              long long stride, int log2pad, int mode, int n_mels, void* stream) {
  return with_log2<0, 13>(log2pad - 1, [&](auto lg) {
    constexpr int LM = decltype(lg)::value;
    const int fpc = default_rows<LM>();
    const Cta c = cta_shape<LM>(fpc);
    const size_t smem = static_cast<size_t>(c.slots) * Row<LM>::kN * 2 * sizeof(float);
    const long long frames = rows * S;
    const long long blocks = (frames + fpc - 1) / fpc;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = gdsp::allow_smem(stft_kernel<LM>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    stft_kernel<LM><<<static_cast<unsigned>(blocks), c.threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
        x, reinterpret_cast<const float2*>(w), tw, out, fb, band, frames, S, L, nfft, stride, fpc,
        c.slots, mode, n_mels);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // extern "C"
