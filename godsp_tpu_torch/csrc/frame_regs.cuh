// One frame's one-sided spectrum in registers, and the partial sums of a
// CTA's frames: the framing load and the spectrum are the body that K5
// (stft_kernel.cu, beside its three epilogues), K4/K11 (pwelch_kernel.cu)
// and K7 (csd_kernel.cu) share; the partial sums are K4/K11's and K7's.
// unsplit is K3's split run backwards, the load of K6 (istft_kernel.cu).
//
// Frame s of a row reads samples a = s * stride .. a + nfft - 1, windowed
// by w[:nfft] and zero-extended to pad = 2m.  load_frame reads it as m
// complex pairs z[j] = (x[a+2j] w[2j], x[a+2j+1] w[2j+1]), lane t holding
// pairs t + r T (r < P, fft_regs.cuh's first-pass layout), as two float
// loads (an odd hop makes a odd: an 8-byte load would be misaligned) and
// the window as one float2 through __ldg.  A sample comes from x for j = a
// + e < L, from the halo source h at j - L for L <= j < L + H (K11: the
// choice is made per element, since a pair may straddle L at an odd hop;
// such frames stage their samples in the slot), and is zero past nfft or
// past both.  spectrum then runs the m-point
// transform on fft_regs.cuh's register-radix passes with cuda_fft's
// rfft_table(pad) and K3's split (fft_kernels.cu: rfft_pow2_kernel) from
// registers and one more trip through the frame's slot:
//   X[k] = 1/2 (Z[k] + conj Z[m-k]) - 1/2 i W_pad^k (Z[k] - conj Z[m-k]),
// leaving X[t + out_index(i) T] in v[i] and returning X[m] = Re Z[0] -
// Im Z[0] in lane t = 0.
//
// store_partials sums the CTA's slots into one row of m + 1 floats, in a
// fixed order, so two calls on the same input are bit-equal: in the warp
// route the Q slots a warp holds (pad <= 512) by a __shfl_xor_sync
// butterfly over the lane bits above T (every lane ends with the same
// sums), then each group's sums (K4: a warp's, K7: a warp pair's) in its
// own run of m + 1 words at the start of shared memory (the exchange
// words, free once every warp is past its last frame), then, bin k by
// thread k (mod the CTA's threads), the groups in order.  Every warp
// access of it is one word a bank: the T lanes of a warp's first slot
// write consecutive words, the readers consecutive words
// (ops/cuda_pwelch.py: reduce_word, counted by
// tests/test_torch_pwelch_regs.py).  In the block route (pad >= 4096, one
// segment a CTA) and in a CTA of one group (a tile of fewer segments than
// a warp's Q) each thread of the first slots stores its own bins.

#pragma once

#include <cuda_runtime.h>

#include "fft_regs.cuh"

namespace gdsp {
namespace frames {

using regs::Row;
using regs::out_index;
using regs::row_dft;
using regs::unroll;

// Where a row's samples come from: x[j] for j < L, then h[j - L] for
// j - L < H (H = 0: none); zeros past both.  Row r starts at r * x_stride
// (r * h_stride).
struct Samples {
  const float* x;
  long long x_stride;
  long long L;
  const float* h;
  long long h_stride;
  long long H;
};

// p, as a value the compiler cannot see through.  The window and twiddle
// loads of a frame depend on the thread alone, so without this the
// compiler hoists them out of the frame loop and keeps every one live
// across frames (K4's 16 window pairs and ~60 twiddles a thread at pad
// 16384), far past the register cap; ptxas then spills.
template <class T>
__device__ __forceinline__ const T* opaque(const T* p) {
  asm volatile("" : "+l"(p));
  return p;
}

// The same for a lane index: every address a frame derives from it is
// computed anew a frame, not hoisted out of the frame loop and held.
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

// The frame at sample a of row pointers x and h into v (the first pass's
// inputs) through its slot s; live false loads zeros (a slot past the
// tile).  Samples past the signal read zeros, so a masked-out segment's
// loads, issued beside its mask's, stay inside the rows.  A frame that reads the
// halo source (kHalo: a frame crossing L) goes another way, taken by the
// whole warp (or CTA) when any of its frames needs it: its samples are
// staged in the slot one a thread at a time (sample e at word e of the re
// plane, e - m of the im plane) and read back as pairs, so that no lane
// holds a pointer an element; the slot ends free.
template <int LOG2M, bool kHalo, class SlotT>
__device__ __forceinline__ void load_frame(float2* v, int t, const float* __restrict__ x,
                                           const float* __restrict__ h, long long a,
                                           const Samples& src, int nfft,
                                           const float2* __restrict__ w, bool live,
                                           const SlotT& s) {
  using R = Row<LOG2M>;
  constexpr int m = R::kN;
  w = opaque(w);
  // Samples e < lx come from x, lx <= e < lh from h.
  const long long ex = src.L - a;
  const int lx = !live || ex <= 0 ? 0 : ex < nfft ? static_cast<int>(ex) : nfft;
  const long long eh = ex + src.H;
  const int lh = !kHalo || !live || eh <= 0 ? lx : eh < nfft ? static_cast<int>(eh) : nfft;
  const float* __restrict__ xa = x + a;
  if constexpr (kHalo) {
    const bool halo = lh > lx;
    if (R::kWarp ? __any_sync(0xffffffffu, halo) : halo) {
      unroll<2>([&](auto hh) {  // each half's P loads in flight before its first store
        float val[R::kP];
        unroll<R::kP>([&](auto ii) {
          const int e = t + (GDSP_IDX(hh) * R::kP + GDSP_IDX(ii)) * R::kT;
          val[GDSP_IDX(ii)] = e < lx ? __ldg(&xa[e]) : e < lh ? __ldg(&h[e - ex]) : 0.f;
        });
        unroll<R::kP>([&](auto ii) {
          const int e = t + (GDSP_IDX(hh) * R::kP + GDSP_IDX(ii)) * R::kT;
          (e < m ? s.re : s.im)[s.base + (e & (m - 1)) * R::kQ] = val[GDSP_IDX(ii)];
        });
      });
      s.fence();
      auto staged = [&](int e) { return (e < m ? s.re : s.im)[s.base + (e & (m - 1)) * R::kQ]; };
      unroll<R::kP>([&](auto rr) {
        constexpr int r = GDSP_IDX(rr);
        const int e = 2 * (t + r * R::kT);
        const float2 wp = __ldg(&w[e >> 1]);
        v[r] = make_float2(staged(e) * wp.x, staged(e + 1) * wp.y);
      });
      s.fence();
      return;
    }
  }
  unroll<R::kP>([&](auto rr) {
    constexpr int r = GDSP_IDX(rr);
    const int e = 2 * (t + r * R::kT);
    const float2 wp = __ldg(&w[e >> 1]);  // w[e], w[e + 1]: even e, 8-byte aligned
    v[r] = make_float2(e < lx ? __ldg(&xa[e]) * wp.x : 0.f,
                       e + 1 < lx ? __ldg(&xa[e + 1]) * wp.y : 0.f);
  });
}

// The pad-point one-sided spectrum of the frame in v (load_frame's
// layout): X[t + out_index(i) T] into v[i]; returns X[m] (lane t = 0).
// Every thread of the slot calls it; ends fenced (the slot is free).
template <int LOG2M, class SlotT>
__device__ __forceinline__ float spectrum(float2* v, int t, const SlotT& s,
                                          const float2* __restrict__ tw) {
  using R = Row<LOG2M>;
  constexpr int m = R::kN;
  tw = opaque(tw);
  row_dft<LOG2M, false>(v, t, s, tw);
  // Z[t + c T] is in v; its partner Z[m - k] is another thread's, so the
  // frame goes through its slot once more, in natural order.
  unroll<R::kP>([&](auto ii) {
    constexpr int i = GDSP_IDX(ii);
    s.put(t + out_index<LOG2M>(i) * R::kT, v[i]);
  });
  s.fence();
  const float top = v[0].x - v[0].y;  // X[m] = Re Z[0] - Im Z[0] (thread t = 0)
  unroll<R::kP>([&](auto ii) {
    constexpr int i = GDSP_IDX(ii);
    const int k = t + out_index<LOG2M>(i) * R::kT;
    const float2 za = v[i];
    const float2 zb = s.get((m - k) & (m - 1));  // Z[m - k]; its conjugate below
    const float2 e = make_float2(0.5f * (za.x + zb.x), 0.5f * (za.y - zb.y));
    const float2 d = make_float2(0.5f * (za.x - zb.x), 0.5f * (za.y + zb.y));
    const float2 wd = regs::mul(d, __ldg(&tw[m + k]));
    v[i] = make_float2(e.x + wd.y, e.y - wd.x);  // X[k]
  });
  s.fence();  // every read of the slot done before the next frame writes it
  return top;
}

// The inputs of the m-point inverse transform whose output z[j] =
// (x[2j], x[2j+1]) is pad times the inverse DFT of the one-sided spectrum
// x of m + 1 bins (pad = 2m): K3's split run backwards,
//   Z[k] = (X[k] + conj X[m-k]) + i W_pad^{-k} (X[k] - conj X[m-k]),
// into v[r] = Z[t + r T] (the first pass's layout), X[0] and X[m] taken
// real (the real part of an inverse DFT ignores their imaginary parts).
// tw is the conjugate of rfft_table(pad) (ops/cuda_istft.py: irfft_table):
// the inverse m-point Stockham table, then W_pad^{-k}, k < m.  live false
// loads zeros.
template <int LOG2M>
__device__ __forceinline__ void unsplit(float2* v, int t, const float2* __restrict__ x,
                                        const float2* __restrict__ tw, bool live) {
  using R = Row<LOG2M>;
  constexpr int m = R::kN;
  unroll<R::kP>([&](auto rr) {
    constexpr int r = GDSP_IDX(rr);
    const int k = t + r * R::kT;
    float2 a = live ? __ldg(&x[k]) : make_float2(0.f, 0.f);
    float2 b = live ? __ldg(&x[m - k]) : make_float2(0.f, 0.f);
    if (k == 0) a.y = b.y = 0.f;
    const float2 sum = make_float2(a.x + b.x, a.y - b.y);   // X[k] + conj X[m - k]
    const float2 wd = regs::mul(make_float2(a.x - b.x, a.y + b.y), __ldg(&tw[m + k]));
    v[r] = make_float2(sum.x - wd.y, sum.y + wd.x);         // + i W^{-k} (X[k] - conj X[m - k])
  });
}

// Segments a CTA of K4 (frames 1) or K7 (frames 2, a segment's x and y
// frames) holds at once for a tile of `tile` segments: the default eight
// warps' frames (fft_regs.cuh: default_rows) over `frames`, or whole warps
// enough for the tile; one in the block route.
template <int LOG2M>
inline int frames_per_cta(int tile, int frames) {
  using R = Row<LOG2M>;
  if (!R::kWarp) return 1;
  const int most = regs::default_rows<LOG2M>() / frames;
  const int q_tile = (tile + R::kQ - 1) / R::kQ * R::kQ;
  return q_tile < most ? q_tile : most;
}

// One row of m + 1 partial sums of the CTA at o.  The CTA's slots form
// `groups` groups (K4: its warps, each summing every bin; K7: its warp
// pairs, the x frame's warp summing the bins of registers i < H and the y
// frame's the rest); part[i], i < n, is this thread's sum over its slot's
// frames of bin t + out_index(i0 + i) T, and top, where has_top (lane t =
// 0), of bin m.  Every thread of the CTA calls it; smem holds at least
// groups (m + 1) floats that no thread reads any more.
template <int LOG2M, int N>
__device__ __forceinline__ void store_partials(float* part, int i0, int n, bool has_top,
                                               float top, int t, int group, int groups,
                                               float* smem, float* __restrict__ o) {
  using R = Row<LOG2M>;
  constexpr int m = R::kN;
  constexpr int lp = m + 1;
  if constexpr (R::kWarp) {
#pragma unroll
    for (int d = R::kT; d < 32; d <<= 1) {
      unroll<N>([&](auto ii) {
        constexpr int i = GDSP_IDX(ii);
        part[i] += __shfl_xor_sync(0xffffffffu, part[i], d);
      });
      top += __shfl_xor_sync(0xffffffffu, top, d);
    }
  }
  if (!R::kWarp || groups == 1) {  // one group: its first slot's lanes store their bins
    if ((threadIdx.x & 31) < R::kT || !R::kWarp) {
      unroll<N>([&](auto ii) {
        constexpr int i = GDSP_IDX(ii);
        if (i < n) o[t + out_index<LOG2M>(i0 + i) * R::kT] = part[i];
      });
      if (has_top && t == 0) o[m] = top;
    }
  } else {
    __syncthreads();  // every warp is past its last read of these words
    float* red = smem + group * lp;
    if ((threadIdx.x & 31) < R::kT) {
      unroll<N>([&](auto ii) {
        constexpr int i = GDSP_IDX(ii);
        if (i < n) red[t + out_index<LOG2M>(i0 + i) * R::kT] = part[i];
      });
      if (has_top && t == 0) red[m] = top;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < lp; k += blockDim.x) {
      float sum = smem[k];
      for (int g = 1; g < groups; ++g) sum += smem[g * lp + k];
      o[k] = sum;
    }
  }
}

}  // namespace frames
}  // namespace gdsp
