// Fused Welch-periodogram partial sums for Hopper (sm_90a): K4, and K11
// (the same body reading a neighbour shard's head past its block's end).
//
// K4 replaces godsp_tpu/ops/pallas_pwelch.py: pwelch_power_partials (inner
// kernel _pwelch_kernel).  Grid: (tiles, rows), the rows spread over y
// and z (row_grid).  A block walks its tile's segments s in order; for
// each segment with mask[s] != 0 it
//   * loads ext[s*stride : s*stride + nfft] (the overlap is re-read
//     through L2, never materialized as frames in device memory),
//   * multiplies by w[:nfft] and zero-extends to pad,
//   * runs the pad-point FFT in shared memory (fft_block.cuh),
//   * adds mask[s] * |X_k|^2 for k = 0..pad/2 into a shared accumulator
//     that each thread owns a fixed set of bins of.
// It writes one partial row per tile, (rows, tiles, pad/2 + 1) in natural
// order; the sum over tiles is a torch reduction in the wrapper's caller.
// No atomics: the result is deterministic.
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
// overlap, mostly from L2) and each segment costs a pad-point FFT of
// 5 pad log2 pad flops, so at pad = 1024 the kernel does ~25 flops per
// byte it reads from device memory: latency- and shared-memory-bound at
// this simple radix-2 structure rather than HBM-bound.  The design keeps
// every intermediate (frame, spectrum, power) in shared memory; a later
// version can pack two real segments into one complex FFT.

#include <cstdint>

#include "fft_block.cuh"

namespace {

// Where a row's samples come from: x[r * x_stride + j] for j < L, then
// (kHalo) h[r * h_stride + j - L] for j - L < H; zeros past both.
struct Samples {
  const float* x;
  long long x_stride;
  long long L;
  const float* h;
  long long h_stride;
  long long H;
};

template <bool kHalo>
__global__ void pwelch_partials_kernel(Samples src, const float* __restrict__ mask,
                                       long long mask_stride, const float* __restrict__ w,
                                       float* __restrict__ out, const float2* __restrict__ tw,
                                       long long rows, long long S, int nfft, int stride,
                                       int log2pad, int bt, int n_tiles) {
  extern __shared__ float2 s[];
  const long long row = gdsp::block_row();
  if (row >= rows) return;
  const int pad = 1 << log2pad;
  const int lp = (pad >> 1) + 1;
  float* acc = reinterpret_cast<float*>(s + pad);
  const int tile = blockIdx.x;
  const float* x = src.x + row * src.x_stride;
  const float* h = kHalo ? src.h + row * src.h_stride : nullptr;
  const float* m = mask + row * mask_stride;

  for (int k = threadIdx.x; k < lp; k += blockDim.x) acc[k] = 0.f;

  const long long s0 = static_cast<long long>(tile) * bt;
  const long long s1 = s0 + bt < S ? s0 + bt : S;
  for (long long sg = s0; sg < s1; ++sg) {
    const float ms = m[sg];  // the same for every thread: uniform branch
    if (ms == 0.f) continue;
    const long long base = sg * stride;
    __syncthreads();  // the previous segment's readers are done with s[]
    for (int i = threadIdx.x; i < pad; i += blockDim.x) {
      float v = 0.f;
      if (i < nfft) {
        const long long j = base + i;
        if (j < src.L) {
          v = x[j] * w[i];
        } else if (kHalo && j - src.L < src.H) {
          v = h[j - src.L] * w[i];
        }
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

template <bool kHalo>
int launch(const Samples& src, const float* mask, long long mask_stride, const float* w,
           float* out, const float2* tw, long long rows, long long S, int nfft, int stride,
           int log2pad, int bt, int n_tiles, void* stream) {
  const int pad = 1 << log2pad;
  const int lp = (pad >> 1) + 1;
  const size_t smem = static_cast<size_t>(pad) * sizeof(float2) + static_cast<size_t>(lp) * 4;
  cudaError_t e = gdsp::allow_smem(pwelch_partials_kernel<kHalo>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid = gdsp::row_grid(static_cast<unsigned>(n_tiles), rows);
  const int threads = gdsp::block_threads(pad >> 1);
  pwelch_partials_kernel<kHalo><<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      src, mask, mask_stride, w, out, tw, rows, S, nfft, stride, log2pad, bt, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K4: out[r, t, k] = sum over segments s of tile t of
// mask[r, s] * |FFT_pad(w * ext[r, s*stride:])|^2_k for k <= pad/2, ext
// and mask contiguous rows.  Returns cudaGetLastError().
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
// Returns cudaGetLastError().
int gdsp_pwelch_partials_halo(const float* x, long long x_stride, long long L, const float* h,
                              long long h_stride, long long H, const float* mask,
                              long long mask_stride, const float* w, float* out,
                              const float2* tw, long long rows, long long S, int nfft, int stride,
                              int log2pad, int bt, int n_tiles, void* stream) {
  const Samples src{x, x_stride, L, h, h_stride, H};
  return launch<true>(src, mask, mask_stride, w, out, tw, rows, S, nfft, stride, log2pad, bt,
                      n_tiles, stream);
}

}  // extern "C"
