// Fused Welch-periodogram partial sums for Hopper (sm_90a).
//
// Replaces godsp_tpu/ops/pallas_pwelch.py: pwelch_power_partials (inner
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

__global__ void pwelch_partials_kernel(const float* __restrict__ ext,
                                       const float* __restrict__ mask,
                                       const float* __restrict__ w, float* __restrict__ out,
                                       const float2* __restrict__ tw, long long rows,
                                       long long L_ext, long long S, int nfft, int stride,
                                       int log2pad, int bt, int n_tiles) {
  extern __shared__ float2 s[];
  const long long row = gdsp::block_row();
  if (row >= rows) return;
  const int pad = 1 << log2pad;
  const int lp = (pad >> 1) + 1;
  float* acc = reinterpret_cast<float*>(s + pad);
  const int tile = blockIdx.x;
  const float* x = ext + row * L_ext;
  const float* m = mask + row * S;

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
      if (i < nfft && base + i < L_ext) v = x[base + i] * w[i];
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

}  // namespace

extern "C" {

// out[r, t, k] = sum over segments s of tile t of mask[r, s] * |FFT_pad(w * ext[r, s*stride:])|^2_k
// for k <= pad/2.  Returns cudaGetLastError().
int gdsp_pwelch_partials(const float* ext, const float* mask, const float* w, float* out,
                         const float2* tw, long long rows, long long L_ext, long long S, int nfft,
                         int stride, int log2pad, int bt, int n_tiles, void* stream) {
  const int pad = 1 << log2pad;
  const int lp = (pad >> 1) + 1;
  const size_t smem = static_cast<size_t>(pad) * sizeof(float2) + static_cast<size_t>(lp) * 4;
  cudaError_t e = gdsp::allow_smem(pwelch_partials_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid = gdsp::row_grid(static_cast<unsigned>(n_tiles), rows);
  const int threads = gdsp::block_threads(pad >> 1);
  pwelch_partials_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      ext, mask, w, out, tw, rows, L_ext, S, nfft, stride, log2pad, bt, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
