// Fused inverse STFT (windowed overlap-add of inverse FFTs) for Hopper
// (sm_90a).
//
// Replaces godsp_tpu/ops/pallas_istft.py: istft_overlap_add (inner kernel
// _istft_kernel).  Grid: (tiles of bt frames, rows), the rows spread over
// y and z (row_grid).  For each frame f of its tile, in order, a block
//   * loads the frame's bins into shared memory in bit-reversed order; a
//     one-sided input (pad/2 + 1 bins) is completed to the conjugate-
//     symmetric pad-point spectrum in the loader (X[k] = conj(X[pad-k])
//     for k > pad/2), so no mirrored tensor is ever written to device
//     memory;
//   * runs the inverse pad-point FFT (fft_block.cuh, conjugate table);
//   * multiplies the real part of samples 0..nfft-1 by scale * w and adds
//     them at offset (f - f0) * hop into the tile's span of
//     (bt - 1) * hop + nfft samples.
// The block then writes its span as one output row (rows, tiles, span);
// the wrapper adds each tile's nfft - hop tail onto its successor's head
// with one shifted add (bt * hop >= nfft - hop, so a tail reaches only
// the next tile).  No atomics: the sum is deterministic.
//
// The span lives in shared memory when pad * 8 + span * 4 bytes fit in a
// block's 227 KB (always for pad <= 8192); otherwise (pad 16384 with a
// short hop) the block accumulates straight into its output row, which
// only its own threads touch, between the same barriers.
//
// Bound on the H100: each frame reads pad/2 + 1 complex bins (8 bytes
// each) and contributes hop new output samples (4 bytes each), so the
// kernel reads ~8 pad / hop bytes per output sample; the inverse FFT runs
// in shared memory at 5 pad log2 pad flops a frame.  The radix-2 stages,
// one frame at a time, bound this simple version.

#include <cstdint>

#include "fft_block.cuh"

namespace {

constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may use on the H100

__global__ void istft_kernel(const float2* __restrict__ spec, const float* __restrict__ w,
                             const float2* __restrict__ tw_inv, float* __restrict__ out,
                             long long rows, long long F, int bins, int onesided, int nfft,
                             int hop, int log2pad, int bt, long long n_tiles, int span_in_smem,
                             float scale) {
  extern __shared__ float2 s[];
  const long long row = gdsp::block_row();
  if (row >= rows) return;
  const int pad = 1 << log2pad;
  const long long tile = blockIdx.x;
  const int span = (bt - 1) * hop + nfft;
  float* o = out + (row * n_tiles + tile) * span;
  float* acc = span_in_smem ? reinterpret_cast<float*>(s + pad) : o;

  for (int i = threadIdx.x; i < span; i += blockDim.x) acc[i] = 0.f;

  const long long f0 = tile * bt;
  const long long f1 = f0 + bt < F ? f0 + bt : F;
  for (long long f = f0; f < f1; ++f) {
    __syncthreads();  // the previous frame's readers are done with s[]; acc is visible
    const float2* x = spec + (row * F + f) * bins;
    for (int k = threadIdx.x; k < pad; k += blockDim.x) {
      float2 v;
      if (!onesided || k < bins) {
        v = x[k];
      } else {
        v = x[pad - k];
        v.y = -v.y;
      }
      s[gdsp::bit_reverse(k, log2pad)] = v;
    }
    __syncthreads();
    gdsp::block_fft_rows(s, 1, pad, log2pad, tw_inv);
    const int base = static_cast<int>(f - f0) * hop;
    for (int t = threadIdx.x; t < nfft; t += blockDim.x) acc[base + t] += s[t].x * scale * w[t];
  }
  if (span_in_smem) {
    __syncthreads();
    for (int i = threadIdx.x; i < span; i += blockDim.x) o[i] = acc[i];
  }
}

}  // namespace

extern "C" {

// out[r, t, :] = sum over frames f of tile t (bt frames a tile) of
// w * scale * real(IFFT_pad(spec[r, f]))[:nfft], placed at (f - t*bt)*hop
// in a span of (bt-1)*hop + nfft samples.  spec (rows, F, bins) float2,
// natural order: bins = pad/2 + 1 with onesided, else pad.  tw_inv is the
// conjugate table of pad = 2^log2pad.  Returns cudaGetLastError().
int gdsp_istft_ola(const float2* spec, const float* w, const float2* tw_inv, float* out,
                   long long rows, long long F, int bins, int onesided, int nfft, int hop,
                   int log2pad, int bt, long long n_tiles, float scale, void* stream) {
  const int pad = 1 << log2pad;
  const size_t span = static_cast<size_t>(bt - 1) * hop + nfft;
  const size_t fft_bytes = static_cast<size_t>(pad) * sizeof(float2);
  const int span_in_smem = fft_bytes + span * sizeof(float) <= kMaxSmem;
  const size_t smem = fft_bytes + (span_in_smem ? span * sizeof(float) : 0);
  cudaError_t e = gdsp::allow_smem(istft_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid = gdsp::row_grid(static_cast<unsigned>(n_tiles), rows);
  const int threads = gdsp::block_threads(pad >> 1);
  istft_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      spec, w, tw_inv, out, rows, F, bins, onesided, nfft, hop, log2pad, bt, n_tiles,
      span_in_smem, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
