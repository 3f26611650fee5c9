// Fused short-time Fourier transform for Hopper (sm_90a).
//
// Replaces godsp_tpu/ops/pallas_stft.py: stft_pallas (inner kernel
// _stft_kernel).  Grid: (frame groups, rows), the rows spread over y and
// z (row_grid).  A block owns `fpb`
// consecutive frames of one row; for each it
//   * loads x[s*stride : s*stride + nfft] * w[:nfft] and zero-extends to
//     pad (the overlap is re-read through L2, never materialized as
//     frames in device memory),
//   * runs the pad-point FFT in shared memory (fft_block.cuh),
// and then writes, per frame, one of
//   mode 0 (complex): bins 0..pad/2 as float2 straight into a complex64
//                     output viewed as real, natural order;
//   mode 1 (power):   |X_k|^2, k = 0..pad/2, as float32;
//   mode 2 (mel):     m[j] = sum_k |X_k|^2 fb[j, k] over filter j's band
//                     [band[j].x, band[j].y] of nonzero bins: the power
//                     spectrum never leaves shared memory, and the zeros
//                     outside a triangle add nothing, so the sum is the
//                     dense product's.
//
// Bound on the H100: unlike the Welch kernel, every frame stores its
// result, so modes 0 and 1 write 8 and 4 bytes a bin: at pad = 1024, hop
// 256 the complex mode writes 4.1 KB a frame against 1 KB of new input,
// and device-memory writes bound it once the radix-2 stages in shared
// memory are fast enough.  The design keeps frames and spectra out of
// device memory and stores each output once, coalesced.

#include <cstdint>

#include "fft_block.cuh"

namespace {

constexpr int kPointsPerBlock = 4096;  // frames per block = max(1, this / pad)

__global__ void stft_kernel(const float* __restrict__ x, const float* __restrict__ w,
                            const float2* __restrict__ tw, float* __restrict__ out,
                            const float* __restrict__ fb, const int2* __restrict__ band,
                            long long rows, long long L, long long S, int nfft,
                            long long stride, int log2pad, int fpb, int mode, int n_mels) {
  extern __shared__ float2 s[];
  const long long row = gdsp::block_row();
  if (row >= rows) return;
  const int pad = 1 << log2pad;
  const int lp = (pad >> 1) + 1;
  const long long f0 = static_cast<long long>(blockIdx.x) * fpb;
  const float* xr = x + row * L;

  const int total = fpb * pad;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i >> log2pad;
    const int k = i & (pad - 1);
    const long long f = f0 + r;
    const long long at = f * stride + k;
    float v = 0.f;
    if (f < S && k < nfft && at < L) v = xr[at] * w[k];
    s[r * pad + gdsp::bit_reverse(k, log2pad)] = make_float2(v, 0.f);
  }
  __syncthreads();
  gdsp::block_fft_rows(s, fpb, pad, log2pad, tw);

  if (mode == 0) {
    float2* o = reinterpret_cast<float2*>(out);
    for (int i = threadIdx.x; i < fpb * lp; i += blockDim.x) {
      const int r = i / lp;
      const int k = i - r * lp;
      if (f0 + r < S) o[(row * S + f0 + r) * lp + k] = s[r * pad + k];
    }
    return;
  }
  if (mode == 1) {
    for (int i = threadIdx.x; i < fpb * lp; i += blockDim.x) {
      const int r = i / lp;
      const int k = i - r * lp;
      if (f0 + r < S) {
        const float2 c = s[r * pad + k];
        out[(row * S + f0 + r) * lp + k] = c.x * c.x + c.y * c.y;
      }
    }
    return;
  }
  // mel: |X|^2 into the float region after the spectra, then each thread
  // sums one (frame, filter) pair over the filter's band.
  float* p = reinterpret_cast<float*>(s + fpb * pad);
  for (int i = threadIdx.x; i < fpb * lp; i += blockDim.x) {
    const int r = i / lp;
    const int k = i - r * lp;
    const float2 c = s[r * pad + k];
    p[i] = c.x * c.x + c.y * c.y;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < fpb * n_mels; i += blockDim.x) {
    const int r = i / n_mels;
    const int j = i - r * n_mels;
    if (f0 + r >= S) continue;
    const int2 b = band[j];
    const float* fj = fb + static_cast<long long>(j) * lp;
    const float* pr = p + r * lp;
    float acc = 0.f;
    for (int k = b.x; k <= b.y; ++k) acc += pr[k] * fj[k];
    out[(row * S + f0 + r) * n_mels + j] = acc;
  }
}

inline int frames_per_block(int pad) { return pad >= kPointsPerBlock ? 1 : kPointsPerBlock / pad; }

}  // namespace

extern "C" {

// out = per-frame results of frames s in [0, S) of each of `rows` rows of
// x (rows, L): frame s reads x[s*stride : s*stride + nfft] * w[:nfft],
// zero-extended to pad = 2^log2pad.  mode 0: (rows, S, pad/2+1) float2;
// mode 1: (rows, S, pad/2+1) float; mode 2: (rows, S, n_mels) float with
// fb (n_mels, pad/2+1) and band (n_mels) = first and last nonzero bin of
// each filter.  tw is the forward table of pad.  Returns cudaGetLastError().
int gdsp_stft(const float* x, const float* w, const float2* tw, float* out, const float* fb,
              const int2* band, long long rows, long long L, long long S, int nfft,
              long long stride, int log2pad, int mode, int n_mels, void* stream) {
  const int pad = 1 << log2pad;
  const int lp = (pad >> 1) + 1;
  const int fpb = frames_per_block(pad);
  size_t smem = static_cast<size_t>(fpb) * pad * sizeof(float2);
  if (mode == 2) smem += static_cast<size_t>(fpb) * lp * sizeof(float);
  cudaError_t e = gdsp::allow_smem(stft_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid = gdsp::row_grid(static_cast<unsigned>((S + fpb - 1) / fpb), rows);
  const int threads = gdsp::block_threads(static_cast<long long>(fpb) * (pad >> 1));
  stft_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w, tw, out, fb, band, rows, L, S, nfft, stride, log2pad, fpb, mode, n_mels);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
