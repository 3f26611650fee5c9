// Fused cross-spectral (Welch CSD) partial sums for Hopper (sm_90a).
//
// Replaces godsp_tpu/ops/pallas_csd.py: csd_power_partials (inner kernel
// _csd_kernel), the two-signal sibling of pwelch_kernel.cu (K4).  Grid:
// (tiles, rows), the rows spread over y and z (row_grid).  A block walks
// its tile's segments s in order; for each segment with mask[s] != 0 it
//   * loads x[s*stride : s*stride + nfft] (read through L2, never
//     materialized as frames), multiplies by w[:nfft], zero-extends to
//     pad and runs the pad-point FFT in shared memory (fft_block.cuh);
//   * copies X_k of the bins it owns (k = tid + j*blockDim.x <= pad/2)
//     into registers;
//   * does the same for y in the same shared buffer, then adds
//     mask[s] * conj(X_k) Y_k into two register accumulators:
//       re += xr*yr + xi*yi,   im += xr*yi - xi*yr.
// It writes one partial row per tile of re and of im, (rows, tiles,
// pad/2 + 1) each in natural order; the sum over tiles is a torch
// reduction in the wrapper's caller.  No atomics: the result is
// deterministic.
//
// Shared memory: one pad-point complex buffer (128 KB at pad 16384).  Two
// buffers, one a signal, would need 262 KB at pad 16384, past the 227 KB
// a block may have; so the X_k wait in registers while y is transformed.
// At pad 16384 and 512 threads a thread owns ceil(8193/512) = 17 bins:
// 17 X_k and 17 re/im accumulators, 68 registers, held in registers by a
// compile-time bound (MAXB, a template parameter) and fully unrolled
// loops.  Both transforms are exact complex FFTs of real input, as K4's:
// packing x + i*y into one transform would halve the FFT work but scale
// the error of Y by |X|/|Y| (a later speed option, with that caveat).
//
// Bound on the H100: each segment costs two pad-point FFTs of 5 pad
// log2 pad flops against 2 x 4 x stride bytes of new samples, so at pad
// 1024, hop 512 the kernel does ~50 flops per byte of device memory it
// must read: operations-bound (67 TFLOP/s float32) at the roofline,
// latency- and shared-memory-bound at this simple radix-2 structure.

#include <cstdint>

#include "fft_block.cuh"

namespace {

// x (or y) segment sg of `row`, windowed and zero-extended, into s[] in
// bit-reversed order, then its FFT.  Ends synchronized.
__device__ __forceinline__ void load_and_transform(float2* s, const float* __restrict__ src,
                                                   const float* __restrict__ w, long long base,
                                                   long long L_ext, int nfft, int pad,
                                                   int log2pad, const float2* __restrict__ tw) {
  for (int i = threadIdx.x; i < pad; i += blockDim.x) {
    float v = 0.f;
    if (i < nfft && base + i < L_ext) v = src[base + i] * w[i];
    s[gdsp::bit_reverse(i, log2pad)] = make_float2(v, 0.f);
  }
  __syncthreads();
  gdsp::block_fft_rows(s, 1, pad, log2pad, tw);
}

template <int MAXB>
__global__ void __launch_bounds__(512) csd_partials_kernel(
    const float* __restrict__ ext_x, const float* __restrict__ ext_y,
    const float* __restrict__ mask, const float* __restrict__ w, float* __restrict__ out_re,
    float* __restrict__ out_im, const float2* __restrict__ tw, long long rows, long long L_ext,
    long long S, int nfft, int stride, int log2pad, int bt, int n_tiles) {
  extern __shared__ float2 s[];
  const long long row = gdsp::block_row();
  if (row >= rows) return;
  const int pad = 1 << log2pad;
  const int lp = (pad >> 1) + 1;
  const int tile = blockIdx.x;
  const float* x = ext_x + row * L_ext;
  const float* y = ext_y + row * L_ext;
  const float* m = mask + row * S;

  float xr[MAXB], xi[MAXB], acc_re[MAXB], acc_im[MAXB];
#pragma unroll
  for (int j = 0; j < MAXB; ++j) acc_re[j] = acc_im[j] = 0.f;

  const long long s0 = static_cast<long long>(tile) * bt;
  const long long s1 = s0 + bt < S ? s0 + bt : S;
  for (long long sg = s0; sg < s1; ++sg) {
    const float ms = m[sg];  // the same for every thread: uniform branch
    if (ms == 0.f) continue;
    const long long base = sg * stride;
    __syncthreads();  // the previous segment's readers are done with s[]
    load_and_transform(s, x, w, base, L_ext, nfft, pad, log2pad, tw);
#pragma unroll
    for (int j = 0; j < MAXB; ++j) {
      const int k = threadIdx.x + j * blockDim.x;
      const float2 c = k < lp ? s[k] : make_float2(0.f, 0.f);
      xr[j] = c.x;
      xi[j] = c.y;
    }
    __syncthreads();  // every X_k is in registers before y overwrites s[]
    load_and_transform(s, y, w, base, L_ext, nfft, pad, log2pad, tw);
#pragma unroll
    for (int j = 0; j < MAXB; ++j) {
      const int k = threadIdx.x + j * blockDim.x;
      if (k < lp) {
        const float2 c = s[k];
        acc_re[j] += ms * (xr[j] * c.x + xi[j] * c.y);
        acc_im[j] += ms * (xr[j] * c.y - xi[j] * c.x);
      }
    }
  }
  const long long o = (row * n_tiles + tile) * lp;
#pragma unroll
  for (int j = 0; j < MAXB; ++j) {
    const int k = threadIdx.x + j * blockDim.x;
    if (k < lp) {
      out_re[o + k] = acc_re[j];
      out_im[o + k] = acc_im[j];
    }
  }
}

template <int MAXB>
cudaError_t launch(const float* ext_x, const float* ext_y, const float* mask, const float* w,
                   float* out_re, float* out_im, const float2* tw, long long rows,
                   long long L_ext, long long S, int nfft, int stride, int log2pad, int bt,
                   int n_tiles, int threads, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(1) << log2pad) * sizeof(float2);
  cudaError_t e = gdsp::allow_smem(csd_partials_kernel<MAXB>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid = gdsp::row_grid(static_cast<unsigned>(n_tiles), rows);
  csd_partials_kernel<MAXB><<<grid, threads, smem, stream>>>(
      ext_x, ext_y, mask, w, out_re, out_im, tw, rows, L_ext, S, nfft, stride, log2pad, bt,
      n_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out_re[r, t, k] + i out_im[r, t, k] = sum over segments s of tile t of
// mask[r, s] * conj(X_s[k]) Y_s[k], X_s = FFT_pad(w * ext_x[r, s*stride:]),
// Y_s likewise of ext_y, for k <= pad/2.  Returns cudaGetLastError().
int gdsp_csd_partials(const float* ext_x, const float* ext_y, const float* mask, const float* w,
                      float* out_re, float* out_im, const float2* tw, long long rows,
                      long long L_ext, long long S, int nfft, int stride, int log2pad, int bt,
                      int n_tiles, void* stream) {
  const int pad = 1 << log2pad;
  const int lp = (pad >> 1) + 1;
  const int threads = gdsp::block_threads(pad >> 1);
  const int per_thread = (lp + threads - 1) / threads;  // bins a thread owns
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GDSP_CSD_LAUNCH(B)                                                                  \
  launch<B>(ext_x, ext_y, mask, w, out_re, out_im, tw, rows, L_ext, S, nfft, stride, log2pad, \
            bt, n_tiles, threads, st)
  cudaError_t e;
  if (per_thread <= 2) {
    e = GDSP_CSD_LAUNCH(2);
  } else if (per_thread <= 3) {
    e = GDSP_CSD_LAUNCH(3);
  } else if (per_thread <= 5) {
    e = GDSP_CSD_LAUNCH(5);
  } else if (per_thread <= 9) {
    e = GDSP_CSD_LAUNCH(9);
  } else if (per_thread <= 17) {
    e = GDSP_CSD_LAUNCH(17);
  } else {
    e = cudaErrorInvalidValue;  // pad > 16384: the wrapper never asks
  }
#undef GDSP_CSD_LAUNCH
  return static_cast<int>(e);
}

}  // extern "C"
