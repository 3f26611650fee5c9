// Block-level power-of-2 FFT in shared memory: the body of the probe
// twins of pwelch_probe_kernels.cu and anatomy_probe_kernels.cu, and of
// radix2_probe_kernels.cu, the first designs of K1/K3, K4, K5, K6, K7, K8
// and K9 kept as yardsticks.  The kernels of the main path run on
// fft_regs.cuh's register-radix passes and take their launch helpers from
// launch.cuh, which this header includes for the probes.
//
// A block holds `rows` transforms of n complex float32 values in dynamic
// shared memory (n <= 16384, 128 KB a row).  The loader writes each row
// in bit-reversed order; block_fft_rows then runs the iterative radix-2
// decimation-in-time stages in place and leaves natural bin order.
//
// Twiddles come from a table tw[j] = exp(-+2 pi i j / n), j < n/2, built
// in float64 on the host and rounded once to float32 (no __sinf): the
// 120 dB bar at n = 16384 depends on it.  The inverse passes the
// conjugate table.

#pragma once

#include <cuda_runtime.h>

#include "launch.cuh"

namespace gdsp {

__device__ __forceinline__ unsigned bit_reverse(unsigned k, int log2n) {
  return __brev(k) >> (32 - log2n);
}

// In-place radix-2 DIT over `rows` rows of n values in s[], row r at
// s[r * row_stride], each already in bit-reversed order.  Every thread of
// the block must call it; the caller synchronizes after the loads.  Ends
// synchronized.
__device__ __forceinline__ void block_fft_rows(float2* s, int rows, int n, int log2n,
                                               const float2* __restrict__ tw, int row_stride) {
  const int half = n >> 1;
  const int butterflies = rows * half;
  for (int lg = 1; lg <= log2n; ++lg) {
    const int h = 1 << (lg - 1);        // half-length of this stage's groups
    const int tw_shift = log2n - lg;    // twiddle index = pos * (n / 2h)
    for (int b = threadIdx.x; b < butterflies; b += blockDim.x) {
      const int row = b >> (log2n - 1);
      const int j = b & (half - 1);
      const int pos = j & (h - 1);
      const int i0 = row * row_stride + ((j >> (lg - 1)) << lg) + pos;
      const int i1 = i0 + h;
      const float2 w = __ldg(&tw[pos << tw_shift]);
      const float2 a = s[i0];
      const float2 c = s[i1];
      const float2 t = make_float2(w.x * c.x - w.y * c.y, w.x * c.y + w.y * c.x);
      s[i0] = make_float2(a.x + t.x, a.y + t.y);
      s[i1] = make_float2(a.x - t.x, a.y - t.y);
    }
    __syncthreads();
  }
}

// The same over `rows` consecutive rows (row_stride = n).
__device__ __forceinline__ void block_fft_rows(float2* s, int rows, int n, int log2n,
                                               const float2* __restrict__ tw) {
  block_fft_rows(s, rows, n, log2n, tw, n);
}

}  // namespace gdsp
