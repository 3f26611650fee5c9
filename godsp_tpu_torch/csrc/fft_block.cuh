// Block-level power-of-2 FFT in shared memory: the body of the kernels
// that transform a row inside a fused pass (K6, K9: istft_kernel,
// peel_rows_kernel), of the probe twins of pwelch_probe_kernels.cu and
// anatomy_probe_kernels.cu, and of radix2_probe_kernels.cu, the first
// designs of K1/K3, K4, K5, K7 and K8 kept as yardsticks.  K1-K5, K7, K8
// and K11 themselves run on fft_regs.cuh's register-radix passes; K4,
// K7 and K11 take only this header's launch helpers (allow_smem).
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

// Threads per block for `butterflies` butterflies a stage: a multiple of
// the warp, at most 512.
inline int block_threads(long long butterflies) {
  long long t = butterflies < 512 ? butterflies : 512;
  t = (t + 31) / 32 * 32;
  return static_cast<int>(t);
}

// A grid of x blocks per row over `rows` rows (rows > 0), spread over
// grid.y and grid.z: one launch serves more rows than grid.y's 65535.
// The last z slice may overshoot, so a kernel reads its row with
// block_row() and returns at once when it is past the last row.
inline dim3 row_grid(unsigned x, long long rows) {
  const long long y = rows < 65535 ? rows : 65535;
  return dim3(x, static_cast<unsigned>(y), static_cast<unsigned>((rows + y - 1) / y));
}

__device__ __forceinline__ long long block_row() {
  return blockIdx.y + static_cast<long long>(gridDim.y) * blockIdx.z;
}

// Allow more than 48 KB of dynamic shared memory where a launch needs it.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel k, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace gdsp
