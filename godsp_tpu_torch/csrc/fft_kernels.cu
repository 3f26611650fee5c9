// Batched power-of-2 FFT kernel for Hopper (sm_90a).
//
// fft_pow2_kernel replaces three kernels of godsp_tpu/ops/pallas_fft.py:
// fft_pow2_split (forward, real-input mode, conjugate-table inverse with
// `scale` folded in), ifft_pow2_digit_split (the inverse of the
// convolve/Bluestein chains; natural order here, the TPU digit order is
// not ported) and rfft_pow2_split (real input, bins 0..n/2: the same
// transform with a store of out_n = n/2 + 1 bins a row).
//
// Bound on the H100: at n <= 16384 a radix-2 FFT does 5 n log2 n flops on
// 16 bytes a point (read + write of two f32 planes), about 3 flops a byte
// at n = 1024: memory-bound.  So each row makes one trip through device
// memory: a coalesced load into shared memory (bit-reversed), all
// log2 n stages in shared memory, one coalesced store with the scale
// applied.  Small n packs several rows into one block so that a block
// still has a few thousand points in flight.

#include <cstdint>

#include "fft_block.cuh"

namespace {

constexpr int kPointsPerBlock = 4096;  // rows per block = max(1, this / n)

// y[:, :out_n] = scale * DFT(x) over rows of n = 2^log2n points; xi null
// reads a real input.  y rows are out_n wide.
__global__ void fft_pow2_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                                float* __restrict__ yr, float* __restrict__ yi,
                                const float2* __restrict__ tw, int log2n, int out_n,
                                long long rows, int rows_per_block, float scale) {
  extern __shared__ float2 s[];
  const int n = 1 << log2n;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const int total = rows_per_block * n;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i >> log2n;
    const int k = i & (n - 1);
    float2 v = make_float2(0.f, 0.f);
    if (row0 + r < rows) {
      const long long g = (row0 + r) * n + k;
      v.x = xr[g];
      if (xi != nullptr) v.y = xi[g];
    }
    s[r * n + gdsp::bit_reverse(k, log2n)] = v;
  }
  __syncthreads();
  gdsp::block_fft_rows(s, rows_per_block, n, log2n, tw);
  const int out_total = rows_per_block * out_n;
  for (int i = threadIdx.x; i < out_total; i += blockDim.x) {
    const int r = i / out_n;
    const int k = i - r * out_n;
    if (row0 + r < rows) {
      const long long g = (row0 + r) * out_n + k;
      const float2 c = s[r * n + k];
      yr[g] = c.x * scale;
      yi[g] = c.y * scale;
    }
  }
}

inline int rows_per_block(int n) { return n >= kPointsPerBlock ? 1 : kPointsPerBlock / n; }

}  // namespace

extern "C" {

// The transform of gdsp_fft_pow2 with rows_per_block rows a block instead
// of rows_per_block(n): the twin of the TPU probes' batch-tile sweeps
// (tools/probe_r3.py bt4096/bt8192/ls16384, tools/probe_r4.py's 8192
// stage).  Each row's arithmetic is the same, so every setting gives K1's
// result.  Returns cudaErrorInvalidValue where rows_per_block is below 1 or
// its rows pass the 227 KB of shared memory a block may use.
int gdsp_fft_pow2_rows(const float* xr, const float* xi, float* yr, float* yi, const float2* tw,
                       int log2n, int out_n, long long rows, float scale, int rows_per_block,
                       void* stream) {
  const int n = 1 << log2n;
  const size_t smem = static_cast<size_t>(rows_per_block) * n * sizeof(float2);
  if (rows_per_block < 1 || smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = gdsp::allow_smem(fft_pow2_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  const int threads = gdsp::block_threads(static_cast<long long>(rows_per_block) * (n >> 1));
  fft_pow2_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                    static_cast<cudaStream_t>(stream)>>>(xr, xi, yr, yi, tw, log2n, out_n, rows,
                                                         rows_per_block, scale);
  return static_cast<int>(cudaGetLastError());
}

// y = scale * DFT(x) over rows of n = 2^log2n points, bins 0..out_n-1 of
// each row stored (out_n = n, or n/2 + 1 for the one-sided transform);
// xi may be null (real input).  tw is the forward table for a forward
// transform and the conjugate table for the inverse.  Returns
// cudaGetLastError().
int gdsp_fft_pow2(const float* xr, const float* xi, float* yr, float* yi, const float2* tw,
                  int log2n, int out_n, long long rows, float scale, void* stream) {
  return gdsp_fft_pow2_rows(xr, xi, yr, yi, tw, log2n, out_n, rows, scale,
                            rows_per_block(1 << log2n), stream);
}

}  // extern "C"
