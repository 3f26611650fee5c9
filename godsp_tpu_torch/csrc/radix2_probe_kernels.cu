// fft_pow2_radix2: K1's first design, kept as a yardstick off the main
// path.  Its kernel is K1's earlier radix-2 fft_pow2_kernel, unchanged:
// a coalesced load into shared memory in bit-reversed order, the log2 n
// radix-2 DIT stages of fft_block.cuh's block_fft_rows, one __syncthreads
// and one twiddle __ldg a butterfly a stage, and a coalesced store with
// the scale applied.  It replaces no TPU kernel: it shows, on one card and
// in one run, what the register-radix redesign of K1/K2/K3 (fft_regs.cuh,
// fft_kernels.cu) changed.  Wrapper: ops/cuda_probes.py fft_pow2_radix2,
// with its own launch count; nothing under fft/, models/, spectral/ or
// parallel/ reaches it.  Bound on the H100 at n <= 16384: bytes, 16 B a
// point (two float32 planes read, two written).

#include <cstdint>

#include "fft_block.cuh"

namespace {

constexpr int kPointsPerBlock = 4096;  // rows per block = max(1, this / n)

// y[:, :out_n] = scale * DFT(x) over rows of n = 2^log2n points; xi null
// reads a real input.  y rows are out_n wide.
__global__ void fft_pow2_radix2_kernel(const float* __restrict__ xr,
                                       const float* __restrict__ xi, float* __restrict__ yr,
                                       float* __restrict__ yi, const float2* __restrict__ tw,
                                       int log2n, int out_n, long long rows, int rows_per_block,
                                       float scale) {
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

// y[:, :out_n] = scale * DFT(x) over rows of n = 2^log2n points by the
// radix-2 design; xi may be null (real input); tw is the (n/2)-entry
// table exp(-+2 pi i j / n) (ops/cuda_fft.py: twiddle_table), forward or
// conjugate.  Returns cudaGetLastError().
int gdsp_fft_pow2_radix2(const float* xr, const float* xi, float* yr, float* yi,
                         const float2* tw, int log2n, int out_n, long long rows, float scale,
                         void* stream) {
  const int n = 1 << log2n;
  const int rpb = rows_per_block(n);
  const size_t smem = static_cast<size_t>(rpb) * n * sizeof(float2);
  cudaError_t e = gdsp::allow_smem(fft_pow2_radix2_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (rows + rpb - 1) / rpb;
  const int threads = gdsp::block_threads(static_cast<long long>(rpb) * (n >> 1));
  fft_pow2_radix2_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(xr, xi, yr, yi, tw, log2n, out_n,
                                                                rows, rpb, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
