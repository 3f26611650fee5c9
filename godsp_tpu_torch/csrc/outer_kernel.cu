// Outer DFT levels of the giant-N FFT plan for Hopper (sm_90a).
//
// Replaces godsp_tpu/ops/pallas_outer.py: outer_dft_split (inner kernel
// _outer_kernel).  For a length-N transform viewed as (m, n3), N = m * n3,
// each column c of each batch row gets
//   * the m-point DFT down the column (row index i in natural order),
//   * a multiply by W_N^{k c}, W_N = exp(-+2 pi i / N), for its bin k,
//   * a store at row (k % d1) * d2 + k / d1, the TPU kernel's row order
//     for its two dense levels of d1 and d2 points (m = d1 * d2);
// what is left is the n3-point FFT of each row (fft/large.py).  The TPU
// ran the two levels as Karatsuba matmuls on the MXU; here the column DFT
// is one radix-2 FFT in shared memory, as in every kernel of this library.
//
// Grid: (column tiles, batch), the batch spread over y and z (row_grid).
// A block loads a tile of T adjacent columns x m rows, coalesced along
// the columns (T >= 8 floats fills a 32-byte sector), into shared memory
// as T rows of m points in bit-reversed order, at a row stride of m + 1
// float2 so that the column-wise loads and stores hit distinct banks;
// runs block_fft_rows (fft_block.cuh) with the float64-built m-point
// table; then twiddles and stores, coalesced along the columns.
//
// Precision: N reaches 2^28, where an N-entry table would take 2 GB and a
// float32 angle would lose the 120 dB bar.  The exponent p = k * c < N is
// exact in 64-bit integers (k < m, c < n3), and W_N^p = hi[p >> s] *
// lo[p & (2^s - 1)] reads two float64-built, once-rounded float32 tables
// of about sqrt(N) entries each: godsp_tpu's factoring (pallas_outer.py
// _outer_tables), one extra float32 rounding.  No __sinf/__cosf, no
// matmul, so no TF32.
//
// Bound on the H100: one read and one write of two float32 planes, 16
// bytes a point (268 MB at 2^24, 0.080 ms at 3.35 TB/s), against
// 5 log2(m) flops a point for the column FFT: memory-bound.  Each block's
// radix-2 stages in shared memory, with one barrier a stage, are what
// bind this simple version (as they bind K1); wgmma, TMA and clusters are
// the later speed work.

#include <cstdint>

#include "fft_block.cuh"

namespace {

constexpr int kPointsPerBlock = 4096;  // tile columns T = max(8, this / m)
constexpr int kMinCols = 8;            // one 32-byte sector of floats a row

__global__ void outer_dft_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                                 float* __restrict__ yr, float* __restrict__ yi,
                                 const float2* __restrict__ tw, const float2* __restrict__ hi,
                                 const float2* __restrict__ lo, int log2m, int d2,
                                 long long n3, long long batch, int log2t, int lo_bits) {
  extern __shared__ float2 s[];
  const long long b = gdsp::block_row();
  if (b >= batch) return;
  const int m = 1 << log2m;
  const int d1 = m / d2;
  const int T = 1 << log2t;
  const int stride = m + 1;
  const long long c0 = static_cast<long long>(blockIdx.x) << log2t;
  const long long base = b * m * n3;
  const int total = m << log2t;

  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int i = e >> log2t;
    const int t = e & (T - 1);
    const long long c = c0 + t;
    float2 v = make_float2(0.f, 0.f);
    if (c < n3) {
      const long long g = base + i * n3 + c;
      v = make_float2(xr[g], xi[g]);
    }
    s[t * stride + gdsp::bit_reverse(i, log2m)] = v;
  }
  __syncthreads();
  gdsp::block_fft_rows(s, T, m, log2m, tw, stride);

  const unsigned long long lo_mask = (1ull << lo_bits) - 1;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int r = e >> log2t;
    const int t = e & (T - 1);
    const long long c = c0 + t;
    if (c >= n3) continue;
    const int k = r / d2 + d1 * (r % d2);  // row r = (k % d1) * d2 + k / d1
    const unsigned long long p = static_cast<unsigned long long>(k) * c;  // < N: reduced
    const float2 wh = __ldg(&hi[p >> lo_bits]);
    const float2 wl = __ldg(&lo[p & lo_mask]);
    const float2 w = make_float2(wh.x * wl.x - wh.y * wl.y, wh.x * wl.y + wh.y * wl.x);
    const float2 v = s[t * stride + k];
    const long long g = base + r * n3 + c;
    yr[g] = v.x * w.x - v.y * w.y;
    yi[g] = v.x * w.y + v.y * w.x;
  }
}

}  // namespace

extern "C" {

// y = the outer levels of x over `batch` (m, n3) planes, m = 2^log2m,
// rows stored in the (d1 = m / d2, d2) order above.  tw is the m-point
// table (conjugate for the inverse); hi and lo the factored W_N tables,
// lo of 2^lo_bits entries.  Returns cudaGetLastError().
int gdsp_outer_dft(const float* xr, const float* xi, float* yr, float* yi, const float2* tw,
                   const float2* hi, const float2* lo, int log2m, int d2, long long n3,
                   long long batch, int lo_bits, void* stream) {
  const int m = 1 << log2m;
  int log2t = 0;
  while ((m << log2t) < kPointsPerBlock || (1 << log2t) < kMinCols) ++log2t;
  const int T = 1 << log2t;
  const size_t smem = static_cast<size_t>(T) * (m + 1) * sizeof(float2);
  cudaError_t e = gdsp::allow_smem(outer_dft_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles = (n3 + T - 1) / T;
  const int threads = gdsp::block_threads(static_cast<long long>(T) * (m >> 1));
  outer_dft_kernel<<<gdsp::row_grid(static_cast<unsigned>(tiles), batch), threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(xr, xi, yr, yi, tw, hi, lo, log2m,
                                                          d2, n3, batch, log2t, lo_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
