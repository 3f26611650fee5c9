// Fused last peel + row FFT of the giant-N FFT plan for Hopper (sm_90a).
//
// Replaces godsp_tpu/ops/pallas_outer.py: peel_rows_fused_split (inner
// kernel _peel_rows_kernel).  Each (128, n3) batch element of the input is
// one length-128 n3 sub-transform; row k1 of the result is
//
//   Y[k1, k3] = scale * sum_t W_n3^{k3 t} W_{128 n3}^{k1 t} sum_i W_128^{k1 i} x[i, t],
//
// the 128-point column DFT, its twiddle and the n3-point row FFT in one
// pass over device memory (the separate route is outer_dft_split(128, 1)
// then fft_pow2).  Rows come out in natural bin order; the TPU kernel's
// digit order is not ported.  n3 is a power of 2 from 256 to 8192.
//
// Grid: (128 / R row groups, batch), the row group fastest, so the blocks
// of one batch element run together and the input they all read stays in
// L2 (1-8 MB a batch element against 50 MB).  Block g owns the R rows
// k1 = g + G j (G = 128 / R, j < R): R rows of n3 float2 in shared memory,
// 128 KB at R = 2, n3 = 8192 and at R = 16, n3 = 1024.
//
// Phase A, one column t a thread at a time (loads coalesced along t): one
// radix-G decimation step of the column DFT for the block's residue class,
// with i = i0 + R i1,
//   u[i0]   = W_128^{g i0} sum_{i1 < G} x[i0 + R i1, t] W_128^{R g i1}
//   X[g+Gj] = sum_{i0 < R} W_R^{j i0} u[i0]                (R-point DFT)
// which costs 128 + R^2 complex multiply-adds a column instead of the
// dense form's 128 R; then the twiddle W_{128 n3}^{k1 t}, and a store at
// the bit-reversed position of t in row j.  Phase B runs block_fft_rows
// (fft_block.cuh) over the R rows, then the scaled rows are stored,
// coalesced along k3.
//
// Precision: every table is built in float64 on the host and rounded once
// to float32 (W_128 whole, the n3-point row table, and W_{128 n3}^p =
// hi[p >> s] * lo[p & (2^s - 1)] factored as in K8, p = k1 t < 128 n3
// exact in integers); float32 FMA on CUDA cores, no matmul, so no TF32.
//
// Bound on the H100: one read and one write of two float32 planes, 16
// bytes a point (268 MB at 16 x 2^20, 0.080 ms at 3.35 TB/s), against
// 5 log2(128 n3) flops a point.  This simple version re-reads each batch
// element's input from L2 once per row group (G = 64 times at n3 = 8192):
// L2 traffic and the bit-reversed shared-memory stores, not device memory,
// are what bind it.  A cluster that shares the input over distributed
// shared memory is the later speed work.

#include <cstdint>

#include "fft_block.cuh"

namespace {

constexpr int kD = 128;  // points of the fused peel
constexpr int kThreads = 512;
constexpr int kSlabPoints = 16384;  // R * n3 float2 in shared memory: 128 KB
constexpr int kMaxRows = 16;        // R: u[R] lives in registers

template <int R>
__global__ void __launch_bounds__(kThreads)
    peel_rows_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                     float* __restrict__ yr, float* __restrict__ yi,
                     const float2* __restrict__ w128, const float2* __restrict__ tw,
                     const float2* __restrict__ hi, const float2* __restrict__ lo, int log2n3,
                     long long batch, int lo_bits, float scale) {
  constexpr int G = kD / R;  // row groups a batch element
  extern __shared__ float2 smem[];
  float2* wt = smem;      // W_128^p, p < 128
  float2* s = smem + kD;  // R rows of n3 points
  const long long b = gdsp::block_row();
  if (b >= batch) return;
  const int g = blockIdx.x;
  const int n3 = 1 << log2n3;
  for (int e = threadIdx.x; e < kD; e += blockDim.x) wt[e] = w128[e];
  __syncthreads();

  const long long base = b * kD * n3;
  const unsigned lo_mask = (1u << lo_bits) - 1;
  for (int t = threadIdx.x; t < n3; t += blockDim.x) {
    float2 u[R];
#pragma unroll
    for (int i0 = 0; i0 < R; ++i0) {
      float ar = 0.f, ai = 0.f;
#pragma unroll 8
      for (int i1 = 0; i1 < G; ++i1) {
        const long long gi = base + static_cast<long long>(i0 + R * i1) * n3 + t;
        const float vr = __ldg(&xr[gi]);
        const float vi = __ldg(&xi[gi]);
        const float2 w = wt[(R * g * i1) & (kD - 1)];
        ar = fmaf(vr, w.x, fmaf(-vi, w.y, ar));
        ai = fmaf(vr, w.y, fmaf(vi, w.x, ai));
      }
      const float2 w = wt[(g * i0) & (kD - 1)];
      u[i0] = make_float2(ar * w.x - ai * w.y, ar * w.y + ai * w.x);
    }
    const unsigned tr = gdsp::bit_reverse(t, log2n3);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float vr = 0.f, vi = 0.f;
#pragma unroll
      for (int i0 = 0; i0 < R; ++i0) {
        const float2 w = wt[(G * j * i0) & (kD - 1)];
        vr = fmaf(u[i0].x, w.x, fmaf(-u[i0].y, w.y, vr));
        vi = fmaf(u[i0].x, w.y, fmaf(u[i0].y, w.x, vi));
      }
      const unsigned p = static_cast<unsigned>(g + G * j) * static_cast<unsigned>(t);
      const float2 wh = __ldg(&hi[p >> lo_bits]);
      const float2 wl = __ldg(&lo[p & lo_mask]);
      const float2 w = make_float2(wh.x * wl.x - wh.y * wl.y, wh.x * wl.y + wh.y * wl.x);
      s[j * n3 + tr] = make_float2(vr * w.x - vi * w.y, vr * w.y + vi * w.x);
    }
  }
  __syncthreads();
  gdsp::block_fft_rows(s, R, n3, log2n3, tw);

  for (int e = threadIdx.x; e < (R << log2n3); e += blockDim.x) {
    const int j = e >> log2n3;
    const int k3 = e & (n3 - 1);
    const long long gi = base + static_cast<long long>(g + G * j) * n3 + k3;
    const float2 c = s[e];
    yr[gi] = c.x * scale;
    yi[gi] = c.y * scale;
  }
}

template <int R>
int launch(const float* xr, const float* xi, float* yr, float* yi, const float2* w128,
           const float2* tw, const float2* hi, const float2* lo, int log2n3, long long batch,
           int lo_bits, float scale, cudaStream_t stream) {
  const size_t smem = (kD + (static_cast<size_t>(R) << log2n3)) * sizeof(float2);
  cudaError_t e = gdsp::allow_smem(peel_rows_kernel<R>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  peel_rows_kernel<R><<<gdsp::row_grid(kD / R, batch), kThreads, smem, stream>>>(
      xr, xi, yr, yi, w128, tw, hi, lo, log2n3, batch, lo_bits, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y = scale * (the 128-point peel, its twiddle and the n3-point row FFT)
// of x over `batch` (128, n3) planes, n3 = 2^log2n3 in 256..8192, rows in
// natural order.  w128 is the whole 128-entry W_128 table, tw the n3-point
// row table (both conjugate for the inverse), hi and lo the factored
// W_{128 n3} tables, lo of 2^lo_bits entries.  Returns cudaGetLastError().
int gdsp_peel_rows(const float* xr, const float* xi, float* yr, float* yi, const float2* w128,
                   const float2* tw, const float2* hi, const float2* lo, int log2n3,
                   long long batch, int lo_bits, float scale, void* stream) {
  if (log2n3 < 8 || log2n3 > 13) return static_cast<int>(cudaErrorInvalidValue);
  int rows = kSlabPoints >> log2n3;
  if (rows > kMaxRows) rows = kMaxRows;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 2:
      return launch<2>(xr, xi, yr, yi, w128, tw, hi, lo, log2n3, batch, lo_bits, scale, st);
    case 4:
      return launch<4>(xr, xi, yr, yi, w128, tw, hi, lo, log2n3, batch, lo_bits, scale, st);
    case 8:
      return launch<8>(xr, xi, yr, yi, w128, tw, hi, lo, log2n3, batch, lo_bits, scale, st);
    default:
      return launch<16>(xr, xi, yr, yi, w128, tw, hi, lo, log2n3, batch, lo_bits, scale, st);
  }
}

}  // extern "C"
