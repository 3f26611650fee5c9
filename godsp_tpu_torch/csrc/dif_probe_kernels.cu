// K14h and K14i: the butterfly twins for Hopper (sm_90a), the radix-2
// networks with no dense matrix of tools/probe_vdif.py and
// tools/probe_sdif.py.  They run under godsp_tpu_torch/probes/vdif.py and
// probes/sdif.py.  No library kernel is called; every twiddle comes from a
// table built in float64 on the host and rounded once (ops/cuda_probes.py:
// vdif_tables, sdif_tables).
//
// vdif_kernel<N1> replaces tools/probe_vdif.py:116 (vdif_op over
// _vdif_kernel :82): per row of n = N1 x 128 points (N1 in 1, 2, 4, 8), the
// N1-point DFT across the row's slices (slice_network.cuh, after
// pallas_fft._dft_slices: radix-2 DIT, bit-reversed slice order in), the
// twiddle T[k1, p] = W_n^{k1 p} x scale, then a 128-point radix-2 DIF
// along each slice (_lane_dft.lane_dif_128).  Position k1 128 + p of the output holds bin
// k1 + N1 brev7(p): the vdif digit order.  Design: one warp owns a row;
// lane l holds points p = l + 32 q, q = 0..3, of all N1 slices (4 N1 complex
// values, 64 registers at N1 = 8), loaded and stored 32 consecutive floats
// a (slice, q): every access is one 128-byte line a warp.  The slice DFT
// and T run in registers; the DIF stages at w = 64 and 32 pair registers
// q ^ 2 and q ^ 1 of one lane; the stages at w = 16 .. 1 pair lanes l ^ w
// by __shfl_xor_sync, two shuffles (re, im) a value a stage, where the TPU
// paid full-width lane rolls and selects.  The b element of a pair takes
// W_{2w}^{p mod w}.  Bound on the H100 at 16384 x 1024: 268 MB of traffic,
// 0.080 ms at 3.35 TB/s (5 log2 n + 6 = 56 float32 operations a point:
// 0.014 ms at 67 TFLOP/s): bytes.  Its shuffles, 5 stages x 2 N1 x 4 a
// lane, are ~5.2e6 warp instructions at 16384 rows: ~0.02 ms at one a
// clock an SM.
//
// sdif_peel_kernel replaces tools/probe_sdif.py:116 (the pl.pallas_call of
// sdif_peel, over _sdif_kernel :136): the 128-point peel of an N = 128 m
// signal seen as (128, m): seven radix-2 DIF stages across the 128 rows
// (stage s, half h = 64 >> s: row i with i / h even takes x[i] + x[i + h],
// the row i + h takes (x[i] - x[i + h]) W_{2h}^{i mod h}), then the post
// twiddle Tb[r, t] = W_N^{brev7(r) t}.  Row r then holds the dense peel's
// row brev7(r): K8 (outer_kernel.cu) at d1 = 128, d2 = 1 up to that row
// map.  Design: a block stages a 128-row x 32-column tile of both planes
// in shared memory (32 KB), loaded a warp a row segment (128 bytes,
// coalesced along m); runs the seven stages there behind a barrier each,
// a thread owning one column (the 32 columns of a warp fall in 32 banks);
// applies Tb from K8's factored tables (the exponent brev7(r) t < N exact
// in 64-bit integers, W_N^p = hi[p >> lo_bits] lo[p & mask]); and stores
// the tile as it loaded it.  A ragged last tile is guarded; leading batch
// dimensions spread over grid.y and grid.z (row_grid).  Bound: bytes,
// 0.080 ms at 2^24 (7 x 5 + 6 = 41 float32 operations a point: 0.010 ms).

#include <cuda_runtime.h>

#include <cstdint>

#include "fft_block.cuh"
#include "slice_network.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kQ = kLanes / 32;  // points of a slice a lane holds: p = lane + 32 q
constexpr int kVdifThreads = 256;
constexpr int kVdifRows = kVdifThreads / 32;  // rows a block: one a warp
constexpr int kPeel = 128;                   // rows of the sdif peel
constexpr int kCols = 32;                    // columns of an sdif tile
constexpr int kSdifThreads = 256;
constexpr int kColStep = kSdifThreads / kCols;  // rows a thread steps over

using gdsp::cadd;
using gdsp::cmul;
using gdsp::csub;
using gdsp::log2_small;
using gdsp::rev_bits;

// ---------------------------------------------------------------------------
// K14h: vdif
// ---------------------------------------------------------------------------

// tab: T (N1 x 128 float2, scale folded in), then the seven lane stages'
// W_{2w}^j, j < w, stage w at 128 - 2 w (127 float2).
template <int N1>
__global__ void __launch_bounds__(kVdifThreads)
vdif_kernel(const float* __restrict__ xr, const float* __restrict__ xi, float* __restrict__ yr,
            float* __restrict__ yi, const float2* __restrict__ tab, long long b) {
  constexpr int kBits = log2_small(N1);
  constexpr int n = N1 * kLanes;
  const long long row = gdsp::block_row() * kVdifRows + (threadIdx.x >> 5);
  if (row >= b) return;  // the whole warp: its shuffles keep all 32 lanes
  const int lane = threadIdx.x & 31;
  const float2* T = tab;
  const float2* S = tab + n;
  const size_t base = static_cast<size_t>(row) * n + lane;

  float2 z[N1][kQ];
#pragma unroll
  for (int j1 = 0; j1 < N1; ++j1) {
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const size_t g = base + j1 * kLanes + 32 * q;
      z[rev_bits(j1, kBits)][q] = make_float2(__ldg(xr + g), __ldg(xi + g));
    }
  }

  // The N1-point DFT across slices: radix-2 DIT in place, natural k1 out.
  gdsp::slice_dft(z);

  // T, then the 128-point DIF of each slice.
#pragma unroll
  for (int k1 = 0; k1 < N1; ++k1) {
#pragma unroll
    for (int q = 0; q < kQ; ++q) z[k1][q] = cmul(z[k1][q], __ldg(&T[k1 * kLanes + lane + 32 * q]));
  }
  const float2 w64a = __ldg(&S[lane]), w64b = __ldg(&S[lane + 32]), w32 = __ldg(&S[64 + lane]);
#pragma unroll
  for (int k1 = 0; k1 < N1; ++k1) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {  // w = 64: p and p + 64 are q and q + 2
      const float2 a = z[k1][q], c = z[k1][q + 2];
      z[k1][q] = cadd(a, c);
      z[k1][q + 2] = cmul(csub(a, c), q == 0 ? w64a : w64b);
    }
#pragma unroll
    for (int q = 0; q < kQ; q += 2) {  // w = 32: q and q + 1
      const float2 a = z[k1][q], c = z[k1][q + 1];
      z[k1][q] = cadd(a, c);
      z[k1][q + 1] = cmul(csub(a, c), w32);
    }
  }
#pragma unroll
  for (int st = 0; st < 5; ++st) {  // w = 16 .. 1: lanes l and l ^ w
    const int w = 16 >> st;
    const bool low = (lane & w) == 0;
    const float2 tw = __ldg(&S[kLanes - 2 * w + (lane & (w - 1))]);
#pragma unroll
    for (int k1 = 0; k1 < N1; ++k1) {
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float2 v = z[k1][q];
        const float2 u = make_float2(__shfl_xor_sync(0xffffffffu, v.x, w),
                                     __shfl_xor_sync(0xffffffffu, v.y, w));
        z[k1][q] = low ? cadd(v, u) : cmul(csub(u, v), tw);
      }
    }
  }

#pragma unroll
  for (int k1 = 0; k1 < N1; ++k1) {
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const size_t g = base + k1 * kLanes + 32 * q;
      yr[g] = z[k1][q].x;
      yi[g] = z[k1][q].y;
    }
  }
}

// ---------------------------------------------------------------------------
// K14i: sdif_peel
// ---------------------------------------------------------------------------

// cols: seven 128-entry stage columns (float2), stage s's row i holding
// W_{2h}^{i mod h} where i / h is odd (1 elsewhere, unused); hi and lo: the
// factored W_N table of 2^lo_bits low entries.
__global__ void __launch_bounds__(kSdifThreads)
sdif_peel_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                 float* __restrict__ yr, float* __restrict__ yi,
                 const float2* __restrict__ cols, const float2* __restrict__ hi,
                 const float2* __restrict__ lo, long long m, long long batch, int lo_bits) {
  __shared__ float sr[kPeel][kCols];
  __shared__ float si[kPeel][kCols];
  const long long bt = gdsp::block_row();
  if (bt >= batch) return;
  const int c = threadIdx.x % kCols;
  const int r0 = threadIdx.x / kCols;
  const long long t = static_cast<long long>(blockIdx.x) * kCols + c;
  const bool in = t < m;
  const size_t base = static_cast<size_t>(bt) * kPeel * m + t;

  for (int r = r0; r < kPeel; r += kColStep) {
    const size_t g = base + static_cast<size_t>(r) * m;
    sr[r][c] = in ? __ldg(xr + g) : 0.f;
    si[r][c] = in ? __ldg(xi + g) : 0.f;
  }
  __syncthreads();

  for (int s = 0; s < 7; ++s) {
    const int h = 64 >> s;
    for (int k = r0; k < kPeel / 2; k += kColStep) {
      const int i = (k / h) * 2 * h + k % h;  // the a row; its b row is i + h
      const float2 a = make_float2(sr[i][c], si[i][c]);
      const float2 v = make_float2(sr[i + h][c], si[i + h][c]);
      const float2 d = cmul(csub(a, v), __ldg(&cols[s * kPeel + i + h]));
      sr[i][c] = a.x + v.x;
      si[i][c] = a.y + v.y;
      sr[i + h][c] = d.x;
      si[i + h][c] = d.y;
    }
    __syncthreads();
  }

  if (!in) return;
  const unsigned long long lo_mask = (1ull << lo_bits) - 1;
  for (int r = r0; r < kPeel; r += kColStep) {
    const unsigned long long p =
        static_cast<unsigned long long>(__brev(static_cast<unsigned>(r)) >> 25) * t;  // < N
    const float2 wh = __ldg(&hi[p >> lo_bits]);
    const float2 wl = __ldg(&lo[p & lo_mask]);
    const float2 y = cmul(make_float2(sr[r][c], si[r][c]), cmul(wh, wl));
    const size_t g = base + static_cast<size_t>(r) * m;
    yr[g] = y.x;
    yi[g] = y.y;
  }
}

}  // namespace

extern "C" {

// vdif of (b, n) float32 planes, n = N1 x 128 with N1 in 1, 2, 4, 8, every
// pointer 16-byte aligned; tab as vdif_kernel's.  Returns cudaGetLastError(),
// or cudaErrorInvalidValue for a shape the kernel does not take.
int gdsp_vdif(const float* xr, const float* xi, float* yr, float* yi, const float2* tab,
              long long b, int n, void* stream) {
  if (b < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  const dim3 grid = gdsp::row_grid(1, (b + kVdifRows - 1) / kVdifRows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 128: vdif_kernel<1><<<grid, kVdifThreads, 0, s>>>(xr, xi, yr, yi, tab, b); break;
    case 256: vdif_kernel<2><<<grid, kVdifThreads, 0, s>>>(xr, xi, yr, yi, tab, b); break;
    case 512: vdif_kernel<4><<<grid, kVdifThreads, 0, s>>>(xr, xi, yr, yi, tab, b); break;
    case 1024: vdif_kernel<8><<<grid, kVdifThreads, 0, s>>>(xr, xi, yr, yi, tab, b); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The sdif peel of `batch` (128, m) float32 planes; cols, hi, lo and
// lo_bits as sdif_peel_kernel's (hi and lo: W_N, N = 128 m).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for m < 1 or batch < 0.
int gdsp_sdif_peel(const float* xr, const float* xi, float* yr, float* yi, const float2* cols,
                   const float2* hi, const float2* lo, long long m, long long batch, int lo_bits,
                   void* stream) {
  if (m < 1 || batch < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const long long tiles = (m + kCols - 1) / kCols;
  sdif_peel_kernel<<<gdsp::row_grid(static_cast<unsigned>(tiles), batch), kSdifThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(xr, xi, yr, yi, cols, hi, lo, m, batch,
                                                          lo_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
