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
// along each slice (_lane_dft.lane_dif_128).  Position k1 128 + p of the
// output holds bin k1 + N1 brev7(p): the vdif digit order.  A warp owns a
// row: lane l holds points p = l + 32 q, q = 0..3, of all N1 slices (4 N1
// complex values, 64 registers at N1 = 8).  The slice DFT and T run in
// registers; the DIF stages at w = 64 and 32 pair registers q ^ 2 and
// q ^ 1 of one lane; the stages at w = 16 .. 1 pair lanes l ^ w by
// __shfl_xor_sync, two shuffles (re, im) a value a stage, where the TPU
// paid full-width lane rolls and selects.  The b element of a pair takes
// W_{2w}^{p mod w}.  Bound on the H100 at 16384 x 1024: 268 MB of traffic,
// 0.080 ms at 3.35 TB/s (5 log2 n + 6 = 56 float32 operations a point:
// 0.014 ms at 67 TFLOP/s): bytes.  Its 320 shuffles a lane a row are ~5.2e6
// warp instructions at 16384 rows, ~0.02 ms at one a clock an SM.
//   Its first design, vdif_sync_kernel (gdsp_vdif_sync, kept as the
// yardstick): eight rows a block on a grid of every row, the row loaded
// and stored 4 bytes a lane (one 128-byte line a warp), T and the stage
// twiddles read from device memory for every row, each shuffle stage
// computing both arms of `low ? a + b : (b - a) w`.  As compiled
// (probes/bd1_vdif.py, on an NVIDIA H100 80GB HBM3 at 700.00 W): 114
// registers, no stack frame, 4128 instructions a row (104 LDG, 320 SHFL, 64
// STG, 1908 float32); 0.193 ms by chain, torch.fft.fft 0.184.  Its row by
// 16-byte loads through shared memory took 0.120, T from shared memory
// 0.161; two rows a warp put the second row in a stack frame (0.356).
//   The redesign, vdif_kernel: blocks of four warps, a warp a row (VdPlan).
// The row lands by 16-byte cp.async in the warp's 8 KB buffer (at N1 = 8)
// while the block reads T into shared memory and each warp its stage
// twiddles into registers; it is then read into registers.  The slice order
// is reversed in the shared-memory address, not in the register index:
// loaded into z[brev(j1)] as the first design loads it, z went to a
// 256-byte stack frame and the kernel took 0.154 ms.  A lane-exchange
// stage is one fma by a sign (u + v on the a lane, u - v on the b lane) and
// one complex multiply by the lane's twiddle (1 on the a lane): 2752
// instructions a warp, T's staging included (1588 of them float32).  On
// the same card it took 0.097 ms by chain; a persistent grid whose warps
// walk rows, each next row's copy issued before the current row's
// butterflies, 0.111; the outputs staged for 16-byte stores 0.103
// (probes/bd1_vdif.py --tune).
// Shared memory: 8 KB of T and 8 KB a warp at N1 = 8, 40 KB a block, 16
// warps an SM.  It gives the first design's result bit for bit.
//
// sdif_peel_kernel replaces tools/probe_sdif.py:116 (the pl.pallas_call of
// sdif_peel, over _sdif_kernel :136): the 128-point peel of an N = 128 m
// signal seen as (128, m): seven radix-2 DIF stages across the 128 rows
// (stage s, half h = 64 >> s: row i with i / h even takes x[i] + x[i + h],
// the row i + h takes (x[i] - x[i + h]) W_{2h}^{i mod h}), then the post
// twiddle Tb[r, t] = W_N^{brev7(r) t}.  Row r then holds the dense peel's
// row brev7(r): K8 (outer_kernel.cu) at d1 = 128, d2 = 1 up to that row
// map.  Bound on the H100: bytes, one read and one write of both planes,
// 0.080 ms at 2^24 (7 x 5 + 6 = 41 float32 operations a point: 0.010 ms).
//   The redesign runs on K8's column tile: a CTA of 256 threads takes 32
// adjacent columns x 128 rows, thread (j, c) = j 32 + c column c, so every
// warp access is one row's 32 columns (128 bytes) and nothing is staged
// before the stages.  Each thread loads its 16 rows j + 8 q of both planes
// (all 32 loads issued before the first butterfly) and runs the stages at
// h = 64, 32, 16, 8, which pair rows 8 apart or more, in its registers;
// one exchange through 32 KB of shared memory (a row's 32 words, one a
// bank) hands it the 16 rows 16 j + e for the stages at h = 4, 2, 1.  Each
// butterfly is the first design's IEEE operations on the same twiddles
// (sdif_tables' stage columns, one address a warp), so the stages equal
// its stages.  Tb at the store: W_N^{k c0} of the row from K8's factored
// hi and lo (the exponent k c0 < N exact in 64-bit integers, one address a
// warp) times K8's tile table W_N^{k cc} (_tile_table, coalesced), k =
// brev7(r), as K8's own store does: gathering hi and lo at k t a point,
// the first design's Tb, ran 1-2 % slower and spilled 8 bytes
// (probes/noframe_sdif.py).  The plan is SdPlan (gdsp_sdif_geometry).
// Its first design, sdif_peel_sync_kernel (gdsp_sdif_peel_sync, kept as
// the yardstick): a block stages the tile of both planes in shared memory
// by 4-byte loads, runs the seven stages there behind a barrier each, a
// thread owning one column, then Tb gathered a point; 0.240 ms by chain at
// 2^24 where its tile loaded and stored alone took 0.099, with the stages
// 0.178, with Tb 0.177 (probes/noframe_sdif.py, NVIDIA H100 80GB HBM3,
// 700.00 W).  A ragged last tile is guarded in both; leading batch
// dimensions spread over grid.y and grid.z (row_grid).

#include <cuda_runtime.h>

#include <cstdint>

#include "fft_block.cuh"
#include "fft_regs.cuh"
#include "lane_contract.cuh"
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
// W_{2w}^j, j < w, stage w at 128 - 2 w (127 float2).  A row is held as
// z[slice][q], lane l holding points p = l + 32 q of every slice.

// The first design's load: a row's slices into z, slice j1 in z[brev(j1)].
template <int N1>
__device__ __forceinline__ void vdif_sync_load(float2 (&z)[N1][kQ], const float* __restrict__ xr,
                                               const float* __restrict__ xi, size_t base) {
  constexpr int kBits = log2_small(N1);
#pragma unroll
  for (int j1 = 0; j1 < N1; ++j1) {
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const size_t g = base + j1 * kLanes + 32 * q;
      z[rev_bits(j1, kBits)][q] = make_float2(__ldg(xr + g), __ldg(xi + g));
    }
  }
}

// The first design's arithmetic on a loaded row: the slice DFT, T, then the
// DIF (each stage's twiddles read from S for the row).
template <int N1>
__device__ __forceinline__ void vdif_sync_row(float2 (&z)[N1][kQ], const float2* __restrict__ T,
                                              const float2* __restrict__ S, int lane) {
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
}

// The row out, position k1 128 + p from z[k1][q].
template <int N1>
__device__ __forceinline__ void vdif_store(const float2 (&z)[N1][kQ], float* __restrict__ yr,
                                           float* __restrict__ yi, size_t base) {
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

// vdif's first design, the yardstick (gdsp_vdif_sync): one warp a row, one
// row a warp, eight rows a block on row_grid.
template <int N1>
__global__ void __launch_bounds__(kVdifThreads)
vdif_sync_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                 float* __restrict__ yr, float* __restrict__ yi, const float2* __restrict__ tab,
                 long long b) {
  constexpr int n = N1 * kLanes;
  const long long row = gdsp::block_row() * kVdifRows + (threadIdx.x >> 5);
  if (row >= b) return;  // the whole warp: its shuffles keep all 32 lanes
  const int lane = threadIdx.x & 31;
  const size_t base = static_cast<size_t>(row) * n + lane;
  float2 z[N1][kQ];
  vdif_sync_load(z, xr, xi, base);
  vdif_sync_row(z, tab, tab + n, lane);
  vdif_store(z, yr, yi, base);
}

// ---------------------------------------------------------------------------
// K14h redesigned: a warp a row, the row brought by 16-byte cp.async into the
// warp's buffer while the block reads T (the plan: VdPlan)
// ---------------------------------------------------------------------------

constexpr int kVdWarps = 4;      // warps a block, a row each
constexpr int kVdThreads = 32 * kVdWarps;
constexpr int kVdMinBlocks = 4;  // blocks an SM the registers are sized for: 16 warps

// Bytes of shared memory a block of vdif_kernel<n1> takes: T, then each
// warp's row buffer (both planes of a row).
__host__ __device__ constexpr int vdif_smem(int n1) {
  return n1 * kLanes * 8 + kVdWarps * n1 * kLanes * 8;
}

// The stage twiddles a lane uses on every row: W_128^p at w = 64 (p = lane,
// lane + 32), W_64^lane at w = 32, and at w = 16 .. 1 W_{2w}^{lane mod w}
// where lane & w (the b element), 1 where not.
struct VdTw {
  float2 w64a, w64b, w32, s[5];
};

// The slice DFT, T (from shared memory) and the DIF of a loaded row.  A
// lane-exchange stage takes u from lane l ^ w and forms u + v on the a lane,
// u - v on the b lane, as one fma by a sign; both then multiply by their
// twiddle (1 on the a lane).
template <int N1>
__device__ __forceinline__ void vdif_butterflies(float2 (&z)[N1][kQ], const float2* sT,
                                                 const VdTw& tw, int lane) {
  gdsp::slice_dft(z);
#pragma unroll
  for (int k1 = 0; k1 < N1; ++k1) {
#pragma unroll
    for (int q = 0; q < kQ; ++q) z[k1][q] = cmul(z[k1][q], sT[k1 * kLanes + lane + 32 * q]);
  }
#pragma unroll
  for (int k1 = 0; k1 < N1; ++k1) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {  // w = 64: p and p + 64 are q and q + 2
      const float2 a = z[k1][q], c = z[k1][q + 2];
      z[k1][q] = cadd(a, c);
      z[k1][q + 2] = cmul(csub(a, c), q == 0 ? tw.w64a : tw.w64b);
    }
#pragma unroll
    for (int q = 0; q < kQ; q += 2) {  // w = 32: q and q + 1
      const float2 a = z[k1][q], c = z[k1][q + 1];
      z[k1][q] = cadd(a, c);
      z[k1][q + 1] = cmul(csub(a, c), tw.w32);
    }
  }
#pragma unroll
  for (int st = 0; st < 5; ++st) {  // w = 16 .. 1: lanes l and l ^ w
    const int w = 16 >> st;
    const float sg = (lane & w) ? -1.f : 1.f;
#pragma unroll
    for (int k1 = 0; k1 < N1; ++k1) {
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float2 v = z[k1][q];
        const float2 u = make_float2(__shfl_xor_sync(0xffffffffu, v.x, w),
                                     __shfl_xor_sync(0xffffffffu, v.y, w));
        z[k1][q] = cmul(make_float2(fmaf(sg, v.x, u.x), fmaf(sg, v.y, u.y)), tw.s[st]);
      }
    }
  }
}

// Row `row` of both planes (n floats each) into buf (re, then im) by 16-byte
// cp.async, one commit group.
template <int N1>
__device__ __forceinline__ void vdif_fetch(float* buf, const float* __restrict__ xr,
                                           const float* __restrict__ xi, long long row, int lane) {
  constexpr int n = N1 * kLanes;
  const size_t at = static_cast<size_t>(row) * n;
#pragma unroll
  for (int e = 4 * lane; e < n; e += 128) {
    gdsp::lane::cp_async16(buf + e, xr + at + e, true);
    gdsp::lane::cp_async16(buf + n + e, xi + at + e, true);
  }
  gdsp::lane::cp_async_commit();
}

// The redesign: warp g of the grid (block g / kVdWarps) takes row g.  The
// row lands by 16-byte cp.async in the warp's buffer while the block reads T
// into shared memory and each warp its stage twiddles into registers, is
// read into registers as the first design holds it, and its outputs are
// stored from there.
template <int N1>
__global__ void __launch_bounds__(kVdThreads, kVdMinBlocks)
vdif_kernel(const float* __restrict__ xr, const float* __restrict__ xi, float* __restrict__ yr,
            float* __restrict__ yi, const float2* __restrict__ tab, long long b) {
  constexpr int n = N1 * kLanes;
  constexpr int kBits = log2_small(N1);
  extern __shared__ float4 vsm[];
  float2* sT = reinterpret_cast<float2*>(vsm);
  float* buf = reinterpret_cast<float*>(vsm) + 2 * n + (threadIdx.x >> 5) * 2 * n;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kVdWarps + (threadIdx.x >> 5);
  if (row < b) vdif_fetch<N1>(buf, xr, xi, row, lane);
  for (int e = threadIdx.x; e < n; e += kVdThreads) sT[e] = __ldg(tab + e);
  const float2* S = tab + n;
  VdTw tw;
  tw.w64a = __ldg(&S[lane]);
  tw.w64b = __ldg(&S[lane + 32]);
  tw.w32 = __ldg(&S[64 + lane]);
#pragma unroll
  for (int st = 0; st < 5; ++st) {
    const int w = 16 >> st;
    tw.s[st] = (lane & w) ? __ldg(&S[kLanes - 2 * w + (lane & (w - 1))]) : make_float2(1.f, 0.f);
  }
  __syncthreads();
  if (row >= b) return;  // the whole warp
  gdsp::lane::cp_async_wait<0>();
  __syncwarp();
  float2 z[N1][kQ];
#pragma unroll
  for (int k = 0; k < N1; ++k) {
#pragma unroll
    for (int q = 0; q < kQ; ++q) {  // z[k] takes slice brev(k): the index in the address
      const int at = rev_bits(k, kBits) * kLanes + lane + 32 * q;
      z[k][q] = make_float2(buf[at], buf[n + at]);
    }
  }
  vdif_butterflies(z, sT, tw, lane);
  vdif_store(z, yr, yi, static_cast<size_t>(row) * n + lane);
}

// ---------------------------------------------------------------------------
// K14i: sdif_peel
// ---------------------------------------------------------------------------

// cols: seven 128-entry stage columns (float2), stage s's row i holding
// W_{2h}^{i mod h} where i / h is odd (1 elsewhere, unused); hi and lo: the
// factored W_N table of 2^lo_bits low entries.
__global__ void __launch_bounds__(kSdifThreads)
sdif_peel_sync_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
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

// ---------------------------------------------------------------------------
// K14i redesigned: K8's column tile, the stages in registers (the plan: SdPlan)
// ---------------------------------------------------------------------------

constexpr int kSdRows = 16;                   // rows a thread holds
constexpr int kSdGroups = kPeel / kSdRows;    // threads a column: 8
constexpr int kSdThreads = kCols * kSdGroups;  // 256
constexpr int kSdMinBlocks = 3;               // blocks an SM the registers are sized for
// Tb as W_N^{k c0} of the row times the tile table's W_N^{k cc} (true), or
// gathered a point from hi and lo at k t, the first design's Tb (false).
constexpr bool kSdifTileTable = true;

using gdsp::regs::unroll;

// Thread (j, c), threadIdx.x = j kCols + c, takes column c0 + c of a 128 x
// kCols tile: rows j + 8 q (q < 16) for the stages at h = 64, 32, 16, 8,
// which pair rows 8 h / 8 apart, q and q ^ h / 8 of its registers; then,
// after one exchange through shared memory, the 16 rows 16 j + e (e < 16)
// for the stages at h = 4, 2, 1, which pair e and e ^ h.  A warp is one j:
// every load and store is a row's 32 columns, 128 bytes, and every access
// to the exchange a row's 32 consecutive words, one a bank.  Each butterfly
// is the first design's: a + b on the a row, cmul(a - b, cols[s][i + h]) on
// the b row.  Row r = 16 j + e then takes Tb = W_N^{k t}, k = brev7(r), t =
// c0 + c, and is stored at row r (K8's row k).
__global__ void __launch_bounds__(kSdThreads, kSdMinBlocks)
sdif_peel_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                 float* __restrict__ yr, float* __restrict__ yi, const float2* __restrict__ cols,
                 const float2* __restrict__ hi, const float2* __restrict__ lo,
                 const float2* __restrict__ tt, long long m, long long batch, int lo_bits) {
  __shared__ float er[kPeel][kCols];
  __shared__ float ei[kPeel][kCols];
  const long long b = gdsp::block_row();
  if (b >= batch) return;  // the whole block: before its barrier
  const int c = threadIdx.x % kCols;
  const int j = threadIdx.x / kCols;
  const long long c0 = static_cast<long long>(blockIdx.x) * kCols;
  const bool in = c0 + c < m;
  const float* __restrict__ pr = xr + b * kPeel * m + c0 + c;
  const float* __restrict__ pi = xi + b * kPeel * m + c0 + c;
  float2 z[kSdRows];
  unroll<kSdRows>([&](auto qq) {  // all 32 loads before the first butterfly
    constexpr int q = GDSP_IDX(qq);
    const long long g = static_cast<long long>(j + kSdGroups * q) * m;
    z[q] = in ? make_float2(__ldg(pr + g), __ldg(pi + g)) : make_float2(0.f, 0.f);
  });
  unroll<4>([&](auto ss) {  // h = 64, 32, 16, 8: registers q and q + h / 8
    constexpr int s = GDSP_IDX(ss);
    constexpr int h = 64 >> s, g = h / kSdGroups;
    unroll<kSdRows>([&](auto qq) {
      constexpr int q = GDSP_IDX(qq);
      if constexpr ((q & g) == 0) {
        const int i = j + kSdGroups * q;  // the a row; its b row is i + h
        const float2 a = z[q], v = z[q + g];
        z[q] = make_float2(a.x + v.x, a.y + v.y);
        z[q + g] = cmul(csub(a, v), __ldg(&cols[s * kPeel + i + h]));
      }
    });
  });
  unroll<kSdRows>([&](auto qq) {
    constexpr int q = GDSP_IDX(qq);
    er[j + kSdGroups * q][c] = z[q].x;
    ei[j + kSdGroups * q][c] = z[q].y;
  });
  __syncthreads();
  unroll<kSdRows>([&](auto ee) {
    constexpr int e = GDSP_IDX(ee);
    z[e] = make_float2(er[kSdRows * j + e][c], ei[kSdRows * j + e][c]);
  });
  unroll<3>([&](auto ss) {  // h = 4, 2, 1: registers e and e + h
    constexpr int s = GDSP_IDX(ss) + 4;
    constexpr int h = 64 >> s;
    unroll<kSdRows>([&](auto ee) {
      constexpr int e = GDSP_IDX(ee);
      if constexpr ((e & h) == 0) {
        const int i = kSdRows * j + e;
        const float2 a = z[e], v = z[e + h];
        z[e] = make_float2(a.x + v.x, a.y + v.y);
        z[e + h] = cmul(csub(a, v), __ldg(&cols[s * kPeel + i + h]));
      }
    });
  });
  if (!in) return;
  const unsigned long long lo_mask = (1ull << lo_bits) - 1;
  const int kj = static_cast<int>(__brev(static_cast<unsigned>(j)) >> 29);  // brev3(j)
  float* __restrict__ qr = yr + b * kPeel * m + c0 + c;
  float* __restrict__ qi = yi + b * kPeel * m + c0 + c;
  unroll<kSdRows>([&](auto ee) {
    constexpr int e = GDSP_IDX(ee);
    const int k = (rev_bits(e, 4) << 3) + kj;  // brev7(16 j + e)
    float2 w;
    if constexpr (kSdifTileTable) {  // W_N^{k c0} W_N^{k c}: one hi and lo address a warp
      const unsigned long long p = static_cast<unsigned long long>(k) * c0;  // < N
      w = cmul(cmul(__ldg(&hi[p >> lo_bits]), __ldg(&lo[p & lo_mask])), __ldg(&tt[k * kCols + c]));
    } else {
      const unsigned long long p = static_cast<unsigned long long>(k) * (c0 + c);  // < N
      w = cmul(__ldg(&hi[p >> lo_bits]), __ldg(&lo[p & lo_mask]));
    }
    const float2 y = cmul(z[e], w);
    const long long g = static_cast<long long>(kSdRows * j + e) * m;
    qr[g] = y.x;
    qi[g] = y.y;
  });
}

// sdif_peel's launch plan (ops/cuda_probes.py: sdif_plan holds the same; the
// GPU tests compare through gdsp_sdif_geometry).  A CTA a (batch, tile):
// tiles along grid.x, the batch over row_grid's y and z.
struct SdPlan {
  int threads;       // threads a block
  int columns;       // columns a tile
  long long tiles;   // tiles a (128, m) plane: grid.x
  int smem;          // bytes of (static) shared memory a block: the exchange
};

int make_sdif_plan(long long m, long long batch, SdPlan* p) {
  if (m < 1 || batch < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (m + kCols - 1) / kCols;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  *p = SdPlan{kSdThreads, kCols, tiles, 2 * kPeel * kCols * static_cast<int>(sizeof(float))};
  return 0;
}

// vdif's launch plan (ops/cuda_probes.py: vdif_plan holds the same; the
// GPU tests compare through gdsp_vdif_geometry).
struct VdPlan {
  int threads;       // threads a block
  long long blocks;  // blocks of the grid: a warp a row
  int smem;          // bytes of dynamic shared memory a block
};

// b >= 0 rows of n1 slices.
int make_vdif_plan(long long b, int n1, VdPlan* p) {
  if (b < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long need = (b + kVdWarps - 1) / kVdWarps;
  const long long blocks = need < 1 ? 1 : need;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  *p = VdPlan{kVdThreads, blocks, vdif_smem(n1)};
  return 0;
}

template <int N1>
int launch_vdif(const float* xr, const float* xi, float* yr, float* yi, const float2* tab,
                long long b, const VdPlan& p, cudaStream_t s) {
  cudaError_t e = gdsp::allow_smem(vdif_kernel<N1>, p.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  vdif_kernel<N1><<<static_cast<unsigned>(p.blocks), kVdThreads, p.smem, s>>>(xr, xi, yr, yi,
                                                                               tab, b);
  return static_cast<int>(cudaGetLastError());
}

bool vdif_width(int n) { return n == 128 || n == 256 || n == 512 || n == 1024; }

}  // namespace

extern "C" {

// vdif's plan for b rows of n points: out[0..2] = threads a block, blocks,
// shared bytes a block (VdPlan).
int gdsp_vdif_geometry(long long b, int n, long long* out) {
  if (!vdif_width(n)) return static_cast<int>(cudaErrorInvalidValue);
  VdPlan p;
  const int rc = make_vdif_plan(b, n / kLanes, &p);
  if (rc != 0) return rc;
  out[0] = p.threads;
  out[1] = p.blocks;
  out[2] = p.smem;
  return 0;
}

// vdif of (b, n) float32 planes, n = N1 x 128 with N1 in 1, 2, 4, 8, every
// pointer 16-byte aligned; tab as vdif_sync_kernel's.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape the kernel does
// not take.
int gdsp_vdif(const float* xr, const float* xi, float* yr, float* yi, const float2* tab,
              long long b, int n, void* stream) {
  if (!vdif_width(n)) return static_cast<int>(cudaErrorInvalidValue);
  VdPlan p;
  const int rc = make_vdif_plan(b, n / kLanes, &p);
  if (rc != 0) return rc;
  if (b == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 128: return launch_vdif<1>(xr, xi, yr, yi, tab, b, p, s);
    case 256: return launch_vdif<2>(xr, xi, yr, yi, tab, b, p, s);
    case 512: return launch_vdif<4>(xr, xi, yr, yi, tab, b, p, s);
    default: return launch_vdif<8>(xr, xi, yr, yi, tab, b, p, s);
  }
}

// vdif's first design, the yardstick: the arguments as gdsp_vdif's.
int gdsp_vdif_sync(const float* xr, const float* xi, float* yr, float* yi, const float2* tab,
                   long long b, int n, void* stream) {
  if (b < 0 || !vdif_width(n)) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  const dim3 grid = gdsp::row_grid(1, (b + kVdifRows - 1) / kVdifRows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 128: vdif_sync_kernel<1><<<grid, kVdifThreads, 0, s>>>(xr, xi, yr, yi, tab, b); break;
    case 256: vdif_sync_kernel<2><<<grid, kVdifThreads, 0, s>>>(xr, xi, yr, yi, tab, b); break;
    case 512: vdif_sync_kernel<4><<<grid, kVdifThreads, 0, s>>>(xr, xi, yr, yi, tab, b); break;
    default: vdif_sync_kernel<8><<<grid, kVdifThreads, 0, s>>>(xr, xi, yr, yi, tab, b); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// The sdif peel of `batch` (128, m) float32 planes; cols, hi, lo and
// lo_bits as sdif_peel_kernel's (hi and lo: W_N, N = 128 m).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for m < 1 or batch < 0.
int gdsp_sdif_peel_sync(const float* xr, const float* xi, float* yr, float* yi,
                        const float2* cols, const float2* hi, const float2* lo, long long m,
                        long long batch, int lo_bits, void* stream) {
  if (m < 1 || batch < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const long long tiles = (m + kCols - 1) / kCols;
  sdif_peel_sync_kernel<<<gdsp::row_grid(static_cast<unsigned>(tiles), batch), kSdifThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(xr, xi, yr, yi, cols, hi, lo, m,
                                                               batch, lo_bits);
  return static_cast<int>(cudaGetLastError());
}

// sdif_peel's plan for `batch` (128, m) planes: out[0..3] = threads a
// block, columns a tile, tiles, shared bytes a block (SdPlan).
int gdsp_sdif_geometry(long long m, long long batch, long long* out) {
  SdPlan p;
  const int rc = make_sdif_plan(m, batch, &p);
  if (rc != 0) return rc;
  out[0] = p.threads;
  out[1] = p.columns;
  out[2] = p.tiles;
  out[3] = p.smem;
  return 0;
}

// The sdif peel of `batch` (128, m) float32 planes by the redesign; cols,
// hi, lo and lo_bits as sdif_peel_sync_kernel's, tt K8's tile table
// W_N^{k cc} at k kCols + cc (ops/cuda_outer.py: _tile_table(N, 128, 32)).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for m < 1, batch <
// 0 or more than 2^31 - 1 tiles.
int gdsp_sdif_peel(const float* xr, const float* xi, float* yr, float* yi, const float2* cols,
                   const float2* hi, const float2* lo, const float2* tt, long long m,
                   long long batch, int lo_bits, void* stream) {
  SdPlan p;
  const int rc = make_sdif_plan(m, batch, &p);
  if (rc != 0) return rc;
  if (batch == 0) return 0;
  sdif_peel_kernel<<<gdsp::row_grid(static_cast<unsigned>(p.tiles), batch), p.threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(xr, xi, yr, yi, cols, hi, lo, tt, m,
                                                          batch, lo_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
