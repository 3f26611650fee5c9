// The measurement path's two reference kernels for Hopper (sm_90a): K12
// and K13.  Both run only under the bench (godsp_tpu_torch/bench.py,
// utils/metrics.py), beside K1 at the same planes.
//
// K12 copy_split_kernel replaces godsp_tpu/utils/metrics.py:
// copy_split_pallas.  (yr, yi) = (xr, xi) for two float32 planes of
// b x n points: two planes read, two written, no compute, the same
// device-memory traffic as K1 (16 B a point).  Its time is the session's
// copy ceiling.  Bound on the H100: bytes, 16 B x b x n over 3.35 TB/s.
// Design: a grid-stride loop of 16-byte loads (read-only path, __ldg) and
// 16-byte stores over the float4 body of each plane, then a scalar tail
// for a point count that is not a multiple of 4.
//
// K13 gmm_floor_kernel replaces godsp_tpu/utils/metrics.py:
// gmm_floor_pallas.  For each row and each 128-point lane slice k1 of
// n = n1 x 128 points:
//
//   y[128 k1 + k2] = sum_{i2} x[128 k1 + i2] G[k1][i2, k2],
//   G[k1][i2, k2] = exp(-2 pi i k1 i2 / n) exp(-2 pi i i2 k2 / 128) / 128,
//
// the twiddled 128-point DFT of every slice: steps 2-3 of a four-step
// n1 x 128 FFT.  On the TPU this is K1's contraction stream (one
// Karatsuba triple of (rows, 128) @ (128, 128) MXU matmuls a slice) with
// the butterfly network removed, so its time there is the floor of K1's
// dense-DFT design.  On the H100, K1 (fft_kernels.cu) is register-radix
// Stockham passes and runs no such contraction: here the kernel's time
// says what the TPU's dense-DFT design of one K1 step costs on this card,
// beside K1's own design.
//
// Bound on the H100: the larger of 16 B a point over 3.35 TB/s and 768
// float32 operations a point (three real dot products of 128 terms, two
// operations a term) over 67 TFLOP/s; operations, at every n.  The
// arithmetic is fixed: per output m1 = Re x . Re G, m2 = Im x . Im G,
// m3 = (Re x + Im x) . (Re G + Im G), each from 0.f by fmaf over i2 = 0 ..
// 127 in order (Re x + Im x one float32 add), Re y = m1 - m2, Im y =
// (m3 - m1) - m2, on the CUDA cores (no TF32): so K13, gmm_concat, ls_full's
// contraction (lane_contract.cuh) and gmm_concat_stream agree bit for bit.
// The tables are built in float64 on the host and rounded once to float32
// (ops/cuda_metrics.py).
//
// Design (gmm_floor_kernel): the register tile sets how many floats a
// thread reads from shared memory for each FMA, and a 16-byte read costs a
// warp four wavefronts whatever its lanes share, so each thread holds 8 rows
// x 4 bins (96 accumulators) and, per four i2, reads 3 x 4 float4 of G and
// 8 x 2 float4 of x: 28 floats for 96 FMAs an i2 (a warp's lanes are 4 row
// groups x 8 bin groups; a G read is 128 contiguous bytes, each x read one
// float4 per row group on its own banks), and the three planes' FMAs run
// in turn so that four in a row share their x operand.  A CTA owns half a
// slice's bins, (k1, h): 64 bins, their three G planes resident (96 KB),
// and 8 warps in a 4 x 2 grid of 32-row x 32-bin warp tiles over 128-row
// tiles.  Each tile's x comes through a ring of four stages of 32 i2 (two
// 128-row x 32-column TMA boxes, xr and xi, in the 128-byte swizzle, so
// the four row groups' reads of one i2 quad land on distinct banks; rows
// past b read as 0), on full/empty mbarriers: thread 0 refills a slot as
// soon as every warp has released it, so the next loads overlap the
// contraction.  No warp is set apart to produce: eight warps leave each SM
// sub-partition two, so a thread may hold 255 registers (nine warps would
// cap it at 168, and the tile spilled there; 16 x 4 and 8 x 8 tiles spilled
// at 255 and were slower: PERF.md, section 6).  The
// grid is persistent, one CTA an SM by the occupancy query: CTA c walks the
// items c I / C .. (c + 1) I / C - 1 of the I = n1 x 2 x tiles items in
// slice-major order ((k1, h) major, row tile minor), so it loads G once for
// each (k1, h) its run touches (one or two at 16384 x 1024, two or three at
// 1024 x 16384), while the two halves of a tile run at the same time on
// CTAs C / (2 n1) apart and share x through L2.  The FMA loop then issues
// 384 FFMA, 32 FADD and 28 LDS.128 a warp for four i2, and the shared
// reads and the issue slots are about equally busy (PERF.md, section 6).
// gdsp_gmm_floor_geometry exports the plan (ops/cuda_metrics.py:
// gmm_floor_plan and gmm_floor_walk mirror it).
// gmm_floor_sync_kernel, the first design, kept as the yardstick: one block
// per (slice k1, group of rows) with all three planes of G[k1] (192 KB)
// staged, so one block of 256 threads an SM; the rows in tiles of 32 loaded
// synchronously between two barriers; a 4-row x 4-bin register tile (20
// floats read from shared memory for 48 FMAs).

#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_async.cuh"
#include "launch.cuh"

namespace hp = gdsp::hopper;

namespace {

constexpr int kLanes = 128;
constexpr int kPlane = kLanes * kLanes;  // one plane of G[k1]
constexpr int kRowTile = 32;             // gmm_floor_sync: rows of x staged a step
constexpr int kThreads = 256;            // gmm_floor_sync: 8 warps, 4 rows each, 32 lanes x 4 bins
constexpr int kGmmSmem = (3 * kPlane + 2 * kRowTile * kLanes) * sizeof(float);

// gmm_floor_kernel (the plan: FloorPlan below).
constexpr int kFlRows = 128;                     // rows of a tile
constexpr int kFlBins = 64;                      // bins a CTA: half a slice
constexpr int kFlK = 32;                         // i2 a stage: one 128-byte swizzled box row
constexpr int kFlStages = 4;                     // the ring of stages
constexpr int kFlThreads = 256;                  // 8 warps, a 4 x 2 grid of 32 x 32 warp tiles
constexpr int kFlPlane = kLanes * kFlBins * 4;   // bytes of one resident plane of G: 32 KB
constexpr int kFlBox = kFlRows * kFlK * 4;       // bytes of a box: 128 rows x 128 bytes
constexpr int kFlStage = 2 * kFlBox;             // xr and xi of a stage: 32 KB
constexpr int kFlSmem = kFlStages * kFlStage + 3 * kFlPlane + 2 * kFlStages * 8 + 1024;
constexpr int kFlPlanFields = 7;
static_assert(kFlSmem <= 232448, "within an SM's shared memory");

__global__ void copy_split_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                                  float* __restrict__ yr, float* __restrict__ yi, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long body = n / 4;
  const float4* ar = reinterpret_cast<const float4*>(xr);
  const float4* ai = reinterpret_cast<const float4*>(xi);
  float4* br = reinterpret_cast<float4*>(yr);
  float4* bi = reinterpret_cast<float4*>(yi);
  for (long long e = first; e < body; e += stride) {
    const float4 r = __ldg(ar + e);
    const float4 i = __ldg(ai + e);
    br[e] = r;
    bi[e] = i;
  }
  for (long long e = 4 * body + first; e < n; e += stride) {
    yr[e] = __ldg(xr + e);
    yi[e] = __ldg(xi + e);
  }
}

// g: (n1, 3, 128, 128) float32, plane p of slice k1 at g + (3 k1 + p) * kPlane,
// entry [i2][k2].  Block (k1, group) serves rows [group * rows_per_block,
// min(b, (group + 1) * rows_per_block)).
__global__ void __launch_bounds__(kThreads, 1)
gmm_floor_sync_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                 float* __restrict__ yr, float* __restrict__ yi, const float* __restrict__ g,
                 long long b, int n, long long rows_per_block) {
  extern __shared__ float4 smem4[];
  float* sg = reinterpret_cast<float*>(smem4);  // gr, gi, gs: 3 x 128 x 128
  float* sxr = sg + 3 * kPlane;                 // kRowTile x 128
  float* sxi = sxr + kRowTile * kLanes;
  const int k1 = blockIdx.x;
  const long long r0 = blockIdx.y * rows_per_block;
  const long long r1 = r0 + rows_per_block < b ? r0 + rows_per_block : b;
  if (r0 >= b) return;

  const float4* gsrc = reinterpret_cast<const float4*>(g + static_cast<size_t>(k1) * 3 * kPlane);
  for (int e = threadIdx.x; e < 3 * kPlane / 4; e += kThreads) smem4[e] = __ldg(gsrc + e);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t col0 = static_cast<size_t>(k1) * kLanes;
  for (long long t0 = r0; t0 < r1; t0 += kRowTile) {
    const int rows = static_cast<int>(r1 - t0 < kRowTile ? r1 - t0 : kRowTile);
    __syncthreads();  // the previous tile's reads are done (and G is staged)
    for (int e = threadIdx.x; e < kRowTile * kLanes / 4; e += kThreads) {
      const int r = e / (kLanes / 4), c4 = e % (kLanes / 4);
      float4 vr = make_float4(0.f, 0.f, 0.f, 0.f), vi = vr;
      if (r < rows) {
        const size_t off = static_cast<size_t>(t0 + r) * n + col0;
        vr = __ldg(reinterpret_cast<const float4*>(xr + off) + c4);
        vi = __ldg(reinterpret_cast<const float4*>(xi + off) + c4);
      }
      reinterpret_cast<float4*>(sxr)[e] = vr;
      reinterpret_cast<float4*>(sxi)[e] = vi;
    }
    __syncthreads();

    float m1[4][4], m2[4][4], m3[4][4];  // [row warp + 8 j][bin lane + 32 q]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) m1[j][q] = m2[j][q] = m3[j][q] = 0.f;
    }
#pragma unroll 4
    for (int i2 = 0; i2 < kLanes; ++i2) {
      float ar[4], ai[4], as[4], gr[4], gi[4], gs[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ar[j] = sxr[(warp + 8 * j) * kLanes + i2];
        ai[j] = sxi[(warp + 8 * j) * kLanes + i2];
        as[j] = ar[j] + ai[j];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = i2 * kLanes + lane + 32 * q;
        gr[q] = sg[k];
        gi[q] = sg[kPlane + k];
        gs[q] = sg[2 * kPlane + k];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          m1[j][q] = fmaf(ar[j], gr[q], m1[j][q]);
          m2[j][q] = fmaf(ai[j], gi[q], m2[j][q]);
          m3[j][q] = fmaf(as[j], gs[q], m3[j][q]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = warp + 8 * j;
      if (r >= rows) continue;
      const size_t row = static_cast<size_t>(t0 + r) * n + col0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k2 = lane + 32 * q;
        yr[row + k2] = m1[j][q] - m2[j][q];
        yi[row + k2] = m3[j][q] - m1[j][q] - m2[j][q];
      }
    }
  }
}


// K13's plan (ops/cuda_metrics.py: FloorPlan holds the same fields in this
// order).
struct FloorPlan {
  int ctas;       // CTAs of the persistent grid: min(resident, items)
  int rows_tile;  // rows of a tile
  int bins_cta;   // bins a CTA: half a slice
  int stages;     // the ring of x stages
  int smem;       // bytes of dynamic shared memory a CTA
  int items;      // (k1, h, row tile) items: n1 x 2 x tiles
  int threads;    // threads a CTA: 8 warps, thread 0 also keeping the ring full
};

// b >= 0, n a multiple of 128; resident the CTAs the card holds at once.
int make_floor_plan(long long b, int n, int resident, FloorPlan* p) {
  if (b < 0 || n < kLanes || n % kLanes != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (resident < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const long long items = (b + kFlRows - 1) / kFlRows * 2 * (n / kLanes);
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  *p = FloorPlan{static_cast<int>(items < resident ? items : resident), kFlRows, kFlBins,
                 kFlStages, kFlSmem, static_cast<int>(items), kFlThreads};
  return 0;
}

// The TMA copies of the CTA's stage c (item first + c / 4, its 32 i2 of
// chunk c % 4) into ring slot c % kFlStages; one thread.
__device__ __forceinline__ void floor_issue(const CUtensorMap* txr, const CUtensorMap* txi,
                                            char* stages, uint64_t* full, long long first,
                                            long long tiles, long long c) {
  const long long it = first + c / (kLanes / kFlK);
  const int ch = static_cast<int>(c % (kLanes / kFlK)), s = static_cast<int>(c % kFlStages);
  const int col = (static_cast<int>(it / tiles) >> 1) * kLanes + ch * kFlK;
  const int row = static_cast<int>(it % tiles) * kFlRows;
  hp::mbar_arrive_expect_tx(full + s, kFlStage);
  hp::tma_load_2d(stages + s * kFlStage, txr, col, row, full + s);
  hp::tma_load_2d(stages + s * kFlStage + kFlBox, txi, col, row, full + s);
}

// txr, txi: tensor maps of the (b, n) input planes, boxes of 32 columns x
// 128 rows in the 128-byte swizzle; g: (n1, 3, 128, 128) float32 tables;
// items: n1 x 2 x tiles.  CTA c takes items c items / C .. (c + 1) items /
// C - 1, item i being (pair i / tiles, tile i % tiles), pair = 2 k1 + h:
// bins 64 h .. of slice k1.  Warp w takes rows 32 (w / 2) .. of a tile and
// bins 32 (w % 2) .. of the CTA's 64; lane = 8 rg + bg holds rows
// 32 (w / 2) + rg + 4 j (j < 8) and bins 32 (w % 2) + 4 bg .. + 3.  Thread
// 0 also keeps the ring full: it issues the first kFlStages stages, and
// before its warp consumes stage c, refills the slot of stage c - 1 with
// stage c - 1 + kFlStages once every warp has released it.
__global__ void __launch_bounds__(kFlThreads, 1)
gmm_floor_kernel(const __grid_constant__ CUtensorMap txr, const __grid_constant__ CUtensorMap txi,
                 float* __restrict__ yr, float* __restrict__ yi, const float* __restrict__ g,
                 long long b, int n, int items) {
  extern __shared__ float4 smem4[];
  // The ring's boxes start on 1024-byte boundaries (the swizzle's atoms).
  // The offset is added to smem4 itself, so the compiler still sees shared
  // memory and reads it with LDS, not generic loads.
  char* base = reinterpret_cast<char*>(smem4) + ((1024 - (hp::smem_addr(smem4) & 1023)) & 1023);
  char* stages = base;                                  // [stage][xr, xi][rows][128 bytes]
  float* sg = reinterpret_cast<float*>(base + kFlStages * kFlStage);  // [plane][i2][64 bins]
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kFlStages * kFlStage + 3 * kFlPlane);
  uint64_t* empty = full + kFlStages;
  const long long tiles = (b + kFlRows - 1) / kFlRows;
  const long long first = static_cast<long long>(blockIdx.x) * items / gridDim.x;
  const long long last = static_cast<long long>(blockIdx.x + 1) * items / gridDim.x;
  const long long total = (last - first) * (kLanes / kFlK);  // the CTA's stages

  if (threadIdx.x == 0) {
    for (int s = 0; s < kFlStages; ++s) {
      hp::mbar_init(full + s, 1);                  // thread 0's arrive.expect_tx
      hp::mbar_init(empty + s, kFlThreads / 32);  // every warp
    }
    hp::mbar_init_fence();
  }
  __syncthreads();  // the barriers exist before any copy or arrival
  if (threadIdx.x == 0) {
    for (long long c = 0; c < total && c < kFlStages; ++c)
      floor_issue(&txr, &txi, stages, full, first, tiles, c);
  }

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int rg = lane >> 3, bg = lane & 7;
  const int rbase = 32 * (w >> 1) + rg;        // rows rbase + 4 j of a tile
  const int bin = 32 * (w & 1) + 4 * bg;       // the CTA's bins bin .. bin + 3
  long long loaded = -1;                       // the pair whose G is resident
  long long c = 0;                             // stages consumed
  for (long long it = first; it < last; ++it) {
    const long long pair = it / tiles;
    const int k1 = static_cast<int>(pair >> 1), h = static_cast<int>(pair & 1);
    if (pair != loaded) {
      // G's bins 64 h .. of slice k1: three planes of [i2][64 bins], once
      // every warp is done with the last pair's.
      if (loaded >= 0) __syncthreads();
      const float* gk = g + static_cast<size_t>(k1) * 3 * kPlane + kFlBins * h;
#pragma unroll 4
      for (int e = threadIdx.x; e < 3 * kLanes * kFlBins / 4; e += kFlThreads) {
        const int pl = e / (kLanes * kFlBins / 4), i2 = (e / (kFlBins / 4)) % kLanes;
        const int q4 = e % (kFlBins / 4);
        reinterpret_cast<float4*>(sg)[e] =
            __ldg(reinterpret_cast<const float4*>(gk + pl * kPlane + i2 * kLanes) + q4);
      }
      __syncthreads();
      loaded = pair;
    }

    float m1[8][4], m2[8][4], m3[8][4];  // [row rbase + 4 j][bin + q]
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) m1[j][q] = m2[j][q] = m3[j][q] = 0.f;
    }
    for (int ch = 0; ch < kLanes / kFlK; ++ch, ++c) {
      const int s = static_cast<int>(c % kFlStages);
      if (threadIdx.x == 0 && c >= 1 && c - 1 + kFlStages < total) {
        hp::mbar_wait(empty + (c - 1) % kFlStages, static_cast<uint32_t>((c - 1) / kFlStages) & 1u);
        floor_issue(&txr, &txi, stages, full, first, tiles, c - 1 + kFlStages);
      }
      hp::mbar_wait(full + s, static_cast<uint32_t>(c / kFlStages) & 1u);
      // Row rbase + 4 j of the stage's boxes (128 bytes a row): its 16-byte
      // unit u sits at unit u ^ (row % 8) = u ^ rg ^ 4 (j % 2).
      const char* xr_rows = stages + s * kFlStage + rbase * 128;
      const char* xi_rows = xr_rows + kFlBox;
#pragma unroll 1
      for (int u = 0; u < kFlK / 4; ++u) {
        const int unit = (u ^ rg) << 4;
        // G at i2 = 32 ch + 4 u + e, e < 4: three planes, four bins each;
        // then each row's four i2 as one float4 a plane.
        float4 gr[4], gi[4], gs[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* at = sg + (ch * kFlK + 4 * u + e) * kFlBins + bin;
          gr[e] = *reinterpret_cast<const float4*>(at);
          gi[e] = *reinterpret_cast<const float4*>(at + kLanes * kFlBins);
          gs[e] = *reinterpret_cast<const float4*>(at + 2 * kLanes * kFlBins);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int off = 4 * 128 * j + (unit ^ (64 * (j & 1)));
          const float4 vr = *reinterpret_cast<const float4*>(xr_rows + off);
          const float4 vi = *reinterpret_cast<const float4*>(xi_rows + off);
          const float ar[4] = {vr.x, vr.y, vr.z, vr.w};
          const float ai[4] = {vi.x, vi.y, vi.z, vi.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float as = __fadd_rn(ar[e], ai[e]);
            const float gre[4] = {gr[e].x, gr[e].y, gr[e].z, gr[e].w};
            const float gie[4] = {gi[e].x, gi[e].y, gi[e].z, gi[e].w};
            const float gse[4] = {gs[e].x, gs[e].y, gs[e].z, gs[e].w};
            // A plane at a time: four FMAs in a row share their x operand.
#pragma unroll
            for (int q = 0; q < 4; ++q) m1[j][q] = fmaf(ar[e], gre[q], m1[j][q]);
#pragma unroll
            for (int q = 0; q < 4; ++q) m2[j][q] = fmaf(ai[e], gie[q], m2[j][q]);
#pragma unroll
            for (int q = 0; q < 4; ++q) m3[j][q] = fmaf(as, gse[q], m3[j][q]);
          }
        }
      }
      // The stage's reads are done: release its slot.
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(empty + s);
    }
    const long long row0 = (it % tiles) * kFlRows;
    const size_t col = static_cast<size_t>(k1) * kLanes + kFlBins * h + bin;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long row = row0 + rbase + 4 * j;
      if (row >= b) continue;
      const size_t at = static_cast<size_t>(row) * n + col;
      *reinterpret_cast<float4*>(yr + at) =
          make_float4(__fsub_rn(m1[j][0], m2[j][0]), __fsub_rn(m1[j][1], m2[j][1]),
                      __fsub_rn(m1[j][2], m2[j][2]), __fsub_rn(m1[j][3], m2[j][3]));
      *reinterpret_cast<float4*>(yi + at) =
          make_float4(__fsub_rn(__fsub_rn(m3[j][0], m1[j][0]), m2[j][0]),
                      __fsub_rn(__fsub_rn(m3[j][1], m1[j][1]), m2[j][1]),
                      __fsub_rn(__fsub_rn(m3[j][2], m1[j][2]), m2[j][2]),
                      __fsub_rn(__fsub_rn(m3[j][3], m1[j][3]), m2[j][3]));
    }
  }
}

}  // namespace

extern "C" {

// K12: (yr, yi) = (xr, xi), n points a plane, every pointer 16-byte
// aligned.  Returns cudaGetLastError().
int gdsp_copy_split(const float* xr, const float* xi, float* yr, float* yi, long long n,
                    void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const long long units = (n + 3) / 4;
  long long grid = (units + threads - 1) / threads;
  if (grid > 16 * 132) grid = 16 * 132;
  copy_split_kernel<<<static_cast<unsigned>(grid), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      xr, xi, yr, yi, n);
  return static_cast<int>(cudaGetLastError());
}

// K13: (b, n) float32 planes, n % 128 == 0, every pointer 16-byte aligned;
// g: the (n / 128, 3, 128, 128) tables; resident: the CTAs of
// gmm_floor_kernel the card holds at once (gdsp_gmm_floor_resident).
// Returns cudaGetLastError(), cudaErrorInvalidValue for a shape the kernel
// does not take, or cudaErrorLaunchOutOfResources where resident < 1.
int gdsp_gmm_floor(const float* xr, const float* xi, float* yr, float* yi, const float* g,
                   long long b, int n, int resident, void* stream) {
  FloorPlan p;
  const int rc = make_floor_plan(b, n, resident, &p);
  if (rc != 0) return rc;
  if (b == 0) return 0;
  CUtensorMap maps[2];
  const float* planes[2] = {xr, xi};
  for (int i = 0; i < 2; ++i) {
    const int e = hp::encode_tensor_map_2d(maps + i, planes[i], b, n, kFlK, kFlRows);
    if (e != 0) return e;
  }
  cudaError_t e = gdsp::allow_smem(gmm_floor_kernel, static_cast<size_t>(p.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  gmm_floor_kernel<<<static_cast<unsigned>(p.ctas), p.threads, static_cast<size_t>(p.smem),
                     static_cast<cudaStream_t>(stream)>>>(maps[0], maps[1], yr, yi, g, b, n,
                                                          p.items);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of gmm_floor_kernel the card holds at once with the plan's shared
// memory plus extra_smem bytes a CTA (the CTAs resident an SM times the
// SMs): 0 where none fits, or -(CUDA error).
int gdsp_gmm_floor_resident(int extra_smem) {
  const int smem = kFlSmem + extra_smem;
  int device = 0, sms = 0, blocks = 0;
  cudaError_t e = gdsp::allow_smem(gmm_floor_kernel, static_cast<size_t>(smem));
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gmm_floor_kernel, kFlThreads, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();  // reported here, not by the next launch's check
    return -static_cast<int>(e);
  }
  return blocks * sms;
}

// K13's plan at b x n with `resident` CTAs: out[0..6] = CTAs, rows a tile,
// bins a CTA, stages, shared bytes, items, threads (FloorPlan).
// ops/cuda_metrics.py: gmm_floor_plan holds the same; the GPU tests and
// phase 3 compare.
int gdsp_gmm_floor_geometry(long long b, int n, int resident, int* out) {
  FloorPlan p;
  const int rc = make_floor_plan(b, n, resident, &p);
  if (rc != 0) return rc;
  const int v[kFlPlanFields] = {p.ctas, p.rows_tile, p.bins_cta, p.stages,
                                p.smem, p.items,     p.threads};
  for (int i = 0; i < kFlPlanFields; ++i) out[i] = v[i];
  return 0;
}

// K13's first design, the yardstick: (b, n) float32 planes, n % 128 == 0,
// every pointer 16-byte aligned; g the tables.  groups: row groups per
// slice (grid.y, <= 65535).  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape the kernel does not take.
int gdsp_gmm_floor_sync(const float* xr, const float* xi, float* yr, float* yi, const float* g,
                        long long b, int n, int groups, void* stream) {
  if (n < kLanes || n % kLanes != 0 || groups < 1 || groups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0) return 0;
  cudaError_t e = gdsp::allow_smem(gmm_floor_sync_kernel, kGmmSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  long long per = (b + groups - 1) / groups;
  per = (per + kRowTile - 1) / kRowTile * kRowTile;
  const dim3 grid(n / kLanes, static_cast<unsigned>((b + per - 1) / per));
  gmm_floor_sync_kernel<<<grid, kThreads, kGmmSmem, static_cast<cudaStream_t>(stream)>>>(
      xr, xi, yr, yi, g, b, n, per);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
