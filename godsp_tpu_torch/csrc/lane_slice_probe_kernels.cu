// K14e and K14f: the twins for Hopper (sm_90a) of tools/probe_r4.py's
// lane flip and of tools/probe_r3.py's run_variant (:140, one
// pl.pallas_call at :157 over thirteen bodies), which takes the TPU's K1
// (pallas_fft._fft_kernel_ls) apart.  They run under
// godsp_tpu_torch/probes/r4.py and probes/r3.py.  No library kernel is
// called.  The lane-slice twins take two float32 planes (b, n), n = n1 x
// 128 with n1 in 1, 2, 4, 8, contiguous and 16-byte aligned, and write two
// new planes of the same shape.  Bounds below are at 16384 x 1024 on the
// H100 (3.35 TB/s, 67 TFLOP/s float32, 495 TFLOP/s TF32).
//
// ls_network_kernel<N1> replaces k_step1_only (:218): the N1-point DFT
// across a row's slices (slice_network.cuh: pallas_fft._dft_slices, slices
// in bit-reversed order, natural k1 out), output slice k1 at columns
// [128 k1, 128 k1 + 128).  Design: one warp owns a row, as vdif_kernel
// does; lane l holds points p = l + 32 q of every slice, loaded and stored
// 32 consecutive floats a (slice, q).  Bound: bytes, 268 MB, 0.080 ms (~15
// float32 operations a point at N1 = 8: 0.004 ms).
//
// gmm_tf32_kernel replaces k_gmm_default (:259): K13's Karatsuba
// contraction of every slice (m1 = a G_r, m2 = b G_i, m3 = (a + b) G_s,
// yr = m1 - m2, yi = m3 - m1 - m2, G = K13's tables) with each product in
// ONE TF32 pass on the tensor cores, the card's counterpart of the TPU's
// one-bf16-pass DEFAULT matmul.  A block owns one slice k1 and a group of
// rows: it stages G[k1]'s three planes once, rounded by cvt.rna.tf32.f32,
// 128 rows 136 words apart (204 KB: a B fragment's 32 reads fall in 32
// banks), then its warps walk 16-row tiles, 64 output columns at a time.
// A comes from device memory, a, b and a + b (an IEEE float32 add) each
// rounded by cvt.rna.  Each k-step's product is summed on the tensor cores
// from zero and added to the running sum on the CUDA cores in IEEE
// float32: the tensor cores' own accumulation of chained mma truncates.
// Bound: bytes, 0.080 ms (768 TF32 operations a point: 0.026 ms).  It
// changes no TF32 or matmul flag; nothing at the 120 dB bar uses it.
//
// ls_full_kernel<N1> replaces k_full (:239, pallas_fft._fft_kernel_ls at
// n1 = 8: the TPU's K1 in digit order), k_full_concat (:245),
// make_subtiled(2/4/8) (:279) and k_full at bt = 512 and 1024 (:318-319):
// the n-point DFT of every row, position 128 k1 + k2 holding bin
// k1 + N1 k2 (pallas_fft._digit_to_natural's digit order).  It runs on a
// thread-block cluster of N1 CTAs, CTA k1 keeping G[k1] resident (unscaled:
// K13's tables times 128, exactly pallas_fft._ls_tables' G) and
// contracting its slice with lane_contract.cuh's routine.  The slice
// network needs every slice of a point, so it runs as an all-to-all, as
// K9's column step does: CTA c's points c P .. c P + P - 1 (P = 128 / N1) of
// every slice of a 16-row tile arrive by cp.async in a staging buffer
// while the last tile is contracted; a thread a (row, point) runs
// slice_network.cuh's slice_dft (the same code as ls_network_kernel, so
// the same bits) and stores output slice k1 into CTA k1's tile buffer
// over distributed shared memory; a cluster barrier; then the
// contraction.  Launch parameters pick the TPU body:
//   store_rows 0 (k_full): each CTA stores its 512-byte run of each row
//     as its contraction ends; 1 (k_full_concat): the outputs overwrite
//     the inputs and, after a cluster barrier, each CTA stores its share
//     of the tile's rows as whole rows gathered from every CTA's buffer;
//   chunk_rows 16, 8, 4, 2 (make_subtiled(1, 2, 4, 8)): network then
//     contraction on that many rows of the tile at a time, a cluster
//     barrier between chunks;
//   rows_per_block 16, 32, 64: the rows a cluster takes as one unit of
//     work, the TPU's bt 256, 512, 1024 mapped x1, x2, x4 (a cluster walks
//     units cl, cl + clusters, ...).
// ls_full_stream_kernel<N1> is the first design, kept as the yardstick: a
// block owns rows_per_block rows walked in 16-row tiles, the tile of both
// planes waits in shared memory (128 KB at n = 1024), the network runs
// there, then the contraction with G streamed through shared memory 32
// rows of i2 at a time (48 KB, again every tile and chunk), with the same
// store, chunk and rows-a-block parameters.
// Every output is the same fmaf chain over i2 = 0..127 (then the same
// subtractions) whatever thread computes it, and the network the same
// code for every setting, so every setting of both kernels equals the
// default's bit for bit.  Bound: bytes, 268 MB, 0.080 ms: the function is
// the n-point DFT, 5 log2 n = 50 float32 operations a point (0.013 ms).
// The method does 768 + 15 a point, 1.31e10 at 16384 x 1024: 0.196 ms at
// 67 TFLOP/s, the floor of this method, not of the function.
//
// lane_flip_kernel replaces tools/probe_r4.py:67 (kf :61): y[r, 127 - c] =
// 2 x[r, c] over a (rows, 128) float32 view, exactly.  One warp a row: lane
// l loads x[r, 4 l .. 4 l + 3] (16 bytes), takes lane 31 - l's four by
// __shfl_xor_sync(.., 31), reverses them in registers, doubles them and
// stores them at 4 l.  Bound: bytes, one plane read and written, 134 MB,
// 0.040 ms.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "fft_block.cuh"
#include "lane_contract.cuh"
#include "mma_tf32.cuh"
#include "slice_network.cuh"

namespace cg = cooperative_groups;
namespace ln = gdsp::lane;

namespace {

constexpr int kLanes = 128;
constexpr int kQ = kLanes / 32;  // points of a slice a lane holds: p = lane + 32 q
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPlane = kLanes * kLanes;  // one plane of G[k1]
constexpr int kFS = 136;                 // words a staged row of G in gmm_tf32
constexpr int kTf32Smem = 3 * kLanes * kFS * sizeof(uint32_t);
constexpr int kTile = 16;   // rows of an ls_full tile
constexpr int kSteps = 32;  // rows i2 of G[k1] staged a step: 3 planes, 48 KB
constexpr int kMaxPer = kTile * kLanes / kThreads;  // outputs a thread a slice

// ---------------------------------------------------------------------------
// ls_network
// ---------------------------------------------------------------------------

template <int N1>
__global__ void __launch_bounds__(kThreads)
ls_network_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                  float* __restrict__ yr, float* __restrict__ yi, long long b) {
  constexpr int kBits = gdsp::log2_small(N1);
  constexpr int n = N1 * kLanes;
  const long long row = gdsp::block_row() * kWarps + (threadIdx.x >> 5);
  if (row >= b) return;
  const size_t base = static_cast<size_t>(row) * n + (threadIdx.x & 31);
  float2 z[N1][kQ];
#pragma unroll
  for (int j1 = 0; j1 < N1; ++j1) {
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const size_t g = base + j1 * kLanes + 32 * q;
      z[gdsp::rev_bits(j1, kBits)][q] = make_float2(__ldg(xr + g), __ldg(xi + g));
    }
  }
  gdsp::slice_dft(z);
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
// gmm_tf32
// ---------------------------------------------------------------------------

// g: K13's (n1, 3, 128, 128) tables (any such tables: the fragment-map
// checks pass permutations).  Block (k1, group) serves rows
// [group * rows_per_block, min(b, (group + 1) * rows_per_block)).
__global__ void __launch_bounds__(kThreads, 1)
gmm_tf32_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                float* __restrict__ yr, float* __restrict__ yi, const float* __restrict__ g,
                long long b, int n, long long rows_per_block) {
  extern __shared__ float4 smem4[];
  uint32_t* sg = reinterpret_cast<uint32_t*>(smem4);  // gr, gi, gs: 3 x 128 rows x kFS
  const int k1 = blockIdx.x;
  const long long r0 = blockIdx.y * rows_per_block;
  if (r0 >= b) return;
  const long long r1 = r0 + rows_per_block < b ? r0 + rows_per_block : b;
  const float* gk = g + static_cast<size_t>(k1) * 3 * kPlane;
  for (int e = threadIdx.x; e < 3 * kPlane; e += kThreads)
    sg[(e / kLanes) * kFS + e % kLanes] = gdsp::tf32(__ldg(gk + e));
  __syncthreads();

  const int gq = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const uint32_t* sgr = sg;
  const uint32_t* sgi = sg + kLanes * kFS;
  const uint32_t* sgs = sg + 2 * kLanes * kFS;
  for (long long t0 = r0 + 16 * (threadIdx.x >> 5); t0 < r1; t0 += 16 * kWarps) {
    const int rows = r1 - t0 < 16 ? static_cast<int>(r1 - t0) : 16;
    const size_t base = static_cast<size_t>(t0) * n + k1 * kLanes;
    for (int half = 0; half < 2; ++half) {
      float m1[8][4], m2[8][4], m3[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int q = 0; q < 4; ++q) m1[nt][q] = m2[nt][q] = m3[nt][q] = 0.f;
      }
      for (int ks = 0; ks < 16; ++ks) {
        float va[4], vb[4];
        gdsp::a_values(va, xr + base, n, rows, 8 * ks);
        gdsp::a_values(vb, xi + base, n, rows, 8 * ks);
        uint32_t ua[4], ub[4], us[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ua[q] = gdsp::tf32(va[q]);
          ub[q] = gdsp::tf32(vb[q]);
          us[q] = gdsp::tf32(va[q] + vb[q]);
        }
        const int at0 = (8 * ks + t) * kFS + 64 * half + gq, at1 = at0 + 4 * kFS;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int c0 = at0 + 8 * nt, c1 = at1 + 8 * nt;
          float p1[4] = {0.f, 0.f, 0.f, 0.f}, p2[4] = {0.f, 0.f, 0.f, 0.f},
                p3[4] = {0.f, 0.f, 0.f, 0.f};
          gdsp::mma_tf32(p1, ua, sgr[c0], sgr[c1]);
          gdsp::mma_tf32(p2, ub, sgi[c0], sgi[c1]);
          gdsp::mma_tf32(p3, us, sgs[c0], sgs[c1]);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            m1[nt][q] += p1[q];
            m2[nt][q] += p2[q];
            m3[nt][q] += p3[q];
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = 64 * half + 8 * nt + 2 * t;
        float r[4], i[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          r[q] = m1[nt][q] - m2[nt][q];
          i[q] = m3[nt][q] - m1[nt][q] - m2[nt][q];
        }
        gdsp::store_c(yr + base, n, rows, col, r[0], r[1], r[2], r[3]);
        gdsp::store_c(yi + base, n, rows, col, i[0], i[1], i[2], i[3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// ls_full's first design (the yardstick)
// ---------------------------------------------------------------------------

// g: (N1, 3, 128, 128) unscaled tables, plane p of slice k1 at
// g + (3 k1 + p) * kPlane, entry [i2][k2].  Block r serves rows
// [r * rows_per_block, min(b, (r + 1) * rows_per_block)); rows_per_block is
// a multiple of kTile, chunk_rows divides kTile and is even.
template <int N1>
__global__ void __launch_bounds__(kThreads, 1)
ls_full_stream_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
               float* __restrict__ yr, float* __restrict__ yi, const float* __restrict__ g,
               long long b, int rows_per_block, int chunk_rows, int store_rows) {
  constexpr int kBits = gdsp::log2_small(N1);
  constexpr int n = N1 * kLanes;
  constexpr int quads = n / 4;
  extern __shared__ float4 smem4[];
  float* sxr = reinterpret_cast<float*>(smem4);  // kTile x n: inputs, then outputs
  float* sxi = sxr + kTile * n;
  float* sg = sxi + kTile * n;  // 3 planes x kSteps rows of G[k1]
  const long long r_begin = gdsp::block_row() * rows_per_block;
  if (r_begin >= b) return;
  const long long r_end = r_begin + rows_per_block < b ? r_begin + rows_per_block : b;
  const int per = chunk_rows * kLanes / kThreads;  // outputs a thread a slice
  const int bin = threadIdx.x & (kLanes - 1), r_off = threadIdx.x / kLanes;

  for (long long t0 = r_begin; t0 < r_end; t0 += kTile) {
    const int rows = r_end - t0 < kTile ? static_cast<int>(r_end - t0) : kTile;
    __syncthreads();  // the previous tile's stores have read shared memory
    for (int e = threadIdx.x; e < kTile * quads; e += kThreads) {
      const int rr = e / quads, c = 4 * (e % quads);
      float4 vr = make_float4(0.f, 0.f, 0.f, 0.f), vi = vr;
      if (rr < rows) {
        const size_t off = static_cast<size_t>(t0 + rr) * n + c;
        vr = __ldg(reinterpret_cast<const float4*>(xr + off));
        vi = __ldg(reinterpret_cast<const float4*>(xi + off));
      }
      *reinterpret_cast<float4*>(sxr + rr * n + c) = vr;
      *reinterpret_cast<float4*>(sxi + rr * n + c) = vi;
    }
    __syncthreads();

    for (int c0 = 0; c0 < kTile; c0 += chunk_rows) {
      // The slice network over the chunk, a thread a (row, point p).
      for (int e = threadIdx.x; e < chunk_rows * kLanes; e += kThreads) {
        const int at = (c0 + e / kLanes) * n + e % kLanes;
        float2 z[N1][1];
#pragma unroll
        for (int j1 = 0; j1 < N1; ++j1) {
          const int a = at + j1 * kLanes;
          z[gdsp::rev_bits(j1, kBits)][0] = make_float2(sxr[a], sxi[a]);
        }
        gdsp::slice_dft(z);
#pragma unroll
        for (int k1 = 0; k1 < N1; ++k1) {
          sxr[at + k1 * kLanes] = z[k1][0].x;
          sxi[at + k1 * kLanes] = z[k1][0].y;
        }
      }
      // K13's contraction of each slice; this thread's outputs are rows
      // c0 + r_off + 2 u, u < per, at bin `bin`.
      for (int k1 = 0; k1 < N1; ++k1) {
        const float* gk = g + static_cast<size_t>(k1) * 3 * kPlane;
        float m1[kMaxPer], m2[kMaxPer], m3[kMaxPer];
#pragma unroll
        for (int u = 0; u < kMaxPer; ++u) m1[u] = m2[u] = m3[u] = 0.f;
        for (int i0 = 0; i0 < kLanes; i0 += kSteps) {
          __syncthreads();  // the last step's G is read (and the network is done)
          for (int e = threadIdx.x; e < 3 * kSteps * kLanes / 4; e += kThreads) {
            const int p = e / (kSteps * kLanes / 4), r = e % (kSteps * kLanes / 4);
            reinterpret_cast<float4*>(sg)[e] =
                __ldg(reinterpret_cast<const float4*>(gk + p * kPlane + i0 * kLanes) + r);
          }
          __syncthreads();
#pragma unroll 4
          for (int ii = 0; ii < kSteps; ++ii) {
            const int i2 = i0 + ii;
            const float gr = sg[ii * kLanes + bin];
            const float gi = sg[(kSteps + ii) * kLanes + bin];
            const float gs = sg[(2 * kSteps + ii) * kLanes + bin];
#pragma unroll
            for (int u = 0; u < kMaxPer; ++u) {
              if (u < per) {
                const int at = (c0 + r_off + 2 * u) * n + k1 * kLanes + i2;
                const float ar = sxr[at], ai = sxi[at];
                const float as = ar + ai;
                m1[u] = fmaf(ar, gr, m1[u]);
                m2[u] = fmaf(ai, gi, m2[u]);
                m3[u] = fmaf(as, gs, m3[u]);
              }
            }
          }
        }
        if (store_rows) __syncthreads();  // every thread has read slice k1 of the chunk
#pragma unroll
        for (int u = 0; u < kMaxPer; ++u) {
          if (u >= per) continue;
          const int r = c0 + r_off + 2 * u;
          const float vr = m1[u] - m2[u];
          const float vi = m3[u] - m1[u] - m2[u];
          if (store_rows) {
            sxr[r * n + k1 * kLanes + bin] = vr;
            sxi[r * n + k1 * kLanes + bin] = vi;
          } else if (r < rows) {
            const size_t off = static_cast<size_t>(t0 + r) * n + k1 * kLanes + bin;
            yr[off] = vr;
            yi[off] = vi;
          }
        }
      }
    }
    if (store_rows) {
      __syncthreads();
      for (int e = threadIdx.x; e < kTile * quads; e += kThreads) {
        const int rr = e / quads, c = 4 * (e % quads);
        if (rr >= rows) continue;
        const size_t off = static_cast<size_t>(t0 + rr) * n + c;
        *reinterpret_cast<float4*>(yr + off) = *reinterpret_cast<const float4*>(sxr + rr * n + c);
        *reinterpret_cast<float4*>(yi + off) = *reinterpret_cast<const float4*>(sxi + rr * n + c);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// ls_full on a thread-block cluster
// ---------------------------------------------------------------------------

// CTA `rank`'s points p = rank P .. rank P + P - 1 (P = 128 / N1) of every
// slice of tile `tile`'s rows into ss (two planes at ln::kPitch, row r's
// slice j1 at words j1 P ..) by cp.async, rows past b zero: 8 copies of 16
// bytes a thread at every N1.  The caller commits.
template <int N1>
__device__ __forceinline__ void load_points(float* ss, const float* __restrict__ xr,
                                            const float* __restrict__ xi, long long b,
                                            long long tile, int rank) {
  constexpr int n = N1 * ln::kLanes;
  constexpr int P = ln::kLanes / N1;
  constexpr int kQuads = ln::kLanes / 4;  // 16-byte words a staged row
  for (int e = threadIdx.x; e < 2 * ln::kTileRows * kQuads; e += ln::kThreads) {
    const int plane = e / (ln::kTileRows * kQuads);
    const int r = (e / kQuads) % ln::kTileRows, w = e % kQuads;
    const int col = (4 * w / P) * ln::kLanes + rank * P + 4 * w % P;  // slice j1 = 4 w / P
    const long long row = tile * ln::kTileRows + r;
    const bool valid = row < b;
    const float* src = (plane ? xi : xr) + (valid ? static_cast<size_t>(row) * n + col : 0);
    ln::cp_async16(ss + plane * ln::kTileWords + r * ln::kPitch + 4 * w, src, valid);
  }
}

// g: (N1, 3, 128, 128) unscaled tables.  A cluster of N1 CTAs takes units
// of tiles_unit 16-row tiles (cluster cl: units cl, cl + clusters, ...);
// CTA `rank` holds G[rank] for its whole life.  A tile: CTA c's points
// p in [c P, c P + P) of every slice arrive in ss by cp.async (during the
// last tile's contraction); then, chunk_rows rows at a time, a thread a
// (row, point) runs slice_network.cuh's slice_dft as ls_network_kernel
// does and stores output slice k1 into CTA k1's buffer sx over distributed
// shared memory (an all-to-all, as K9's column step), a cluster barrier,
// and each CTA contracts its slice with its resident G; store_rows 0
// stores each row's 512-byte run of the slice from registers, 1 leaves
// the outputs over the inputs in sx and, after a cluster barrier, stores
// whole rows gathered from every CTA's sx.  The barrier that frees sx for
// the next tile's stores arrives after the contraction (or the gather)
// and waits before the next tile's network, once ss has landed.
template <int N1>
__global__ void __launch_bounds__(ln::kThreads, 1)
ls_full_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
               float* __restrict__ yr, float* __restrict__ yi, const float* __restrict__ g,
               long long b, int tiles_unit, int chunk_rows, int store_rows) {
  constexpr int kBits = gdsp::log2_small(N1);
  constexpr int n = N1 * ln::kLanes;
  constexpr int P = ln::kLanes / N1;                        // points of a slice a CTA
  extern __shared__ float4 smem4[];
  float* sg = reinterpret_cast<float*>(smem4);  // G[rank]: three planes
  float* sx = sg + 3 * ln::kPlane;              // slice `rank` of the tile's rows, two planes
  float* ss = sx + 2 * ln::kTileWords;          // this CTA's points of every slice, two planes
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long cl = blockIdx.x / N1, clusters = gridDim.x / N1;
  const long long tiles = (b + ln::kTileRows - 1) / ln::kTileRows;
  const long long units = (tiles + tiles_unit - 1) / tiles_unit;
  const ln::Place pl = ln::place();
  const bool on = pl.row < chunk_rows;  // the contraction's rows of a chunk
  const int pairs = chunk_rows * P;     // the network's (row, point) of a chunk

  long long tile = cl < units ? cl * tiles_unit : -1;
  ln::cluster_arrive_relaxed();  // every sx is free: the first stores into it wait on this
  if (tile >= 0) {
    ln::stage_g(sg, g + static_cast<size_t>(rank) * 3 * ln::kPlane);
    load_points<N1>(ss, xr, xi, b, tile, rank);
  }
  ln::cp_async_commit();
  while (tile >= 0) {
    long long next = tile + 1;  // the walk: the unit's tiles, then unit + clusters
    if (next % tiles_unit == 0 || next >= tiles) {
      const long long u = tile / tiles_unit + clusters;
      next = u < units ? u * tiles_unit : -1;
    }
    ln::cp_async_wait_all();
    __syncthreads();  // ss holds the tile (and G is staged)
    for (int h0 = 0; h0 < ln::kTileRows; h0 += chunk_rows) {
      if (h0 == 0) ln::cluster_wait();  // every CTA is done with its sx
      for (int e = threadIdx.x; e < pairs; e += ln::kThreads) {
        const int r = h0 + e / P, p = e % P;
        float2 z[N1][1];
#pragma unroll
        for (int j1 = 0; j1 < N1; ++j1) {
          const int at = r * ln::kPitch + j1 * P + p;
          z[gdsp::rev_bits(j1, kBits)][0] = make_float2(ss[at], ss[ln::kTileWords + at]);
        }
        gdsp::slice_dft(z);
        const float* at = sx + r * ln::kPitch + rank * P + p;
#pragma unroll
        for (int k1 = 0; k1 < N1; ++k1) {
          ln::st_cluster(at, k1, z[k1][0].x);
          ln::st_cluster(at + ln::kTileWords, k1, z[k1][0].y);
        }
      }
      ln::cluster_arrive();
      ln::cluster_wait();  // rows h0 .. h0 + chunk_rows of every sx are in
      if (h0 + chunk_rows == ln::kTileRows) {  // every thread's reads of ss came before
        if (next >= 0) load_points<N1>(ss, xr, xi, b, next, rank);
        ln::cp_async_commit();
      }
      ln::Acc acc;
      ln::zero(acc);
      const int r0 = h0 + pl.row;
      if (on) ln::contract<0, ln::kLanes>(acc, sx + h0 * ln::kPitch,
                                          sx + ln::kTileWords + h0 * ln::kPitch, sg, pl.row,
                                          pl.bin);
      if (store_rows) {
        __syncthreads();  // every thread has read the chunk's rows of sx
        if (on) ln::put_outputs(sx + h0 * ln::kPitch, acc, pl, chunk_rows);
      } else if (on) {
#pragma unroll
        for (int e = 0; e < ln::kR; ++e) {
          const long long row = tile * ln::kTileRows + r0 + e;
          if (pl.row + e >= chunk_rows || row >= b) break;
          float4 vr, vi;
          ln::outputs(acc, e, vr, vi);
          const size_t off = static_cast<size_t>(row) * n + rank * ln::kLanes + pl.bin;
          *reinterpret_cast<float4*>(yr + off) = vr;
          *reinterpret_cast<float4*>(yi + off) = vi;
        }
      }
    }
    if (store_rows) {
      ln::cluster_arrive();
      ln::cluster_wait();  // every slice of the tile waits in its CTA's sx
      ln::gather_rows(sx, yr, yi, b, n, tile, 0, n, rank, N1);
    }
    ln::cluster_arrive_relaxed();  // this CTA is done reading every sx of the tile
    tile = next;
  }
  ln::cluster_wait();  // no CTA leaves while another reads or writes its shared memory
}

// ---------------------------------------------------------------------------
// lane_flip
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
lane_flip_kernel(const float* __restrict__ x, float* __restrict__ y, long long rows) {
  const int lane = threadIdx.x & 31;
  const long long step = static_cast<long long>(gridDim.x) * kWarps;
  for (long long r = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5); r < rows;
       r += step) {
    const size_t row = static_cast<size_t>(r) * kLanes;
    const float4 v = __ldg(reinterpret_cast<const float4*>(x + row) + lane);
    float4 u;
    u.x = 2.f * __shfl_xor_sync(0xffffffffu, v.w, 31);
    u.y = 2.f * __shfl_xor_sync(0xffffffffu, v.z, 31);
    u.z = 2.f * __shfl_xor_sync(0xffffffffu, v.y, 31);
    u.w = 2.f * __shfl_xor_sync(0xffffffffu, v.x, 31);
    reinterpret_cast<float4*>(y + row)[lane] = u;
  }
}

bool bad_shape(long long b, int n) {
  return b < 0 || (n != 128 && n != 256 && n != 512 && n != 1024);
}

int ls_full_smem(int n) { return (2 * kTile * n + 3 * kSteps * kLanes) * sizeof(float); }

template <int N1>
int launch_ls_full_stream(const float* xr, const float* xi, float* yr, float* yi,
                          const float* g, long long b, int rows_per_block, int chunk_rows,
                          int store_rows, cudaStream_t s) {
  const int smem = ls_full_smem(N1 * kLanes);
  cudaError_t e = gdsp::allow_smem(ls_full_stream_kernel<N1>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ls_full_stream_kernel<N1><<<gdsp::row_grid(1, (b + rows_per_block - 1) / rows_per_block),
                              kThreads, smem, s>>>(xr, xi, yr, yi, g, b, rows_per_block,
                                                   chunk_rows, store_rows);
  return static_cast<int>(cudaGetLastError());
}

template <int N1>
int launch_ls_full(const float* xr, const float* xi, float* yr, float* yi, const float* g,
                   long long b, const ln::Plan& p, cudaStream_t s) {
  auto kernel = &ls_full_kernel<N1>;
  cudaError_t e = gdsp::allow_smem(kernel, static_cast<size_t>(p.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  ln::ClusterLaunch l(p.cluster, p.ctas, static_cast<size_t>(p.smem), s);
  e = cudaLaunchKernelEx(&l.cfg, kernel, xr, xi, yr, yi, g, b, p.tiles_unit, p.chunk_rows,
                         p.store_rows);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each lane-slice entry: (b, n) float32 planes, n = n1 x 128 with n1 in
// 1, 2, 4, 8 (gmm_tf32: any n1), every pointer 16-byte aligned.  Returns cudaGetLastError(),
// or cudaErrorInvalidValue for a shape or setting the kernel does not take.

int gdsp_ls_network(const float* xr, const float* xi, float* yr, float* yi, long long b, int n,
                    void* stream) {
  if (bad_shape(b, n)) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  const dim3 grid = gdsp::row_grid(1, (b + kWarps - 1) / kWarps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 128: ls_network_kernel<1><<<grid, kThreads, 0, s>>>(xr, xi, yr, yi, b); break;
    case 256: ls_network_kernel<2><<<grid, kThreads, 0, s>>>(xr, xi, yr, yi, b); break;
    case 512: ls_network_kernel<4><<<grid, kThreads, 0, s>>>(xr, xi, yr, yi, b); break;
    default: ls_network_kernel<8><<<grid, kThreads, 0, s>>>(xr, xi, yr, yi, b); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// g: (n / 128, 3, 128, 128) float32 tables; groups: row groups a slice
// (grid.y, <= 65535).
int gdsp_gmm_tf32(const float* xr, const float* xi, float* yr, float* yi, const float* g,
                  long long b, int n, int groups, void* stream) {
  if (b < 0 || n < kLanes || n % kLanes != 0 || groups < 1 || groups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  cudaError_t e = gdsp::allow_smem(gmm_tf32_kernel, kTf32Smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  long long per = (b + groups - 1) / groups;
  per = (per + 15) / 16 * 16;
  const dim3 grid(n / kLanes, static_cast<unsigned>((b + per - 1) / per));
  gmm_tf32_kernel<<<grid, kThreads, kTf32Smem, static_cast<cudaStream_t>(stream)>>>(
      xr, xi, yr, yi, g, b, n, per);
  return static_cast<int>(cudaGetLastError());
}

// ls_full's first design, the yardstick: g (n / 128, 3, 128, 128) unscaled
// float32 tables; rows_per_block a positive multiple of 16; chunk_rows 2,
// 4, 8 or 16; store_rows 0 or 1.
int gdsp_ls_full_stream(const float* xr, const float* xi, float* yr, float* yi, const float* g,
                        long long b, int n, int rows_per_block, int chunk_rows, int store_rows,
                        void* stream) {
  if (bad_shape(b, n) || rows_per_block < kTile || rows_per_block % kTile != 0 ||
      (chunk_rows != 2 && chunk_rows != 4 && chunk_rows != 8 && chunk_rows != 16) ||
      (store_rows != 0 && store_rows != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto launch = n == 128 ? launch_ls_full_stream<1>
                    : n == 256 ? launch_ls_full_stream<2>
                    : n == 512 ? launch_ls_full_stream<4>
                               : launch_ls_full_stream<8>;
  return launch(xr, xi, yr, yi, g, b, rows_per_block, chunk_rows, store_rows, s);
}

// ls_full on clusters of n / 128 CTAs: g (n / 128, 3, 128, 128) unscaled
// float32 tables; rows_per_block a positive multiple of 16; chunk_rows 2,
// 4, 8 or 16; store_rows 0 or 1; resident the clusters of the kernel the
// card holds at once (gdsp_ls_full_resident).  Returns
// cudaErrorLaunchOutOfResources where resident < 1.
int gdsp_ls_full(const float* xr, const float* xi, float* yr, float* yi, const float* g,
                 long long b, int n, int rows_per_block, int chunk_rows, int store_rows,
                 int resident, void* stream) {
  ln::Plan p;
  if (bad_shape(b, n)) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = ln::make_plan(ln::kLsFull, b, n, rows_per_block, chunk_rows, store_rows,
                               resident, &p);
  if (rc != 0) return rc;
  if (b == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto launch = n == 128 ? launch_ls_full<1>
                    : n == 256 ? launch_ls_full<2>
                    : n == 512 ? launch_ls_full<4>
                               : launch_ls_full<8>;
  return launch(xr, xi, yr, yi, g, b, p, s);
}

// Clusters of ls_full_kernel at n points (n / 128 CTAs a cluster) the
// card holds at once with the plan's shared memory plus extra_smem bytes a
// CTA: 0 where none fits, or -(CUDA error).
int gdsp_ls_full_resident(int n, int extra_smem) {
  if (bad_shape(0, n)) return -static_cast<int>(cudaErrorInvalidValue);
  const int smem = ln::kSmem + extra_smem;
  switch (n) {
    case 128: return ln::resident_clusters(ls_full_kernel<1>, 1, smem);
    case 256: return ln::resident_clusters(ls_full_kernel<2>, 2, smem);
    case 512: return ln::resident_clusters(ls_full_kernel<4>, 4, smem);
    default: return ln::resident_clusters(ls_full_kernel<8>, 8, smem);
  }
}

// y[r, 127 - c] = 2 x[r, c] over `rows` rows of 128 float32, both pointers
// 16-byte aligned.
int gdsp_lane_flip(const float* x, float* y, long long rows, void* stream) {
  if (rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 16 * 132) blocks = 16 * 132;
  lane_flip_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(x, y, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
