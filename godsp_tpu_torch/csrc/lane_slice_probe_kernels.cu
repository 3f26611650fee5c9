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
// yr = m1 - m2, yi = (m3 - m1) - m2, G = K13's tables) with each product in
// ONE TF32 pass on the tensor cores, the card's counterpart of the TPU's
// one-bf16-pass DEFAULT matmul, by wgmma.  A pair of CTAs (2 p and 2 p + 1
// of a plain grid) serves one slice k1: CTA h of the pair keeps bins
// 64 h .. 64 h + 63 of G[k1]'s three planes resident (96 KB), staged once,
// rounded by cvt.rna.tf32.f32 and laid out as wgmma's K-major B operand (G
// transposed to [k2][i2]) in the 128-byte swizzle.  Rows come in 64-row
// tiles (wgmma's M), each in two stages of 64 columns.  A producer warp
// brings a stage by TMA tensor copies (boxes of 64 rows x 32 columns in the
// 128-byte swizzle, rows past b arriving as zeros): each CTA copies both
// planes' two boxes itself (L2 serves the pair's second read; a multicast
// of each plane to both CTAs of a cluster, tried first, tied the two CTAs'
// rings together and was slower on the H100), into a ring of three 32 KB
// stages with full and empty mbarriers.  The landed boxes are already
// wgmma's K-major A operand in the 128-byte swizzle, so both operands come
// from shared memory: the two consumer warpgroups round a and b in place
// by cvt.rna.tf32.f32 and write round(a + b) (an IEEE float32 add) beside
// them, once a stage for both, then each issues the stage's m64n32k8
// products for its 32 of the CTA's 64 bins.  Accumulation: the tensor
// cores chain kWgChain = 4 k-steps (scale-d 1) from zero, then that partial
// sum is added to the running sum on the CUDA cores in IEEE float32 (the
// first design adds each k8 product; chains of 1, 2, 4, 8 and 16 were
// measured once, PERF.md section 6, and 4 is the longest within 3 dB of
// the first design).  The pairs are persistent: as many as the card holds
// (one CTA an SM) split evenly among the slices, each walking its slice's
// tiles.  Epilogue: the same two subtractions into the two a + b buffers,
// laid out as the 64-row boxes of 32 bins a TMA store takes (rows past b
// dropped), stored by TMA, four boxes a tile.  Shared memory: 98,304 (G) +
// 98,304 (stages) + 32,768 (two stages' a + b) + 48 (barriers) + 1,024
// (alignment) = 230,448 bytes.  Bound: bytes, 0.080 ms (768 TF32
// operations a point: 0.026 ms).  It changes no TF32 or matmul flag;
// nothing at the 120 dB bar uses it.
// gmm_tf32_sync_kernel is the first design, kept as the yardstick: a block
// owns one slice k1 and a group of rows, stages G[k1]'s three planes
// rounded (204 KB at 136 words a row), and its warps walk 16-row tiles 64
// output columns at a time with mma.sync m16n8k8, A read from device
// memory in fragment order (a slice of A twice, once a half), each k-step
// summed from zero and added on the CUDA cores.

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
#include "hopper_async.cuh"
#include "lane_contract.cuh"
#include "mma_tf32.cuh"
#include "slice_network.cuh"

namespace cg = cooperative_groups;
namespace hp = gdsp::hopper;
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
gmm_tf32_sync_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
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
// gmm_tf32 on wgmma, fed by TMA (the plan: Tf32Plan below)
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;        // rows of a tile: wgmma's M
constexpr int kWgBins = 64;        // bins a CTA: half a slice
constexpr int kWgN = 32;           // bins a consumer warpgroup: wgmma's N
constexpr int kWgK = 64;           // columns of a slice a stage
constexpr int kWgBoxK = 32;        // columns of a TMA box: one 128-byte swizzled row
constexpr int kWgStages = 3;       // the ring of stages
constexpr int kWgChain = 4;        // k-steps the tensor cores sum before an add
constexpr int kWgConsumers = 256;  // two warpgroups, kWgN bins each
constexpr int kWgThreads = kWgConsumers + 32;  // and one producer warp
constexpr int kWgPlaneB = kWgBins * kLanes * 4;          // bytes of one resident plane of G
constexpr int kWgBox = kWgRows * kWgBoxK * 4;            // bytes of a box: 64 rows x 128 bytes
constexpr int kWgHalf = (kWgK / kWgBoxK) * kWgBox;       // one plane of a stage: 16 KB
constexpr int kWgStage = 2 * kWgHalf;                    // a and b of a stage: 32 KB
constexpr int kWgSmem =
    3 * kWgPlaneB + kWgStages * kWgStage + 2 * kWgHalf + 2 * kWgStages * 8 + 1024;

__device__ __forceinline__ float4 wg_round(float4 v) {
  return make_float4(__uint_as_float(gdsp::tf32(v.x)), __uint_as_float(gdsp::tf32(v.y)),
                     __uint_as_float(gdsp::tf32(v.z)), __uint_as_float(gdsp::tf32(v.w)));
}

// yr = m1 - m2, yi = (m3 - m1) - m2 from m (the accumulator layout of
// wgmma_m64n32k8_tf32: rows r0 and r0 + 8, columns col0 + 8 jn of the
// CTA's 64 bins) into out (yr's 16 KB, then yi's) laid out as TMA boxes of
// 32 bins land (hp::b128_offset over 64 rows).
__device__ __forceinline__ void wg_put(const float (&m)[3][16], char* out, int r0, int col0) {
#pragma unroll
  for (int jn = 0; jn < kWgN / 8; ++jn) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int q = 4 * jn + 2 * hh, at = hp::b128_offset(r0 + 8 * hh, col0 + 8 * jn, kWgRows);
      *reinterpret_cast<float2*>(out + at) =
          make_float2(__fsub_rn(m[0][q], m[1][q]), __fsub_rn(m[0][q + 1], m[1][q + 1]));
      *reinterpret_cast<float2*>(out + kWgHalf + at) =
          make_float2(__fsub_rn(__fsub_rn(m[2][q], m[0][q]), m[1][q]),
                      __fsub_rn(__fsub_rn(m[2][q + 1], m[0][q + 1]), m[1][q + 1]));
    }
  }
}

// ta, tb, tyr, tyi: tensor maps of the (b, n) planes a, b, yr and yi, boxes
// of 32 columns x 64 rows in the 128-byte swizzle; g: (n1, 3, 128, 128)
// float32 tables.
// Pair cl (CTAs 2 cl + h, h = 0, 1: bins 64 h ..) serves slice cl % n1 and
// its 64-row tiles cl / n1, + per, ...  Warpgroup c of a CTA's two consumer
// warpgroups takes its bins 32 c .. 32 c + 31; warp 8 is the producer.
__global__ void __launch_bounds__(kWgThreads, 1)
gmm_tf32_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                const __grid_constant__ CUtensorMap tyr, const __grid_constant__ CUtensorMap tyi,
                const float* __restrict__ g, long long b, int n, int per) {
  static_assert((kWgK / 8) % kWgChain == 0, "a chain ends within its stage");
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem4) + 1023) & ~static_cast<uintptr_t>(1023));
  char* sg = base;                         // G's three half planes, swizzled
  char* stages = base + 3 * kWgPlaneB;     // the ring: [stage][plane][box][64 rows][128 bytes]
  char* sums = stages + kWgStages * kWgStage;  // round(a + b) of a stage, two of them
  uint64_t* full = reinterpret_cast<uint64_t*>(sums + 2 * kWgHalf);
  uint64_t* empty = full + kWgStages;
  const int h = static_cast<int>(blockIdx.x & 1);
  const int n1 = n / kLanes;
  const long long cl = blockIdx.x / 2;
  const int k1 = static_cast<int>(cl % n1);
  const long long first = cl / n1;
  const long long tiles = (b + kWgRows - 1) / kWgRows;
  const long long steps = first < tiles ? (tiles - 1 - first) / per + 1 : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      hp::mbar_init(full + s, 1);                       // the producer's arrive.expect_tx
      hp::mbar_init(empty + s, kWgConsumers / 32);  // every consumer warp
    }
    hp::mbar_init_fence();
  }
  __syncthreads();  // the barriers exist before any copy or arrival

  if (threadIdx.x >= kWgConsumers) {
    // The producer warp's lane 0: the two boxes (the tile's rows, 32
    // columns each) of planes a and b a stage.
    if ((threadIdx.x & 31) == 0) {
      long long c = 0;  // stages filled
      for (long long i = 0; i < steps; ++i) {
        const int row = static_cast<int>((first + i * per) * kWgRows);
        for (int half = 0; half < kLanes / kWgK; ++half, ++c) {
          const int s = static_cast<int>(c % kWgStages);
          hp::mbar_wait(empty + s, (static_cast<uint32_t>(c / kWgStages) & 1u) ^ 1u);
          hp::mbar_arrive_expect_tx(full + s, kWgStage);
          for (int pl = 0; pl < 2; ++pl) {
            for (int box = 0; box < kWgK / kWgBoxK; ++box)
              hp::tma_load_2d(stages + s * kWgStage + pl * kWgHalf + box * kWgBox,
                              pl == 0 ? &ta : &tb, k1 * kLanes + half * kWgK + box * kWgBoxK, row,
                              full + s);
          }
        }
      }
    }
    __syncwarp();
  } else {
    // The consumer warpgroups.  First G's bins 64 h .. of slice k1, rounded,
    // into the B layout (the CTA's bins as rows, i2 as k), four bins a load.
    const float* gk = g + static_cast<size_t>(k1) * 3 * kPlane + kWgBins * h;
#pragma unroll 4
    for (int e = threadIdx.x; e < (steps > 0 ? 3 * kLanes * kWgBins / 4 : 0);
         e += kWgConsumers) {
      const int p = e / (kLanes * kWgBins / 4), i2 = (e / (kWgBins / 4)) % kLanes;
      const int nb = 4 * (e % (kWgBins / 4));
      const float4 v = __ldg(reinterpret_cast<const float4*>(gk + p * kPlane + i2 * kLanes + nb));
      char* at = sg + p * kWgPlaneB;
      *reinterpret_cast<uint32_t*>(at + hp::b128_offset(nb, i2, kWgBins)) = gdsp::tf32(v.x);
      *reinterpret_cast<uint32_t*>(at + hp::b128_offset(nb + 1, i2, kWgBins)) = gdsp::tf32(v.y);
      *reinterpret_cast<uint32_t*>(at + hp::b128_offset(nb + 2, i2, kWgBins)) = gdsp::tf32(v.z);
      *reinterpret_cast<uint32_t*>(at + hp::b128_offset(nb + 3, i2, kWgBins)) = gdsp::tf32(v.w);
    }

    const int wg = threadIdx.x >> 7;  // this warpgroup: bins 32 wg .. of the CTA's 64
    const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3, gq = lane >> 2, t = lane & 3;
    long long c = 0;  // stages consumed
    float d[3][16];   // the tensor cores' sums (scale-d 0 ignores them at a chain's start)
#pragma unroll
    for (int p = 0; p < 3; ++p) {
#pragma unroll
      for (int q = 0; q < 16; ++q) d[p][q] = 0.f;
    }
    for (long long i = 0; i < steps; ++i) {
      const long long t0 = (first + i * per) * kWgRows;
      float run[3][16];  // the running sums on the CUDA cores
#pragma unroll
      for (int p = 0; p < 3; ++p) {
#pragma unroll
        for (int q = 0; q < 16; ++q) run[p][q] = 0.f;
      }
#pragma unroll
      for (int half = 0; half < kLanes / kWgK; ++half, ++c) {
        const int s = static_cast<int>(c % kWgStages);
        char* sa = stages + s * kWgStage;  // a, then b at + kWgHalf
        char* ss = sums + (c & 1) * kWgHalf;
        hp::mbar_wait(full + s, static_cast<uint32_t>(c / kWgStages) & 1u);
        // a and b rounded in place by cvt.rna.tf32.f32, round(a + b) (an IEEE
        // float32 add) beside them: four 16-byte units of each plane a thread.
#pragma unroll
        for (int q = 0; q < kWgHalf / 16 / kWgConsumers; ++q) {
          const int off = 16 * (threadIdx.x + kWgConsumers * q);
          const float4 va = *reinterpret_cast<const float4*>(sa + off);
          const float4 vb = *reinterpret_cast<const float4*>(sa + kWgHalf + off);
          *reinterpret_cast<float4*>(sa + off) = wg_round(va);
          *reinterpret_cast<float4*>(sa + kWgHalf + off) = wg_round(vb);
          *reinterpret_cast<float4*>(ss + off) =
              wg_round(make_float4(__fadd_rn(va.x, vb.x), __fadd_rn(va.y, vb.y),
                                   __fadd_rn(va.z, vb.z), __fadd_rn(va.w, vb.w)));
        }
        hp::fence_proxy_async();           // the rounded operands, to wgmma's reads
        hp::named_sync(1, kWgConsumers);   // (and G's, at the first stage)
#pragma unroll
        for (int jj = 0; jj < kWgK / 8; ++jj) {
          const int j = (kWgK / 8) * half + jj;  // the k-step of the slice
          if (jj % kWgChain == 0) {
#pragma unroll
            for (int p = 0; p < 3; ++p) {
#pragma unroll
              for (int q = 0; q < 16; ++q) hp::fence_operand(d[p][q]);
            }
            hp::wgmma_fence();
          }
          const int ka = (jj >> 2) * kWgBox + (jj & 3) * 32;  // this k-step in a stage's plane
          const char* gb = sg + (j >> 2) * (kWgBins * 128) + kWgN * 128 * wg + (j & 3) * 32;
          const bool acc = jj % kWgChain != 0;
          hp::wgmma_m64n32k8_tf32(d[0], hp::desc_b128(sa + ka), hp::desc_b128(gb), acc);
          hp::wgmma_m64n32k8_tf32(d[1], hp::desc_b128(sa + kWgHalf + ka),
                                  hp::desc_b128(gb + kWgPlaneB), acc);
          hp::wgmma_m64n32k8_tf32(d[2], hp::desc_b128(ss + ka),
                                  hp::desc_b128(gb + 2 * kWgPlaneB), acc);
          if ((jj + 1) % kWgChain == 0) {
            hp::wgmma_commit();
            hp::wgmma_wait<0>();
#pragma unroll
            for (int p = 0; p < 3; ++p) {
#pragma unroll
              for (int q = 0; q < 16; ++q) {
                hp::fence_operand(d[p][q]);
                run[p][q] = __fadd_rn(run[p][q], d[p][q]);
              }
            }
          }
        }
        // The stage's products are done: release it to the producer.
        __syncwarp();
        if (lane == 0) hp::mbar_arrive(empty + s);
      }
      // The outputs into the two a + b buffers (free once both warpgroups'
      // products of the tile are done) as two 64-row boxes of 32 bins each a
      // plane, then stored by TMA; the buffers are written again only after
      // the store has read them.
      hp::named_sync(1, kWgConsumers);
      wg_put(run, sums, 16 * w + gq, kWgN * wg + 2 * t);
      hp::fence_proxy_async();
      hp::named_sync(1, kWgConsumers);
      if (threadIdx.x == 0) {
        const int col = k1 * kLanes + kWgBins * h, row = static_cast<int>(t0);
        for (int box = 0; box < kWgBins / kWgN; ++box) {
          hp::tma_store_2d(&tyr, sums + box * kWgBox, col + box * kWgN, row);
          hp::tma_store_2d(&tyi, sums + kWgHalf + box * kWgBox, col + box * kWgN, row);
        }
        hp::bulk_commit();
        hp::bulk_wait_read();
      }
      hp::named_sync(1, kWgConsumers);
    }
    if (threadIdx.x == 0) hp::bulk_wait_all();
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

// gmm_tf32's launch plan (ops/cuda_probes.py: gmm_tf32_plan holds the
// same; the GPU tests compare through gdsp_gmm_tf32_geometry).
struct Tf32Plan {
  int pair;       // CTAs a slice's tile: the two halves of its bins
  int pairs;      // pairs of the grid: per_slice x n1
  int ctas;       // CTAs of the grid
  int rows_tile;  // rows of a tile (wgmma's M)
  int bins_cta;   // bins a CTA (wgmma's N)
  int stages;     // the ring of stages a CTA
  int k_stage;    // columns of a slice a stage
  int smem;       // bytes of dynamic shared memory a CTA
  int per_slice;  // pairs a slice, each walking tiles first, first + per_slice, ...
  int chain;      // k-steps the tensor cores sum before an add on the CUDA cores
};
constexpr int kTf32PlanFields = 10;

// b >= 0, n a multiple of 128; resident the pairs the card holds at once.
// The resident pairs split evenly among the n1 slices (at least one a
// slice, at most one a tile).
int make_tf32_plan(long long b, int n, int resident, Tf32Plan* p) {
  if (b < 0 || n < kLanes || n % kLanes != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (resident < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const int n1 = n / kLanes;
  const long long tiles = (b + kWgRows - 1) / kWgRows;
  long long per = resident / n1;
  if (per < 1) per = 1;
  if (per > tiles) per = tiles > 0 ? tiles : 1;
  if (per * n1 * 2 > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  *p = Tf32Plan{2, static_cast<int>(per * n1), static_cast<int>(per * n1 * 2), kWgRows, kWgBins,
                kWgStages, kWgK, kWgSmem, static_cast<int>(per), kWgChain};
  return 0;
}

int launch_gmm_tf32(const float* xr, const float* xi, float* yr, float* yi, const float* g,
                    long long b, int n, const Tf32Plan& p, cudaStream_t s) {
  CUtensorMap maps[4];
  const float* planes[4] = {xr, xi, yr, yi};
  for (int i = 0; i < 4; ++i) {
    const int rc = hp::encode_tensor_map_2d(maps + i, planes[i], b, n, kWgBoxK, kWgRows);
    if (rc != 0) return rc;
  }
  cudaError_t e = gdsp::allow_smem(gmm_tf32_kernel, static_cast<size_t>(p.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  gmm_tf32_kernel<<<static_cast<unsigned>(p.ctas), kWgThreads, static_cast<size_t>(p.smem), s>>>(
      maps[0], maps[1], maps[2], maps[3], g, b, n, p.per_slice);
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

// gmm_tf32's first design, the yardstick (mma.sync, A from device memory):
// g (n / 128, 3, 128, 128) float32 tables; groups: row groups a slice
// (grid.y, <= 65535).
int gdsp_gmm_tf32_sync(const float* xr, const float* xi, float* yr, float* yi, const float* g,
                       long long b, int n, int groups, void* stream) {
  if (b < 0 || n < kLanes || n % kLanes != 0 || groups < 1 || groups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  cudaError_t e = gdsp::allow_smem(gmm_tf32_sync_kernel, kTf32Smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  long long per = (b + groups - 1) / groups;
  per = (per + 15) / 16 * 16;
  const dim3 grid(n / kLanes, static_cast<unsigned>((b + per - 1) / per));
  gmm_tf32_sync_kernel<<<grid, kThreads, kTf32Smem, static_cast<cudaStream_t>(stream)>>>(
      xr, xi, yr, yi, g, b, n, per);
  return static_cast<int>(cudaGetLastError());
}

// gmm_tf32 on wgmma: g (n / 128, 3, 128, 128) float32 tables (any n1);
// resident the pairs of gmm_tf32_kernel's CTAs the card holds at once
// (gdsp_gmm_tf32_resident).  Returns cudaErrorLaunchOutOfResources where
// resident < 1.
int gdsp_gmm_tf32(const float* xr, const float* xi, float* yr, float* yi, const float* g,
                  long long b, int n, int resident, void* stream) {
  Tf32Plan p;
  const int rc = make_tf32_plan(b, n, resident, &p);
  if (rc != 0) return rc;
  if (b == 0) return 0;
  return launch_gmm_tf32(xr, xi, yr, yi, g, b, n, p, static_cast<cudaStream_t>(stream));
}

// Pairs of gmm_tf32_kernel's CTAs the card holds at once with the plan's
// shared memory plus extra_smem bytes a CTA (the CTAs resident an SM times
// the SMs, halved): 0 where none fits, or -(CUDA error).
int gdsp_gmm_tf32_resident(int extra_smem) {
  const int smem = kWgSmem + extra_smem;
  int device = 0, sms = 0, blocks = 0;
  cudaError_t e = gdsp::allow_smem(gmm_tf32_kernel, static_cast<size_t>(smem));
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gmm_tf32_kernel, kWgThreads, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();  // reported here, not by the next launch's check
    return -static_cast<int>(e);
  }
  return blocks * sms / 2;
}

// gmm_tf32's plan at b x n with `resident` pairs: out[0..9] = pair, pairs,
// CTAs, rows a tile, bins a CTA, stages, columns a stage, shared bytes,
// pairs a slice, chain (Tf32Plan).  ops/cuda_probes.py: gmm_tf32_plan holds
// the same; the GPU tests compare.
int gdsp_gmm_tf32_geometry(long long b, int n, int resident, int* out) {
  Tf32Plan p;
  const int rc = make_tf32_plan(b, n, resident, &p);
  if (rc != 0) return rc;
  const int v[kTf32PlanFields] = {p.pair,     p.pairs,   p.ctas, p.rows_tile, p.bins_cta,
                                  p.stages,   p.k_stage, p.smem, p.per_slice, p.chain};
  for (int i = 0; i < kTf32PlanFields; ++i) out[i] = v[i];
  return 0;
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
