// Fused last peel + row FFT of the giant-N FFT plan for Hopper (sm_90a): K9.
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
// Bound on the H100: one read and one write of two float32 planes, 16
// bytes a point (268 MB at 16 x 2^20, 0.080 ms at 3.35 TB/s), against
// 5 log2(128 n3) flops a point: device memory bounds it.  So the input
// should come from device memory once and go back once, with the column
// step, the exchange between the two steps and the row passes on chip.
//
// Design (the redesign; the first design, R rows a block re-reading
// all 128 input rows, bit-reversed stores and log2 n3 radix-2 stages of
// fft_block.cuh, stays in radix2_probe_kernels.cu as the yardstick
// peel_rows_radix2): a thread-block cluster of C = 8 CTAs owns M = C R
// rows of one batch element, R rows a CTA in R n3 float2 of shared
// memory (R = min(16, 16384 / n3): 128 KB from n3 = 1024 on).  The G =
// 128 / M clusters of a batch element each read its whole input once from
// device memory or L2: G is 1 up to n3 = 1024 and 2, 4, 8 at 2048, 4096,
// 8192, where the first design read it 128 / R = 8..64 times.
//
// Phase A, the column step, once a column: CTA q of the cluster takes
// columns [q n3 / C, (q + 1) n3 / C), in tiles of K8's shape (tile(M) in
// ops/cuda_outer.py: Ct columns x T threads, 256 threads, two tiles side
// by side).  Cluster g (k1 = g + G j, j < M) first runs one radix-G
// decimation step for its residue class where G > 1,
//   u[i0] = W_128^{g i0} sum_{i1 < G} x[i0 + M i1, t] W_128^{g M i1},
// then the M-point DFT of u on fft_regs.cuh's register-radix passes (K8's
// column passes, columns interleaved word by word in shared memory), then
// W_{128 n3}^{k1 t} from K8's factored hi/lo tables (8 KB at most: K8's
// tile table, which avoids gathering lo at a stride of k1 across the
// lanes, left K9's time as it was), and stores bin j at
// natural position t of row slot j / C in the shared memory of CTA
// j mod C: a distributed shared memory store through
// cluster_group::map_shared_rank, one row and 32 consecutive columns a
// warp access (free of bank conflicts in the target but at n3 = 256, where
// the row passes interleave two rows word by word: two ways).  No bit
// reversal.  Then cluster.sync().
//
// Phase B, the rows on K1's body: each CTA runs its R rows with
// fft_regs.cuh's passes (a row a warp up to n3 = 1024, a row of n3 / 16
// threads from 2048), the first pass reading the CTA's own shared memory,
// the exchanges in the row's own slot, the store coalesced along k3 with
// `scale` applied.
//
// Precision: every table is built in float64 on the host and rounded once
// to float32 (the M- and n3-point Stockham tables, W_128 whole, and W_{128
// n3}^p = hi[p >> s] * lo[p & (2^s - 1)] factored as in K8, p = k1 t exact
// in integers); float32 FMA on CUDA cores, no matmul, so no TF32; no
// atomics, so a second call is bit-equal.

#include <cooperative_groups.h>

#include <cstdint>

#include "fft_regs.cuh"
#include "launch.cuh"

namespace cg = cooperative_groups;

namespace {

using gdsp::regs::Row;
using gdsp::regs::Slot;
using gdsp::regs::out_index;
using gdsp::regs::row_dft;
using gdsp::regs::slot_of;
using gdsp::regs::unroll;
using gdsp::regs::with_log2;

constexpr int kD = 128;        // points of the fused peel
constexpr int kCluster = 8;    // CTAs a cluster (portable)
constexpr int kThreads = 512;  // threads a CTA
constexpr int kSlabPoints = 16384;  // R n3 float2 a CTA at most: 128 KB

// The plan of n3 = 2^LOG2N3 (ops/cuda_outer.py: peel_plan holds the same).
template <int LOG2N3>
struct Plan {
  static constexpr int kN3 = 1 << LOG2N3;
  static constexpr int kR = kSlabPoints / kN3 < 16 ? kSlabPoints / kN3 : 16;  // rows a CTA
  static constexpr int kM = kCluster * kR;  // rows a cluster: the column DFT's points
  static constexpr int kLog2M = gdsp::regs::ilog2(kM);
  static constexpr int kG = kD / kM;  // clusters a batch element: its L2 re-read factor
  using A = Row<kLog2M>;              // the column passes
  using B = Row<LOG2N3>;              // the row passes
  // K8's column tile (outer_kernel.cu: Tile): Ct columns x A::kT threads.
  static constexpr int kCt = A::kT <= 16 ? (256 / A::kT > 32 ? 256 / A::kT : 32) : 8;
  static constexpr int kTileThreads = A::kT * kCt;
  static constexpr int kTiles = kThreads / kTileThreads;  // tiles side by side
  static constexpr int kExchange = A::kPasses >= 2 ? kCt * kM * 2 : 0;  // floats a tile
  static constexpr int kSlab = kR * kN3 * 2;                            // floats
  static constexpr size_t kSmem = static_cast<size_t>(kSlab + kTiles * kExchange) * sizeof(float);
  // Rows a round of phase B: whole warps of Q rows, or 512 / T rows.
  static constexpr int kRowsAtOnce = B::kWarp ? kThreads / 32 * B::kQ : kThreads / B::kT;
};

template <int LOG2N3, bool INV>
__global__ void __launch_bounds__(kThreads)
    peel_rows_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                     float* __restrict__ yr, float* __restrict__ yi,
                     const float2* __restrict__ w128, const float2* __restrict__ tw_m,
                     const float2* __restrict__ tw_n3, const float2* __restrict__ hi,
                     const float2* __restrict__ lo, int lo_bits, float scale) {
  using K = Plan<LOG2N3>;
  using A = typename K::A;
  using B = typename K::B;
  constexpr int n3 = K::kN3;
  constexpr int M = K::kM;
  constexpr int G = K::kG;
  constexpr int Ct = K::kCt;
  extern __shared__ float smem[];
  float* slab = smem;  // the CTA's R rows: re plane, then im plane (fft_regs.cuh's slots)
  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());
  const long long cl = blockIdx.x / kCluster;
  const long long b = cl / G;
  const int g = static_cast<int>(cl % G);
  const long long base = b * kD * n3;
  cluster.sync();  // every CTA of the cluster runs before any store into its shared memory

  // ---- Phase A: the column step of this CTA's columns, scattered to the cluster.
  {
    const int tile = threadIdx.x / K::kTileThreads;
    const int tid = threadIdx.x % K::kTileThreads;
    const int t = tid / Ct;
    const int cc = tid % Ct;
    float* ex = smem + K::kSlab + tile * K::kExchange;
    const Slot<K::kLog2M, Ct, false> s{ex, ex + Ct * M, cc};
    constexpr int cols = n3 / kCluster;  // a multiple of Ct at every n3
    constexpr int tiles = cols / Ct;
    const unsigned lo_mask = (1u << lo_bits) - 1;
    for (int it = 0; it < (tiles + K::kTiles - 1) / K::kTiles; ++it) {  // uniform: fences inside
      const int tl = it * K::kTiles + tile;
      const bool live = tl < tiles;
      const int c = q * cols + (live ? tl : 0) * Ct + cc;
      float2 v[A::kP];
      if constexpr (G == 1) {
        unroll<A::kP>([&](auto rr) {
          const long long gi = base + static_cast<long long>(t + GDSP_IDX(rr) * A::kT) * n3 + c;
          v[GDSP_IDX(rr)] = make_float2(__ldg(&xr[gi]), __ldg(&xi[gi]));
        });
      } else {
        unroll<A::kP>([&](auto rr) { v[GDSP_IDX(rr)] = make_float2(0.f, 0.f); });
#pragma unroll 1
        for (int i1 = 0; i1 < G; ++i1) {  // P loads a plane in flight, not G P
          const float2 w = __ldg(&w128[(g * M * i1) & (kD - 1)]);  // W_G^{g i1}
          unroll<A::kP>([&](auto rr) {
            constexpr int r = GDSP_IDX(rr);
            const long long gi = base + static_cast<long long>(t + r * A::kT + M * i1) * n3 + c;
            const float vr = __ldg(&xr[gi]), vi = __ldg(&xi[gi]);
            v[r].x = fmaf(vr, w.x, fmaf(-vi, w.y, v[r].x));
            v[r].y = fmaf(vr, w.y, fmaf(vi, w.x, v[r].y));
          });
        }
        unroll<A::kP>([&](auto rr) {
          constexpr int r = GDSP_IDX(rr);
          v[r] = gdsp::regs::mul(v[r], __ldg(&w128[(g * (t + r * A::kT)) & (kD - 1)]));
        });
      }
      row_dft<K::kLog2M, INV>(v, t, s, tw_m);
      if (live) {
        unroll<A::kP>([&](auto ii) {
          constexpr int i = GDSP_IDX(ii);
          const int j = t + out_index<K::kLog2M>(i) * A::kT;
          const unsigned p = static_cast<unsigned>(g + G * j) * static_cast<unsigned>(c);
          const float2 w = gdsp::regs::mul(__ldg(&hi[p >> lo_bits]), __ldg(&lo[p & lo_mask]));
          const float2 y = gdsp::regs::mul(v[i], w);
          // Row j lives in CTA j mod C, row slot j / C, natural position c.
          const auto dst = slot_of<LOG2N3>(cluster.map_shared_rank(slab, j % kCluster), K::kR,
                                           j / kCluster);
          dst.put(c, y);
        });
      }
    }
  }
  cluster.sync();  // every row of the cluster complete; no remote access after this

  // ---- Phase B: this CTA's R rows.
  for (int r0 = 0; r0 < K::kR; r0 += K::kRowsAtOnce) {
    const int slot = r0 + threadIdx.x / B::kT;
    if (B::kWarp && slot >= K::kR) break;  // whole warps (R is a multiple of Q)
    const int t = threadIdx.x % B::kT;
    const auto s = slot_of<LOG2N3>(slab, K::kR, slot);
    float2 v[B::kP];
    unroll<B::kP>([&](auto rr) { v[GDSP_IDX(rr)] = s.get(t + GDSP_IDX(rr) * B::kT); });
    s.fence();  // every read of the row before its first exchange overwrites it
    row_dft<LOG2N3, INV>(v, t, s, tw_n3);
    const int k1 = g + G * (slot * kCluster + q);
    const long long o = base + static_cast<long long>(k1) * n3;
    unroll<B::kP>([&](auto ii) {
      constexpr int i = GDSP_IDX(ii);
      const long long gi = o + t + out_index<LOG2N3>(i) * B::kT;
      yr[gi] = v[i].x * scale;
      yi[gi] = v[i].y * scale;
    });
  }
}

template <int LOG2N3, bool INV>
int launch(const float* xr, const float* xi, float* yr, float* yi, const float2* w128,
           const float2* tw_m, const float2* tw_n3, const float2* hi, const float2* lo,
           long long batch, int lo_bits, float scale, cudaStream_t stream) {
  using K = Plan<LOG2N3>;
  auto kernel = &peel_rows_kernel<LOG2N3, INV>;
  const long long blocks = batch * K::kG * kCluster;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = gdsp::allow_smem(kernel, K::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = K::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static int clusters = 0;  // clusters of the plan the card holds at once, asked once
  if (clusters == 0) {
    e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (clusters == 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
  }
  e = cudaLaunchKernelEx(&cfg, kernel, xr, xi, yr, yi, w128, tw_m, tw_n3, hi, lo, lo_bits, scale);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y = scale * (the 128-point peel, its twiddle and the n3-point row FFT)
// of x over `batch` (128, n3) planes, n3 = 2^log2n3 in 256..8192, rows in
// natural order, on clusters of 8 CTAs.  w128 is the whole 128-entry W_128
// table, tw_m the M-point and tw_n3 the n3-point Stockham table
// (ops/cuda_fft.py: stockham_table; all three conjugate for the inverse),
// hi and lo the factored W_{128 n3} tables, lo of 2^lo_bits entries.
// Returns cudaErrorInvalidValue for an n3 out of range or a grid past
// 2^31 - 1 blocks, cudaErrorLaunchOutOfResources where no cluster of
// the plan fits on the card (cudaOccupancyMaxActiveClusters gives 0),
// else the launch's error.
int gdsp_peel_rows(const float* xr, const float* xi, float* yr, float* yi, const float2* w128,
                   const float2* tw_m, const float2* tw_n3, const float2* hi, const float2* lo,
                   int log2n3, long long batch, int lo_bits, int inverse, float scale,
                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_log2<8, 13>(log2n3, [&](auto lg) {
    constexpr int L = decltype(lg)::value;
    return inverse ? launch<L, true>(xr, xi, yr, yi, w128, tw_m, tw_n3, hi, lo, batch, lo_bits,
                                     scale, st)
                   : launch<L, false>(xr, xi, yr, yi, w128, tw_m, tw_n3, hi, lo, batch, lo_bits,
                                      scale, st);
  });
}

// The plan of n3 = 2^log2n3 (8..13) as the kernel runs it: out[0] CTAs a
// cluster, [1] rows a CTA, [2] rows a cluster (the column DFT's points),
// [3] clusters a batch element (its L2 re-read factor), [4] threads a
// CTA, [5] columns a phase-A tile, [6] tiles side by side, [7] bytes of
// shared memory.  ops/cuda_outer.py: peel_plan holds the same; the GPU
// tests compare.
int gdsp_peel_rows_geometry(int log2n3, int* out) {
  return with_log2<8, 13>(log2n3, [&](auto lg) {
    using K = Plan<decltype(lg)::value>;
    out[0] = kCluster;
    out[1] = K::kR;
    out[2] = K::kM;
    out[3] = K::kG;
    out[4] = kThreads;
    out[5] = K::kCt;
    out[6] = K::kTiles;
    out[7] = static_cast<int>(K::kSmem);
    return 0;
  });
}

}  // extern "C"
