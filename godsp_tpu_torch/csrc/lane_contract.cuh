// K13's Karatsuba contraction of a row tile of one 128-point slice
// against a resident G[k1], shared by the cluster redesigns of K14c
// gmm_concat (lane_probe_kernels.cu) and K14f ls_full
// (lane_slice_probe_kernels.cu), the whole-row gather over distributed
// shared memory they store with, the remote stores K14c i8_concat
// (int8_probe_kernels.cu) pushes its rows with, and the three kernels'
// launch plan and cluster launch.
//
// The function, for the rows of a tile and one slice k1:
//   m1 = a G_r,  m2 = b G_i,  m3 = (a + b) G_s   (a = Re x, b = Im x),
//   Re y = m1 - m2,  Im y = (m3 - m1) - m2,
// every output the same chain as K13's (metrics_kernels.cu:
// gmm_floor_kernel): fmaf over i2 = 0..127 in order from 0.f for m1, m2
// and m3, a + b an IEEE float32 add, then the two subtractions.  So a
// result equals K13's bit for bit, whatever thread computes it and
// however the i2 loop is cut into segments.  No TF32, no mma: the
// tensor-core forms of this contraction are other twins (gmm_tf32, bd_hi,
// i8full).
//
// Where the time goes: 768 float32 operations a point (1.29e10 at 16384 x
// 1024: 0.192 ms at 67 TFLOP/s) against 16 B a point of device traffic
// (0.080 ms at 3.35 TB/s), so the FMA pipe has to be fed from shared
// memory.  A CTA of 128 threads keeps G[k1]'s three planes resident (192
// KB, natural [i2][k2] order, staged once by cp.async) and contracts a
// 16-row tile whose two planes wait in shared memory at a pitch of 132
// words.  Each thread owns 4 rows x 4 bins: per four i2 it reads 8 float4
// of the tile (a row's a or b at i2 .. i2 + 3) and 12 float4 of G (4
// consecutive bins of the three planes at each i2) for 192 FMAs and 16
// adds.  A warp covers 16 rows x 32 bins (lanes 8 bin groups x 4 row
// groups); each quarter-warp of a 16-byte load reads one tile address or
// 128 consecutive bytes of G, one wavefront each.  What bounds it: a
// 16-byte load costs a warp four wavefronts whatever lanes share, so each
// float a thread loads costs a wavefront; 20 floats an i2 for 48 FMAs
// give 80 wavefronts against 48 FMA cycles a 16-row i2 step on an SM.
// G's 192 KB leaves room for 16-row tiles only, so no larger register tile
// fits, and the design sits at K13's rate a SM (PERF.md, section 6).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace gdsp {
namespace lane {

constexpr int kLanes = 128;                        // points of a slice
constexpr int kPlane = kLanes * kLanes;            // one plane of G[k1]
constexpr int kThreads = 128;                      // threads a CTA: a warp a 32-bin quarter
constexpr int kR = 4;                              // rows a thread
constexpr int kC = 4;                              // bins a thread
constexpr int kTileRows = 16;                      // rows of a tile
constexpr int kPitch = 132;                        // words a staged row: 4 banks apart
constexpr int kTileWords = kTileRows * kPitch;     // one plane of a tile buffer
constexpr int kMaxCluster = 8;                     // portable cluster size
constexpr int kChunk = kMaxCluster * kLanes;       // columns a cluster covers
// G[k1] and two two-plane tile buffers: 196,608 + 33,792 = 230,400 bytes of
// the 232,448 a CTA may hold.
constexpr int kSmem = (3 * kPlane + 4 * kTileWords) * static_cast<int>(sizeof(float));
// i8_concat's CTA (256 compute threads and a storer warp): its slice's nine
// 16 KB int8 table planes, the step's nine 2 KB digit planes, 16 row
// scales, a two-plane 16-row input tile buffer (147,456 + 18,432 + 64 +
// 16,384 = 182,336 bytes), two rows buffers of the ceil(16 / n1) whole
// rows of a tile it stores and their four mbarriers.
constexpr int kI8Threads = 256;
__host__ __device__ constexpr int i8_rows(int n1) { return (kTileRows + n1 - 1) / n1; }
__host__ __device__ constexpr int i8_smem(int n1) {
  return 9 * 16384 + 9 * 2048 + kTileRows * 4 + 2 * kTileRows * kLanes * 4 +
         2 * 2 * i8_rows(n1) * n1 * kLanes * 4 + 4 * 8;
}

// ---------------------------------------------------------------------------
// Device side
// ---------------------------------------------------------------------------

// 16 bytes from device memory into shared memory without the registers,
// zero-filled where `valid` is false (gmem must still be a device address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// Waits until at most N of this thread's newest cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v stored at `at`, an address of this CTA's shared memory, in the shared
// memory of CTA `rank` of the cluster (mapa, then st.shared::cluster: a
// 32-bit shared-window address).  The store is volatile, so it keeps its
// place before the barrier's release, and clobbers no memory, so the
// thread's values stay in registers.
__device__ __forceinline__ void st_cluster(const float* at, int rank, float v) {
  const unsigned local = static_cast<unsigned>(__cvta_generic_to_shared(at));
  unsigned remote;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(v));
}

// Two floats stored at `at` (8-byte aligned) in CTA `rank`'s shared memory,
// as st_cluster.
__device__ __forceinline__ void st_cluster2(const float* at, int rank, float x, float y) {
  const unsigned local = static_cast<unsigned>(__cvta_generic_to_shared(at));
  unsigned remote;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(remote), "f"(x), "f"(y));
}

// The cluster barrier in its two halves: every thread of the cluster
// arrives (its earlier shared-memory writes released to the cluster), then
// waits until all have arrived.  A thread alternates arrive and wait; work
// placed between them hides the barrier.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
// An arrival that orders nothing: for "done reading", whose reads have
// returned (their values are used before it), so that it does not wait
// for the thread's global stores in flight as a release would.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A thread's place in the contraction of a tile: bins bin .. bin + 3 of
// rows row .. row + 3 (warp w: bins 32 w ..; lane: 8 bin groups x 4 row
// groups).
struct Place {
  int row, bin;
};

__device__ __forceinline__ Place place() {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return {kR * (lane >> 3), 32 * warp + kC * (lane & 7)};
}

// m1, m2, m3 of a thread's kR rows x kC bins.
struct Acc {
  float m1[kR][kC], m2[kR][kC], m3[kR][kC];
};

__device__ __forceinline__ void zero(Acc& c) {
#pragma unroll
  for (int e = 0; e < kR; ++e) {
#pragma unroll
    for (int q = 0; q < kC; ++q) c.m1[e][q] = c.m2[e][q] = c.m3[e][q] = 0.f;
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// The chain's steps i2 in [I0, I1) for rows r .. r + kR - 1 of a tile,
// bins bin .. bin + kC - 1: xr/xi the tile's planes (pitch kPitch), g
// G[k1]'s three planes.
template <int I0, int I1>
__device__ __forceinline__ void contract(Acc& c, const float* xr, const float* xi,
                                         const float* g, int r, int bin) {
  static_assert(I0 % 4 == 0 && I1 % 4 == 0 && I0 < I1 && I1 <= kLanes, "i2 segments of 4");
  const float* ar0 = xr + r * kPitch;
  const float* ai0 = xi + r * kPitch;
#pragma unroll 2
  for (int i = I0; i < I1; i += 4) {
    float4 a[kR], b[kR];
#pragma unroll
    for (int e = 0; e < kR; ++e) {
      a[e] = *reinterpret_cast<const float4*>(ar0 + e * kPitch + i);
      b[e] = *reinterpret_cast<const float4*>(ai0 + e * kPitch + i);
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const float* gi2 = g + (i + ii) * kLanes + bin;
      const float4 gr = *reinterpret_cast<const float4*>(gi2);
      const float4 gi = *reinterpret_cast<const float4*>(gi2 + kPlane);
      const float4 gs = *reinterpret_cast<const float4*>(gi2 + 2 * kPlane);
#pragma unroll
      for (int e = 0; e < kR; ++e) {
        const float ar = lane_of(a[e], ii), ai = lane_of(b[e], ii);
        const float as = ar + ai;
#pragma unroll
        for (int q = 0; q < kC; ++q) {
          c.m1[e][q] = fmaf(ar, lane_of(gr, q), c.m1[e][q]);
          c.m2[e][q] = fmaf(ai, lane_of(gi, q), c.m2[e][q]);
          c.m3[e][q] = fmaf(as, lane_of(gs, q), c.m3[e][q]);
        }
      }
    }
  }
}

// The outputs of the thread's row e: (Re y, Im y) at its 4 bins.
__device__ __forceinline__ void outputs(const Acc& c, int e, float4& yr, float4& yi) {
  float r[4], i[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    r[q] = c.m1[e][q] - c.m2[e][q];
    i[q] = c.m3[e][q] - c.m1[e][q] - c.m2[e][q];
  }
  yr = make_float4(r[0], r[1], r[2], r[3]);
  yi = make_float4(i[0], i[1], i[2], i[3]);
}

// Stage G[k1]'s three planes (g: 3 x kPlane floats, 16-byte aligned) into
// sg by cp.async; the caller commits.
__device__ __forceinline__ void stage_g(float* sg, const float* g) {
  for (int e = threadIdx.x; e < 3 * kPlane / 4; e += kThreads)
    cp_async16(sg + 4 * e, g + 4 * e, true);
}

// The thread's rows of outputs below `rows` into a tile buffer (two planes
// at kPitch), over the inputs they came from.
__device__ __forceinline__ void put_outputs(float* buf, const Acc& c, Place p, int rows) {
#pragma unroll
  for (int e = 0; e < kR; ++e) {
    if (p.row + e >= rows) break;
    float4 vr, vi;
    outputs(c, e, vr, vi);
    float* at = buf + (p.row + e) * kPitch + p.bin;
    *reinterpret_cast<float4*>(at) = vr;
    *reinterpret_cast<float4*>(at + kTileWords) = vi;
  }
}

// The whole-row store of a tile: CTA `rank` of a cluster of `cs` stores
// rows rank, rank + cs, ... (< 16, and < b in all) of tile `tile` as whole
// rows of columns c0 .. c0 + cols - 1 of the (b, n) planes, the 128
// columns of slice s read from CTA s's tile buffer `buf` over distributed
// shared memory (16 bytes a thread a plane, consecutive threads on
// consecutive columns).  A thread takes at most ceil(16 / cs) x 32 cs /
// kThreads <= kGatherMax words a plane; all its remote loads are issued
// before its first store.
constexpr int kGatherMax = 6;

__device__ __forceinline__ void gather_rows(float* buf, float* __restrict__ yr,
                                            float* __restrict__ yi, long long b, int n,
                                            long long tile, int c0, int cols, int rank, int cs) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int quads = cols / 4;
  const int words = (kTileRows - rank + cs - 1) / cs * quads;
  float4 vr[kGatherMax], vi[kGatherMax];
#pragma unroll
  for (int u = 0; u < kGatherMax; ++u) {
    const int e = threadIdx.x + u * kThreads;
    const int r = rank + cs * (e / quads), c = 4 * (e % quads);
    if (e < words && tile * kTileRows + r < b) {
      const float* src = cluster.map_shared_rank(buf, c / kLanes) + r * kPitch + c % kLanes;
      vr[u] = *reinterpret_cast<const float4*>(src);
      vi[u] = *reinterpret_cast<const float4*>(src + kTileWords);
    }
  }
#pragma unroll
  for (int u = 0; u < kGatherMax; ++u) {
    const int e = threadIdx.x + u * kThreads;
    const int r = rank + cs * (e / quads), c = 4 * (e % quads);
    const long long row = tile * kTileRows + r;
    if (e < words && row < b) {
      const size_t off = static_cast<size_t>(row) * n + c0 + c;
      *reinterpret_cast<float4*>(yr + off) = vr[u];
      *reinterpret_cast<float4*>(yi + off) = vi[u];
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: the launch plan (ops/cuda_probes.py: lane_cluster_plan holds
// the same; the GPU tests compare through gdsp_lane_cluster_geometry).
// ---------------------------------------------------------------------------

enum Kind { kGmmConcat = 0, kLsFull = 1, kI8Concat = 2 };

struct Plan {
  int cluster;     // CTAs a cluster: a CTA a 128-column slice
  int clusters;    // clusters of the grid (persistent: at most the resident ones a chunk)
  int ctas;        // CTAs of the grid
  int rows_tile;   // rows of a tile
  int tiles_unit;  // tiles a cluster takes as one unit of work
  int buffers;     // two-plane tile buffers a CTA
  int smem;        // bytes of dynamic shared memory a CTA
  int store_rows;  // 1: whole rows gathered over distributed shared memory; 0: 512-byte runs
  int chunk_rows;  // rows of a tile the network and contraction take at a time
  int chunks;      // 1024-column chunks of a row, each its own clusters
};
constexpr int kPlanFields = 10;

// kind kGmmConcat: n a multiple of 128 (rows_per_block, chunk_rows,
// store_rows ignored); kLsFull: n = n1 x 128, n1 in 1, 2, 4, 8,
// rows_per_block a positive multiple of 16, chunk_rows 2, 4, 8 or 16,
// store_rows 0 or 1; kI8Concat: n = n1 x 128, 1 <= n1 <= 8 (the rest
// ignored), a cluster of n1 CTAs, two rows buffers.  resident: clusters of the kernel the card holds at
// once (cudaOccupancyMaxActiveClusters).  Returns cudaErrorInvalidValue for
// a shape or setting the kernel does not take, cudaErrorLaunchOutOfResources
// where resident < 1.
inline int make_plan(int kind, long long b, int n, int rows_per_block, int chunk_rows,
                     int store_rows, int resident, Plan* p) {
  if (b < 0 || n < kLanes || n % kLanes != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n1 = n / kLanes;
  const long long tiles = (b + kTileRows - 1) / kTileRows;
  *p = Plan{};
  p->rows_tile = kTileRows;
  p->buffers = 2;
  p->smem = kSmem;
  if (kind == kGmmConcat) {
    p->cluster = n1 < kMaxCluster ? n1 : kMaxCluster;
    p->chunks = (n + kChunk - 1) / kChunk;
    p->tiles_unit = 1;
    p->store_rows = 1;
    p->chunk_rows = kTileRows;
  } else if (kind == kLsFull) {
    if ((n1 != 1 && n1 != 2 && n1 != 4 && n1 != 8) || rows_per_block < kTileRows ||
        rows_per_block % kTileRows != 0 ||
        (chunk_rows != 2 && chunk_rows != 4 && chunk_rows != 8 && chunk_rows != 16) ||
        (store_rows != 0 && store_rows != 1))
      return static_cast<int>(cudaErrorInvalidValue);
    p->cluster = n1;
    p->chunks = 1;
    p->tiles_unit = rows_per_block / kTileRows;
    p->store_rows = store_rows;
    p->chunk_rows = chunk_rows;
  } else if (kind == kI8Concat) {
    if (n1 > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
    p->cluster = n1;
    p->chunks = 1;
    p->tiles_unit = 1;
    p->store_rows = 1;
    p->chunk_rows = kTileRows;
    p->smem = i8_smem(n1);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (resident < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const long long units = (tiles + p->tiles_unit - 1) / p->tiles_unit;
  long long per = resident / p->chunks;  // clusters a chunk
  if (per < 1) per = 1;
  if (per > units) per = units;
  const long long clusters = per * p->chunks;
  if (clusters * p->cluster > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p->clusters = static_cast<int>(clusters);
  p->ctas = p->clusters * p->cluster;
  return 0;
}

inline void plan_fields(const Plan& p, int* out) {
  const int v[kPlanFields] = {p.cluster, p.clusters,   p.ctas,       p.rows_tile,  p.tiles_unit,
                              p.buffers, p.smem,       p.store_rows, p.chunk_rows, p.chunks};
  for (int i = 0; i < kPlanFields; ++i) out[i] = v[i];
}

// The launch configuration of a cluster kernel: ctas CTAs of `threads`
// threads in clusters of `cluster`.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int cluster, int ctas, size_t smem, cudaStream_t stream, int threads = kThreads)
      : cfg{}, attr{} {
    cfg.gridDim = dim3(static_cast<unsigned>(ctas));
    cfg.blockDim = dim3(static_cast<unsigned>(threads));
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Clusters of `cluster` CTAs of `kernel` (`threads` threads, smem bytes of
// dynamic shared memory each) that the card holds at once (0 where none
// fits), or -(CUDA error).  The kernel's shared-memory attribute is set to
// smem first, so a CTA asking for more than the card allows reports the
// error here.
template <typename Kernel>
inline int resident_clusters(Kernel kernel, int cluster, int smem, int threads = kThreads) {
  cudaError_t e = allow_smem(kernel, static_cast<size_t>(smem));
  int clusters = 0;
  if (e == cudaSuccess) {
    ClusterLaunch l(cluster, cluster, static_cast<size_t>(smem), nullptr, threads);
    e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &l.cfg);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();  // reported here, not by the next launch's check
    return -static_cast<int>(e);
  }
  return clusters;
}

}  // namespace lane
}  // namespace gdsp
