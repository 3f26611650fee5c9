// K14b and K14c: the lane-DFT probes for Hopper (sm_90a), twins of K13
// (metrics_kernels.cu: gmm_floor_kernel) and K12 (copy_split_kernel).
// They run under godsp_tpu_torch/probes/facdft.py and probes/store.py.
// Every kernel takes two float32 planes (b, n), n = n1 x 128, contiguous
// and 16-byte aligned, and a block covers a tile of rows by a chunk of up
// to 1024 columns (eight 128-column slices: a whole row at n = 1024).
//
// K14b fac_dft_kernel replaces tools/probe_facdft.py: fac_pallas
// (_kern_fac).  K13's function, y[128 s + k] = sum_j x[128 s + j] T[s, j]
// W128^{jk} / 128, factored as 128 = 16 x 8: j = 8 j1 + j2, k = ka + 16 kb,
//   X[ka + 16 kb] = sum_j2 W8^{j2 kb} W128^{j2 ka} sum_j1 v[8 j1 + j2] W16^{j1 ka},
// v = x T.  Per point: the outer twiddle (6 operations), 16 complex
// multiply-adds in the 16-point DFTs (128), the mid twiddle (6) and 8 in
// the 8-point DFTs (64): 204 float32 operations, against the dense
// contraction's 768.  Bound on the H100 at 1024 x 16384: 268 MB of
// traffic, 0.080 ms at 3.35 TB/s, above 3.4e9 operations, 0.051 ms at
// 67 TFLOP/s: bytes.  Design (simple, right first): a block stages two
// rows of its chunk in shared memory (16-byte loads, the outer twiddle
// applied as they land; slices 136 floats apart so that the lanes of a
// warp hit distinct banks); one thread per (row, slice, j2, half of the
// ka) holds its 16 inputs in registers and writes 8 mid-twiddled outputs
// back over them; one thread per (row, slice, ka) then does an 8-point
// DFT in registers; the block stores whole rows of its chunk (16-byte
// stores).  The tables (W16 with 1/128 folded in, the mid twiddle, W8,
// and the outer twiddle T) are built in float64 on the host and rounded
// once (ops/cuda_probes.py: fac_tables).  The TPU's layout A ((B, 16,
// 64), j1 in sublanes) was a Mosaic workaround and is not ported: the
// kernel reads and writes natural (b, n) planes in K13's bin order.
//
// K14c, three twins of tools/probe_store.py: _call, which asked on the
// TPU whether K1's per-slice stores, not its contraction, kept it off
// K12's copy ceiling:
//   slicestore_kernel  (_slicestore_kernel): a copy whose block walks
//     its rows' chunk in 128-column slices, storing one slice of each row
//     a pass (512 B a row a pass), as K13 stores.  Its first design,
//     slicestore_sync_kernel (gdsp_slicestore_sync, kept as the
//     yardstick), loads and stores one slice at a time, one warp a row;
//     the redesign keeps the grid and the walk and issues every slice's
//     loads of the warp's chunk before its first store (slice_walk.cuh,
//     the walk slice8_kernel runs in anatomy_probe_kernels.cu, whose
//     header says why);
//   concatstore_kernel (_concatstore_kernel): a copy whose block loads its
//     rows' chunk slice by slice into shared memory, then stores whole
//     rows of the chunk (16 B a thread, one row's 4 KB a pass);
//   gmm_concat_kernel  (_gmm_concat_kernel): K13's contraction, every
//     slice of a 16-row tile waiting on chip and leaving as whole rows, on
//     a thread-block cluster of min(n1, 8) CTAs a 1024-column chunk, a CTA
//     a slice (lane_contract.cuh: G[k1] resident, 4 x 4 register tiles).
//     As many clusters as the card holds walk the chunk's tiles; a CTA's
//     slice of the next tile arrives by cp.async in a second buffer while
//     it contracts the current one, its outputs overwrite its inputs, and
//     after a cluster barrier each CTA stores its share of the tile's rows
//     as whole rows read from every CTA's buffer over distributed shared
//     memory (cluster_group::map_shared_rank): the probe's concat store at
//     the cluster's scale.  Each output is the same chain of fmaf over i2
//     = 0..127 as in K13, so the result equals K13's bit for bit.  Two
//     16-row buffers (33 KB at a pitch of 132 words) beside G (192 KB)
//     take 230,400 of a CTA's 232,448 bytes.
//   gmm_concat_stream_kernel: gmm_concat's first design, kept as the
//     redesign's yardstick: one block covers every slice of a 16-row tile,
//     the tile waits in shared memory (128 KB) and G[k1] streams through
//     32 rows of i2 at a time (48 KB from L2, again every tile); equal to
//     the redesign.
// Bounds on the H100 at 1024 x 16384: the copies 268 MB, 0.080 ms
// (bytes); gmm_concat K13's 768 x 2^24 = 1.29e10 operations, 0.192 ms.
// The copies' design keeps K12's bytes and changes only the order of the
// stores; gmm_concat keeps K13's arithmetic and changes where its outputs
// wait, how G arrives and the register tiles.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fft_block.cuh"
#include "lane_contract.cuh"
#include "slice_walk.cuh"

namespace cg = cooperative_groups;
namespace ln = gdsp::lane;

namespace {

constexpr int kLanes = 128;
constexpr int kChunk = 1024;  // columns a block: eight slices
constexpr int kThreads = 256;

// K14b
constexpr int kFacRows = 2;   // rows a block: 128 threads a row
constexpr int kSS = 136;      // floats a slice in shared memory
constexpr int kFacTab = 896;  // w16r, w16i (16 x 16), tmr, tmi (8 x 16), w8r, w8i (8 x 8)
constexpr int kW16i = 256, kTmr = 512, kTmi = 640, kW8r = 768, kW8i = 832;

// K14c
constexpr int kStoreRows = 8;  // one warp a row
constexpr int kGcRows = 16;    // gmm_concat: 2 rows a warp
constexpr int kPlane = kLanes * kLanes;
constexpr int kConcatSmem = 2 * kStoreRows * kChunk * sizeof(float);
constexpr int kGcSteps = 32;   // rows i2 of G[k1] staged a step: 3 planes, 48 KB
constexpr int kGcSmem = (2 * kGcRows * kChunk + 3 * kGcSteps * kLanes) * sizeof(float);

struct Chunk {
  int c0, cols, slices;
};

__device__ __forceinline__ Chunk chunk_of(int n) {
  Chunk c;
  c.c0 = blockIdx.x * kChunk;
  c.cols = n - c.c0 < kChunk ? n - c.c0 : kChunk;
  c.slices = c.cols / kLanes;
  return c;
}

// tab: the kFacTab small tables, then T's real and imaginary planes (n each).
__global__ void __launch_bounds__(kThreads)
fac_dft_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
               float* __restrict__ yr, float* __restrict__ yi, const float* __restrict__ tab,
               long long b, int n) {
  __shared__ float sw[kFacTab];
  __shared__ __align__(16) float sr[kFacRows * 8 * kSS];
  __shared__ __align__(16) float si[kFacRows * 8 * kSS];
  const Chunk ch = chunk_of(n);
  const float* twr = tab + kFacTab;
  const float* twi = twr + n;
  for (int e = threadIdx.x; e < kFacTab; e += kThreads) sw[e] = __ldg(tab + e);

  const int r = threadIdx.x >> 7;  // row of the tile
  const int w = threadIdx.x & 127;
  const int base_r = r * 8 * kSS;
  const int quads = ch.cols / 4;
  const long long tiles = (b + kFacRows - 1) / kFacRows;
  for (long long tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const long long r0 = tile * kFacRows;
    __syncthreads();  // the previous tile's stores are done (and the tables staged)
    for (int e = threadIdx.x; e < kFacRows * quads; e += kThreads) {
      const int rr = e / quads, c = 4 * (e % quads);
      float4 vr = make_float4(0.f, 0.f, 0.f, 0.f), vi = vr;
      if (r0 + rr < b) {
        const size_t off = static_cast<size_t>(r0 + rr) * n + ch.c0 + c;
        const float4 ar = __ldg(reinterpret_cast<const float4*>(xr + off));
        const float4 ai = __ldg(reinterpret_cast<const float4*>(xi + off));
        const float4 tr = __ldg(reinterpret_cast<const float4*>(twr + ch.c0 + c));
        const float4 ti = __ldg(reinterpret_cast<const float4*>(twi + ch.c0 + c));
        vr = make_float4(ar.x * tr.x - ai.x * ti.x, ar.y * tr.y - ai.y * ti.y,
                         ar.z * tr.z - ai.z * ti.z, ar.w * tr.w - ai.w * ti.w);
        vi = make_float4(ar.x * ti.x + ai.x * tr.x, ar.y * ti.y + ai.y * tr.y,
                         ar.z * ti.z + ai.z * tr.z, ar.w * ti.w + ai.w * tr.w);
      }
      const int at = rr * 8 * kSS + (c >> 7) * kSS + (c & 127);
      *reinterpret_cast<float4*>(sr + at) = vr;
      *reinterpret_cast<float4*>(si + at) = vi;
    }
    __syncthreads();

    // Stage 1: thread (r, s, j2, half): the 16-point DFT over j1 of column
    // j2, outputs ka = 8 half .. 8 half + 7, mid-twiddled, written over the
    // column's inputs at 8 ka + j2.
    {
      const int j2 = w & 7, half = (w >> 3) & 1, s = w >> 4;
      const bool on = s < ch.slices;
      const int at = base_r + s * kSS + j2;
      float ar[16], ai[16];
      if (on) {
#pragma unroll
        for (int j1 = 0; j1 < 16; ++j1) {
          ar[j1] = sr[at + 8 * j1];
          ai[j1] = si[at + 8 * j1];
        }
      }
      __syncthreads();
      if (on) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int ka = 8 * half + q;
          float ur = 0.f, ui = 0.f;
#pragma unroll
          for (int j1 = 0; j1 < 16; ++j1) {
            const float wr = sw[j1 * 16 + ka], wi = sw[kW16i + j1 * 16 + ka];
            ur = fmaf(ar[j1], wr, fmaf(-ai[j1], wi, ur));
            ui = fmaf(ar[j1], wi, fmaf(ai[j1], wr, ui));
          }
          const float mr = sw[kTmr + j2 * 16 + ka], mi = sw[kTmi + j2 * 16 + ka];
          sr[at + 8 * ka] = ur * mr - ui * mi;
          si[at + 8 * ka] = ur * mi + ui * mr;
        }
      }
      __syncthreads();
    }
    // Stage 2: thread (r, s, ka): the 8-point DFT over j2 of row ka, bins
    // ka + 16 kb, natural order.
    {
      const int ka = w & 15, s = w >> 4;
      const bool on = s < ch.slices;
      const int at = base_r + s * kSS;
      float br[8], bi[8];
      if (on) {
#pragma unroll
        for (int j2 = 0; j2 < 8; ++j2) {
          br[j2] = sr[at + 8 * ka + j2];
          bi[j2] = si[at + 8 * ka + j2];
        }
      }
      __syncthreads();
      if (on) {
#pragma unroll
        for (int kb = 0; kb < 8; ++kb) {
          float yr8 = 0.f, yi8 = 0.f;
#pragma unroll
          for (int j2 = 0; j2 < 8; ++j2) {
            const float wr = sw[kW8r + j2 * 8 + kb], wi = sw[kW8i + j2 * 8 + kb];
            yr8 = fmaf(br[j2], wr, fmaf(-bi[j2], wi, yr8));
            yi8 = fmaf(br[j2], wi, fmaf(bi[j2], wr, yi8));
          }
          sr[at + ka + 16 * kb] = yr8;
          si[at + ka + 16 * kb] = yi8;
        }
      }
      __syncthreads();
    }
    for (int e = threadIdx.x; e < kFacRows * quads; e += kThreads) {
      const int rr = e / quads, c = 4 * (e % quads);
      if (r0 + rr >= b) continue;
      const size_t off = static_cast<size_t>(r0 + rr) * n + ch.c0 + c;
      const int at = rr * 8 * kSS + (c >> 7) * kSS + (c & 127);
      *reinterpret_cast<float4*>(yr + off) = *reinterpret_cast<const float4*>(sr + at);
      *reinterpret_cast<float4*>(yi + off) = *reinterpret_cast<const float4*>(si + at);
    }
  }
}

// slicestore redesigned: the first design's grid and walk, every slice's
// loads of the warp's row chunk issued before its first store
// (slice_walk.cuh, as slice8_kernel), then the slices stored one at a time.
__global__ void __launch_bounds__(kThreads)
slicestore_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                  float* __restrict__ yr, float* __restrict__ yi, long long b, int n) {
  gdsp::slice_walk::walk(xr, xi, yr, yi, b, n, gdsp::slice_walk::Identity{});
}

// slicestore's first design, the yardstick: a slice's load and store in turn.
__global__ void __launch_bounds__(kThreads)
slicestore_sync_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                       float* __restrict__ yr, float* __restrict__ yi, long long b, int n) {
  const Chunk ch = chunk_of(n);
  const int lane = threadIdx.x & 31;
  const long long tiles = (b + kStoreRows - 1) / kStoreRows;
  for (long long tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const long long row = tile * kStoreRows + (threadIdx.x >> 5);
    if (row >= b) continue;
    for (int s = 0; s < ch.slices; ++s) {
      const size_t off = static_cast<size_t>(row) * n + ch.c0 + s * kLanes + 4 * lane;
      const float4 ar = __ldg(reinterpret_cast<const float4*>(xr + off));
      const float4 ai = __ldg(reinterpret_cast<const float4*>(xi + off));
      *reinterpret_cast<float4*>(yr + off) = ar;
      *reinterpret_cast<float4*>(yi + off) = ai;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
concatstore_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                   float* __restrict__ yr, float* __restrict__ yi, long long b, int n) {
  extern __shared__ float4 smem4[];
  float* sr = reinterpret_cast<float*>(smem4);
  float* si = sr + kStoreRows * kChunk;
  const Chunk ch = chunk_of(n);
  const int lane = threadIdx.x & 31, r = threadIdx.x >> 5;
  const int quads = ch.cols / 4;
  const long long tiles = (b + kStoreRows - 1) / kStoreRows;
  for (long long tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const long long r0 = tile * kStoreRows;
    __syncthreads();  // the previous tile's stores have read shared memory
    if (r0 + r < b) {
      for (int s = 0; s < ch.slices; ++s) {
        const int c = s * kLanes + 4 * lane;
        const size_t off = static_cast<size_t>(r0 + r) * n + ch.c0 + c;
        *reinterpret_cast<float4*>(sr + r * kChunk + c) =
            __ldg(reinterpret_cast<const float4*>(xr + off));
        *reinterpret_cast<float4*>(si + r * kChunk + c) =
            __ldg(reinterpret_cast<const float4*>(xi + off));
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kStoreRows * quads; e += kThreads) {
      const int rr = e / quads, c = 4 * (e % quads);
      if (r0 + rr >= b) continue;
      const size_t off = static_cast<size_t>(r0 + rr) * n + ch.c0 + c;
      *reinterpret_cast<float4*>(yr + off) = *reinterpret_cast<const float4*>(sr + rr * kChunk + c);
      *reinterpret_cast<float4*>(yi + off) = *reinterpret_cast<const float4*>(si + rr * kChunk + c);
    }
  }
}

// g: K13's (n1, 3, 128, 128) tables, plane p of slice k1 at
// g + (3 k1 + p) * kPlane, entry [i2][k2].
__global__ void __launch_bounds__(kThreads, 1)
gmm_concat_stream_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                  float* __restrict__ yr, float* __restrict__ yi, const float* __restrict__ g,
                  long long b, int n) {
  extern __shared__ float4 smem4[];
  float* sxr = reinterpret_cast<float*>(smem4);  // kGcRows x kChunk, inputs then outputs
  float* sxi = sxr + kGcRows * kChunk;
  float* sg = sxi + kGcRows * kChunk;  // 3 planes x kGcSteps rows of G[k1]
  const Chunk ch = chunk_of(n);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int quads = ch.cols / 4;
  const long long tiles = (b + kGcRows - 1) / kGcRows;
  for (long long tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const long long r0 = tile * kGcRows;
    __syncthreads();  // the previous tile's stores have read shared memory
    for (int e = threadIdx.x; e < kGcRows * quads; e += kThreads) {
      const int rr = e / quads, c = 4 * (e % quads);
      float4 vr = make_float4(0.f, 0.f, 0.f, 0.f), vi = vr;
      if (r0 + rr < b) {
        const size_t off = static_cast<size_t>(r0 + rr) * n + ch.c0 + c;
        vr = __ldg(reinterpret_cast<const float4*>(xr + off));
        vi = __ldg(reinterpret_cast<const float4*>(xi + off));
      }
      *reinterpret_cast<float4*>(sxr + rr * kChunk + c) = vr;
      *reinterpret_cast<float4*>(sxi + rr * kChunk + c) = vi;
    }
    for (int s = 0; s < ch.slices; ++s) {
      const float* gs0 = g + static_cast<size_t>((ch.c0 / kLanes) + s) * 3 * kPlane;
      float m1[2][4], m2[2][4], m3[2][4];  // [row warp + 8 j][bin lane + 32 q]
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) m1[j][q] = m2[j][q] = m3[j][q] = 0.f;
      }
      for (int i0 = 0; i0 < kLanes; i0 += kGcSteps) {
        __syncthreads();  // the last step's G is read (and the tile is staged)
        for (int e = threadIdx.x; e < 3 * kGcSteps * kLanes / 4; e += kThreads) {
          const int p = e / (kGcSteps * kLanes / 4), r = e % (kGcSteps * kLanes / 4);
          reinterpret_cast<float4*>(sg)[e] =
              __ldg(reinterpret_cast<const float4*>(gs0 + p * kPlane + i0 * kLanes) + r);
        }
        __syncthreads();
#pragma unroll 4
        for (int ii = 0; ii < kGcSteps; ++ii) {
          const int i2 = i0 + ii;
          float ar[2], ai[2], as[2], gr[4], gi[4], gsum[4];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            ar[j] = sxr[(warp + 8 * j) * kChunk + s * kLanes + i2];
            ai[j] = sxi[(warp + 8 * j) * kChunk + s * kLanes + i2];
            as[j] = ar[j] + ai[j];
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int k = ii * kLanes + lane + 32 * q;
            gr[q] = sg[k];
            gi[q] = sg[kGcSteps * kLanes + k];
            gsum[q] = sg[2 * kGcSteps * kLanes + k];
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              m1[j][q] = fmaf(ar[j], gr[q], m1[j][q]);
              m2[j][q] = fmaf(ai[j], gi[q], m2[j][q]);
              m3[j][q] = fmaf(as[j], gsum[q], m3[j][q]);
            }
          }
        }
      }
      __syncthreads();  // every warp has read slice s of its rows
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int at = (warp + 8 * j) * kChunk + s * kLanes + lane + 32 * q;
          sxr[at] = m1[j][q] - m2[j][q];
          sxi[at] = m3[j][q] - m1[j][q] - m2[j][q];
        }
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kGcRows * quads; e += kThreads) {
      const int rr = e / quads, c = 4 * (e % quads);
      if (r0 + rr >= b) continue;
      const size_t off = static_cast<size_t>(r0 + rr) * n + ch.c0 + c;
      *reinterpret_cast<float4*>(yr + off) = *reinterpret_cast<const float4*>(sxr + rr * kChunk + c);
      *reinterpret_cast<float4*>(yi + off) = *reinterpret_cast<const float4*>(sxi + rr * kChunk + c);
    }
  }
}

// ---------------------------------------------------------------------------
// gmm_concat on a thread-block cluster
// ---------------------------------------------------------------------------

// Rows of tile `tile` and columns c0 .. c0 + 127 of both planes into buf
// (two planes at ln::kPitch) by cp.async, rows past b zero: 8 copies of 16
// bytes a thread.  The caller commits.
__device__ __forceinline__ void load_slice(float* buf, const float* __restrict__ xr,
                                           const float* __restrict__ xi, long long b, int n,
                                           long long tile, int c0) {
  constexpr int kQuads = ln::kLanes / 4;
  for (int e = threadIdx.x; e < 2 * ln::kTileRows * kQuads; e += ln::kThreads) {
    const int plane = e / (ln::kTileRows * kQuads);
    const int r = (e / kQuads) % ln::kTileRows, q = e % kQuads;
    const long long row = tile * ln::kTileRows + r;
    const bool valid = row < b;
    const size_t off = valid ? static_cast<size_t>(row) * n + c0 + 4 * q : 0;
    const float* src = (plane ? xi : xr) + off;
    ln::cp_async16(buf + plane * ln::kTileWords + r * ln::kPitch + 4 * q, src, valid);
  }
}

// Cluster cl of the grid serves 1024-column chunk cl % chunks and its row
// tiles first, first + per_chunk, ... (first = cl / chunks); CTA `rank`
// holds G[k1] of slice k1 = 8 chunk + rank for its whole life (a rank past
// a ragged chunk's slices only stores).  Tile buffers alternate: tile i
// arrives in buffer i & 1 while tile i - 1 is contracted, its outputs
// overwrite its inputs there, and while tile i + 1 is contracted every CTA
// stores its rows of tile i as whole rows, gathered from the cluster's
// buffers.  The contraction's i2 loop runs in three segments with the
// barriers' waits between them, so no wait is on the critical path:
//   [0, 32)   then wait (tile i - 1 out everywhere), gather its rows,
//             arrive (relaxed: only reads to order);
//   [32, 96)  then wait (every CTA gathered), load tile i + 1 into the
//             freed buffer;
//   [96, 128) then the outputs over the inputs, arrive.
// (Holding the gather's loads in registers across [0, 32), with tile i + 1
// loaded after [0, 64), measured slower on the H100: PERF.md, section 6.)
__global__ void __launch_bounds__(ln::kThreads, 1)
gmm_concat_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                  float* __restrict__ yr, float* __restrict__ yi, const float* __restrict__ g,
                  long long b, int n, int per_chunk) {
  extern __shared__ float4 smem4[];
  float* sg = reinterpret_cast<float*>(smem4);  // G[k1]: three planes
  float* bufs = sg + 3 * ln::kPlane;            // two tile buffers of two planes
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int chunks = (n + ln::kChunk - 1) / ln::kChunk;
  const long long cl = blockIdx.x / cs;
  const int chunk = static_cast<int>(cl % chunks);
  const long long first = cl / chunks;
  const int c0 = chunk * ln::kChunk;
  const int cols = n - c0 < ln::kChunk ? n - c0 : ln::kChunk;
  const bool live = rank < cols / ln::kLanes;
  const int cr = c0 + rank * ln::kLanes;  // this CTA's slice
  const long long tiles = (b + ln::kTileRows - 1) / ln::kTileRows;
  const long long steps = first < tiles ? (tiles - 1 - first) / per_chunk + 1 : 0;
  const ln::Place pl = ln::place();

  if (live && steps > 0) {
    ln::stage_g(sg, g + static_cast<size_t>(cr / ln::kLanes) * 3 * ln::kPlane);
    load_slice(bufs, xr, xi, b, n, first, cr);
  }
  ln::cp_async_commit();
  for (long long i = 0; i < steps; ++i) {
    const long long tile = first + i * per_chunk;
    float* cur = bufs + (i & 1) * 2 * ln::kTileWords;
    float* other = bufs + ((i + 1) & 1) * 2 * ln::kTileWords;
    ln::cp_async_wait_all();
    __syncthreads();  // tile i (and G) staged
    ln::Acc acc;
    ln::zero(acc);
    if (live) ln::contract<0, 32>(acc, cur, cur + ln::kTileWords, sg, pl.row, pl.bin);
    if (i > 0) {
      ln::cluster_wait();  // tile i - 1's outputs wait in every CTA's `other`
      ln::gather_rows(other, yr, yi, b, n, tile - per_chunk, c0, cols, rank, cs);
      ln::cluster_arrive_relaxed();  // done reading the cluster's `other`
    }
    if (live) ln::contract<32, 96>(acc, cur, cur + ln::kTileWords, sg, pl.row, pl.bin);
    if (i > 0) ln::cluster_wait();  // every CTA has read `other`
    if (live && i + 1 < steps) load_slice(other, xr, xi, b, n, tile + per_chunk, cr);
    ln::cp_async_commit();
    if (live) ln::contract<96, 128>(acc, cur, cur + ln::kTileWords, sg, pl.row, pl.bin);
    __syncthreads();  // every thread has read `cur`
    if (live) ln::put_outputs(cur, acc, pl, ln::kTileRows);
    ln::cluster_arrive();  // this slice of tile i waits in `cur`
  }
  if (steps > 0) {
    ln::cluster_wait();
    ln::gather_rows(bufs + ((steps - 1) & 1) * 2 * ln::kTileWords, yr, yi, b, n,
                    first + (steps - 1) * per_chunk, c0, cols, rank, cs);
    ln::cluster_arrive_relaxed();
    ln::cluster_wait();  // no CTA leaves while another reads its shared memory
  }
}

bool bad_shape(long long b, int n) { return b < 0 || n < kLanes || n % kLanes != 0; }

dim3 tile_grid(int n, long long b, int rows) {
  const long long tiles = (b + rows - 1) / rows;
  return dim3((n + kChunk - 1) / kChunk, static_cast<unsigned>(tiles < 65535 ? tiles : 65535));
}

}  // namespace

extern "C" {

// Each entry: (b, n) float32 planes, n % 128 == 0, every pointer 16-byte
// aligned.  Returns cudaGetLastError(), or cudaErrorInvalidValue for a
// shape the kernel does not take.

// K14b: tab = the kFacTab small tables, then T's two planes of n floats.
int gdsp_fac_dft(const float* xr, const float* xi, float* yr, float* yi, const float* tab,
                 long long b, int n, void* stream) {
  if (bad_shape(b, n)) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  fac_dft_kernel<<<tile_grid(n, b, kFacRows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xr, xi, yr, yi, tab, b, n);
  return static_cast<int>(cudaGetLastError());
}

// The redesign, slicestore_kernel, on the first design's grid.
int gdsp_slicestore(const float* xr, const float* xi, float* yr, float* yi, long long b, int n,
                    void* stream) {
  if (bad_shape(b, n)) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  slicestore_kernel<<<gdsp::slice_walk::grid(b, n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(xr, xi, yr, yi, b, n);
  return static_cast<int>(cudaGetLastError());
}

// The first design, the yardstick: slicestore_sync_kernel.
int gdsp_slicestore_sync(const float* xr, const float* xi, float* yr, float* yi, long long b,
                         int n, void* stream) {
  if (bad_shape(b, n)) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  slicestore_sync_kernel<<<tile_grid(n, b, kStoreRows), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(xr, xi, yr, yi, b, n);
  return static_cast<int>(cudaGetLastError());
}

int gdsp_concatstore(const float* xr, const float* xi, float* yr, float* yi, long long b, int n,
                     void* stream) {
  if (bad_shape(b, n)) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  cudaError_t e = gdsp::allow_smem(concatstore_kernel, kConcatSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  concatstore_kernel<<<tile_grid(n, b, kStoreRows), kThreads, kConcatSmem,
                       static_cast<cudaStream_t>(stream)>>>(xr, xi, yr, yi, b, n);
  return static_cast<int>(cudaGetLastError());
}

// gmm_concat's first design, the yardstick: g K13's (n / 128, 3, 128, 128)
// tables.
int gdsp_gmm_concat_stream(const float* xr, const float* xi, float* yr, float* yi,
                           const float* g, long long b, int n, void* stream) {
  if (bad_shape(b, n)) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  cudaError_t e = gdsp::allow_smem(gmm_concat_stream_kernel, kGcSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  gmm_concat_stream_kernel<<<tile_grid(n, b, kGcRows), kThreads, kGcSmem,
                             static_cast<cudaStream_t>(stream)>>>(xr, xi, yr, yi, g, b, n);
  return static_cast<int>(cudaGetLastError());
}

// gmm_concat on clusters: g K13's (n / 128, 3, 128, 128) tables; resident
// the clusters of the kernel the card holds at once (gdsp_gmm_concat_resident).
// Returns cudaErrorLaunchOutOfResources where resident < 1.
int gdsp_gmm_concat(const float* xr, const float* xi, float* yr, float* yi, const float* g,
                    long long b, int n, int resident, void* stream) {
  ln::Plan p;
  const int rc = ln::make_plan(ln::kGmmConcat, b, n, 0, 0, 0, resident, &p);
  if (rc != 0) return rc;
  if (b == 0) return 0;
  cudaError_t e = gdsp::allow_smem(gmm_concat_kernel, static_cast<size_t>(p.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  ln::ClusterLaunch l(p.cluster, p.ctas, static_cast<size_t>(p.smem),
                      static_cast<cudaStream_t>(stream));
  e = cudaLaunchKernelEx(&l.cfg, gmm_concat_kernel, xr, xi, yr, yi, g, b, n,
                         p.clusters / p.chunks);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of gmm_concat_kernel at n points (min(n / 128, 8) CTAs a
// cluster) the card holds at once with the plan's shared memory plus
// extra_smem bytes a CTA: 0 where none fits, or -(CUDA error).
int gdsp_gmm_concat_resident(int n, int extra_smem) {
  if (n < kLanes || n % kLanes != 0) return -static_cast<int>(cudaErrorInvalidValue);
  const int n1 = n / kLanes;
  return ln::resident_clusters(gmm_concat_kernel, n1 < ln::kMaxCluster ? n1 : ln::kMaxCluster,
                               ln::kSmem + extra_smem);
}

// The cluster plan of gmm_concat (kind 0) or ls_full (kind 1) at b x n
// with ls_full's settings and `resident` clusters the card holds:
// out[0..9] = cluster, clusters, CTAs, rows a tile, tiles a unit, tile
// buffers, shared bytes, store_rows, chunk_rows, 1024-column chunks
// (lane_contract.cuh: Plan).  ops/cuda_probes.py: lane_cluster_plan holds
// the same; the GPU tests compare.
int gdsp_lane_cluster_geometry(int kind, long long b, int n, int rows_per_block, int chunk_rows,
                               int store_rows, int resident, int* out) {
  ln::Plan p;
  const int rc = ln::make_plan(kind, b, n, rows_per_block, chunk_rows, store_rows, resident, &p);
  if (rc != 0) return rc;
  ln::plan_fields(p, out);
  return 0;
}

}  // extern "C"
