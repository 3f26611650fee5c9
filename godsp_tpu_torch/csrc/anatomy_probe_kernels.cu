// K14d: the anatomy twins for Hopper (sm_90a), the data-movement and
// matrix-unit idioms of tools/probe_anatomy2.py: run_kernel_variant (:60),
// whose one pl.pallas_call (:87) wraps seven bodies.  They run under
// godsp_tpu_torch/probes/anatomy2.py.  Every kernel takes two float32
// planes (b, n), n = n1 x 128, contiguous and 16-byte aligned, and writes
// two new planes of the same shape.  The first body, v0copy (:124), is K12
// (metrics_kernels.cu: copy_split_kernel) and is not repeated here.
//
// half3_kernel replaces v1half3 (:128): three rounds of a <- [u + v, u - v]
// with u, v the two halves of the row (h = n / 2 every round: the concat
// restores the width), both planes.  Bound on the H100 at 16384 x 1024:
// 268 MB of traffic, 0.080 ms at 3.35 TB/s (6 operations a point: 0.015
// ms at 67 TFLOP/s): bytes.  Design: a block stages whole rows of both
// planes in shared memory (16-byte loads; rows n + 4 floats apart), runs
// the three butterfly passes there, each behind a barrier, as a stage of
// K1 (fft_block.cuh: block_fft_rows) does, and stores whole rows.  Each
// value is the same IEEE add or subtract as the plain version's, in the
// same order, so the result equals it bit for bit.
//
// slice8_kernel replaces v2slice8 (:140) and add_one_kernel<true>
// v3reshape (:148): x + 1, both planes.  Bound: bytes, 0.080 ms (2
// operations a point).  The reshape map reads the planes as a (b n / 128,
// 128) view, one warp a 128-float row, 16 B a thread.  The slice map walks
// a row's chunk of up to 1024 columns one 128-column slice a pass, one
// warp a row, eight rows a block.  Its first design, add_one_kernel<false>
// (gdsp_slice8_add_sync, kept as the yardstick), is the reshape map's body
// in a loop over the slices, and took 0.127 ms by chain where the reshape
// map took 0.092.  As compiled (probes/slice8.py reads the SASS) the loop
// is unrolled by four; a slice's two 16-byte loads issue only after the
// previous slice's stores, each float4 is stored as four 4-byte stores,
// and at 40 registers a SM holds 6 blocks: 48 KB of loads in flight a SM.
// No one of these costs much alone (probes/slice8.py's variants: 16-byte
// stores, or the loop not unrolled, at 8 blocks a SM 0.095-0.096 ms, at 6
// blocks 0.097; the reshape map stores 4 bytes at a time too), together
// they cost a third.  slice8_kernel keeps the grid and the walk and
// issues every slice's loads of the warp's chunk before its first add and
// store: 16 loads a thread, at 80 registers 3 blocks and 192 KB of loads a
// SM in flight, stored 16 bytes at a time; it runs at the reshape map's
// speed.  Each value is one IEEE float32 add, as in the plain version, so
// both designs equal it bit for bit.
//
// bd_tf32_kernel replaces v4bd1 (:176): each plane's 128-point slices times
// Re F128 (F[j, k] = exp(-2 pi i j k / 128), unscaled) in ONE TF32 pass on
// the tensor cores, the card's counterpart of the TPU's DEFAULT-precision
// (one bf16 pass) matmul.  The TPU multiplies the zeros of the 1024 x 1024
// block-diagonal matrix too; here each slice meets its 128 x 128 block
// only.  mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 by inline PTX,
// both operands rounded by cvt.rna.tf32.f32 (the table as it is staged in
// shared memory, 128 rows 136 words apart so that a B fragment's 32 reads
// fall in 32 banks), float32 accumulation.  A warp owns a 16-row tile of
// one slice: 16 k-steps of 8, each one A fragment read from device memory
// and 16 mma over the slice's 128 outputs.  The table is an argument:
// Re F128 by default, any (128, 128) table for the fragment-map checks
// (the identity returns round_tf32(x); a cyclic shift shows the B map).
// Bound: bytes, 0.080 ms (512 TF32 operations a point: 0.017 ms at 495
// TFLOP/s).  This is the port's only TF32 path, on purpose: it measures
// what one reduced-precision pass costs; nothing at the 120 dB bar uses it.
//
// bd_hi_kernel replaces v5bd_hi (:190): the complex product (a + i b)(F_r +
// i F_i) of every slice at float32 accuracy (the 128-point DFT, unscaled)
// by Karatsuba, m1 = a F_r, m2 = b F_i, m3 = (a + b)(F_r + F_i), yr = m1 - m2,
// yi = m3 - m1 - m2, each product in 3xTF32: big = cvt.rna(x), small =
// cvt.rna(x - big), product = small big + big small + big big (small terms
// first), where the TPU's HIGHEST made six bf16 limb passes; each k-step's
// products are summed on the tensor cores from zero and added to the
// running sum on the CUDA cores in IEEE float32.  Bound: bytes, 0.080 ms
// (its products are 2304 TF32 operations a point on the tensor cores,
// 0.078 ms at 495 TFLOP/s; K13 does the same function as 768 float32
// operations a point on the CUDA cores).  Design: the three F planes' big and small halves
// (six tables) would take 384 KB as 128 x 128 matrices; since F[j, k]
// depends on j k mod 128 only, they are six 128-entry vectors (3 KB of
// shared memory), split on the host from float64 (ops/cuda_probes.py:
// hi_tables), and a B fragment reads entry (j k) & 127.  A warp owns a
// 16-row tile of one slice, 64 output columns at a time (m1, m2, m3: 96
// accumulators a thread); A fragments come from device memory and are
// split in registers.
//
// anat_full_kernel replaces v6full (:203): half3, then ar = a tw - b tw and
// ai = a tw + b tw with a row tw of n floats (the TPU probe's random row,
// not a twiddle), then bd_hi's contraction, in one kernel: the block stages
// min(16, 16384 / n) whole rows of both planes in shared memory (128 KB),
// runs half3's rounds and the tw row there (the same device functions),
// and its warps read their A fragments from shared memory: nothing goes
// back to device memory between the steps.  Bound: bytes, 0.080 ms
// (bd_hi's 2304 TF32 operations a point, 0.078 ms, and 10 float32 ones
// for the rounds and the row on the CUDA cores, 0.0025 ms).

#include <cuda_runtime.h>

#include <cstdint>

#include "fft_block.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kChunk = 1024;  // columns a block of the slice map: eight slices
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 4;           // floats past each staged row (bank spread, 16-byte rows)
constexpr int kHalfPoints = 8192;  // points of a plane a half3 block stages
constexpr int kFullPoints = 16384;  // points of a plane an anat_full block stages
constexpr int kMaxN = 16384;      // widest row half3 and anat_full stage
constexpr int kFS = 136;          // words a row of the staged TF32 table
constexpr int kTf32Smem = kLanes * kFS * sizeof(float);
constexpr int kHiTab = 6 * kLanes;  // r big, r small, i big, i small, s big, s small

// ---------------------------------------------------------------------------
// Staged rows: half3 and anat_full
// ---------------------------------------------------------------------------

// Rows r0 .. r0 + R - 1 of both planes into sr/si (row stride n + kPad),
// zeros past row b.
__device__ __forceinline__ void stage_rows(const float* __restrict__ xr,
                                           const float* __restrict__ xi, float* sr, float* si,
                                           long long r0, int R, long long b, int n) {
  const int quads = n / 4, S = n + kPad;
  for (int e = threadIdx.x; e < R * quads; e += blockDim.x) {
    const int rr = e / quads, c = 4 * (e % quads);
    float4 vr = make_float4(0.f, 0.f, 0.f, 0.f), vi = vr;
    if (r0 + rr < b) {
      const size_t off = static_cast<size_t>(r0 + rr) * n + c;
      vr = __ldg(reinterpret_cast<const float4*>(xr + off));
      vi = __ldg(reinterpret_cast<const float4*>(xi + off));
    }
    *reinterpret_cast<float4*>(sr + rr * S + c) = vr;
    *reinterpret_cast<float4*>(si + rr * S + c) = vi;
  }
}

__device__ __forceinline__ void store_rows(const float* sr, const float* si, float* __restrict__ yr,
                                           float* __restrict__ yi, long long r0, int R,
                                           long long b, int n) {
  const int quads = n / 4, S = n + kPad;
  for (int e = threadIdx.x; e < R * quads; e += blockDim.x) {
    const int rr = e / quads, c = 4 * (e % quads);
    if (r0 + rr >= b) continue;
    const size_t off = static_cast<size_t>(r0 + rr) * n + c;
    *reinterpret_cast<float4*>(yr + off) = *reinterpret_cast<const float4*>(sr + rr * S + c);
    *reinterpret_cast<float4*>(yi + off) = *reinterpret_cast<const float4*>(si + rr * S + c);
  }
}

// Three rounds of a <- [u + v, u - v], h = n / 2 each round, in place over R
// staged rows of both planes.  The caller synchronizes after staging; ends
// synchronized.
__device__ __forceinline__ void half3_rounds(float* sr, float* si, int R, int n) {
  const int h = n / 2, S = n + kPad;
  for (int round = 0; round < 3; ++round) {
    for (int e = threadIdx.x; e < R * h; e += blockDim.x) {
      const int at = (e / h) * S + e % h;
      const float ur = sr[at], vr = sr[at + h];
      const float ui = si[at], vi = si[at + h];
      sr[at] = ur + vr;
      sr[at + h] = ur - vr;
      si[at] = ui + vi;
      si[at + h] = ui - vi;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
half3_kernel(const float* __restrict__ xr, const float* __restrict__ xi, float* __restrict__ yr,
             float* __restrict__ yi, long long b, int n, int R) {
  extern __shared__ float4 smem4[];
  float* sr = reinterpret_cast<float*>(smem4);
  float* si = sr + R * (n + kPad);
  const long long tiles = (b + R - 1) / R;
  for (long long tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const long long r0 = tile * R;
    __syncthreads();  // the previous tile's stores have read shared memory
    stage_rows(xr, xi, sr, si, r0, R, b, n);
    __syncthreads();
    half3_rounds(sr, si, R, n);
    store_rows(sr, si, yr, yi, r0, R, b, n);
  }
}

// ---------------------------------------------------------------------------
// x + 1: the slice map and the reshape map
// ---------------------------------------------------------------------------

__device__ __forceinline__ void add_one4(const float* __restrict__ xr,
                                         const float* __restrict__ xi, float* __restrict__ yr,
                                         float* __restrict__ yi, size_t off) {
  float4 a = __ldg(reinterpret_cast<const float4*>(xr + off));
  float4 c = __ldg(reinterpret_cast<const float4*>(xi + off));
  a = make_float4(a.x + 1.f, a.y + 1.f, a.z + 1.f, a.w + 1.f);
  c = make_float4(c.x + 1.f, c.y + 1.f, c.z + 1.f, c.w + 1.f);
  *reinterpret_cast<float4*>(yr + off) = a;
  *reinterpret_cast<float4*>(yi + off) = c;
}

// kReshape false: grid (chunks, row tiles), one warp a row, a slice a pass.
// kReshape true: a 1-D grid striding over the (b n / 128, 128) view, one
// warp a 128-float row.
template <bool kReshape>
__global__ void __launch_bounds__(kThreads)
add_one_kernel(const float* __restrict__ xr, const float* __restrict__ xi, float* __restrict__ yr,
               float* __restrict__ yi, long long b, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if constexpr (kReshape) {
    const long long rows = b * (n / kLanes);
    const long long step = static_cast<long long>(gridDim.x) * kWarps;
    for (long long g = static_cast<long long>(blockIdx.x) * kWarps + warp; g < rows; g += step)
      add_one4(xr, xi, yr, yi, static_cast<size_t>(g) * kLanes + 4 * lane);
  } else {
    const int c0 = blockIdx.x * kChunk;
    const int slices = (n - c0 < kChunk ? n - c0 : kChunk) / kLanes;
    const long long tiles = (b + kWarps - 1) / kWarps;
    for (long long tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
      const long long row = tile * kWarps + warp;
      if (row >= b) continue;
      for (int s = 0; s < slices; ++s)
        add_one4(xr, xi, yr, yi, static_cast<size_t>(row) * n + c0 + s * kLanes + 4 * lane);
    }
  }
}

// The slice map redesigned: add_one_kernel<false>'s grid and walk, every
// slice's loads of the warp's row chunk issued before its first add and
// store, so a warp has 2 x slices 16-byte loads a thread in flight.
__global__ void __launch_bounds__(kThreads)
slice8_kernel(const float* __restrict__ xr, const float* __restrict__ xi, float* __restrict__ yr,
              float* __restrict__ yi, long long b, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * kChunk;
  const int slices = (n - c0 < kChunk ? n - c0 : kChunk) / kLanes;
  const long long tiles = (b + kWarps - 1) / kWarps;
  for (long long tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const long long row = tile * kWarps + warp;
    if (row >= b) continue;
    const size_t at = static_cast<size_t>(row) * n + c0 + 4 * lane;
    float4 a[kChunk / kLanes], c[kChunk / kLanes];
#pragma unroll
    for (int s = 0; s < kChunk / kLanes; ++s)
      if (s < slices) {
        a[s] = __ldg(reinterpret_cast<const float4*>(xr + at + s * kLanes));
        c[s] = __ldg(reinterpret_cast<const float4*>(xi + at + s * kLanes));
      }
#pragma unroll
    for (int s = 0; s < kChunk / kLanes; ++s)
      if (s < slices) {
        *reinterpret_cast<float4*>(yr + at + s * kLanes) =
            make_float4(a[s].x + 1.f, a[s].y + 1.f, a[s].z + 1.f, a[s].w + 1.f);
        *reinterpret_cast<float4*>(yi + at + s * kLanes) =
            make_float4(c[s].x + 1.f, c[s].y + 1.f, c[s].z + 1.f, c[s].w + 1.f);
      }
  }
}

// ---------------------------------------------------------------------------
// The tensor-core contractions: mma.sync m16n8k8 in TF32
// ---------------------------------------------------------------------------
//
// The fragment maps, tf32, mma_tf32, a_values and store_c: mma_tf32.cuh.
using gdsp::a_values;
using gdsp::mma_tf32;
using gdsp::store_c;
using gdsp::tf32;

// table: (128, 128) float32, row j, column k.
__global__ void __launch_bounds__(kThreads)
bd_tf32_kernel(const float* __restrict__ xr, const float* __restrict__ xi, float* __restrict__ yr,
               float* __restrict__ yi, const float* __restrict__ table, long long b, int n) {
  extern __shared__ float4 smem4[];
  uint32_t* sf = reinterpret_cast<uint32_t*>(smem4);
  for (int e = threadIdx.x; e < kLanes * kLanes; e += kThreads)
    sf[(e / kLanes) * kFS + e % kLanes] = tf32(__ldg(table + e));
  __syncthreads();
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int n1 = n / kLanes;
  const long long tasks = (b + 15) / 16 * n1;
  const long long step = static_cast<long long>(gridDim.x) * kWarps;
  for (long long task = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       task < tasks; task += step) {
    const long long r0 = task / n1 * 16;
    const int s = static_cast<int>(task % n1);
    const int rows = b - r0 < 16 ? static_cast<int>(b - r0) : 16;
    const size_t base = static_cast<size_t>(r0) * n + s * kLanes;
    for (int p = 0; p < 2; ++p) {
      const float* x = (p ? xi : xr) + base;
      float* y = (p ? yi : yr) + base;
      float acc[16][4];
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll 2
      for (int ks = 0; ks < 16; ++ks) {
        float v[4];
        a_values(v, x, n, rows, 8 * ks);
        const uint32_t a[4] = {tf32(v[0]), tf32(v[1]), tf32(v[2]), tf32(v[3])};
        const uint32_t* f0 = sf + (8 * ks + t) * kFS + g;
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) mma_tf32(acc[nt], a, f0[8 * nt], f0[4 * kFS + 8 * nt]);
      }
#pragma unroll
      for (int nt = 0; nt < 16; ++nt)
        store_c(y, n, rows, 8 * nt + 2 * t, acc[nt][0], acc[nt][1], acc[nt][2], acc[nt][3]);
    }
  }
}

// x = big + small in TF32, both rounded to nearest, ties away.
__device__ __forceinline__ void split(const float (&v)[4], uint32_t (&big)[4],
                                      uint32_t (&small)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    big[i] = tf32(v[i]);
    small[i] = tf32(v[i] - __uint_as_float(big[i]));
  }
}

// One k-step of a 3xTF32 product: c += (a_big + a_small)(b_big + b_small)
// without the small-small term, small terms first.  The tensor cores sum
// the step's 24 products from zero; the running sum over the k-steps is
// an IEEE float32 add on the CUDA cores (the tensor cores' own
// accumulation, which truncates, cost ~10 dB over a 3 x 16-step chain).
// tab: a big vector, its small vector 128 words on; i0, i1: the entries
// of b0 and b1.
__device__ __forceinline__ void step_3xtf32(float (&c)[4], const uint32_t (&abig)[4],
                                            const uint32_t (&asmall)[4], const uint32_t* tab,
                                            int i0, int i1) {
  const uint32_t b0 = tab[i0], b1 = tab[i1];
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(p, asmall, b0, b1);
  mma_tf32(p, abig, tab[kLanes + i0], tab[kLanes + i1]);
  mma_tf32(p, abig, b0, b1);
#pragma unroll
  for (int q = 0; q < 4; ++q) c[q] += p[q];
}

// The Karatsuba DFT of one 16-row slice tile: a, b at pa, pb (row stride
// lda; device or shared memory), outputs at yr, yi (row stride ldy), rows
// at or past `rows` neither read nor written.  tab: the kHiTab split
// vectors in shared memory, indexed by j k mod 128.
__device__ __forceinline__ void karatsuba_tile(const float* pa, const float* pb, long long lda,
                                               float* yr, float* yi, long long ldy, int rows,
                                               const uint32_t* tab) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  for (int half = 0; half < 2; ++half) {
    float m1[8][4], m2[8][4], m3[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int q = 0; q < 4; ++q) m1[nt][q] = m2[nt][q] = m3[nt][q] = 0.f;
    }
    for (int ks = 0; ks < 16; ++ks) {
      float va[4], vb[4], vs[4];
      a_values(va, pa, lda, rows, 8 * ks);
      a_values(vb, pb, lda, rows, 8 * ks);
#pragma unroll
      for (int q = 0; q < 4; ++q) vs[q] = va[q] + vb[q];
      uint32_t ab[4], as[4], bb[4], bs[4], sb[4], ss[4];
      split(va, ab, as);
      split(vb, bb, bs);
      split(vs, sb, ss);
      const int j0 = 8 * ks + t, j1 = j0 + 4;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int k = 64 * half + 8 * nt + g;
        const int i0 = (j0 * k) & (kLanes - 1), i1 = (j1 * k) & (kLanes - 1);
        step_3xtf32(m1[nt], ab, as, tab, i0, i1);
        step_3xtf32(m2[nt], bb, bs, tab + 2 * kLanes, i0, i1);
        step_3xtf32(m3[nt], sb, ss, tab + 4 * kLanes, i0, i1);
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
      store_c(yr, ldy, rows, col, r[0], r[1], r[2], r[3]);
      store_c(yi, ldy, rows, col, i[0], i[1], i[2], i[3]);
    }
  }
}

__device__ __forceinline__ void stage_hi_table(uint32_t* st, const float* __restrict__ tab) {
  for (int e = threadIdx.x; e < kHiTab; e += blockDim.x) st[e] = __float_as_uint(__ldg(tab + e));
}

// tab: the kHiTab split vectors (already TF32-exact).
__global__ void __launch_bounds__(kThreads)
bd_hi_kernel(const float* __restrict__ xr, const float* __restrict__ xi, float* __restrict__ yr,
             float* __restrict__ yi, const float* __restrict__ tab, long long b, int n) {
  __shared__ uint32_t st[kHiTab];
  stage_hi_table(st, tab);
  __syncthreads();
  const int n1 = n / kLanes;
  const long long tasks = (b + 15) / 16 * n1;
  const long long step = static_cast<long long>(gridDim.x) * kWarps;
  for (long long task = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       task < tasks; task += step) {
    const long long r0 = task / n1 * 16;
    const int s = static_cast<int>(task % n1);
    const int rows = b - r0 < 16 ? static_cast<int>(b - r0) : 16;
    const size_t base = static_cast<size_t>(r0) * n + s * kLanes;
    karatsuba_tile(xr + base, xi + base, n, yr + base, yi + base, n, rows, st);
  }
}

// tw: n floats; tab: the kHiTab split vectors.  R rows a tile (<= 16).
__global__ void __launch_bounds__(kThreads)
anat_full_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                 float* __restrict__ yr, float* __restrict__ yi, const float* __restrict__ tw,
                 const float* __restrict__ tab, long long b, int n, int R) {
  extern __shared__ float4 smem4[];
  uint32_t* st = reinterpret_cast<uint32_t*>(smem4);
  float* sr = reinterpret_cast<float*>(smem4) + kHiTab;
  float* si = sr + R * (n + kPad);
  stage_hi_table(st, tab);
  const int S = n + kPad, n1 = n / kLanes, warp = threadIdx.x >> 5;
  const long long tiles = (b + R - 1) / R;
  for (long long tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const long long r0 = tile * R;
    const int rows = b - r0 < R ? static_cast<int>(b - r0) : R;
    __syncthreads();  // the previous tile's contraction has read shared memory
    stage_rows(xr, xi, sr, si, r0, R, b, n);
    __syncthreads();
    half3_rounds(sr, si, R, n);
    for (int e = threadIdx.x; e < R * n; e += kThreads) {
      const int at = (e / n) * S + e % n;
      const float w = __ldg(tw + e % n), a = sr[at], c = si[at];
      sr[at] = a * w - c * w;
      si[at] = a * w + c * w;
    }
    __syncthreads();
    for (int s = warp; s < n1; s += kWarps) {
      const size_t out = static_cast<size_t>(r0) * n + s * kLanes;
      karatsuba_tile(sr + s * kLanes, si + s * kLanes, S, yr + out, yi + out, n, rows, st);
    }
  }
}

bool bad_shape(long long b, int n) { return b < 0 || n < kLanes || n % kLanes != 0; }

unsigned tile_blocks(long long tiles) {
  return static_cast<unsigned>(tiles < 65535 ? tiles : 65535);
}

// Blocks of a persistent grid: as many as can be resident at once, at most
// `need`.
template <typename Kernel>
cudaError_t resident_blocks(Kernel k, int smem, long long need, unsigned* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads, smem);
  if (e != cudaSuccess) return e;
  const long long most = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  *out = static_cast<unsigned>(need < most ? need : most);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Each entry: (b, n) float32 planes, n % 128 == 0 (half3 and anat_full:
// n <= 16384), every pointer 16-byte aligned.  Returns cudaGetLastError(),
// or cudaErrorInvalidValue for a shape the kernel does not take.

int gdsp_half3(const float* xr, const float* xi, float* yr, float* yi, long long b, int n,
               void* stream) {
  if (bad_shape(b, n) || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  const int R = n < kHalfPoints ? kHalfPoints / n : 1;
  const int smem = 2 * R * (n + kPad) * sizeof(float);
  cudaError_t e = gdsp::allow_smem(half3_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  half3_kernel<<<dim3(1, tile_blocks((b + R - 1) / R)), kThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(xr, xi, yr, yi, b, n, R);
  return static_cast<int>(cudaGetLastError());
}

// The redesign, slice8_kernel, on the first design's grid.
int gdsp_slice8_add(const float* xr, const float* xi, float* yr, float* yi, long long b, int n,
                    void* stream) {
  if (bad_shape(b, n)) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  slice8_kernel<<<dim3((n + kChunk - 1) / kChunk, tile_blocks((b + kWarps - 1) / kWarps)),
                  kThreads, 0, static_cast<cudaStream_t>(stream)>>>(xr, xi, yr, yi, b, n);
  return static_cast<int>(cudaGetLastError());
}

// The first design, the yardstick: add_one_kernel<false>.
int gdsp_slice8_add_sync(const float* xr, const float* xi, float* yr, float* yi, long long b,
                         int n, void* stream) {
  if (bad_shape(b, n)) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  add_one_kernel<false><<<dim3((n + kChunk - 1) / kChunk, tile_blocks((b + kWarps - 1) / kWarps)),
                          kThreads, 0, static_cast<cudaStream_t>(stream)>>>(xr, xi, yr, yi, b, n);
  return static_cast<int>(cudaGetLastError());
}

int gdsp_reshape_add(const float* xr, const float* xi, float* yr, float* yi, long long b, int n,
                     void* stream) {
  if (bad_shape(b, n)) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  const long long blocks = (b * (n / kLanes) + kWarps - 1) / kWarps;
  add_one_kernel<true><<<static_cast<unsigned>(blocks < (1 << 20) ? blocks : (1 << 20)), kThreads,
                         0, static_cast<cudaStream_t>(stream)>>>(xr, xi, yr, yi, b, n);
  return static_cast<int>(cudaGetLastError());
}

// table: (128, 128) float32, row j, column k.
int gdsp_bd_tf32(const float* xr, const float* xi, float* yr, float* yi, const float* table,
                 long long b, int n, void* stream) {
  if (bad_shape(b, n)) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  cudaError_t e = gdsp::allow_smem(bd_tf32_kernel, kTf32Smem);
  unsigned blocks = 0;
  const long long tasks = (b + 15) / 16 * (n / kLanes);
  if (e == cudaSuccess)
    e = resident_blocks(bd_tf32_kernel, kTf32Smem, (tasks + kWarps - 1) / kWarps, &blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  bd_tf32_kernel<<<blocks, kThreads, kTf32Smem, static_cast<cudaStream_t>(stream)>>>(
      xr, xi, yr, yi, table, b, n);
  return static_cast<int>(cudaGetLastError());
}

// tab: the six 128-entry split vectors (ops/cuda_probes.py: hi_tables).
int gdsp_bd_hi(const float* xr, const float* xi, float* yr, float* yi, const float* tab,
               long long b, int n, void* stream) {
  if (bad_shape(b, n)) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  unsigned blocks = 0;
  const long long tasks = (b + 15) / 16 * (n / kLanes);
  cudaError_t e = resident_blocks(bd_hi_kernel, 0, (tasks + kWarps - 1) / kWarps, &blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  bd_hi_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(xr, xi, yr, yi, tab,
                                                                           b, n);
  return static_cast<int>(cudaGetLastError());
}

// tw: n floats; tab: as gdsp_bd_hi.
int gdsp_anat_full(const float* xr, const float* xi, float* yr, float* yi, const float* tw,
                   const float* tab, long long b, int n, void* stream) {
  if (bad_shape(b, n) || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  const int R = kFullPoints / n < 16 ? kFullPoints / n : 16;
  const int smem = (kHiTab + 2 * R * (n + kPad)) * sizeof(float);
  cudaError_t e = gdsp::allow_smem(anat_full_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  anat_full_kernel<<<dim3(1, tile_blocks((b + R - 1) / R)), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(xr, xi, yr, yi, tw, tab, b, n, R);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
