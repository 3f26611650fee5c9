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
// store (slice_walk.cuh, which slicestore_kernel runs too): 16 loads a
// thread, at 80 registers 3 blocks and 192 KB of loads a SM in flight,
// stored 16 bytes at a time; it runs at the reshape map's speed.  Each
// value is one IEEE float32 add, as in the plain version, so both designs
// equal it bit for bit.
//
// bd_tf32_kernel replaces v4bd1 (:176): each plane's 128-point slices times
// `table` (Re F128 by default: F[j, k] = exp(-2 pi i j k / 128), unscaled;
// any (128, 128) table for the fragment-map checks: the identity returns
// round_tf32(x), a cyclic shift shows the B map) in ONE TF32 pass on the
// tensor cores, the card's counterpart of the TPU's DEFAULT-precision (one
// bf16 pass) matmul.  The TPU multiplies the zeros of the 1024 x 1024
// block-diagonal matrix too; here each slice meets its 128 x 128 block
// only.  Both operands are rounded as cvt.rna.tf32.f32 (round to nearest,
// ties away; wgmma reading float32 truncates) and the products summed in
// float32.  Bound: bytes, 0.080 ms at 16384 x 1024 (512 TF32 operations a
// point: 0.017 ms at 495 TFLOP/s), so the design is a stream: the tensor
// cores are busy a fifth of the time and the bytes must move at the copy's
// speed.  This is the port's only TF32 path, on purpose: it measures what
// one reduced-precision pass costs; nothing at the 120 dB bar uses it, and
// it changes no TF32 or matmul flag.
//   Its first design, bd_tf32_sync_kernel (gdsp_bd_tf32_sync, kept as the
// yardstick): a warp owns a 16-row tile of one slice, 16 k-steps of
// mma.sync m16n8k8 (the rounded table staged at 136 words a row), A read
// from device memory in fragment order (4-byte loads, 8 rows x 16 bytes a
// warp), 8-byte stores of the accumulator layout.  As compiled
// (probes/bd1_vdif.py, on an NVIDIA H100 80GB HBM3 at 700.00 W): 124
// registers, 2 blocks a SM, a k-step a warp 16 HMMA, 4 LDG and 32 LDS;
// 0.134 ms by chain at 16384 x 1024, torch.matmul with TF32 0.117.
// Staging A by 16-byte copies or the outputs through shared memory, a warp
// at a time, did not pay (0.186, 0.169; both 0.127).
//   The redesign: a persistent grid of one CTA an SM keeps round(table)
// transposed as wgmma's K-major B in the 128-byte swizzle (64 KB, built
// from `table` at every launch) and walks the (plane, 64-row tile, slice)
// items in turn (Bd1Plan).  A producer warp brings each item, 64 rows x 128
// columns of one slice of one plane, by four TMA boxes into a ring of five
// 32 KB stages; item k of a CTA goes to warpgroup k % 2, whose warps read
// their A fragments from the landed boxes (conflict-free through the
// swizzle), round them by two integer operations (bd_hi's hi_round, equal
// to cvt.rna), and issue 16 wgmma m64n128k8 with A from registers, all 128
// bins, the tensor cores summing the 16 k-steps.  Each warp then writes its
// 16 rows back into the stage as the boxes landed and stores them by TMA
// (boxes of 32 columns x 16 rows; rows past b dropped); it frees the stage
// when its warpgroup's next item has landed and its stores have read it.
// Shared memory: 65,536 (B) + 163,840 (stages) + 80 (barriers) + 1,024
// (alignment) = 230,480 bytes.  On the same card: 0.106 ms by chain at
// 16384 x 1024 against the first design's 0.133 and torch.matmul's 0.118;
// four stages in place of five 0.106 against 0.103 (probes/bd1_vdif.py
// --tune).  It gives the first design's result bit for bit.
//
// bd_hi_kernel replaces v5bd_hi (:190): the complex product (a + i b)(F_r +
// i F_i) of every slice at float32 accuracy (the 128-point DFT, unscaled)
// by Karatsuba, m1 = a F_r, m2 = b F_i, m3 = (a + b)(F_r + F_i), yr = m1 - m2,
// yi = m3 - m1 - m2, each product in 3xTF32: big = cvt.rna(x), small =
// cvt.rna(x - big), product = small big + big small + big big (small terms
// first), where the TPU's HIGHEST made six bf16 limb passes.  Bound: bytes,
// 0.080 ms (its products are 2304 TF32 operations a point on the tensor
// cores, 0.078 ms at 495 TFLOP/s; K13 does the same function as 768
// float32 operations a point on the CUDA cores).  The three F planes' big
// and small halves depend on j k mod 128 only: six 128-entry vectors split
// on the host from float64 (ops/cuda_probes.py: hi_tables).
//   Its first design, bd_hi_sync_kernel (gdsp_bd_hi_sync, kept as the
// yardstick): a warp owns a 16-row tile of one slice, 64 output columns at
// a time (m1, m2, m3: 96 accumulators a thread, 174 registers, one
// 256-thread block a SM), mma.sync m16n8k8, A read from device memory in
// fragment order (4-byte loads, each slice twice) and split in registers,
// B gathered from the vectors at (j k) & 127 in shared memory; each
// k-step's products summed on the tensor cores from zero and added to the
// running sum in IEEE float32.  As compiled (probes/bd_hi.py) a k-step a
// warp is 72 HMMA beside 96 LDS, 8 LDG, 34 IMAD and 112 FADD; with the
// gather made conflict-free it ran 1.8x faster, with A made in registers
// 1.2x, both 2.5x (wrong results, on purpose).
//   The redesign: pairs of CTAs on a plain grid, one CTA an SM; CTA h of a
// pair keeps bins 64 h .. 64 h + 63 of the six planes resident for its
// life (expanded once from the vectors into wgmma's K-major B in the
// 128-byte swizzle, 192 KB) and the pairs walk the (64-row tile, slice)
// items in turn (F is the same for every slice).  a and b arrive by TMA
// tensor copies, 64-row x 32-column boxes in a ring of two 16 KB stages;
// the CTA's eight warps read each stage's A fragments into registers
// (conflict-free through the swizzle), and the last of them to do so
// refills the slot: no warp is set aside for copies, since a ninth warp
// caps a thread at 168 registers (three warps on one scheduler) and the
// kernel then spilled 208 bytes.  Each warpgroup forms a + b and the six
// TF32 halves in registers, rounding by two integer operations (ptxas
// emulates cvt.rna.tf32 in about five; with it the kernel took 1.2x as long),
// and issues wgmma m64n32k8 with A from registers, 9 a k-step, on its 32
// of the CTA's 64 bins; its walk is a template on the warpgroup, so the B
// descriptors stay in uniform registers.  Two sets of A registers take
// turns: k-step j + 1's halves are made while k-step j's products run.
// The tensor cores chain kHiChain = 4 k-steps from zero, then the partial
// sum is added to the running sum on the CUDA cores in IEEE float32 (a
// chain of 1 gives the first design's result bit for bit; 2, 4, 8, 16 give
// 135.39, 131.62, 126.45, 120.76 dB against float64 at 16384 x 1024: 4 is
// the longest at >= 130).  Epilogue: yr = m1 - m2 and yi = (m3 - m1) - m2,
// stored 8 bytes a thread.  Shared memory: 196,608 (planes) + 32,768
// (stages) + 24 (barriers, counts) + 1,024 (alignment) = 230,424 bytes.
// On an NVIDIA H100 80GB HBM3 at 700.00 W, at 16384 x 1024 (probes/bd_hi.py):
// 0.19 ms by chain against the first design's 0.47 and torch.matmul's 0.35;
// without its products 0.15.  It changes no TF32 or matmul flag.
//
// anat_full_kernel replaces v6full (:203): half3, then ar = a tw - b tw and
// ai = a tw + b tw with a row tw of n floats (the TPU probe's random row,
// not a twiddle), then bd_hi's contraction, in one kernel.  Bound: bytes,
// 0.080 ms (bd_hi's 2304 TF32 operations a point, 0.078 ms, and 10 float32
// ones for the rounds and the row on the CUDA cores, 0.0025 ms).
//   Its first design, anat_full_sync_kernel (gdsp_anat_full_sync, kept as
// the yardstick): a block stages min(16, 16384 / n) whole rows of both
// planes by plain 16-byte loads (128 KB), runs half3's rounds and the row
// there behind barriers, and its warps run bd_hi_sync's contraction from
// shared memory: 170 registers, one block a SM, 0.633 ms by chain at 16384
// x 1024, of which staging 0.13, the rounds and the row 0.10 and the
// products the rest (probes/anat_staged.py, on an NVIDIA H100 80GB HBM3 at
// 700.00 W); the unfused route half3 + the row + bd_hi took 0.558.
//   The redesign runs on bd_hi's walk (hi_body<true>): each round maps
// columns c and c + n / 2 to the same two columns, so a k-box's values
// depend only on the k-box n / 2 columns away in the same row.  A stage is
// the 32-column k-box of a and b and its partner k-box, four TMA boxes in
// one 32 KB slot beside the 192 KB of planes.  Once a stage has landed, the
// CTA's 256 threads make each element's three rounds with its partner (the
// same IEEE adds as the plain version), keep its half (r2a + sgn r2b, one
// FMA of an exact product) and multiply by the row, writing ar and ai over
// the k-box's a and b (an_prepass); after a barrier each warp reads its A
// fragments of them and splits them as bd_hi does: nothing returns to
// device memory between the steps.  The walk steps its items' tiles and
// slices without a 64-bit division (StagePos: the first build divided, a
// subroutine call a stage).  Shared memory: 196,608 + 32,768 + 12 + 1,024 =
// 230,412 bytes.  It gives bd_hi of the float32 rounds and row bit for bit.
// On the same card: 0.245 ms by chain; each warp making the rounds and the
// row of its own fragments (each value four times over, by both
// warpgroups of both CTAs of a pair) took 0.28, two 16 KB stages of
// 16-column boxes 0.28, four of 8 columns 0.49.

#include <cuda_runtime.h>

#include <cstdint>

#include "fft_block.cuh"
#include "hopper_async.cuh"
#include "mma_tf32.cuh"
#include "slice_walk.cuh"

namespace hp = gdsp::hopper;

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
// store (slice_walk.cuh), so a warp has 2 x slices 16-byte loads a thread
// in flight.
__global__ void __launch_bounds__(kThreads)
slice8_kernel(const float* __restrict__ xr, const float* __restrict__ xi, float* __restrict__ yr,
              float* __restrict__ yi, long long b, int n) {
  gdsp::slice_walk::walk(xr, xi, yr, yi, b, n, gdsp::slice_walk::AddOne{});
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

// table: (128, 128) float32, row j, column k.  bd_tf32's first design, the
// yardstick (gdsp_bd_tf32_sync).
__global__ void __launch_bounds__(kThreads)
bd_tf32_sync_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                    float* __restrict__ yr, float* __restrict__ yi,
                    const float* __restrict__ table, long long b, int n) {
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

// tab: the kHiTab split vectors (already TF32-exact).  bd_hi's first design,
// the yardstick (gdsp_bd_hi_sync).
__global__ void __launch_bounds__(kThreads)
bd_hi_sync_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                  float* __restrict__ yr, float* __restrict__ yi, const float* __restrict__ tab,
                  long long b, int n) {
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

// ---------------------------------------------------------------------------
// bd_hi on wgmma, fed by TMA (the plan: HiPlan below)
// ---------------------------------------------------------------------------

constexpr int kHiRows = 64;    // rows of a tile: wgmma's M
constexpr int kHiBins = 64;    // bins a CTA: half a slice
constexpr int kHiN = 32;       // bins a warpgroup: wgmma's N
constexpr int kHiK = 32;       // columns of a stage: one TMA box, one 128-byte swizzled row
constexpr int kHiStages = 2;   // the ring of stages
constexpr int kHiChain = 4;    // k-steps the tensor cores sum before an add
constexpr int kHiThreads = 256;  // two warpgroups, kHiN bins each
constexpr int kHiPlanes = 6;     // kHiTab's six vectors, as matrices
constexpr int kHiPlaneB = kHiBins * kLanes * 4;  // bytes of one resident plane: 32 KB
constexpr int kHiBox = kHiRows * kHiK * 4;       // bytes of a box: 64 rows x 128 bytes
constexpr int kHiStage = 2 * kHiBox;             // a and b of a stage: 16 KB
constexpr int kHiSmem =
    kHiPlanes * kHiPlaneB + kHiStages * kHiStage + kHiStages * (8 + 4) + 1024;

// The A fragment of k-step kk (columns 8 kk .. 8 kk + 7) of a landed box
// (64 rows x 32 columns, 128-byte swizzle) for this thread: rows r0 and
// r0 + 8 (r0 % 8 = g), columns t and t + 4 (wgmma_m64n32k8_tf32_rs's A
// layout).  A warp's eight rows read eight distinct 16-byte units of their
// 128-byte rows, so its 32 lanes hit 32 banks.
__device__ __forceinline__ void hi_fragment(float (&v)[4], const char* box, int r0, int kk,
                                            int t) {
  const int g = r0 & 7;
  const char* p = box + r0 * 128 + 4 * t;
  const int u0 = ((2 * kk) ^ g) << 4, u1 = ((2 * kk + 1) ^ g) << 4;
  v[0] = *reinterpret_cast<const float*>(p + u0);
  v[1] = *reinterpret_cast<const float*>(p + 8 * 128 + u0);
  v[2] = *reinterpret_cast<const float*>(p + u1);
  v[3] = *reinterpret_cast<const float*>(p + 8 * 128 + u1);
}

// cvt.rna.tf32.f32 of a finite x in two integer operations: half a TF32
// unit added to the magnitude's bits, the 13 bits below TF32 cleared
// (ties away from zero, as cvt.rna; ptxas emulates the cvt in about five).
__device__ __forceinline__ uint32_t hi_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// The TF32 halves of a k-step's A values: a, b and a + b (an IEEE float32
// add), each x = big + small, big = round(x), small = round(x - big), as
// split() makes them.
struct HiA {
  uint32_t ab[4], as[4], bb[4], bs[4], sb[4], ss[4];
};

__device__ __forceinline__ void hi_split(HiA& x, const float (&va)[4], const float (&vb)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float vs = __fadd_rn(va[q], vb[q]);
    x.ab[q] = hi_round(va[q]);
    x.as[q] = hi_round(__fsub_rn(va[q], __uint_as_float(x.ab[q])));
    x.bb[q] = hi_round(vb[q]);
    x.bs[q] = hi_round(__fsub_rn(vb[q], __uint_as_float(x.bb[q])));
    x.sb[q] = hi_round(vs);
    x.ss[q] = hi_round(__fsub_rn(vs, __uint_as_float(x.sb[q])));
  }
}

// The descriptor of the warpgroup's bins of plane 0 at k-step 0, in two
// words: the start address (bits 0-13, 16-byte units) moves by off / 16 for
// an operand off bytes on, with no carry out (shared memory < 256 KB).
struct HiDesc {
  uint32_t lo, hi;
  __device__ __forceinline__ uint64_t at(int off) const {
    return (static_cast<uint64_t>(hi) << 32) | (lo + static_cast<uint32_t>(off >> 4));
  }
};

// One k-step of the three products into d (m1, m2, m3), each small big +
// big small + big big, small terms first; off: the k-step's bytes in a
// plane; acc 0 starts a chain (scale-d 0).
__device__ __forceinline__ void hi_products(float (&d)[3][16], const HiA& x, const HiDesc& f,
                                            int off, int acc) {
  hp::wgmma_m64n32k8_tf32_rs(d[0], x.as, f.at(off), acc);
  hp::wgmma_m64n32k8_tf32_rs(d[0], x.ab, f.at(off + kHiPlaneB), 1);
  hp::wgmma_m64n32k8_tf32_rs(d[0], x.ab, f.at(off), 1);
  hp::wgmma_m64n32k8_tf32_rs(d[1], x.bs, f.at(off + 2 * kHiPlaneB), acc);
  hp::wgmma_m64n32k8_tf32_rs(d[1], x.bb, f.at(off + 3 * kHiPlaneB), 1);
  hp::wgmma_m64n32k8_tf32_rs(d[1], x.bb, f.at(off + 2 * kHiPlaneB), 1);
  hp::wgmma_m64n32k8_tf32_rs(d[2], x.ss, f.at(off + 4 * kHiPlaneB), acc);
  hp::wgmma_m64n32k8_tf32_rs(d[2], x.sb, f.at(off + 5 * kHiPlaneB), 1);
  hp::wgmma_m64n32k8_tf32_rs(d[2], x.sb, f.at(off + 4 * kHiPlaneB), 1);
}

// The stages of bd_hi (kFull false) and of anat_full (kFull true): a box is
// kK columns x 64 rows of one plane, its rows kK x 4 bytes in the TMA's
// swizzle of that span (128, 64 or 32 bytes).  bd_hi's stage is the boxes of
// a and b at one k-box of 32 columns, two stages of 16 KB; anat_full's the
// boxes of a and b at one k-box of kAnK columns and at its partner k-box
// n / 2 columns away, as many stages as fill the same 32 KB: at 32 columns
// one stage of 32 KB (0.277 ms by chain at 16384 x 1024 against 0.303 for
// two 16 KB stages of 16 columns and 0.620 for four 8 KB stages of 8:
// probes/anat_staged.py --tune).
constexpr int kAnK = 32;  // columns of an anat_full k-box
template <bool kFull>
struct HiStage {
  static constexpr int kK = kFull ? kAnK : kHiK;          // columns a box
  static constexpr int kBoxes = kFull ? 4 : 2;            // a, b (and their partners)
  static constexpr int kBox = kHiRows * HiStage::kK * 4;  // bytes a box
  static constexpr int kBytes = HiStage::kBoxes * HiStage::kBox;  // bytes a stage
  static constexpr int kStages = kHiStages * kHiStage / HiStage::kBytes;  // the ring: 32 KB
  static constexpr int kSteps = HiStage::kK / 8;          // k-steps a stage
  static constexpr int kPerSlice = kLanes / HiStage::kK;  // stages a slice
  static constexpr int kSmem = kHiPlanes * kHiPlaneB + HiStage::kStages * HiStage::kBytes +
                               HiStage::kStages * (8 + 4) + 1024;
  static_assert(kStages * kBytes == kHiStages * kHiStage, "the ring fills its 32 KB");
};

// Where a stage of a CTA's walk lies: its item's 64-row tile and slice and
// its k-box in the slice.  next() steps to the following stage without a
// division (the walk's items are pairs apart: dq tiles and dr slices).
struct StagePos {
  long long tile;
  int slice, box;
  template <int kPerSlice>
  __device__ __forceinline__ void next(long long dq, int dr, int n1) {
    if (++box == kPerSlice) {
      box = 0;
      tile += dq;
      slice += dr;
      if (slice >= n1) {
        slice -= n1;
        ++tile;
      }
    }
  }
};

// A bd_hi (or anat_full) CTA's walk: pair p (CTAs 2 p + h, h = 0, 1: bins
// 64 h .. 64 h + 63 of every slice) takes items p, p + pairs, ... of the
// (64-row tile, slice) items, the slice fastest; stage c (HiStage) lands in
// slot c % kStages.
template <bool kFull>
struct HiCta {
  using St = HiStage<kFull>;
  const CUtensorMap* maps[2];  // a and b: boxes of kK columns x 64 rows, swizzled
  char* sf;                    // the six planes, swizzled
  char* stages;                // the ring: [slot][box][64 rows][kK x 4 bytes]
  uint64_t* full;              // a slot's mbarrier
  unsigned* reads;             // a slot's count of the warps that have read it
  float* yr;
  float* yi;
  const float* tw;             // anat_full: the row, n floats
  long long b, pair, pairs, mine, total;  // total: the stages this CTA reads
  long long dq;                // pairs / n1: tiles from one item of the walk to the next
  int n, n1, h, dr;            // h: the CTA's half of the bins; dr: pairs % n1

  // The position of the walk's first stage.
  __device__ __forceinline__ StagePos first() const {
    return StagePos{pair / n1, static_cast<int>(pair % n1), 0};
  }
  __device__ __forceinline__ void next(StagePos& p) const {
    p.next<St::kPerSlice>(dq, dr, n1);
  }
  // The copy of stage c, at p, into its slot: anat_full's partner k-box is
  // n / 2 columns on or back (in the same row: half3 maps columns c and
  // c + n / 2 to the same two columns every round).
  __device__ __forceinline__ void issue(long long c, const StagePos& p) const {
    const int row = static_cast<int>(p.tile * kHiRows), col = p.slice * kLanes + p.box * St::kK;
    const int s = static_cast<int>(c % St::kStages);
    hp::mbar_arrive_expect_tx(full + s, St::kBytes);
    for (int pl = 0; pl < 2; ++pl)
      hp::tma_load_2d(stages + s * St::kBytes + pl * St::kBox, maps[pl], col, row, full + s);
    if constexpr (kFull) {
      const int partner = col < n / 2 ? col + n / 2 : col - n / 2;
      for (int pl = 0; pl < 2; ++pl)
        hp::tma_load_2d(stages + s * St::kBytes + (2 + pl) * St::kBox, maps[pl], partner, row,
                        full + s);
    }
  }
};

// Byte offset of element (row r, column k) of a landed anat_full box (64
// rows x kAnK columns in the TMA's swizzle of kAnK x 4 bytes: the 16-byte
// unit u of row r at u ^ ((r >> (3 - B)) & (2^B - 1)), 2^B = kAnK / 4 units a
// row; at 32 columns the 128-byte swizzle of hi_fragment).
__device__ __forceinline__ int an_offset(int r, int k) {
  constexpr int kUnits = kAnK / 4, kShift = kUnits == 4 ? 1 : kUnits == 2 ? 2 : 0;
  return r * (kAnK * 4) + (((k >> 2) ^ ((r >> kShift) & (kUnits - 1))) << 4) + (k & 3) * 4;
}

// The A fragment of k-step kk (columns 8 kk .. 8 kk + 7) of a landed
// anat_full box for this thread: rows r0 and r0 + 8, columns t and t + 4, as
// hi_fragment.  A warp's eight rows read eight distinct 16-byte bank groups,
// so its 32 lanes hit 32 banks.
__device__ __forceinline__ void an_fragment(float (&v)[4], const char* box, int r0, int kk,
                                            int t) {
  v[0] = *reinterpret_cast<const float*>(box + an_offset(r0, 8 * kk + t));
  v[1] = *reinterpret_cast<const float*>(box + an_offset(r0 + 8, 8 * kk + t));
  v[2] = *reinterpret_cast<const float*>(box + an_offset(r0, 8 * kk + t + 4));
  v[3] = *reinterpret_cast<const float*>(box + an_offset(r0 + 8, 8 * kk + t + 4));
}

// anat_full's A values of a landed stage, made once by the CTA's 256
// threads together and written over the own k-box's a and b: for each
// element, half3's three rounds with its partner (lo at the lower column, hi
// at the higher: u + v, u - v each round, the same IEEE adds in the same
// order as the plain version's concatenations), the half its column owns
// (r2a + sgn r2b, sgn = +1 for the lower k-box, -1 for the higher: one
// rounding of an exact product, the IEEE add or subtract), then the row,
// ar = a w - b w, ai = a w + b w.  own: the stage (a, b, then the partner's
// a, b); w: the row at this thread's column (lane % kAnK).  A warp's
// accesses of a row hit distinct banks at 32 columns.
__device__ __forceinline__ void an_prepass(char* own, bool lower, float w, int lane) {
  constexpr int kBox = kHiRows * kAnK * 4, kRowsAtOnce = kHiThreads / kAnK;
  const char* lo = lower ? own : own + 2 * kBox;
  const char* hi = lower ? own + 2 * kBox : own;
  const float sgn = lower ? 1.f : -1.f;
  const int k = lane % kAnK;
#pragma unroll
  for (int i = 0; i < kHiRows / kRowsAtOnce; ++i) {
    const int off = an_offset(static_cast<int>(threadIdx.x) / kAnK + kRowsAtOnce * i, k);
    float y[2];
#pragma unroll
    for (int pl = 0; pl < 2; ++pl) {
      const float u = *reinterpret_cast<const float*>(lo + pl * kBox + off);
      const float v = *reinterpret_cast<const float*>(hi + pl * kBox + off);
      const float r1a = __fadd_rn(u, v), r1b = __fsub_rn(u, v);
      const float r2a = __fadd_rn(r1a, r1b), r2b = __fsub_rn(r1a, r1b);
      y[pl] = __fmaf_rn(sgn, r2b, r2a);
    }
    const float at = __fmul_rn(y[0], w), bt = __fmul_rn(y[1], w);
    *reinterpret_cast<float*>(own + off) = __fsub_rn(at, bt);
    *reinterpret_cast<float*>(own + kBox + off) = __fadd_rn(at, bt);
  }
}

// Warpgroup WG of a bd_hi (or anat_full) CTA: its bins 32 WG .. 32 WG + 31
// of the CTA's 64, every item of the walk.  WG is a template argument so
// that the B descriptors depend on nothing that varies between threads and
// stay in uniform registers.
template <int WG, bool kFull>
__device__ __forceinline__ void hi_walk(const HiCta<kFull>& k) {
  using St = HiStage<kFull>;
  constexpr int kS = St::kSteps;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int r0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);  // rows r0, r0 + 8 of a tile
  const uint64_t d0 = hp::desc_b128(k.sf + kHiN * 128 * WG);   // its bins of plane 0
  const HiDesc fb{static_cast<uint32_t>(d0), static_cast<uint32_t>(d0 >> 32)};
  long long c = 0;               // stages read
  StagePos rd = k.first();       // stage c's position
  StagePos ah = rd;              // stage c + kStages's: the one its slot takes next
#pragma unroll 1
  for (int i = 0; i < St::kStages; ++i) k.next(ah);
  float va[kS][4], vb[kS][4];    // a stage's A values of a and b (anat_full: ar, ai)
  // Stage c into registers; its slot released, and refilled with stage
  // c + kStages by the last of the CTA's eight warps to read it.
  auto read_stage = [&]() {
    const int s = static_cast<int>(c % St::kStages);
    char* sa = k.stages + s * St::kBytes;
    if constexpr (kFull) {
      // The stage made into A values by the whole CTA (an_prepass), then
      // this warp's fragments of them.
      const int col = rd.slice * kLanes + rd.box * St::kK;
      const float w = __ldg(k.tw + col + lane % St::kK);
      hp::mbar_wait(k.full + s, static_cast<uint32_t>(c / St::kStages) & 1u);
      an_prepass(sa, col < k.n / 2, w, lane);
      hp::fence_proxy_async();  // the writes, before the refill's copy into the slot
      hp::named_sync(1, kHiThreads);
#pragma unroll
      for (int kk = 0; kk < kS; ++kk) {
        an_fragment(va[kk], sa, r0, kk, t);
        an_fragment(vb[kk], sa + St::kBox, r0, kk, t);
      }
    } else {
      hp::mbar_wait(k.full + s, static_cast<uint32_t>(c / St::kStages) & 1u);
#pragma unroll
      for (int kk = 0; kk < kS; ++kk) {
        hi_fragment(va[kk], sa, r0, kk, t);
        hi_fragment(vb[kk], sa + kHiBox, r0, kk, t);
      }
    }
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();  // the warp's reads of the slot, before its count
      if ((atomicAdd(k.reads + s, 1u) & (kHiThreads / 32 - 1)) == kHiThreads / 32 - 1 &&
          c + St::kStages < k.total) {
        __threadfence_block();
        hp::fence_proxy_async();  // the generic reads, before the copy's writes
        k.issue(c + St::kStages, ah);
      }
    }
    ++c;
    k.next(rd);
    k.next(ah);
  };

  float d[3][16];  // the tensor cores' sums of m1, m2, m3 (scale-d 0 at a chain's start)
#pragma unroll
  for (int p = 0; p < 3; ++p) {
#pragma unroll
    for (int q = 0; q < 16; ++q) d[p][q] = 0.f;
  }
  for (long long i = 0; i < k.mine; ++i) {
    const StagePos item = rd;  // the item's tile and slice
    float run[3][16];  // the running sums on the CUDA cores
#pragma unroll
    for (int p = 0; p < 3; ++p) {
#pragma unroll
      for (int q = 0; q < 16; ++q) run[p][q] = 0.f;
    }
    // Two sets of split A registers in turn: k-step j + 1's are made while
    // k-step j's products run (wgmma_wait<1> frees the set k-step j - 1
    // read).
    HiA x[2];
    read_stage();
    hi_split(x[0], va[0], vb[0]);
#pragma unroll
    for (int j = 0; j < kLanes / 8; ++j) {
#pragma unroll
      for (int p = 0; p < 3; ++p) {
#pragma unroll
        for (int q = 0; q < 16; ++q) hp::fence_operand(d[p][q]);
      }
      hp::wgmma_fence();
      hi_products(d, x[j & 1], fb, (j >> 2) * (kHiBins * 128) + (j & 3) * 32,
                  j % kHiChain != 0);
      hp::wgmma_commit();
      if ((j + 1) % kHiChain == 0) {
        hp::wgmma_wait<0>();
#pragma unroll
        for (int p = 0; p < 3; ++p) {
#pragma unroll
          for (int q = 0; q < 16; ++q) {
            hp::fence_operand(d[p][q]);
            run[p][q] = __fadd_rn(run[p][q], d[p][q]);
          }
        }
      } else {
        hp::wgmma_wait<1>();
      }
      if (j + 1 < kLanes / 8) {
        if ((j + 1) % kS == 0) read_stage();
        hi_split(x[(j + 1) & 1], va[(j + 1) % kS], vb[(j + 1) % kS]);
      }
    }
    // yr = m1 - m2 and yi = (m3 - m1) - m2, 8 bytes a store: rows r0 and
    // r0 + 8 of the tile, columns 8 jn + 2 t of the warpgroup's 32 bins
    // (the accumulator layout of wgmma_m64n32k8_tf32).
    const long long row = item.tile * kHiRows + r0;
    const size_t col =
        static_cast<size_t>(item.slice) * kLanes + kHiBins * k.h + kHiN * WG + 2 * t;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (row + 8 * hh >= k.b) continue;
      const size_t at = static_cast<size_t>(row + 8 * hh) * k.n + col;
#pragma unroll
      for (int jn = 0; jn < kHiN / 8; ++jn) {
        const int q = 4 * jn + 2 * hh;
        *reinterpret_cast<float2*>(k.yr + at + 8 * jn) =
            make_float2(__fsub_rn(run[0][q], run[1][q]), __fsub_rn(run[0][q + 1], run[1][q + 1]));
        *reinterpret_cast<float2*>(k.yi + at + 8 * jn) =
            make_float2(__fsub_rn(__fsub_rn(run[2][q], run[0][q]), run[1][q]),
                        __fsub_rn(__fsub_rn(run[2][q + 1], run[0][q + 1]), run[1][q + 1]));
      }
    }
  }
}

// The body of bd_hi_kernel (kFull false) and anat_full_kernel (kFull true):
// the CTA's walk set up, its first stages issued, its bins of the six
// planes expanded while they land, then each warpgroup's walk.
template <bool kFull>
__device__ __forceinline__ void hi_body(const CUtensorMap* ta, const CUtensorMap* tb, float* yr,
                                        float* yi, const float* tw, const float* tab, long long b,
                                        int n, int pairs) {
  static_assert(kLanes / 8 % kHiChain == 0, "a chain ends within a slice");
  extern __shared__ float4 smem4[];
  // Aligned by an offset, not through an integer, so the compiler keeps
  // shared loads (LDS) for the stages.
  char* base = reinterpret_cast<char*>(smem4) + ((1024 - (hp::smem_addr(smem4) & 1023)) & 1023);
  HiCta<kFull> k;
  k.maps[0] = ta;
  k.maps[1] = tb;
  k.sf = base;
  k.stages = base + kHiPlanes * kHiPlaneB;
  k.full = reinterpret_cast<uint64_t*>(k.stages + kHiStages * kHiStage);
  k.reads = reinterpret_cast<unsigned*>(k.full + HiStage<kFull>::kStages);
  k.yr = yr;
  k.yi = yi;
  k.tw = tw;
  k.b = b;
  k.n = n;
  k.n1 = n / kLanes;
  k.h = static_cast<int>(blockIdx.x & 1);
  k.pair = blockIdx.x >> 1;
  k.pairs = pairs;
  k.dq = pairs / k.n1;
  k.dr = pairs % k.n1;
  const long long items = (b + kHiRows - 1) / kHiRows * k.n1;
  k.mine = k.pair < items ? (items - 1 - k.pair) / pairs + 1 : 0;
  k.total = k.mine * HiStage<kFull>::kPerSlice;

  if (threadIdx.x == 0) {
    for (int s = 0; s < HiStage<kFull>::kStages; ++s) {
      hp::mbar_init(k.full + s, 1);  // the issuing thread's arrive.expect_tx
      k.reads[s] = 0;
    }
    hp::mbar_init_fence();
  }
  __syncthreads();  // the barriers exist before any copy
  if (threadIdx.x == 0) {
    StagePos p = k.first();
    for (long long c = 0; c < k.total && c < HiStage<kFull>::kStages; ++c, k.next(p))
      k.issue(c, p);
  }
  // The six planes' bins 64 h .. of every j (F[j, k] = v[j k mod 128]) as
  // wgmma's K-major B (the CTA's bins as rows, j as k), four j a 16-byte
  // store, while the first stages land.
  for (int e = threadIdx.x; e < (k.mine > 0 ? kHiPlanes * kHiBins * kLanes / 4 : 0);
       e += kHiThreads) {
    const int p = e / (kHiBins * kLanes / 4), bk = e / (kLanes / 4) % kHiBins;
    const int j = 4 * (e % (kLanes / 4)), bin = kHiBins * k.h + bk;
    const float* v = tab + p * kLanes;
    *reinterpret_cast<float4*>(k.sf + p * kHiPlaneB + hp::b128_offset(bk, j, kHiBins)) =
        make_float4(__ldg(v + ((j * bin) & (kLanes - 1))),
                    __ldg(v + (((j + 1) * bin) & (kLanes - 1))),
                    __ldg(v + (((j + 2) * bin) & (kLanes - 1))),
                    __ldg(v + (((j + 3) * bin) & (kLanes - 1))));
  }
  hp::fence_proxy_async();  // the planes, to wgmma's reads
  __syncthreads();
  if (threadIdx.x < kHiThreads / 2)
    hi_walk<0>(k);
  else
    hi_walk<1>(k);
}

// ta, tb: tensor maps of the (b, n) planes a and b, boxes of 32 columns x 64
// rows in the 128-byte swizzle (rows past b arrive as zeros); tab: the
// kHiTab split vectors; the walk: HiCta.  No warp is set aside for the
// copies: thread 0 issues the first two stages, and the last warp to read a
// stage into registers issues the copy that refills its slot, so the 8
// warps keep up to 255 registers a thread.
__global__ void __launch_bounds__(kHiThreads, 1)
bd_hi_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
             float* __restrict__ yr, float* __restrict__ yi, const float* __restrict__ tab,
             long long b, int n, int pairs) {
  hi_body<false>(&ta, &tb, yr, yi, nullptr, tab, b, n, pairs);
}

// anat_full on bd_hi's walk: ta, tb as bd_hi_kernel's, boxes of kAnK
// columns; tw: the row, n floats.  Each stage brings a k-box of a and b and
// its partner k-box n / 2 columns away; the CTA makes half3's rounds and the
// row once a stage (an_prepass), each warp the split in registers.
__global__ void __launch_bounds__(kHiThreads, 1)
anat_full_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                 float* __restrict__ yr, float* __restrict__ yi, const float* __restrict__ tw,
                 const float* __restrict__ tab, long long b, int n, int pairs) {
  hi_body<true>(&ta, &tb, yr, yi, tw, tab, b, n, pairs);
}

// ---------------------------------------------------------------------------
// bd_tf32 on wgmma, fed by TMA (the plan: Bd1Plan below)
// ---------------------------------------------------------------------------

constexpr int kB1Rows = 64;                  // rows of a tile: wgmma's M
constexpr int kB1K = 32;                     // columns of a TMA box: one 128-byte swizzled row
constexpr int kB1Box = kB1Rows * kB1K * 4;   // bytes of a box: 8 KB
constexpr int kB1Stage = kLanes / kB1K * kB1Box;  // a tile of one slice of one plane: 32 KB
constexpr int kB1Stages = 5;                 // the ring of stages
constexpr int kB1Consumers = 256;            // two warpgroups, an item each
constexpr int kB1Threads = kB1Consumers + 32;  // and a producer warp
constexpr int kB1StoreRows = 16;             // rows of a store box: one warp's
constexpr int kB1TableB = kLanes * kLanes * 4;  // round(table) as wgmma's B: 64 KB
constexpr int kB1Smem = kB1TableB + kB1Stages * kB1Stage + 2 * kB1Stages * 8 + 1024;

// Item i of a bd_tf32 launch: plane i / (tiles n1), then the 64-row tile,
// then the slice (fastest).
struct B1Item {
  int plane, row, col;  // row: the tile's first row; col: the slice's first column
  __device__ __forceinline__ B1Item(long long i, long long tiles, int n1) {
    plane = static_cast<int>(i / (tiles * n1));
    const long long r = i % (tiles * n1);
    row = static_cast<int>(r / n1 * kB1Rows);
    col = static_cast<int>(r % n1) * kLanes;
  }
};

// ta, tb: tensor maps of the (b, n) planes a and b, boxes of 32 columns x 64
// rows; tya, tyb: of the outputs, boxes of 32 columns x 16 rows; both in the
// 128-byte swizzle (rows past b arrive as zeros and are not stored).
// table: (128, 128) float32, row j, column k.  CTA c walks items c, c +
// ctas, ... (B1Item); its k-th item lands in stage k % kB1Stages and
// warpgroup k % 2 contracts it, all 128 bins (wgmma m64n128k8, 16 k-steps
// chained on the tensor cores), writes it back into the stage as the boxes
// landed and stores it by TMA, a warp its own 16 rows.  Warp 8 is the
// producer: it refills a stage once the four warps that stored from it
// have seen their stores read it, which each checks when its warpgroup's
// next item has landed.
__global__ void __launch_bounds__(kB1Threads, 1)
bd_tf32_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
               const __grid_constant__ CUtensorMap tya, const __grid_constant__ CUtensorMap tyb,
               const float* __restrict__ table, long long b, int n) {
  extern __shared__ float4 smem4[];
  // Aligned by an offset, not through an integer, so the stages' reads stay LDS.
  char* base = reinterpret_cast<char*>(smem4) + ((1024 - (hp::smem_addr(smem4) & 1023)) & 1023);
  char* sb = base;                  // round(table) transposed: [bin][j], swizzled
  char* stages = base + kB1TableB;  // the ring: [stage][box][64 rows][128 bytes]
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kB1Stages * kB1Stage);
  uint64_t* empty = full + kB1Stages;
  const int n1 = n / kLanes;
  const long long tiles = (b + kB1Rows - 1) / kB1Rows;
  const long long items = 2 * tiles * n1;
  const long long mine =
      blockIdx.x < items ? (items - 1 - blockIdx.x) / gridDim.x + 1 : 0;  // this CTA's items
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kB1Stages; ++s) {
      hp::mbar_init(full + s, 1);   // the producer's arrive.expect_tx
      hp::mbar_init(empty + s, 4);  // the four warps that stored from it
    }
    hp::mbar_init_fence();
  }
  __syncthreads();  // the barriers exist before any copy or arrival

  if (threadIdx.x >= kB1Consumers) {
    if (lane == 0) {
      for (long long c = 0; c < mine; ++c) {
        const int s = static_cast<int>(c % kB1Stages);
        hp::mbar_wait(empty + s, (static_cast<uint32_t>(c / kB1Stages) & 1u) ^ 1u);
        const B1Item it(blockIdx.x + c * gridDim.x, tiles, n1);
        hp::mbar_arrive_expect_tx(full + s, kB1Stage);
        for (int box = 0; box < kLanes / kB1K; ++box)
          hp::tma_load_2d(stages + s * kB1Stage + box * kB1Box, it.plane ? &tb : &ta,
                          it.col + box * kB1K, it.row, full + s);
      }
    }
    return;
  }

  // round(table) transposed into wgmma's K-major B (the bins as rows, j as
  // k), four j a 16-byte store, the table read a row of bins at a time.
  for (int e = threadIdx.x; e < (mine > 0 ? kLanes * kLanes / 4 : 0); e += kB1Consumers) {
    const int bin = e % kLanes, j = 4 * (e / kLanes);
    const float* col = table + j * kLanes + bin;
    *reinterpret_cast<uint4*>(sb + hp::b128_offset(bin, j, kLanes)) =
        make_uint4(hi_round(__ldg(col)), hi_round(__ldg(col + kLanes)),
                   hi_round(__ldg(col + 2 * kLanes)), hi_round(__ldg(col + 3 * kLanes)));
  }
  hp::fence_proxy_async();  // B, to wgmma's reads
  hp::named_sync(1, kB1Consumers);

  const int wg = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3, t = lane & 3;
  const int r0 = 16 * w + (lane >> 2);  // rows r0, r0 + 8 of a tile
  float d[64];
#pragma unroll
  for (int q = 0; q < 64; ++q) d[q] = 0.f;
  for (long long c = wg; c < mine; c += 2) {
    const int s = static_cast<int>(c % kB1Stages);
    char* st = stages + s * kB1Stage;
    hp::mbar_wait(full + s, static_cast<uint32_t>(c / kB1Stages) & 1u);
    if (lane == 0 && c >= 2) {
      // The warp's stores of its previous item have read their stage: free it.
      hp::bulk_wait_read();
      hp::mbar_arrive(empty + (c - 2) % kB1Stages);
    }
    // Every k-step's A values first, rounded as cvt.rna.tf32.f32 does.
    uint32_t a[kLanes / 8][4];
#pragma unroll
    for (int j = 0; j < kLanes / 8; ++j) {
      float v[4];
      hi_fragment(v, st + (j >> 2) * kB1Box, r0, j & 3, t);
#pragma unroll
      for (int q = 0; q < 4; ++q) a[j][q] = hi_round(v[q]);
    }
#pragma unroll
    for (int q = 0; q < 64; ++q) hp::fence_operand(d[q]);
    hp::wgmma_fence();
#pragma unroll
    for (int j = 0; j < kLanes / 8; ++j)
      hp::wgmma_m64n128k8_tf32_rs(
          d, a[j], hp::desc_b128(sb + (j >> 2) * (kLanes * 128) + (j & 3) * 32), j != 0);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
#pragma unroll
    for (int q = 0; q < 64; ++q) hp::fence_operand(d[q]);
    // The warp's 16 rows back into the stage as the boxes landed (its reads
    // of them are done: they fed its A registers), then stored by TMA.
#pragma unroll
    for (int j = 0; j < kLanes / 8; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(st + (j >> 2) * kB1Box +
                                   hp::b128_offset(r0 + 8 * hh, 8 * (j & 3) + 2 * t, kB1Rows)) =
            make_float2(d[4 * j + 2 * hh], d[4 * j + 2 * hh + 1]);
    }
    hp::fence_proxy_async();
    __syncwarp();
    if (lane == 0) {
      const B1Item it(blockIdx.x + c * gridDim.x, tiles, n1);
      const int row = it.row + kB1StoreRows * w;
      if (row < b) {
        for (int box = 0; box < kLanes / kB1K; ++box)
          hp::tma_store_2d(it.plane ? &tyb : &tya,
                           st + box * kB1Box + kB1StoreRows * w * 128, it.col + box * kB1K, row);
      }
      hp::bulk_commit();
    }
    __syncwarp();
  }
  if (lane == 0) hp::bulk_wait_all();
}

// tw: n floats; tab: the kHiTab split vectors.  R rows a tile (<= 16).
// anat_full's first design, the yardstick (gdsp_anat_full_sync).
__global__ void __launch_bounds__(kThreads)
anat_full_sync_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
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

// CTAs of `kernel` (`threads` threads, `smem` dynamic shared bytes each) the
// card holds at once, the CTAs resident an SM times the SMs: 0 where none
// fits, or -(CUDA error).
template <typename Kernel>
int resident_ctas(Kernel kernel, int threads, int smem) {
  int device = 0, sms = 0, blocks = 0;
  cudaError_t e = gdsp::allow_smem(kernel, static_cast<size_t>(smem));
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();  // reported here, not by the next launch's check
    return -static_cast<int>(e);
  }
  return blocks * sms;
}

// bd_hi's launch plan (ops/cuda_probes.py: bd_hi_plan holds the same; the
// GPU tests compare through gdsp_bd_hi_geometry).
struct HiPlan {
  int pair;       // CTAs an item: the two halves of a slice's bins
  int pairs;      // pairs of the grid: the resident pairs, at most the items
  int ctas;       // CTAs of the grid
  int rows_tile;  // rows of a tile (wgmma's M)
  int bins_cta;   // bins a CTA
  int stages;     // the ring of stages a CTA
  int k_stage;    // columns of a slice a stage
  int smem;       // bytes of dynamic shared memory a CTA
  int per_pair;   // items the busiest pair walks
  int chain;      // k-steps the tensor cores sum before an add on the CUDA cores
};
constexpr int kHiPlanFields = 10;

// b >= 0, n a multiple of 128; resident the pairs the card holds at once.
int make_hi_plan(long long b, int n, int resident, HiPlan* p) {
  if (bad_shape(b, n)) return static_cast<int>(cudaErrorInvalidValue);
  if (resident < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const long long items = (b + kHiRows - 1) / kHiRows * (n / kLanes);
  const long long pairs = items < 1 ? 1 : (items < resident ? items : resident);
  const long long per = (items + pairs - 1) / pairs;
  if (per > 0x7fffffffLL || b > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  *p = HiPlan{2,       static_cast<int>(pairs), static_cast<int>(2 * pairs),
              kHiRows, kHiBins, kHiStages, kHiK, kHiSmem, static_cast<int>(per), kHiChain};
  return 0;
}

// anat_full's launch plan (ops/cuda_probes.py: anat_full_plan holds the
// same; the GPU tests and the smoke compare through gdsp_anat_full_geometry):
// bd_hi's walk, four boxes a stage (HiStage<true>).
struct AnatPlan {
  HiPlan hi;    // the pairs, tiles, bins and chain: bd_hi's; the ring: HiStage<true>'s
  int boxes;    // boxes a stage: a and b at the k-box and at its partner
  int partner;  // columns from a k-box to its partner: n / 2
};
constexpr int kAnatPlanFields = kHiPlanFields + 2;

int make_anat_plan(long long b, int n, int resident, AnatPlan* p) {
  if (bad_shape(b, n) || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = make_hi_plan(b, n, resident, &p->hi);
  if (rc != 0) return rc;
  p->hi.k_stage = HiStage<true>::kK;
  p->hi.stages = HiStage<true>::kStages;
  p->hi.smem = HiStage<true>::kSmem;
  p->boxes = HiStage<true>::kBoxes;
  p->partner = n / 2;
  return 0;
}

// bd_tf32's launch plan (ops/cuda_probes.py: bd_tf32_plan holds the same;
// the GPU tests compare through gdsp_bd_tf32_geometry).
struct Bd1Plan {
  int ctas;       // CTAs of the grid: the resident ones, at most the items
  int per_cta;    // items the busiest CTA walks
  int rows_tile;  // rows of a tile (wgmma's M)
  int bins;       // bins a warpgroup's product (wgmma's N)
  int stages;     // the ring of stages a CTA
  int threads;    // threads a CTA: two warpgroups and a producer warp
  int smem;       // bytes of dynamic shared memory a CTA
  int store_rows; // rows of a TMA store box: one warp's
};
constexpr int kB1PlanFields = 8;

// b >= 0, n a multiple of 128; resident the CTAs the card holds at once.
int make_bd1_plan(long long b, int n, int resident, Bd1Plan* p) {
  if (bad_shape(b, n)) return static_cast<int>(cudaErrorInvalidValue);
  if (resident < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const long long items = 2 * ((b + kB1Rows - 1) / kB1Rows) * (n / kLanes);
  const long long ctas = items < 1 ? 1 : (items < resident ? items : resident);
  const long long per = (items + ctas - 1) / ctas;
  if (per > 0x7fffffffLL || b > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  *p = Bd1Plan{static_cast<int>(ctas), static_cast<int>(per), kB1Rows,  kLanes,
               kB1Stages,              kB1Threads,            kB1Smem, kB1StoreRows};
  return 0;
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
  slice8_kernel<<<gdsp::slice_walk::grid(b, n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(xr, xi, yr, yi, b, n);
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

// bd_tf32 on wgmma: table (128, 128) float32, row j, column k; resident the
// CTAs of bd_tf32_kernel the card holds at once (gdsp_bd_tf32_resident).
// Returns cudaErrorLaunchOutOfResources where resident < 1.
int gdsp_bd_tf32(const float* xr, const float* xi, float* yr, float* yi, const float* table,
                 long long b, int n, int resident, void* stream) {
  Bd1Plan p;
  const int rc = make_bd1_plan(b, n, resident, &p);
  if (rc != 0) return rc;
  if (b == 0) return 0;
  CUtensorMap maps[4];
  const float* planes[4] = {xr, xi, yr, yi};
  for (int i = 0; i < 4; ++i) {
    const int m = hp::encode_tensor_map_2d(maps + i, planes[i], b, n, kB1K,
                                           i < 2 ? kB1Rows : kB1StoreRows);
    if (m != 0) return m;
  }
  cudaError_t e = gdsp::allow_smem(bd_tf32_kernel, static_cast<size_t>(p.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  bd_tf32_kernel<<<static_cast<unsigned>(p.ctas), kB1Threads, static_cast<size_t>(p.smem),
                   static_cast<cudaStream_t>(stream)>>>(maps[0], maps[1], maps[2], maps[3],
                                                        table, b, n);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of bd_tf32_kernel the card holds at once with the plan's shared
// memory plus extra_smem bytes a CTA: 0 where none fits, or -(CUDA error).
int gdsp_bd_tf32_resident(int extra_smem) {
  return resident_ctas(bd_tf32_kernel, kB1Threads, kB1Smem + extra_smem);
}

// bd_tf32's plan at b x n with `resident` CTAs: out[0..7] = CTAs, items of
// the busiest CTA, rows a tile, bins, stages, threads, shared bytes, rows a
// store box (Bd1Plan).  ops/cuda_probes.py: bd_tf32_plan holds the same.
int gdsp_bd_tf32_geometry(long long b, int n, int resident, int* out) {
  Bd1Plan p;
  const int rc = make_bd1_plan(b, n, resident, &p);
  if (rc != 0) return rc;
  const int v[kB1PlanFields] = {p.ctas,    p.per_cta, p.rows_tile, p.bins,
                                p.stages, p.threads, p.smem,      p.store_rows};
  for (int i = 0; i < kB1PlanFields; ++i) out[i] = v[i];
  return 0;
}

// bd_tf32's first design, the yardstick (mma.sync m16n8k8, A read from
// device memory in fragment order): table as gdsp_bd_tf32's.
int gdsp_bd_tf32_sync(const float* xr, const float* xi, float* yr, float* yi, const float* table,
                      long long b, int n, void* stream) {
  if (bad_shape(b, n)) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  cudaError_t e = gdsp::allow_smem(bd_tf32_sync_kernel, kTf32Smem);
  unsigned blocks = 0;
  const long long tasks = (b + 15) / 16 * (n / kLanes);
  if (e == cudaSuccess)
    e = resident_blocks(bd_tf32_sync_kernel, kTf32Smem, (tasks + kWarps - 1) / kWarps, &blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  bd_tf32_sync_kernel<<<blocks, kThreads, kTf32Smem, static_cast<cudaStream_t>(stream)>>>(
      xr, xi, yr, yi, table, b, n);
  return static_cast<int>(cudaGetLastError());
}

// bd_hi on wgmma: tab the six 128-entry split vectors (ops/cuda_probes.py:
// hi_tables); resident the pairs of bd_hi_kernel's CTAs the card holds at
// once (gdsp_bd_hi_resident).  Returns cudaErrorLaunchOutOfResources where
// resident < 1.
int gdsp_bd_hi(const float* xr, const float* xi, float* yr, float* yi, const float* tab,
               long long b, int n, int resident, void* stream) {
  HiPlan p;
  const int rc = make_hi_plan(b, n, resident, &p);
  if (rc != 0) return rc;
  if (b == 0) return 0;
  CUtensorMap maps[2];
  const float* planes[2] = {xr, xi};
  for (int i = 0; i < 2; ++i) {
    const int m = hp::encode_tensor_map_2d(maps + i, planes[i], b, n, kHiK, kHiRows);
    if (m != 0) return m;
  }
  cudaError_t e = gdsp::allow_smem(bd_hi_kernel, static_cast<size_t>(p.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  bd_hi_kernel<<<static_cast<unsigned>(p.ctas), kHiThreads, static_cast<size_t>(p.smem),
                 static_cast<cudaStream_t>(stream)>>>(maps[0], maps[1], yr, yi, tab, b, n,
                                                      p.pairs);
  return static_cast<int>(cudaGetLastError());
}

// Pairs of bd_hi_kernel's CTAs the card holds at once with the plan's shared
// memory plus extra_smem bytes a CTA (the CTAs resident an SM times the SMs,
// halved): 0 where none fits, or -(CUDA error).
int gdsp_bd_hi_resident(int extra_smem) {
  const int ctas = resident_ctas(bd_hi_kernel, kHiThreads, kHiSmem + extra_smem);
  return ctas < 0 ? ctas : ctas / 2;
}

// bd_hi's plan at b x n with `resident` pairs: out[0..9] = pair, pairs,
// CTAs, rows a tile, bins a CTA, stages, columns a stage, shared bytes,
// items of the busiest pair, chain (HiPlan).  ops/cuda_probes.py: bd_hi_plan
// holds the same; the GPU tests compare.
int gdsp_bd_hi_geometry(long long b, int n, int resident, int* out) {
  HiPlan p;
  const int rc = make_hi_plan(b, n, resident, &p);
  if (rc != 0) return rc;
  const int v[kHiPlanFields] = {p.pair,   p.pairs,   p.ctas, p.rows_tile, p.bins_cta,
                                p.stages, p.k_stage, p.smem, p.per_pair,  p.chain};
  for (int i = 0; i < kHiPlanFields; ++i) out[i] = v[i];
  return 0;
}

// bd_hi's first design, the yardstick (mma.sync, A from device memory, the
// tables gathered over j k mod 128): tab as gdsp_bd_hi.
int gdsp_bd_hi_sync(const float* xr, const float* xi, float* yr, float* yi, const float* tab,
                    long long b, int n, void* stream) {
  if (bad_shape(b, n)) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  unsigned blocks = 0;
  const long long tasks = (b + 15) / 16 * (n / kLanes);
  cudaError_t e = resident_blocks(bd_hi_sync_kernel, 0, (tasks + kWarps - 1) / kWarps, &blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  bd_hi_sync_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xr, xi, yr, yi, tab, b, n);
  return static_cast<int>(cudaGetLastError());
}

// anat_full's first design, the yardstick (min(16, 16384 / n) whole rows
// staged a block, the rounds and the row there, bd_hi_sync's contraction
// from shared memory): tw n floats, tab as gdsp_bd_hi.
int gdsp_anat_full_sync(const float* xr, const float* xi, float* yr, float* yi, const float* tw,
                        const float* tab, long long b, int n, void* stream) {
  if (bad_shape(b, n) || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  const int R = kFullPoints / n < 16 ? kFullPoints / n : 16;
  const int smem = (kHiTab + 2 * R * (n + kPad)) * sizeof(float);
  cudaError_t e = gdsp::allow_smem(anat_full_sync_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  anat_full_sync_kernel<<<dim3(1, tile_blocks((b + R - 1) / R)), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(xr, xi, yr, yi, tw, tab, b, n, R);
  return static_cast<int>(cudaGetLastError());
}

// anat_full on bd_hi's walk: tw n floats, tab as gdsp_bd_hi; resident the
// pairs of anat_full_kernel's CTAs the card holds at once
// (gdsp_anat_full_resident).  Returns cudaErrorLaunchOutOfResources where
// resident < 1.
int gdsp_anat_full(const float* xr, const float* xi, float* yr, float* yi, const float* tw,
                   const float* tab, long long b, int n, int resident, void* stream) {
  AnatPlan p;
  const int rc = make_anat_plan(b, n, resident, &p);
  if (rc != 0) return rc;
  if (b == 0) return 0;
  CUtensorMap maps[2];
  const float* planes[2] = {xr, xi};
  for (int i = 0; i < 2; ++i) {
    const int m = hp::encode_tensor_map_2d(
        maps + i, planes[i], b, n, kAnK, kHiRows,
        kAnK == 32 ? CU_TENSOR_MAP_SWIZZLE_128B
                   : kAnK == 16 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B);
    if (m != 0) return m;
  }
  cudaError_t e = gdsp::allow_smem(anat_full_kernel, static_cast<size_t>(p.hi.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  anat_full_kernel<<<static_cast<unsigned>(p.hi.ctas), kHiThreads,
                     static_cast<size_t>(p.hi.smem), static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], yr, yi, tw, tab, b, n, p.hi.pairs);
  return static_cast<int>(cudaGetLastError());
}

// Pairs of anat_full_kernel's CTAs the card holds at once with the plan's
// shared memory plus extra_smem bytes a CTA: 0 where none fits, or -(CUDA
// error).
int gdsp_anat_full_resident(int extra_smem) {
  const int ctas = resident_ctas(anat_full_kernel, kHiThreads, HiStage<true>::kSmem + extra_smem);
  return ctas < 0 ? ctas : ctas / 2;
}

// anat_full's plan at b x n with `resident` pairs: out[0..11] = bd_hi's
// fields (gdsp_bd_hi_geometry's order; columns a stage 16), boxes a stage,
// columns to the partner k-box (AnatPlan).  ops/cuda_probes.py:
// anat_full_plan holds the same; the GPU tests compare.
int gdsp_anat_full_geometry(long long b, int n, int resident, int* out) {
  AnatPlan p;
  const int rc = make_anat_plan(b, n, resident, &p);
  if (rc != 0) return rc;
  const HiPlan& h = p.hi;
  const int v[kAnatPlanFields] = {h.pair,    h.pairs,  h.ctas,     h.rows_tile, h.bins_cta,
                                  h.stages,  h.k_stage, h.smem,    h.per_pair,  h.chain,
                                  p.boxes,   p.partner};
  for (int i = 0; i < kAnatPlanFields; ++i) out[i] = v[i];
  return 0;
}

}  // extern "C"
