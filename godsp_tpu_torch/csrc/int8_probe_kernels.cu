// K14g: the twins for Hopper (sm_90a) of tools/probe_int8.py's int8-limb
// contraction probe (_call :68, one pl.pallas_call at :71 over the bodies
// _i8mm_kernel :93, _i8dec_kernel :123 and _i8full_kernel :162; the
// exactness check of one int8 dot at :213) and of tools/probe_store.py's
// _call (:53) over _i8_concat_kernel (:101).  They run under
// godsp_tpu_torch/probes/int8.py and probes/store.py.  No library kernel is
// called.  Every product is an int8 mma.sync m16n8k32 with its int32 sum on
// the tensor cores (mma_s8.cuh): integer sums are exact, so unlike the TF32
// twins the running sum may stay there.  Bounds below are at 16384 x 1024 on
// the H100 (3.35 TB/s, 1,979 TOPS dense int8, 67 TFLOP/s float32).
//
// i8_dot_kernel<kVec> replaces :213 (the body `tiny` :204): c = a b for
// int8 a (m, k) and b (k, n), row-major, into int32 c (m, n), exactly.  At
// the probe's (256, 128) @ (128, 128) the bound is the bytes, 0.1 MB, so
// the time is latency: the launch and the dependent trips to memory.  A
// CTA of four warps owns a 32 x 32 tile of c (32 CTAs at the probe's
// shape), each warp 16 x 16 of it (two m16n8k32 tiles).  k comes in chunks
// of 128 through a ring of four stages: where k <= 512 every byte of the
// tile's a and b is asked for at once (kVec: 16-byte cp.async, rows and
// k past the edge zero-filled) and waited for once; deeper k refills a
// stage as soon as its chunk is used.  a lands row-major at a 144-byte
// pitch (the A fragments' words hit 32 banks); b lands row-major with its
// rows permuted so that one pass transposes each 4 x 4 block of bytes by
// byte permutes (prmt) into b^T at the same pitch, both sides on 32 banks;
// the B fragments then read four k-consecutive bytes a column as a word.
// c is stored as 8-byte runs.  kVec = false (k or n not a multiple of 16,
// or an operand not 16-byte aligned: a view with a storage offset) takes
// the same ring with predicated byte loads, bytes past m, k or n read as
// 0, and scalar stores: the same integers.  gdsp_i8_dot_geometry exports
// the plan (ops/cuda_probes.py: i8_dot_plan mirrors it).
// i8_dot_bytes_kernel, its first design, kept as the yardstick: a block of
// four warps a 64 x 64 tile of c (8 CTAs at the probe's shape); each
// 32-deep k-step stages 64 x 32 bytes of a and 32 x 64 of b one byte a
// load between two barriers (b transposed byte by byte, 48 bytes a staged
// row), four dependent rounds of scalar loads at k = 128.
//
// i8_probe_kernel<kMode, kRows> takes two float32 planes (b, n), n = n1 x
// 128 with n1 <= 8, contiguous and 16-byte aligned, and int8 tables packed
// by the wrapper in B-fragment order (for table plane p, n-tile nt of its
// 128 output columns, k-step ks and lane L, eight bytes at
// ((p * 16 + nt) * 4 + ks) * 32 + L); it writes two new planes.  Every mode
// works on 16-row steps of one 128-column slice k1: the step's int8 digit
// planes are computed on the CUDA cores into shared memory in A-fragment
// order (a thread a row and 8 columns), then each of the 8 warps takes 16
// output columns (two n-tiles) and runs the mode's products over the four
// k-steps of the slice, then converts and stores.  kMode:
//   kMM (i8mm, :93): a = xr 100, b = xi 100, s = (xr + xi) 50, each
//     truncated to int8 (saturated out of range; in range as astype); with
//     the slice's random tables w0 (128 x 384), w1 (x 256), w2 (x 128):
//     yr = f32(sum over d of d w0[:, 0:128] + d w0[:, 128:256] + d w1[:, 0:128]) 1e-5,
//     yi = f32(sum over d of d w0[:, 256:] + d w1[:, 128:] + d w2) 1e-5,
//     the same integers as its q0 + q1 and q2; 2304 int8 MACs a point;
//   kDEC (i8dec, :123): the row scale of the slice (row_quant_scales of
//     max |xr| + |xi|: ck = K / S, s_out = S 2^32 / K^2 / 128, S = 2^(e + 1),
//     e = floor(log2 max) taken exactly from the exponent bits) and the first
//     digit d0 of xr ck, xi ck and (xr + xi) ck (digits3); yr = f32(sum of
//     d0 w0[:, 0:128] + d0 w0[:, 128:256]) s_out, yi = f32(sum of
//     d0 w0[:, 256:]) s_out; 1152 MACs a point;
//   kFULL (i8full_sync, i8_concat_stream): godsp_tpu/ops/_int8_contract.py's
//     karatsuba_g_i8 with K13's unscaled G (extra_scale 1/128): three digits
//     each of a = xr ck, b = xi ck and (xr + xi) ck against the digits
//     t0, t1, t2 of Gr, Gi and (Gr + Gi) / 2; per product the partials
//     Q0 = d0 t0, Q1 = d0 t1 + d1 t0, Q2 = d0 t2 + d1 t1 + d2 t0 (the six
//     products of i + j <= 2: the TPU's stacked w1 = [t0 | t1] and w2 = t0
//     repeat w0's blocks, so a slice has nine unique 16 KB planes, 144 KB,
//     not the stacked 288 KB); re = Qr - Qi, im = 2 Qs - Qr - Qi in int32,
//     then one float32 recombination (Q0 + 2^-8 Q1 + 2^-16 Q2) s_out each;
//     2304 MACs a point.
// Every float32 step is an IEEE operation in _int8_contract.py's order
// (__fadd_rn / __fmul_rn: nothing contracted to an FMA), the integers are
// exact, and int32 -> float32 rounds to nearest, so each mode equals its
// plain version (ops/cuda_probes.py) bit for bit.
// kRows picks the TPU body's store (kFULL only):
//   false (i8mm, i8dec, and i8full's first design i8full_sync, kept as the
//     yardstick: the slice's outputs stored as they come): block (k1, row
//     group) stages its slice's table planes once (144 KB for kFULL, 96 KB
//     kMM, 48 KB kDEC) and walks its group's 16-row steps, prefetching the
//     next step's inputs before the products.  The groups fill one wave
//     (occupancy x SMs blocks), so at 16384 x 1024 a kFULL block walks 1024
//     rows and the tables cost 128 x 144 KB = 18.9 MB of L2 reads, 7 % of
//     the 268 MB the planes move.  In kFULL one block an SM runs each
//     step's digits (the CUDA cores) and products (the tensor cores) in
//     turn behind two block barriers, and digits3's floors and float-to-int
//     conversions run on the SM's conversion pipe;
//   true (i8_concat_stream, the first design of _i8_concat_kernel, kept as
//     the yardstick: whole rows stored once a plane): block owns one 16-row
//     tile and walks its slices; the tile's outputs wait in shared memory
//     (2 x 16 rows x (n + 8) floats, 132 KB at n = 1024) and go out as
//     whole rows.  With them, a slice's 144 KB of tables no longer fits, so
//     each product's three planes (48 KB) are staged in turn: every tile
//     reads all 8 x 144 KB of tables again, 1.2 GB of L2 reads at 16384
//     rows, 4.4 x the planes' bytes, with six block barriers a slice and
//     no overlap of staging and products.
// i8_concat_kernel (_i8_concat_kernel, the redesign) keeps the whole-row
// store without re-staging: a thread-block cluster of n1 CTAs (n1 <= 8)
// covers a 16-row tile, CTA k1 holding slice k1's nine table planes
// (144 KB) for its whole life, staged once by cp.async.  As many clusters
// as the card holds (cudaOccupancyMaxActiveClusters) walk the tiles
// cl, cl + clusters, ...  A tile's slice arrives by cp.async in an input
// buffer while the last tile's products run; eight compute warps run
// i8full's digit_step and products<kFULL, 0..2> on it and push each output
// row r into the rows buffer of its owner, CTA r % n1, over distributed
// shared memory (st.shared::cluster), then arrive on the owner's full
// mbarrier (release at cluster scope).  A ninth, storer warp of the owner
// waits for it, stores its rows whole by bulk copies (the TMA) from its
// shared memory to device memory, and arrives on every CTA's empty
// mbarrier; the pushes of the tile after next wait for that (two rows
// buffers alternate), so the compute warps never wait on a cluster-wide
// barrier.  Tried on the way on the H100 and slower (development runs, not
// kept): the outputs over the inputs in three rotating buffers with each
// CTA gathering its rows from the cluster's buffers by remote loads behind
// two split cluster barriers a tile; that gather on a storer warp; the
// pushes above behind one cluster barrier a tile; and the rows sent from
// shared memory to the owner by bulk copies.  The same digit_step, mma_s8
// products and recombine in the same order make it equal to i8full and to
// i8_concat_stream bit for bit.  Shared memory: 182,336 bytes a CTA, two
// rows buffers of ceil(16 / n1) rows and four mbarriers (215,136 at
// n1 = 8, 225,376 at 7; lane_contract.cuh: i8_smem).
// i8full_kernel (_i8full_kernel :162, the redesign of i8full) overlaps
// the two kinds of work on one CTA an SM (make_fu_plan: a persistent grid,
// CTA c on slice c % n1 with its nine table planes resident, the slice's
// 16-row steps split evenly among its CTAs).  Four digit warps bring each
// step's points by cp.async into a ring of two steps (each thread its own
// 16 points: no barrier) and make its nine digit planes into one of two
// digit buffers, a uint4 of A fragment a plane a thread (conflict-free),
// with digits3's ladder by round-down adds (digits3_rd: no floor and no
// float-to-int conversion, the same digits); eight product warps run the
// same six mma a digit triple as products<kFULL> on the other buffer.  The
// roles hand the buffers over on named barriers (bar.arrive / bar.sync,
// kBarFull, kBarEmpty), so neither waits on a CTA-wide barrier; a product
// warp stores its rows 16 bytes a lane after one shuffle a pair.  The
// recombination keeps its IEEE order, so i8full equals i8full_sync,
// i8_concat and the plain version bit for bit.  What bounds it on the H100:
// its products' fragment loads, 2304 shared-memory wavefronts a step
// (cuda_probes.i8full_wavefronts), and the int8 mma.sync, each about the
// time of the bytes bound at 64 steps a CTA; wgmma (B read once for 64
// rows) would need 64-row steps, 72 KB of digits each, which do not fit
// twice beside the 144 KB of tables.  Shared memory: 217,216 bytes.
// Bound: bytes, 16 B a point, 268 MB, 0.080 ms (4608 int8 operations a
// point for kMM and kFULL, 2304 for kDEC: 0.039 / 0.020 ms at 1,979 TOPS).

#include <cuda_runtime.h>

#include <cstdint>

#include <cooperative_groups.h>

#include "fft_block.cuh"
#include "hopper_async.cuh"
#include "lane_contract.cuh"
#include "mma_s8.cuh"

namespace cg = cooperative_groups;
namespace hp = gdsp::hopper;
namespace ln = gdsp::lane;

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kTile = 16;                          // rows of a step: one m16 tile
constexpr int kPlane4 = kLanes * kLanes / 16;      // uint4s of a 128 x 128 int8 table plane
constexpr int kDigit4 = kTile * kLanes / 16;       // uint4s of a 16 x 128 int8 digit plane
constexpr int kOutPad = 8;                         // floats past n a staged output row
constexpr float kK = 8355584.f;                    // K_I8 = 2^23 - 2^15 - 2^8
constexpr float kB0 = 32896.5f;                    // 2^15 + 2^7 + 1/2
constexpr float kB1 = 128.5f;                      // 2^7 + 1/2
constexpr float kInvK2 = static_cast<float>(1.0 / (8355584.0 * 8355584.0));

enum { kMM = 0, kDEC = 1, kFULL = 2 };

__host__ __device__ constexpr int data_planes(int mode) { return mode == kFULL ? 9 : 3; }
__host__ __device__ constexpr int table_planes(int mode) {
  return mode == kFULL ? 9 : mode == kMM ? 6 : 3;
}
__host__ __device__ constexpr int accumulators(int mode) { return mode == kFULL ? 9 : 2; }

// 2^k as a float32, -126 <= k <= 127.
__device__ __forceinline__ float pow2(int k) { return __int_as_float((k + 127) << 23); }

__device__ __forceinline__ int sat_trunc(float x) {
  return static_cast<int>(fminf(fmaxf(truncf(x), -128.f), 127.f));
}

// _int8_contract.py's digits3: v = d0 2^16 + d1 2^8 + d2 + eps, |eps| <= 1/2,
// every digit in [-128, 127] for |v| <= K.
__device__ __forceinline__ void digits3(float v, int& d0, int& d1, int& d2) {
  const float f0 = floorf(__fmul_rn(__fadd_rn(v, kB0), 0x1p-16f));
  const float r0 = __fsub_rn(v, __fmul_rn(f0, 65536.f));
  const float f1 = floorf(__fmul_rn(__fadd_rn(r0, kB1), 0x1p-8f));
  const float r1 = __fsub_rn(r0, __fmul_rn(f1, 256.f));
  d0 = static_cast<int>(f0);
  d1 = static_cast<int>(f1);
  d2 = static_cast<int>(floorf(__fadd_rn(r1, 0.5f)));
}

// (Q0 + 2^-8 Q1 + 2^-16 Q2) s, _int8_contract.py's _recombine.
__device__ __forceinline__ float recombine(int q0, int q1, int q2, float s) {
  const float v = __fadd_rn(__fadd_rn(__int2float_rn(q0), __fmul_rn(0x1p-8f, __int2float_rn(q1))),
                            __fmul_rn(0x1p-16f, __int2float_rn(q2)));
  return __fmul_rn(v, s);
}

// ---------------------------------------------------------------------------
// i8_dot
// ---------------------------------------------------------------------------

constexpr int kDot = 64;      // rows and columns of a block's tile of c
constexpr int kDotK = 32;     // k of a step
constexpr int kDotRow = 48;   // bytes a staged row
constexpr int kDotThreads = 128;

__global__ void __launch_bounds__(kDotThreads)
i8_dot_bytes_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ bm,
                    int32_t* __restrict__ c, long long m, int k, int n) {
  __shared__ __align__(16) int8_t sa[kDot * kDotRow];  // [row][k]
  __shared__ __align__(16) int8_t sb[kDot * kDotRow];  // [column][k]
  const long long r0 = gdsp::block_row() * kDot;
  if (r0 >= m) return;
  const int c0 = blockIdx.x * kDot;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  int acc[kDot / 8][4] = {};
  for (int k0 = 0; k0 < k; k0 += kDotK) {
    __syncthreads();  // the last step's fragments are read
    for (int e = threadIdx.x; e < kDot * kDotK; e += kDotThreads) {
      const int r = e / kDotK, ka = e % kDotK;
      sa[r * kDotRow + ka] =
          r0 + r < m && k0 + ka < k ? a[static_cast<size_t>(r0 + r) * k + k0 + ka] : int8_t(0);
      const int kb = e / kDot, cc = e % kDot;
      sb[cc * kDotRow + kb] =
          k0 + kb < k && c0 + cc < n ? bm[static_cast<size_t>(k0 + kb) * n + c0 + cc] : int8_t(0);
    }
    __syncthreads();
    const int8_t* pa = sa + (16 * w + g) * kDotRow + 4 * t;
    const uint4 fa = make_uint4(*reinterpret_cast<const uint32_t*>(pa),
                                *reinterpret_cast<const uint32_t*>(pa + 8 * kDotRow),
                                *reinterpret_cast<const uint32_t*>(pa + 16),
                                *reinterpret_cast<const uint32_t*>(pa + 8 * kDotRow + 16));
#pragma unroll
    for (int nt = 0; nt < kDot / 8; ++nt) {
      const int8_t* pb = sb + (8 * nt + g) * kDotRow + 4 * t;
      gdsp::mma_s8(acc[nt], fa, make_uint2(*reinterpret_cast<const uint32_t*>(pb),
                                           *reinterpret_cast<const uint32_t*>(pb + 16)));
    }
  }
#pragma unroll
  for (int nt = 0; nt < kDot / 8; ++nt) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long r = r0 + 16 * w + g + 8 * (q >> 1);
      const int col = c0 + 8 * nt + 2 * t + (q & 1);
      if (r < m && col < n) c[static_cast<size_t>(r) * n + col] = acc[nt][q];
    }
  }
}

// ---------------------------------------------------------------------------
// i8_dot: 32 x 32 tiles, the tile's bytes in one round of 16-byte copies
// ---------------------------------------------------------------------------

constexpr int kDotTile = 32;                        // rows and columns of a CTA's tile of c
constexpr int kDotChunk = 128;                      // k of a chunk of the ring
constexpr int kDotStages = 4;                       // chunks in flight: k <= 512 in one round
constexpr int kDotPitch = kDotChunk + 16;           // bytes a staged row of a and of b^T
constexpr int kDotA = kDotTile * kDotPitch;         // a's chunk: 4,608 bytes
constexpr int kDotB = kDotChunk * kDotTile;         // b's chunk, row-major: 4,096 bytes
constexpr int kDotStage = kDotA + kDotB;
constexpr int kDotBt = kDotTile * kDotPitch;        // b's chunk transposed
constexpr int kDotWarps = 4;                        // a 2 x 2 grid of 16 x 16 warp tiles
constexpr int kDotPlanFields = 10;

// i8_dot's launch plan (ops/cuda_probes.py: I8DotPlan holds the same
// fields in this order).
struct DotPlan {
  int tile;     // rows and columns of a CTA's tile of c
  int ctas;     // CTAs of the grid (gx gy gz; past the last row tile they return)
  int gx, gy, gz;
  int vec;      // 1: 16-byte cp.async; 0: predicated byte loads
  int k_chunk;  // k of a chunk
  int stages;   // chunks in flight: min(chunks, 4)
  int smem;     // bytes of dynamic shared memory a CTA
  int threads;  // threads a CTA
};

// m, k, n >= 0; aligned: both operands 16-byte aligned.
int make_dot_plan(long long m, int k, int n, int aligned, DotPlan* p) {
  if (m < 0 || k < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (k + kDotChunk - 1) / kDotChunk;
  const int stages = chunks < kDotStages ? chunks : kDotStages;
  dim3 grid(0, 0, 0);
  if (m > 0 && n > 0)
    grid = gdsp::row_grid((n + kDotTile - 1) / kDotTile, (m + kDotTile - 1) / kDotTile);
  const long long ctas = static_cast<long long>(grid.x) * grid.y * grid.z;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  *p = DotPlan{kDotTile,
               static_cast<int>(ctas),
               static_cast<int>(grid.x),
               static_cast<int>(grid.y),
               static_cast<int>(grid.z),
               aligned && k % 16 == 0 && n % 16 == 0 ? 1 : 0,
               kDotChunk,
               stages,
               stages * kDotStage + kDotBt,
               kDotWarps * 32};
  return 0;
}

__device__ __forceinline__ uint32_t ld_word(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Chunk ch of the tile's a and b into stage ch % kDotStages: a's 32 rows x
// 128 k at kDotPitch, b's 128 k-rows x 32 columns with k-row r at slot
// (r % 4) (kDotChunk / 4) + r / 4 (so the transposing pass reads 32 banks).
template <bool kVec>
__device__ __forceinline__ void dot_issue(unsigned char* sm, int ch, const int8_t* a,
                                          const int8_t* bm, long long m, int k, int n,
                                          long long r0, int c0) {
  unsigned char* sa = sm + (ch % kDotStages) * kDotStage;
  unsigned char* sb = sa + kDotA;
  const int k0 = ch * kDotChunk;
  if constexpr (kVec) {
#pragma unroll
    for (int i = 0; i < kDotTile * kDotChunk / 16 / (kDotWarps * 32); ++i) {
      const int e = threadIdx.x + kDotWarps * 32 * i, r = e >> 3, p = e & 7, kk = k0 + 16 * p;
      const bool ok = r0 + r < m && kk < k;
      ln::cp_async16(sa + r * kDotPitch + 16 * p,
                     ok ? a + static_cast<size_t>(r0 + r) * k + kk : a, ok);
    }
#pragma unroll
    for (int i = 0; i < kDotChunk * kDotTile / 16 / (kDotWarps * 32); ++i) {
      const int e = threadIdx.x + kDotWarps * 32 * i, kr = e >> 1, p = e & 1;
      const int col = c0 + 16 * p;
      const bool ok = k0 + kr < k && col < n;
      const int slot = (kr & 3) * (kDotChunk / 4) + (kr >> 2);
      ln::cp_async16(sb + slot * kDotTile + 16 * p,
                     ok ? bm + static_cast<size_t>(k0 + kr) * n + col : bm, ok);
    }
  } else {
#pragma unroll 8
    for (int e = threadIdx.x; e < kDotTile * kDotChunk; e += kDotWarps * 32) {
      const int r = e / kDotChunk, kc = e % kDotChunk;
      sa[r * kDotPitch + kc] =
          r0 + r < m && k0 + kc < k
              ? static_cast<unsigned char>(a[static_cast<size_t>(r0 + r) * k + k0 + kc])
              : 0;
    }
#pragma unroll 8
    for (int e = threadIdx.x; e < kDotChunk * kDotTile; e += kDotWarps * 32) {
      const int kr = e / kDotTile, cc = e % kDotTile;
      const int slot = (kr & 3) * (kDotChunk / 4) + (kr >> 2);
      sb[slot * kDotTile + cc] =
          k0 + kr < k && c0 + cc < n
              ? static_cast<unsigned char>(bm[static_cast<size_t>(k0 + kr) * n + c0 + cc])
              : 0;
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kDotWarps * 32)
i8_dot_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ bm, int32_t* __restrict__ c,
              long long m, int k, int n) {
  extern __shared__ uint4 dot_smem[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(dot_smem);
  const long long r0 = gdsp::block_row() * kDotTile;
  if (r0 >= m) return;
  const int c0 = blockIdx.x * kDotTile;
  const int chunks = (k + kDotChunk - 1) / kDotChunk;
  const int stages = chunks < kDotStages ? chunks : kDotStages;
  unsigned char* bt = sm + stages * kDotStage;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int wr = w >> 1, wc = w & 1;

  for (int ch = 0; ch < stages; ++ch) {
    dot_issue<kVec>(sm, ch, a, bm, m, k, n, r0, c0);
    if constexpr (kVec) ln::cp_async_commit();
  }
  int acc[2][4] = {};
  for (int ch = 0; ch < chunks; ++ch) {
    if constexpr (kVec) {
      // Group j holds chunk j.  One round (chunks <= stages): wait once for
      // all; the ring: chunk ch is done when at most the newest stages - 1
      // (at ch = 0) or stages - 2 (later: one refill a step) are pending.
      if (chunks <= kDotStages) {
        if (ch == 0) ln::cp_async_wait<0>();
      } else if (ch == 0) {
        ln::cp_async_wait<kDotStages - 1>();
      } else {
        ln::cp_async_wait<kDotStages - 2>();
      }
    }
    __syncthreads();  // chunk ch is in; every thread is done with chunk ch - 1
    if (chunks > kDotStages && ch >= 1) {
      if (ch - 1 + kDotStages < chunks)
        dot_issue<kVec>(sm, ch - 1 + kDotStages, a, bm, m, k, n, r0, c0);
      if constexpr (kVec) ln::cp_async_commit();
    }
    // b's chunk transposed: a thread a 4 x 4 block of bytes (k-rows 4 blk ..,
    // columns 4 q ..) at a time, the four words written in a rotated order
    // so a warp's stores hit 32 banks.
    const unsigned char* sa = sm + (ch % kDotStages) * kDotStage;
    const unsigned char* sb = sa + kDotA;
#pragma unroll
    for (int i = 0; i < kDotChunk * kDotTile / 16 / (kDotWarps * 32); ++i) {
      const int e = threadIdx.x + kDotWarps * 32 * i, blk = e >> 3, q = e & 7;
      uint32_t r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        r[j] = ld_word(sb + (j * (kDotChunk / 4) + blk) * kDotTile + 4 * q);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int jc = (jj + (q >> 1)) & 3;
        const uint32_t sel = static_cast<uint32_t>(jc | ((jc + 4) << 4));
        const uint32_t lo = __byte_perm(r[0], r[1], sel), hi = __byte_perm(r[2], r[3], sel);
        *reinterpret_cast<uint32_t*>(bt + (4 * q + jc) * kDotPitch + 4 * blk) =
            __byte_perm(lo, hi, 0x5410);
      }
    }
    __syncthreads();
    const int left = k - ch * kDotChunk;
    const int steps = left < kDotChunk ? (left + 31) / 32 : kDotChunk / 32;
#pragma unroll
    for (int ks = 0; ks < kDotChunk / 32; ++ks) {
      if (ks < steps) {
        const unsigned char* pa = sa + (16 * wr + g) * kDotPitch + 32 * ks + 4 * t;
        const uint4 fa = make_uint4(ld_word(pa), ld_word(pa + 8 * kDotPitch), ld_word(pa + 16),
                                    ld_word(pa + 8 * kDotPitch + 16));
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const unsigned char* pb = bt + (16 * wc + 8 * nt + g) * kDotPitch + 32 * ks + 4 * t;
          gdsp::mma_s8(acc[nt], fa, make_uint2(ld_word(pb), ld_word(pb + 16)));
        }
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long long row = r0 + 16 * wr + g + 8 * hh;
      const int col = c0 + 16 * wc + 8 * nt + 2 * t;
      if (row >= m || col >= n) continue;
      int32_t* at = c + static_cast<size_t>(row) * n + col;
      if constexpr (kVec) {
        *reinterpret_cast<int2*>(at) = make_int2(acc[nt][2 * hh], acc[nt][2 * hh + 1]);
      } else {
        at[0] = acc[nt][2 * hh];
        if (col + 1 < n) at[1] = acc[nt][2 * hh + 1];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// i8mm, i8dec, i8full / i8_concat
// ---------------------------------------------------------------------------

// One thread's inputs of a step: row threadIdx.x / 16 of the tile, columns
// 8 (threadIdx.x % 16) .. + 7 of slice k1; rows at or past b read as 0.
struct StepIn {
  float4 r[2], i[2];
};

__device__ __forceinline__ void load_step(StepIn& s, const float* xr, const float* xi, long long b,
                                          int n, long long t0, int k1) {
  const long long row = t0 + (threadIdx.x >> 4);
  if (row < b) {
    const size_t off = static_cast<size_t>(row) * n + k1 * kLanes + 8 * (threadIdx.x & 15);
    s.r[0] = __ldg(reinterpret_cast<const float4*>(xr + off));
    s.r[1] = __ldg(reinterpret_cast<const float4*>(xr + off + 4));
    s.i[0] = __ldg(reinterpret_cast<const float4*>(xi + off));
    s.i[1] = __ldg(reinterpret_cast<const float4*>(xi + off + 4));
  } else {
    s.r[0] = s.r[1] = s.i[0] = s.i[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The step's digit planes into sd in A-fragment order (plane p, k-step ks,
// lane L, register q at word ((p * 4 + ks) * 32 + L) * 4 + q) and, for the
// modes with a row scale, each row's s_out into s_row.  A row is one half
// warp, so its max is a shuffle over 16 lanes.
template <int kMode>
__device__ __forceinline__ void digit_step(const StepIn& s, uint32_t* sd, float* s_row) {
  constexpr int kData = data_planes(kMode);
  const int row = threadIdx.x >> 4, part = threadIdx.x & 15;
  const float vr[8] = {s.r[0].x, s.r[0].y, s.r[0].z, s.r[0].w,
                       s.r[1].x, s.r[1].y, s.r[1].z, s.r[1].w};
  const float vi[8] = {s.i[0].x, s.i[0].y, s.i[0].z, s.i[0].w,
                       s.i[1].x, s.i[1].y, s.i[1].z, s.i[1].w};
  float ck = 0.f;
  if constexpr (kMode != kMM) {
    float mx = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) mx = fmaxf(mx, __fadd_rn(fabsf(vr[q]), fabsf(vi[q])));
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    mx = fmaxf(mx, 1e-30f);
    const int e = ((__float_as_int(mx) >> 23) & 0xff) - 127;  // floor(log2 mx): mx is normal
    ck = __fmul_rn(pow2(-e - 1), kK);
    if (part == 0) s_row[row] = __fmul_rn(kInvK2, pow2(e + 26));
  }
  const int g = row & 7, hi = row >> 3;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int c = 8 * part + 4 * u;
    const int ks = c >> 5, h = (c >> 4) & 1, t = (c >> 2) & 3;
    const int at = (ks * 32 + 4 * g + t) * 4 + hi + 2 * h;
    int d[kData][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float ar = vr[4 * u + q], ai = vi[4 * u + q];
      if constexpr (kMode == kMM) {
        d[0][q] = sat_trunc(__fmul_rn(ar, 100.f));
        d[1][q] = sat_trunc(__fmul_rn(ai, 100.f));
        d[2][q] = sat_trunc(__fmul_rn(__fadd_rn(ar, ai), 50.f));
      } else {
        const float x[3] = {ar, ai, __fadd_rn(ar, ai)};
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          int d0, d1, d2;
          digits3(__fmul_rn(x[p], ck), d0, d1, d2);
          if constexpr (kMode == kDEC) {
            d[p][q] = d0;
          } else {
            d[3 * p][q] = d0;
            d[3 * p + 1][q] = d1;
            d[3 * p + 2][q] = d2;
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kData; ++p)
      sd[p * kDigit4 * 4 + at] = gdsp::pack_s8(d[p][0], d[p][1], d[p][2], d[p][3]);
  }
}

// The products of one step for this warp's two n-tiles (output columns
// 16 w .. 16 w + 15 of the slice).  sd: digit planes; st: table planes
// staged from plane tb of the slice on (kFULL: product kP's three planes at
// tb); acc[a][j][q]: accumulator a, n-tile j, C register q.
template <int kMode, int kP>
__device__ __forceinline__ void products(const uint4* sd, const uint2* st, int tb,
                                         int (&acc)[accumulators(kMode)][2][4]) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  auto A = [&](int p, int ks) { return sd[(p * 4 + ks) * 32 + lane]; };
  auto B = [&](int p, int nt, int ks) { return st[(((p - tb) * 16 + nt) * 4 + ks) * 32 + lane]; };
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if constexpr (kMode == kFULL) {
      const uint4 d0 = A(3 * kP, ks), d1 = A(3 * kP + 1, ks), d2 = A(3 * kP + 2, ks);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int nt = 2 * w + j, p = 3 * kP;
        const uint2 t0 = B(p, nt, ks), t1 = B(p + 1, nt, ks), t2 = B(p + 2, nt, ks);
        gdsp::mma_s8(acc[p][j], d0, t0);
        gdsp::mma_s8(acc[p + 1][j], d0, t1);
        gdsp::mma_s8(acc[p + 1][j], d1, t0);
        gdsp::mma_s8(acc[p + 2][j], d0, t2);
        gdsp::mma_s8(acc[p + 2][j], d1, t1);
        gdsp::mma_s8(acc[p + 2][j], d2, t0);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int nt = 2 * w + j;
        uint2 tw[table_planes(kMode)];
#pragma unroll
        for (int p = 0; p < table_planes(kMode); ++p) tw[p] = B(p, nt, ks);
#pragma unroll
        for (int dp = 0; dp < 3; ++dp) {
          const uint4 d = A(dp, ks);
          // kMM planes w0a w0b w0c w1a w1b w2; kDEC planes w0a w0b w0c.
          gdsp::mma_s8(acc[0][j], d, tw[0]);
          gdsp::mma_s8(acc[0][j], d, tw[1]);
          gdsp::mma_s8(acc[1][j], d, tw[2]);
          if constexpr (kMode == kMM) {
            gdsp::mma_s8(acc[0][j], d, tw[3]);
            gdsp::mma_s8(acc[1][j], d, tw[4]);
            gdsp::mma_s8(acc[1][j], d, tw[5]);
          }
        }
      }
    }
  }
}

// The outputs of C register q of n-tile j (row g + 8 (q / 2) of the step).
template <int kMode>
__device__ __forceinline__ float2 outputs(const int (&acc)[accumulators(kMode)][2][4], int j, int q,
                                          float s) {
  if constexpr (kMode == kMM) {
    return make_float2(__fmul_rn(__int2float_rn(acc[0][j][q]), 1e-5f),
                       __fmul_rn(__int2float_rn(acc[1][j][q]), 1e-5f));
  } else if constexpr (kMode == kDEC) {
    return make_float2(__fmul_rn(__int2float_rn(acc[0][j][q]), s),
                       __fmul_rn(__int2float_rn(acc[1][j][q]), s));
  } else {
    int re[3], im[3];
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      re[l] = acc[l][j][q] - acc[3 + l][j][q];
      im[l] = 2 * acc[6 + l][j][q] - acc[l][j][q] - acc[3 + l][j][q];
    }
    return make_float2(recombine(re[0], re[1], re[2], s), recombine(im[0], im[1], im[2], s));
  }
}

__device__ __forceinline__ void stage(uint4* dst, const uint4* src, int count) {
  for (int e = threadIdx.x; e < count; e += kThreads) dst[e] = __ldg(src + e);
}

template <int kMode, bool kRows>
__global__ void __launch_bounds__(kThreads, kMode == kFULL ? 1 : 2)
i8_probe_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                float* __restrict__ yr, float* __restrict__ yi, const uint4* __restrict__ tables,
                long long b, int n, long long rows_per_block) {
  constexpr int kStaged = kRows ? 3 : table_planes(kMode);  // table planes in shared memory
  constexpr int kData = data_planes(kMode);
  extern __shared__ uint4 smem[];
  uint4* st = smem;
  uint4* sd = st + kStaged * kPlane4;
  float* s_row = reinterpret_cast<float*>(sd + kData * kDigit4);
  float* so = s_row + kTile;  // kRows: the tile's outputs, re then im, rows n + kOutPad apart
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int n1 = n / kLanes;
  const uint2* st2 = reinterpret_cast<const uint2*>(st);
  uint32_t* sd1 = reinterpret_cast<uint32_t*>(sd);
  StepIn in;

  if constexpr (!kRows) {
    const int k1 = blockIdx.x;
    const long long r0 = blockIdx.y * rows_per_block;
    if (r0 >= b) return;
    const long long r1 = r0 + rows_per_block < b ? r0 + rows_per_block : b;
    stage(st, tables + static_cast<size_t>(k1) * table_planes(kMode) * kPlane4,
          kStaged * kPlane4);
    load_step(in, xr, xi, b, n, r0, k1);
    for (long long t0 = r0; t0 < r1; t0 += kTile) {
      __syncthreads();  // the tables are staged; every warp has read the last step's digits
      digit_step<kMode>(in, sd1, s_row);
      __syncthreads();
      if (t0 + kTile < r1) load_step(in, xr, xi, b, n, t0 + kTile, k1);
      int acc[accumulators(kMode)][2][4] = {};
      if constexpr (kMode == kFULL) {
        products<kMode, 0>(sd, st2, 0, acc);
        products<kMode, 1>(sd, st2, 0, acc);
        products<kMode, 2>(sd, st2, 0, acc);
      } else {
        products<kMode, 0>(sd, st2, 0, acc);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = k1 * kLanes + 16 * w + 8 * j + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = g + 8 * h;  // C registers 2 h (column 2 t) and 2 h + 1
          const float sr = kMode == kMM ? 0.f : s_row[r];  // kMM writes no row scale
          const float2 v0 = outputs<kMode>(acc, j, 2 * h, sr);
          const float2 v1 = outputs<kMode>(acc, j, 2 * h + 1, sr);
          if (t0 + r < r1) {
            const size_t off = static_cast<size_t>(t0 + r) * n + col;
            *reinterpret_cast<float2*>(yr + off) = make_float2(v0.x, v1.x);
            *reinterpret_cast<float2*>(yi + off) = make_float2(v0.y, v1.y);
          }
        }
      }
    }
  } else {
    const int ld = n + kOutPad;
    const long long t0 = gdsp::block_row() * kTile;
    if (t0 >= b) return;
    load_step(in, xr, xi, b, n, t0, 0);
    for (int k1 = 0; k1 < n1; ++k1) {
      __syncthreads();  // every warp has read the last slice's digits and tables
      digit_step<kMode>(in, sd1, s_row);
      if (k1 + 1 < n1) load_step(in, xr, xi, b, n, t0, k1 + 1);
      int acc[accumulators(kMode)][2][4] = {};
      const uint4* tk = tables + static_cast<size_t>(k1) * table_planes(kMode) * kPlane4;
      stage(st, tk, 3 * kPlane4);
      __syncthreads();
      products<kMode, 0>(sd, st2, 0, acc);
      __syncthreads();
      stage(st, tk + 3 * kPlane4, 3 * kPlane4);
      __syncthreads();
      products<kMode, 1>(sd, st2, 3, acc);
      __syncthreads();
      stage(st, tk + 6 * kPlane4, 3 * kPlane4);
      __syncthreads();
      products<kMode, 2>(sd, st2, 6, acc);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = k1 * kLanes + 16 * w + 8 * j + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = g + 8 * h;  // C registers 2 h (column 2 t) and 2 h + 1
          const float sr = kMode == kMM ? 0.f : s_row[r];  // kMM writes no row scale
          const float2 v0 = outputs<kMode>(acc, j, 2 * h, sr);
          const float2 v1 = outputs<kMode>(acc, j, 2 * h + 1, sr);
          *reinterpret_cast<float2*>(so + r * ld + col) = make_float2(v0.x, v1.x);
          *reinterpret_cast<float2*>(so + (kTile + r) * ld + col) = make_float2(v0.y, v1.y);
        }
      }
    }
    __syncthreads();
    const int quads = n / 4;
    for (int e = threadIdx.x; e < kTile * quads; e += kThreads) {
      const int rr = e / quads, c = 4 * (e % quads);
      if (t0 + rr >= b) continue;
      const size_t off = static_cast<size_t>(t0 + rr) * n + c;
      *reinterpret_cast<float4*>(yr + off) = *reinterpret_cast<const float4*>(so + rr * ld + c);
      *reinterpret_cast<float4*>(yi + off) =
          *reinterpret_cast<const float4*>(so + (kTile + rr) * ld + c);
    }
  }
}

// ---------------------------------------------------------------------------
// i8_concat on a thread-block cluster
// ---------------------------------------------------------------------------

static_assert(kThreads == ln::kI8Threads && kTile == ln::kTileRows,
              "lane_contract.cuh's i8_concat plan");
constexpr int kBufWords = 2 * kTile * kLanes;  // the input tile buffer: two planes

// Slice k1 of tile `tile`'s rows into buf (plane re then im, 16 rows of
// 128) by cp.async, rows past b zero: four 16-byte copies a thread.  The
// caller commits.
__device__ __forceinline__ void load_tile(float* buf, const float* __restrict__ xr,
                                          const float* __restrict__ xi, long long b, int n,
                                          long long tile, int k1) {
  for (int e = threadIdx.x; e < 2 * kTile * (kLanes / 4); e += kThreads) {
    const int plane = e / (kTile * kLanes / 4);
    const int r = (e / (kLanes / 4)) % kTile, q = e % (kLanes / 4);
    const long long row = tile * kTile + r;
    const bool valid = row < b;
    const float* src =
        (plane ? xi : xr) + (valid ? static_cast<size_t>(row) * n + k1 * kLanes + 4 * q : 0);
    ln::cp_async16(buf + plane * kTile * kLanes + r * kLanes + 4 * q, src, valid);
  }
}

// load_step's values (row threadIdx.x / 16, columns 8 (threadIdx.x % 16)
// .. + 7 of the slice) from a tile buffer.
__device__ __forceinline__ void read_step(StepIn& s, const float* buf) {
  const float* p = buf + (threadIdx.x >> 4) * kLanes + 8 * (threadIdx.x & 15);
  s.r[0] = *reinterpret_cast<const float4*>(p);
  s.r[1] = *reinterpret_cast<const float4*>(p + 4);
  s.i[0] = *reinterpret_cast<const float4*>(p + kTile * kLanes);
  s.i[1] = *reinterpret_cast<const float4*>(p + kTile * kLanes + 4);
}

// tables: (n1, 9, 16384) bytes in B-fragment order.  Cluster cl (n1 CTAs,
// CTA k1 slice k1) takes tiles cl, cl + clusters, ...; row r of a tile
// belongs to CTA r % n1 (the header above says how its rows travel).
constexpr int kI8Warps = kThreads / 32;            // compute warps
constexpr int kI8AllThreads = kThreads + 32;       // and the storer warp

__global__ void __launch_bounds__(kI8AllThreads, 1)
i8_concat_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                 float* __restrict__ yr, float* __restrict__ yi,
                 const uint4* __restrict__ tables, long long b, int n) {
  constexpr int kData = data_planes(kFULL);
  extern __shared__ uint4 smem[];
  uint4* st = smem;
  uint4* sd = st + table_planes(kFULL) * kPlane4;
  float* s_row = reinterpret_cast<float*>(sd + kData * kDigit4);
  float* in_buf = s_row + kTile;            // the next tile's slice
  float* rows_buf = in_buf + kBufWords;     // two buffers of this CTA's rows, re then im
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int k1 = static_cast<int>(cluster.block_rank());
  const int rl_max = ln::i8_rows(cs);
  const int rows_words = 2 * rl_max * n;  // one buffer: two planes of rl_max rows
  uint64_t* full = reinterpret_cast<uint64_t*>(rows_buf + 2 * rows_words);
  uint64_t* empty = full + 2;
  const long long cl = blockIdx.x / cs, clusters = gridDim.x / cs;
  const long long tiles = (b + kTile - 1) / kTile;
  const long long steps = cl < tiles ? (tiles - 1 - cl) / clusters + 1 : 0;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    for (int k = 0; k < 2; ++k) {
      hp::mbar_init(full + k, kI8Warps * cs);  // every compute warp of every CTA
      hp::mbar_init(empty + k, cs);            // every CTA's storer warp
    }
    hp::mbar_init_fence();
  }
  ln::cluster_arrive();
  ln::cluster_wait();  // every CTA's barriers exist before any remote arrival

  if (w == kI8Warps) {
    // The storer warp: tile i's rows k1, k1 + cs, ... whole, once every
    // CTA's pushes of them landed.
    const int mine = (kTile - k1 + cs - 1) / cs;
    for (long long i = 0; i < steps; ++i) {
      const int k = static_cast<int>(i & 1);
      hp::mbar_wait_cluster(full + k, static_cast<uint32_t>(i >> 1) & 1u);
      if (lane == 0) {
        hp::fence_proxy_async();  // the pushes, to the bulk copies' reads
        const float* rb = rows_buf + k * rows_words;
        for (int rl = 0; rl < mine; ++rl) {
          const long long row = (cl + i * clusters) * kTile + k1 + cs * rl;
          if (row >= b) break;
          const size_t off = static_cast<size_t>(row) * n;
          hp::bulk_store(yr + off, rb + rl * n, static_cast<uint32_t>(n * 4));
          hp::bulk_store(yi + off, rb + (rl_max + rl) * n, static_cast<uint32_t>(n * 4));
        }
        hp::bulk_commit();
        hp::bulk_wait_read();
      }
      __syncwarp();
      if (lane < cs) hp::mbar_arrive_cluster(empty + k, lane);  // buffer k is free here
    }
    if (lane == 0) hp::bulk_wait_all();
  } else {
    const uint2* st2 = reinterpret_cast<const uint2*>(st);
    uint32_t* sd1 = reinterpret_cast<uint32_t*>(sd);
    const int g = lane >> 2, t = lane & 3;
    if (steps > 0) {
      const uint4* tk = tables + static_cast<size_t>(k1) * table_planes(kFULL) * kPlane4;
      for (int e = threadIdx.x; e < table_planes(kFULL) * kPlane4; e += kThreads)
        ln::cp_async16(st + e, tk + e, true);
      load_tile(in_buf, xr, xi, b, n, cl, k1);
    }
    ln::cp_async_commit();
    for (long long i = 0; i < steps; ++i) {
      const long long tile = cl + i * clusters;
      const int k = static_cast<int>(i & 1);
      ln::cp_async_wait_all();
      hp::named_sync(1, kThreads);  // tile i landed; every warp is done with the last products
      StepIn in;
      read_step(in, in_buf);
      digit_step<kFULL>(in, sd1, s_row);
      hp::named_sync(1, kThreads);  // digits and row scales in; in_buf is free
      if (i + 1 < steps) load_tile(in_buf, xr, xi, b, n, tile + clusters, k1);
      ln::cp_async_commit();
      int acc[accumulators(kFULL)][2][4] = {};
      products<kFULL, 0>(sd, st2, 0, acc);
      products<kFULL, 1>(sd, st2, 0, acc);
      products<kFULL, 2>(sd, st2, 0, acc);
      // Every owner has stored tile i - 2 from buffer k.
      if (i >= 2) hp::mbar_wait_cluster(empty + k, (static_cast<uint32_t>(i >> 1) & 1u) ^ 1u);
      float* rb = rows_buf + k * rows_words;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = k1 * kLanes + 16 * w + 8 * j + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = g + 8 * h;
          const float2 v0 = outputs<kFULL>(acc, j, 2 * h, s_row[r]);
          const float2 v1 = outputs<kFULL>(acc, j, 2 * h + 1, s_row[r]);
          const float* at = rb + (r / cs) * n + col;
          ln::st_cluster2(at, r % cs, v0.x, v1.x);
          ln::st_cluster2(at + rl_max * n, r % cs, v0.y, v1.y);
        }
      }
      __syncwarp();
      if (lane < cs) hp::mbar_arrive_cluster(full + k, lane);  // this warp's pushes to CTA lane
    }
  }
  ln::cluster_arrive();
  ln::cluster_wait();  // no CTA leaves while another may push into it or arrive on it
}

// ---------------------------------------------------------------------------
// i8full redesigned: digit warps and product warps on named barriers
// ---------------------------------------------------------------------------

constexpr int kFuDigitWarps = 4;                          // make a step's nine digit planes
constexpr int kFuMmaWarps = 8;                            // run its products, 16 columns each
constexpr int kFuDigitThreads = kFuDigitWarps * 32;
constexpr int kFuMmaThreads = kFuMmaWarps * 32;
constexpr int kFuThreads = kFuDigitThreads + kFuMmaThreads;
constexpr int kFuStages = 2;                              // steps of inputs in the ring
constexpr int kFuBufs = 2;                                // digit buffers
constexpr int kFuLoads = 8;                               // 16-byte copies a digit thread a step
constexpr int kFuStage4 = kFuDigitThreads * kFuLoads;     // uint4s of a ring stage: 16 KB
constexpr int kFuDigits4 = 9 * kDigit4;                   // uint4s of a step's digit planes
constexpr int kFuPlanFields = 6;
// Named barriers (0 is __syncthreads): kBarFull + k, digit buffer k holds
// its step; kBarEmpty + k, the product warps are done with it; kBarTables,
// the product warps' tables are in.
constexpr int kBarFull = 1;
constexpr int kBarEmpty = 3;
constexpr int kBarTables = 5;
static_assert(kFuStages == kFuBufs, "step i's ring stage and digit buffer are both i % 2");

constexpr int fu_smem() {
  return (9 * kPlane4 + kFuBufs * kFuDigits4 + kFuStages * kFuStage4) * 16 + kFuBufs * kTile * 4;
}

// i8full's launch plan (ops/cuda_probes.py: I8FullPlan holds the same
// fields in this order).
struct FuPlan {
  int ctas;         // a persistent grid: at most resident, at most slices x steps
  int threads;      // the digit warps, then the product warps
  int digit_warps;
  int mma_warps;
  int stages;       // steps of inputs in flight
  int smem;         // bytes of dynamic shared memory a CTA
};

int make_fu_plan(long long b, int n, int resident, FuPlan* p) {
  if (b < 0 || n < kLanes || n % kLanes != 0 || n / kLanes > 8 || resident < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // Every slice needs a CTA: at least n1 of them (items >= n1 where b > 0).
  const long long items = (b + kTile - 1) / kTile * (n / kLanes);
  const long long want = resident > n / kLanes ? resident : n / kLanes;
  *p = FuPlan{static_cast<int>(items < want ? items : want), kFuThreads, kFuDigitWarps,
              kFuMmaWarps, kFuStages, fu_smem()};
  return 0;
}

// bar.arrive on named barrier `id` for `threads` threads: this thread's
// earlier shared-memory writes are visible to the threads that bar.sync on
// it once it completes.
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// digits3's ladder with no floor and no float-to-int conversion: with M =
// 1.5 2^(23 + s), y + M rounded down is M + 2^s floor(y / 2^s) for |y| <
// 2^(22 + s) (the floats there are 2^s apart), so that sum's bits less M's
// are the digit and the sum less M is 2^s times it, exactly.  The remainders
// are the same IEEE subtractions as digits3's (2^16 d0 and 2^8 d1 exact), so
// the digits are digits3's; each is the low byte of its sum's bits (M's low
// byte is 0).
__device__ __forceinline__ void digits3_rd(float v, uint32_t& b0, uint32_t& b1, uint32_t& b2) {
  const float t0 = __fadd_rd(__fadd_rn(v, kB0), 0x1.8p39f);
  const float r0 = __fsub_rn(v, __fsub_rn(t0, 0x1.8p39f));
  const float t1 = __fadd_rd(__fadd_rn(r0, kB1), 0x1.8p31f);
  const float r1 = __fsub_rn(r0, __fsub_rn(t1, 0x1.8p31f));
  const float t2 = __fadd_rd(__fadd_rn(r1, 0.5f), 0x1.8p23f);
  b0 = __float_as_uint(t0);
  b1 = __float_as_uint(t1);
  b2 = __float_as_uint(t2);
}

// The low bytes of four words, the first lowest: one int8 register.
__device__ __forceinline__ uint32_t low_bytes(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// Digit thread d = lane 8 ks + 4 (g % 2) + t of digit warp g / 2 owns the A
// fragment of lane 4 g + t at k-step ks: rows g and g + 8, columns 32 ks +
// 4 t .. + 3 and 32 ks + 16 + 4 t .. + 3 (mma_s8.cuh).  Its copy j brings
// plane j / 4's row g + 8 ((j / 2) % 2), columns 32 ks + 16 (j % 2) + 4 t
// .. + 3 into ring word j kFuDigitThreads + d (ops/cuda_probes.py:
// i8full_digit_map).
__device__ __forceinline__ void fu_issue(uint4* stage, const float* __restrict__ xr,
                                         const float* __restrict__ xi, long long b, int n,
                                         long long step, int k1, int d, int ks, int g, int t) {
#pragma unroll
  for (int j = 0; j < kFuLoads; ++j) {
    const long long row = step * kTile + g + 8 * ((j >> 1) & 1);
    const bool valid = row < b;
    const float* src = (j >> 2 ? xi : xr) +
        (valid ? static_cast<size_t>(row) * n + k1 * kLanes + 32 * ks + 16 * (j & 1) + 4 * t : 0);
    ln::cp_async16(stage + j * kFuDigitThreads + d, src, valid);
  }
}

// A step's digit planes from this thread's sixteen points (q: its copies)
// into the buffer sd (plane p's uint4 of lane 4 g + t at k-step ks at
// p kDigit4 + 32 ks + 4 g + t, i8_probe_kernel's A-fragment order), and the
// row scales of rows g and g + 8 into s_row: the row max over the 16 lanes
// of a row (lane bits 0, 1, 3, 4) by shuffles, then digit_step's scales and
// digits3's digits, operation for operation.
__device__ __forceinline__ void fu_digit_step(const float4 (&q)[kFuLoads], uint4* sd, float* s_row,
                                              int ks, int g, int t) {
  float mx[2] = {0.f, 0.f};
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 a = q[2 * hi + h], c = q[4 + 2 * hi + h];
      mx[hi] = fmaxf(mx[hi], __fadd_rn(fabsf(a.x), fabsf(c.x)));
      mx[hi] = fmaxf(mx[hi], __fadd_rn(fabsf(a.y), fabsf(c.y)));
      mx[hi] = fmaxf(mx[hi], __fadd_rn(fabsf(a.z), fabsf(c.z)));
      mx[hi] = fmaxf(mx[hi], __fadd_rn(fabsf(a.w), fabsf(c.w)));
    }
  }
  float ck[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 1));
    mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 2));
    mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 8));
    mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 16));
    mx[hi] = fmaxf(mx[hi], 1e-30f);
    const int e = ((__float_as_int(mx[hi]) >> 23) & 0xff) - 127;  // floor(log2 mx): mx is normal
    ck[hi] = __fmul_rn(pow2(-e - 1), kK);
    if (ks == 0 && t == 0) s_row[g + 8 * hi] = __fmul_rn(kInvK2, pow2(e + 26));
  }
  uint32_t word[9][4];  // plane, A register (row g + 8 (r % 2), column half r / 2)
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int hi = r & 1, h = r >> 1;
    const float4 a4 = q[2 * hi + h], c4 = q[4 + 2 * hi + h];
    const float ar[4] = {a4.x, a4.y, a4.z, a4.w}, ai[4] = {c4.x, c4.y, c4.z, c4.w};
    uint32_t bytes[9][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x[3] = {ar[e], ai[e], __fadd_rn(ar[e], ai[e])};
#pragma unroll
      for (int p = 0; p < 3; ++p)
        digits3_rd(__fmul_rn(x[p], ck[hi]), bytes[3 * p][e], bytes[3 * p + 1][e],
                   bytes[3 * p + 2][e]);
    }
#pragma unroll
    for (int p = 0; p < 9; ++p)
      word[p][r] = low_bytes(bytes[p][0], bytes[p][1], bytes[p][2], bytes[p][3]);
  }
#pragma unroll
  for (int p = 0; p < 9; ++p)
    sd[p * kDigit4 + 32 * ks + 4 * g + t] = make_uint4(word[p][0], word[p][1], word[p][2],
                                                       word[p][3]);
}

// products<kFULL, kP> for product warp mw (output columns 16 mw .. + 15 of
// the slice): the same six mma a k-step and n-tile in the same order.
template <int kP>
__device__ __forceinline__ void fu_products(const uint4* sd, const uint2* st, int mw, int lane,
                                            int (&acc)[9][2][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint4 d0 = sd[((3 * kP) * 4 + ks) * 32 + lane];
    const uint4 d1 = sd[((3 * kP + 1) * 4 + ks) * 32 + lane];
    const uint4 d2 = sd[((3 * kP + 2) * 4 + ks) * 32 + lane];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int nt = 2 * mw + j, p = 3 * kP;
      const uint2 t0 = st[((p * 16 + nt) * 4 + ks) * 32 + lane];
      const uint2 t1 = st[(((p + 1) * 16 + nt) * 4 + ks) * 32 + lane];
      const uint2 t2 = st[(((p + 2) * 16 + nt) * 4 + ks) * 32 + lane];
      gdsp::mma_s8(acc[p][j], d0, t0);
      gdsp::mma_s8(acc[p + 1][j], d0, t1);
      gdsp::mma_s8(acc[p + 1][j], d1, t0);
      gdsp::mma_s8(acc[p + 2][j], d0, t2);
      gdsp::mma_s8(acc[p + 2][j], d1, t1);
      gdsp::mma_s8(acc[p + 2][j], d2, t0);
    }
  }
}

// i8full on one CTA an SM (make_fu_plan): CTA c takes slice k1 = c % n1, and
// the G CTAs of a slice split its T 16-row steps as [g T / G, (g + 1) T / G),
// g = c / n1.  Digit warps: each step's points by cp.async into a ring of
// kFuStages steps (every thread its own sixteen), their digits into digit
// buffer i % 2 once the product warps are done with step i - 2 (kBarEmpty),
// then kBarFull.  Product warps: the slice's tables by cp.async once, then
// for each step, once kBarFull completes, its products, the row scales read,
// kBarEmpty (but for the last two steps), the recombination and the store:
// each row's 16 columns of a warp as four 16-byte stores a plane, each lane
// trading one pair of columns with lane t ^ 1.
__global__ void __launch_bounds__(kFuThreads, 1)
i8full_kernel(const float* __restrict__ xr, const float* __restrict__ xi, float* __restrict__ yr,
              float* __restrict__ yi, const uint4* __restrict__ tables, long long b, int n) {
  extern __shared__ uint4 smem[];
  uint4* st = smem;                                // the slice's nine table planes
  uint4* sd = st + 9 * kPlane4;                    // kFuBufs digit buffers
  uint4* ring = sd + kFuBufs * kFuDigits4;         // kFuStages input stages
  float* s_row = reinterpret_cast<float*>(ring + kFuStages * kFuStage4);  // kFuBufs x 16
  const int n1 = n / kLanes;
  const int k1 = static_cast<int>(blockIdx.x % n1);
  const long long g_cta = blockIdx.x / n1;
  const long long per = (static_cast<long long>(gridDim.x) - k1 + n1 - 1) / n1;  // the slice's
  const long long steps_all = (b + kTile - 1) / kTile;
  const long long first = g_cta * steps_all / per;
  const long long steps = (g_cta + 1) * steps_all / per - first;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (w < kFuDigitWarps) {
    const int d = threadIdx.x;
    const int ks = lane >> 3, g = 2 * w + ((lane >> 2) & 1), t = lane & 3;
    for (int s = 0; s < kFuStages; ++s) {
      if (s < steps) fu_issue(ring + s * kFuStage4, xr, xi, b, n, first + s, k1, d, ks, g, t);
      ln::cp_async_commit();
    }
    for (long long i = 0; i < steps; ++i) {
      const int k = static_cast<int>(i & 1);
      ln::cp_async_wait<kFuStages - 1>();  // step i's copies (this thread's own) landed
      uint4* stage = ring + k * kFuStage4;
      float4 q[kFuLoads];
#pragma unroll
      for (int j = 0; j < kFuLoads; ++j) {
        const uint4 u = stage[j * kFuDigitThreads + d];
        q[j] = make_float4(__uint_as_float(u.x), __uint_as_float(u.y), __uint_as_float(u.z),
                           __uint_as_float(u.w));
      }
      if (i >= kFuBufs) hp::named_sync(kBarEmpty + k, kFuThreads);  // step i - 2 is read
      fu_digit_step(q, sd + k * kFuDigits4, s_row + k * kTile, ks, g, t);
      named_arrive(kBarFull + k, kFuThreads);
      // The stage is refilled once its values are used (the digits above).
      if (i + kFuStages < steps)
        fu_issue(stage, xr, xi, b, n, first + i + kFuStages, k1, d, ks, g, t);
      ln::cp_async_commit();
    }
  } else {
    const int mt = threadIdx.x - kFuDigitThreads, mw = w - kFuDigitWarps;
    const int g = lane >> 2, t = lane & 3;
    const uint4* tk = tables + static_cast<size_t>(k1) * 9 * kPlane4;
    for (int e = mt; e < 9 * kPlane4; e += kFuMmaThreads) ln::cp_async16(st + e, tk + e, true);
    ln::cp_async_commit();
    ln::cp_async_wait_all();
    hp::named_sync(kBarTables, kFuMmaThreads);  // every product warp's share of the tables
    const uint2* st2 = reinterpret_cast<const uint2*>(st);
    const bool odd = t & 1;
    const int col = k1 * kLanes + 16 * mw + (odd ? 6 + 2 * t : 2 * t);  // a lane's four columns
    for (long long i = 0; i < steps; ++i) {
      const int k = static_cast<int>(i & 1);
      hp::named_sync(kBarFull + k, kFuThreads);
      const uint4* sdk = sd + k * kFuDigits4;
      int acc[9][2][4] = {};
      fu_products<0>(sdk, st2, mw, lane, acc);
      fu_products<1>(sdk, st2, mw, lane, acc);
      fu_products<2>(sdk, st2, mw, lane, acc);
      const float sr[2] = {s_row[k * kTile + g], s_row[k * kTile + g + 8]};
      if (i + kFuBufs < steps) named_arrive(kBarEmpty + k, kFuThreads);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // C registers 2 h, 2 h + 1 of n-tile j: row g + 8 h, columns 8 j + 2 t, + 1.
        const float2 a0 = outputs<kFULL>(acc, 0, 2 * h, sr[h]);
        const float2 a1 = outputs<kFULL>(acc, 0, 2 * h + 1, sr[h]);
        const float2 c0 = outputs<kFULL>(acc, 1, 2 * h, sr[h]);
        const float2 c1 = outputs<kFULL>(acc, 1, 2 * h + 1, sr[h]);
        // Even t keeps n-tile 0's pair and takes lane t + 1's; odd t takes
        // lane t - 1's n-tile 1 pair and keeps its own.
        const float2 re_send = odd ? make_float2(a0.x, a1.x) : make_float2(c0.x, c1.x);
        const float2 im_send = odd ? make_float2(a0.y, a1.y) : make_float2(c0.y, c1.y);
        const float2 re_got = make_float2(__shfl_xor_sync(0xffffffffu, re_send.x, 1),
                                          __shfl_xor_sync(0xffffffffu, re_send.y, 1));
        const float2 im_got = make_float2(__shfl_xor_sync(0xffffffffu, im_send.x, 1),
                                          __shfl_xor_sync(0xffffffffu, im_send.y, 1));
        const float4 re = odd ? make_float4(re_got.x, re_got.y, c0.x, c1.x)
                              : make_float4(a0.x, a1.x, re_got.x, re_got.y);
        const float4 im = odd ? make_float4(im_got.x, im_got.y, c0.y, c1.y)
                              : make_float4(a0.y, a1.y, im_got.x, im_got.y);
        const long long row = (first + i) * kTile + g + 8 * h;
        if (row < b) {
          const size_t off = static_cast<size_t>(row) * n + col;
          *reinterpret_cast<float4*>(yr + off) = re;
          *reinterpret_cast<float4*>(yi + off) = im;
        }
      }
    }
  }
}

int launch_i8full(const float* xr, const float* xi, float* yr, float* yi, const void* tables,
                  long long b, int n, int resident, cudaStream_t s) {
  FuPlan p;
  const int rc = make_fu_plan(b, n, resident, &p);
  if (rc != 0) return rc;
  if (b == 0) return 0;
  cudaError_t e = gdsp::allow_smem(i8full_kernel, static_cast<size_t>(p.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  i8full_kernel<<<p.ctas, p.threads, p.smem, s>>>(xr, xi, yr, yi,
                                                  static_cast<const uint4*>(tables), b, n);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode, bool kRows>
int probe_smem(int n) {
  const int staged = kRows ? 3 : table_planes(kMode);
  const int out = kRows ? 2 * kTile * (n + kOutPad) * 4 : 0;
  return (staged * kPlane4 + data_planes(kMode) * kDigit4) * 16 + kTile * 4 + out;
}

template <int kMode, bool kRows>
int launch_probe(const float* xr, const float* xi, float* yr, float* yi, const void* tables,
                 long long b, int n, cudaStream_t s) {
  if (b < 0 || n < kLanes || n % kLanes != 0 || n / kLanes > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  const auto kernel = i8_probe_kernel<kMode, kRows>;
  const int smem = probe_smem<kMode, kRows>(n);
  cudaError_t e = gdsp::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles = (b + kTile - 1) / kTile;
  const uint4* tab = static_cast<const uint4*>(tables);
  if (kRows) {
    kernel<<<gdsp::row_grid(1, tiles), kThreads, smem, s>>>(xr, xi, yr, yi, tab, b, n, kTile);
    return static_cast<int>(cudaGetLastError());
  }
  // One wave: as many blocks as the SMs hold, split over the slices.
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return static_cast<int>(e);
  const int n1 = n / kLanes;
  long long groups = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms / n1;
  if (groups < 1) groups = 1;
  if (groups > tiles) groups = tiles;
  const long long per = (tiles + groups - 1) / groups;  // tiles a block
  groups = (tiles + per - 1) / per;
  kernel<<<dim3(n1, static_cast<unsigned>(groups)), kThreads, smem, s>>>(
      xr, xi, yr, yi, tab, b, n, per * kTile);
  return static_cast<int>(cudaGetLastError());
}

int launch_i8_concat(const float* xr, const float* xi, float* yr, float* yi,
                     const void* tables, long long b, int n, int resident, cudaStream_t s) {
  ln::Plan p;
  const int rc = ln::make_plan(ln::kI8Concat, b, n, 0, 0, 0, resident, &p);
  if (rc != 0) return rc;
  if (b == 0) return 0;
  cudaError_t e = gdsp::allow_smem(i8_concat_kernel, static_cast<size_t>(p.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  ln::ClusterLaunch l(p.cluster, p.ctas, static_cast<size_t>(p.smem), s, kI8AllThreads);
  e = cudaLaunchKernelEx(&l.cfg, i8_concat_kernel, xr, xi, yr, yi,
                         static_cast<const uint4*>(tables), b, n);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// c (m, n) int32 = a (m, k) int8 @ b (k, n) int8, all row-major and
// contiguous, c 8-byte aligned; the 16-byte path where both operands are
// 16-byte aligned and k and n are multiples of 16, else the byte path.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a negative extent.
int gdsp_i8_dot(const int8_t* a, const int8_t* b, int32_t* c, long long m, int k, int n,
                void* stream) {
  DotPlan p;
  const int aligned = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const int rc = make_dot_plan(m, k, n, aligned, &p);
  if (rc != 0) return rc;
  if (p.ctas == 0) return 0;
  const dim3 grid(p.gx, p.gy, p.gz);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.vec)
    i8_dot_kernel<true><<<grid, p.threads, p.smem, s>>>(a, b, c, m, k, n);
  else
    i8_dot_kernel<false><<<grid, p.threads, p.smem, s>>>(a, b, c, m, k, n);
  return static_cast<int>(cudaGetLastError());
}

// i8_dot's plan at (m, k, n), aligned: both operands 16-byte aligned:
// out[0..9] = tile, CTAs, grid x, y, z, 16-byte path, k a chunk, stages,
// shared bytes, threads (DotPlan).  ops/cuda_probes.py: i8_dot_plan holds
// the same; the GPU tests and phase 3 compare.
int gdsp_i8_dot_geometry(long long m, int k, int n, int aligned, int* out) {
  DotPlan p;
  const int rc = make_dot_plan(m, k, n, aligned, &p);
  if (rc != 0) return rc;
  const int v[kDotPlanFields] = {p.tile,    p.ctas,   p.gx,     p.gy,   p.gz,
                                 p.vec,     p.k_chunk, p.stages, p.smem, p.threads};
  for (int i = 0; i < kDotPlanFields; ++i) out[i] = v[i];
  return 0;
}

// i8_dot's first design, the yardstick: 64 x 64 tiles, each 32-deep k-step
// staged a byte a load.
int gdsp_i8_dot_bytes(const int8_t* a, const int8_t* b, int32_t* c, long long m, int k, int n,
                      void* stream) {
  if (m < 0 || k < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return 0;
  const dim3 grid = gdsp::row_grid((n + kDot - 1) / kDot, (m + kDot - 1) / kDot);
  i8_dot_bytes_kernel<<<grid, kDotThreads, 0, static_cast<cudaStream_t>(stream)>>>(a, b, c, m, k,
                                                                                    n);
  return static_cast<int>(cudaGetLastError());
}

// Each int8-limb entry: (b, n) float32 planes, n = n1 x 128 with n1 <= 8,
// every pointer 16-byte aligned; tables: the slices' table planes in
// B-fragment order, (n1, planes, 16384) bytes (i8mm 6 planes: w0's three
// blocks, w1's two, w2; i8dec 3: w0's blocks; i8full 9: the digits t0, t1,
// t2 of Gr, Gi, (Gr + Gi) / 2).  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape or setting the kernel does not take.

int gdsp_i8mm(const float* xr, const float* xi, float* yr, float* yi, const void* tables,
              long long b, int n, void* stream) {
  return launch_probe<kMM, false>(xr, xi, yr, yi, tables, b, n, static_cast<cudaStream_t>(stream));
}

int gdsp_i8dec(const float* xr, const float* xi, float* yr, float* yi, const void* tables,
               long long b, int n, void* stream) {
  return launch_probe<kDEC, false>(xr, xi, yr, yi, tables, b, n,
                                   static_cast<cudaStream_t>(stream));
}

// store_rows 0: each slice stored as it ends (i8full: i8full_kernel on a
// persistent grid of `resident` CTAs at most, gdsp_i8full_resident, its
// plan make_fu_plan; cudaErrorInvalidValue where resident < 1); 1: whole
// rows of a 16-row tile gathered over a thread-block cluster (i8_concat),
// resident the clusters of i8_concat_kernel the card holds at once
// (gdsp_i8_concat_resident); returns cudaErrorLaunchOutOfResources where
// resident < 1.
int gdsp_i8full(const float* xr, const float* xi, float* yr, float* yi, const void* tables,
                long long b, int n, int store_rows, int resident, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (store_rows == 0) return launch_i8full(xr, xi, yr, yi, tables, b, n, resident, s);
  if (store_rows == 1) return launch_i8_concat(xr, xi, yr, yi, tables, b, n, resident, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// CTAs of i8full_kernel the card holds at once (SMs x blocks a SM at its
// shared memory): 0 where none fits, or -(CUDA error).
int gdsp_i8full_resident() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = gdsp::allow_smem(i8full_kernel, static_cast<size_t>(fu_smem()));
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, i8full_kernel, kFuThreads,
                                                      fu_smem());
  return e == cudaSuccess ? sms * per_sm : -static_cast<int>(e);
}

// i8full's plan at (b, n) over `resident` CTAs: out[0..5] = CTAs, threads,
// digit warps, product warps, input stages, shared bytes (FuPlan).
// ops/cuda_probes.py: i8full_plan holds the same; the GPU tests and phase 3
// compare.
int gdsp_i8full_geometry(long long b, int n, int resident, int* out) {
  FuPlan p;
  const int rc = make_fu_plan(b, n, resident, &p);
  if (rc != 0) return rc;
  const int v[kFuPlanFields] = {p.ctas, p.threads, p.digit_warps, p.mma_warps, p.stages, p.smem};
  for (int i = 0; i < kFuPlanFields; ++i) out[i] = v[i];
  return 0;
}

// i8full's first design, the yardstick: a block a slice and a row group,
// the slice's nine table planes staged once, each 16-row step's digits then
// its products behind two block barriers.
int gdsp_i8full_sync(const float* xr, const float* xi, float* yr, float* yi, const void* tables,
                     long long b, int n, void* stream) {
  return launch_probe<kFULL, false>(xr, xi, yr, yi, tables, b, n,
                                    static_cast<cudaStream_t>(stream));
}

// i8_concat's first design, the yardstick: a block a 16-row tile walking
// its slices, each product's three table planes staged in turn.
int gdsp_i8_concat_stream(const float* xr, const float* xi, float* yr, float* yi,
                          const void* tables, long long b, int n, void* stream) {
  return launch_probe<kFULL, true>(xr, xi, yr, yi, tables, b, n,
                                   static_cast<cudaStream_t>(stream));
}

// Clusters of i8_concat_kernel at n points (n / 128 CTAs a cluster) the
// card holds at once with the plan's shared memory plus extra_smem bytes a
// CTA: 0 where none fits, or -(CUDA error).
int gdsp_i8_concat_resident(int n, int extra_smem) {
  if (n < kLanes || n % kLanes != 0 || n / kLanes > ln::kMaxCluster)
    return -static_cast<int>(cudaErrorInvalidValue);
  return ln::resident_clusters(i8_concat_kernel, n / kLanes, ln::i8_smem(n / kLanes) + extra_smem,
                               kI8AllThreads);
}

}  // extern "C"
