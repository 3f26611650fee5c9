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
// dense-DFT design.  On the H100, K1 (fft_kernels.cu) is a radix-2 FFT
// in shared memory and runs no such contraction: here the kernel's time
// says what the TPU's dense-DFT design of one K1 step costs on this card,
// beside K1's radix-2 design.  A later K1 on tensor cores needs that
// answer.
//
// Bound on the H100: the larger of 16 B a point over 3.35 TB/s and 768
// float32 operations a point (three real dot products of 128 terms, two
// operations a term) over 67 TFLOP/s; operations, at every n.
// Design (simple, right first): one block per (slice k1, group of rows).
// The block stages G[k1] as three float32 planes (Re G, Im G, Re G + Im G:
// the Karatsuba form, 192 KB) in shared memory once, then walks its rows
// in tiles of 32: the tile's 32 x 128 complex inputs go to shared memory
// (32 KB), and each thread accumulates a 4-row x 4-bin register tile over
// the 128 terms in float32 FMA on the CUDA cores (no TF32, no wgmma):
//   m1 = Re x . Re G,  m2 = Im x . Im G,  m3 = (Re x + Im x) . (Re G + Im G),
//   Re y = m1 - m2,  Im y = m3 - m1 - m2.
// A warp's 32 lanes read 32 consecutive bins of G (no bank conflicts) and
// one broadcast input each.  The tables are built in float64 on the host
// and rounded once to float32 (ops/cuda_metrics.py).

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kPlane = kLanes * kLanes;  // one plane of G[k1]
constexpr int kRowTile = 32;             // rows of x staged a step
constexpr int kThreads = 256;            // 8 warps: 4 rows each, 32 lanes x 4 bins
constexpr int kGmmSmem = (3 * kPlane + 2 * kRowTile * kLanes) * sizeof(float);

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
gmm_floor_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
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
// g: the (n / 128, 3, 128, 128) tables.  groups: row groups per slice
// (grid.y, <= 65535).  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape the kernel does not take.
int gdsp_gmm_floor(const float* xr, const float* xi, float* yr, float* yi, const float* g,
                   long long b, int n, int groups, void* stream) {
  if (n < kLanes || n % kLanes != 0 || groups < 1 || groups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0) return 0;
  cudaError_t e = gdsp::allow_smem(gmm_floor_kernel, kGmmSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  long long per = (b + groups - 1) / groups;
  per = (per + kRowTile - 1) / kRowTile * kRowTile;
  const dim3 grid(n / kLanes, static_cast<unsigned>((b + per - 1) / per));
  gmm_floor_kernel<<<grid, kThreads, kGmmSmem, static_cast<cudaStream_t>(stream)>>>(
      xr, xi, yr, yi, g, b, n, per);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
