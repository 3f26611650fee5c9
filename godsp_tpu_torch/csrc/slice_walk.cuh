// The slice walk of two float32 planes (b, n), n a multiple of 128: a block
// covers a chunk of up to 1024 columns (eight 128-column slices) of eight
// rows, one warp a row, grid (chunks, row tiles) with the row tiles past
// grid.y's 65535 walked in steps of gridDim.y.  Each warp issues every
// slice's 16-byte loads of its row's chunk (16 a thread) before its first
// store, then stores the slices one at a time, 16 bytes a thread, each
// value through Op.  Used by slice8_kernel (anatomy_probe_kernels.cu, Op
// AddOne: x + 1) and slicestore_kernel (lane_probe_kernels.cu, Op
// Identity: a copy).  Why the loads go first: PERF.md section 6, "Reading:
// slice8_add's 34 %".

#pragma once

#include <cuda_runtime.h>

namespace gdsp {
namespace slice_walk {

constexpr int kLanes = 128;   // a slice
constexpr int kChunk = 1024;  // columns a block: eight slices
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // rows a block

struct AddOne {
  __device__ __forceinline__ float4 operator()(float4 v) const {
    return make_float4(v.x + 1.f, v.y + 1.f, v.z + 1.f, v.w + 1.f);
  }
};

struct Identity {
  __device__ __forceinline__ float4 operator()(float4 v) const { return v; }
};

template <typename Op>
__device__ __forceinline__ void walk(const float* __restrict__ xr, const float* __restrict__ xi,
                                     float* __restrict__ yr, float* __restrict__ yi, long long b,
                                     int n, Op op) {
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
        *reinterpret_cast<float4*>(yr + at + s * kLanes) = op(a[s]);
        *reinterpret_cast<float4*>(yi + at + s * kLanes) = op(c[s]);
      }
  }
}

// The walk's grid: chunks of the row by row tiles (at most 65535).
inline dim3 grid(long long b, int n) {
  const long long tiles = (b + kWarps - 1) / kWarps;
  return dim3((n + kChunk - 1) / kChunk, static_cast<unsigned>(tiles < 65535 ? tiles : 65535));
}

}  // namespace slice_walk
}  // namespace gdsp
