// Host-side launch helpers shared by every kernel source: the dynamic
// shared-memory attribute, a grid that serves more rows than grid.y's
// 65535, and threads a block for a radix-2 stage.  No device arithmetic.

#pragma once

#include <cuda_runtime.h>

namespace gdsp {

// Threads per block for `butterflies` butterflies a stage: a multiple of
// the warp, at most 512.
inline int block_threads(long long butterflies) {
  long long t = butterflies < 512 ? butterflies : 512;
  t = (t + 31) / 32 * 32;
  return static_cast<int>(t);
}

// A grid of x blocks per row over `rows` rows (rows > 0), spread over
// grid.y and grid.z: one launch serves more rows than grid.y's 65535.
// The last z slice may overshoot, so a kernel reads its row with
// block_row() and returns at once when it is past the last row.
inline dim3 row_grid(unsigned x, long long rows) {
  const long long y = rows < 65535 ? rows : 65535;
  return dim3(x, static_cast<unsigned>(y), static_cast<unsigned>((rows + y - 1) / y));
}

__device__ __forceinline__ long long block_row() {
  return blockIdx.y + static_cast<long long>(gridDim.y) * blockIdx.z;
}

// Allow more than 48 KB of dynamic shared memory where a launch needs it.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel k, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace gdsp
