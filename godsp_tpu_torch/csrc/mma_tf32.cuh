// One TF32 tensor-core product a warp, mma.sync.aligned.m16n8k8 by
// inline PTX, with its operand rounding and fragment loads and stores:
// used by bd_tf32_kernel, bd_hi_kernel and anat_full_kernel
// (anatomy_probe_kernels.cu) and gmm_tf32_kernel
// (lane_slice_probe_kernels.cu).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace gdsp {

// Fragments (PTX ISA, "Matrix Fragments for mma.m16n8k8", .tf32), with
// g = lane / 4 and t = lane % 4:
//   A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
//   B (8 x 8, col):  b0 (t, g), b1 (t + 4, g);
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The four A values of k-step k0 from a row-major tile at p (row stride
// ld), rows at or past `rows` read as 0 (and not at all).
__device__ __forceinline__ void a_values(float (&v)[4], const float* p, long long ld, int rows,
                                         int k0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const bool lo = g < rows, hi = g + 8 < rows;
  v[0] = lo ? p[g * ld + k0 + t] : 0.f;
  v[1] = hi ? p[(g + 8) * ld + k0 + t] : 0.f;
  v[2] = lo ? p[g * ld + k0 + t + 4] : 0.f;
  v[3] = hi ? p[(g + 8) * ld + k0 + t + 4] : 0.f;
}

// c0, c1 to row g and c2, c3 to row g + 8 of a row-major tile at y (row
// stride ld), columns col and col + 1; rows at or past `rows` skipped.
__device__ __forceinline__ void store_c(float* y, long long ld, int rows, int col, float c0,
                                        float c1, float c2, float c3) {
  const int g = (threadIdx.x & 31) >> 2;
  if (g < rows) *reinterpret_cast<float2*>(y + g * ld + col) = make_float2(c0, c1);
  if (g + 8 < rows) *reinterpret_cast<float2*>(y + (g + 8) * ld + col) = make_float2(c2, c3);
}

}  // namespace gdsp
