// One int8 tensor-core product a warp, mma.sync.aligned.m16n8k32 with s8
// operands and an s32 sum, by inline PTX, with the packing of four int8
// values a register: used by i8_dot_kernel and i8_probe_kernel
// (int8_probe_kernels.cu).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace gdsp {

// Fragments (PTX ISA, "Matrix Fragments for mma.m16n8k32", .s8), with
// g = lane / 4 and t = lane % 4, four int8 values a 32-bit register, the
// lowest column (A) or k (B) in the lowest byte:
//   A (16 x 32, row): a0 (g, 4t .. 4t + 3), a1 (g + 8, 4t ..), a2 (g, 16 + 4t ..),
//                     a3 (g + 8, 16 + 4t ..);
//   B (32 x 8, col):  b0 (4t .. 4t + 3, g), b1 (16 + 4t .., g);
//   C (16 x 8, s32):  c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
// The sum is integer arithmetic: exact while it stays inside int32.

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint4& a, const uint2& b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b.x), "r"(b.y));
}

// Four values in [-128, 127] as one register of int8, v0 in the lowest byte.
__device__ __forceinline__ uint32_t pack_s8(int v0, int v1, int v2, int v3) {
  return (static_cast<uint32_t>(v0) & 0xffu) | ((static_cast<uint32_t>(v1) & 0xffu) << 8) |
         ((static_cast<uint32_t>(v2) & 0xffu) << 16) | (static_cast<uint32_t>(v3) << 24);
}

}  // namespace gdsp
