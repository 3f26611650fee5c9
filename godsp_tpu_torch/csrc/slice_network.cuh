// The slice network: the n1-point DFT across a row's n1 slices of 128
// points (godsp_tpu/ops/pallas_fft.py: _dft_slices, radix-2 DIT with the
// slices taken in bit-reversed order, natural k1 out), kept in registers.
// Used by vdif_kernel (dif_probe_kernels.cu) and by ls_network_kernel,
// ls_full_kernel and ls_full_stream_kernel (lane_slice_probe_kernels.cu).
//
// z[j][q] holds value q of slice j; a caller loads slice j1 into
// z[rev_bits(j1, log2 n1)] and, after slice_dft, finds output k1 in z[k1].
// Every index is a template constant, so z stays in registers.  The
// twiddles W_m^j = W_8^{8 j / m} are float32 constants rounded once, exact
// where the value is.

#pragma once

#include <cuda_runtime.h>

namespace gdsp {

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

__host__ __device__ constexpr int rev_bits(int v, int bits) {
  return bits == 0 ? 0 : ((v & 1) << (bits - 1)) | rev_bits(v >> 1, bits - 1);
}

__host__ __device__ constexpr int log2_small(int n) { return n <= 1 ? 0 : 1 + log2_small(n / 2); }

// W_8^e, e < 4: the slice DFT's twiddles (W_m^j = W_8^{8 j / m}), exact
// where the value is.
__device__ __forceinline__ float2 w8(int e) {
  constexpr float r = 0.70710678118654752440f;
  return e == 0 ? make_float2(1.f, 0.f)
       : e == 1 ? make_float2(r, -r)
       : e == 2 ? make_float2(0.f, -1.f)
                : make_float2(-r, -r);
}

// One radix-2 DIT stage of block size M over the N1 slices, Q values of
// each, every index a constant.
template <int N1, int M, int Q>
__device__ __forceinline__ void dit_stage(float2 (&z)[N1][Q]) {
  constexpr int half = M / 2;
#pragma unroll
  for (int s = 0; s < N1; s += M) {
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const float2 w = w8(j * (8 / M));
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float2 u = z[s + j][q];
        const float2 v = j == 0 ? z[s + j + half][q] : cmul(z[s + j + half][q], w);
        z[s + j][q] = cadd(u, v);
        z[s + j + half][q] = csub(u, v);
      }
    }
  }
}

// The N1-point DFT across the slices (N1 in 1, 2, 4, 8), in place: slices
// in bit-reversed order in, natural k1 out.
template <int N1, int Q>
__device__ __forceinline__ void slice_dft(float2 (&z)[N1][Q]) {
  if constexpr (N1 >= 2) dit_stage<N1, 2>(z);
  if constexpr (N1 >= 4) dit_stage<N1, 4>(z);
  if constexpr (N1 >= 8) dit_stage<N1, 8>(z);
}

}  // namespace gdsp
