// K14a: the fused-Welch floor twins for Hopper (sm_90a).  Each is one
// variant of K4's own body (pwelch_kernel.cu: pwelch_partials_kernel):
// the same grid (tiles, rows; rows over y and z by row_grid), the same
// tiling (segs_per_tile segments a block), the same shared-memory FFT
// (fft_block.cuh) and twiddle table.  Only the part under test changes,
// so each time is a floor of K4's.
//
// They replace the Pallas elimination twins of tools/probe_pwfloor.py
// (build_variant):
//   loadonly  (:189, _kern_loadonly)  reads the tile's samples, its halo,
//             its mask and the window once and sums them: 1 float a tile
//             (the TPU twin broadcast it over a row);
//   frameonly (:189, _kern_frameonly) K4's framing and window into shared
//             memory, then the mask-weighted sum of the windowed frames,
//             no FFT: pad floats a tile, time order;
//   noframe   (:264, _kern_noframe)   input already framed as (S, pad)
//             rows (K3's layout): window, FFT, |X|^2, masked sum;
//   staged    (:229, _frames_2d / _kern_full2d) the Hopper counterpart of
//             the TPU's 2-D framing: the tile's span of samples,
//             (bt - 1) * stride + nfft of them (bt + nfft/stride - 1
//             stride-wide rows), is loaded ONCE into shared memory and
//             the frames are cut from there, where K4 re-reads each sample
//             nfft/stride times through L2; then what K4 does.  Its
//             partial sums equal K4's.
// The spectral twins give pad/2 + 1 bins a tile in natural order, as K4.
//
// Bound on the H100 at the probe's geometry (nfft = pad = 1024, stride
// 512, 16384 segments): bytes.  loadonly, frameonly, staged and K4 read
// the 33.6 MB of samples once (0.010 ms at 3.35 TB/s); noframe reads the
// 67.1 MB of frames (0.020 ms); the FFTs' 4.2e8 float32 operations take
// 0.006 ms at 67 TFLOP/s.  What each twin measures is how far its part
// of K4 stands above that floor; the design keeps the twins' plumbing
// identical to K4's so that differences are the part under test.

#include <cstdint>

#include "fft_block.cuh"

namespace {

constexpr int kLoadThreads = 256;

__global__ void loadonly_kernel(const float* __restrict__ ext, const float* __restrict__ mask,
                                const float* __restrict__ w, float* __restrict__ out,
                                long long rows, long long L, long long S, int nfft, int stride,
                                int pad, int bt, int n_tiles) {
  __shared__ float warp_sums[kLoadThreads / 32];
  const long long row = gdsp::block_row();
  if (row >= rows) return;
  const int tile = blockIdx.x;
  const long long s0 = static_cast<long long>(tile) * bt;
  const long long s1 = s0 + bt < S ? s0 + bt : S;
  const float* x = ext + row * L;
  const float* m = mask + row * S;
  const long long lo = s0 * stride;
  const long long end = (s1 - 1) * stride + nfft;
  const long long hi = end < L ? end : L;
  float acc = 0.f;
  for (long long j = lo + threadIdx.x; j < hi; j += blockDim.x) acc += x[j];
  for (long long sg = s0 + threadIdx.x; sg < s1; sg += blockDim.x) acc += m[sg];
  for (int i = threadIdx.x; i < pad; i += blockDim.x) acc += w[i];
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int k = 0; k < static_cast<int>(blockDim.x >> 5); ++k) t += warp_sums[k];
    out[row * n_tiles + tile] = t;
  }
}

__global__ void frameonly_kernel(const float* __restrict__ ext, const float* __restrict__ mask,
                                 const float* __restrict__ w, float* __restrict__ out,
                                 long long rows, long long L, long long S, int nfft, int stride,
                                 int log2pad, int bt, int n_tiles) {
  extern __shared__ float2 s[];
  const long long row = gdsp::block_row();
  if (row >= rows) return;
  const int pad = 1 << log2pad;
  float* acc = reinterpret_cast<float*>(s + pad);
  const int tile = blockIdx.x;
  const float* x = ext + row * L;
  const float* m = mask + row * S;
  for (int i = threadIdx.x; i < pad; i += blockDim.x) acc[i] = 0.f;
  const long long s0 = static_cast<long long>(tile) * bt;
  const long long s1 = s0 + bt < S ? s0 + bt : S;
  for (long long sg = s0; sg < s1; ++sg) {
    const float ms = m[sg];
    if (ms == 0.f) continue;
    const long long base = sg * stride;
    __syncthreads();
    for (int i = threadIdx.x; i < pad; i += blockDim.x) {
      float v = 0.f;
      if (i < nfft && base + i < L) v = x[base + i] * w[i];
      s[gdsp::bit_reverse(i, log2pad)] = make_float2(v, 0.f);
    }
    __syncthreads();
    // Each thread reads back the positions it will own: the frame in
    // time order, from K4's bit-reversed layout.
    for (int i = threadIdx.x; i < pad; i += blockDim.x)
      acc[i] += ms * s[gdsp::bit_reverse(i, log2pad)].x;
  }
  float* o = out + (row * n_tiles + tile) * pad;
  for (int i = threadIdx.x; i < pad; i += blockDim.x) o[i] = acc[i];
}

// noframe (kStaged false): frame s of a row is frames[s * pad : (s + 1) * pad].
// staged (kStaged true): the tile's span of ext is staged in shared memory
// first, frames are cut from it.
template <bool kStaged>
__global__ void spectral_twin_kernel(const float* __restrict__ src, const float* __restrict__ mask,
                                     const float* __restrict__ w, float* __restrict__ out,
                                     const float2* __restrict__ tw, long long rows, long long L,
                                     long long S, int nfft, int stride, int log2pad, int bt,
                                     int n_tiles) {
  extern __shared__ float2 s[];
  const long long row = gdsp::block_row();
  if (row >= rows) return;
  const int pad = 1 << log2pad;
  const int lp = (pad >> 1) + 1;
  float* acc = reinterpret_cast<float*>(s + pad);
  float* span = acc + lp;
  const int tile = blockIdx.x;
  const float* x = src + row * L;
  const float* m = mask + row * S;
  for (int k = threadIdx.x; k < lp; k += blockDim.x) acc[k] = 0.f;

  const long long s0 = static_cast<long long>(tile) * bt;
  const long long s1 = s0 + bt < S ? s0 + bt : S;
  if (kStaged) {
    const long long lo = s0 * stride;
    const int n_span = static_cast<int>((s1 - 1 - s0) * stride + nfft);
    for (int j = threadIdx.x; j < n_span; j += blockDim.x)
      span[j] = lo + j < L ? x[lo + j] : 0.f;
  }
  for (long long sg = s0; sg < s1; ++sg) {
    const float ms = m[sg];
    if (ms == 0.f) continue;
    __syncthreads();  // the span is staged; the previous segment's readers are done
    for (int i = threadIdx.x; i < pad; i += blockDim.x) {
      float v;
      if (kStaged) {
        v = i < nfft ? span[(sg - s0) * stride + i] * w[i] : 0.f;
      } else {
        v = x[sg * pad + i] * w[i];
      }
      s[gdsp::bit_reverse(i, log2pad)] = make_float2(v, 0.f);
    }
    __syncthreads();
    gdsp::block_fft_rows(s, 1, pad, log2pad, tw);
    for (int k = threadIdx.x; k < lp; k += blockDim.x) {
      const float2 c = s[k];
      acc[k] += ms * (c.x * c.x + c.y * c.y);
    }
  }
  float* o = out + (row * n_tiles + tile) * lp;
  for (int k = threadIdx.x; k < lp; k += blockDim.x) o[k] = acc[k];
}

template <bool kStaged>
int launch_spectral(const float* src, const float* mask, const float* w, float* out,
                    const float2* tw, long long rows, long long L, long long S, int nfft,
                    int stride, int log2pad, int bt, int n_tiles, void* stream) {
  const int pad = 1 << log2pad;
  const int lp = (pad >> 1) + 1;
  size_t smem = static_cast<size_t>(pad) * sizeof(float2) + static_cast<size_t>(lp) * 4;
  if (kStaged) smem += static_cast<size_t>((bt - 1) * static_cast<long long>(stride) + nfft) * 4;
  cudaError_t e = gdsp::allow_smem(spectral_twin_kernel<kStaged>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid = gdsp::row_grid(static_cast<unsigned>(n_tiles), rows);
  spectral_twin_kernel<kStaged><<<grid, gdsp::block_threads(pad >> 1), smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      src, mask, w, out, tw, rows, L, S, nfft, stride, log2pad, bt, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// loadonly: out[r, t] = the sum of ext[r, t*bt*stride : end of the tile's
// last frame] (clipped to L_ext), mask[r, tile's segments] and w[:pad].
int gdsp_pwfloor_loadonly(const float* ext, const float* mask, const float* w, float* out,
                          long long rows, long long L_ext, long long S, int nfft, int stride,
                          int pad, int bt, int n_tiles, void* stream) {
  const dim3 grid = gdsp::row_grid(static_cast<unsigned>(n_tiles), rows);
  loadonly_kernel<<<grid, kLoadThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ext, mask, w, out, rows, L_ext, S, nfft, stride, pad, bt, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// frameonly: out[r, t, i] = sum over segments s of tile t of
// mask[r, s] * w[i] * ext[r, s*stride + i] (i < nfft, zero to pad).
int gdsp_pwfloor_frameonly(const float* ext, const float* mask, const float* w, float* out,
                           long long rows, long long L_ext, long long S, int nfft, int stride,
                           int log2pad, int bt, int n_tiles, void* stream) {
  const int pad = 1 << log2pad;
  const size_t smem = static_cast<size_t>(pad) * (sizeof(float2) + 4);
  cudaError_t e = gdsp::allow_smem(frameonly_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid = gdsp::row_grid(static_cast<unsigned>(n_tiles), rows);
  frameonly_kernel<<<grid, gdsp::block_threads(pad >> 1), smem,
                     static_cast<cudaStream_t>(stream)>>>(ext, mask, w, out, rows, L_ext, S, nfft,
                                                          stride, log2pad, bt, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// noframe: out[r, t, k] = sum over segments s of tile t of
// mask[r, s] * |FFT_pad(w * frames[r, s, :])|^2_k, k <= pad/2.
int gdsp_pwfloor_noframe(const float* frames, const float* mask, const float* w, float* out,
                         const float2* tw, long long rows, long long S, int log2pad, int bt,
                         int n_tiles, void* stream) {
  const int pad = 1 << log2pad;
  return launch_spectral<false>(frames, mask, w, out, tw, rows, S * pad, S, pad, pad, log2pad,
                                bt, n_tiles, stream);
}

// staged: K4's sums (gdsp_pwelch_partials) with each tile's span staged
// once in shared memory.
int gdsp_pwfloor_staged(const float* ext, const float* mask, const float* w, float* out,
                        const float2* tw, long long rows, long long L_ext, long long S, int nfft,
                        int stride, int log2pad, int bt, int n_tiles, void* stream) {
  return launch_spectral<true>(ext, mask, w, out, tw, rows, L_ext, S, nfft, stride, log2pad, bt,
                               n_tiles, stream);
}

}  // extern "C"
