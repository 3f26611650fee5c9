// The first designs of K1/K3, K4, K5, K6, K7, K8 and K9, kept as
// yardsticks off the main path.  Each kernel is the one its TPU kernel's
// port first ran, unchanged in arithmetic; they replace no TPU kernel of
// their own: each shows, on one card and in one run, what the
// register-radix redesign (fft_regs.cuh: fft_kernels.cu for K1/K2/K3,
// stft_kernel.cu and outer_kernel.cu for K5 and K8, pwelch_kernel.cu and
// csd_kernel.cu for K4/K11 and K7, istft_kernel.cu and peel_rows_kernel.cu
// for K6 and K9) changed.  Wrappers: ops/cuda_probes.py fft_pow2_radix2,
// stft_radix2, outer_dft_radix2, pwelch_radix2, csd_radix2, istft_radix2,
// peel_rows_radix2, each with its own launch count; nothing under fft/,
// models/, spectral/ or parallel/ reaches them.
//
// fft_pow2_radix2_kernel (K1's first design): a coalesced load into shared
// memory in bit-reversed order, the log2 n radix-2 DIT stages of
// fft_block.cuh's block_fft_rows, one __syncthreads and one twiddle __ldg
// a butterfly a stage, and a coalesced store with the scale applied.
// Bound on the H100 at n <= 16384: bytes, 16 B a point (two float32 planes
// read, two written).
//
// stft_radix2_kernel (K5's first design): a block owns max(1, 4096 / pad)
// consecutive frames of one row, loads each windowed and zero-extended
// frame bit-reversed into shared memory (the overlap re-read through L2),
// runs the pad-point complex FFT of the real frame with block_fft_rows,
// then writes bins 0..pad/2 (complex), |X|^2 (power) or the band sums of
// |X|^2 against the filterbank (mel, the power spectrum in shared memory).
// Bound: the output bytes, 8 (complex) or 4 (power) a bin.
//
// outer_dft_radix2_kernel (K8's first design): a block loads a tile of
// max(8, 4096 / m) adjacent columns x m rows into shared memory as rows
// of m points in bit-reversed order, at a row stride of m + 1 float2, runs
// block_fft_rows with the m-point table, then multiplies by W_N^{k c} from
// the factored hi/lo tables and stores row (k % d1) d2 + k / d1.  Bound:
// 16 B a point.
//
// pwelch_radix2_kernel (K4's first design, without K11's halo): grid
// (tiles, rows); a block walks its tile's segments in order and, for each
// with mask[s] != 0, loads the windowed, zero-extended frame bit-reversed
// into shared memory, runs the pad-point complex FFT of the real frame
// with block_fft_rows (a __syncthreads a stage) and adds mask[s] |X_k|^2
// into a shared accumulator of pad/2 + 1 floats.  Bound: the samples'
// bytes (pwelch_kernel.cu).
//
// csd_radix2_kernel<MAXB> (K7's first design): the same walk, x's frame
// transformed in the one shared buffer and its X_k copied into MAXB
// registers a thread, then y's, then mask[s] conj(X_k) Y_k added into two
// register accumulators.  Bound: csd_kernel.cu's.
//
// peel_rows_radix2_kernel<R> (K9's first design): grid (128 / R row
// groups, batch); block g owns the R rows k1 = g + G j (G = 128 / R) of
// one batch element, reads all 128 input rows of every column (the
// element re-read G times from L2), runs one radix-G decimation step and
// an R-point DFT a column, the W_{128 n3} twiddle from the hi/lo tables,
// stores at the bit-reversed position of t, then block_fft_rows over the R
// rows and a coalesced scaled store.  Bound: 16 B a point.
//
// istft_radix2_kernel (K6's first design): grid (tiles of bt frames,
// rows); for each frame of its tile in turn a block loads the bins
// bit-reversed into shared memory, completing a one-sided spectrum to the
// conjugate-symmetric pad-point one in the loader, runs the inverse
// pad-point FFT with block_fft_rows, and adds the windowed real part at
// the frame's offset into the tile's span (in shared memory where it
// fits); the wrapper adds each span's nfft - hop tail onto the next one's
// head.  Bound: istft_kernel.cu's.

#include <cstdint>

#include "fft_block.cuh"

namespace {

constexpr int kPointsPerBlock = 4096;  // rows per block = max(1, this / n)

// y[:, :out_n] = scale * DFT(x) over rows of n = 2^log2n points; xi null
// reads a real input.  y rows are out_n wide.
__global__ void fft_pow2_radix2_kernel(const float* __restrict__ xr,
                                       const float* __restrict__ xi, float* __restrict__ yr,
                                       float* __restrict__ yi, const float2* __restrict__ tw,
                                       int log2n, int out_n, long long rows, int rows_per_block,
                                       float scale) {
  extern __shared__ float2 s[];
  const int n = 1 << log2n;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const int total = rows_per_block * n;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i >> log2n;
    const int k = i & (n - 1);
    float2 v = make_float2(0.f, 0.f);
    if (row0 + r < rows) {
      const long long g = (row0 + r) * n + k;
      v.x = xr[g];
      if (xi != nullptr) v.y = xi[g];
    }
    s[r * n + gdsp::bit_reverse(k, log2n)] = v;
  }
  __syncthreads();
  gdsp::block_fft_rows(s, rows_per_block, n, log2n, tw);
  const int out_total = rows_per_block * out_n;
  for (int i = threadIdx.x; i < out_total; i += blockDim.x) {
    const int r = i / out_n;
    const int k = i - r * out_n;
    if (row0 + r < rows) {
      const long long g = (row0 + r) * out_n + k;
      const float2 c = s[r * n + k];
      yr[g] = c.x * scale;
      yi[g] = c.y * scale;
    }
  }
}

inline int rows_per_block(int n) { return n >= kPointsPerBlock ? 1 : kPointsPerBlock / n; }

}  // namespace

extern "C" {

// y[:, :out_n] = scale * DFT(x) over rows of n = 2^log2n points by the
// radix-2 design; xi may be null (real input); tw is the (n/2)-entry
// table exp(-+2 pi i j / n) (ops/cuda_fft.py: twiddle_table), forward or
// conjugate.  Returns cudaGetLastError().
int gdsp_fft_pow2_radix2(const float* xr, const float* xi, float* yr, float* yi,
                         const float2* tw, int log2n, int out_n, long long rows, float scale,
                         void* stream) {
  const int n = 1 << log2n;
  const int rpb = rows_per_block(n);
  const size_t smem = static_cast<size_t>(rpb) * n * sizeof(float2);
  cudaError_t e = gdsp::allow_smem(fft_pow2_radix2_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (rows + rpb - 1) / rpb;
  const int threads = gdsp::block_threads(static_cast<long long>(rpb) * (n >> 1));
  fft_pow2_radix2_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(xr, xi, yr, yi, tw, log2n, out_n,
                                                                rows, rpb, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// ---------------------------------------------------------------------------
// K5's first design
// ---------------------------------------------------------------------------

namespace {

constexpr int kFramePointsPerBlock = 4096;  // frames per block = max(1, this / pad)

__global__ void stft_radix2_kernel(const float* __restrict__ x, const float* __restrict__ w,
                            const float2* __restrict__ tw, float* __restrict__ out,
                            const float* __restrict__ fb, const int2* __restrict__ band,
                            long long rows, long long L, long long S, int nfft,
                            long long stride, int log2pad, int fpb, int mode, int n_mels) {
  extern __shared__ float2 s[];
  const long long row = gdsp::block_row();
  if (row >= rows) return;
  const int pad = 1 << log2pad;
  const int lp = (pad >> 1) + 1;
  const long long f0 = static_cast<long long>(blockIdx.x) * fpb;
  const float* xr = x + row * L;

  const int total = fpb * pad;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i >> log2pad;
    const int k = i & (pad - 1);
    const long long f = f0 + r;
    const long long at = f * stride + k;
    float v = 0.f;
    if (f < S && k < nfft && at < L) v = xr[at] * w[k];
    s[r * pad + gdsp::bit_reverse(k, log2pad)] = make_float2(v, 0.f);
  }
  __syncthreads();
  gdsp::block_fft_rows(s, fpb, pad, log2pad, tw);

  if (mode == 0) {
    float2* o = reinterpret_cast<float2*>(out);
    for (int i = threadIdx.x; i < fpb * lp; i += blockDim.x) {
      const int r = i / lp;
      const int k = i - r * lp;
      if (f0 + r < S) o[(row * S + f0 + r) * lp + k] = s[r * pad + k];
    }
    return;
  }
  if (mode == 1) {
    for (int i = threadIdx.x; i < fpb * lp; i += blockDim.x) {
      const int r = i / lp;
      const int k = i - r * lp;
      if (f0 + r < S) {
        const float2 c = s[r * pad + k];
        out[(row * S + f0 + r) * lp + k] = c.x * c.x + c.y * c.y;
      }
    }
    return;
  }
  // mel: |X|^2 into the float region after the spectra, then each thread
  // sums one (frame, filter) pair over the filter's band.
  float* p = reinterpret_cast<float*>(s + fpb * pad);
  for (int i = threadIdx.x; i < fpb * lp; i += blockDim.x) {
    const int r = i / lp;
    const int k = i - r * lp;
    const float2 c = s[r * pad + k];
    p[i] = c.x * c.x + c.y * c.y;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < fpb * n_mels; i += blockDim.x) {
    const int r = i / n_mels;
    const int j = i - r * n_mels;
    if (f0 + r >= S) continue;
    const int2 b = band[j];
    const float* fj = fb + static_cast<long long>(j) * lp;
    const float* pr = p + r * lp;
    float acc = 0.f;
    for (int k = b.x; k <= b.y; ++k) acc += pr[k] * fj[k];
    out[(row * S + f0 + r) * n_mels + j] = acc;
  }
}

inline int frames_per_block(int pad) {
  return pad >= kFramePointsPerBlock ? 1 : kFramePointsPerBlock / pad;
}

}  // namespace

extern "C" {

// K5's function by the radix-2 design: out = per-frame results of frames
// s in [0, S) of each of `rows` rows of x (rows, L): frame s reads x[s*stride : s*stride + nfft] * w[:nfft],
// zero-extended to pad = 2^log2pad.  mode 0: (rows, S, pad/2+1) float2;
// mode 1: (rows, S, pad/2+1) float; mode 2: (rows, S, n_mels) float with
// fb (n_mels, pad/2+1) and band (n_mels) = first and last nonzero bin of
// each filter.  tw is the forward (pad/2)-entry table of pad
// (ops/cuda_fft.py: twiddle_table).  Returns cudaGetLastError().
int gdsp_stft_radix2(const float* x, const float* w, const float2* tw, float* out,
                     const float* fb, const int2* band, long long rows, long long L, long long S, int nfft,
              long long stride, int log2pad, int mode, int n_mels, void* stream) {
  const int pad = 1 << log2pad;
  const int lp = (pad >> 1) + 1;
  const int fpb = frames_per_block(pad);
  size_t smem = static_cast<size_t>(fpb) * pad * sizeof(float2);
  if (mode == 2) smem += static_cast<size_t>(fpb) * lp * sizeof(float);
  cudaError_t e = gdsp::allow_smem(stft_radix2_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid = gdsp::row_grid(static_cast<unsigned>((S + fpb - 1) / fpb), rows);
  const int threads = gdsp::block_threads(static_cast<long long>(fpb) * (pad >> 1));
  stft_radix2_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w, tw, out, fb, band, rows, L, S, nfft, stride, log2pad, fpb, mode, n_mels);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// ---------------------------------------------------------------------------
// K8's first design
// ---------------------------------------------------------------------------

namespace {

constexpr int kTilePointsPerBlock = 4096;  // tile columns T = max(8, this / m)
constexpr int kMinCols = 8;            // one 32-byte sector of floats a row

__global__ void outer_dft_radix2_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                                 float* __restrict__ yr, float* __restrict__ yi,
                                 const float2* __restrict__ tw, const float2* __restrict__ hi,
                                 const float2* __restrict__ lo, int log2m, int d2,
                                 long long n3, long long batch, int log2t, int lo_bits) {
  extern __shared__ float2 s[];
  const long long b = gdsp::block_row();
  if (b >= batch) return;
  const int m = 1 << log2m;
  const int d1 = m / d2;
  const int T = 1 << log2t;
  const int stride = m + 1;
  const long long c0 = static_cast<long long>(blockIdx.x) << log2t;
  const long long base = b * m * n3;
  const int total = m << log2t;

  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int i = e >> log2t;
    const int t = e & (T - 1);
    const long long c = c0 + t;
    float2 v = make_float2(0.f, 0.f);
    if (c < n3) {
      const long long g = base + i * n3 + c;
      v = make_float2(xr[g], xi[g]);
    }
    s[t * stride + gdsp::bit_reverse(i, log2m)] = v;
  }
  __syncthreads();
  gdsp::block_fft_rows(s, T, m, log2m, tw, stride);

  const unsigned long long lo_mask = (1ull << lo_bits) - 1;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int r = e >> log2t;
    const int t = e & (T - 1);
    const long long c = c0 + t;
    if (c >= n3) continue;
    const int k = r / d2 + d1 * (r % d2);  // row r = (k % d1) * d2 + k / d1
    const unsigned long long p = static_cast<unsigned long long>(k) * c;  // < N: reduced
    const float2 wh = __ldg(&hi[p >> lo_bits]);
    const float2 wl = __ldg(&lo[p & lo_mask]);
    const float2 w = make_float2(wh.x * wl.x - wh.y * wl.y, wh.x * wl.y + wh.y * wl.x);
    const float2 v = s[t * stride + k];
    const long long g = base + r * n3 + c;
    yr[g] = v.x * w.x - v.y * w.y;
    yi[g] = v.x * w.y + v.y * w.x;
  }
}

}  // namespace

extern "C" {

// K8's function by the radix-2 design: y = the outer levels of x over `batch` (m, n3) planes, m = 2^log2m,
// rows stored in the (d1 = m / d2, d2) order above.  tw is the m-point
// table of ops/cuda_fft.py: twiddle_table (conjugate for the inverse); hi and lo the factored W_N tables,
// lo of 2^lo_bits entries.  Returns cudaGetLastError().
int gdsp_outer_dft_radix2(const float* xr, const float* xi, float* yr, float* yi, const float2* tw,
                   const float2* hi, const float2* lo, int log2m, int d2, long long n3,
                   long long batch, int lo_bits, void* stream) {
  const int m = 1 << log2m;
  int log2t = 0;
  while ((m << log2t) < kTilePointsPerBlock || (1 << log2t) < kMinCols) ++log2t;
  const int T = 1 << log2t;
  const size_t smem = static_cast<size_t>(T) * (m + 1) * sizeof(float2);
  cudaError_t e = gdsp::allow_smem(outer_dft_radix2_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles = (n3 + T - 1) / T;
  const int threads = gdsp::block_threads(static_cast<long long>(T) * (m >> 1));
  outer_dft_radix2_kernel<<<gdsp::row_grid(static_cast<unsigned>(tiles), batch), threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(xr, xi, yr, yi, tw, hi, lo, log2m,
                                                          d2, n3, batch, log2t, lo_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// ---------------------------------------------------------------------------
// K4's first design
// ---------------------------------------------------------------------------

namespace {

__global__ void pwelch_radix2_kernel(const float* __restrict__ ext, const float* __restrict__ mask,
                                     const float* __restrict__ w, float* __restrict__ out,
                                     const float2* __restrict__ tw, long long rows,
                                     long long L_ext, long long S, int nfft, int stride,
                                     int log2pad, int bt, int n_tiles) {
  extern __shared__ float2 s[];
  const long long row = gdsp::block_row();
  if (row >= rows) return;
  const int pad = 1 << log2pad;
  const int lp = (pad >> 1) + 1;
  float* acc = reinterpret_cast<float*>(s + pad);
  const int tile = blockIdx.x;
  const float* x = ext + row * L_ext;
  const float* m = mask + row * S;

  for (int k = threadIdx.x; k < lp; k += blockDim.x) acc[k] = 0.f;

  const long long s0 = static_cast<long long>(tile) * bt;
  const long long s1 = s0 + bt < S ? s0 + bt : S;
  for (long long sg = s0; sg < s1; ++sg) {
    const float ms = m[sg];  // the same for every thread: uniform branch
    if (ms == 0.f) continue;
    const long long base = sg * stride;
    __syncthreads();  // the previous segment's readers are done with s[]
    for (int i = threadIdx.x; i < pad; i += blockDim.x) {
      float v = 0.f;
      if (i < nfft && base + i < L_ext) v = x[base + i] * w[i];
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

}  // namespace

extern "C" {

// K4's function by the radix-2 design: out[r, t, k] = sum over segments s
// of tile t of mask[r, s] * |FFT_pad(w * ext[r, s*stride:])|^2_k for k <=
// pad/2, ext and mask contiguous rows.  tw is the (pad/2)-entry forward
// table (ops/cuda_fft.py: twiddle_table).  Returns cudaGetLastError().
int gdsp_pwelch_radix2(const float* ext, const float* mask, const float* w, float* out,
                       const float2* tw, long long rows, long long L_ext, long long S, int nfft,
                       int stride, int log2pad, int bt, int n_tiles, void* stream) {
  const int pad = 1 << log2pad;
  const int lp = (pad >> 1) + 1;
  const size_t smem = static_cast<size_t>(pad) * sizeof(float2) + static_cast<size_t>(lp) * 4;
  cudaError_t e = gdsp::allow_smem(pwelch_radix2_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid = gdsp::row_grid(static_cast<unsigned>(n_tiles), rows);
  const int threads = gdsp::block_threads(pad >> 1);
  pwelch_radix2_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      ext, mask, w, out, tw, rows, L_ext, S, nfft, stride, log2pad, bt, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// ---------------------------------------------------------------------------
// K7's first design
// ---------------------------------------------------------------------------

namespace {

// x (or y) segment sg of `row`, windowed and zero-extended, into s[] in
// bit-reversed order, then its FFT.  Ends synchronized.
__device__ __forceinline__ void load_and_transform(float2* s, const float* __restrict__ src,
                                                   const float* __restrict__ w, long long base,
                                                   long long L_ext, int nfft, int pad,
                                                   int log2pad, const float2* __restrict__ tw) {
  for (int i = threadIdx.x; i < pad; i += blockDim.x) {
    float v = 0.f;
    if (i < nfft && base + i < L_ext) v = src[base + i] * w[i];
    s[gdsp::bit_reverse(i, log2pad)] = make_float2(v, 0.f);
  }
  __syncthreads();
  gdsp::block_fft_rows(s, 1, pad, log2pad, tw);
}

template <int MAXB>
__global__ void __launch_bounds__(512) csd_radix2_kernel(
    const float* __restrict__ ext_x, const float* __restrict__ ext_y,
    const float* __restrict__ mask, const float* __restrict__ w, float* __restrict__ out_re,
    float* __restrict__ out_im, const float2* __restrict__ tw, long long rows, long long L_ext,
    long long S, int nfft, int stride, int log2pad, int bt, int n_tiles) {
  extern __shared__ float2 s[];
  const long long row = gdsp::block_row();
  if (row >= rows) return;
  const int pad = 1 << log2pad;
  const int lp = (pad >> 1) + 1;
  const int tile = blockIdx.x;
  const float* x = ext_x + row * L_ext;
  const float* y = ext_y + row * L_ext;
  const float* m = mask + row * S;

  float xr[MAXB], xi[MAXB], acc_re[MAXB], acc_im[MAXB];
#pragma unroll
  for (int j = 0; j < MAXB; ++j) acc_re[j] = acc_im[j] = 0.f;

  const long long s0 = static_cast<long long>(tile) * bt;
  const long long s1 = s0 + bt < S ? s0 + bt : S;
  for (long long sg = s0; sg < s1; ++sg) {
    const float ms = m[sg];  // the same for every thread: uniform branch
    if (ms == 0.f) continue;
    const long long base = sg * stride;
    __syncthreads();  // the previous segment's readers are done with s[]
    load_and_transform(s, x, w, base, L_ext, nfft, pad, log2pad, tw);
#pragma unroll
    for (int j = 0; j < MAXB; ++j) {
      const int k = threadIdx.x + j * blockDim.x;
      const float2 c = k < lp ? s[k] : make_float2(0.f, 0.f);
      xr[j] = c.x;
      xi[j] = c.y;
    }
    __syncthreads();  // every X_k is in registers before y overwrites s[]
    load_and_transform(s, y, w, base, L_ext, nfft, pad, log2pad, tw);
#pragma unroll
    for (int j = 0; j < MAXB; ++j) {
      const int k = threadIdx.x + j * blockDim.x;
      if (k < lp) {
        const float2 c = s[k];
        acc_re[j] += ms * (xr[j] * c.x + xi[j] * c.y);
        acc_im[j] += ms * (xr[j] * c.y - xi[j] * c.x);
      }
    }
  }
  const long long o = (row * n_tiles + tile) * lp;
#pragma unroll
  for (int j = 0; j < MAXB; ++j) {
    const int k = threadIdx.x + j * blockDim.x;
    if (k < lp) {
      out_re[o + k] = acc_re[j];
      out_im[o + k] = acc_im[j];
    }
  }
}

template <int MAXB>
cudaError_t launch_csd_radix2(const float* ext_x, const float* ext_y, const float* mask,
                              const float* w, float* out_re, float* out_im, const float2* tw,
                              long long rows, long long L_ext, long long S, int nfft, int stride,
                              int log2pad, int bt, int n_tiles, int threads, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(1) << log2pad) * sizeof(float2);
  cudaError_t e = gdsp::allow_smem(csd_radix2_kernel<MAXB>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid = gdsp::row_grid(static_cast<unsigned>(n_tiles), rows);
  csd_radix2_kernel<MAXB><<<grid, threads, smem, stream>>>(
      ext_x, ext_y, mask, w, out_re, out_im, tw, rows, L_ext, S, nfft, stride, log2pad, bt,
      n_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K7's function by the radix-2 design: out_re[r, t, k] + i out_im[r, t, k]
// = sum over segments s of tile t of mask[r, s] * conj(X_s[k]) Y_s[k],
// X_s = FFT_pad(w * ext_x[r, s*stride:]), Y_s likewise of ext_y, for k <=
// pad/2.  tw is the (pad/2)-entry forward table (ops/cuda_fft.py:
// twiddle_table).  Returns cudaGetLastError().
int gdsp_csd_radix2(const float* ext_x, const float* ext_y, const float* mask, const float* w,
                    float* out_re, float* out_im, const float2* tw, long long rows,
                    long long L_ext, long long S, int nfft, int stride, int log2pad, int bt,
                    int n_tiles, void* stream) {
  const int pad = 1 << log2pad;
  const int lp = (pad >> 1) + 1;
  const int threads = gdsp::block_threads(pad >> 1);
  const int per_thread = (lp + threads - 1) / threads;  // bins a thread owns
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GDSP_CSD_LAUNCH(B)                                                               \
  launch_csd_radix2<B>(ext_x, ext_y, mask, w, out_re, out_im, tw, rows, L_ext, S, nfft, stride, \
                       log2pad, bt, n_tiles, threads, st)
  cudaError_t e;
  if (per_thread <= 2) {
    e = GDSP_CSD_LAUNCH(2);
  } else if (per_thread <= 3) {
    e = GDSP_CSD_LAUNCH(3);
  } else if (per_thread <= 5) {
    e = GDSP_CSD_LAUNCH(5);
  } else if (per_thread <= 9) {
    e = GDSP_CSD_LAUNCH(9);
  } else if (per_thread <= 17) {
    e = GDSP_CSD_LAUNCH(17);
  } else {
    e = cudaErrorInvalidValue;  // pad > 16384: the wrapper never asks
  }
#undef GDSP_CSD_LAUNCH
  return static_cast<int>(e);
}

}  // extern "C"

// ---------------------------------------------------------------------------

namespace {

constexpr int kPeelD = 128;  // points of the fused peel
constexpr int kPeelThreads = 512;
constexpr int kPeelSlabPoints = 16384;  // R * n3 float2 in shared memory: 128 KB
constexpr int kPeelMaxRows = 16;        // R: u[R] lives in registers

template <int R>
__global__ void __launch_bounds__(kPeelThreads)
    peel_rows_radix2_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                     float* __restrict__ yr, float* __restrict__ yi,
                     const float2* __restrict__ w128, const float2* __restrict__ tw,
                     const float2* __restrict__ hi, const float2* __restrict__ lo, int log2n3,
                     long long batch, int lo_bits, float scale) {
  constexpr int G = kPeelD / R;  // row groups a batch element
  extern __shared__ float2 smem[];
  float2* wt = smem;      // W_128^p, p < 128
  float2* s = smem + kPeelD;  // R rows of n3 points
  const long long b = gdsp::block_row();
  if (b >= batch) return;
  const int g = blockIdx.x;
  const int n3 = 1 << log2n3;
  for (int e = threadIdx.x; e < kPeelD; e += blockDim.x) wt[e] = w128[e];
  __syncthreads();

  const long long base = b * kPeelD * n3;
  const unsigned lo_mask = (1u << lo_bits) - 1;
  for (int t = threadIdx.x; t < n3; t += blockDim.x) {
    float2 u[R];
#pragma unroll
    for (int i0 = 0; i0 < R; ++i0) {
      float ar = 0.f, ai = 0.f;
#pragma unroll 8
      for (int i1 = 0; i1 < G; ++i1) {
        const long long gi = base + static_cast<long long>(i0 + R * i1) * n3 + t;
        const float vr = __ldg(&xr[gi]);
        const float vi = __ldg(&xi[gi]);
        const float2 w = wt[(R * g * i1) & (kPeelD - 1)];
        ar = fmaf(vr, w.x, fmaf(-vi, w.y, ar));
        ai = fmaf(vr, w.y, fmaf(vi, w.x, ai));
      }
      const float2 w = wt[(g * i0) & (kPeelD - 1)];
      u[i0] = make_float2(ar * w.x - ai * w.y, ar * w.y + ai * w.x);
    }
    const unsigned tr = gdsp::bit_reverse(t, log2n3);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float vr = 0.f, vi = 0.f;
#pragma unroll
      for (int i0 = 0; i0 < R; ++i0) {
        const float2 w = wt[(G * j * i0) & (kPeelD - 1)];
        vr = fmaf(u[i0].x, w.x, fmaf(-u[i0].y, w.y, vr));
        vi = fmaf(u[i0].x, w.y, fmaf(u[i0].y, w.x, vi));
      }
      const unsigned p = static_cast<unsigned>(g + G * j) * static_cast<unsigned>(t);
      const float2 wh = __ldg(&hi[p >> lo_bits]);
      const float2 wl = __ldg(&lo[p & lo_mask]);
      const float2 w = make_float2(wh.x * wl.x - wh.y * wl.y, wh.x * wl.y + wh.y * wl.x);
      s[j * n3 + tr] = make_float2(vr * w.x - vi * w.y, vr * w.y + vi * w.x);
    }
  }
  __syncthreads();
  gdsp::block_fft_rows(s, R, n3, log2n3, tw);

  for (int e = threadIdx.x; e < (R << log2n3); e += blockDim.x) {
    const int j = e >> log2n3;
    const int k3 = e & (n3 - 1);
    const long long gi = base + static_cast<long long>(g + G * j) * n3 + k3;
    const float2 c = s[e];
    yr[gi] = c.x * scale;
    yi[gi] = c.y * scale;
  }
}

template <int R>
int launch_peel_radix2(const float* xr, const float* xi, float* yr, float* yi,
                       const float2* w128, const float2* tw, const float2* hi, const float2* lo,
                       int log2n3, long long batch, int lo_bits, float scale,
                       cudaStream_t stream) {
  const size_t smem = (kPeelD + (static_cast<size_t>(R) << log2n3)) * sizeof(float2);
  cudaError_t e = gdsp::allow_smem(peel_rows_radix2_kernel<R>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  peel_rows_radix2_kernel<R><<<gdsp::row_grid(kPeelD / R, batch), kPeelThreads, smem,
                               stream>>>(
      xr, xi, yr, yi, w128, tw, hi, lo, log2n3, batch, lo_bits, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y = scale * (the 128-point peel, its twiddle and the n3-point row FFT)
// of x over `batch` (128, n3) planes, n3 = 2^log2n3 in 256..8192, rows in
// natural order.  w128 is the whole 128-entry W_128 table, tw the n3-point
// row table (both conjugate for the inverse), hi and lo the factored
// W_{128 n3} tables, lo of 2^lo_bits entries.  Returns cudaGetLastError().
int gdsp_peel_rows_radix2(const float* xr, const float* xi, float* yr, float* yi,
                          const float2* w128, const float2* tw, const float2* hi,
                          const float2* lo, int log2n3, long long batch, int lo_bits,
                          float scale, void* stream) {
  if (log2n3 < 8 || log2n3 > 13) return static_cast<int>(cudaErrorInvalidValue);
  int rows = kPeelSlabPoints >> log2n3;
  if (rows > kPeelMaxRows) rows = kPeelMaxRows;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 2:
      return launch_peel_radix2<2>(xr, xi, yr, yi, w128, tw, hi, lo, log2n3, batch, lo_bits,
                                    scale, st);
    case 4:
      return launch_peel_radix2<4>(xr, xi, yr, yi, w128, tw, hi, lo, log2n3, batch, lo_bits,
                                    scale, st);
    case 8:
      return launch_peel_radix2<8>(xr, xi, yr, yi, w128, tw, hi, lo, log2n3, batch, lo_bits,
                                    scale, st);
    default:
      return launch_peel_radix2<16>(xr, xi, yr, yi, w128, tw, hi, lo, log2n3, batch, lo_bits,
                                    scale, st);
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------

namespace {

constexpr size_t kIstftMaxSmem = 232448;  // dynamic shared memory a block may use on the H100

__global__ void istft_radix2_kernel(const float2* __restrict__ spec, const float* __restrict__ w,
                             const float2* __restrict__ tw_inv, float* __restrict__ out,
                             long long rows, long long F, int bins, int onesided, int nfft,
                             int hop, int log2pad, int bt, long long n_tiles, int span_in_smem,
                             float scale) {
  extern __shared__ float2 s[];
  const long long row = gdsp::block_row();
  if (row >= rows) return;
  const int pad = 1 << log2pad;
  const long long tile = blockIdx.x;
  const int span = (bt - 1) * hop + nfft;
  float* o = out + (row * n_tiles + tile) * span;
  float* acc = span_in_smem ? reinterpret_cast<float*>(s + pad) : o;

  for (int i = threadIdx.x; i < span; i += blockDim.x) acc[i] = 0.f;

  const long long f0 = tile * bt;
  const long long f1 = f0 + bt < F ? f0 + bt : F;
  for (long long f = f0; f < f1; ++f) {
    __syncthreads();  // the previous frame's readers are done with s[]; acc is visible
    const float2* x = spec + (row * F + f) * bins;
    for (int k = threadIdx.x; k < pad; k += blockDim.x) {
      float2 v;
      if (!onesided || k < bins) {
        v = x[k];
      } else {
        v = x[pad - k];
        v.y = -v.y;
      }
      s[gdsp::bit_reverse(k, log2pad)] = v;
    }
    __syncthreads();
    gdsp::block_fft_rows(s, 1, pad, log2pad, tw_inv);
    const int base = static_cast<int>(f - f0) * hop;
    for (int t = threadIdx.x; t < nfft; t += blockDim.x) acc[base + t] += s[t].x * scale * w[t];
  }
  if (span_in_smem) {
    __syncthreads();
    for (int i = threadIdx.x; i < span; i += blockDim.x) o[i] = acc[i];
  }
}

}  // namespace

extern "C" {

// out[r, t, :] = sum over frames f of tile t (bt frames a tile) of
// w * scale * real(IFFT_pad(spec[r, f]))[:nfft], placed at (f - t*bt)*hop
// in a span of (bt-1)*hop + nfft samples.  spec (rows, F, bins) float2,
// natural order: bins = pad/2 + 1 with onesided, else pad.  tw_inv is the
// conjugate table of pad = 2^log2pad.  Returns cudaGetLastError().
int gdsp_istft_radix2(const float2* spec, const float* w, const float2* tw_inv, float* out,
                   long long rows, long long F, int bins, int onesided, int nfft, int hop,
                   int log2pad, int bt, long long n_tiles, float scale, void* stream) {
  const int pad = 1 << log2pad;
  const size_t span = static_cast<size_t>(bt - 1) * hop + nfft;
  const size_t fft_bytes = static_cast<size_t>(pad) * sizeof(float2);
  const int span_in_smem = fft_bytes + span * sizeof(float) <= kIstftMaxSmem;
  const size_t smem = fft_bytes + (span_in_smem ? span * sizeof(float) : 0);
  cudaError_t e = gdsp::allow_smem(istft_radix2_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid = gdsp::row_grid(static_cast<unsigned>(n_tiles), rows);
  const int threads = gdsp::block_threads(pad >> 1);
  istft_radix2_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      spec, w, tw_inv, out, rows, F, bins, onesided, nfft, hop, log2pad, bt, n_tiles,
      span_in_smem, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
