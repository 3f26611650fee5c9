// Batched power-of-2 FFT kernels for Hopper (sm_90a): K1/K2 and K3.
//
// fft_pow2_kernel<LOG2N, INV> replaces godsp_tpu/ops/pallas_fft.py:
// fft_pow2_split (forward, real-input mode with xi null, the conjugate-table
// inverse with `scale` folded in) and ifft_pow2_digit_split (the inverse
// of the convolve/Bluestein chains; natural order here, the TPU digit
// order is not ported).  rfft_pow2_kernel<LOG2M> replaces rfft_pow2_split
// (real input, bins 0..n/2).
//
// Bound on the H100: at n <= 16384 the FFT does 5 n log2 n flops on 16
// bytes a point (two float32 planes read and written), about 3 flops a
// byte at n = 1024: device memory bounds it, 0.080 ms for 2^24 points at
// 3.35 TB/s.  So each row makes one trip through device memory, and the
// design keeps what is left (shared-memory passes, barriers, twiddle
// reads) under that trip: fft_regs.cuh runs a row as 2-4 register-radix
// Stockham passes (R = 16 or 32 points a thread), natural order in and
// out, loading and storing straight from registers, one shared-memory
// exchange a pass and no bank conflicts.  Rows of n <= 1024 live in one
// warp (__syncwarp only); larger rows take a block.
//
// K3 reads the real row x of n = 2m points as m complex points, z[j] =
// x[2j] + i x[2j+1] (one 8-byte load a pair), runs the m-point transform
// Z, and splits while the row is on chip:
//   X[k] = 1/2 (Z[k] + conj Z[m-k]) - 1/2 i W_n^k (Z[k] - conj Z[m-k]),
//   k < m (Z[m] = Z[0]), and X[m] = Re Z[0] - Im Z[0],
// storing bins 0..m: half the arithmetic and half the exchanges of the
// n-point transform, and its bound is 0.040 ms at 16384 x 1024 (4 B a
// point in, 8 B a bin out).  Its table (ops/cuda_fft.py: rfft_table) is
// the m-point Stockham table, then W_n^k, k < m.
//
// Rows a CTA: the launch takes rows_per_cta rows a CTA (gdsp_fft_pow2_rows,
// the probes' sweep); every row's arithmetic is the same at every setting.

#include <climits>
#include <cstdint>
#include <type_traits>

#include "launch.cuh"
#include "fft_regs.cuh"

namespace {

using gdsp::regs::Cta;
using gdsp::regs::Row;
using gdsp::regs::Slot;
using gdsp::regs::cta_shape;
using gdsp::regs::default_rows;
using gdsp::regs::out_index;
using gdsp::regs::row_dft;
using gdsp::regs::slot_of;
using gdsp::regs::unroll;
using gdsp::regs::with_log2;

constexpr size_t kSmemMax = 232448;  // 227 KB, what one block may use

// y = scale * DFT(x) over rows of n = 2^LOG2N points (INV: the inverse,
// with the conjugate table); xi null reads a real input.
template <int LOG2N, bool INV>
__global__ void __launch_bounds__(Row<LOG2N>::kMaxThreads)
fft_pow2_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                float* __restrict__ yr, float* __restrict__ yi, const float2* __restrict__ tw,
                long long rows, int rows_per_cta, int slots, float scale) {
  using S = Row<LOG2N>;
  extern __shared__ float smem[];
  const int slot = threadIdx.x / S::kT;
  const int t = threadIdx.x % S::kT;
  const long long row = static_cast<long long>(blockIdx.x) * rows_per_cta + slot;
  const bool live = slot < rows_per_cta && row < rows;
  const long long off = (live ? row : 0) * S::kN;
  float2 v[S::kP];
  unroll<S::kP>([&](auto rr) {
    constexpr int r = GDSP_IDX(rr);
    const long long g = off + t + r * S::kT;
    v[r] = live ? make_float2(xr[g], xi != nullptr ? xi[g] : 0.f) : make_float2(0.f, 0.f);
  });
  row_dft<LOG2N, INV>(v, t, slot_of<LOG2N>(smem, slots, slot), tw);
  if (!live) return;
  unroll<S::kP>([&](auto ii) {
    constexpr int i = GDSP_IDX(ii);
    const long long g = off + t + out_index<LOG2N>(i) * S::kT;
    yr[g] = v[i].x * scale;
    yi[g] = v[i].y * scale;
  });
}

// Bins 0..m of the DFT of real rows of n = 2m points, m = 2^LOG2M; x holds
// the rows as m float2 pairs each.
template <int LOG2M>
__global__ void __launch_bounds__(Row<LOG2M>::kMaxThreads)
rfft_pow2_kernel(const float2* __restrict__ x, float* __restrict__ yr, float* __restrict__ yi,
                 const float2* __restrict__ tw, long long rows, int rows_per_cta, int slots) {
  using S = Row<LOG2M>;
  constexpr int m = S::kN;
  extern __shared__ float smem[];
  const int slot = threadIdx.x / S::kT;
  const int t = threadIdx.x % S::kT;
  const long long row = static_cast<long long>(blockIdx.x) * rows_per_cta + slot;
  const bool live = slot < rows_per_cta && row < rows;
  const long long off = (live ? row : 0) * m;
  float2 v[S::kP];
  unroll<S::kP>([&](auto rr) {
    constexpr int r = GDSP_IDX(rr);
    v[r] = live ? x[off + t + r * S::kT] : make_float2(0.f, 0.f);
  });
  const Slot<LOG2M> s = slot_of<LOG2M>(smem, slots, slot);
  row_dft<LOG2M, false>(v, t, s, tw);
  // Z[t + c T] is in v; its partner Z[m - k] is another thread's, so the
  // row goes through shared memory once more, in natural order.
  unroll<S::kP>([&](auto ii) {
    constexpr int i = GDSP_IDX(ii);
    s.put(t + out_index<LOG2M>(i) * S::kT, v[i]);
  });
  gdsp::regs::fence(S::kWarp);
  if (!live) return;
  const long long o = row * (m + 1);
  unroll<S::kP>([&](auto ii) {
    constexpr int i = GDSP_IDX(ii);
    const int k = t + out_index<LOG2M>(i) * S::kT;
    const float2 a = v[i];
    const float2 b = s.get((m - k) & (m - 1));  // Z[m - k]; its conjugate below
    const float2 e = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
    const float2 d = make_float2(0.5f * (a.x - b.x), 0.5f * (a.y + b.y));
    const float2 wd = gdsp::regs::mul(d, __ldg(&tw[m + k]));
    yr[o + k] = e.x + wd.y;
    yi[o + k] = e.y - wd.x;
  });
  if (t == 0) {
    yr[o + m] = v[0].x - v[0].y;
    yi[o + m] = 0.f;
  }
}

// The CTA of rows_per_cta rows and its shared memory (words of both
// planes x 4 B; none where a row has no exchange), or false where it does
// not fit.
template <int LOG2N>
bool fit(int rows_per_cta, bool split, Cta* c, size_t* smem) {
  using S = Row<LOG2N>;
  if (rows_per_cta < 1) return false;
  *c = cta_shape<LOG2N>(rows_per_cta);
  const bool exchanges = S::kPasses >= 2 || split;
  *smem = exchanges ? static_cast<size_t>(c->slots) * S::kN * 2 * sizeof(float) : 0;
  return c->threads <= S::kMaxThreads && *smem <= kSmemMax;
}

template <class K>
int launch_grid(K kernel, long long rows, int rows_per_cta, const Cta& c, size_t smem,
                long long* blocks) {
  *blocks = (rows + rows_per_cta - 1) / rows_per_cta;
  if (*blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(gdsp::allow_smem(kernel, smem));
}

}  // namespace

extern "C" {

// y = scale * DFT(x) (inverse != 0: the inverse DFT, tw the conjugate
// table) over rows of n = 2^log2n points, n = 2..16384, with
// rows_per_cta rows a CTA; xi may be null (real input).  tw is the n-entry
// Stockham table of ops/cuda_fft.py: stockham_table.  Every setting gives
// the same result.  Returns cudaErrorInvalidValue where rows_per_cta is
// below 1 or its CTA passes the launch bound's threads or 227 KB of shared
// memory, else cudaGetLastError().
int gdsp_fft_pow2_rows(const float* xr, const float* xi, float* yr, float* yi, const float2* tw,
                       int log2n, long long rows, float scale, int inverse, int rows_per_cta,
                       void* stream) {
  return with_log2<1, 14>(log2n, [&](auto lg) {
    constexpr int L = decltype(lg)::value;
    Cta c;
    size_t smem;
    if (!fit<L>(rows_per_cta, false, &c, &smem)) return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = inverse ? &fft_pow2_kernel<L, true> : &fft_pow2_kernel<L, false>;
    long long blocks;
    const int e = launch_grid(kernel, rows, rows_per_cta, c, smem, &blocks);
    if (e != 0) return e;
    kernel<<<static_cast<unsigned>(blocks), c.threads, smem, static_cast<cudaStream_t>(stream)>>>(
        xr, xi, yr, yi, tw, rows, rows_per_cta, c.slots, scale);
    return static_cast<int>(cudaGetLastError());
  });
}

// The same at the default rows a CTA.
int gdsp_fft_pow2(const float* xr, const float* xi, float* yr, float* yi, const float2* tw,
                  int log2n, long long rows, float scale, int inverse, void* stream) {
  const int rpc = with_log2<1, 14>(log2n, [](auto lg) { return default_rows<decltype(lg)::value>(); });
  return gdsp_fft_pow2_rows(xr, xi, yr, yi, tw, log2n, rows, scale, inverse, rpc, stream);
}

// Bins 0..n/2 of the DFT of real rows of n = 2^log2n points (n = 2..16384,
// rows 8-byte aligned); tw is ops/cuda_fft.py's rfft_table(n).  Returns
// cudaGetLastError().
int gdsp_rfft_pow2(const float* x, float* yr, float* yi, const float2* tw, int log2n,
                   long long rows, void* stream) {
  return with_log2<0, 13>(log2n - 1, [&](auto lg) {
    constexpr int L = decltype(lg)::value;
    const int rpc = default_rows<L>();
    Cta c;
    size_t smem;
    if (!fit<L>(rpc, true, &c, &smem)) return static_cast<int>(cudaErrorInvalidValue);
    long long blocks;
    const int e = launch_grid(rfft_pow2_kernel<L>, rows, rpc, c, smem, &blocks);
    if (e != 0) return e;
    rfft_pow2_kernel<L><<<static_cast<unsigned>(blocks), c.threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float2*>(x), yr, yi, tw, rows, rpc, c.slots);
    return static_cast<int>(cudaGetLastError());
  });
}

// The plan and CTA of n = 2^log2n (0..14) as the kernels use them:
// out[0] points a thread, [1] threads a row, [2] 1 for the warp route,
// [3] rows a warp interleaves, [4] the launch bound's threads, [5] the
// default rows a CTA, [6] passes, [7..10] each pass's radix (0 past the
// last).  ops/cuda_fft.py holds the same plan; the GPU tests compare.
int gdsp_fft_pow2_geometry(int log2n, int* out) {
  return with_log2<0, 14>(log2n, [&](auto lg) {
    constexpr int L = decltype(lg)::value;
    using S = Row<L>;
    out[0] = S::kP;
    out[1] = S::kT;
    out[2] = S::kWarp ? 1 : 0;
    out[3] = S::kQ;
    out[4] = S::kMaxThreads;
    out[5] = default_rows<L>();
    out[6] = S::kPasses;
    for (int p = 0; p < 4; ++p) out[7 + p] = p < S::kPasses ? 1 << gdsp::regs::pass_log2r(L, p) : 0;
    return 0;
  });
}

}  // extern "C"
