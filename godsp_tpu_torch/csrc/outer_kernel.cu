// Outer DFT levels of the giant-N FFT plan for Hopper (sm_90a): K8.
//
// Replaces godsp_tpu/ops/pallas_outer.py: outer_dft_split (inner kernel
// _outer_kernel).  For a length-N transform viewed as (m, n3), N = m * n3,
// each column c of each batch plane gets
//   * the m-point DFT down the column (row index i in natural order),
//   * a multiply by W_N^{k c}, W_N = exp(-+2 pi i / N), for its bin k,
//   * a store at row (k % d1) * d2 + k / d1, the TPU kernel's row order
//     for its two dense levels of d1 and d2 points (m = d1 * d2);
// what is left is the n3-point FFT of each row (fft/large.py).  The TPU
// ran the two levels as Karatsuba matmuls on the MXU.
//
// Bound on the H100: one read and one write of two float32 planes, 16
// bytes a point (268 MB at 2^24, 0.080 ms at 3.35 TB/s), against
// 5 log2(m) + 12 flops a point: device memory bounds it.  So each point
// makes one trip from device memory to registers and one back, and the
// design keeps the column transform, its exchanges and the twiddle under
// that trip.
//
// Design (PR 15's redesign; the first design, a tile staged bit-reversed
// in shared memory and log2 m radix-2 stages of fft_block.cuh behind a
// block barrier each, stays in radix2_probe_kernels.cu as the yardstick):
// K1's register-radix Stockham passes (fft_regs.cuh: row_dft) run down the
// columns.  A CTA takes a tile of C adjacent columns x m rows, each column
// spread over T = m / P threads of P points in registers with
// radix_plan(m)'s passes (m = 64: [16, 4]; 128: [16, 8]; 1024: [32, 32],
// one exchange; 2048: [16, 16, 8]).  Thread (t, c) is threadIdx.x =
// t C + c: the lanes of a warp run along the columns, so the first pass
// reads x[(t + r T) n3 + c] straight from device memory and the last pass
// writes its bins straight to their permuted rows, each warp access C
// (>= 8) contiguous floats a row, 32 where C = 32 (m <= 256), 128 bytes;
// nothing is staged bit-reversed.  The exchange between passes keeps the
// tile's columns interleaved word by word in shared memory (fft_regs.cuh's
// Slot with Q = C), so a warp access at one logical index is C consecutive
// words; where a warp spans 32 / C > 1 logical indices, fft_regs.cuh's XOR
// swizzle of the pass's groups puts them on distinct banks
// (tests/test_torch_outer_regs.py counts every access of every plan).  C
// is set by shared memory and by blocks in flight: 256 threads a CTA
// (max(32, 256 / T) columns while T <= 16, 8 above: m = 128 is 32
// columns in 32 KB; m = 1024 8 in 64 KB; m = 2048 8 in 128 KB, 1024
// threads).
//
// Twiddle at the store, from registers: output register i holds bin k =
// t + out_index(i) T, known from t and i.  Column c = c0 + cc of the tile
// takes W_N^{k c} = W_N^{k c0} W_N^{k cc}.  The tile's exponent p = k c0 <
// N is exact in 64-bit integers and W_N^p = hi[p >> s] * lo[p & (2^s - 1)]
// reads two float64-built, once-rounded float32 tables of about sqrt(N)
// entries each (ops/cuda_outer.py: _factor_tables; godsp_tpu's factoring,
// pallas_outer.py _outer_tables, which holds 120 dB at 2^28), one address
// a row for the whole warp; W_N^{k cc} is a third such table of m C
// entries (_tile_table), read at k C + cc, coalesced.  Gathering hi and lo
// at p = k c itself strides lo by k across the lanes: at 2^28 (128 KB
// tables) that ran slower in a same-call comparison (PERF.md §6).  No
// __sinf/__cosf, no matmul, so no TF32.  The column passes read
// stockham_table(m) (conjugate for the inverse) through __ldg.

#include <cstdint>

#include "launch.cuh"
#include "fft_regs.cuh"

namespace {

using gdsp::regs::Row;
using gdsp::regs::Slot;
using gdsp::regs::out_index;
using gdsp::regs::row_dft;
using gdsp::regs::unroll;
using gdsp::regs::with_log2;

// The column tile of m = 2^LOG2M rows.
template <int LOG2M>
struct Tile {
  using R = Row<LOG2M>;
  static constexpr int kC = R::kT <= 16 ? (256 / R::kT > 32 ? 256 / R::kT : 32) : 8;  // columns
  static constexpr int kThreads = R::kT * kC;
  // CTAs a SM the launch bound asks for, a register cap: 4 at m = 64, 3 at
  // m = 128 and 2 at m = 1024 ran fastest in a same-call comparison on the
  // H100 (PERF.md §6; with the thread bound alone ptxas spent registers on
  // hoisted twiddle loads and ran one CTA a SM); 3 elsewhere, 1 where the
  // CTA's threads already cap it (m = 256: 512 threads, m = 2048: 1024).
  static constexpr int kMinBlocks = LOG2M == 6 ? 4 : LOG2M == 10 ? 2
                                  : LOG2M == 8 || LOG2M == 11 ? 1 : 3;
  static constexpr size_t kSmem =
      R::kPasses >= 2 ? static_cast<size_t>(kC) * R::kN * 2 * sizeof(float) : 0;
};

template <int LOG2M, bool INV>
__global__ void __launch_bounds__(Tile<LOG2M>::kThreads, Tile<LOG2M>::kMinBlocks)
outer_dft_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                 float* __restrict__ yr, float* __restrict__ yi, const float2* __restrict__ tw,
                 const float2* __restrict__ hi, const float2* __restrict__ lo,
                 const float2* __restrict__ tt, int d2, long long n3, long long batch,
                 int lo_bits) {
  using R = Row<LOG2M>;
  constexpr int m = R::kN;
  constexpr int C = Tile<LOG2M>::kC;
  extern __shared__ float smem[];
  const long long b = gdsp::block_row();
  if (b >= batch) return;  // the whole block: before any fence
  const int cc = threadIdx.x % C;
  const int t = threadIdx.x / C;
  const long long c = static_cast<long long>(blockIdx.x) * C + cc;
  const bool live = c < n3;
  const long long base = b * m * n3 + (live ? c : 0);
  float2 v[R::kP];
  unroll<R::kP>([&](auto rr) {
    constexpr int r = GDSP_IDX(rr);
    const long long g = base + static_cast<long long>(t + r * R::kT) * n3;
    v[r] = live ? make_float2(xr[g], xi[g]) : make_float2(0.f, 0.f);
  });
  row_dft<LOG2M, INV>(v, t, Slot<LOG2M, C, false>{smem, smem + C * m, cc}, tw);
  if (!live) return;
  const int d1 = m / d2;
  const unsigned long long lo_mask = (1ull << lo_bits) - 1;
  unroll<R::kP>([&](auto ii) {
    constexpr int i = GDSP_IDX(ii);
    const int k = t + out_index<LOG2M>(i) * R::kT;
    const unsigned long long p = static_cast<unsigned long long>(k) * (c - cc);  // k c0 < N
    const float2 w = gdsp::regs::mul(
        gdsp::regs::mul(__ldg(&hi[p >> lo_bits]), __ldg(&lo[p & lo_mask])), __ldg(&tt[k * C + cc]));
    const float2 y = gdsp::regs::mul(v[i], w);
    const long long g = base + static_cast<long long>((k % d1) * d2 + k / d1) * n3;
    yr[g] = y.x;
    yi[g] = y.y;
  });
}

}  // namespace

extern "C" {

// y = the outer levels of x over `batch` (m, n3) planes, m = 2^log2m
// (2..2048), rows stored in the (d1 = m / d2, d2) order above.  tw is
// ops/cuda_fft.py's stockham_table(m) (conjugate for the inverse); hi and
// lo the factored W_N tables, lo of 2^lo_bits entries; tt the tile's
// W_N^{k cc} (ops/cuda_outer.py: _tile_table).  Returns
// cudaErrorInvalidValue for an m out of range or more than 2^31 - 1
// column tiles, else cudaGetLastError().
int gdsp_outer_dft(const float* xr, const float* xi, float* yr, float* yi, const float2* tw,
                   const float2* hi, const float2* lo, const float2* tt, int log2m, int d2,
                   long long n3, long long batch, int lo_bits, int inverse, void* stream) {
  return with_log2<1, 11>(log2m, [&](auto lg) {
    constexpr int LM = decltype(lg)::value;
    using K = Tile<LM>;
    const long long tiles = (n3 + K::kC - 1) / K::kC;
    if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = inverse ? &outer_dft_kernel<LM, true> : &outer_dft_kernel<LM, false>;
    cudaError_t e = gdsp::allow_smem(kernel, K::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<gdsp::row_grid(static_cast<unsigned>(tiles), batch), K::kThreads, K::kSmem,
             static_cast<cudaStream_t>(stream)>>>(xr, xi, yr, yi, tw, hi, lo, tt, d2, n3, batch,
                                                  lo_bits);
    return static_cast<int>(cudaGetLastError());
  });
}

// The column tile of m = 2^log2m (1..11) as the kernel uses it: out[0]
// columns a CTA, [1] threads, [2] bytes of shared memory.
// ops/cuda_outer.py: tile holds the same; the GPU tests compare.
int gdsp_outer_dft_geometry(int log2m, int* out) {
  return with_log2<1, 11>(log2m, [&](auto lg) {
    using K = Tile<decltype(lg)::value>;
    out[0] = K::kC;
    out[1] = K::kThreads;
    out[2] = static_cast<int>(K::kSmem);
    return 0;
  });
}

}  // extern "C"
