// Register-radix Stockham FFT rows for Hopper (sm_90a): the body of
// fft_pow2_kernel (K1, K2) and rfft_pow2_kernel (K3) in fft_kernels.cu, of
// stft_kernel (K5: K3's half-length frame) in stft_kernel.cu and of
// outer_dft_kernel (K8: the passes run down the columns of a tile, Q = the
// tile's columns, a block barrier a fence) in outer_kernel.cu.
//
// Plan.  A row of n = 2^LOG2N complex float32 points is spread over
// T = n / P threads, P points a thread held in registers.  The transform is
// ceil(log2 n / log2 P) Stockham passes: every pass has radix P but the
// last, which takes the radix left over (ops/cuda_fft.py: radix_plan gives
// the same plan, fft_pow2_stockham_model follows these passes in float64):
//
//   n          P    T        radices a pass      route
//   2 .. 16    n    1        [n]                 warp, 32 rows a warp
//   32 .. 256  16   2 .. 16  [16, n / 16]        warp, 32 / T rows a warp
//   512        16   32       [16, 16, 2]         warp, 1 row a warp
//   1024       32   32       [32, 32]            warp, 1 row a warp
//   2048       16   128      [16, 16, 8]         block
//   4096       16   256      [16, 16, 16]        block
//   8192       16   512      [16, 16, 16, 2]     block
//   16384      16   1024     [16, 16, 16, 4]     block
//
// So n <= 1024 keeps a row inside one warp: its exchanges are fenced by
// __syncwarp and no block barrier; from 2048 on a row takes a block (up to
// 1024 threads) and __syncthreads.  n = 1024 is 2 passes and 1 exchange,
// n = 16384 is 4 passes and 3 exchanges.
//
// Stockham pass p of radix R, stride Ns (the product of the earlier
// radices): butterfly j < n / R, k = j mod Ns, reads a[j + r n / R],
// r < R, multiplies element r by W_{Ns R}^{r k}, takes the R-point DFT in
// registers and writes b[(j / Ns) Ns R + k + r Ns].  Natural order in and
// out: no bit reversal anywhere.  Thread t runs butterflies j = t + b T,
// b < P / R.  The first pass (Ns = 1, R = P, j = t) reads x[t + r T]
// straight from device memory and the last pass (Ns R = n) writes
// y[t + c T], c < P, straight to it, with `scale` applied at the store:
// every warp access is 32 consecutive floats of a plane (K3: float2s), and
// no staging copy.
//
// The R-point DFT (dft_regs) runs radix-2 DIF stages over the thread's
// registers; the internal constants W_32^e are float32 literals rounded
// once from float64 (oct32), -i and 1 exact; the result is renamed back
// to natural order by swaps.  Every register index is a constant
// expression (unroll), so the P points never leave registers.
//
// Exchange between passes, through shared memory, one float plane for re
// and one for im (32-bit words: bank = word mod 32).  A row's slot holds n
// words a plane.  Logical index i (a point of the row) lands at word
//   base(slot) + L(i) Q + slot mod Q,    base = (slot / Q) Q n,
// Q = 32 / T rows interleaved word by word in the warp route (T < 32),
// Q = 1 otherwise, and L the XOR swizzle of the pass that wrote it
// (stride Ns, radix R, M = Ns R):
//   L(i) = i ^ ((i / M) Ns mod 32)        (identity once Ns >= 32).
// A write puts 32 / Ns groups of Ns consecutive i, M apart, on one warp
// access: the swizzle moves group g to the banks g Ns higher.  A read is
// an aligned run of 32 (or of T, Q runs side by side) consecutive i, which
// L permutes inside its 32-word line.  So each exchange is free of bank
// conflicts; tests/test_torch_fft_regs.py counts the banks of every warp
// access of every plan.
//
// Twiddles: one table of n float2 a transform, built in float64 on the
// host and rounded once to float32 (ops/cuda_fft.py: stockham_table; the
// inverse passes the conjugate table).  Pass p reads tw[r Ns + k] =
// W_{Ns R}^{r k}, r = 1 .. R - 1: the table is laid out in the order the
// passes read it (pass p's entries at [Ns, Ns R)), each warp load a run of
// consecutive k.  It stays in device memory, read through the read-only
// L1 path (__ldg): n <= 1024 is at most 8 KB, which stays in L1 after the
// first rows, and at n = 16384 its 128 KB would not fit in shared memory
// beside the row's own 128 KB.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>
#include <utility>

namespace gdsp {
namespace regs {

// ---------------------------------------------------------------------------
// The plan
// ---------------------------------------------------------------------------

// log2 of the points a thread holds.
__host__ __device__ constexpr int points_log2(int log2n) {
  return log2n <= 4 ? log2n : log2n == 10 ? 5 : 4;
}

__host__ __device__ constexpr int num_passes(int log2n) {
  return log2n == 0 ? 0 : (log2n + points_log2(log2n) - 1) / points_log2(log2n);
}

// log2 of pass p's radix: P, but the last pass takes what is left.
__host__ __device__ constexpr int pass_log2r(int log2n, int p) {
  return log2n - p * points_log2(log2n) < points_log2(log2n) ? log2n - p * points_log2(log2n)
                                                            : points_log2(log2n);
}

// The low `bits` bits of v reversed.  A loop, not a recursion: nvcc folds
// it at every unrolled call (a recursive form left the renaming of radix-4
// and radix-8 DFTs in local memory).
__host__ __device__ constexpr int rev(int v, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((v >> b) & 1) << (bits - 1 - b);
  return r;
}

__host__ __device__ constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v / 2); }

template <int LOG2N>
struct Row {
  static constexpr int kN = 1 << LOG2N;
  static constexpr int kLog2P = points_log2(LOG2N);
  static constexpr int kP = 1 << kLog2P;  // points a thread
  static constexpr int kT = kN / kP;      // threads a row
  static constexpr bool kWarp = kT <= 32;
  static constexpr int kQ = kWarp ? 32 / kT : 1;  // rows a warp interleaves
  static constexpr int kPasses = num_passes(LOG2N);
  static constexpr int kMaxThreads = kWarp ? 512 : 1024;  // a CTA, the launch bound
};

// Rows a CTA holds, threads it runs and words of a plane its shared memory
// holds, at `rows` rows a CTA (slots: rows rounded up to whole warps in the
// warp route).
struct Cta {
  int threads, slots;
};

template <int LOG2N>
__host__ __device__ constexpr Cta cta_shape(int rows) {
  using S = Row<LOG2N>;
  return S::kWarp ? Cta{32 * ((rows + S::kQ - 1) / S::kQ), S::kQ * ((rows + S::kQ - 1) / S::kQ)}
                  : Cta{rows * S::kT, rows};
}

// f(std::integral_constant<int, L>{}) for L = log2n in [L, HI]
// (cudaErrorInvalidValue outside): the host picks an instantiation.
template <int L, int HI, class F>
int with_log2(int log2n, F f) {
  if constexpr (L > HI) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return log2n == L ? f(std::integral_constant<int, L>{}) : with_log2<L + 1, HI>(log2n, f);
  }
}

// Rows a CTA by default: eight warps in the warp route, one row in the
// block route (the fastest settings of the H100 sweep, PERF.md).
template <int LOG2N>
constexpr int default_rows() {
  return Row<LOG2N>::kWarp ? 8 * Row<LOG2N>::kQ : 1;
}

// ---------------------------------------------------------------------------
// Complex arithmetic and the R-point DFT in registers
// ---------------------------------------------------------------------------

__device__ __forceinline__ float2 add(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 sub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 mul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

// cos(2 pi e / 32), e = 0..8: float64 rounded once to float32.
__host__ __device__ constexpr float oct32(int e) {
  return e == 0 ? 1.0f
       : e == 1 ? 0.98078525f
       : e == 2 ? 0.9238795f
       : e == 3 ? 0.8314696f
       : e == 4 ? 0.70710677f
       : e == 5 ? 0.55557024f
       : e == 6 ? 0.38268343f
       : e == 7 ? 0.19509032f
                : 0.0f;
}

// d W_32^E (forward) or d conj(W_32^E) (INV), 0 <= E < 16: 1 and -i exact.
template <bool INV, int E>
__device__ __forceinline__ float2 rot32(float2 d) {
  if constexpr (E == 0) {
    return d;
  } else if constexpr (E == 8) {
    return INV ? make_float2(-d.y, d.x) : make_float2(d.y, -d.x);
  } else {
    constexpr float c = E < 8 ? oct32(E) : -oct32(16 - E);
    constexpr float s = E < 8 ? oct32(8 - E) : oct32(E - 8);
    return mul(d, make_float2(c, INV ? s : -s));
  }
}

template <class F, int... I>
__device__ __forceinline__ void unroll_seq(F& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}

// f(std::integral_constant<int, i>{}) for i = 0 .. N-1: every register
// index below is a constant expression, so no array of points depends on
// the compiler's unrolling heuristics to stay in registers (with
// `#pragma unroll` loops some plans kept a 128-byte array in local memory).
template <int N, class F>
__device__ __forceinline__ void unroll(F f) {
  unroll_seq(f, std::make_integer_sequence<int, N>{});
}

#define GDSP_IDX(c) decltype(c)::value

// The R-point DFT (R <= 32) of v[0..R) in place, natural order in and out:
// radix-2 DIF stages (the pair i, i + h of a stage takes a + b and
// (a - b) W_{2h}^{i mod h}), then a renaming from bit-reversed order by
// swaps.
template <int R, bool INV>
__device__ __forceinline__ void dft_regs(float2* v) {
  constexpr int kBits = ilog2(R);
  unroll<kBits>([&](auto s) {
    constexpr int h = R >> (GDSP_IDX(s) + 1);
    unroll<R>([&](auto ii) {
      constexpr int i = GDSP_IDX(ii);
      if constexpr ((i & h) == 0) {
        const float2 a = v[i], b = v[i + h];
        v[i] = add(a, b);
        v[i + h] = rot32<INV, (i & (h - 1)) * (16 / h)>(sub(a, b));
      }
    });
  });
  unroll<R>([&](auto kk) {
    constexpr int k = GDSP_IDX(kk);
    constexpr int rk = rev(k, kBits);
    if constexpr (k < rk) {
      const float2 tmp = v[k];
      v[k] = v[rk];
      v[rk] = tmp;
    }
  });
}

// ---------------------------------------------------------------------------
// Passes
// ---------------------------------------------------------------------------

template <int LOG2N, int PASS>
struct Pass {
  using S = Row<LOG2N>;
  static constexpr int kLog2R = pass_log2r(LOG2N, PASS);
  static constexpr int kR = 1 << kLog2R;
  static constexpr int kLog2Ns = PASS * S::kLog2P;
  static constexpr int kNs = 1 << kLog2Ns;
  static constexpr int kB = S::kP / kR;  // butterflies a thread
};

// L(i) for the exchange written by pass PASS.
template <int LOG2N, int PASS>
__device__ __forceinline__ int swizzle(int i) {
  using X = Pass<LOG2N, PASS>;
  if (X::kNs >= 32) return i;
  return i ^ (((i >> (X::kLog2Ns + X::kLog2R)) << X::kLog2Ns) & 31);
}

__device__ __forceinline__ void fence(bool warp) {
  if (warp) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// A thread's view of its row in shared memory: word of logical index i
// (already swizzled) is at base + i * Q, Q rows (K8: columns of a tile)
// interleaved word by word; WARP: the row's threads are one warp, so its
// exchanges are fenced by __syncwarp alone.
template <int LOG2N, int Q = Row<LOG2N>::kQ, bool WARP = Row<LOG2N>::kWarp>
struct Slot {
  float* re;
  float* im;
  int base;
  __device__ __forceinline__ void put(int i, float2 v) const {
    re[base + i * Q] = v.x;
    im[base + i * Q] = v.y;
  }
  __device__ __forceinline__ float2 get(int i) const {
    return make_float2(re[base + i * Q], im[base + i * Q]);
  }
  __device__ __forceinline__ void fence() const { regs::fence(WARP); }
};

template <int LOG2N>
__device__ __forceinline__ Slot<LOG2N> slot_of(float* smem, int slots, int slot) {
  using S = Row<LOG2N>;
  return Slot<LOG2N>{smem, smem + slots * S::kN, (slot / S::kQ) * S::kQ * S::kN + slot % S::kQ};
}

// Pass PASS's twiddles and DFTs on v[b R + r] (element r of butterfly
// j = t + b T).
template <int LOG2N, int PASS, bool INV>
__device__ __forceinline__ void butterflies(float2* v, int t, const float2* __restrict__ tw) {
  using X = Pass<LOG2N, PASS>;
  unroll<X::kB>([&](auto bb) {
    constexpr int b = GDSP_IDX(bb);
    if constexpr (PASS > 0) {
      const int k = (t + b * Row<LOG2N>::kT) & (X::kNs - 1);
      unroll<X::kR - 1>([&](auto rr) {
        constexpr int r = GDSP_IDX(rr) + 1;
        v[b * X::kR + r] = mul(v[b * X::kR + r], __ldg(&tw[r * X::kNs + k]));
      });
    }
    dft_regs<X::kR, INV>(v + b * X::kR);
  });
}

// Pass PASS's outputs into the exchange, then the next pass's inputs out
// of it.
template <int LOG2N, int PASS, class SlotT>
__device__ __forceinline__ void exchange(float2* v, int t, const SlotT& s) {
  using S = Row<LOG2N>;
  using X = Pass<LOG2N, PASS>;
  using Y = Pass<LOG2N, PASS + 1>;
  unroll<X::kB>([&](auto bb) {
    constexpr int b = GDSP_IDX(bb);
    const int j = t + b * S::kT;
    const int out = ((j >> X::kLog2Ns) << (X::kLog2Ns + X::kLog2R)) + (j & (X::kNs - 1));
    unroll<X::kR>([&](auto rr) {
      constexpr int r = GDSP_IDX(rr);
      s.put(swizzle<LOG2N, PASS>(out + r * X::kNs), v[b * X::kR + r]);
    });
  });
  s.fence();
  unroll<Y::kB>([&](auto bb) {
    constexpr int b = GDSP_IDX(bb);
    const int j = t + b * S::kT;
    unroll<Y::kR>([&](auto rr) {
      constexpr int r = GDSP_IDX(rr);
      v[b * Y::kR + r] = s.get(swizzle<LOG2N, PASS>(j + r * (S::kN / Y::kR)));
    });
  });
  s.fence();  // every read done before the slot is written again
}

template <int LOG2N, int PASS, bool INV, class SlotT>
__device__ __forceinline__ void passes_from(float2* v, int t, const SlotT& s,
                                            const float2* __restrict__ tw) {
  if constexpr (PASS < Row<LOG2N>::kPasses) {
    if constexpr (PASS > 0) exchange<LOG2N, PASS - 1>(v, t, s);
    butterflies<LOG2N, PASS, INV>(v, t, tw);
    passes_from<LOG2N, PASS + 1, INV>(v, t, s, tw);
  }
}

// The n-point DFT of one row.  In: v[r] = x[t + r T], r < P (the first
// pass's inputs).  Out: v[b R + r] = X[t + (b + r B) T] with the last
// pass's radix R and B = P / R butterflies a thread (out_index gives the
// bin).  s is the row's Slot (any Q and fence).  Every thread of the CTA
// calls it (it fences); ends fenced when a pass read shared memory.
template <int LOG2N, bool INV, class SlotT>
__device__ __forceinline__ void row_dft(float2* v, int t, const SlotT& s,
                                        const float2* __restrict__ tw) {
  passes_from<LOG2N, 0, INV>(v, t, s, tw);
}

// The bin index c (X[t + c T]) of output register i after row_dft.
template <int LOG2N>
__host__ __device__ constexpr int out_index(int i) {
  using S = Row<LOG2N>;
  return S::kPasses == 0 ? 0
       : (i % (1 << pass_log2r(LOG2N, S::kPasses - 1))) * (S::kP >> pass_log2r(LOG2N, S::kPasses - 1)) +
             i / (1 << pass_log2r(LOG2N, S::kPasses - 1));
}

}  // namespace regs
}  // namespace gdsp
