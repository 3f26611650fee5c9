"""Large power-of-2 FFT (N > 16384, through 2^28) over the Hopper kernels.

Port of godsp_tpu/fft/large.py.  It covers the reference's only
benchmark, a 2^20-point complex FFT (fft/fft_test.go:262-280), and the
sizes above it through 2^28.  The FFT kernel's rows stop at 16384 points
(ops/cuda_fft.py: what one block's shared memory holds), so the
transform factors as N = m * n3, a Cooley-Tukey split with the plan's
own layout:

    x[b, i, t] = x[b, i*n3 + t]
    K8 outer_dft_split:  X[b, k, t] = W_N^{k t} sum_i x[b, i, t] W_m^{k i}
                         (the m-point column DFT and the twiddle, one pass)
    K1/K2 rows:          Y[b, k, k3] = sum_t X[b, k, t] W_n3^{k3 t}
    fold:                bin k + m*k3 = Y[b, k, k3], one permute to
                         natural order (packed into the complex result)

with n3 = 8192 up to 2^20 (m <= 128) and 16384 above, so m <= 2048 for
N <= 2^25 and one K8 call does the outer levels.  Above that (2^26..2^28,
m up to 16384) a block's m-row tile would not fit shared memory, so m
splits as g * m2 into two K8 calls, each with its own twiddle: call 1 over
(b, g, m2*n3), call 2 over (b*g, m2, n3); bin k_a + g*k_b + m*k3 then
folds in the same one permute (godsp_tpu's recursive branch,
large.py:347-374).  Each K8 call passes the planes once; with the split
of a complex input into planes, the plan makes four passes over device
memory at N <= 2^25 (split, K8, rows, fold) and five above.

On the CPU the same plan runs the wrappers' plain versions in the
input's dtype (the float64 parity mode); the public fft reaches it only
on CUDA (fft/pow2.py), as godsp_tpu reaches it only on the TPU.  The
inverse conjugates every table and applies `scale` in the row kernel's
store (the public ifft passes 1/N).

godsp_tpu's TPU A/B knobs (set_peel_enabled, set_fuse_rows_enabled,
set_outer_kernel_enabled) select TPU structure and are not ported;
fft.set_kernels_enabled covers the kernel A/B.
"""

from __future__ import annotations

import torch

from godsp_tpu_torch.ops import cuda_fft, cuda_outer

__all__ = ["fft_large", "fft_large_split", "large_supported", "set_large_min"]

_KERNEL_MAX = cuda_fft.MAX_N  # 16384: the row kernel's largest row
_ROW_N = 8192  # rows of the plans up to 2^20
_MAX_N = 1 << 28  # godsp_tpu's range (large.py:101-106)
# Largest m one K8 call takes (a block's m x 8 tile in shared memory).
# Tests shrink it to run the two-call branch at CPU size.
_MAX_ROWS = cuda_outer.MAX_ROWS

# Smallest size routed through this module; set_large_min(16384) routes
# 16384 here (m = 2, n3 = 8192) instead of the single row kernel.
_MIN_N = 2 * _KERNEL_MAX


def set_large_min(n: int) -> None:
    """Lowest FFT size dispatched through the large plan (default 32768;
    16384 routes n = 16384 here instead of one row-kernel transform)."""
    global _MIN_N
    _MIN_N = int(n)


def large_supported(n: int) -> bool:
    """Power-of-2 sizes from the large-plan minimum through 2^28 (the
    same set as godsp_tpu's large_supported)."""
    return n & (n - 1) == 0 and max(_MIN_N, 2 * _ROW_N) <= n <= _MAX_N


def _plan(n: int) -> tuple[int, int]:
    """n = m * n3: rows of 8192 while m <= 128, else of 16384."""
    n3 = _ROW_N if n <= _ROW_N * 128 else _KERNEL_MAX
    return n // n3, n3


def _balanced(v: int) -> tuple[int, int]:
    l2 = v.bit_length() - 1
    hi = 1 << (l2 - l2 // 2)
    return hi, v // hi


def _transform(xr, xi, inverse: bool, scale: float):
    """Outer levels and rows: (yr, yi, perm), planes of shape
    (b, *outer, n3) and the permute that puts their bins in natural
    order."""
    n = xr.shape[-1]
    if not large_supported(n):
        raise ValueError(f"unsupported large-FFT size: {n} (pow-2 {_MIN_N}..2^28)")
    if xr.shape != xi.shape:
        raise ValueError("re/im planes must have identical shapes")
    m, n3 = _plan(n)
    b = xr.numel() // n
    if m <= _MAX_ROWS:
        yr, yi = cuda_outer.outer_dft_split(xr.reshape(b, m, n3), xi.reshape(b, m, n3), m, 1,
                                            inverse)
        outer, perm = (m,), (0, 2, 1)
    else:
        g, m2 = _balanced(m)
        yr, yi = cuda_outer.outer_dft_split(xr.reshape(b, g, m2 * n3), xi.reshape(b, g, m2 * n3),
                                            g, 1, inverse)
        yr, yi = cuda_outer.outer_dft_split(yr.reshape(b * g, m2, n3), yi.reshape(b * g, m2, n3),
                                            m2, 1, inverse)
        outer, perm = (g, m2), (0, 3, 2, 1)
    yr, yi = yr.reshape(b * m, n3), yi.reshape(b * m, n3)
    if inverse:
        yr, yi = cuda_fft.ifft_pow2(yr, yi, scale=scale)
    else:
        yr, yi = cuda_fft.fft_pow2(yr, yi, scale=scale)
    shape = (b, *outer, n3)
    return yr.reshape(shape), yi.reshape(shape), perm


def fft_large_split(xr: torch.Tensor, xi: torch.Tensor,
                    inverse: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Unnormalized large-N DFT (inverse: conjugate tables, no 1/N) over
    split planes (..., N), natural bin order in and out."""
    yr, yi, perm = _transform(xr, xi, inverse, 1.0)
    return (yr.permute(perm).reshape(xr.shape), yi.permute(perm).reshape(xr.shape))


def fft_large(x: torch.Tensor, inverse: bool = False, scale: float = 1.0) -> torch.Tensor:
    """Complex wrapper: scale * unnormalized large-N DFT, natural order.
    The fold to natural order and the complex pack are one pass."""
    yr, yi, perm = _transform(x.real, x.imag, inverse, scale)
    yr, yi = yr.permute(perm), yi.permute(perm)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    torch.complex(yr, yi, out=out.view(yr.shape))
    return out
