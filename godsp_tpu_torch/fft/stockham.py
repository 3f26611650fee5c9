"""Stockham autosort radix-2 FFT in plain torch, batched over leading axes.

Port of godsp_tpu/fft/stockham.py, the independent radix-2 oracle beside
the four-step version (reference fft/radix2.go:80-153): log2(N) stages
of slice / butterfly / concatenate, unit-stride, natural order out.  It
runs no kernel.

Twiddles are built in float64 once per (L, sign) and cached, the
analogue of the reference's lazily built table (radix2.go:26-69).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from godsp_tpu_torch._dtypes import as_tensor, complex_for, working_float

__all__ = ["ensure_radix2_factors", "stockham_fft", "twiddles"]


@lru_cache(maxsize=None)
def _twiddles_f64(L: int, sign: int) -> np.ndarray:
    """exp(sign * 2i*pi * k / L) for k in [0, L/2), float64."""
    k = np.arange(L // 2, dtype=np.float64)
    ang = sign * 2.0 * np.pi * k / L
    return np.cos(ang) + 1j * np.sin(ang)


def twiddles(L: int, sign: int, dtype: torch.dtype, device=None) -> torch.Tensor:
    """The (L/2,) twiddle table in `dtype` on `device` (default: default_device())."""
    return as_tensor(_twiddles_f64(L, sign), device).to(dtype)


def ensure_radix2_factors(n: int) -> None:
    """Pre-build the twiddle tables of every power-of-2 size up to n
    (fft.EnsureRadix2Factors, fft/fft.go:103-107)."""
    L = 4
    while L <= n:
        _twiddles_f64(L, -1)
        _twiddles_f64(L, +1)
        L *= 2


def stockham_fft(x, inverse: bool = False) -> torch.Tensor:
    """Radix-2 FFT of the trailing axis; its length must be a power of 2.

    x: (..., N) complex (host data goes to default_device()).
    Unnormalized in both directions: the 1/N of the inverse lives in the
    public ifft (fft/fft.go:47-50).
    """
    x = as_tensor(x)
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError(f"stockham_fft requires a power-of-2 length, got {n}")
    if not (x.dtype.is_floating_point or x.dtype.is_complex):
        x = x.to(working_float(x.device))
    cdtype = complex_for(x.dtype)
    x = x.to(cdtype)
    if n <= 1:
        return x
    sign = 1 if inverse else -1
    lead = x.shape[:-1]
    # Time-major state (L, M*B): M interleaved sub-transforms of length L
    # over B batch lanes; concatenating the butterfly halves along the
    # merged axis is the Stockham self-sort.
    t = x.reshape(-1, n).transpose(0, 1)
    L = n
    while L > 1:
        half = L // 2
        w = twiddles(L, sign, cdtype, x.device)
        a, b = t[:half], t[half:]
        t = torch.cat([a + b, (a - b) * w[:, None]], dim=1)
        L = half
    return t.reshape(n, -1).transpose(0, 1).reshape(*lead, n)
