"""Split-complex public FFT: (re, im) planes in, planes out.

Port of godsp_tpu/fft/split.py.  On CUDA, float32 planes of power-of-2
length up to 16384 run the kernels directly (K1 fft_pow2, K2 ifft_pow2,
K3 rfft_pow2 in ops/cuda_fft.py), with the inverse's 1/N folded into the
kernel's store; everything else, the large plan included, goes through
the complex dispatch (fft/core.py).  The
public layouts are natural bin order and, for rfft_split, numpy's rfft
layout (bins 0..N/2).
"""

from __future__ import annotations

import torch

from godsp_tpu_torch._dtypes import as_real_array
from godsp_tpu_torch.fft.pow2 import kernel_route
from godsp_tpu_torch.ops import cuda_fft

__all__ = ["fft_split", "ifft_split", "rfft_split"]


def _dispatch(xr, xi, inverse: bool, scale: float):
    """xi may be None (real input): the kernel then reads one plane only."""
    n = xr.shape[-1]
    if cuda_fft.supported_size(n) and kernel_route(xr):
        if inverse:
            return cuda_fft.ifft_pow2(xr, xi, scale=scale)
        return cuda_fft.fft_pow2(xr, xi, scale=scale)
    from godsp_tpu_torch.fft.core import fft, ifft

    z = torch.complex(xr, torch.zeros_like(xr) if xi is None else xi)
    Z = ifft(z) if inverse else fft(z)  # ifft applies 1/N itself
    if not inverse and scale != 1.0:
        Z = Z * scale
    return Z.real.contiguous(), Z.imag.contiguous()


def _planes(xr, xi):
    xr = as_real_array(xr)
    if xi is None:
        return xr, None
    xi = as_real_array(xi, device=xr.device)
    if xr.shape != xi.shape:
        raise ValueError("re/im planes must have identical shapes")
    return xr, xi.to(xr.dtype)


def fft_split(xr, xi=None):
    """Natural-order forward DFT over split planes (..., N) -> (yr, yi).

    xi=None means a real input.  Matches fft.fft on complex(xr, xi) bin
    for bin.
    """
    xr, xi = _planes(xr, xi)
    if xr.shape[-1] <= 1:
        return xr, (torch.zeros_like(xr) if xi is None else xi)
    return _dispatch(xr, xi, inverse=False, scale=1.0)


def ifft_split(yr, yi):
    """Normalized inverse DFT over split planes: fft.ifft semantics
    (1/N on the inverse, fft.go:47-50)."""
    yr, yi = _planes(yr, yi)
    if yi is None:
        raise ValueError("ifft_split needs both planes")
    n = yr.shape[-1]
    if n <= 1:
        return yr, yi
    return _dispatch(yr, yi, inverse=True, scale=1.0 / n)


def rfft_split(xr):
    """One-sided forward DFT of a real plane (..., N) -> (yr, yi) planes of
    shape (..., N//2 + 1), numpy.fft.rfft bin layout (FFTReal,
    fft/fft.go:25-32).  On CUDA, pow-2 float32 planes run K3."""
    xr = as_real_array(xr)
    n = xr.shape[-1]
    if n <= 1:
        return xr, torch.zeros_like(xr)
    if cuda_fft.supported_size(n) and kernel_route(xr):
        return cuda_fft.rfft_pow2(xr)
    yr, yi = fft_split(xr, None)
    return yr[..., : n // 2 + 1], yi[..., : n // 2 + 1]
