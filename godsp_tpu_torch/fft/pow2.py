"""Power-of-2 FFT dispatcher: the one choke point of every pow-2 transform.

Port of godsp_tpu/fft/pow2.py.  Public fft/ifft, convolve (1-D and, in
pow2_convolve2, 2-D) and Bluestein's circular filter all pass through
here:

  * a CUDA float32/complex64 tensor launches the Hopper kernels: K1
    fft_pow2 forward and K2 ifft_pow2 for every inverse at N = 2..16384
    (ops/cuda_fft.py), and the large plan (fft/large.py: K8
    outer_dft_split, then K1/K2 rows) for N = 2^15..2^28 (and 16384
    after set_large_min(16384)), checked first as godsp_tpu does;
  * a CUDA tensor of another dtype, or of pow-2 N > 2^28, raises;
  * a CPU tensor runs the plain four-step version (fft/four_step.py), as
    godsp_tpu runs its four-step off the TPU.

set_kernels_enabled(False) is the A/B knob (godsp_tpu's
set_pallas_enabled): the plain version then runs on CUDA too.  It is not
a fallback: nothing switches it off on its own.
"""

from __future__ import annotations

import torch

from godsp_tpu_torch.fft.four_step import four_step_fft
from godsp_tpu_torch.fft.large import fft_large, large_supported
from godsp_tpu_torch.ops import cuda_fft

__all__ = [
    "kernels_enabled",
    "pow2_circular_filter",
    "pow2_convolve",
    "pow2_convolve2",
    "pow2_fft",
    "set_kernels_enabled",
]

_kernels_on = True


def set_kernels_enabled(on: bool) -> None:
    """Enable/disable the CUDA kernel route globally (default on)."""
    global _kernels_on
    _kernels_on = bool(on)


def kernels_enabled() -> bool:
    return _kernels_on


def kernel_route(x: torch.Tensor) -> bool:
    """True when x's transform must run on the kernels: a CUDA tensor while
    they are on.  Raises for a CUDA tensor they cannot take."""
    if not (x.is_cuda and _kernels_on):
        return False
    n = x.shape[-1]
    if x.dtype not in (torch.float32, torch.complex64):
        raise TypeError(f"the CUDA FFT kernels take float32/complex64, got {x.dtype}")
    if not (cuda_fft.supported_size(n) or large_supported(n)):
        raise NotImplementedError(
            f"pow-2 FFT of length {n} on CUDA: the kernels cover 2..2^28 (fft/large.py)"
        )
    return True


def pow2_fft(x: torch.Tensor, inverse: bool = False, scale: float = 1.0) -> torch.Tensor:
    """scale * unnormalized DFT (or conjugate-table inverse) of the trailing
    power-of-2 axis, batched.  x complex."""
    n = x.shape[-1]
    if n <= 1:
        return x * scale if scale != 1.0 else x
    if kernel_route(x):
        if large_supported(n):
            return fft_large(x, inverse, scale)
        if inverse:
            yr, yi = cuda_fft.ifft_pow2(x.real, x.imag, scale=scale)
        else:
            yr, yi = cuda_fft.fft_pow2(x.real, x.imag, scale=scale)
        return torch.complex(yr, yi)
    y = four_step_fft(x, inverse)
    return y * scale if scale != 1.0 else y


def pow2_circular_filter(x: torch.Tensor, h: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """scale * IDFT(DFT(x) * h): the Convolve/Bluestein core.

    h: the frequency response in natural bin order (same trailing length
    as x).  On CUDA: forward kernel -> elementwise product in torch ->
    inverse kernel with scale folded into its store (through the large
    plan for N > 16384).
    """
    if kernel_route(x):
        if large_supported(x.shape[-1]):
            return fft_large(fft_large(x) * h, inverse=True, scale=scale)
        xr, xi = cuda_fft.fft_pow2(x.real, x.imag)
        pr = xr * h.real - xi * h.imag
        pi = xr * h.imag + xi * h.real
        zr, zi = cuda_fft.ifft_pow2(pr, pi, scale=scale)
        return torch.complex(zr, zi)
    return pow2_fft(pow2_fft(x) * (h * scale), inverse=True)


def pow2_convolve(x: torch.Tensor, y: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """scale * IDFT(DFT(x) * DFT(y)); scale=1/N folds the normalized inverse
    into the inverse kernel's store."""
    if kernel_route(x):
        if large_supported(x.shape[-1]):
            return fft_large(fft_large(x) * fft_large(y), inverse=True, scale=scale)
        xr, xi = cuda_fft.fft_pow2(x.real, x.imag)
        yr, yi = cuda_fft.fft_pow2(y.real, y.imag)
        zr, zi = cuda_fft.ifft_pow2(xr * yr - xi * yi, xr * yi + xi * yr, scale=scale)
        return torch.complex(zr, zi)
    return pow2_fft(pow2_fft(x) * pow2_fft(y), inverse=True, scale=scale)


def pow2_convolve2(x: torch.Tensor, y: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """2-D circular convolution scale * IDFT2(DFT2(x) * DFT2(y)) over the
    two trailing power-of-2 axes, batched (and broadcast) over leading axes.

    Each separable pass goes through pow2_fft, which transforms the
    trailing axis: on the card K1 forward and K2 inverse at up to 16384
    points a row, the large plan above.  The column pass takes a
    transposed contiguous copy, so the product and the first inverse run
    in (n2, n1) order, and scale folds into the last inverse's store.
    """

    def fwd2(c: torch.Tensor) -> torch.Tensor:
        c = pow2_fft(c)
        return pow2_fft(c.transpose(-1, -2).contiguous())  # (..., n2, n1)

    z = pow2_fft(fwd2(x) * fwd2(y), inverse=True)
    return pow2_fft(z.transpose(-1, -2).contiguous(), inverse=True, scale=scale)
