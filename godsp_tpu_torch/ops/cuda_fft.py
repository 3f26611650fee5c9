"""Batched power-of-2 FFT kernels for Hopper, with their plain versions.

Counterpart of godsp_tpu/ops/pallas_fft.py.  Three wrappers, each with
its own launch count, over the one kernel of csrc/fft_kernels.cu
(fft_pow2_kernel):

  K1 fft_pow2(xr, xi|None, inverse, scale)   replaces pallas_fft.py: fft_pow2_split
  K2 ifft_pow2(yr, yi, scale)                replaces pallas_fft.py: ifft_pow2_digit_split
                                             (K1's conjugate-table mode)
  K3 rfft_pow2(xr)                           replaces pallas_fft.py: rfft_pow2_split
                                             (K1's real-input mode storing n/2+1 bins)

The TPU kernels contracted DFT tables on the MXU and emitted a digit bin
order; on Hopper each row is one radix-2 FFT in shared memory with a
float64-built twiddle table, and every output is in natural order (K2
takes natural-order input).  The pow-2 range is N = 2..16384: the TPU's
256 floor was a lane rule, and 16384 rows (128 KB) are what one block's
shared memory holds.  What bounds each kernel on the H100 is in the
source's header: device-memory traffic, one read and one write a point.

Beside each wrapper stands its plain PyTorch version (fft/four_step.py),
and a launch count.  A wrapper takes the plain version only for a tensor
on the CPU; for a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from godsp_tpu_torch.fft.four_step import four_step_fft
from godsp_tpu_torch.ops import _build

__all__ = [
    "MAX_N",
    "fft_pow2",
    "fft_pow2_plain",
    "ifft_pow2",
    "ifft_pow2_plain",
    "launches",
    "rfft_pow2",
    "rfft_pow2_plain",
    "supported_size",
    "twiddle_table",
]

MAX_N = 16384

# Kernel launches by wrapper, counted where each launches its kernel.
launches = {"fft_pow2": 0, "ifft_pow2": 0, "rfft_pow2": 0}


def supported_size(n: int) -> bool:
    """Power-of-2 sizes the kernels cover: 2..16384."""
    return n >= 2 and n & (n - 1) == 0 and n <= MAX_N


@lru_cache(maxsize=None)
def twiddle_table(n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """(n/2, 2) float32 table exp(-+2 pi i j / n), built in float64, rounded once."""
    j = np.arange(n // 2, dtype=np.float64)
    ang = (2.0 if inverse else -2.0) * np.pi * j / n
    tab = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    return torch.from_numpy(tab).to(device)


# ---------------------------------------------------------------------------
# Plain versions (any device, any float dtype: the float64 oracle on the card)
# ---------------------------------------------------------------------------


def fft_pow2_plain(xr: torch.Tensor, xi: torch.Tensor | None, inverse: bool = False,
                   scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """scale * DFT (or conjugate-table inverse DFT) of split planes, natural order."""
    z = torch.complex(xr, torch.zeros_like(xr) if xi is None else xi)
    y = four_step_fft(z, inverse)
    if scale != 1.0:
        y = y * scale
    return y.real.contiguous(), y.imag.contiguous()


def ifft_pow2_plain(yr: torch.Tensor, yi: torch.Tensor,
                    scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """scale * inverse DFT of natural-order planes."""
    return fft_pow2_plain(yr, yi, inverse=True, scale=scale)


def rfft_pow2_plain(xr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Bins 0..N/2 of the DFT of a real plane: (..., N/2 + 1) x 2."""
    n = xr.shape[-1]
    yr, yi = fft_pow2_plain(xr, None)
    return yr[..., : n // 2 + 1].contiguous(), yi[..., : n // 2 + 1].contiguous()


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _cuda_plane(t: torch.Tensor, n: int, name: str) -> torch.Tensor:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32 planes, got {t.dtype}")
    if not supported_size(n):
        raise ValueError(f"{name}: unsupported kernel size {n} (pow-2 2..{MAX_N})")
    return t.contiguous()


def _launch(xr, xi, inverse: bool, scale: float, out_n: int, name: str):
    """Run fft_pow2_kernel over the rows of xr (and xi): bins 0..out_n-1."""
    n = xr.shape[-1]
    xr = _cuda_plane(xr, n, name)
    if xi is not None:
        if xi.shape != xr.shape or xi.device != xr.device:
            raise ValueError(f"{name}: re/im planes must match in shape and device")
        xi = _cuda_plane(xi, n, name)
    yr = torch.empty(*xr.shape[:-1], out_n, dtype=torch.float32, device=xr.device)
    yi = torch.empty_like(yr)
    rows = xr.numel() // n
    if rows == 0:
        return yr, yi
    lib = _build.library()
    with torch.cuda.device(xr.device):
        rc = lib.gdsp_fft_pow2(
            xr.data_ptr(), None if xi is None else xi.data_ptr(),
            yr.data_ptr(), yi.data_ptr(),
            twiddle_table(n, inverse, xr.device).data_ptr(),
            n.bit_length() - 1, out_n, rows, float(scale),
            torch.cuda.current_stream(xr.device).cuda_stream,
        )
    _build.check(rc, name)
    launches[name] += 1
    return yr, yi


def fft_pow2(xr: torch.Tensor, xi: torch.Tensor | None, inverse: bool = False,
             scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """K1: batched scale * DFT over split float32 planes (..., N), natural order.

    xi=None marks a real input (one plane read).  inverse runs the
    conjugate-table transform (unnormalized unless scale says so).
    """
    if xi is None and inverse:
        raise ValueError("real-input mode is forward-only (xi=None)")
    if not xr.is_cuda:
        return fft_pow2_plain(xr, xi, inverse, scale)
    return _launch(xr, xi, inverse, scale, xr.shape[-1], "fft_pow2")


def ifft_pow2(yr: torch.Tensor, yi: torch.Tensor,
              scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """K2: scale * inverse DFT of natural-order float32 planes (..., N)."""
    if not yr.is_cuda:
        return ifft_pow2_plain(yr, yi, scale)
    return _launch(yr, yi, True, scale, yr.shape[-1], "ifft_pow2")


def rfft_pow2(xr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: one-sided DFT of a real float32 plane (..., N) -> (..., N/2 + 1) x 2."""
    if not xr.is_cuda:
        return rfft_pow2_plain(xr)
    return _launch(xr, None, False, 1.0, xr.shape[-1] // 2 + 1, "rfft_pow2")
