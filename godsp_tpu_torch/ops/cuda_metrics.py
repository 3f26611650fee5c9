"""The measurement path's reference kernels for Hopper, with their plain versions.

Counterpart of godsp_tpu/utils/metrics.py's two Pallas kernels.

  K12 copy_split(xr, xi)   replaces metrics.py: copy_split_pallas
  K13 gmm_floor(xr, xi)    replaces metrics.py: gmm_floor_pallas

Both take two float32 planes (b, n).  K12 copies them: the same
device-memory traffic as K1 with no compute, so its time is the
session's copy ceiling.  K13 computes, for every row and every 128-point
lane slice k1 of n = n1 x 128,

    y[:, 128 k1 : 128 (k1 + 1)] = FFT_128(x[:, 128 k1 + i2] exp(-2 pi i k1 i2 / n)) / 128,

the twiddled 128-point DFT of each slice (steps 2-3 of a four-step
n1 x 128 FFT) as a dense contraction with G[k1][i2, k2] =
exp(-2 pi i k1 i2 / n) exp(-2 pi i i2 k2 / 128) / 128.  On the TPU it is
K1's contraction stream without its butterflies; on the H100, whose K1 is
register-radix Stockham passes (csrc/fft_regs.cuh), its time says what
the TPU's dense-DFT design of one K1 step costs on this card
(csrc/metrics_kernels.cu, whose header says what bounds each kernel).

The G tables are built in float64 on the host as godsp_tpu builds them
(ops/pallas_fft.py: _ls_tables: the twiddle times the scaled DFT matrix;
the third plane Re G + Im G for the Karatsuba form), rounded once to
float32, and cached per n on each device.  The plain versions are
`xr.clone(), xi.clone()` and (x.view(b, n1, 128) * T) @ F128 / 128 in the
input's dtype (TF32 off on the card): the float64 oracle.

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

from contextlib import nullcontext
from functools import lru_cache

import numpy as np
import torch

from godsp_tpu_torch.fft.four_step import _tf32_off, dft_matrix, twiddle_2d
from godsp_tpu_torch.ops import _build

__all__ = [
    "LANES",
    "copy_split",
    "copy_split_plain",
    "gmm_floor",
    "gmm_floor_plain",
    "gmm_groups",
    "gmm_tables",
    "launches",
]

LANES = 128  # points of one slice: the TPU's lane width, G's side
_SMS = 132  # H100 SXM streaming multiprocessors: K13 runs one block on each

# Kernel launches by wrapper, counted where each launches its kernel.
launches = {"copy_split": 0, "gmm_floor": 0}


def _check(xr: torch.Tensor, xi: torch.Tensor, name: str) -> tuple[int, int]:
    if xr.shape != xi.shape or xr.dim() != 2:
        raise ValueError(f"{name}: two (b, n) planes of one shape, got {tuple(xr.shape)} "
                         f"and {tuple(xi.shape)}")
    return xr.shape[0], xr.shape[1]


def _check_gmm(xr: torch.Tensor, xi: torch.Tensor) -> tuple[int, int]:
    b, n = _check(xr, xi, "gmm_floor")
    if n < LANES or n % LANES:
        raise ValueError(f"gmm_floor: n must be a multiple of {LANES}, got {n}")
    return b, n


def _cuda_planes(xr: torch.Tensor, xi: torch.Tensor, name: str):
    """Contiguous, 16-byte-aligned float32 CUDA planes on one device, or raise."""
    if xr.dtype != torch.float32 or xi.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32 planes, got {xr.dtype}, {xi.dtype}")
    if not xi.is_cuda or xi.device != xr.device:
        raise ValueError(f"{name}: both planes must be on one CUDA device")
    planes = []
    for t in (xr, xi):
        t = t.contiguous()
        planes.append(t if t.data_ptr() % 16 == 0 else t.clone())
    return planes


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _g_host(n: int) -> np.ndarray:
    """(n1, 3, 128, 128) float32: Re G, Im G, Re G + Im G of every slice,
    built in float64 as godsp_tpu's _ls_tables(n, False, False, 1/128) and
    rounded once."""
    g = twiddle_2d(n // LANES, LANES)[:, :, None] * (dft_matrix(LANES) * (1.0 / LANES))[None]
    return np.ascontiguousarray(np.stack([g.real, g.imag, g.real + g.imag], axis=1),
                                dtype=np.float32)


@lru_cache(maxsize=None)
def gmm_tables(n: int, device: torch.device) -> torch.Tensor:
    """K13's G tables for n points on `device` (n * 1.5 KB of float32)."""
    return torch.from_numpy(_g_host(n)).to(device)


@lru_cache(maxsize=None)
def _plain_tables(n: int, device: torch.device, dtype: torch.dtype):
    """(T (n1, 128), F128 (128, 128)) in `dtype` on `device`, float64-built."""
    t = torch.from_numpy(twiddle_2d(n // LANES, LANES)).to(device=device, dtype=dtype)
    return t, torch.from_numpy(dft_matrix(LANES)).to(device=device, dtype=dtype)


def gmm_groups(b: int, n: int) -> int:
    """Row groups a slice is split into: about two blocks for each SM over
    the whole grid, never more groups than 32-row tiles."""
    return max(1, min(-(-b // 32), -(-2 * _SMS // (n // LANES)), 65535))


# ---------------------------------------------------------------------------
# Plain versions (any device, any float dtype: the float64 oracle on the card)
# ---------------------------------------------------------------------------


def copy_split_plain(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of K12."""
    _check(xr, xi, "copy_split")
    return xr.clone(), xi.clone()


def gmm_floor_plain(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of K13: (x.view(b, n1, 128) * T) @ F128 / 128 in
    the input's dtype (complex128 for float64 planes)."""
    b, n = _check_gmm(xr, xi)
    cdt = torch.complex128 if xr.dtype == torch.float64 else torch.complex64
    t, f = _plain_tables(n, xr.device, cdt)
    z = torch.complex(xr, xi).to(cdt).reshape(b, n // LANES, LANES)
    with _tf32_off() if z.is_cuda else nullcontext():
        y = (torch.matmul(z * t, f) / LANES).reshape(b, n)
    return y.real.contiguous(), y.imag.contiguous()


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def copy_split(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K12: (yr, yi) = (xr, xi), two float32 planes (b, n) read and written."""
    _check(xr, xi, "copy_split")
    if not xr.is_cuda:
        return copy_split_plain(xr, xi)
    xr, xi = _cuda_planes(xr, xi, "copy_split")
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    n = xr.numel()
    if n == 0:
        return yr, yi
    with torch.cuda.device(xr.device):
        rc = _build.library().gdsp_copy_split(
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(), n,
            torch.cuda.current_stream(xr.device).cuda_stream,
        )
    _build.check(rc, "copy_split")
    launches["copy_split"] += 1
    return yr, yi


def gmm_floor(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K13: the twiddled 128-point DFT of every lane slice of two float32
    planes (b, n), n a multiple of 128 (see the module docstring)."""
    b, n = _check_gmm(xr, xi)
    if not xr.is_cuda:
        return gmm_floor_plain(xr, xi)
    xr, xi = _cuda_planes(xr, xi, "gmm_floor")
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    if b == 0:
        return yr, yi
    g = gmm_tables(n, xr.device)
    with torch.cuda.device(xr.device):
        rc = _build.library().gdsp_gmm_floor(
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(), g.data_ptr(), b, n,
            gmm_groups(b, n), torch.cuda.current_stream(xr.device).cuda_stream,
        )
    _build.check(rc, "gmm_floor")
    launches["gmm_floor"] += 1
    return yr, yi
