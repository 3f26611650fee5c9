"""Outer DFT levels of the giant-N FFT plan for Hopper, with their plain version.

Counterpart of godsp_tpu/ops/pallas_outer.py.

  K8 outer_dft_split(xr, xi, d1, d2, inverse)
     replaces pallas_outer.py: outer_dft_split (_outer_kernel)

For a length-N transform viewed as (..., m, n3) float32 planes, m = d1*d2
rows and N = m*n3, the result's row k1*d2 + k2, column t holds

    W_N^{k t} * sum_i x[i, t] W_m^{k i},   k = k1 + d1*k2,

godsp_tpu's two dense outer levels and both twiddles (pallas_outer.py:6-9)
in its row order, so that the n3-point FFT of every row finishes the
transform (fft/large.py).  d2 = 1 is the single-level form.  The kernel
(csrc/outer_kernel.cu, whose header says what bounds it on the H100) runs
the m-point column DFT as one radix-2 FFT in shared memory, for any
pow-2 m = 2..2048 and any n3; the TPU's d <= 128 and n3 % 128 rules are
not ported.

The plain version is godsp_tpu's einsum form (fft/large.py:378-404): the
dense DFT over d1, the factored twiddle, the dense DFT over d2 and its
twiddle, in the input's dtype; the tables are built in float64 with the
exponents reduced in exact integer arithmetic.  It is the float64
oracle on the card (TF32 off around its matmuls).

A wrapper takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

from contextlib import nullcontext
from functools import lru_cache

import numpy as np
import torch

from godsp_tpu_torch.fft.four_step import _tf32_off, dft_matrix
from godsp_tpu_torch.ops import _build
from godsp_tpu_torch.ops.cuda_fft import twiddle_table

__all__ = [
    "MAX_ROWS",
    "launches",
    "outer_dft_split",
    "outer_dft_split_plain",
    "outer_supported",
]

MAX_ROWS = 2048  # m rows x 8 columns of float2 in shared memory: 128 KB a block

# Kernel launches by wrapper, counted where each launches its kernel.
launches = {"outer_dft_split": 0}


def outer_supported(d1: int, d2: int, n3: int) -> bool:
    """Row factors d1, d2 >= 1 with m = d1*d2 a power of 2 in 2..MAX_ROWS, any n3 >= 1."""
    m = d1 * d2
    return d1 >= 1 and d2 >= 1 and 2 <= m <= MAX_ROWS and m & (m - 1) == 0 and n3 >= 1


def _exp_table(n: int, kk: torch.Tensor, tt: torch.Tensor, inverse: bool) -> torch.Tensor:
    """complex128 exp(-+2 pi i (kk (x) tt mod n) / n), the exponent exact in int64."""
    p = torch.remainder(kk[:, None] * tt[None, :], n).to(torch.float64)
    ang = p * ((2.0 if inverse else -2.0) * np.pi / n)
    return torch.polar(torch.ones_like(ang), ang)


@lru_cache(maxsize=None)
def _factor_tables(n: int, inverse: bool, device: torch.device):
    """(hi, lo, lo_bits): W_n^p = hi[p >> lo_bits] * lo[p & (2^lo_bits - 1)],
    two (entries, 2) float32 tables built in float64 and rounded once."""
    lo_bits = ((n - 1).bit_length() + 1) // 2
    n_hi = (n + (1 << lo_bits) - 1) >> lo_bits
    sign = 2.0 if inverse else -2.0

    def table(p):
        ang = sign * np.pi * p / n
        return torch.from_numpy(np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32))

    hi = table(np.arange(n_hi, dtype=np.float64) * float(1 << lo_bits))
    lo = table(np.arange(1 << lo_bits, dtype=np.float64))
    return hi.to(device), lo.to(device), lo_bits


def _check(xr, xi, d1: int, d2: int) -> tuple[int, int]:
    if xr.shape != xi.shape:
        raise ValueError("re/im planes must have identical shapes")
    if xr.dim() < 2:
        raise ValueError("outer_dft_split takes (..., d1*d2, n3) planes")
    rows, n3 = xr.shape[-2], xr.shape[-1]
    if rows != d1 * d2:
        raise ValueError(f"row dim {rows} != d1*d2 = {d1 * d2}")
    if not outer_supported(d1, d2, n3):
        raise ValueError(f"unsupported outer plan ({d1}, {d2}, {n3}): "
                         f"d1*d2 must be a power of 2 in 2..{MAX_ROWS}")
    return rows, n3


# ---------------------------------------------------------------------------
# Plain version (any device, any float dtype: the float64 oracle on the card)
# ---------------------------------------------------------------------------


def outer_dft_split_plain(xr: torch.Tensor, xi: torch.Tensor, d1: int, d2: int,
                          inverse: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Both outer levels + twiddles as dense contractions (godsp_tpu's
    einsum form), same layout as outer_dft_split."""
    rows, n3 = _check(xr, xi, d1, d2)
    n = rows * n3
    dev = xr.device
    cdt = torch.complex128 if xr.dtype == torch.float64 else torch.complex64
    lead = xr.shape[:-2]
    x = torch.complex(xr, xi).to(cdt).reshape(-1, d1, d2, n3)

    def ar(v):
        return torch.arange(v, device=dev, dtype=torch.int64)

    f1, f2 = dft_matrix(d1), dft_matrix(d2)
    if inverse:
        f1, f2 = np.conj(f1), np.conj(f2)
    f1 = torch.from_numpy(f1).to(device=dev, dtype=cdt)
    f2 = torch.from_numpy(f2).to(device=dev, dtype=cdt)
    ta = _exp_table(n, ar(d1), ar(d2) * n3, inverse).to(cdt)  # (d1, d2): W_N^{k1 i2 n3}
    tb = _exp_table(n, ar(d1), ar(n3), inverse).to(cdt)  # (d1, n3): W_N^{k1 t}
    with _tf32_off() if x.is_cuda else nullcontext():
        a = torch.einsum("ki,bijn->bkjn", f1, x)  # level 1 over i1
        a = a * ta[:, :, None] * tb[:, None, :]
        if d2 > 1:
            tc = _exp_table(d2 * n3, ar(d2), ar(n3), inverse).to(cdt)  # W_{d2 n3}^{k2 t}
            a = torch.einsum("cj,bkjn->bkcn", f2, a) * tc  # level 2 over i2
    y = a.reshape(*lead, rows, n3)
    return y.real.contiguous(), y.imag.contiguous()


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def outer_dft_split(xr: torch.Tensor, xi: torch.Tensor, d1: int, d2: int,
                    inverse: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """K8: the outer levels of (..., d1*d2, n3) float32 planes in one
    device-memory pass; row k1*d2 + k2 of the result is ready for its
    n3-point row FFT.  inverse conjugates every table (no scale)."""
    rows, n3 = _check(xr, xi, d1, d2)
    if not xr.is_cuda:
        return outer_dft_split_plain(xr, xi, d1, d2, inverse)
    if xr.dtype != torch.float32 or xi.dtype != torch.float32:
        raise TypeError(f"outer_dft_split: the kernel takes float32 planes, got {xr.dtype}")
    if xi.device != xr.device:
        raise ValueError("outer_dft_split: re/im planes must be on one device")
    xr, xi = xr.contiguous(), xi.contiguous()
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    batch = xr.numel() // (rows * n3)
    if batch == 0:
        return yr, yi
    hi, lo, lo_bits = _factor_tables(rows * n3, inverse, xr.device)
    lib = _build.library()
    with torch.cuda.device(xr.device):
        rc = lib.gdsp_outer_dft(
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            twiddle_table(rows, inverse, xr.device).data_ptr(), hi.data_ptr(), lo.data_ptr(),
            rows.bit_length() - 1, d2, n3, batch, lo_bits,
            torch.cuda.current_stream(xr.device).cuda_stream,
        )
    _build.check(rc, "outer_dft_split")
    launches["outer_dft_split"] += 1
    return yr, yi
