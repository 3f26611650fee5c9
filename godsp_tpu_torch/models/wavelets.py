"""Continuous wavelet transform as one batched convolution bank.

Port of godsp_tpu/models/wavelets.py: scipy.signal's classic
cwt/ricker/morlet/morlet2 surface (removed from scipy in 1.15; the
semantics follow the classic definitions).  The wavelets are host
float64 numpy (copies).  cwt zero-pads all W wavelet kernels to the
widest length and convolves them with the signal in one batched FFT
chain (fft/pow2.py: K1/K2 on the card, the large plan with a leading
batch past 16384 points); each row's 'same' window is one torch.gather
on the full outputs (trailing zero taps shift nothing).
"""

from __future__ import annotations

import numpy as np
import torch

from godsp_tpu_torch._dtypes import as_complex_array, as_tensor
from godsp_tpu_torch.dsputils.utils import next_power_of_2
from godsp_tpu_torch.fft.pow2 import pow2_fft

__all__ = ["cwt", "morlet", "morlet2", "ricker"]


def ricker(points: int, a: float) -> np.ndarray:
    """Ricker (Mexican-hat) wavelet: the normalized negative second
    derivative of a Gaussian of width a (classic scipy.signal.ricker)."""
    points = int(points)
    A = 2.0 / (np.sqrt(3.0 * a) * np.pi**0.25)
    vec = np.arange(points, dtype=np.float64) - (points - 1.0) / 2.0
    xsq = (vec / a) ** 2
    return A * (1.0 - xsq) * np.exp(-xsq / 2.0)


def morlet(M: int, w: float = 5.0, s: float = 1.0,
           complete: bool = True) -> np.ndarray:
    """Classic Morlet wavelet on [-s*2pi, s*2pi] (scipy.signal.morlet):
    exp(1j w x) Gaussian, with the admissibility correction term when
    complete=True."""
    x = np.linspace(-s * 2 * np.pi, s * 2 * np.pi, int(M))
    out = np.exp(1j * w * x).astype(complex)
    if complete:
        out -= np.exp(-0.5 * w**2)
    out *= np.exp(-0.5 * x**2) * np.pi ** (-0.25)
    return out


def morlet2(M: int, s: float, w: float = 5.0) -> np.ndarray:
    """Morlet wavelet parameterized for cwt (scipy.signal.morlet2):
    unit-energy complex exponential under a Gaussian of width s."""
    x = (np.arange(int(M), dtype=np.float64) - (int(M) - 1.0) / 2.0) / s
    wave = np.exp(1j * w * x) * np.exp(-0.5 * x**2) * np.pi ** (-0.25)
    return np.sqrt(1.0 / s) * wave


def _cwt_bank(data_c: torch.Tensor, bank_c: torch.Tensor, starts: np.ndarray, n: int,
              real_out: bool) -> torch.Tensor:
    """Full convolution of data with every (zero-padded) kernel in one
    batched chain, then each row's 'same' window by one gather."""
    lmax = bank_c.shape[-1]
    nfft = next_power_of_2(n + lmax - 1)
    D = pow2_fft(torch.nn.functional.pad(data_c, (0, nfft - n)))
    B = pow2_fft(torch.nn.functional.pad(bank_c, (0, nfft - lmax)))
    full = pow2_fft(D[None, :] * B, inverse=True, scale=1.0 / nfft)
    idx = (torch.as_tensor(starts, device=full.device)[:, None]
           + torch.arange(n, device=full.device)[None, :])
    out = torch.gather(full, -1, idx)
    return out.real if real_out else out


def cwt(data, wavelet, widths, dtype=None, **kwargs) -> torch.Tensor:
    """Continuous wavelet transform (classic scipy.signal.cwt
    semantics): row i is the 'same'-mode convolution of data with
    conj(reversed wavelet(min(10*widths[i], len(data)), widths[i])).
    All rows run as one batched FFT convolution."""
    data = as_tensor(data)
    if data.dim() != 1:
        raise ValueError("data must be 1-D")
    n = data.shape[0]
    if n == 0:
        raise ValueError("empty data")
    widths = np.atleast_1d(np.asarray(widths, np.float64))
    if widths.ndim != 1 or widths.size == 0 or np.any(widths <= 0):
        raise ValueError("widths must be positive and 1-D")
    kernels = []
    for wdt in widths:
        length = max(int(min(10 * wdt, n)), 1)
        kernels.append(np.conj(np.asarray(wavelet(length, wdt, **kwargs))[::-1]))
    lens = np.array([len(k) for k in kernels])
    complex_bank = any(np.iscomplexobj(k) for k in kernels)
    bank = np.zeros((len(kernels), int(lens.max())),
                    np.complex128 if complex_bank else np.float64)
    for i, k in enumerate(kernels):
        bank[i, : len(k)] = k
    data_c = as_complex_array(data)
    bank_c = torch.as_tensor(bank, device=data_c.device).to(data_c.dtype)
    real_out = not data.dtype.is_complex and not complex_bank
    return _cwt_bank(data_c, bank_c, (lens - 1) // 2, n, real_out)
