"""Bluestein chirp-z FFT for arbitrary lengths (reference fft/bluestein.go).

Port of godsp_tpu/fft/bluestein.py: an N-point DFT as a circular
convolution at the next power of 2 >= 2N-1, run through
pow2_circular_filter (on CUDA: forward kernel, product, inverse kernel).

  * chirp phases use mod-2N argument reduction in exact integer
    arithmetic (bluestein.go:53 squares in int and feeds sin an
    unreduced argument; float i^2 loses bits above n ~ 2^26);
  * FFT(b), which depends only on N, is built once in float64 and cached
    per (n, device, dtype).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from godsp_tpu_torch._dtypes import complex_for
from godsp_tpu_torch.dsputils.utils import next_power_of_2
from godsp_tpu_torch.fft.pow2 import pow2_circular_filter

__all__ = ["bluestein_fft"]


@lru_cache(maxsize=None)
def _chirp_tables_f64(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(w, fft_b): chirp w[i] = exp(+i*pi*i^2/n) and the FFT of the symmetric
    chirp filter b at la = next_pow2(2n-1) (bluestein.go:44-58, :78-87)."""
    la = next_power_of_2(2 * n - 1)
    i = np.arange(n, dtype=np.int64)
    isq_mod = ((i * i) % (2 * n)).astype(np.float64)  # i^2 < 2^63: exact
    ang = np.pi * isq_mod / n
    w = np.cos(ang) + 1j * np.sin(ang)
    b = np.zeros(la, dtype=np.complex128)
    b[0] = w[0]
    if n > 1:
        b[1:n] = w[1:n]
        b[la - n + 1:] = w[1:n][::-1]  # b[la-i] = w[i], i in [1, n)
    return w, np.fft.fft(b)


@lru_cache(maxsize=None)
def _chirp_tables(n: int, device: torch.device, dtype: torch.dtype):
    w, fft_b = _chirp_tables_f64(n)
    return (torch.from_numpy(w).to(device=device, dtype=dtype),
            torch.from_numpy(fft_b).to(device=device, dtype=dtype))


def bluestein_fft(x: torch.Tensor) -> torch.Tensor:
    """Arbitrary-length forward DFT of the trailing axis via chirp-z.

    x: (..., N) complex, batched over leading axes.  Unnormalized; the
    public ifft reaches it through index reversal (fft/fft.go:35-52).
    """
    n = x.shape[-1]
    x = x.to(complex_for(x.dtype))
    if n <= 1:
        return x
    la = next_power_of_2(2 * n - 1)
    w, fft_b = _chirp_tables(n, x.device, x.dtype)
    # Premultiply by the conjugate chirp and zero-pad (bluestein.go:70-76).
    a = torch.nn.functional.pad(x * w.conj(), (0, la - n))
    conv = pow2_circular_filter(a, fft_b, scale=1.0 / la)
    # Postmultiply and truncate (bluestein.go:89-93).
    return conv[..., :n] * w.conj()
