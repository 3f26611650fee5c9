"""Chirp-z transform on an arbitrary spiral contour, and the zoom FFT.

Port of godsp_tpu/fft/_czt_impl.py (scipy.signal's czt/zoom_fft surface):
X[k] = sum_n x[n] a^{-n} w^{nk}, k in [0, m); the DFT when a = 1,
w = exp(-2 pi i / m); a zoomed band when w steps a sub-interval of the
unit circle; a spiral contour when |w| != 1.

The same shape as Bluestein (fft/bluestein.py): every chirp table is
built in float64 numpy once per geometry (and cast once per device and
dtype), and the one convolution runs through pow2_circular_filter
(fft/pow2.py): on the card K1, the product and K2 with the 1/L of the
inverse in its store, or the large plan (K8 and the rows) for pads of
2^15 and more.  The unit-circle default reduces k^2 mod 2m exactly, as
fft/bluestein.py does; explicit contours follow scipy's w**(k^2/2)
float64 semantics (their precision decays the same way, keeping parity).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from godsp_tpu_torch._dtypes import as_complex_array
from godsp_tpu_torch.dsputils.utils import next_power_of_2
from godsp_tpu_torch.fft.pow2 import pow2_circular_filter

__all__ = ["CZT", "ZoomFFT", "czt", "czt_points", "zoom_fft"]


def _chain_tables(n: int, m: int, wk2: np.ndarray, ak: np.ndarray):
    """The shifted-filter convolution form (scipy's _czt layout): the
    premultiplier a^-k w^(k^2/2) (length n), the spectrum of the filter
    1 / [w^((n-1)^2/2) .. w^(1/2), w^0 .. w^((m-1)^2/2)] placed so that
    the linear convolution's window sits at [n-1, n+m-1), the
    postmultiplier w^(k^2/2) (length m), and the pad.  The pad is at
    least 2, the kernels' smallest transform."""
    la = max(2, next_power_of_2(n + m - 1))
    b = np.zeros(la, np.complex128)
    filt = 1.0 / np.hstack((wk2[n - 1 : 0 : -1], wk2[:m]))
    b[: filt.shape[0]] = filt
    return ak * wk2[:n], wk2[:m], np.fft.fft(b), la


@lru_cache(maxsize=None)
def _czt_tables(n: int, m: int, w: Optional[complex], a: complex):
    k = np.arange(max(m, n), dtype=np.float64)
    if w is None:
        # FFT-like default: exact k^2 mod 2m reduction (bluestein.py).
        kexact = [(int(v) * int(v)) % (2 * m) for v in range(max(m, n))]
        wk2 = np.exp(-1j * np.pi * np.asarray(kexact, np.float64) / m)
    else:
        wk2 = np.asarray(w, np.complex128) ** (k**2 / 2.0)
    ak = np.asarray(a, np.complex128) ** -k[:n]
    return _chain_tables(n, m, wk2, ak)


@lru_cache(maxsize=None)
def _zoom_tables(n: int, m: int, f1: float, f2: float, fs: float, endpoint: bool):
    # scipy.signal.ZoomFFT: phases built from the frequency step directly
    # (not through a power of w), endpoint semantics included.
    k = np.arange(max(m, n), dtype=np.float64)
    scale = ((f2 - f1) * m) / (fs * (m - 1)) if endpoint else (f2 - f1) / fs
    wk2 = np.exp(-1j * np.pi * scale * k**2 / m)
    ak = np.exp(-2j * np.pi * f1 / fs * k[:n])
    return _chain_tables(n, m, wk2, ak)


@lru_cache(maxsize=None)
def _device_tables(kind: str, key: tuple, device: torch.device, dtype: torch.dtype):
    """(pre, post, filter spectrum, pad) of one geometry as `dtype` tensors
    on `device`, cast once."""
    pre, post, fb, la = (_czt_tables if kind == "czt" else _zoom_tables)(*key)
    on = tuple(torch.from_numpy(t).to(device=device, dtype=dtype) for t in (pre, post, fb))
    return (*on, la)


def _czt_apply(x: torch.Tensor, kind: str, key: tuple) -> torch.Tensor:
    n = x.shape[-1]
    pre, post, fb, la = _device_tables(kind, key, x.device, x.dtype)
    m = post.shape[0]
    u = torch.nn.functional.pad(x * pre, (0, la - n))
    conv = pow2_circular_filter(u, fb, scale=1.0 / la)
    # The circular result equals the linear convolution on the window
    # [n-1, n+m-1), since la >= n+m-1 pushes every aliased term below n-1.
    return conv[..., n - 1 : n + m - 1] * post


def _band(fn) -> tuple[float, float]:
    fn = np.atleast_1d(np.asarray(fn, np.float64))
    if fn.size == 2:
        return float(fn[0]), float(fn[1])
    if fn.size == 1:
        return 0.0, float(fn[0])
    raise ValueError("fn must be a scalar or a 2-element sequence")


def czt(x, m: Optional[int] = None, w: Optional[complex] = None,
        a: complex = 1 + 0j) -> torch.Tensor:
    """Chirp-z transform of the trailing axis (scipy.signal.czt).

    X[k] = sum_n x[n] a^{-n} w^{nk}, k in [0, m).  Defaults: m = N,
    w = exp(-2 pi i / m) (the DFT: czt(x) == fft(x) for a = 1), a = 1.
    Batched over leading axes.

    Numerical note (shared with scipy.signal.czt): contours far off the
    unit circle are ill-conditioned, since the chirp tables span
    |w|^(k^2/2); keep |log|w|| * max(n, m)^2 / 2 within float64 range.
    """
    x = as_complex_array(x)
    n = x.shape[-1]
    if n < 1:
        raise ValueError("czt requires at least one input point")
    m = n if m is None else m
    if m < 1:
        raise ValueError("m must be >= 1")
    wkey = None if w is None else complex(w)
    if wkey is not None and wkey == 0:
        raise ValueError("w must be nonzero")
    return _czt_apply(x, "czt", (n, m, wkey, complex(a)))


def zoom_fft(x, fn, m: Optional[int] = None, fs: float = 2.0,
             endpoint: bool = False) -> torch.Tensor:
    """Zoomed DFT over the band [f1, f2] (scipy.signal.zoom_fft).

    fn: [f1, f2], or a scalar for [0, fn].  Evaluates m points (default
    N) at linspace(f1, f2, m, endpoint=endpoint) in units of fs: a band
    of the spectrum without the full FFT.
    """
    x = as_complex_array(x)
    n = x.shape[-1]
    if n < 1:
        raise ValueError("zoom_fft requires at least one input point")
    f1, f2 = _band(fn)
    m = n if m is None else m
    if m < 1 or (endpoint and m < 2):
        raise ValueError("m must be >= 1 (>= 2 with endpoint=True)")
    return _czt_apply(x, "zoom", (n, m, f1, f2, float(fs), bool(endpoint)))


class CZT:
    """Callable chirp-z plan (scipy.signal.CZT surface): fixes (n, m, w, a),
    so the chirp and filter tables are built once and every call on a new
    signal is one chain."""

    def __init__(self, n: int, m: Optional[int] = None,
                 w: Optional[complex] = None, a: complex = 1 + 0j):
        n = int(n)
        if n < 1:
            raise ValueError("n must be >= 1")
        m = n if m is None else int(m)
        if m < 1:
            raise ValueError("m must be >= 1")
        wkey = None if w is None else complex(w)
        if wkey is not None and wkey == 0:
            raise ValueError("w must be nonzero")
        self.n, self.m = n, m
        self.w = wkey if wkey is not None else np.exp(-2j * np.pi / m)
        self.a = complex(a)
        self._chain = ("czt", (n, m, wkey, complex(a)))

    def __call__(self, x) -> torch.Tensor:
        x = as_complex_array(x)
        if x.shape[-1] != self.n:
            raise ValueError(f"signal length must be {self.n}")
        return _czt_apply(x, *self._chain)

    def points(self) -> np.ndarray:
        """The m contour points a * w^-k (scipy.signal.CZT.points)."""
        return self.a * self.w ** -np.arange(self.m)


class ZoomFFT(CZT):
    """Callable zoomed-DFT plan (scipy.signal.ZoomFFT surface): fixes (n,
    band, m, fs), so repeated band analyses reuse the tables."""

    def __init__(self, n: int, fn, m: Optional[int] = None, *,
                 fs: float = 2.0, endpoint: bool = False):
        n = int(n)
        if n < 1:
            raise ValueError("n must be >= 1")
        f1, f2 = _band(fn)
        m = n if m is None else int(m)
        if m < 1 or (endpoint and m < 2):
            raise ValueError("m must be >= 1 (>= 2 with endpoint=True)")
        self.n, self.m = n, m
        self.f1, self.f2, self.fs = f1, f2, float(fs)
        step = (f2 - f1) / ((m - 1) if endpoint else m)
        self.w = np.exp(-2j * np.pi * step / float(fs))
        self.a = np.exp(2j * np.pi * f1 / float(fs))
        self._chain = ("zoom", (n, m, f1, f2, float(fs), bool(endpoint)))


def czt_points(m: int, w: Optional[complex] = None, a: complex = 1 + 0j) -> np.ndarray:
    """The m chirp-z contour points a * w^-k (scipy.signal.czt_points; w
    defaults to the unit-circle DFT spacing exp(-2j pi / m))."""
    m = int(m)
    if m < 1:
        raise ValueError("m must be >= 1")
    w = np.exp(-2j * np.pi / m) if w is None else complex(w)
    return complex(a) * w ** -np.arange(m)
