"""scipy.signal.windows-compatible namespace: every catalogue window as
a (M, sym) function.

Port of godsp_tpu/window/windows.py.  The reference-parity tables
(godsp_tpu_torch.window) and the extended catalogue (window.extended)
provide the math; this module adds the scipy calling conventions (sym
keyword, periodic truncation) and the three remaining generators
(general_cosine, general_hamming, kaiser_bessel_derived).  Exposed as
`godsp_tpu_torch.window.windows`.
"""

from __future__ import annotations

import numpy as np

from godsp_tpu_torch.window import _kaiser_table, window_table_np
from godsp_tpu_torch.window.extended import (  # noqa: F401 - re-exports
    barthann,
    bohman,
    chebwin,
    cosine,
    dpss,
    exponential,
    gaussian,
    general_gaussian,
    get_window,
    lanczos,
    parzen,
    taylor,
    triang,
    tukey,
)
from godsp_tpu_torch.window.extended import _sym_window

__all__ = [
    "barthann", "bartlett", "blackman", "blackmanharris", "bohman",
    "boxcar", "chebwin", "cosine", "dpss", "exponential", "flattop",
    "gaussian", "general_cosine", "general_gaussian", "general_hamming",
    "get_window", "hamming", "hann", "kaiser", "kaiser_bessel_derived",
    "lanczos", "nuttall", "parzen", "taylor", "triang", "tukey",
]


def _core(name: str, M: int, sym: bool) -> np.ndarray:
    return _sym_window(M, sym, lambda L: window_table_np(name, L))


def boxcar(M: int, sym: bool = True) -> np.ndarray:
    """All-ones window (scipy.signal.windows.boxcar)."""
    if int(M) != M or M < 0:
        raise ValueError("window length must be a non-negative integer")
    return np.ones(int(M))


def bartlett(M: int, sym: bool = True) -> np.ndarray:
    """Triangular window with zero endpoints."""
    return _core("bartlett", M, sym)


def blackman(M: int, sym: bool = True) -> np.ndarray:
    """Blackman window."""
    return _core("blackman", M, sym)


def blackmanharris(M: int, sym: bool = True) -> np.ndarray:
    """Minimum 4-term Blackman-Harris window."""
    return _core("blackman_harris", M, sym)


def flattop(M: int, sym: bool = True) -> np.ndarray:
    """Flat-top window (amplitude-accurate peaks)."""
    return _core("flat_top", M, sym)


def hamming(M: int, sym: bool = True) -> np.ndarray:
    """Hamming window."""
    return _core("hamming", M, sym)


def hann(M: int, sym: bool = True) -> np.ndarray:
    """Hann window."""
    return _core("hann", M, sym)


def nuttall(M: int, sym: bool = True) -> np.ndarray:
    """Nuttall 4-term minimum-sidelobe window."""
    return _core("nuttall", M, sym)


def kaiser(M: int, beta: float, sym: bool = True) -> np.ndarray:
    """Kaiser window with shape parameter beta."""
    return _sym_window(M, sym, lambda L: _kaiser_table(float(beta), L))


def general_cosine(M: int, a, sym: bool = True) -> np.ndarray:
    """Generic weighted-cosine-series window
    sum_k (-1)^k a[k] cos(2 pi k n / (M-1))
    (scipy.signal.windows.general_cosine)."""
    a = np.asarray(a, np.float64)

    def build(L):
        fac = np.linspace(-np.pi, np.pi, L)
        w = np.zeros(L)
        for k, coef in enumerate(a):
            w += coef * np.cos(k * fac)
        return w

    return _sym_window(M, sym, build)


def general_hamming(M: int, alpha: float, sym: bool = True) -> np.ndarray:
    """Generalized Hamming: alpha - (1-alpha) cos term
    (scipy.signal.windows.general_hamming)."""
    return general_cosine(M, [float(alpha), 1.0 - float(alpha)], sym)


def kaiser_bessel_derived(M: int, beta: float, sym: bool = True) -> np.ndarray:
    """Kaiser-Bessel derived (KBD) window: the MDCT taper whose squared
    halves are normalized cumulative sums of a length-(M/2+1) Kaiser
    window (scipy.signal.windows.kaiser_bessel_derived; even symmetric
    lengths only)."""
    if not sym:
        raise ValueError("kaiser_bessel_derived is defined for sym=True only")
    M = int(M)
    if M < 1:
        return np.ones(max(M, 0))
    if M % 2:
        raise ValueError("kaiser_bessel_derived needs an even length")
    kw = _kaiser_table(float(beta), M // 2 + 1)
    csum = np.cumsum(kw)
    half = np.sqrt(csum[:-1] / csum[-1])
    return np.concatenate([half, half[::-1]])
