"""Window tapers (reference window/window.go:25-152).

Port of godsp_tpu.window: the six symmetric L-point windows of the
reference (plus Blackman-Harris, Nuttall and Kaiser), with identical
endpoint conventions and the L == 1 -> [1] special case.  Tables are
built host-side in float64 (matching the Go math) once per (window, L)
and cached; window_table moves one to the device and dtype asked for.
The scipy catalogue and get_window live in window/extended.py, the
scipy.signal.windows namespace in window/windows.py.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable

import numpy as np
import torch

from godsp_tpu_torch._dtypes import resolve_device

__all__ = [
    "extended",
    "windows",
    "get_window",
    "rectangular",
    "hamming",
    "hann",
    "bartlett",
    "flat_top",
    "blackman",
    "blackman_harris",
    "nuttall",
    "kaiser",
    "window_table",
    "window_table_np",
    "WINDOWS",
]


@lru_cache(maxsize=None)
def _table(name: str, L: int) -> np.ndarray:
    """Float64 window table; exact formulas of window/window.go."""
    if L < 0:
        raise ValueError("window length must be >= 0")
    if L == 0:
        return np.zeros(0, dtype=np.float64)
    if L == 1 and name != "rectangular":
        return np.ones(1, dtype=np.float64)
    n = np.arange(L, dtype=np.float64)
    N = L - 1
    if name == "rectangular":  # window.go:32-40
        return np.ones(L, dtype=np.float64)
    if name == "hamming":  # window.go:44-59
        return 0.54 - 0.46 * np.cos(2.0 * np.pi / N * n)
    if name == "hann":  # window.go:62-77
        return 0.5 * (1.0 - np.cos(2.0 * np.pi / N * n))
    if name == "bartlett":  # window.go:80-99 (two-branch triangle)
        coef = 2.0 / N
        return np.where(n <= N // 2, coef * n, 2.0 - coef * n)
    if name == "flat_top":  # window.go:102-134 (MATLAB 5-term coefficients)
        a0, a1, a2, a3, a4 = (
            0.21557895,
            0.41663158,
            0.277263158,
            0.083578947,
            0.006947368,
        )
        f = n * (2.0 * np.pi / N)
        return a0 - a1 * np.cos(f) + a2 * np.cos(2 * f) - a3 * np.cos(3 * f) + a4 * np.cos(4 * f)
    if name == "blackman":  # window.go:136-152
        return 0.42 - 0.5 * np.cos(2.0 * np.pi * n / N) + 0.08 * np.cos(4.0 * np.pi * n / N)
    # Beyond-reference tapers (scipy-compatible symmetric forms).
    if name == "blackman_harris":
        a = (0.35875, 0.48829, 0.14128, 0.01168)
        f = n * (2.0 * np.pi / N)
        return a[0] - a[1] * np.cos(f) + a[2] * np.cos(2 * f) - a[3] * np.cos(3 * f)
    if name == "nuttall":
        a = (0.3635819, 0.4891775, 0.1365995, 0.0106411)
        f = n * (2.0 * np.pi / N)
        return a[0] - a[1] * np.cos(f) + a[2] * np.cos(2 * f) - a[3] * np.cos(3 * f)
    raise ValueError(f"unknown window: {name}")


@lru_cache(maxsize=None)
def _kaiser_table(beta: float, L: int) -> np.ndarray:
    """Symmetric Kaiser window, float64 (scipy.signal.windows.kaiser)."""
    if L == 0:
        return np.zeros(0, dtype=np.float64)
    if L == 1:
        return np.ones(1, dtype=np.float64)
    n = np.arange(L, dtype=np.float64)
    N = L - 1
    return np.i0(beta * np.sqrt(1.0 - ((2.0 * n - N) / N) ** 2)) / np.i0(beta)


def _make(name: str) -> Callable[[int], torch.Tensor]:
    def w(L: int) -> torch.Tensor:
        return torch.from_numpy(_table(name, L).copy()).to(resolve_device())

    w.__name__ = name
    w.__qualname__ = name
    w.__doc__ = (f"L-point symmetric {name} window (window/window.go), float64 on "
                 "default_device().")
    return w


rectangular = _make("rectangular")
hamming = _make("hamming")
hann = _make("hann")
bartlett = _make("bartlett")
flat_top = _make("flat_top")
blackman = _make("blackman")
blackman_harris = _make("blackman_harris")
nuttall = _make("nuttall")


def kaiser(beta: float) -> Callable[[int], torch.Tensor]:
    """Kaiser window factory: kaiser(beta) is an L -> table callable
    usable anywhere a window is accepted (beyond-reference, scipy form).
    """

    def w(L: int) -> torch.Tensor:
        return torch.from_numpy(_kaiser_table(float(beta), L).copy()).to(resolve_device())

    w.__name__ = f"kaiser_{beta}"
    w.__doc__ = f"L-point symmetric Kaiser window, beta={beta}."
    return w


WINDOWS = {
    "rectangular": rectangular,
    "hamming": hamming,
    "hann": hann,
    "bartlett": bartlett,
    "flat_top": flat_top,
    "blackman": blackman,
    "blackman_harris": blackman_harris,
    "nuttall": nuttall,
}


def window_table_np(window, L: int) -> np.ndarray:
    """Resolve a window (name or callable) to a float64 numpy table."""
    if isinstance(window, str):
        return _table(window, L)
    name = getattr(window, "__name__", None)
    if name in WINDOWS:
        return _table(name, L)
    t = window(L)
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float64)


def window_table(window, L: int, device=None, dtype=torch.float64) -> torch.Tensor:
    """Resolve a window (name or callable) to an L-point tensor on `device`
    (default: default_device())."""
    return torch.from_numpy(window_table_np(window, L).copy()).to(device=resolve_device(device),
                                                                   dtype=dtype)


# Extended scipy-compatible window family (full catalogue + dispatcher).
from godsp_tpu_torch.window import extended  # noqa: E402
from godsp_tpu_torch.window.extended import get_window  # noqa: E402
from godsp_tpu_torch.window import windows  # noqa: E402  (scipy-style namespace)

