"""Savitzky-Golay smoothing/differentiation (scipy.signal semantics).

Port of godsp_tpu/models/savgol.py.  The FIR taps and the polynomial
edge-correction matrices are closed-form least-squares solutions computed
in float64 numpy on the host (savgol_coeffs and _edge_matrices are
copies), cast once to the signal's dtype on its device, so the device
work is one batched convolution (models.filter.fftconvolve: K1/K2 on the
card, the large plan past 16384 points) plus two small edge einsums, run
with TF32 off on the card.  Torch has no negative-step slicing: the
mirror mode's reversed edges are torch.flip of the tensor.
"""

from __future__ import annotations

from contextlib import nullcontext
from functools import lru_cache
from math import factorial

import numpy as np
import torch

from godsp_tpu_torch._dtypes import as_real_array
from godsp_tpu_torch.fft.four_step import _tf32_off

__all__ = ["savgol_coeffs", "savgol_filter"]


def savgol_coeffs(
    window_length: int,
    polyorder: int,
    deriv: int = 0,
    delta: float = 1.0,
    pos=None,
    use: str = "conv",
) -> np.ndarray:
    """FIR taps of a Savitzky-Golay filter (scipy.signal.savgol_coeffs):
    the least-squares degree-`polyorder` polynomial fit over
    `window_length` samples, evaluated (or differentiated `deriv` times)
    at `pos`.  Returns float64 numpy taps."""
    window_length = int(window_length)
    polyorder = int(polyorder)
    if polyorder >= window_length:
        raise ValueError("polyorder must be less than window_length")
    halflen, rem = divmod(window_length, 2)
    if pos is None:
        pos = halflen - 0.5 if rem == 0 else halflen
    if not 0 <= pos <= window_length - 1:
        raise ValueError("pos must be nonnegative and less than window_length")
    if use not in ("conv", "dot"):
        raise ValueError("use must be 'conv' or 'dot'")
    if deriv > polyorder:
        return np.zeros(window_length)
    x = np.arange(-pos, window_length - pos, dtype=np.float64)
    if use == "conv":
        x = x[::-1]
    order = np.arange(polyorder + 1).reshape(-1, 1)
    A = x**order  # (polyorder+1, window_length)
    y = np.zeros(polyorder + 1)
    y[deriv] = factorial(deriv) / (delta**deriv)
    coeffs, _, _, _ = np.linalg.lstsq(A, y, rcond=None)
    return coeffs


@lru_cache(maxsize=None)
def _edge_matrices(window_length: int, polyorder: int, deriv: int, delta: float):
    """Edge-correction operators for mode='interp': scipy fits one
    degree-`polyorder` polynomial to the first (last) `window_length`
    samples and replaces the first (last) halflen outputs with its
    derivative values, E = V_eval @ pinv(V_fit), a (halflen,
    window_length) float64 matrix per edge."""
    halflen = window_length // 2
    t = np.arange(window_length, dtype=np.float64)
    V_fit = np.vander(t, polyorder + 1, increasing=True)  # (W, p+1)
    pinv = np.linalg.pinv(V_fit)
    i = np.arange(polyorder + 1)
    dcoef = np.where(
        i >= deriv,
        np.array([factorial(ii) / factorial(ii - deriv) if ii >= deriv else 0.0 for ii in i]),
        0.0,
    ) / (delta**deriv)
    te = t[:halflen]
    pow_ = np.where((i - deriv) >= 0, i - deriv, 0)
    V_eval = (te[:, None] ** pow_[None, :]) * dcoef[None, :]  # (halflen, p+1)
    E_head = V_eval @ pinv
    tt = t[window_length - halflen :]
    V_eval_t = (tt[:, None] ** pow_[None, :]) * dcoef[None, :]
    return E_head, V_eval_t @ pinv


def savgol_filter(
    x,
    window_length: int,
    polyorder: int,
    deriv: int = 0,
    delta: float = 1.0,
    axis: int = -1,
    mode: str = "interp",
    cval: float = 0.0,
) -> torch.Tensor:
    """Apply a Savitzky-Golay filter along `axis`
    (scipy.signal.savgol_filter).  mode='interp' (default) fits edge
    polynomials exactly as scipy; 'mirror'/'nearest'/'constant'/'wrap'
    pad then convolve.  One batched device convolution either way."""
    from godsp_tpu_torch.models.filter import fftconvolve

    window_length = int(window_length)
    if window_length % 2 == 0 and mode == "interp":
        raise ValueError("window_length must be odd for mode='interp'")
    if mode not in ("interp", "mirror", "nearest", "constant", "wrap"):
        raise ValueError(
            "mode must be 'interp', 'mirror', 'nearest', 'constant', or 'wrap'"
        )
    taps = savgol_coeffs(window_length, polyorder, deriv=deriv, delta=delta)
    x = as_real_array(x).movedim(axis, -1)
    n = x.shape[-1]
    halflen = window_length // 2
    # float64 taps would promote a float32 card tensor out of the kernel route
    h = torch.as_tensor(taps, dtype=x.dtype, device=x.device)
    if mode == "interp":
        if window_length > n:
            raise ValueError(
                "If mode is 'interp', window_length must be less than or "
                "equal to the size of x"
            )
        y = fftconvolve(x, h, mode="same")
        E_head, E_tail = _edge_matrices(window_length, int(polyorder), int(deriv), float(delta))
        with _tf32_off() if x.is_cuda else nullcontext():
            eh, et = (torch.as_tensor(e, dtype=x.dtype, device=x.device) for e in (E_head, E_tail))
            head = torch.einsum("ij,...j->...i", eh, x[..., :window_length])
            tail = torch.einsum("ij,...j->...i", et, x[..., n - window_length :])
        y = torch.cat([head, y[..., halflen : n - halflen], tail], dim=-1)
        return y.movedim(-1, axis)
    pad = halflen
    if mode == "mirror":
        # numpy's x[..., pad:0:-1] and x[..., -2:-pad-2:-1]
        head = x[..., 1 : pad + 1].flip(-1)
        tail = x[..., max(n - pad - 1, 0) : max(n - 1, 0)].flip(-1)
    elif mode == "nearest":
        head = x[..., :1].expand(*x.shape[:-1], pad)
        tail = x[..., -1:].expand(*x.shape[:-1], pad)
    elif mode == "wrap":
        head = x[..., -pad:]
        tail = x[..., :pad]
    else:  # constant
        head = torch.full((*x.shape[:-1], pad), float(cval), dtype=x.dtype, device=x.device)
        tail = head
    ext = torch.cat([head, x, tail], dim=-1)
    full = fftconvolve(ext, h, mode="full")
    return full[..., 2 * pad : 2 * pad + n].movedim(-1, axis)
