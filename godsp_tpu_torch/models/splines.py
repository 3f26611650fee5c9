"""B-spline filtering and evaluation (scipy.signal spline surface).

Port of godsp_tpu/models/splines.py.  Under scipy's mirror-symmetric
(half-sample) boundary, convolution by the symmetric B-spline kernel is
diagonal in the DCT-II basis, so the spline-coefficient "inverse filter"
is one forward DCT, a pointwise divide and one inverse DCT through the
port's fft/_dct_impl.py (K1/K2 on the card for power-of-2 lengths,
Bluestein over them for the rest), instead of scipy's truncated-precision
forward/backward recursions:

- interior values match scipy's cspline1d/qspline1d to float64 round-off;
- at a few boundary samples of the smoothing path (lamb > 0) scipy's
  truncated initial conditions differ from the exact mirror solution by
  up to ~1e-3: this module returns the exact solution;
- cspline2d/qspline2d are two separable DCT passes (the second over a
  transposed contiguous copy); scipy's own 2-D C path truncates at
  `precision`, this one is exact.

The evaluators reproduce scipy's cspline1d_eval/qspline1d_eval
conventions (reflection of out-of-range points, clipped tap indices);
spline_filter runs the B3 reconstruction through models.conv2d.sepfir2d.
"""

from __future__ import annotations

import numpy as np
import torch

from godsp_tpu_torch._dtypes import as_real_array, as_tensor
from godsp_tpu_torch.fft._dct_impl import dct, idct

__all__ = [
    "cspline1d",
    "cspline1d_eval",
    "cspline2d",
    "gauss_spline",
    "qspline1d",
    "qspline1d_eval",
    "qspline2d",
    "spline_filter",
    "symiirorder1",
    "symiirorder2",
]


def gauss_spline(x, n: int) -> torch.Tensor:
    """Gaussian approximation of the order-n B-spline
    (scipy.signal.gauss_spline): variance (n+1)/12."""
    x = as_tensor(x)
    if not (x.dtype.is_floating_point or x.dtype.is_complex):
        x = as_real_array(x)
    sig2 = (n + 1) / 12.0
    return torch.exp(-x * x / (2.0 * sig2)) / float(np.sqrt(2.0 * np.pi * sig2))


def _spline_denominator(n: int, kernel_dc: float, kernel_ac: float, lamb: float) -> np.ndarray:
    """Eigenvalues of (B + lamb*D4) under the half-sample-symmetric
    extension, on the DCT-II frequency grid w_k = pi k / n (float64)."""
    w = np.pi * np.arange(n, dtype=np.float64) / n
    den = kernel_dc + kernel_ac * np.cos(w)
    if lamb != 0.0:
        den = den + lamb * (2.0 * np.cos(w) - 2.0) ** 2
    return den


def _spline_filter(x: torch.Tensor, dc: float, ac: float, lamb: float) -> torch.Tensor:
    den = _spline_denominator(x.shape[-1], dc, ac, lamb)
    return idct(dct(x) / torch.as_tensor(den, dtype=x.dtype, device=x.device))


def _spline_filter2d(x: torch.Tensor, dc: float, ac: float, lamb: float) -> torch.Tensor:
    c = _spline_filter(x, dc, ac, lamb)
    c = _spline_filter(c.transpose(-1, -2).contiguous(), dc, ac, lamb)
    return c.transpose(-1, -2)


def cspline1d(signal, lamb: float = 0.0) -> torch.Tensor:
    """Cubic-spline coefficients of the trailing axis with
    mirror-symmetric boundary (scipy.signal.cspline1d semantics; the
    lamb > 0 smoothing-spline case solves (B3 + lamb D4) c = x exactly).
    One DCT round trip; leading axes batch."""
    x = as_real_array(signal)
    if x.shape[-1] <= 1:
        return x
    return _spline_filter(x, 4.0 / 6.0, 2.0 / 6.0, float(lamb))


def qspline1d(signal, lamb: float = 0.0) -> torch.Tensor:
    """Quadratic-spline coefficients (scipy.signal.qspline1d; smoothing
    is unsupported there too)."""
    if lamb != 0.0:
        raise ValueError("smoothing quadratic splines are not supported "
                         "(scipy.signal.qspline1d raises likewise)")
    x = as_real_array(signal)
    if x.shape[-1] <= 1:
        return x
    return _spline_filter(x, 6.0 / 8.0, 2.0 / 8.0, 0.0)


def cspline2d(signal, lamb: float = 0.0, precision: float = -1.0) -> torch.Tensor:
    """2-D cubic-spline coefficients: the separable per-axis filter
    (scipy.signal.cspline2d; `precision` accepted for API parity: the
    DCT route is exact, there is nothing to truncate)."""
    x = as_real_array(signal)
    if x.dim() < 2:
        raise ValueError("cspline2d needs a 2-D input")
    if min(x.shape[-2:]) <= 1:
        c = cspline1d(x, lamb)
        return cspline1d(c.transpose(-1, -2), lamb).transpose(-1, -2)
    return _spline_filter2d(x, 4.0 / 6.0, 2.0 / 6.0, float(lamb))


def qspline2d(signal, lamb: float = 0.0, precision: float = -1.0) -> torch.Tensor:
    """2-D quadratic-spline coefficients (scipy.signal.qspline2d)."""
    x = as_real_array(signal)
    if x.dim() < 2:
        raise ValueError("qspline2d needs a 2-D input")
    if min(x.shape[-2:]) <= 1:
        c = qspline1d(x, lamb)
        return qspline1d(c.transpose(-1, -2), lamb).transpose(-1, -2)
    return _spline_filter2d(x, 6.0 / 8.0, 2.0 / 8.0, 0.0)


def spline_filter(Iin, lmbda: float = 5.0) -> torch.Tensor:
    """Cubic smoothing-spline filter of a 2-D array
    (scipy.signal.spline_filter): coefficients via cspline2d, then the
    B3 reconstruction kernel [1,4,1]/6 along both axes (sepfir2d)."""
    from godsp_tpu_torch.models.conv2d import sepfir2d

    ck = cspline2d(Iin, lmbda)
    h = torch.as_tensor(np.array([1.0, 4.0, 1.0]) / 6.0, dtype=ck.dtype, device=ck.device)
    return sepfir2d(ck, h, h)


def _bspline3(t: torch.Tensor) -> torch.Tensor:
    a = t.abs()
    return torch.where(a < 1.0, 2.0 / 3.0 - a * a + a**3 / 2.0,
                       torch.where(a < 2.0, (2.0 - a) ** 3 / 6.0, torch.zeros_like(a)))


def _bspline2(t: torch.Tensor) -> torch.Tensor:
    a = t.abs()
    return torch.where(a < 0.5, 0.75 - a * a,
                       torch.where(a < 1.5, (a - 1.5) ** 2 / 2.0, torch.zeros_like(a)))


def _spline_eval(cj: torch.Tensor, t: torch.Tensor, order: int) -> torch.Tensor:
    n = cj.shape[0]
    # reflect out-of-range points: |t|, then fold into [0, N-1]
    period = 2.0 * (n - 1)
    t = torch.remainder(t.abs(), period)
    t = torch.minimum(t, period - t)
    if order == 3:
        jlo = torch.floor(t - 2.0).long() + 1
        taps, basis = 4, _bspline3
    else:
        jlo = torch.floor(t - 1.5).long() + 1
        taps, basis = 3, _bspline2
    res = torch.zeros_like(t)
    for i in range(taps):
        j = jlo + i
        res = res + cj[j.clamp(0, n - 1)] * basis(t - j.to(t.dtype))  # scipy's clipped taps
    return res


def _eval_points(cj, newx, dx: float, x0: float):
    cj = as_tensor(cj)
    if cj.dim() != 1:
        raise ValueError("cj must be 1-D")
    t = (as_tensor(newx, device=cj.device).to(cj.dtype) - x0) / float(dx)
    return cj, t


def cspline1d_eval(cj, newx, dx: float = 1.0, x0: float = 0.0) -> torch.Tensor:
    """Evaluate the cubic spline with coefficients cj at points newx
    (scipy.signal.cspline1d_eval: mirror-symmetric reflection outside
    [x0, x0 + dx*(N-1)], clipped edge taps)."""
    return _spline_eval(*_eval_points(cj, newx, dx, x0), 3)


def qspline1d_eval(cj, newx, dx: float = 1.0, x0: float = 0.0) -> torch.Tensor:
    """Evaluate the quadratic spline (scipy.signal.qspline1d_eval)."""
    return _spline_eval(*_eval_points(cj, newx, dx, x0), 2)


def symiirorder1(signal, c0: float, z1: float, precision: float = -1.0) -> torch.Tensor:
    """Symmetric cascade of first-order sections
    c0 / ((1 - z1 z^-1)(1 - z1 z)) with mirror-symmetric boundary
    (scipy.signal.symiirorder1).  Diagonal in the DCT-II basis:
    eigenvalue c0 / (1 - 2 z1 cos w + z1^2), exact where scipy's
    recursion truncates its initial sums at `precision` (accepted for
    API parity)."""
    if abs(z1) >= 1.0:
        raise ValueError("|z1| must be < 1 for a stable filter")
    x = as_real_array(signal)
    n = x.shape[-1]
    if n <= 1:
        return x * (c0 / (1.0 - z1) ** 2 if n else 1.0)
    w = np.pi * np.arange(n, dtype=np.float64) / n
    gain = c0 / (1.0 - 2.0 * z1 * np.cos(w) + z1 * z1)
    return idct(dct(x) * torch.as_tensor(gain, dtype=x.dtype, device=x.device))


def symiirorder2(input, r: float, omega: float, precision: float = -1.0) -> torch.Tensor:
    """Symmetric cascade of second-order sections
    cs^2 / ((1 - 2 r cos(omega) z^-1 + r^2 z^-2)(... z form)) with
    cs = 1 - 2 r cos(omega) + r^2 and mirror-symmetric boundary
    (scipy.signal.symiirorder2): one DCT-II round trip with eigenvalue
    cs^2 / |1 - 2 r cos(omega) e^{-iw} + r^2 e^{-2iw}|^2, so it never
    meets scipy's 'boundary sum did not converge' failure."""
    if not 0.0 < r < 1.0:
        raise ValueError("r must lie in (0, 1)")
    x = as_real_array(input)
    n = x.shape[-1]
    cs = 1.0 - 2.0 * r * np.cos(omega) + r * r
    if n <= 1:
        return x * (cs * cs / ((1.0 - 2.0 * r * np.cos(omega) + r * r) ** 2) if n else 1.0)
    w = np.pi * np.arange(n, dtype=np.float64) / n
    e = np.exp(-1j * w)
    den = np.abs(1.0 - 2.0 * r * np.cos(omega) * e + (r * r) * e * e) ** 2
    return idct(dct(x) * torch.as_tensor(cs * cs / den, dtype=x.dtype, device=x.device))
