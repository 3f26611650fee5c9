"""Fast Hankel transform on a logarithmic grid (FFTLog; Hamilton 2000).

Port of godsp_tpu/fft/fftlog.py (scipy.fft.fht/ifht/fhtoffset
semantics): the order-mu Hankel transform of a log-periodically sampled
function, computed as one real FFT, a pointwise multiply by the analytic
U_mu coefficients and an inverse real FFT over the port's rfft/irfft
(fft/helpers.py: K3 and the complex plan on the card).  The coefficient
table (complex log-gamma by the Lanczos approximation, no scipy) is host
float64, cast once to the input's complex dtype.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from godsp_tpu_torch._dtypes import as_real_array, complex_for
from godsp_tpu_torch.fft.helpers import irfft, rfft

__all__ = ["fht", "fhtoffset", "ifht"]

_LANCZOS_G = 7.0
_LANCZOS = np.array([
    0.99999999999980993, 676.5203681218851, -1259.1392167224028,
    771.32342877765313, -176.61502916214059, 12.507343278686905,
    -0.13857109526572012, 9.9843695780195716e-6, 1.5056327351493116e-7,
])


def _loggamma(z):
    """Complex log-gamma (Lanczos g = 7; reflection for Re z < 1/2), about
    1e-13 absolute on the FFTLog argument range."""
    z = np.asarray(z, complex)
    reflect = z.real < 0.5
    zr = np.where(reflect, 1.0 - z, z)
    # No [None, :] on the coefficient axis: a scalar z stays 0-d.
    x = _LANCZOS[0] + np.sum(
        _LANCZOS[1:] / (zr[..., None] + np.arange(len(_LANCZOS) - 1)), axis=-1)
    t = zr + _LANCZOS_G - 0.5
    lg = 0.5 * np.log(2 * np.pi) + (zr - 0.5) * np.log(t) - t + np.log(x)
    with np.errstate(all="ignore"):
        refl = np.log(np.pi / np.sin(np.pi * z)) - lg
    return np.where(reflect, refl, lg)


def _gamma_ratio(xp_: float, xm: float) -> float:
    """Gamma(xp)/Gamma(xm) with the negative-integer pole limits: 0 when
    only Gamma(xm) has a pole, inf when only Gamma(xp) does, and the
    residue ratio when both do."""
    def is_pole(v):
        return v <= 0 and v == int(v)

    if is_pole(xp_) and is_pole(xm):
        # lim Gamma(xp+e)/Gamma(xm+e) = (-1)^(xm-xp) Gamma(1-xm)/Gamma(1-xp)
        sign = -1.0 if (int(xm - xp_) % 2) else 1.0
        return sign * float(np.exp(_loggamma(1.0 - xm) - _loggamma(1.0 - xp_)).real)
    if is_pole(xm):
        return 0.0
    if is_pole(xp_):
        return np.inf
    return float(np.exp(_loggamma(xp_) - _loggamma(xm)).real)


def _fhtcoeff(n: int, dln: float, mu: float, offset: float, bias: float,
              inverse: bool) -> np.ndarray:
    """u_m = (kr)^{-2 pi i m/(n dln)} U_mu(q + 2 pi i m/(n dln)),
    U_mu(x) = 2^x Gamma((mu+1+x)/2) / Gamma((mu+1-x)/2)."""
    lnkr, q = float(offset), float(bias)
    xp_ = (mu + 1 + q) / 2
    xm = (mu + 1 - q) / 2
    y = np.pi * np.arange(n // 2 + 1) / (n * dln)
    lg = (_loggamma(xp_ + 1j * y) - np.conj(_loggamma(xm + 1j * y))
          + np.log(2.0) * q + 2j * y * (np.log(2.0) - lnkr))
    u = np.exp(lg)
    if n % 2 == 0:
        u.imag[-1] = 0.0  # the Nyquist coefficient is real
    if not np.isfinite(u[0]):
        u[0] = 2.0**q * _gamma_ratio(xp_, xm)
    if np.isinf(u[0]) and not inverse:
        warnings.warn("singular transform; consider changing the bias", stacklevel=3)
        u = u.copy()
        u[0] = 0.0
    elif u[0] == 0 and inverse:
        warnings.warn("singular inverse transform; consider changing the bias", stacklevel=3)
        u = u.copy()
        u[0] = np.inf
    return u


def _bias_factors(n: int, dln: float, bias: float, offset: float):
    j = np.arange(n, dtype=np.float64)
    j_c = (n - 1) / 2.0
    return np.exp(-bias * (j - j_c) * dln), np.exp(-bias * ((j - j_c) * dln + offset))


def _on(t: np.ndarray, like: torch.Tensor, complex_: bool = False) -> torch.Tensor:
    dtype = complex_for(like.dtype) if complex_ else like.dtype
    return torch.from_numpy(t).to(device=like.device, dtype=dtype)


def fht(a, dln: float, mu: float, offset: float = 0.0, bias: float = 0.0) -> torch.Tensor:
    """Fast Hankel transform of order mu over a log-spaced grid with
    spacing dln (scipy.fft.fht).  offset = ln(k_c r_c); bias = the
    power-law bias q of the FFTLog variant."""
    a = as_real_array(a)
    n = a.shape[-1]
    u = _fhtcoeff(n, float(dln), float(mu), offset, bias, inverse=False)
    if bias != 0:
        pre, post = _bias_factors(n, float(dln), float(bias), float(offset))
        a = a * _on(pre, a)
    A = irfft(rfft(a) * _on(u, a, True), n).flip(-1)
    if bias != 0:
        A = A * _on(post, A)
    return A


def ifht(A, dln: float, mu: float, offset: float = 0.0, bias: float = 0.0) -> torch.Tensor:
    """Inverse fast Hankel transform (scipy.fft.ifht)."""
    A = as_real_array(A)
    n = A.shape[-1]
    u = _fhtcoeff(n, float(dln), float(mu), offset, bias, inverse=True)
    if bias != 0:
        pre, post = _bias_factors(n, float(dln), float(bias), float(offset))
        A = A / _on(post, A)
    a = irfft(rfft(A) / _on(np.conj(u), A, True), n).flip(-1)
    if bias != 0:
        a = a / _on(pre, a)
    return a


def fhtoffset(dln: float, mu: float, initial: float = 0.0, bias: float = 0.0) -> float:
    """Shift `initial` to the nearest low-ringing offset (scipy.fft.fhtoffset;
    Hamilton 2000's periodicity condition on the Nyquist mode's phase)."""
    lnkr, q = float(initial), float(bias)
    xp_ = (mu + 1 + q) / 2
    xm = (mu + 1 - q) / 2
    y = np.pi / (2.0 * float(dln))
    zp = _loggamma(np.asarray(xp_ + 1j * y))
    zm = _loggamma(np.asarray(xm + 1j * y))
    arg = (np.log(2.0) - lnkr) / dln + (zp.imag + zm.imag) / np.pi
    return float(lnkr + (arg - np.round(arg)) * dln)
