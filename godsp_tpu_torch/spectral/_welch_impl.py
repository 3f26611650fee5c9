"""scipy-compatible Welch estimators (the modern-API twins of pwelch).

Port of godsp_tpu/spectral/_welch_impl.py.  `pwelch` keeps the
reference's exact semantics (symmetric tapers, no detrend,
pad-then-window); this module gives the scipy.signal surface users
coming from scipy expect — PERIODIC windows of length nperseg applied
before the zero pad, per-segment detrending, density/spectrum scaling,
mean/median averaging, two-sided complex support — and returns
(freqs, Pxx) in scipy's order:

  welch, welch_csd, welch_coherence, spectrogram_scipy, lombscargle.

Routes on CUDA (float32 tensors, kernels on):
  * welch, one-sided, mean, no detrend: K4 (ops/cuda_pwelch.py) with the
    periodic nperseg window zero-extended to nfft in the kernel's
    pad-length window slot, which reproduces window-then-pad exactly;
  * welch_csd on the same condition: K7 (ops/cuda_csd.py);
  * spectrogram_scipy, psd mode, one-sided, no detrend: K5 stft_power;
  * everything else frames, detrends, windows and pads in torch, then
    fft_real or fft (K1/K2, Bluestein or the large plan on CUDA).
The fused branches take the eligibility checks through their module
attributes (_pwelch_impl.fused_path_eligible, _stft_impl's), so a test
can route CPU tensors through them.

One-sided doubling is scipy's: bins [1 : lp - 1 + nfft % 2] (every
non-DC bin for odd nfft), not the reference's [1 : lp - 1].
"""

from __future__ import annotations

import math

import numpy as np
import torch

from godsp_tpu_torch._dtypes import (
    _cuda_cast,
    as_complex_array,
    as_tensor,
    working_float,
)
from godsp_tpu_torch.dsputils.utils import detrend as _detrend
from godsp_tpu_torch.fft.core import fft, fft_real
from godsp_tpu_torch.ops import cuda_csd, cuda_pwelch, cuda_stft
from godsp_tpu_torch.spectral import _pwelch_impl
from godsp_tpu_torch.spectral._segment_impl import segment
from godsp_tpu_torch.window.extended import get_window

__all__ = ["lombscargle", "spectrogram_scipy", "welch", "welch_coherence", "welch_csd"]


def _periodic_table_np(window, nperseg: int) -> np.ndarray:
    """Resolve a scipy-style window spec to a float64 PERIODIC table
    (scipy's get_window(..., fftbins=True)): any catalogue name or
    (name, *params) tuple via window.extended.get_window, or an
    explicit length-nperseg array or tensor (used as given)."""
    if isinstance(window, (str, bytes)) or isinstance(window, tuple) or (
        isinstance(window, (int, float)) and not isinstance(window, bool)
    ):
        spec = tuple(window) if isinstance(window, tuple) else window
        return get_window(spec, nperseg, fftbins=True)
    if isinstance(window, list) and window and isinstance(window[0], str):
        return get_window(tuple(window), nperseg, fftbins=True)
    if isinstance(window, torch.Tensor):
        window = window.detach().cpu().numpy()
    w = np.asarray(window, np.float64)
    if w.ndim != 1 or w.shape[0] != nperseg:
        raise ValueError(f"window array must have length nperseg={nperseg}")
    return w


def _no_detrend(detrend) -> bool:
    return detrend is False or detrend is None


def _detrend_segments(frames: torch.Tensor, detrend) -> torch.Tensor:
    if _no_detrend(detrend):
        return frames
    if callable(detrend):
        return detrend(frames)
    if detrend in ("constant", "c"):
        return _detrend(frames, type="constant")
    if detrend in ("linear", "l"):
        return _detrend(frames, type="linear")
    raise ValueError("detrend must be 'constant', 'linear', False, or callable")


def _median_bias(n: int) -> float:
    """Bias of the median of n periodogram estimates relative to the
    mean (scipy.signal._spectral_py._median_bias)."""
    ii_2 = 2 * np.arange(1.0, (n - 1) // 2 + 1)
    return float(1 + np.sum(1.0 / (ii_2 + 1) - 1.0 / ii_2))


def _median(p: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """numpy's median along dim: the mean of the two middle values for an
    even count (torch.median returns the lower one; torch.quantile
    refuses more than 2^24 elements)."""
    n = p.shape[dim]
    s = torch.sort(p, dim=dim).values
    mid = s.narrow(dim, (n - 1) // 2, 2 - n % 2)
    return mid.mean(dim=dim)


def _doubler(nfft: int, like: torch.Tensor) -> torch.Tensor:
    """scipy's one-sided doubling over bins [1 : lp - 1 + nfft % 2]."""
    lp = nfft // 2 + 1
    d = torch.ones(lp, dtype=like.real.dtype, device=like.device)
    d[1 : lp - 1 + (nfft % 2)] = 2.0
    return d


def _as_input(x, device=None) -> torch.Tensor:
    """x as an inexact tensor at policy precision (ints lift to the
    working float; CUDA float64/complex128 cast to float32/complex64),
    on `device` when given (host data: default_device())."""
    x = as_tensor(x, device)
    if not (x.dtype.is_floating_point or x.dtype.is_complex):
        x = x.to(working_float(x.device))
    return _cuda_cast(x)


def _geometry(n: int, nperseg, noverlap, nfft, default_overlap):
    """(nperseg, noverlap, nfft) with scipy's defaults and checks."""
    nperseg = int(min(256 if nperseg is None else nperseg, n))
    noverlap = default_overlap(nperseg) if noverlap is None else int(noverlap)
    if noverlap >= nperseg:
        raise ValueError("noverlap must be less than nperseg")
    nfft = nperseg if nfft is None else int(nfft)
    if nfft < nperseg:
        raise ValueError("nfft must be >= nperseg")
    return nperseg, noverlap, nfft


def _scale(wt: np.ndarray, fs: float, scaling: str) -> float:
    if scaling == "density":
        return 1.0 / (float(fs) * float(np.sum(wt * wt)))
    return 1.0 / float(np.sum(wt)) ** 2


def _freqs(nfft: int, fs: float, onesided: bool, fdt, device) -> torch.Tensor:
    if onesided:
        return torch.arange(nfft // 2 + 1, dtype=fdt, device=device) * (float(fs) / nfft)
    return torch.as_tensor(np.fft.fftfreq(nfft, 1.0 / float(fs)), dtype=fdt, device=device)


def _w_ext(wt: np.ndarray, nfft: int, like: torch.Tensor) -> torch.Tensor:
    """The periodic nperseg table zero-extended to nfft: in a fused
    kernel's pad-length window slot it reproduces window-then-pad."""
    w = np.zeros(nfft)
    w[: wt.shape[0]] = wt
    return torch.from_numpy(w).to(like.device, like.real.dtype)


def _spectra(frames: torch.Tensor, w: torch.Tensor, nfft: int, onesided: bool,
             detrend) -> torch.Tensor:
    """Detrend -> periodic window -> zero pad to nfft -> FFT."""
    tapered = _detrend_segments(frames, detrend) * w
    if nfft > tapered.shape[-1]:
        tapered = torch.nn.functional.pad(tapered, (0, nfft - tapered.shape[-1]))
    if onesided:
        return fft_real(tapered)[..., : nfft // 2 + 1]
    return fft(as_complex_array(tapered))


def _out(p: torch.Tensor, axis: int) -> torch.Tensor:
    return torch.movedim(p, -1, axis) if p.dim() > 1 else p


def _check_modes(scaling: str, average: str = "mean") -> None:
    if scaling not in ("density", "spectrum"):
        raise ValueError("scaling must be 'density' or 'spectrum'")
    if average not in ("mean", "median"):
        raise ValueError("average must be 'mean' or 'median'")


def welch_csd(
    x,
    y,
    fs: float = 1.0,
    window="hann",
    nperseg: int | None = None,
    noverlap: int | None = None,
    nfft: int | None = None,
    detrend="constant",
    return_onesided: bool = True,
    scaling: str = "density",
    axis: int = -1,
    average: str = "mean",
):
    """Cross power spectral density with scipy.signal.csd semantics:
    returns (freqs, Pxy) with Pxy complex (conj(X) * Y averaged over
    segments).  The scipy-convention twin of the reference-parity
    spectral.csd (symmetric tapers, no detrend); welch_csd(x, x).real
    == welch(x)."""
    _check_modes(scaling, average)
    x = _as_input(x)
    x, y = torch.movedim(x, axis, -1), torch.movedim(_as_input(y, x.device), axis, -1)
    if x.shape != y.shape:
        raise ValueError("x and y must have identical shapes")
    n = x.shape[-1]
    fdt = x.real.dtype
    if n == 0:
        return (torch.zeros(0, dtype=fdt, device=x.device),
                torch.zeros(x.shape[:-1] + (0,), dtype=torch.complex64, device=x.device))
    nperseg, noverlap, nfft = _geometry(n, nperseg, noverlap, nfft, lambda m: m // 2)
    onesided = return_onesided and not (x.dtype.is_complex or y.dtype.is_complex)
    wt = _periodic_table_np(window, nperseg)
    scale = _scale(wt, fs, scaling)
    stride = nperseg - noverlap
    if (onesided and average == "mean" and _no_detrend(detrend)
            and _pwelch_impl.fused_path_eligible(x, nperseg, nfft, stride)):
        total_segs = (n - nperseg) // stride + 1
        re, im = cuda_csd.csd_power_sum(x, y, _w_ext(wt, nfft, x), nperseg, stride,
                                        total_segs, pad=nfft)
        pxy = torch.complex(re, im) * _doubler(nfft, re) * (scale / total_segs)
        return _freqs(nfft, fs, True, fdt, x.device), _out(pxy, axis)

    w = torch.from_numpy(wt).to(x.device, fdt)
    sx = _spectra(segment(x, nperseg, noverlap), w, nfft, onesided, detrend)
    sy = _spectra(segment(y, nperseg, noverlap), w, nfft, onesided, detrend)
    p = torch.conj(sx) * sy
    if onesided:
        p = p * _doubler(nfft, p)
    p = p * scale
    if average == "median":
        bias = _median_bias(p.shape[-2])
        p = torch.complex(_median(p.real) / bias, _median(p.imag) / bias)
    else:
        p = p.mean(dim=-2)
    return _freqs(nfft, fs, onesided, fdt, x.device), _out(p, axis)


def welch_coherence(
    x,
    y,
    fs: float = 1.0,
    window="hann",
    nperseg: int | None = None,
    noverlap: int | None = None,
    nfft: int | None = None,
    detrend="constant",
    axis: int = -1,
):
    """Magnitude-squared coherence Cxy = |Pxy|^2 / (Pxx Pyy) with
    scipy.signal.coherence semantics (the scipy-convention twin of the
    reference-parity spectral.coherence)."""
    kw = dict(fs=fs, window=window, nperseg=nperseg, noverlap=noverlap,
              nfft=nfft, detrend=detrend, axis=axis)
    x = _as_input(x)
    y = _as_input(y, x.device)
    freqs, pxx = welch(x, **kw)
    _, pyy = welch(y, **kw)
    _, pxy = welch_csd(x, y, **kw)
    return freqs, (pxy.real**2 + pxy.imag**2) / (pxx * pyy)


def welch(
    x,
    fs: float = 1.0,
    window="hann",
    nperseg: int | None = None,
    noverlap: int | None = None,
    nfft: int | None = None,
    detrend="constant",
    return_onesided: bool = True,
    scaling: str = "density",
    axis: int = -1,
    average: str = "mean",
):
    """Welch PSD with scipy.signal.welch semantics: returns (freqs, Pxx)
    along `axis` (other axes batch).  Real input -> one-sided spectrum
    (unless return_onesided=False); complex input -> two-sided.
    scaling='density' (V**2/Hz, 1/(fs*sum(w^2))) or 'spectrum' (V**2,
    1/sum(w)^2); average='mean' or 'median' (bias-corrected)."""
    _check_modes(scaling, average)
    x = torch.movedim(_as_input(x), axis, -1)
    n = x.shape[-1]
    fdt = x.real.dtype
    if n == 0:
        return (torch.zeros(0, dtype=fdt, device=x.device),
                torch.zeros(x.shape[:-1] + (0,), dtype=fdt, device=x.device))
    nperseg, noverlap, nfft = _geometry(n, nperseg, noverlap, nfft, lambda m: m // 2)
    onesided = return_onesided and not x.dtype.is_complex
    wt = _periodic_table_np(window, nperseg)
    scale = _scale(wt, fs, scaling)
    stride = nperseg - noverlap
    if (onesided and average == "mean" and _no_detrend(detrend)
            and _pwelch_impl.fused_path_eligible(x, nperseg, nfft, stride)):
        total_segs = (n - nperseg) // stride + 1
        p = cuda_pwelch.pwelch_power_sum(x, _w_ext(wt, nfft, x), nperseg, stride, total_segs,
                                         pad=nfft)
        pxx = p * _doubler(nfft, p) * (scale / total_segs)
        return _freqs(nfft, fs, True, fdt, x.device), _out(pxx, axis)

    w = torch.from_numpy(wt).to(x.device, fdt)
    spec = _spectra(segment(x, nperseg, noverlap), w, nfft, onesided, detrend)
    p = spec.real * spec.real + spec.imag * spec.imag
    if onesided:
        p = p * _doubler(nfft, p)
    p = p * scale
    if average == "median":
        p = _median(p) / _median_bias(p.shape[-2])
    else:
        p = p.mean(dim=-2)
    return _freqs(nfft, fs, onesided, fdt, x.device), _out(p, axis)


def spectrogram_scipy(
    x,
    fs: float = 1.0,
    window=("tukey", 0.25),
    nperseg: int | None = None,
    noverlap: int | None = None,
    nfft: int | None = None,
    detrend="constant",
    return_onesided: bool = True,
    scaling: str = "density",
    axis: int = -1,
    mode: str = "psd",
):
    """Per-segment spectrogram with scipy.signal.spectrogram semantics:
    returns (freqs, times, Sxx) with the segment axis LAST (scipy's
    layout; models.spectrogram keeps frames on -2).  mode: 'psd' (scaled
    power), 'magnitude' (|X| * sqrt(scale), no one-sided doubling, as
    scipy), or 'complex' (scaled spectrum).  Default noverlap is
    nperseg//8 (scipy's spectrogram default)."""
    from godsp_tpu_torch.models import _stft_impl

    if mode not in ("psd", "magnitude", "complex"):
        raise ValueError("mode must be 'psd', 'magnitude', or 'complex'")
    _check_modes(scaling)
    x = torch.movedim(_as_input(x), axis, -1)
    n = x.shape[-1]
    nperseg, noverlap, nfft = _geometry(n, nperseg, noverlap, nfft, lambda m: m // 8)
    wt = _periodic_table_np(window, nperseg)
    onesided = return_onesided and not x.dtype.is_complex
    fdt = x.real.dtype
    scale = _scale(wt, fs, scaling)
    step = nperseg - noverlap
    if (mode == "psd" and onesided and _no_detrend(detrend) and n >= nperseg
            and _stft_impl.fused_path_eligible(x, nperseg, nfft, step)):
        n_frames = (n - nperseg) // step + 1
        p = cuda_stft.stft_power(x, _w_ext(wt, nfft, x), nperseg, step, n_frames, pad=nfft)
        sxx = torch.swapaxes(p * _doubler(nfft, p) * scale, -1, -2)
        times = (torch.arange(n_frames, dtype=fdt, device=x.device) * step
                 + nperseg / 2.0) / float(fs)
        return _freqs(nfft, fs, True, fdt, x.device), times, sxx

    w = torch.from_numpy(wt).to(x.device, fdt)
    frames = segment(x, nperseg, noverlap)
    nsegs = frames.shape[-2]
    spec = _spectra(frames, w, nfft, onesided, detrend)
    if mode == "complex":
        sxx = spec * math.sqrt(scale)
    elif mode == "magnitude":
        sxx = torch.abs(spec) * math.sqrt(scale)
    else:
        sxx = spec.real * spec.real + spec.imag * spec.imag
        if onesided:
            sxx = sxx * _doubler(nfft, sxx)
        sxx = sxx * scale
    sxx = torch.swapaxes(sxx, -1, -2)  # scipy: freq axis then time axis last
    times = (torch.arange(nsegs, dtype=fdt, device=x.device) * step + nperseg / 2.0) / float(fs)
    return _freqs(nfft, fs, onesided, fdt, x.device), times, sxx


def lombscargle(x, y, freqs, precenter: bool = False, normalize: bool = False):
    """Lomb-Scargle periodogram of unevenly sampled data
    (scipy.signal.lombscargle's classical form): the per-frequency
    phase-shifted least-squares sinusoid fit power, as one batched
    (n_freqs, n_samples) outer trig product and row sums — elementwise
    work and reductions, no matmul and no kernel of its own.  Runs in the
    working float of x's device (float32 on CUDA: the trig of the float32
    product freqs * x loses about |freqs * x| * 2^-24 rad of phase)."""
    x = as_tensor(x)
    dev = x.device
    fdt = working_float(dev)
    x = x.to(fdt)
    y = as_tensor(y, dev).to(fdt)
    freqs = as_tensor(freqs, dev).to(fdt)
    if x.dim() != 1 or y.dim() != 1 or freqs.dim() != 1:
        raise ValueError("x, y, freqs must be 1-D")
    if x.shape[0] != y.shape[0]:
        raise ValueError("x and y must have the same length")
    if precenter:
        y = y - torch.mean(y)
    # classical Lomb-Scargle with per-frequency time offset tau
    wt = freqs[:, None] * x[None, :]  # (nf, n)
    s2 = torch.sum(torch.sin(2 * wt), dim=-1)
    c2 = torch.sum(torch.cos(2 * wt), dim=-1)
    tau = 0.5 * torch.atan2(s2, c2)
    arg = wt - tau[:, None]
    del wt
    cw = torch.cos(arg)
    sw = torch.sin(arg)
    del arg
    yc = torch.sum(y[None, :] * cw, dim=-1)
    ys = torch.sum(y[None, :] * sw, dim=-1)
    cc = torch.sum(cw * cw, dim=-1)
    ss_ = torch.sum(sw * sw, dim=-1)
    p = 0.5 * (yc * yc / cc + ys * ys / ss_)
    if normalize:
        p = p * 2.0 / torch.sum(y * y)
    return p
