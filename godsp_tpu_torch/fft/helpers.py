"""Frequency-grid and spectrum-layout helpers (numpy/scipy.fft semantics).

Port of godsp_tpu/fft/helpers.py.  Beyond the reference's surface (go-dsp
exposes only the freqs grid inside Pwelch, pwelch.go:138-142) but
expected of any FFT package: sample-frequency grids, the centered-spectrum
reorder, the analytic signal (Hilbert transform), the real and Hermitian
transforms in 1-D, 2-D and N-D, and the fast-length planners.  All run
on the framework's FFT dispatch (fft/core.py), batched over leading axes;
host input goes to default_device().
"""

from __future__ import annotations

import numpy as np
import torch

from godsp_tpu_torch._dtypes import (
    as_complex_array,
    as_real_array,
    as_tensor,
    complex_for,
    resolve_device,
    working_float,
)

__all__ = ["fftfreq", "rfftfreq", "fftshift", "ifftshift", "hfft",
           "hfft2", "hfftn", "hilbert", "ihfft", "ihfft2", "ihfftn",
           "irfft", "irfft2", "irfftn",
           "next_fast_len", "prev_fast_len", "rfft", "rfft2", "rfftn"]


def fftfreq(n: int, d: float = 1.0) -> torch.Tensor:
    """DFT sample frequencies: [0, 1, ..., n//2-1, -(n//2), ..., -1]/(n d)
    (numpy.fft.fftfreq; the two-sided counterpart of pwelch.go:138-142),
    on default_device()."""
    dev = resolve_device()
    return torch.as_tensor(np.fft.fftfreq(n, d), dtype=working_float(dev), device=dev)


def rfftfreq(n: int, d: float = 1.0) -> torch.Tensor:
    """One-sided DFT sample frequencies i/(n d), i = 0..n//2 — exactly
    Pwelch's freqs grid (pwelch.go:138-142) with fs = 1/d."""
    dev = resolve_device()
    return torch.arange(n // 2 + 1, dtype=working_float(dev), device=dev) / (n * d)


def _roll_half(x, axes, inverse: bool) -> torch.Tensor:
    x = as_tensor(x)
    if axes is None:
        axes = tuple(range(x.dim()))
    elif isinstance(axes, int):
        axes = (axes,)
    axes = tuple(axes)
    shifts = tuple(-(x.shape[a] // 2) if inverse else x.shape[a] // 2 for a in axes)
    return torch.roll(x, shifts, axes) if axes else x


def fftshift(x, axes=None) -> torch.Tensor:
    """Move the zero-frequency bin to the center (numpy.fft.fftshift)."""
    return _roll_half(x, axes, inverse=False)


def ifftshift(x, axes=None) -> torch.Tensor:
    """Inverse of fftshift, exact also for odd lengths."""
    return _roll_half(x, axes, inverse=True)


def _resize_last(x: torch.Tensor, n: int) -> torch.Tensor:
    """Truncate or zero-pad the trailing axis to n."""
    cur = x.shape[-1]
    if n < cur:
        return x[..., :n]
    if n > cur:
        return torch.nn.functional.pad(x, (0, n - cur))
    return x


def hilbert(x, N: int | None = None, axis: int = -1) -> torch.Tensor:
    """Analytic signal of a real input (scipy.signal.hilbert semantics,
    incl. the N zero-pad/truncate and axis parameters).

    z = x + i * H{x}: the spectrum's positive frequencies are doubled,
    negative zeroed (DC and Nyquist kept), through the framework's FFT
    dispatch (any length; Bluestein over the kernels for non-pow-2).
    |z| is the envelope; torch.angle(z) the instantaneous phase.
    """
    from godsp_tpu_torch.fft.core import fft, ifft

    x = as_real_array(x).movedim(axis, -1)
    if N is not None:
        N = int(N)
        if N < 1:
            raise ValueError("N must be >= 1")
        x = _resize_last(x, N)
    n = x.shape[-1]
    if n == 0:
        return x.to(complex_for(x.dtype)).movedim(-1, axis)
    X = fft(x)
    h = torch.zeros(n, dtype=X.real.dtype, device=X.device)  # built where X lies
    h[0] = 1.0
    if n % 2 == 0:
        h[n // 2] = 1.0
        h[1 : n // 2] = 2.0
    else:
        h[1 : (n + 1) // 2] = 2.0
    return ifft(X * h).movedim(-1, axis)


def rfft(x, n: int | None = None, axis: int = -1) -> torch.Tensor:
    """One-sided FFT of real input (scipy.fft.rfft semantics: n//2 + 1
    bins; n pads/truncates before transforming).  On CUDA, pow-2 n up to
    16384 runs K3 (rfft_split)."""
    from godsp_tpu_torch.fft.split import rfft_split

    x = as_tensor(x)
    if x.dtype.is_complex:
        raise ValueError("rfft expects real input")
    x = x.movedim(axis, -1)
    n = x.shape[-1] if n is None else int(n)
    if n < 1:
        raise ValueError("n must be >= 1")
    yr, yi = rfft_split(_resize_last(as_real_array(x), n))
    return torch.complex(yr, yi).movedim(-1, axis)


def irfft(X, n: int | None = None, axis: int = -1) -> torch.Tensor:
    """Real inverse of rfft (scipy.fft.irfft: output length n, default
    2*(bins-1)): the Hermitian spectrum rebuilt, then the inverse FFT."""
    from godsp_tpu_torch.fft.core import ifft

    X = as_complex_array(X).movedim(axis, -1)
    n = 2 * (X.shape[-1] - 1) if n is None else int(n)
    if n < 1:
        raise ValueError("n must be >= 1")
    X = _resize_last(X, n // 2 + 1)
    neg = torch.conj(X[..., 1 : (n + 1) // 2].flip(-1))
    return ifft(torch.cat([X, neg], dim=-1)).real.movedim(-1, axis)


def hfft(x, n: int | None = None, axis: int = -1) -> torch.Tensor:
    """FFT of a Hermitian-symmetric signal -> real spectrum
    (scipy.fft.hfft): hfft(x, n) == irfft(conj(x), n) * n."""
    x = torch.conj_physical(as_complex_array(x))
    bins = x.shape[axis]
    n = 2 * (bins - 1) if n is None else int(n)
    return irfft(x, n, axis=axis) * n


def ihfft(x, n: int | None = None, axis: int = -1) -> torch.Tensor:
    """Inverse of hfft (scipy.fft.ihfft): conj(rfft(x, n)) / n."""
    x = as_tensor(x)
    if x.dtype.is_complex:
        raise ValueError("ihfft expects real input")
    nn = x.shape[axis] if n is None else int(n)
    return torch.conj(rfft(x, n, axis=axis)) / nn


def _smooth_search(target: int, primes, prev: bool) -> int:
    """Enumerate products of the odd primes (any multiplicity), filling
    with the power of two that lands nearest target on the requested
    side; returns the best 'smooth' length."""
    if prev:
        best = 1

        def rec(prod):
            nonlocal best
            if prod > target:
                return
            quot = target // prod
            if quot >= 1:
                p2 = 1 << (quot.bit_length() - 1)
                best = max(best, p2 * prod)
            for q in primes:
                if prod * q > target:
                    break
                rec(prod * q)

        rec(1)
        return best
    best = 1 << (target - 1).bit_length()

    def rec(prod):
        nonlocal best
        if prod >= best:
            return
        quot = -(-target // prod)
        p2 = 1 << max(quot - 1, 0).bit_length()
        n = p2 * prod
        if n < best:
            best = n
        for q in primes:
            if prod * q >= best:
                break
            rec(prod * q)

    rec(1)
    return best


def next_fast_len(target: int, real: bool = False) -> int:
    """Smallest FFT-fast length >= target (scipy.fft.next_fast_len:
    {2,3,5,7,11}-smooth for complex transforms, {2,3,5}-smooth for
    real=True).  On the kernels powers of two are the fast sizes
    (dsputils.next_power_of_2); this helper is for scipy-compatible
    planning."""
    target = int(target)
    if target <= 1:
        return max(target, 1)
    primes = (3, 5) if real else (3, 5, 7, 11)
    return _smooth_search(target, primes, prev=False)


def prev_fast_len(target: int, real: bool = False) -> int:
    """Largest FFT-fast length <= target (scipy.fft.prev_fast_len)."""
    target = int(target)
    if target < 1:
        raise ValueError("target must be >= 1")
    primes = (3, 5) if real else (3, 5, 7, 11)
    return _smooth_search(target, primes, prev=True)


def _axes_and_sizes(x: torch.Tensor, s, axes, last_default):
    """Normalized transform axes and their lengths; the last length
    defaults to last_default(length along the last axis)."""
    if axes is None:
        axes = tuple(range(x.dim()))
    axes = tuple(int(a) % x.dim() for a in axes)
    if s is None:
        s = tuple(x.shape[a] for a in axes[:-1]) + (last_default(x.shape[axes[-1]]),)
    if len(s) != len(axes):
        raise ValueError("s must match axes")
    return axes, tuple(int(n) for n in s)


def _complex_passes(X: torch.Tensor, axes, s, op) -> torch.Tensor:
    """op (fft or ifft) along each axis after resizing it to its length."""
    for ax, n in zip(axes, s):
        X = op(_resize_last(X.movedim(ax, -1), n)).movedim(-1, ax)
    return X


def rfft2(x, s=None, axes=(-2, -1)) -> torch.Tensor:
    """2-D FFT of real input, one-sided over the last transform axis
    (scipy.fft.rfft2 semantics)."""
    return rfftn(x, s=s, axes=axes)


def irfft2(X, s=None, axes=(-2, -1)) -> torch.Tensor:
    """Inverse of rfft2 (scipy.fft.irfft2)."""
    return irfftn(X, s=s, axes=axes)


def rfftn(x, s=None, axes=None) -> torch.Tensor:
    """N-D FFT of real input, one-sided over the LAST axis in `axes`
    (scipy.fft.rfftn): rfft along the final transform axis, then full
    complex FFTs along the rest."""
    from godsp_tpu_torch.fft.core import fft

    x = as_tensor(x)
    if x.dtype.is_complex:
        raise ValueError("rfftn expects real input")
    axes, s = _axes_and_sizes(x, s, axes, lambda n: n)
    X = rfft(x, s[-1], axis=axes[-1])
    return _complex_passes(X, axes[:-1], s[:-1], fft)


def irfftn(X, s=None, axes=None) -> torch.Tensor:
    """Inverse of rfftn (scipy.fft.irfftn): full inverse FFTs on the
    leading transform axes, then the real inverse along the last."""
    from godsp_tpu_torch.fft.core import ifft

    X = as_complex_array(X)
    axes, s = _axes_and_sizes(X, s, axes, lambda b: 2 * (b - 1))
    X = _complex_passes(X, axes[:-1], s[:-1], ifft)
    return irfft(X, s[-1], axis=axes[-1])


def ihfftn(x, s=None, axes=None) -> torch.Tensor:
    """N-D inverse Hermitian FFT of real input (scipy.fft.ihfftn):
    conj(rfftn(x, s, axes)) / prod(transform lengths)."""
    x = as_tensor(x)
    axes, s = _axes_and_sizes(x, s, axes, lambda n: n)
    return torch.conj(rfftn(x, s=s, axes=axes)) / int(np.prod(s))


def ihfft2(x, s=None, axes=(-2, -1)) -> torch.Tensor:
    """2-D inverse Hermitian FFT (scipy.fft.ihfft2)."""
    return ihfftn(x, s=s, axes=axes)


def hfftn(x, s=None, axes=None) -> torch.Tensor:
    """N-D FFT of a Hermitian-symmetric signal -> real spectrum
    (scipy.fft.hfftn): irfftn(conj(x), s, axes) * prod(output
    transform lengths)."""
    x = torch.conj_physical(as_complex_array(x))
    axes, s = _axes_and_sizes(x, s, axes, lambda b: 2 * (b - 1))
    return irfftn(x, s=s, axes=axes) * int(np.prod(s))


def hfft2(x, s=None, axes=(-2, -1)) -> torch.Tensor:
    """2-D Hermitian FFT (scipy.fft.hfft2)."""
    return hfftn(x, s=s, axes=axes)
