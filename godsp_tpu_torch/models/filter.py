"""Linear convolution and FIR filtering on the port's FFT convolution chain.

Port of godsp_tpu/models/filter.py.  The reference stops at circular
`Convolve` (fft/fft.go:55-69); these add LINEAR convolution and
long-signal FIR filtering over fft/pow2.py (pow2_fft, pow2_convolve,
pow2_circular_filter): on the card a power-of-2 pad up to 16384 runs K1
forward and K2 inverse (ops/cuda_fft.py), a larger one the large plan
(fft/large.py: K8, then K1/K2 rows); on the CPU the plain four-step.

  fftconvolve  — scipy-style linear convolution (full/same/valid) via
                 zero-padding to a power of 2;
  fir_filter   — causal FIR y[n] = sum_k taps[k] x[n-k], zero initial
                 state (scipy.signal.lfilter(taps, 1, x) semantics);
  overlap_save — block-wise FIR for long signals: all blocks go through
                 ONE batched circular filter with the tap spectrum
                 computed once, O(block) memory a row.

All functions batch over leading axes and run on the input's device
(host input lands on default_device(); the second operand follows the
first).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from godsp_tpu_torch._dtypes import as_complex_array, as_real_array, as_tensor
from godsp_tpu_torch.dsputils.utils import next_power_of_2
from godsp_tpu_torch.fft.core import fft, ifft
from godsp_tpu_torch.fft.pow2 import pow2_circular_filter, pow2_convolve, pow2_fft

__all__ = [
    "choose_conv_method",
    "convolve",
    "correlate",
    "correlation_lags",
    "deconvolve",
    "envelope",
    "fftconvolve",
    "fir_filter",
    "medfilt",
    "oaconvolve",
    "overlap_save",
]


def _mode_slice(la: int, lb: int, mode: str) -> slice:
    if mode == "full":
        return slice(0, la + lb - 1)
    if mode == "same":
        start = (lb - 1) // 2
        return slice(start, start + la)
    if mode == "valid":
        lo, hi = min(la, lb), max(la, lb)
        return slice(lo - 1, lo - 1 + hi - lo + 1)
    raise ValueError(f"unknown mode: {mode}")


def _complex_pair(a: torch.Tensor, b: torch.Tensor):
    ac, bc = as_complex_array(a), as_complex_array(b)
    cdt = torch.promote_types(ac.dtype, bc.dtype)
    return ac.to(cdt), bc.to(cdt)


def _fftconvolve_1d(a, b, mode: str, real_out: bool):
    la, lb = a.shape[-1], b.shape[-1]
    n = next_power_of_2(la + lb - 1)
    ac, bc = _complex_pair(a, b)
    ac = torch.nn.functional.pad(ac, (0, n - la))
    bc = torch.nn.functional.pad(bc, (0, n - lb))
    full = pow2_convolve(ac, bc, scale=1.0 / n)
    out = full[..., _mode_slice(la, lb, mode)]
    return out.real if real_out else out


def _pad_axis(t: torch.Tensor, ax: int, n: int) -> torch.Tensor:
    return torch.nn.functional.pad(t.movedim(ax, -1), (0, n - t.shape[ax])).movedim(-1, ax)


def _fftconvolve_nd(a, b, mode: str, real_out: bool, axes: tuple):
    """scipy-style N-D convolution over `axes`: per-axis pow-2 pad +
    forward FFT passes, one pointwise product, inverse passes, then the
    per-axis mode crop."""
    ac, bc = _complex_pair(a, b)
    sizes = []
    for ax in axes:
        la, lb = a.shape[ax], b.shape[ax]
        n = next_power_of_2(la + lb - 1)
        sizes.append((la, lb, n))
        ac = pow2_fft(_pad_axis(ac, ax, n).movedim(ax, -1)).movedim(-1, ax)
        bc = pow2_fft(_pad_axis(bc, ax, n).movedim(ax, -1)).movedim(-1, ax)
    full = ac * bc
    scale = 1.0
    for (_, _, n) in sizes:
        scale *= n
    for ax in axes:
        full = pow2_fft(full.movedim(ax, -1), inverse=True).movedim(-1, ax)
    full = full * (1.0 / scale)
    for ax, (la, lb, _) in zip(axes, sizes):
        sl = [slice(None)] * full.dim()
        sl[ax] = _mode_slice(la, lb, mode)
        full = full[tuple(sl)]
    return full.real if real_out else full


def fftconvolve(a, b, mode: str = "full", axes=None) -> torch.Tensor:
    """Linear convolution of a and b.

    Default (axes=None): scipy.signal.fftconvolve semantics on the 1-D
    TRAILING axis with leading axes broadcast as batch (this framework's
    batched convention).  With `axes` given: scipy's N-D semantics —
    convolve over exactly those axes (the remaining axes must agree or
    broadcast), e.g. axes=(-2, -1) for image convolution.

    Real inputs return real output.  mode: "full" (la+lb-1), "same"
    (size of a), "valid" (|la-lb|+1) — applied per convolved axis.
    """
    if mode not in ("full", "same", "valid"):
        raise ValueError(f"unknown mode: {mode}")
    a = as_tensor(a)
    b = as_tensor(b, device=a.device)
    real_out = not a.dtype.is_complex and not b.dtype.is_complex
    if axes is not None:
        if isinstance(axes, int):
            axes = (axes,)
        nd = max(a.dim(), b.dim())
        axes = tuple(sorted(ax % nd for ax in axes))
        if len(set(axes)) != len(axes):
            raise ValueError("axes must be unique")
        a = a.reshape((1,) * (nd - a.dim()) + tuple(a.shape))
        b = b.reshape((1,) * (nd - b.dim()) + tuple(b.shape))
        for ax in axes:
            if a.shape[ax] == 0 or b.shape[ax] == 0:
                raise ValueError("empty input")
            if mode == "valid" and a.shape[ax] < b.shape[ax]:
                raise ValueError("valid mode needs a at least as large as b "
                                 "along every convolved axis")
        return _fftconvolve_nd(a, b, mode, real_out, axes)
    if a.shape[-1] == 0 or b.shape[-1] == 0:
        raise ValueError("empty input")
    return _fftconvolve_1d(a, b, mode, real_out)


def _reversed_conj(b: torch.Tensor, dims: tuple) -> torch.Tensor:
    rev = b.flip(dims)
    return rev.conj().resolve_conj() if b.dtype.is_complex else rev


def correlate(a, b, mode: str = "full", axes=None) -> torch.Tensor:
    """Cross-correlation of a and b (scipy.signal.correlate, method='fft',
    1-D trailing axes; leading axes broadcast as batch): correlate(a, b)
    [k] = sum_n a[n + k - (lb - 1)] conj(b[n]).  Equivalent to linear
    convolution with the reversed conjugate of b — one convolution chain
    via fftconvolve.  With `axes` given, correlates over those axes
    (N-D, like fftconvolve's axes)."""
    a = as_tensor(a)
    b = as_tensor(b, device=a.device)
    if axes is None:
        return fftconvolve(a, _reversed_conj(b, (-1,)), mode=mode)
    ax_t = (axes,) if isinstance(axes, int) else tuple(axes)
    rev = _reversed_conj(b, tuple(ax % b.dim() for ax in ax_t))
    return fftconvolve(a, rev, mode=mode, axes=ax_t)


def correlation_lags(in1_len: int, in2_len: int, mode: str = "full") -> np.ndarray:
    """Lag indices for correlate's output (scipy.signal.correlation_lags):
    lags[k] such that correlate(a, b)[k] pairs a[n + lags[k]] with b[n].
    Host integers (numpy int64)."""
    in1_len, in2_len = int(in1_len), int(in2_len)
    if mode == "full":
        return np.arange(-in2_len + 1, in1_len)
    if mode == "same":
        lags = np.arange(-in2_len + 1, in1_len)
        mid = lags.shape[0] // 2
        start = mid - in1_len // 2
        return lags[start : start + in1_len]
    if mode == "valid":
        bound = in1_len - in2_len
        return np.arange(bound + 1) if bound >= 0 else np.arange(bound, 1)
    raise ValueError(f"unknown mode: {mode}")


def deconvolve(signal, divisor):
    """Polynomial long division: (quotient, remainder) such that
    signal = convolve(divisor, quotient) + remainder
    (scipy.signal.deconvolve semantics; host float64/complex128 — the
    sequential recurrence is division, not a batched device op)."""
    num = np.atleast_1d(np.asarray(signal))
    den = np.atleast_1d(np.asarray(divisor))
    if num.ndim != 1 or den.ndim != 1:
        raise ValueError("signal and divisor must be 1-D")
    if den.shape[0] == 0 or den[0] == 0:
        raise ValueError("divisor must not be empty or start with zero")
    dt = np.result_type(num.dtype, den.dtype, np.float64)
    num = num.astype(dt)
    den = den.astype(dt)
    N, D = num.shape[0], den.shape[0]
    if D > N:
        return np.zeros(0, dt), num
    quot = np.zeros(N - D + 1, dt)
    rem = num.copy()
    for i in range(N - D + 1):
        c = rem[i] / den[0]
        quot[i] = c
        rem[i : i + D] -= c * den
    return quot, rem


def medfilt(x, kernel_size: int = 3) -> torch.Tensor:
    """Sliding-window median along the trailing axis with zero-padded
    edges (scipy.signal.medfilt's 1-D behavior; leading axes batch).
    The window axis is a strided view (unfold) reduced by torch.median
    over an odd count, so the median is the middle element."""
    k = int(kernel_size)
    if k < 1 or k % 2 == 0:
        raise ValueError("kernel_size must be a positive odd integer")
    x = as_real_array(x)
    xp = torch.nn.functional.pad(x, (k // 2, k // 2))
    return xp.unfold(-1, k, 1).median(dim=-1).values


def fir_filter(x, taps) -> torch.Tensor:
    """Causal FIR filter with zero initial state: y has x's length,
    y[n] = sum_k taps[k] x[n-k] (scipy.signal.lfilter(taps, [1], x))."""
    x = as_tensor(x)
    full = fftconvolve(x, taps, mode="full")
    return full[..., : x.shape[-1]]


def _overlap_save(x, h_freq, block: int, n: int, m: int, real_out: bool):
    L = x.shape[-1]
    nblocks = -(-L // block)
    lead = tuple(x.shape[:-1])
    # Each block b filters x[b*block - (m-1) : b*block + n - (m-1)]; the
    # first m-1 outputs of each circular convolution are aliased and
    # discarded.  Frame with an (m-1)-sample left pad, batched.
    padded = torch.nn.functional.pad(
        as_complex_array(x).to(h_freq.dtype), (m - 1, nblocks * block + n - m + 1 - L))
    frames = padded.unfold(-1, n, block)[..., :nblocks, :]  # (..., nblocks, n)
    filt = pow2_circular_filter(frames, h_freq, scale=1.0 / n)
    y = filt[..., m - 1 : m - 1 + block].reshape(*lead, nblocks * block)[..., :L]
    return y.real if real_out else y


def overlap_save(x, taps, block: int | None = None) -> torch.Tensor:
    """Long-signal causal FIR via overlap-save (zero initial state).

    Equivalent to fir_filter but processes the signal in power-of-2
    blocks with the tap spectrum computed once — ALL blocks run as one
    batched circular filter.  block: output samples per block
    (default: a size >= 8 * len(taps), at least 1024).
    """
    x = as_tensor(x)
    taps = as_tensor(taps, device=x.device)
    m = taps.shape[-1]
    if m == 0:
        raise ValueError("empty taps")
    if m > x.shape[-1]:
        return fir_filter(x, taps)
    if block is None:
        block = max(1024, next_power_of_2(8 * m))
        block = min(block, next_power_of_2(x.shape[-1]))
    if block < m:
        raise ValueError(
            f"block ({block}) must be >= len(taps) ({m}) for overlap-save"
        )
    n = next_power_of_2(block + m - 1)
    real_out = not x.dtype.is_complex and not taps.dtype.is_complex
    xc, tc = _complex_pair(x, taps)
    h = fft(torch.nn.functional.pad(tc, (0, n - m)))
    return _overlap_save(xc, h, int(block), n, m, real_out)


def convolve(in1, in2, mode: str = "full", method: str = "auto") -> torch.Tensor:
    """Generic convolution entry point (scipy.signal.convolve surface).
    Every method routes to the FFT convolution chain — the batched FFT
    chain is the fast path at every size here, so 'direct' and 'auto'
    are accepted for API compatibility and produce identical (float)
    results."""
    if method not in ("auto", "fft", "direct"):
        raise ValueError("method must be 'auto', 'fft', or 'direct'")
    return fftconvolve(in1, in2, mode=mode)


def oaconvolve(in1, in2, mode: str = "full") -> torch.Tensor:
    """Overlap-add convolution (scipy.signal.oaconvolve surface).  For
    unbounded streams use models.overlap_save (the batched blockwise
    form); for in-memory signals the single convolution chain of
    fftconvolve gives the same result, so this routes there."""
    return fftconvolve(in1, in2, mode=mode)


def choose_conv_method(in1, in2, mode: str = "full", measure: bool = False):
    """Convolution-method advisor (scipy.signal.choose_conv_method
    surface).  The batched FFT chain is the fast path at every size this
    framework targets, so the answer is always 'fft'; with measure=True
    the fftconvolve wall time (host clock, synchronized on the card) is
    reported."""
    if not measure:
        return "fft"
    t0 = time.perf_counter()
    out = fftconvolve(in1, in2, mode=mode)
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    return "fft", {"fft": time.perf_counter() - t0}


def _envelope(z, n_out: int, start: int, stop: int, squared: bool,
              residual, is_complex: bool):
    """envelope's pipeline: band select, baseband inverse, magnitude,
    residual rebuild."""
    from godsp_tpu_torch.models._resample_impl import _resample

    n = z.shape[-1]
    fak = n_out / n
    Z = fft(z)
    rdt, dev = Z.real.dtype, Z.device
    if not is_complex:
        wgt = np.zeros(n)
        wgt[: n // 2 + 1] = 1.0
        if start > 0:
            wgt[start:stop] = 2.0
        elif stop > 0:
            wgt[1:stop] = 2.0
        Z = Z * torch.from_numpy(wgt).to(device=dev, dtype=rdt)
    idx = np.arange(start, stop) % n
    band = Z[..., torch.from_numpy(idx).to(dev)]
    bpad = torch.nn.functional.pad(band, (0, n_out - band.shape[-1]))
    z_bb = ifft(bpad) * fak
    z_env = (z_bb.real**2 + z_bb.imag**2) if squared else torch.abs(z_bb)
    if residual is None:
        return z_env
    mask = np.ones(n)
    mask[idx] = 0.0
    if residual == "lowpass":
        if stop > 0:
            mask[stop : (n + 1) // 2] = 0.0
        else:
            mask[np.arange(start, (n + 1) // 2) % n] = 0.0
    Zr = Z * torch.from_numpy(mask).to(device=dev, dtype=rdt)
    if is_complex:
        z_res = _resample(Zr, n_out, False, None, "freq")
    else:
        half = Zr[..., : n // 2 + 1].clone()
        m = min(n, n_out)
        if n_out != n and m % 2 == 0:
            half[..., m // 2] *= 2.0 if n_out < n else 0.5
        nbins = n_out // 2 + 1
        if half.shape[-1] < nbins:
            half = torch.nn.functional.pad(half, (0, nbins - half.shape[-1]))
        else:
            half = half[..., :nbins]
        neg = half[..., 1 : (n_out + 1) // 2].flip(-1).conj()
        full = torch.cat([half, neg], dim=-1)
        z_res = ifft(full).real * fak
    return torch.stack([z_env, z_res], dim=0)


def envelope(z, bp_in: tuple = (1, None), *, n_out: int | None = None,
             squared: bool = False, residual: str | None = "lowpass",
             axis: int = -1):
    """Band-restricted analytic envelope + residual
    (scipy.signal.envelope semantics): select the FFT bins
    bp_in[0]:bp_in[1] (integer frequencies, negatives allowed), form
    the analytic/baseband signal of that band (resampled to n_out),
    return its magnitude (or squared magnitude) stacked with the
    residual of the out-of-band part ('lowpass' keeps only bins below
    the band, 'all' keeps everything outside, None skips it)."""
    z = as_tensor(z)
    z = as_complex_array(z) if z.dtype.is_complex else as_real_array(z)
    if residual not in ("lowpass", "all", None):
        raise ValueError("residual must be 'lowpass', 'all', or None")
    is_complex = z.dtype.is_complex
    z = z.movedim(axis, -1)
    n = z.shape[-1]
    n_out = n if n_out is None else int(n_out)
    if n_out < 1:
        raise ValueError("n_out must be positive")
    start = bp_in[0] if bp_in[0] is not None else -(n // 2)
    stop = bp_in[1] if bp_in[1] is not None else (n + 1) // 2
    if not -(n // 2) <= start < stop <= (n + 1) // 2:
        raise ValueError("need -n//2 <= bp_in[0] < bp_in[1] <= (n+1)//2")
    if stop - start > n_out:
        raise ValueError("n_out must be at least the bandwidth of bp_in")
    out = _envelope(z, n_out, start, stop, bool(squared), residual, is_complex)
    if residual is None:
        return out.movedim(-1, axis)
    # the stacked (env, residual) output has a new leading axis, so a
    # non-negative target shifts by one
    return out.movedim(-1, axis + 1 if axis >= 0 else axis)
