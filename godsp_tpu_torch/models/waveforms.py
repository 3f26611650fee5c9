"""Waveform generators (scipy.signal semantics), in plain torch.

Port of godsp_tpu/models/waveforms.py.  The reference has no signal
synthesis beyond test literals (fft/fft_test.go:24-120); the sweep,
pulse and periodic generators exercise the analysis stack.  All are
elementwise torch math on t's device (host t lands on default_device()),
batched over any t shape, and match scipy.signal to float32 round-off on
the card (float64 on the CPU).

max_len_seq is the exception: a Fibonacci LFSR is bit-serial, so the
register runs on the host (numpy int8, the type godsp_tpu returns too).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from godsp_tpu_torch._dtypes import as_real_array, resolve_device, working_float

__all__ = ["chirp", "gausspulse", "max_len_seq", "sawtooth", "square", "sweep_poly", "unit_impulse"]


def _swept_phase(t, f0, t1, f1, method, vertex_zero):
    """Integrated phase 2 pi INT_0^t f(u) du for the four standard sweep
    laws, each integrated in closed form from its instantaneous
    frequency (conventions — method aliases, the vertex_zero variant,
    the hyperbolic singularity handling via |.| — match
    scipy.signal.chirp so sweeps are drop-in interchangeable)."""
    tau = 2.0 * math.pi
    if method in ("linear", "lin", "li"):
        # f(u) = f0 + rate * u
        rate = (f1 - f0) / t1
        return tau * t * (f0 + 0.5 * rate * t)
    if method in ("quadratic", "quad", "q"):
        rate = (f1 - f0) / (t1 * t1)
        if vertex_zero:
            # f(u) = f0 + rate u^2: parabola vertex at the start
            return tau * t * (f0 + rate * t * t / 3.0)
        # vertex at u = t1: f(u) = f1 + rate (u - t1)^2
        return tau * (f1 * t + rate * ((t1 - t) ** 3 - t1**3) / 3.0)
    if method in ("logarithmic", "log", "lo"):
        if f0 <= 0 or f1 <= 0:
            raise ValueError("logarithmic chirp needs f0, f1 > 0")
        if f0 == f1:
            return tau * f0 * t
        # f(u) = f0 r^(u/t1), r = f1/f0
        r = f1 / f0
        return tau * f0 * (t1 / math.log(r)) * (torch.pow(r, t / t1) - 1.0)
    if method in ("hyperbolic", "hyp"):
        if f0 == 0 or f1 == 0:
            raise ValueError("hyperbolic chirp needs f0, f1 != 0")
        if f0 == f1:
            return tau * f0 * t
        # f(u) = f0 / (1 + c u), c = (f0 - f1) / (f1 t1); |.| continues
        # the phase through the pole at u = -1/c
        c = (f0 - f1) / (f1 * t1)
        return tau * (f0 / c) * torch.log(torch.abs(1.0 + c * t))
    raise ValueError(
        "method must be linear, quadratic, logarithmic, or hyperbolic"
    )


def chirp(
    t,
    f0: float,
    t1: float,
    f1: float,
    method: str = "linear",
    phi: float = 0.0,
    vertex_zero: bool = True,
) -> torch.Tensor:
    """Frequency-swept cosine: instantaneous frequency f0 at t=0 and f1
    at t=t1 (scipy.signal.chirp; phi in degrees)."""
    t = as_real_array(t)
    phase = _swept_phase(t, float(f0), float(t1), float(f1), method, vertex_zero)
    return torch.cos(phase + math.radians(float(phi)))


def sweep_poly(t, poly, phi: float = 0.0) -> torch.Tensor:
    """Cosine with instantaneous frequency given by the polynomial
    `poly` (highest power first, np.poly1d convention; phi in degrees).
    The phase polynomial is integrated in float64 on the host."""
    t = as_real_array(t)
    p = np.atleast_1d(np.asarray(poly, np.float64))
    # antiderivative, highest power first: coefficient c_k of t^(n-k)
    n = p.shape[0]
    intp = p / (n - np.arange(n, dtype=np.float64))
    phase = torch.zeros_like(t)
    for c in intp:  # Horner over t * (...) keeps the +0 constant term
        phase = (phase + float(c)) * t
    return torch.cos(2 * math.pi * phase + math.radians(float(phi)))


def gausspulse(
    t,
    fc: float = 1000.0,
    bw: float = 0.5,
    bwr: float = -6.0,
    retquad: bool = False,
    retenv: bool = False,
):
    """Gaussian-modulated sinusoid (scipy.signal.gausspulse): a cosine
    at fc under a Gaussian envelope whose -|bwr| dB fractional bandwidth
    is bw.  Returns yI, optionally with the quadrature (sine) component
    and/or the envelope appended, exactly as scipy orders them."""
    if fc < 0:
        raise ValueError("fc must be >= 0")
    if bw <= 0:
        raise ValueError("bw must be > 0")
    if bwr >= 0:
        raise ValueError("bwr must be < 0 dB")
    t = as_real_array(t)
    ref = math.pow(10.0, bwr / 20.0)
    a = -((math.pi * fc * bw) ** 2) / (4.0 * math.log(ref))
    yenv = torch.exp(-a * t * t)
    arg = 2 * math.pi * fc * t
    yI = yenv * torch.cos(arg)
    out = [yI]
    if retquad:
        out.append(yenv * torch.sin(arg))
    if retenv:
        out.append(yenv)
    return out[0] if len(out) == 1 else tuple(out)


def square(t, duty: float = 0.5) -> torch.Tensor:
    """Square wave with period 2*pi: +1 for the first `duty` fraction of
    each period, -1 for the rest (scipy.signal.square with scalar duty)."""
    t = as_real_array(t)
    duty = float(duty)
    one = torch.ones_like(t)
    return torch.where(torch.remainder(t, 2 * math.pi) < duty * 2 * math.pi, one, -one)


def sawtooth(t, width: float = 1.0) -> torch.Tensor:
    """Sawtooth/triangle wave with period 2*pi rising over the first
    `width` fraction of the period (scipy.signal.sawtooth with scalar
    width; width=1 pure rising ramp, width=0.5 triangle)."""
    t = as_real_array(t)
    width = float(width)
    if not 0.0 <= width <= 1.0:
        raise ValueError("width must be in [0, 1]")
    tmod = torch.remainder(t, 2 * math.pi)
    rise_den = math.pi * width if width > 0 else 1.0
    fall_den = math.pi * (1.0 - width) if width < 1 else 1.0
    rising = tmod / rise_den - 1.0 if width > 0 else -torch.ones_like(t)
    falling = (math.pi * (width + 1.0) - tmod) / fall_den
    return torch.where(tmod < width * 2 * math.pi, rising, falling)


def unit_impulse(shape, idx=None, dtype=None) -> torch.Tensor:
    """Unit impulse delta[n - idx] (scipy.signal.unit_impulse): 1 at idx
    (default 0; 'mid' = centre), 0 elsewhere, on default_device().  dtype:
    a torch or numpy dtype (default: the device's working float)."""
    if isinstance(shape, int):
        shape = (shape,)
    dev = resolve_device()
    if dtype is None:
        dtype = working_float(dev)
    elif not isinstance(dtype, torch.dtype):
        dtype = torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype
    if idx is None:
        idx = (0,) * len(shape)
    elif idx == "mid":
        idx = tuple(s // 2 for s in shape)
    elif isinstance(idx, int):
        idx = (idx,) * len(shape)
    out = torch.zeros(tuple(shape), dtype=dtype, device=dev)
    out[tuple(idx)] = 1
    return out


_MLS_TAPS = {
    # standard primitive-polynomial feedback taps per register size
    # (the classic published table; same sequences as scipy's)
    2: [1], 3: [2], 4: [3], 5: [3], 6: [5], 7: [6], 8: [7, 6, 1], 9: [5],
    10: [7], 11: [9], 12: [11, 10, 4], 13: [12, 11, 8], 14: [13, 12, 2],
    15: [14], 16: [15, 13, 4], 17: [14], 18: [11], 19: [18, 17, 14],
    20: [17], 21: [19], 22: [21], 23: [18], 24: [23, 22, 17], 25: [22],
    26: [25, 24, 20], 27: [26, 25, 22], 28: [25], 29: [27],
    30: [29, 28, 7], 31: [28], 32: [31, 30, 10],
}


def max_len_seq(nbits: int, state=None, length: int | None = None,
                taps=None):
    """Maximum-length (pseudo-random binary) sequence from an nbits-bit
    Fibonacci LFSR (scipy.signal.max_len_seq semantics: returns
    (seq, final_state) as numpy int8; default taps give the full
    2^nbits - 1 period).  The register runs on the host: bit j + nbits of
    the extended sequence is the XOR of bit j and the tap bits j + t, so
    seq = ext[:length] and the final state is ext[length:]."""
    nbits = int(nbits)
    if taps is None:
        if nbits not in _MLS_TAPS:
            raise ValueError(f"nbits must be in {sorted(_MLS_TAPS)} when "
                             "taps is not given")
        taps = _MLS_TAPS[nbits]
    taps = tuple(int(t) for t in taps)
    if any(t <= 0 or t >= nbits for t in taps):
        raise ValueError("taps must lie in (0, nbits)")
    if length is None:
        length = (1 << nbits) - 1
    length = int(length)
    if length < 0:
        raise ValueError("length must be >= 0")
    if state is None:
        state_np = np.ones(nbits, np.int8)
    else:
        state_np = (np.asarray(state) != 0).astype(np.int8)
        if state_np.shape != (nbits,):
            raise ValueError("state must have nbits elements")
        if not state_np.any():
            raise ValueError("state must not be all zeros")
    if length == 0:
        return np.empty(0, np.int8), state_np
    ext = bytearray(length + nbits)
    ext[:nbits] = state_np.tobytes()
    for j in range(length):
        bit = ext[j]
        for t in taps:
            bit ^= ext[j + t]
        ext[j + nbits] = bit
    seq = np.frombuffer(bytes(ext), np.int8)
    return seq[:length].copy(), seq[length:].copy()
