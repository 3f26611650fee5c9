"""L0 primitives: conversion, padding, predicates, segmentation, detrend.

Port of godsp_tpu/dsputils/utils.py (reference dsputils/dsputils.go:25-115,
plus scipy.signal.detrend).  Predicates and segment geometry are
host-side Python; tensor ops batch over leading axes and run on the
tensor's device.
"""

from __future__ import annotations

import math

import torch

from godsp_tpu_torch._dtypes import _cuda_cast, as_complex_array, as_tensor, working_float

__all__ = [
    "detrend",
    "to_complex",
    "to_complex_2",
    "is_power_of_2",
    "next_power_of_2",
    "zero_pad",
    "zero_pad_f",
    "zero_pad_2",
    "segment",
    "segment_bounds",
]


def to_complex(x) -> torch.Tensor:
    """Complex equivalent of a real-valued array (dsputils.go:25-31).

    Works on any rank; the reference is 1-D only.
    """
    return as_complex_array(x)


def to_complex_2(x) -> torch.Tensor:
    """Complex equivalent of a real-valued matrix (dsputils.go:77-84)."""
    return as_complex_array(x)


def is_power_of_2(x: int) -> bool:
    """True if x is a power of 2 (dsputils.go:34-36).

    Reproduces the reference quirk that 0 reports true (x & (x-1) == 0).
    """
    return x & (x - 1) == 0


def next_power_of_2(x: int) -> int:
    """Next power of 2 >= x (dsputils.go:39-45)."""
    if is_power_of_2(x):
        return x
    return int(2 ** math.ceil(math.log2(x)))


def zero_pad(x, length: int) -> torch.Tensor:
    """x zero-padded along the last axis to `length` (dsputils.go:49-58).

    If the last axis is already >= length the input is returned unchanged.
    """
    x = as_tensor(x)
    n = x.shape[-1]
    if n >= length:
        return x
    return torch.nn.functional.pad(x, (0, length - n))


# The reference splits complex/real padding into ZeroPad/ZeroPadF
# (dsputils.go:49-70); torch's pad is dtype-generic so both are one function.
zero_pad_f = zero_pad


def zero_pad_2(x) -> torch.Tensor:
    """Zero-pad the last axis to the next power of 2 (dsputils.go:72-75)."""
    x = as_tensor(x)
    return zero_pad(x, next_power_of_2(x.shape[-1]))


def segment_bounds(lx: int, segs: int, noverlap: float) -> tuple[int, int]:
    """(length, step) for fractional-overlap segmentation.

    Exact reproduction of the geometry search in dsputils.Segment
    (dsputils.go:94-106): find the largest `length` such that
    segs*(length - overlap) + overlap <= lx with overlap = int(length*noverlap);
    trailing samples that don't fit are discarded.
    Raises ValueError where the reference panics ("too many segments").
    """
    def tot(length: int) -> int:
        overlap = int(length * noverlap)
        return segs * (length - overlap) + overlap

    # tot(length) is strictly increasing for noverlap in [0, 1] (overlap
    # grows by at most 1 per unit of length), so the reference's linear
    # descending scan (dsputils.go:94-101) is equivalent to a binary
    # search for the largest length with tot(length) <= lx.
    lo, hi = 1, lx  # search over [1, lx]
    if lx < 1 or tot(1) > lx:
        raise ValueError("too many segments")
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if tot(mid) <= lx:
            lo = mid
        else:
            hi = mid - 1
    length = lo
    return length, length - int(length * noverlap)


def segment(x, segs: int, noverlap: float) -> torch.Tensor:
    """segs equal-length overlapping segments of x (dsputils.go:89-115).

    noverlap is a fraction in [0, 1]; 0.5 = 50% overlap.  Returns a stacked
    (..., segs, length) tensor (the reference returns aliased sub-slices;
    values are identical).
    """
    x = as_tensor(x)
    length, step = segment_bounds(x.shape[-1], segs, noverlap)
    idx = (torch.arange(segs, device=x.device)[:, None] * step
           + torch.arange(length, device=x.device)[None, :])
    return x[..., idx]


def detrend(x, type: str = "linear", axis: int = -1) -> torch.Tensor:
    """Remove the mean ('constant') or least-squares line ('linear')
    along `axis` (scipy.signal.detrend with its default single segment).

    The linear fit uses the closed-form centered-time solution
    slope = sum((t - t̄) x) / sum((t - t̄)²), identical to the lstsq fit
    scipy runs: two reductions and no matmul (so no TF32 on the card);
    it batches over the other axes."""
    if type not in ("linear", "l", "constant", "c"):
        raise ValueError("type must be 'linear' or 'constant'")
    x = as_tensor(x)
    if not (x.dtype.is_floating_point or x.dtype.is_complex):
        x = x.to(working_float(x.device))
    x = _cuda_cast(x)
    if type in ("constant", "c"):
        return x - torch.mean(x, dim=axis, keepdim=True)
    x = torch.movedim(x, axis, -1)
    n = x.shape[-1]
    t = torch.arange(n, dtype=x.real.dtype, device=x.device) - (n - 1) / 2.0
    denom = torch.sum(t * t)
    xm = torch.mean(x, dim=-1, keepdim=True)
    slope = torch.sum(t * x, dim=-1, keepdim=True) / denom
    return torch.movedim(x - xm - slope * t, -1, axis)
