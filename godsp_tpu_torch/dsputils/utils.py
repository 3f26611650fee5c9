"""L0 primitives: power-of-2 predicates and zero padding.

Port of the part of godsp_tpu/dsputils/utils.py (reference
dsputils/dsputils.go:34-58) that the main path uses; the dtype
conversions live in godsp_tpu_torch/_dtypes.py.  Fractional-overlap
segmentation, detrend and Matrix wait for later slices.
"""

from __future__ import annotations

import math

import torch

from godsp_tpu_torch._dtypes import as_tensor

__all__ = ["is_power_of_2", "next_power_of_2", "zero_pad"]


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
