"""Tolerance comparison matching the reference parity definition.

Reference: dsputils/compare.go:23-96.  Two floats are "pretty close" iff
|a-b| <= 1e-8 OR |1 - a/b| <= 1e-8 (absolute-or-relative).  This is the
tolerance that defines output parity for the whole framework, plus an SNR
helper for the >=120 dB BASELINE bound.  Numpy only; CPU tensors convert
through np.asarray (move CUDA tensors to the host first).
"""

from __future__ import annotations

import numpy as np

CLOSE_FACTOR = 1e-8  # compare.go:24

__all__ = [
    "CLOSE_FACTOR",
    "float_equal",
    "complex_equal",
    "pretty_close",
    "pretty_close_c",
    "pretty_close_2",
    "pretty_close_2f",
    "snr_db",
]


def float_equal(a: float, b: float, tol: float = CLOSE_FACTOR) -> bool:
    """|a-b| <= tol or |1 - a/b| <= tol (compare.go:94-96).

    The relative branch divides by b; like the reference, b == 0 falls back
    to the absolute branch (Go yields inf and the comparison is false).
    """
    if abs(a - b) <= tol:
        return True
    if b == 0:
        return False
    return abs(1 - a / b) <= tol


def complex_equal(a: complex, b: complex, tol: float = CLOSE_FACTOR) -> bool:
    """Componentwise float_equal (compare.go:84-91)."""
    return float_equal(a.real, b.real, tol) and float_equal(a.imag, b.imag, tol)


def _pretty_close_arrays(a, b, tol: float) -> bool:
    a = np.asarray(a)
    b = np.asarray(b)
    if a.shape != b.shape:
        return False
    if np.iscomplexobj(a) or np.iscomplexobj(b):
        return _pretty_close_arrays(np.real(a), np.real(b), tol) and _pretty_close_arrays(
            np.imag(a), np.imag(b), tol
        )
    with np.errstate(divide="ignore", invalid="ignore"):
        abs_ok = np.abs(a - b) <= tol
        rel = np.abs(1 - a / b)
        rel_ok = np.where(np.isfinite(rel), rel <= tol, False)
    return bool(np.all(abs_ok | rel_ok))


def pretty_close(a, b, tol: float = CLOSE_FACTOR) -> bool:
    """Vectorized float_equal over same-shape real arrays (compare.go:28-39)."""
    return _pretty_close_arrays(a, b, tol)


def pretty_close_c(a, b, tol: float = CLOSE_FACTOR) -> bool:
    """Vectorized complex_equal over same-shape complex arrays (compare.go:42-53)."""
    return _pretty_close_arrays(a, b, tol)


# The reference lifts the comparators to 2-D by looping rows
# (compare.go:56-81); the vectorized forms already cover any rank.
pretty_close_2 = pretty_close_c
pretty_close_2f = pretty_close


def snr_db(got, want) -> float:
    """Signal-to-noise ratio of `got` vs ground truth `want`, in dB.

    BASELINE parity bound: >= 120 dB (relative RMS error <= 1e-6).
    """
    got = np.asarray(got, dtype=np.complex128)
    want = np.asarray(want, dtype=np.complex128)
    sig = float(np.sum(np.abs(want) ** 2))
    err = float(np.sum(np.abs(got - want) ** 2))
    if err == 0.0:
        return float("inf")
    if sig == 0.0:
        return float("-inf")
    return 10.0 * np.log10(sig / err)
