"""N-D Matrix container (reference dsputils/matrix.go:21-216).

Port of godsp_tpu/dsputils/matrix.py, kept as its own copy (the port
imports nothing of godsp_tpu).  The reference wraps a flat []complex128
with row-major strides so lanes along any axis can be gathered/scattered
one at a time.  Here, as in godsp_tpu, it is a HOST-side container
(numpy-backed): scalar and lane mutation happen on the host, and the
transforms (fft.fftn/ifftn) move `array` to the device once
(default_device(), the card) and run one batched pass per axis instead of
per-lane gathers.  A Matrix built from godsp_tpu's Matrix's `.array` and
dimensions holds the same numpy array.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from godsp_tpu_torch.dsputils.compare import CLOSE_FACTOR, pretty_close_c

__all__ = ["Matrix", "make_matrix", "make_matrix_2", "make_empty_matrix"]


class Matrix:
    """Multidimensional matrix of fixed size and dimension (matrix.go:21-25)."""

    def __init__(self, flat, dims: Sequence[int]):
        dims = tuple(int(d) for d in dims)
        if any(d < 1 for d in dims):
            raise ValueError("invalid dimensions")
        length = 1
        offsets = [0] * len(dims)
        for i in range(len(dims) - 1, -1, -1):  # row-major strides, matrix.go:41-48
            offsets[i] = length
            length *= dims[i]
        flat = np.asarray(flat).reshape(-1)
        if not np.iscomplexobj(flat):
            flat = flat.astype(np.complex128)
        else:
            flat = flat.copy()
        if flat.shape[0] != length:
            raise ValueError("incorrect dimensions")
        self._flat = flat
        self._dims = dims
        self._offsets = tuple(offsets)

    # -- constructors -------------------------------------------------
    @classmethod
    def from_array(cls, arr) -> "Matrix":
        arr = np.asarray(arr)
        return cls(arr.reshape(-1), arr.shape)

    # -- views --------------------------------------------------------
    @property
    def array(self) -> np.ndarray:
        """The matrix as a shaped array — what the device transforms consume."""
        return self._flat.reshape(self._dims)

    @property
    def flat(self) -> np.ndarray:
        return self._flat

    def dimensions(self) -> list[int]:
        """Copy of the dims array (matrix.go:144-149)."""
        return list(self._dims)

    def copy(self) -> "Matrix":
        """New copy of the matrix (matrix.go:75-81)."""
        return Matrix(self._flat, self._dims)

    # -- scalar access (matrix.go:179-187) -----------------------------
    def _offset(self, dims: Sequence[int]) -> int:
        # Exact reproduction of matrix.go:93-108, including its quirks:
        # the bound check is `v > dims[n]` (not >=) and negative indices
        # are accepted (matrix_test.go passes -1 to SetValue).
        if len(dims) != len(self._dims):
            raise ValueError("incorrect dimensions")
        i = 0
        for n, v in enumerate(dims):
            if v > self._dims[n]:
                raise ValueError("incorrect dimensions")
            i += v * self._offsets[n]
        return i

    def value(self, dims: Sequence[int]) -> complex:
        return complex(self._flat[self._offset(dims)])

    def set_value(self, x: complex, dims: Sequence[int]) -> None:
        self._flat[self._offset(dims)] = x

    # -- lane access (matrix.go:110-175) --------------------------------
    def _indexes(self, dims: Sequence[int]) -> np.ndarray:
        i = -1
        for n, v in enumerate(dims):
            if v == -1:
                if i >= 0:
                    raise ValueError("only one dimension index allowed")
                i = n
            elif v >= self._dims[n]:
                raise ValueError("dimension out of bounds")
        if i == -1:
            raise ValueError("must specify one dimension index")
        x = sum(self._offsets[n] * v for n, v in enumerate(dims) if v >= 0)
        return x + self._offsets[i] * np.arange(self._dims[i])

    def dim(self, dims: Sequence[int]) -> np.ndarray:
        """The lane along the single -1 axis (matrix.go:151-163)."""
        return self._flat[self._indexes(dims)]

    def set_dim(self, x, dims: Sequence[int]) -> None:
        inds = self._indexes(dims)
        x = np.asarray(x)
        if x.shape[0] != inds.shape[0]:
            raise ValueError("incorrect array length")
        self._flat[inds] = x

    # -- conversions / comparison ---------------------------------------
    def to_2d(self) -> list[list[complex]]:
        """2-D nested-list equivalent (matrix.go:191-204)."""
        if len(self._dims) != 2:
            raise ValueError("can only convert 2-D Matrixes")
        return self.array.tolist()

    def pretty_close(self, other: "Matrix", tol: float = CLOSE_FACTOR) -> bool:
        """Tolerance comparison (matrix.go:207-216)."""
        if self._dims != other._dims:
            return False
        return pretty_close_c(self._flat, other._flat, tol)

    def __repr__(self) -> str:
        return f"Matrix(dims={self._dims})"


def make_matrix(x, dims: Sequence[int]) -> Matrix:
    """New Matrix populated with x having dimensions dims (matrix.go:27-55)."""
    return Matrix(x, dims)


def make_matrix_2(x) -> Matrix:
    """2-D array to Matrix (matrix.go:58-71); raises on ragged input."""
    rows = [np.asarray(r) for r in x]
    w = rows[0].shape[0]
    if any(r.shape[0] != w for r in rows):
        raise ValueError("ragged array")
    return Matrix(np.concatenate(rows), (len(rows), w))


def make_empty_matrix(dims: Sequence[int]) -> Matrix:
    """Zero-filled Matrix of the given dims (matrix.go:84-91)."""
    n = int(np.prod(dims))
    return Matrix(np.zeros(n, dtype=np.complex128), dims)
