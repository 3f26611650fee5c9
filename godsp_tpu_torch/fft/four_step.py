"""Four-step (Bailey) power-of-2 DFT in plain torch.

Port of godsp_tpu/fft/four_step.py.  It is the plain version behind the
FFT kernels (ops/cuda_fft.py) and the CPU path: the N-point DFT factors
as N = N1 x N2 into column DFTs (matmuls), a twiddle multiply and row
DFTs, recursing until a factor is <= 64 and one dense DFT matrix applies.

The DFT and twiddle tables are built in float64 numpy once per size and
cast to the input's complex dtype on its device.  On CUDA the float32
matmuls must not run in TF32 (about three decimal digits, far below the
120 dB bar): four_step_fft sets torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 to False around its matmuls on the card
and restores both afterwards.
"""

from __future__ import annotations

from contextlib import contextmanager, nullcontext
from functools import lru_cache

import numpy as np
import torch

__all__ = ["four_step_fft", "dft_matrix", "twiddle_2d"]

# Largest factor solved by one direct DFT-matrix multiply.
_DIRECT_N = 64


@lru_cache(maxsize=None)
def dft_matrix(n: int) -> np.ndarray:
    """Dense n-point DFT matrix, float64: F[k, j] = exp(-2i pi k j / n)."""
    k = np.arange(n, dtype=np.float64)
    return np.exp(-2j * np.pi * np.outer(k, k) / n)


@lru_cache(maxsize=None)
def twiddle_2d(n1: int, n2: int) -> np.ndarray:
    """Four-step twiddle table T[i, j] = exp(-2i pi i j / (n1 n2))."""
    i = np.arange(n1, dtype=np.float64)
    j = np.arange(n2, dtype=np.float64)
    return np.exp(-2j * np.pi * np.outer(i, j) / (n1 * n2))


@lru_cache(maxsize=None)
def _const(kind: str, a: int, b: int, inverse: bool, device: torch.device,
           dtype: torch.dtype) -> torch.Tensor:
    tab = dft_matrix(a) if kind == "dft" else twiddle_2d(a, b)
    if inverse:
        tab = np.conj(tab)
    return torch.from_numpy(tab).to(device=device, dtype=dtype)


def _split_factor(n: int) -> tuple[int, int]:
    """n = n1 * n2 with n1 the larger power-of-2 half (n1 >= n2)."""
    l2 = n.bit_length() - 1
    n1 = 1 << (l2 - l2 // 2)
    return n1, n // n1


def _fft_tm(t: torch.Tensor, inverse: bool) -> torch.Tensor:
    """DFT over axis 0 of a (N, B) complex tensor (time-major)."""
    n = t.shape[0]
    dev, dt = t.device, t.dtype
    if n <= _DIRECT_N:
        return _const("dft", n, 0, inverse, dev, dt) @ t

    n1, n2 = _split_factor(n)
    b = t.shape[1]
    tm = t.reshape(n1, n2 * b)  # n = N2*i1 + i2 (row-major)

    # Step 1: DFT over n1.
    if n1 <= _DIRECT_N:
        A = _const("dft", n1, 0, inverse, dev, dt) @ tm
    else:
        A = _fft_tm(tm, inverse)
    # Step 2: twiddle multiply.
    B = A.reshape(n1, n2, b) * _const("tw", n1, n2, inverse, dev, dt)[:, :, None]
    # Step 3: DFT over n2, batch kept minor.
    y = B.permute(1, 0, 2).reshape(n2, n1 * b)
    if n2 <= _DIRECT_N:
        C = _const("dft", n2, 0, inverse, dev, dt) @ y
    else:
        C = _fft_tm(y, inverse)
    # Step 4: output index k = k1 + N1*k2 is C[k2, k1] flattened.
    return C.reshape(n, b)


@contextmanager
def _tf32_off():
    """TF32 off for cuBLAS and cuDNN inside the block, the flags restored after."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def four_step_fft(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Unnormalized DFT of the trailing power-of-2 axis, batched.

    x: (..., N) complex.  inverse conjugates the tables (still
    unnormalized: the callers apply 1/N).
    """
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError(f"four_step_fft requires a power-of-2 length, got {n}")
    if n <= 1:
        return x
    lead = x.shape[:-1]
    t = x.reshape(-1, n).transpose(0, 1)  # (N, B)
    with _tf32_off() if x.is_cuda else nullcontext():
        y = _fft_tm(t, inverse)
    return y.transpose(0, 1).reshape(*lead, n)
