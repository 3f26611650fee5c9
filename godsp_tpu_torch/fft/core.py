"""Public FFT API: dispatch, inverse, convolution, 2-D transforms.

Port of godsp_tpu/fft/core.py (reference fft/fft.go).  Semantics kept:

  * dispatch by length: <=1 copy-through, power-of-2 through fft/pow2.py
    (the CUDA kernels or the plain four-step), else Bluestein
    (fft.go:72-87);
  * the 1/N normalization lives on the inverse only (fft.go:35-52); the
    inverse of a non-pow-2 length is index reversal + forward FFT;
  * fft_real returns the FULL N-bin spectrum of a real input
    (fft.go:25-27);
  * ValueError where the reference panics (Convolve unequal lengths
    fft.go:56-58; FFT2 empty/ragged fft.go:125-134);
  * fftn/ifftn over a Matrix or tensor: one batched 1-D pass per axis in
    place of the reference's per-lane odometer (fft.go:157-224).

Everything batches over leading axes and runs on the input's device;
host input (numpy, lists, a Matrix's array) goes to default_device().
"""

from __future__ import annotations

import torch

from godsp_tpu_torch._dtypes import as_complex_array, as_real_array, as_tensor
from godsp_tpu_torch.dsputils.matrix import Matrix
from godsp_tpu_torch.dsputils.utils import is_power_of_2
from godsp_tpu_torch.fft.bluestein import bluestein_fft
from godsp_tpu_torch.fft.pow2 import kernel_route, pow2_convolve, pow2_fft
from godsp_tpu_torch.fft.stockham import ensure_radix2_factors
from godsp_tpu_torch.ops import cuda_fft

__all__ = [
    "convolve",
    "ensure_radix2_factors",
    "fft",
    "fft2",
    "fft2_real",
    "fft_real",
    "fftn",
    "ifft",
    "ifft2",
    "ifft2_real",
    "ifft_real",
    "ifftn",
]


def _fft_last(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    if n <= 1:
        return x
    if is_power_of_2(n):
        return pow2_fft(x)
    return bluestein_fft(x)


def fft(x, axis: int = -1) -> torch.Tensor:
    """Forward DFT along `axis` (default trailing), batched over the rest
    (fft.go:72-87)."""
    x = as_complex_array(x)
    return _fft_last(x.movedim(axis, -1)).movedim(-1, axis)


def ifft(x, axis: int = -1) -> torch.Tensor:
    """Inverse DFT along `axis` with 1/N (fft.go:35-52)."""
    x = as_complex_array(x).movedim(axis, -1)
    n = x.shape[-1]
    if n <= 1:
        return x.movedim(-1, axis)
    if is_power_of_2(n):
        # Conjugate-table inverse: the same sum as the reference's index
        # reversal + forward FFT, with 1/N folded into the transform.
        return pow2_fft(x, inverse=True, scale=1.0 / n).movedim(-1, axis)
    # y[0] = x[0], y[i] = x[n-i]  (fft.go:39-43)
    rev = torch.roll(torch.flip(x, dims=(-1,)), 1, dims=-1)
    return (_fft_last(rev) / n).movedim(-1, axis)


def fft_real(x, axis: int = -1) -> torch.Tensor:
    """FFT of real input; returns the full N-bin complex spectrum
    (fft.go:25-27).  On CUDA, power-of-2 sizes up to 16384 take the
    kernel's real-input mode (one plane read); larger ones the complex
    large plan, as godsp_tpu's _fft_real_jit does."""
    x = as_tensor(x)
    if x.dtype.is_complex:
        return fft(x, axis)
    x = as_real_array(x).movedim(axis, -1)
    n = x.shape[-1]
    if cuda_fft.supported_size(n) and kernel_route(x):
        yr, yi = cuda_fft.fft_pow2(x, None)
        return torch.complex(yr, yi).movedim(-1, axis)
    return fft(x, -1).movedim(-1, axis)


def ifft_real(x, axis: int = -1) -> torch.Tensor:
    """IFFT of real input (fft.go:30-32): conj(FFT(x))/N for real x."""
    x = as_tensor(x)
    if not x.dtype.is_complex and x.shape[axis] > 1:
        return torch.conj(fft_real(x, axis)) / x.shape[axis]
    return ifft(x, axis)


def convolve(x, y) -> torch.Tensor:
    """Circular convolution of equal-length arrays via FFT (fft.go:55-69).

    Batched over leading axes; raises ValueError where the reference
    panics on unequal trailing lengths.
    """
    x = as_complex_array(x)
    y = as_complex_array(y, device=x.device)
    if x.shape[-1] != y.shape[-1]:
        raise ValueError("arrays not of equal size")
    n = x.shape[-1]
    if n > 1 and is_power_of_2(n):
        x, y = torch.broadcast_tensors(x, y)
        return pow2_convolve(x, y, scale=1.0 / n)
    return ifft(fft(x) * fft(y))


def _as_2d(x) -> torch.Tensor:
    """Validate a (possibly nested-list) 2-D input; raises on ragged rows
    (fft.go:129-134)."""
    if isinstance(x, (list, tuple)):
        if len(x) == 0:
            raise ValueError("empty input array")
        width = len(x[0])
        for row in x:
            if len(row) != width:
                raise ValueError("ragged input array")
    arr = as_tensor(x)
    if arr.dim() != 2:
        raise ValueError("fft2 requires a 2-D input")
    if arr.shape[0] == 0 or arr.shape[1] == 0:
        raise ValueError("empty input array")  # fft.go:125-127
    return arr


def fft2(x) -> torch.Tensor:
    """2-D forward DFT (fft.go:109-111): column pass, then row pass."""
    return fft(fft(_as_2d(x), axis=0), axis=1)


def ifft2(x) -> torch.Tensor:
    """2-D inverse DFT (fft.go:119-121)."""
    return ifft(ifft(_as_2d(x), axis=0), axis=1)


def fft2_real(x) -> torch.Tensor:
    """2-D DFT of real input (fft.go:104-106)."""
    return fft2(x)


def ifft2_real(x) -> torch.Tensor:
    """2-D inverse DFT of real input (fft.go:114-116)."""
    return ifft2(x)


def _fftn_impl(m, inverse: bool):
    is_matrix = isinstance(m, Matrix)
    arr = as_complex_array(m.array if is_matrix else m)
    op = ifft if inverse else fft
    for axis in range(arr.dim()):
        arr = op(arr, axis=axis)
    if is_matrix:
        return Matrix.from_array(arr.cpu().numpy())
    return arr


def fftn(m):
    """N-D forward DFT over a Matrix or array (fft.go:157-159).  A Matrix
    comes back as a (host) Matrix; its array runs on default_device()."""
    return _fftn_impl(m, inverse=False)


def ifftn(m):
    """N-D inverse DFT over a Matrix or array (fft.go:162-164)."""
    return _fftn_impl(m, inverse=True)
