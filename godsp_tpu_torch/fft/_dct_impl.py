"""Discrete cosine and sine transforms over the port's FFT core.

Port of godsp_tpu/fft/_dct_impl.py.  All eight real trig transforms
(DCT/DST types 1-4, scipy.fft conventions) go through the complex FFT of
fft/core.py: DCT-II by Makhoul's same-length reorder and phase, DCT-I and
DST-I by even and odd extensions, DCT-IV by a zero-padded 2N-point FFT
with phase twists, and the DST types by the alternating-sign and
reversal relations to their DCT twins.  So power-of-2 lengths ride the
Hopper kernels on the card (K1/K2, the large plan above 16384) and other
lengths Bluestein over them; no new kernel and no matmul (no TF32).

  DCT-II:  y[k] = 2 * sum_n x[n] cos(pi k (2n+1) / (2N))
           = 2 Re(e^{-i pi k / 2N} FFT(reorder(x))[k]),
           reorder = [x0, x2, ..., x3, x1] (Makhoul's N-point method).
  norm="ortho" matches scipy.fft.dct(..., norm="ortho").

The phase tables are built in float64 numpy and cast once to the input's
complex dtype on its device.  Batched over leading axes; host input goes
to default_device(), CUDA float64 is cast to float32.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from godsp_tpu_torch._dtypes import as_real_array, as_tensor, complex_for
from godsp_tpu_torch.fft.core import fft, ifft

__all__ = ["dct", "dctn", "dst", "dstn", "idct", "idctn", "idst", "idstn"]


@lru_cache(maxsize=None)
def _phase(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """e^{-i pi k / (2N)}, built in float64."""
    k = np.arange(n, dtype=np.float64)
    return torch.from_numpy(np.exp(-1j * np.pi * k / (2.0 * n))).to(device=device, dtype=dtype)


@lru_cache(maxsize=None)
def _phase4(n: int, dtype: torch.dtype, device: torch.device):
    """DCT-IV phases: the input twist e^{-i pi n/(2N)} and the output twist
    e^{-i pi (2k+1)/(4N)}, built in float64."""
    m = np.arange(n, dtype=np.float64)
    a = np.exp(-1j * np.pi * m / (2.0 * n))
    b = np.exp(-1j * np.pi * (2.0 * m + 1.0) / (4.0 * n))
    return (torch.from_numpy(a).to(device=device, dtype=dtype),
            torch.from_numpy(b).to(device=device, dtype=dtype))


def _ortho_scale(n: int, x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """DCT-II's orthonormal factors (1/sqrt(4N) at k = 0, 1/sqrt(2N) after),
    or their reciprocals."""
    s = torch.full((n,), 2.0 * n, dtype=torch.float64)
    s[0] = 4.0 * n
    s = s.sqrt() if inverse else s.rsqrt()
    return s.to(device=x.device, dtype=x.dtype)


def _dct2(x: torch.Tensor, norm) -> torch.Tensor:
    n = x.shape[-1]
    cdt = complex_for(x.dtype)
    # Makhoul reorder: even indices ascending, odd indices descending.
    v = torch.cat([x[..., 0::2], x[..., 1::2].flip(-1)], dim=-1)
    V = fft(v.to(cdt))
    y = 2.0 * (_phase(n, cdt, x.device) * V).real
    if norm == "ortho":
        y = y * _ortho_scale(n, y, inverse=False)
    return y


def _dct3(y: torch.Tensor, norm) -> torch.Tensor:
    n = y.shape[-1]
    if norm == "ortho":  # undo the forward's ortho scaling: the raw-2x DCT
        y = y * _ortho_scale(n, y, inverse=True)
    cdt = complex_for(y.dtype)
    # The spectrum of the reordered sequence, inverse FFT, undo the reorder.
    yk = y.to(cdt)
    y_rev = torch.cat([torch.zeros_like(yk[..., :1]), -1j * yk[..., 1:].flip(-1)], dim=-1)
    v = ifft((yk + y_rev) / (2.0 * _phase(n, cdt, y.device))).real.to(y.dtype)
    half = (n + 1) // 2
    out = torch.empty_like(v)
    out[..., 0::2] = v[..., :half]
    out[..., 1::2] = v[..., half:].flip(-1)
    return out


def _dct1(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized DCT-I: the real part of the FFT of the even extension
    [x0..x_{N-1}, x_{N-2}..x1] (length 2N-2)."""
    n = x.shape[-1]
    ext = torch.cat([x, x[..., 1 : n - 1].flip(-1)], dim=-1)
    return fft(ext.to(complex_for(x.dtype))).real[..., :n].to(x.dtype)


def _dct4(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized DCT-IV: y[k] = 2 sum x[n] cos(pi(2n+1)(2k+1)/(4N)), one
    zero-padded 2N-point FFT with pre and post phase twists (pow-2 N keeps
    the kernel route: 2N is pow-2 too)."""
    n = x.shape[-1]
    cdt = complex_for(x.dtype)
    pre, post = _phase4(n, cdt, x.device)
    v = torch.nn.functional.pad(x.to(cdt) * pre, (0, n))
    return (2.0 * (post * fft(v)[..., :n]).real).to(x.dtype)


def _dst1(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized DST-I: -imag of the FFT of the odd extension
    [0, x, 0, -reverse(x)] (length 2N+2), bins 1..N."""
    n = x.shape[-1]
    z = torch.zeros_like(x[..., :1])
    ext = torch.cat([z, x, z, -x.flip(-1)], dim=-1)
    return (-fft(ext.to(complex_for(x.dtype))).imag[..., 1 : n + 1]).to(x.dtype)


def _alt(x: torch.Tensor) -> torch.Tensor:
    """x[n] * (-1)^n."""
    s = torch.ones(x.shape[-1], dtype=x.dtype, device=x.device)
    s[1::2] = -1.0
    return x * s


def _sqrt2_scale(x: torch.Tensor, idx: int, up: bool) -> torch.Tensor:
    y = x.clone()
    y[..., idx] *= np.sqrt(2.0) if up else np.sqrt(0.5)
    return y


def _cos_sin_transform(x: torch.Tensor, type: int, norm, sine: bool) -> torch.Tensor:
    """Shared DCT/DST dispatch.  The DST types reduce to the DCT of the
    alternating-sign input with reversed output:
    DST-t(x)[k] = DCT-t((-1)^n x[n])[N-1-k] for t in {2, 4} (and the
    transposed relation for t = 3); DST-I has its own odd extension."""
    n = x.shape[-1]
    if not sine:
        if type == 1:
            if n < 2:
                raise ValueError("DCT-I requires at least 2 points")
            if norm == "ortho":
                x = _sqrt2_scale(_sqrt2_scale(x, 0, True), n - 1, True)
            y = _dct1(x)
            if norm == "ortho":
                y = y / np.sqrt(2.0 * (n - 1))
                y = _sqrt2_scale(_sqrt2_scale(y, 0, False), n - 1, False)
            return y
        if type == 2:
            return _dct2(x, norm)
        if type == 3:
            # standalone forward DCT-III = 2N * the unnormalized inverse
            if norm == "ortho":
                return _dct3(_sqrt2_scale(x, 0, True), None) * (2.0 * n / np.sqrt(2.0 * n))
            return _dct3(x, None) * (2.0 * n)
        y = _dct4(x)
        return y / np.sqrt(2.0 * n) if norm == "ortho" else y
    if type == 1:
        y = _dst1(x)
        return y / np.sqrt(2.0 * (n + 1)) if norm == "ortho" else y
    if type == 2:
        y = _dct2(_alt(x), None).flip(-1)
        if norm == "ortho":
            y = _sqrt2_scale(y / np.sqrt(2.0 * n), n - 1, False)
        return y
    if type == 3:
        if norm == "ortho":
            x = _sqrt2_scale(x, n - 1, True)
            return _alt(_dct3(x.flip(-1), None)) * (2.0 * n / np.sqrt(2.0 * n))
        return _alt(_dct3(x.flip(-1), None)) * (2.0 * n)
    y = _dct4(_alt(x)).flip(-1)
    return y / np.sqrt(2.0 * n) if norm == "ortho" else y


def _check_transform_args(x, type: int, norm) -> torch.Tensor:
    if type not in (1, 2, 3, 4):
        raise ValueError("type must be 1, 2, 3, or 4")
    if norm not in (None, "ortho"):
        raise ValueError(f"unknown norm: {norm}")
    x = as_tensor(x)
    if x.dtype.is_complex:
        raise ValueError("real-input transform expects real input")
    return as_real_array(x)


_INVERSE_TYPE = {1: 1, 2: 3, 3: 2, 4: 4}


def dct(x, type: int = 2, norm: str | None = None) -> torch.Tensor:
    """DCT of the trailing axis, types 1-4 (scipy.fft.dct semantics:
    norm=None is the unnormalized 2x convention, "ortho" orthonormal)."""
    x = _check_transform_args(x, type, norm)
    if x.shape[-1] == 0:
        return x
    return _cos_sin_transform(x, int(type), norm, sine=False)


def idct(y, type: int = 2, norm: str | None = None) -> torch.Tensor:
    """Inverse DCT (scipy.fft.idct): the exact inverse of dct with the
    same type and norm; types 2 and 3 are each other's transposes, types
    1 and 4 self-inverse up to scaling."""
    y = _check_transform_args(y, type, norm)
    n = y.shape[-1]
    if n == 0:
        return y
    type = int(type)
    if norm == "ortho":
        return _cos_sin_transform(y, _INVERSE_TYPE[type], "ortho", sine=False)
    if type == 2:
        # scipy.fft's backward norm makes idct the exact inverse of dct.
        return _dct3(y, None)
    if type == 3:
        return _dct2(y, None) * (0.5 / n)
    if type == 4:
        return _dct4(y) * (0.5 / n)
    return _dct1(y) * (0.5 / (n - 1))


def dst(x, type: int = 2, norm: str | None = None) -> torch.Tensor:
    """DST of the trailing axis, types 1-4 (scipy.fft.dst semantics)."""
    x = _check_transform_args(x, type, norm)
    if x.shape[-1] == 0:
        return x
    return _cos_sin_transform(x, int(type), norm, sine=True)


def idst(y, type: int = 2, norm: str | None = None) -> torch.Tensor:
    """Inverse DST (scipy.fft.idst): the exact inverse of dst with the same
    type and norm."""
    y = _check_transform_args(y, type, norm)
    n = y.shape[-1]
    if n == 0:
        return y
    type = int(type)
    inv = _INVERSE_TYPE[type]
    if norm == "ortho":
        return _cos_sin_transform(y, inv, "ortho", sine=True)
    den = 2.0 * (n + 1) if type == 1 else 2.0 * n
    return _cos_sin_transform(y, inv, None, sine=True) * (1.0 / den)


def _apply_along_axes(fn, x: torch.Tensor, axes) -> torch.Tensor:
    for ax in axes:
        x = fn(x.movedim(ax, -1)).movedim(-1, ax)
    return x


def _norm_axes(x: torch.Tensor, axes) -> tuple[int, ...]:
    if axes is None:
        return tuple(range(x.dim()))
    if isinstance(axes, int):
        axes = (axes,)
    out = tuple(int(a) % x.dim() for a in axes)
    if len(set(out)) != len(out):
        raise ValueError("all axes must be unique")
    return out


def dctn(x, type: int = 2, axes=None, norm: str | None = None) -> torch.Tensor:
    """N-D DCT: the 1-D transform over each axis in `axes` (scipy.fft.dctn
    semantics; axes=None -> all)."""
    x = _check_transform_args(x, type, norm)
    return _apply_along_axes(lambda v: dct(v, type, norm), x, _norm_axes(x, axes))


def idctn(x, type: int = 2, axes=None, norm: str | None = None) -> torch.Tensor:
    """N-D inverse DCT (scipy.fft.idctn)."""
    x = _check_transform_args(x, type, norm)
    return _apply_along_axes(lambda v: idct(v, type, norm), x, _norm_axes(x, axes))


def dstn(x, type: int = 2, axes=None, norm: str | None = None) -> torch.Tensor:
    """N-D DST (scipy.fft.dstn)."""
    x = _check_transform_args(x, type, norm)
    return _apply_along_axes(lambda v: dst(v, type, norm), x, _norm_axes(x, axes))


def idstn(x, type: int = 2, axes=None, norm: str | None = None) -> torch.Tensor:
    """N-D inverse DST (scipy.fft.idstn)."""
    x = _check_transform_args(x, type, norm)
    return _apply_along_axes(lambda v: idst(v, type, norm), x, _norm_axes(x, axes))
