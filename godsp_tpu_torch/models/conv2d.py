"""2-D convolution / correlation and image-style filtering.

Port of godsp_tpu/models/conv2d.py (scipy.signal semantics):
convolve2d/correlate2d (mode full/same/valid, boundary fill/wrap/symm),
wiener (local-statistics adaptive filter), hilbert2 (2-D analytic
signal), sepfir2d, order_filter and medfilt2d.  Leading batch axes are a
framework extension (scipy is strictly 2-D).

Both operands zero-pad to powers of two and run one separable 2-D
circular convolution (fft/pow2.py pow2_convolve2): on the card K1
forward and K2 inverse over rows and columns, never a cuDNN convolution
(cuDNN would run TF32).  The boundary extensions are built by index with
numpy's np.pad rules ('wrap' periodic, 'symmetric' mirrored with the
edge sample repeated), which hold for pads longer than the axis too;
torch's F.pad has neither ('reflect' drops the edge sample, 'circular'
takes no pad past the axis).
"""

from __future__ import annotations

import numpy as np
import torch

from godsp_tpu_torch._dtypes import (
    _cuda_cast,
    as_complex_array,
    as_tensor,
    working_float,
)
from godsp_tpu_torch.dsputils.utils import next_power_of_2
from godsp_tpu_torch.fft.pow2 import pow2_convolve2

__all__ = ["convolve2d", "correlate2d", "hilbert2", "medfilt2d", "order_filter", "sepfir2d",
           "wiener"]

_BOUNDARY_PAD = {"fill": "constant", "wrap": "wrap", "symm": "symmetric"}


def _pad_index(s: int, before: int, after: int, mode: str, device) -> torch.Tensor:
    """Source index of every sample of an axis of s samples extended by
    (before, after), as np.pad(mode='wrap'|'symmetric') extends it."""
    i = torch.arange(-before, s + after, device=device)
    if mode == "wrap":
        return torch.remainder(i, s)
    j = torch.remainder(i, 2 * s)
    return torch.where(j >= s, 2 * s - 1 - j, j)


def _pad2(a: torch.Tensor, p1: int, p2: int, mode: str, fill=0.0) -> torch.Tensor:
    """np.pad of the two trailing axes by (p1, p1), (p2, p2) in `mode`:
    'constant' (with fill), 'wrap' or 'symmetric'."""
    if mode == "constant":
        out = torch.full((*a.shape[:-2], a.shape[-2] + 2 * p1, a.shape[-1] + 2 * p2), fill,
                         dtype=a.dtype, device=a.device)
        out[..., p1 : p1 + a.shape[-2], p2 : p2 + a.shape[-1]] = a
        return out
    rows = _pad_index(a.shape[-2], p1, p1, mode, a.device)
    cols = _pad_index(a.shape[-1], p2, p2, mode, a.device)
    return a.index_select(-2, rows).index_select(-1, cols)


def _same_origin(k: int, flip: bool) -> int:
    # correlation's 'same' window is the mirror of convolution's (the
    # kernel flip mirrors the centering remainder for even sizes)
    return k // 2 if flip else (k - 1) // 2


def _crop(full: torch.Tensor, s1: int, s2: int, k1: int, k2: int, mode: str,
          flip: bool) -> torch.Tensor:
    if mode == "same":
        r0, c0 = _same_origin(k1, flip), _same_origin(k2, flip)
        return full[..., r0 : r0 + s1, c0 : c0 + s2]
    if mode == "valid":
        return full[..., k1 - 1 : s1, k2 - 1 : s2]
    return full


def _conv2_full(a: torch.Tensor, b: torch.Tensor, mode: str, real_out: bool,
                flip: bool) -> torch.Tensor:
    s1, s2 = a.shape[-2], a.shape[-1]
    k1, k2 = b.shape[-2], b.shape[-1]
    n1 = next_power_of_2(s1 + k1 - 1)
    n2 = next_power_of_2(s2 + k2 - 1)
    ac, bc = as_complex_array(a), as_complex_array(b)
    cdt = torch.promote_types(ac.dtype, bc.dtype)
    ac = torch.nn.functional.pad(ac.to(cdt), (0, n2 - s2, 0, n1 - s1))
    bc = torch.nn.functional.pad(bc.to(cdt), (0, n2 - k2, 0, n1 - k1))
    full = pow2_convolve2(ac, bc, scale=1.0 / (n1 * n2))
    full = _crop(full[..., : s1 + k1 - 1, : s2 + k2 - 1], s1, s2, k1, k2, mode, flip)
    return full.real if real_out else full


def _conv2_boundary(a, b, mode: str, real_out: bool, flip: bool, pad_mode: str, fill):
    """Boundary-extended convolution: pad, full convolution of the padded
    problem, cut back to the original full window, then the mode crop."""
    s1, s2 = a.shape[-2], a.shape[-1]
    k1, k2 = b.shape[-2], b.shape[-1]
    a_p = _pad2(a, k1 - 1, k2 - 1, pad_mode, fill)
    full_p = _conv2_full(a_p, b, "full", real_out, flip)
    full = full_p[..., k1 - 1 : k1 - 1 + s1 + k1 - 1, k2 - 1 : k2 - 1 + s2 + k2 - 1]
    return _crop(full, s1, s2, k1, k2, mode, flip)


def _conv2(in1, in2, mode: str, boundary: str, fillvalue, flip: bool):
    if mode not in ("full", "same", "valid"):
        raise ValueError(f"unknown mode: {mode}")
    if boundary not in _BOUNDARY_PAD:
        raise ValueError("boundary must be 'fill', 'wrap', or 'symm'")
    a = _cuda_cast(as_tensor(in1))
    b = _cuda_cast(as_tensor(in2, device=a.device))
    if a.dim() < 2 or b.dim() < 2:
        raise ValueError("inputs must be at least 2-D")
    s1, s2 = a.shape[-2], a.shape[-1]
    k1, k2 = b.shape[-2], b.shape[-1]
    if min(s1, s2, k1, k2) == 0:
        raise ValueError("empty input")
    if mode == "valid" and (s1 < k1 or s2 < k2):
        raise ValueError("valid mode needs in1 at least as large as in2 "
                         "in every dimension")
    if flip:
        b = b.flip((-2, -1))
        if b.dtype.is_complex:
            b = b.conj().resolve_conj()
    fv = np.asarray(fillvalue)
    if fv.size != 1:
        raise ValueError("fillvalue must be a scalar")
    real_out = not a.dtype.is_complex and not b.dtype.is_complex
    if boundary != "fill" or bool(fv.ravel()[0] != 0):
        f0 = fv.ravel()[0]
        fill = (complex(f0) if a.dtype.is_complex else float(f0.real)) \
            if boundary == "fill" else 0.0
        return _conv2_boundary(a, b, mode, real_out, flip, _BOUNDARY_PAD[boundary], fill)
    return _conv2_full(a, b, mode, real_out, flip)


def convolve2d(in1, in2, mode: str = "full", boundary: str = "fill",
               fillvalue=0) -> torch.Tensor:
    """2-D linear convolution (scipy.signal.convolve2d semantics):
    mode 'full'/'same'/'valid'; boundary 'fill' (pad with fillvalue),
    'wrap' (circular), or 'symm' (symmetric reflection).  One separable
    FFT convolution; leading axes batch; in2 follows in1's device."""
    return _conv2(in1, in2, mode, boundary, fillvalue, flip=False)


def correlate2d(in1, in2, mode: str = "full", boundary: str = "fill",
                fillvalue=0) -> torch.Tensor:
    """2-D cross-correlation (scipy.signal.correlate2d): convolution with
    the doubly-reversed conjugate kernel, same mode/boundary rules."""
    return _conv2(in1, in2, mode, boundary, fillvalue, flip=True)


def wiener(im, mysize=None, noise=None) -> torch.Tensor:
    """Local-statistics Wiener filter (scipy.signal.wiener, 1-D or 2-D):
    pixelwise  lMean + max(lVar - noise, 0)/max(lVar, noise) * (im - lMean)
    with lMean/lVar the boxcar local moments and noise defaulting to the
    mean local variance.  The two box sums are the same ones-kernel
    convolution.  lVar = conv(im^2)/N - lMean^2 cancels in float32 on the
    card, so the lVar < noise choice can flip near ties there."""
    im = _cuda_cast(as_tensor(im))
    if not (im.dtype.is_floating_point or im.dtype.is_complex):
        im = im.to(working_float(im.device))
    nd = im.dim()
    if nd not in (1, 2):
        raise ValueError("wiener supports 1-D or 2-D input")
    if mysize is None:
        mysize = (3,) * nd
    if isinstance(mysize, int):
        mysize = (mysize,) * nd
    mysize = tuple(int(m) for m in mysize)
    if len(mysize) != nd or any(m < 1 or m % 2 == 0 for m in mysize):
        raise ValueError("mysize must give one odd size per dimension")
    size = float(np.prod(mysize))
    ones = torch.ones(mysize, dtype=im.real.dtype, device=im.device)
    if nd == 1:
        from godsp_tpu_torch.models.filter import fftconvolve

        def conv(x):
            return fftconvolve(x, ones, mode="same")
    else:
        def conv(x):
            return convolve2d(x, ones, mode="same")
    l_mean = conv(im) / size
    l_var = conv(im * im) / size - l_mean * l_mean
    l_var = torch.clamp_min(l_var.real if im.dtype.is_complex else l_var, 0.0)
    noise = l_var.mean() if noise is None else torch.as_tensor(
        noise, dtype=l_var.dtype, device=l_var.device)
    res = l_mean + (im - l_mean) * (1.0 - noise / torch.maximum(l_var, noise))
    return torch.where(l_var < noise, l_mean, res)


def hilbert2(x) -> torch.Tensor:
    """2-D analytic signal (scipy.signal.hilbert2): keep only the (+,+)
    frequency quadrant via the separable step weighting u(k1)u(k2) (DC
    weight 1, strictly positive bins 2, negative bins and, by scipy's
    convention, the even-length Nyquist bin 0), then invert.  Uses the
    exact-length fft2/ifft2 (zero-extension would change the transform):
    any size works, powers of two take K1/K2 on the card."""
    x = as_tensor(x)
    if x.dim() != 2:
        raise ValueError("hilbert2 requires a 2-D input")
    if x.dtype.is_complex:
        raise ValueError("hilbert2 requires real input")
    from godsp_tpu_torch.fft.core import fft2, ifft2

    X = fft2(x)

    def step(n):
        u = torch.zeros(n, dtype=X.real.dtype, device=X.device)
        u[0] = 1.0
        u[1 : (n + 1) // 2] = 2.0
        return u

    n1, n2 = x.shape
    return ifft2(X * (step(n1)[:, None] * step(n2)[None, :]))


def sepfir2d(input, hrow, hcol) -> torch.Tensor:
    """Separable 2-D FIR filtering with mirror-symmetric boundary
    (scipy.signal.sepfir2d, edge-repeating symmetric extension): rows
    with hrow and columns with hcol, both odd-length, output the input's
    shape.  Runs as a symmetric pad and one 2-D convolution of the
    separable (outer-product) kernel."""
    x = _cuda_cast(as_tensor(input))
    hrow = _cuda_cast(as_tensor(hrow, device=x.device))
    hcol = _cuda_cast(as_tensor(hcol, device=x.device))
    if x.dim() != 2 or hrow.dim() != 1 or hcol.dim() != 1:
        raise ValueError("input must be 2-D and filters 1-D")
    kr, kc = hrow.shape[0], hcol.shape[0]
    if kr % 2 == 0 or kc % 2 == 0:
        raise ValueError("hrow and hcol must be odd length")
    pr, pc = kc // 2, kr // 2  # hcol runs down columns, hrow along rows
    xp = _pad2(x, pr, pc, "symmetric") if (pr or pc) else x
    kern = hcol[:, None] * hrow[None, :]
    return _conv2_full(xp, kern, "valid", not x.dtype.is_complex, False)


def order_filter(a, domain, rank: int) -> torch.Tensor:
    """2-D order (rank) filter (scipy.signal.order_filter): at each pixel,
    sort the neighbours selected by the nonzero entries of `domain` (odd
    sizes, zero-padded boundary) and keep the given rank.  The selected
    shifts are stacked and sorted by torch.sort, which orders NaN last as
    jnp.sort does."""
    a = _cuda_cast(as_tensor(a))
    dom = np.asarray(domain.detach().cpu() if isinstance(domain, torch.Tensor) else domain)
    if a.dim() != 2 or dom.ndim != 2:
        raise ValueError("input and domain must be 2-D")
    k1, k2 = dom.shape
    if k1 % 2 == 0 or k2 % 2 == 0:
        raise ValueError("domain sizes must be odd")
    sel = np.argwhere(dom != 0)
    if not 0 <= rank < len(sel):
        raise ValueError("rank must lie in [0, number of domain elements)")
    p1, p2 = k1 // 2, k2 // 2
    xp = torch.nn.functional.pad(a, (p2, p2, p1, p1))
    stack = torch.stack([xp[i : i + a.shape[0], j : j + a.shape[1]] for i, j in sel.tolist()])
    return torch.sort(stack, dim=0).values[int(rank)]


def medfilt2d(input, kernel_size=3) -> torch.Tensor:
    """2-D median filter with zero-padded boundary (scipy.signal.medfilt2d)."""
    if isinstance(kernel_size, int):
        kernel_size = (kernel_size, kernel_size)
    k1, k2 = int(kernel_size[0]), int(kernel_size[1])
    return order_filter(input, np.ones((k1, k2)), (k1 * k2) // 2)
