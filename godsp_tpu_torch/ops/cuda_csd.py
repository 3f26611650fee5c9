"""Fused cross-spectral (Welch CSD) kernel for Hopper, with its plain version.

Counterpart of godsp_tpu/ops/pallas_csd.py.

  K7 csd_power_partials(ext_x, ext_y, mask, w, nfft, stride, pad)
     replaces pallas_csd.py: csd_power_partials (_csd_kernel)

The two-signal sibling of K4 (ops/cuda_pwelch.py): grid rows x tiles;
each block frames BOTH signals from the raw samples, windows them with
the pad-length taper, zero-extends to pad, runs both FFTs in shared
memory and sums mask[s] * conj(X_s) * Y_s over k = 0..pad/2
(csrc/csd_kernel.cu, whose header says what bounds it on the H100 and
how the X_k wait in registers so that pad 16384 fits one block):

  re = xr*yr + xi*yi,   im = xr*yi - xi*yr.

Output: (re, im), each one partial row per tile, (..., n_tiles,
pad//2 + 1) in natural order.  The tiles, the geometry (any pad = 2^k in
2..16384 with pad >= nfft and stride > 0) and the mask semantics are
K4's; csd_power_sum takes the sum over tiles in torch.

A wrapper takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import torch

from godsp_tpu_torch.ops import _build
from godsp_tpu_torch.ops.cuda_fft import rfft_pow2_plain, twiddle_table
from godsp_tpu_torch.ops.cuda_pwelch import fused_supported, segs_per_tile

__all__ = [
    "csd_power_partials",
    "csd_power_partials_plain",
    "csd_power_sum",
    "launches",
]

# Kernel launches by wrapper, counted where each launches its kernel.
launches = {"csd_power_partials": 0}


def _check(ext_x, ext_y, mask, w, nfft, stride, pad):
    if not fused_supported(nfft, pad, stride):
        raise ValueError(
            f"geometry (nfft={nfft}, pad={pad}, stride={stride}) unsupported "
            "by the fused kernel"
        )
    if ext_x.shape != ext_y.shape:
        raise ValueError("ext_x and ext_y must have identical shapes")
    if mask.shape[:-1] != ext_x.shape[:-1]:
        raise ValueError("ext and mask must share leading dimensions")
    if w.shape != (pad,):
        raise ValueError(f"window must have shape ({pad},), got {tuple(w.shape)}")


def csd_power_partials_plain(ext_x: torch.Tensor, ext_y: torch.Tensor, mask: torch.Tensor,
                             w: torch.Tensor, nfft: int, stride: int, pad: int,
                             bt: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of K7: frames materialized, each signal's FFT by
    rfft_pow2_plain (ops/cuda_fft.py), the conjugate product and the
    masked tile sums.

    Any device and float dtype (the float64 oracle on the card)."""
    S = mask.shape[-1]
    lp = pad // 2 + 1
    n_tiles = -(-S // bt)
    need = (S - 1) * stride + nfft
    dev = ext_x.device
    idx = torch.arange(S, device=dev)[:, None] * stride + torch.arange(nfft, device=dev)[None, :]

    def spectrum(ext):
        if ext.shape[-1] < need:
            ext = torch.nn.functional.pad(ext, (0, need - ext.shape[-1]))
        frames = torch.nn.functional.pad(ext[..., idx] * w[:nfft], (0, pad - nfft))
        return rfft_pow2_plain(frames)

    xr, xi = spectrum(ext_x)
    yr, yi = spectrum(ext_y)
    m = mask[..., None]
    parts = []
    for p in ((xr * yr + xi * yi) * m, (xr * yi - xi * yr) * m):
        p = torch.nn.functional.pad(p, (0, 0, 0, n_tiles * bt - S))
        parts.append(p.reshape(*p.shape[:-2], n_tiles, bt, lp).sum(dim=-2))
    return parts[0], parts[1]


def csd_power_partials(ext_x: torch.Tensor, ext_y: torch.Tensor, mask: torch.Tensor,
                       w: torch.Tensor, nfft: int, stride: int,
                       pad: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """K7: masked per-tile cross-power sums, natural bin order.

    ext_x, ext_y: (..., L_ext) samples of the same shape; segment s reads
                  [..., s*stride : s*stride + nfft] of each.
    mask:         (..., S) validity (1 = count segment s, 0 = drop).
    w:            (pad,) window taper.
    pad:          FFT length >= nfft (default nfft), a power of 2 up to 16384.

    Returns (re, im), each (..., n_tiles, pad//2 + 1): per-tile sums over
    segments of mask[s] * conj(X_s) * Y_s, bins 0..pad/2, with
    segs_per_tile(S, rows) segments a tile.
    """
    pad = pad or nfft
    _check(ext_x, ext_y, mask, w, nfft, stride, pad)
    S = mask.shape[-1]
    lead = ext_x.shape[:-1]
    rows = 1
    for d in lead:
        rows *= d
    bt = segs_per_tile(S, rows)
    lp = pad // 2 + 1
    n_tiles = -(-S // bt)
    if not ext_x.is_cuda:
        return csd_power_partials_plain(ext_x, ext_y, mask, w, nfft, stride, pad, bt)
    for name, t in (("ext_x", ext_x), ("ext_y", ext_y), ("mask", mask), ("w", w)):
        if t.dtype != torch.float32 or t.device != ext_x.device:
            raise TypeError(f"csd_power_partials: {name} must be float32 on {ext_x.device}")
    re = torch.empty(*lead, n_tiles, lp, dtype=torch.float32, device=ext_x.device)
    im = torch.empty_like(re)
    if S == 0 or rows == 0:
        return re, im
    L = ext_x.shape[-1]
    ex2 = ext_x.reshape(rows, L).contiguous()
    ey2 = ext_y.reshape(rows, L).contiguous()
    mask2 = mask.reshape(rows, S).contiguous()
    w = w.contiguous()
    lib = _build.library()
    with torch.cuda.device(ext_x.device):
        rc = lib.gdsp_csd_partials(
            ex2.data_ptr(), ey2.data_ptr(), mask2.data_ptr(), w.data_ptr(), re.data_ptr(),
            im.data_ptr(), twiddle_table(pad, False, ext_x.device).data_ptr(),
            rows, L, S, nfft, stride, pad.bit_length() - 1, bt, n_tiles,
            torch.cuda.current_stream(ext_x.device).cuda_stream,
        )
    _build.check(rc, "csd_power_partials")
    launches["csd_power_partials"] += 1
    return re, im


def csd_power_sum(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, nfft: int, stride: int,
                  total_segs: int, pad: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """One-sided cross-power sum of two raw signals, natural order.

    Segments s in [0, total_segs) of x and y (..., L).  Returns (re, im),
    each (..., pad//2 + 1): the sum over segments of conj(X) * Y; the
    caller applies the doubling and the normalization.
    """
    mask = torch.ones(*x.shape[:-1], total_segs, dtype=x.dtype, device=x.device)
    re, im = csd_power_partials(x, y, mask, w, nfft, stride, pad=pad)
    return re.sum(dim=-2), im.sum(dim=-2)
