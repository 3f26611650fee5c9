"""Fused STFT kernel for Hopper, with its plain version.

Counterpart of godsp_tpu/ops/pallas_stft.py.  Three wrappers, each with
its own launch count, over the one kernel of csrc/stft_kernel.cu
(stft_kernel), as K1-K3 share fft_pow2_kernel:

  K5 stft_complex(x, w, nfft, stride, total_segs, pad)      complex64 spectra
     stft_power(x, w, nfft, stride, total_segs, pad)        |X|^2 float32
     stft_mel(x, w, nfft, stride, total_segs, fb, pad)      sum_k |X_k|^2 fb[m, k]
     replace pallas_stft.py: stft_pallas (out = complex / power / mel)

Frame s of x (..., L) reads x[..., s*stride : s*stride + nfft], is
windowed by w[:nfft] (w is the (pad,) window, the nfft-point taper
zero-extended, which reproduces models.stft's window-then-pad), zero-
extended to pad and transformed; the outputs are natural-order one-sided,
(..., total_segs, pad//2 + 1), or (..., total_segs, n_mels) with
fb (n_mels, pad//2 + 1).  The mel contraction runs inside the kernel,
each filter summed over its band of nonzero bins only (mel_band).

Geometry: any pad = 2^k in 2..16384 with pad >= nfft and any stride > 0
(the TPU's lane rules and phase classes are not ported), as for K4.

A wrapper takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import torch

from godsp_tpu_torch.fft.four_step import _tf32_off
from godsp_tpu_torch.ops import _build
from godsp_tpu_torch.ops.cuda_fft import rfft_pow2_plain, twiddle_table
from godsp_tpu_torch.ops.cuda_pwelch import fused_supported

__all__ = [
    "launches",
    "mel_band",
    "stft_complex",
    "stft_mel",
    "stft_pallas_plain",
    "stft_power",
]

# Kernel launches by wrapper, counted where each launches its kernel.
launches = {"stft_complex": 0, "stft_power": 0, "stft_mel": 0}

_MODES = {"complex": 0, "power": 1, "mel": 2}


def _frames(x: torch.Tensor, w: torch.Tensor, nfft: int, stride: int, total_segs: int,
            pad: int) -> torch.Tensor:
    """(..., total_segs, pad): windowed frames, zero-extended to pad."""
    dev = x.device
    idx = torch.arange(total_segs, device=dev)[:, None] * stride + torch.arange(nfft, device=dev)
    return torch.nn.functional.pad(x[..., idx] * w[:nfft], (0, pad - nfft))


def stft_pallas_plain(x: torch.Tensor, w: torch.Tensor, nfft: int, stride: int,
                      total_segs: int, pad: int | None = None, out: str = "complex",
                      fb: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version of K5: frames materialized, FFT by fft/four_step.py.

    Any device and float dtype (the float64 oracle on the card)."""
    pad = pad or nfft
    yr, yi = rfft_pow2_plain(_frames(x, w, nfft, stride, total_segs, pad))
    if out == "complex":
        return torch.complex(yr, yi)
    p = yr * yr + yi * yi
    if out == "power":
        return p
    if out != "mel":
        raise ValueError(f"unknown out: {out}")
    with _tf32_off():
        return p @ fb.to(p.dtype).T


def mel_band(fb: torch.Tensor) -> torch.Tensor:
    """(n_mels, 2) int32: the first and last nonzero bin of each filter of
    fb (n_mels, bins); an all-zero filter gets the empty band (0, -1)."""
    nz = fb != 0
    bins = fb.shape[-1]
    lo = nz.int().argmax(dim=-1)
    hi = bins - 1 - nz.flip(-1).int().argmax(dim=-1)
    empty = ~nz.any(dim=-1)
    lo = torch.where(empty, torch.zeros_like(lo), lo)
    hi = torch.where(empty, torch.full_like(hi, -1), hi)
    return torch.stack([lo, hi], dim=-1).to(torch.int32)


def _launch(x, w, nfft, stride, total_segs, pad, out, fb=None, band=None, into=None):
    """Run K5 in mode `out`; into: a contiguous tensor of the result's
    shape and dtype on x's device to write (a slice of a larger output)."""
    name = f"stft_{out}"
    pad = pad or nfft
    if not fused_supported(nfft, pad, stride):
        raise ValueError(
            f"geometry (nfft={nfft}, pad={pad}, stride={stride}) unsupported by the fused kernel"
        )
    if w.shape != (pad,):
        raise ValueError(f"window must have shape ({pad},), got {tuple(w.shape)}")
    if out == "mel" and (fb is None or fb.dim() != 2 or fb.shape[1] != pad // 2 + 1):
        raise ValueError(f"out='mel' requires fb of shape (n_mels, {pad // 2 + 1})")
    if not x.is_cuda:
        res = stft_pallas_plain(x, w, nfft, stride, total_segs, pad, out, fb)
        return res if into is None else into.copy_(res)
    tensors = (("x", x), ("w", w)) + ((("fb", fb),) if out == "mel" else ())
    for label, t in tensors:
        if t.dtype != torch.float32 or t.device != x.device:
            raise TypeError(f"{name}: {label} must be float32 on {x.device}")
    lead = x.shape[:-1]
    rows = 1
    for d in lead:
        rows *= d
    L = x.shape[-1]
    if total_segs > 0 and (total_segs - 1) * stride + nfft > L:
        raise ValueError(f"{name}: {total_segs} frames of stride {stride} need "
                         f"{(total_segs - 1) * stride + nfft} samples, got {L}")
    lp = pad // 2 + 1
    width = fb.shape[0] if out == "mel" else lp
    shape = (*lead, total_segs, width)
    dtype = torch.complex64 if out == "complex" else torch.float32
    if into is None:
        res = torch.empty(shape, dtype=dtype, device=x.device)
    elif (into.shape != shape or into.dtype != dtype or into.device != x.device
          or not into.is_contiguous()):
        raise ValueError(f"{name}: into must be a contiguous {dtype} tensor of shape {shape} "
                         f"on {x.device}")
    else:
        res = into
    if total_segs == 0 or rows == 0:
        return res
    x2 = x.reshape(rows, L).contiguous()
    w = w.contiguous()
    if out == "mel":
        fb = fb.contiguous()
        band = (mel_band(fb) if band is None else band).to(x.device, torch.int32).contiguous()
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.gdsp_stft(
            x2.data_ptr(), w.data_ptr(), twiddle_table(pad, False, x.device).data_ptr(),
            res.data_ptr(), None if fb is None else fb.data_ptr(),
            None if band is None else band.data_ptr(),
            rows, L, total_segs, nfft, stride, pad.bit_length() - 1, _MODES[out],
            width if out == "mel" else 0, torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(rc, name)
    launches[name] += 1
    return res


def stft_complex(x: torch.Tensor, w: torch.Tensor, nfft: int, stride: int, total_segs: int,
                 pad: int | None = None) -> torch.Tensor:
    """K5, complex mode: (..., total_segs, pad//2 + 1) complex64 spectra."""
    return _launch(x, w, nfft, stride, total_segs, pad, "complex")


def stft_power(x: torch.Tensor, w: torch.Tensor, nfft: int, stride: int, total_segs: int,
               pad: int | None = None, into: torch.Tensor | None = None) -> torch.Tensor:
    """K5, power mode: (..., total_segs, pad//2 + 1) float32 |X|^2, written
    into `into` when given (a contiguous slice of a larger output)."""
    return _launch(x, w, nfft, stride, total_segs, pad, "power", into=into)


def stft_mel(x: torch.Tensor, w: torch.Tensor, nfft: int, stride: int, total_segs: int,
             fb: torch.Tensor, pad: int | None = None,
             band: torch.Tensor | None = None) -> torch.Tensor:
    """K5, mel mode: (..., total_segs, n_mels) float32 |X|^2 @ fb.T, the
    contraction inside the kernel.  band (n_mels, 2): each filter's first
    and last nonzero bin (mel_band(fb) when not given)."""
    return _launch(x, w, nfft, stride, total_segs, pad, "mel", fb, band)
