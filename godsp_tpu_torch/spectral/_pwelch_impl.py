"""Welch power spectral density (reference spectral/pwelch.go:28-145).

Port of godsp_tpu/spectral/_pwelch_impl.py, the reference's quirks kept:

  * defaults NFFT=256, window=Hann, Pad=NFFT, Noverlap=0, scaling ON;
    `scale_off` is inverted so the zero value scales (pwelch.go:57-65);
  * input shorter than NFFT is zero-padded to NFFT (pwelch.go:97-99);
  * fft_len = max(pad, nfft): each segment is zero-padded to Pad and then
    windowed by a window of the post-pad length (pwelch.go:108-109),
    while the Sum(w^2) norm uses the NFFT window (pwelch.go:124-132);
    pad < nfft keeps the head pad/2+1 bins of the nfft-point FFT;
  * one-sided spectrum of length pad/2+1; interior doubling covers
    [1:lp-1] only, so bin lp-1 is never doubled (pwelch.go:113-121);
  * freqs[i] = i * Fs / pad (pwelch.go:138-142).

On CUDA the fused route runs the Hopper kernel (ops/cuda_pwelch.py) for
any pad = 2^k in 2..16384 with pad >= nfft and stride > 0; elsewhere the
batched route frames, windows and FFTs in torch (the FFT itself still
on the kernels on CUDA).  Both routes give the same sums.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Union

import torch

from godsp_tpu_torch import window as win
from godsp_tpu_torch._dtypes import as_real_array
from godsp_tpu_torch.dsputils.utils import zero_pad
from godsp_tpu_torch.fft.core import fft_real
from godsp_tpu_torch.fft.pow2 import kernels_enabled
from godsp_tpu_torch.ops import cuda_pwelch
from godsp_tpu_torch.spectral._segment_impl import segment

__all__ = [
    "PwelchOptions",
    "fused_path_eligible",
    "periodogram",
    "pwelch",
    "pwelch_from_frames",
]

WindowSpec = Union[str, Callable[[int], torch.Tensor], None]


def fused_path_eligible(x: torch.Tensor, nfft: int, pad: int, stride: int) -> bool:
    """True when the fused kernel serves this geometry for x: a CUDA float32
    tensor while the kernels are on (the CPU takes the batched route, as
    godsp_tpu does off the TPU)."""
    return (
        x.is_cuda
        and x.dtype == torch.float32
        and kernels_enabled()
        and cuda_pwelch.fused_supported(nfft, pad, stride)
    )


@dataclass(frozen=True)
class PwelchOptions:
    """Options for pwelch; defaults and semantics of pwelch.go:28-65.

    nfft:     data points per block (0 -> 256).  Use pad, not nfft, for
              zero padding (the scaling would be wrong otherwise).
    window:   taper name or callable L -> table (None -> Hann).
    pad:      points each segment is padded to before the FFT (0 -> nfft).
    noverlap: overlapping points between blocks (default 0).
    scale_off: disable division by the sampling frequency.  Inverted flag
              kept for parity: the default (False) ENABLES scaling.
    """

    nfft: int = 0
    window: WindowSpec = None
    pad: int = 0
    noverlap: int = 0
    scale_off: bool = False

    def resolved(self):
        """(nfft, window_fn, pad, noverlap, enable_scaling) with defaults applied."""
        nfft = self.nfft or 256
        wf = self.window if self.window is not None else win.hann
        if isinstance(wf, str):
            wf = win.WINDOWS[wf]
        pad = self.pad or nfft
        return nfft, wf, pad, self.noverlap, not self.scale_off


def _windows(wf, nfft: int, fft_len: int, fs: float, scaling: bool, like: torch.Tensor):
    """(pad-length taper, w_norm) in like's dtype on like's device."""
    w_fft = win.window_table(wf, fft_len, device=like.device, dtype=like.dtype)
    w_nfft = win.window_table(wf, nfft, device=like.device, dtype=like.dtype)
    w_norm = torch.sum(w_nfft * w_nfft)  # pwelch.go:124-128 (NFFT window)
    if scaling:
        w_norm = w_norm * fs  # pwelch.go:130-132
    return w_fft, w_norm


def _doubled(p: torch.Tensor) -> torch.Tensor:
    """Interior bins [1:lp-1] doubled (pwelch.go:113-121)."""
    lp = p.shape[-1]
    doubler = torch.ones(lp, dtype=p.dtype, device=p.device)
    doubler[1 : lp - 1] = 2.0
    return p * doubler


def _freqs(lp: int, fs: float, pad: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(lp, dtype=like.dtype, device=like.device) * (fs / pad)


def pwelch(x, fs: float, options: Optional[PwelchOptions] = None):
    """Estimate the PSD of x by Welch's method (pwelch.go:74-145).

    Returns (Pxx, freqs), each of length pad/2 + 1, on x's device.
    """
    o = options or PwelchOptions()
    x = as_real_array(x)
    if x.shape[-1] == 0:  # pwelch.go:75-77
        return x.new_zeros(0), x.new_zeros(0)

    nfft, wf, pad, noverlap, enable_scaling = o.resolved()
    if x.shape[-1] < nfft:
        x = zero_pad(x, nfft)  # pwelch.go:97-99

    stride = nfft - noverlap
    fft_len = max(pad, nfft)
    if stride > 0 and fused_path_eligible(x, nfft, fft_len, stride):
        total_segs = (x.shape[-1] - nfft) // stride + 1  # spectral.go:26-33
        lp = pad // 2 + 1
        w_fft, w_norm = _windows(wf, nfft, fft_len, fs, enable_scaling, x)
        p = cuda_pwelch.pwelch_power_sum(x, w_fft, nfft, stride, total_segs, pad=fft_len)
        pxx = _doubled(p[..., :lp]) / (total_segs * w_norm)
        return pxx, _freqs(lp, fs, pad, x)

    frames = segment(x, nfft, noverlap)  # (nsegs, nfft), pwelch.go:104
    return pwelch_from_frames(frames, fs, o)


def pwelch_from_frames(frames, fs: float, options: Optional[PwelchOptions] = None):
    """Welch PSD from pre-framed segments of shape (..., nsegs, nfft).

    On CUDA the frames feed the fused kernel as a back-to-back
    (stride == nfft) stream; otherwise the batched route.
    """
    o = options or PwelchOptions()
    nfft, wf, pad, _, enable_scaling = o.resolved()
    frames = as_real_array(frames)
    if frames.shape[-1] != nfft:
        raise ValueError(f"frames must have trailing length nfft={nfft}")
    lp = pad // 2 + 1
    fft_len = max(pad, nfft)  # ZeroPadF no-op for pad < nfft
    w_fft, w_norm = _windows(wf, nfft, fft_len, fs, enable_scaling, frames)

    nsegs = frames.shape[-2]
    if nsegs > 0 and fused_path_eligible(frames, nfft, fft_len, nfft):
        flat = frames.reshape(*frames.shape[:-2], nsegs * nfft)
        p = cuda_pwelch.pwelch_power_sum(flat, w_fft, nfft, nfft, nsegs, pad=fft_len)
        pxx = _doubled(p[..., :lp]) / (nsegs * w_norm)
    else:
        tapered = zero_pad(frames, fft_len) * w_fft  # pwelch.go:108-109
        spec = fft_real(tapered)[..., :lp]  # pwelch.go:111, one-sided
        p = (spec.real * spec.real + spec.imag * spec.imag).mean(dim=-2)
        pxx = _doubled(p) / w_norm
    return pxx, _freqs(lp, fs, pad, frames)


def periodogram(x, fs: float, window: WindowSpec = "rectangular", pad: int = 0,
                scale_off: bool = False):
    """Single-segment one-sided PSD: Pwelch with nfft = len(x).

    Default window is rectangular (the classical periodogram).  Returns
    (Pxx, freqs) of length (pad or len(x))//2 + 1.
    """
    x = as_real_array(x)
    n = int(x.shape[-1])
    if n == 0:
        return x.new_zeros(0), x.new_zeros(0)
    o = PwelchOptions(nfft=n, window=window, pad=pad, noverlap=0, scale_off=scale_off)
    return pwelch(x, fs, o)
