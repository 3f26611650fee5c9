"""Cross-spectral density and magnitude-squared coherence (Welch).

Port of godsp_tpu/spectral/_csd_impl.py, which extends the reference's
auto-spectral Pwelch (spectral/pwelch.go) to pairs of signals with the
same conventions:

  csd(x, y)       one-sided Pxy = mean_segments conj(X_s) * Y_s: default
                  NFFT 256, Hann, Pad = NFFT, Noverlap 0, density scaling
                  unless scale_off; each segment zero-padded to pad and
                  THEN windowed by the symmetric pad-length taper
                  (pwelch.go:108-109), the norm from the NFFT table, and
                  the reference's doubling of bins [1:lp-1] only;
  coherence(x, y) Cxy = |Pxy|^2 / (Pxx Pyy), the denominator floored at
                  finfo.tiny.

csd(x, x) equals pwelch(x).  On CUDA the fused route runs K7
(ops/cuda_csd.py) for every geometry K4 takes (_pwelch_impl.
fused_path_eligible: any pow-2 pad <= 16384 with pad >= nfft and any
stride > 0), so godsp_tpu's "semi-fused" route for strides its TPU
kernel could not frame has no counterpart here; elsewhere both signals
are framed, windowed and transformed in torch.
"""

from __future__ import annotations

from typing import Optional

import torch

from godsp_tpu_torch._dtypes import as_real_array, complex_for
from godsp_tpu_torch.dsputils.utils import zero_pad
from godsp_tpu_torch.fft.core import fft_real
from godsp_tpu_torch.ops import cuda_csd
from godsp_tpu_torch.spectral import _pwelch_impl
from godsp_tpu_torch.spectral._pwelch_impl import PwelchOptions, _doubled, _freqs, _windows
from godsp_tpu_torch.spectral._segment_impl import segment

__all__ = ["csd", "coherence"]


def csd(x, y, fs: float, options: Optional[PwelchOptions] = None):
    """One-sided cross power spectral density of x and y.

    Same conventions as spectral.pwelch; returns (Pxy, freqs) with Pxy
    complex of length pad//2 + 1, on x's device.
    """
    o = options or PwelchOptions()
    x = as_real_array(x)
    y = as_real_array(y, x.device)
    if x.shape != y.shape:
        raise ValueError("x and y must have identical shapes")
    if x.shape[-1] == 0:
        return x.new_zeros(0, dtype=complex_for(x.dtype)), x.new_zeros(0)

    nfft, wf, pad, noverlap, enable_scaling = o.resolved()
    stride = nfft - noverlap
    if stride <= 0:
        raise ValueError("noverlap must be < nfft")
    if x.shape[-1] < nfft:
        x = zero_pad(x, nfft)  # pwelch.go:97-99
        y = zero_pad(y, nfft)

    lp = pad // 2 + 1
    # ZeroPadF(seg, pad) is a no-op when pad < nfft (dsputils.go:60-63): the
    # FFT then runs at nfft and only the first lp bins are kept.
    fft_len = max(pad, nfft)
    w_pad, w_norm = _windows(wf, nfft, fft_len, fs, enable_scaling, x)
    total_segs = (x.shape[-1] - nfft) // stride + 1
    if _pwelch_impl.fused_path_eligible(x, nfft, fft_len, stride):
        re, im = cuda_csd.csd_power_sum(x, y, w_pad, nfft, stride, total_segs, pad=fft_len)
        pxy = _doubled(torch.complex(re[..., :lp], im[..., :lp])) / (total_segs * w_norm)
        return pxy, _freqs(lp, fs, pad, x)

    def spectra(sig):
        frames = zero_pad(segment(sig, nfft, noverlap), fft_len) * w_pad
        return fft_real(frames)[..., :lp]

    pxy = torch.mean(torch.conj(spectra(x)) * spectra(y), dim=-2)
    return _doubled(pxy) / w_norm, _freqs(lp, fs, pad, x)


def coherence(x, y, fs: float, options: Optional[PwelchOptions] = None):
    """Magnitude-squared coherence Cxy = |Pxy|^2 / (Pxx Pyy) in [0, 1].

    Requires overlap/averaging over multiple segments to be meaningful
    (with one segment Cxy is identically 1).
    """
    pxy, freqs = csd(x, y, fs, options)
    pxx, _ = _pwelch_impl.pwelch(x, fs, options)
    pyy, _ = _pwelch_impl.pwelch(y, fs, options)
    denom = pxx * pyy
    cxy = (pxy.real**2 + pxy.imag**2) / torch.clamp_min(denom, torch.finfo(denom.dtype).tiny)
    return cxy, freqs
