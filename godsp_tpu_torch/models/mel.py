"""Mel-scale features: filterbank, log-mel spectrogram, MFCC.

Port of godsp_tpu/models/mel.py: power spectrogram -> mel filterbank
contraction -> log -> DCT-II.  HTK mel scale (2595 log10(1 + f/700));
triangular filters with optional Slaney area normalization.  On a CUDA
float32 input at a supported geometry the log-mel front end is one
kernel (K5's mel mode, ops/cuda_stft.py): frames, spectra and the power
spectrum never reach device memory.  mfcc then takes the ortho DCT-II of
the log-mel rows over the FFT core (fft/_dct_impl.py).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from godsp_tpu_torch._dtypes import as_real_array, as_tensor, resolve_device, working_float
from godsp_tpu_torch.fft._dct_impl import dct
from godsp_tpu_torch.fft.four_step import _tf32_off
from godsp_tpu_torch.models._stft_impl import (
    WindowSpec,
    _resolve_window,
    _StreamingFramer,
    spectrogram,
)
from godsp_tpu_torch.ops import cuda_stft
from godsp_tpu_torch.spectral._pwelch_impl import fused_path_eligible

__all__ = ["mel_filterbank", "mel_spectrogram", "mfcc", "stream_mel"]


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@lru_cache(maxsize=None)
def _filterbank_np(
    n_mels: int, nfft: int, fs: float, fmin: float, fmax: float, norm: Optional[str]
) -> np.ndarray:
    """(n_mels, nfft//2 + 1) float64 triangular mel filterbank."""
    if n_mels < 1:
        raise ValueError("n_mels must be >= 1")
    if not 0.0 <= fmin < fmax <= fs / 2.0 + 1e-9:
        raise ValueError(f"need 0 <= fmin < fmax <= fs/2, got [{fmin}, {fmax}]")
    lp = nfft // 2 + 1
    freqs = np.arange(lp, dtype=np.float64) * (fs / nfft)
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)  # (n_mels + 2,) band edges

    fb = np.zeros((n_mels, lp), dtype=np.float64)
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-12)
        down = (hi - freqs) / max(hi - ctr, 1e-12)
        fb[m] = np.maximum(0.0, np.minimum(up, down))
    if norm == "slaney":  # area-normalize each triangle
        enorm = 2.0 / (hz_pts[2:] - hz_pts[:-2])
        fb *= enorm[:, None]
    elif norm is not None:
        raise ValueError(f"unknown norm: {norm}")
    return fb


@lru_cache(maxsize=None)
def _band(n_mels: int, nfft: int, fs: float, fmin: float, fmax: float,
          norm: Optional[str]) -> torch.Tensor:
    """Each filter's first and last nonzero bin, from the float64 table, once."""
    return cuda_stft.mel_band(torch.from_numpy(_filterbank_np(n_mels, nfft, fs, fmin, fmax, norm)))


def _params(n_mels, nfft, fs, fmin, fmax, norm) -> tuple:
    fmax = float(fs) / 2.0 if fmax is None else float(fmax)
    return int(n_mels), int(nfft), float(fs), float(fmin), fmax, norm


def mel_filterbank(
    n_mels: int,
    nfft: int,
    fs: float,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    norm: Optional[str] = None,
    device=None,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """(n_mels, nfft//2 + 1) triangular mel filterbank (HTK mel scale;
    norm="slaney" area-normalizes each filter), on `device` in `dtype`
    (default: the device's working float).  device=None means
    default_device()."""
    fb = _filterbank_np(*_params(n_mels, nfft, fs, fmin, fmax, norm))
    dev = resolve_device(device)
    return torch.from_numpy(fb.copy()).to(device=dev, dtype=dtype or working_float(dev))


def mel_spectrogram(
    x,
    fs: float,
    nfft: int = 1024,
    hop: Optional[int] = None,
    n_mels: int = 80,
    window: WindowSpec = None,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    norm: Optional[str] = None,
    log: bool = False,
    eps: float = 1e-10,
) -> torch.Tensor:
    """(..., frames, n_mels) mel-scale power spectrogram.

    Fused kernel (frame -> window -> FFT -> |.|^2 -> filterbank) on the
    fused route; elsewhere power spectrogram @ fb.T.  log=True applies
    ln(mel + eps).
    """
    params = _params(n_mels, nfft, fs, fmin, fmax, norm)
    x = as_real_array(x)
    fb = mel_filterbank(n_mels, nfft, fs, fmin, fmax, norm, device=x.device, dtype=x.dtype)
    hop_r = nfft // 2 if hop is None else hop
    if hop_r > 0 and x.shape[-1] >= nfft and fused_path_eligible(x, nfft, nfft, hop_r):
        w = _resolve_window(window, nfft, x.dtype, x.device)
        n_frames = (x.shape[-1] - nfft) // hop_r + 1
        m = cuda_stft.stft_mel(x, w, nfft, hop_r, n_frames, fb,
                               band=_band(*params).to(x.device))
    else:
        p = spectrogram(x, nfft, hop, window, scale="power")  # (..., frames, lp)
        with _tf32_off():
            m = p @ fb.T
    return torch.log(m + eps) if log else m


def stream_mel(
    chunks,
    fs: float,
    nfft: int = 1024,
    hop: Optional[int] = None,
    n_mels: int = 80,
    window: WindowSpec = None,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    norm: Optional[str] = None,
    log: bool = False,
    eps: float = 1e-10,
    device=None,
):
    """Streaming mel front end: sample blocks in, (..., F_k, n_mels) mel
    (or log-mel) blocks out, computed on `device` (host blocks go there,
    default: default_device(); tensors stay on theirs).

    The (< nfft)-sample tail behind each block's last frame start is
    carried on the host (models._stft_impl._StreamingFramer), so the
    concatenation of the yielded blocks equals mel_spectrogram of the
    concatenated signal exactly.
    """
    hop_r = nfft // 2 if hop is None else hop
    if hop_r <= 0:
        raise ValueError("hop must be positive")
    framer = _StreamingFramer(nfft, hop_r)
    for block in chunks:
        seg = framer.push(block)
        if seg is not None:
            yield mel_spectrogram(
                as_tensor(seg, device), fs, nfft, hop_r, n_mels, window, fmin,
                fmax, norm, log=log, eps=eps,
            )


def mfcc(
    x,
    fs: float,
    n_mfcc: int = 13,
    nfft: int = 1024,
    hop: Optional[int] = None,
    n_mels: int = 80,
    window: WindowSpec = None,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
) -> torch.Tensor:
    """(..., frames, n_mfcc) mel-frequency cepstral coefficients: the ortho
    DCT-II of the log-mel spectrogram (Slaney-normalized filters), its
    first n_mfcc terms."""
    if n_mfcc > n_mels:
        raise ValueError("n_mfcc must be <= n_mels")
    logmel = mel_spectrogram(x, fs, nfft, hop, n_mels, window, fmin, fmax, norm="slaney",
                             log=True)
    return dct(logmel, norm="ortho")[..., :n_mfcc]
