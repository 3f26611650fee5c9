"""Welch partial step on one device: the body of StreamingPwelch.

Port of the one-device part of godsp_tpu/parallel/_pwelch_sharded_impl.py:
resolve_geometry, partial_periodogram and partial_step, which is
sharded_partial_step's body at n_sp == 1 — the halo is the streamed
tail, the segment mask is global, and the step runs the fused kernel
(ops/cuda_pwelch.py) or the batched frames.  No mesh, no collective: the
sharded paths are ROADMAP queue 1 item 10.
"""

from __future__ import annotations

from typing import Optional

import torch

from godsp_tpu_torch.dsputils.utils import zero_pad
from godsp_tpu_torch.fft.core import fft_real
from godsp_tpu_torch.ops import cuda_pwelch
from godsp_tpu_torch.spectral._pwelch_impl import (
    PwelchOptions,
    _doubled,
    fused_path_eligible,
)

__all__ = ["partial_periodogram", "partial_step", "resolve_geometry"]


def partial_periodogram(frames, w_pad, mask, pad: int, lp: int):
    """(masked periodogram sum over segments, masked count).

    frames: (..., nsegs, nfft) real; mask: (..., nsegs) 0/1 validity.
    One-sided interior-bin doubling and |FFT|^2 as in pwelch.go:111-121;
    normalization happens after the reduction.
    """
    spec = fft_real(zero_pad(frames, pad) * w_pad)[..., :lp]
    p = spec.real * spec.real + spec.imag * spec.imag
    p = torch.sum(p * mask[..., None], dim=-2)
    return _doubled(p), torch.sum(mask, dim=-1)


def _frames_from_block(block, halo, nfft: int, stride: int, segs: int):
    """Frame a (..., B) block extended by its (..., H) right halo."""
    ext = torch.cat([block, halo], dim=-1)
    dev = ext.device
    idx = torch.arange(segs, device=dev)[:, None] * stride + torch.arange(nfft, device=dev)[None, :]
    return ext[..., idx]


def partial_step(x, tail, w_pad, nfft: int, pad: int, stride: int, segs: int, lp: int,
                 total_segs: int):
    """One accumulation step over a block of `segs` candidate segments.

    x: (..., L) with L = segs * stride; tail: (..., H) samples that follow
    x in the stream (H = nfft - stride; zeros in one-shot use).  pad is the
    FFT/window length max(options.pad, nfft); lp may be smaller than
    pad//2 + 1 when options.pad < nfft.  Segment s counts iff
    s < total_segs (spectral.go:26-33).  Returns (periodogram_sum, count).
    """
    H = max(nfft - stride, 0)
    halo = tail if H > 0 else x[..., :0]
    mask = (torch.arange(segs, device=x.device) < total_segs).to(x.dtype)
    mask = mask.expand(*x.shape[:-1], segs)
    if fused_path_eligible(x, nfft, pad, stride):
        ext = torch.cat([x, halo], dim=-1)
        partials = cuda_pwelch.pwelch_power_partials(ext, mask, w_pad, nfft, stride, pad=pad)
        return _doubled(partials.sum(dim=-2)[..., :lp]), torch.sum(mask, dim=-1)
    frames = _frames_from_block(x, halo, nfft, stride, segs)
    return partial_periodogram(frames, w_pad, mask, pad, lp)


def resolve_geometry(options: Optional[PwelchOptions]):
    """(nfft, window_fn, pad, fft_len, noverlap, scaling, stride, lp).

    fft_len = max(pad, nfft): the reference's ZeroPadF(seg, pad) is a
    no-op when pad < nfft (dsputils.go:60-63), so the transform then runs
    at nfft and only the first lp = pad//2 + 1 bins are kept.
    """
    o = options or PwelchOptions()
    nfft, wf, pad, noverlap, enable_scaling = o.resolved()
    stride = nfft - noverlap
    if stride <= 0:
        raise ValueError("noverlap must be < nfft")
    return (nfft, wf, pad, max(pad, nfft), noverlap, enable_scaling, stride,
            pad // 2 + 1)
