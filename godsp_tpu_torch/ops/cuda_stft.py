"""Fused STFT kernel for Hopper, with its plain version and its model.

Counterpart of godsp_tpu/ops/pallas_stft.py.  Three wrappers, each with
its own launch count, over the one kernel of csrc/stft_kernel.cu
(stft_kernel<log2(pad/2)>, the mode a runtime argument), as K1-K3 share
fft_pow2_kernel:

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

The kernel is K3's packed half-length transform behind a framing load
(the source's header says what bounds it on the H100): a frame read as
pad/2 complex pairs of windowed samples, the pad/2-point transform on
csrc/fft_regs.cuh's register-radix passes with cuda_fft.rfft_table(pad),
K3's split into bins 0..pad/2, and the mode's epilogue from registers
(mel: |X|^2 into the frame's shared-memory slot, then each filter's band
summed along k).  stft_regs_model is its float64 model, for the CPU
tests (no main-path call uses it): the pair load with the window, nfft
and L edges, cuda_fft.rfft_packed_model's passes and split, and each
mode's epilogue, the mel sums over each filter's band.  The first design
(radix-2 stages in shared memory) stays as cuda_probes.stft_radix2.

A wrapper takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from godsp_tpu_torch.fft.four_step import _tf32_off
from godsp_tpu_torch.ops import _build
from godsp_tpu_torch.ops.cuda_fft import (
    geometry,
    rfft_packed_model,
    rfft_pow2_plain,
    rfft_table,
    twiddle_table,
)
from godsp_tpu_torch.ops.cuda_pwelch import fused_supported

__all__ = [
    "launches",
    "mel_band",
    "stft_complex",
    "stft_mel",
    "stft_mel_slot_words",
    "stft_pallas_plain",
    "stft_power",
    "stft_regs_model",
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


def _pair_frames_model(x: np.ndarray, w: np.ndarray, nfft: int, stride: int, total_segs: int,
                       pad: int) -> np.ndarray:
    """(rows * total_segs, pad) float64 frames as the kernel's pair load
    builds them: sample e of frame s is x[s*stride + e] * w[e] where e <
    nfft and s*stride + e < L, else 0 (pair j holds samples 2j, 2j + 1)."""
    x = np.asarray(x, np.float64)
    L = x.shape[-1]
    rows = x.reshape(-1, L)
    e = np.arange(pad)
    at = np.arange(total_segs)[:, None] * stride + e  # (S, pad)
    keep = (e < nfft) & (at < L)
    vals = rows[:, np.minimum(at, L - 1)] * np.where(e < nfft, np.asarray(w, np.float64)[e], 0.0)
    return np.where(keep, vals, 0.0).reshape(-1, pad)


def stft_regs_model(x, w, nfft: int, stride: int, total_segs: int, pad: int | None = None,
                    out: str = "complex", fb=None, band=None) -> np.ndarray:
    """float64 model of K5 (csrc/stft_kernel.cu) on numpy arrays: the pair
    load (window, nfft and L edges; frames may run past L), the pad/2-point
    passes and K3's split (cuda_fft.rfft_packed_model), then the mode's
    epilogue: complex bins, |X|^2, or each filter j summed over its band
    [band[j, 0], band[j, 1]] (mel_band(fb) when not given).  Shapes as the
    wrappers'.  For the CPU tests; no main-path call uses it."""
    pad = pad or nfft
    x = np.asarray(x, np.float64)
    lead = x.shape[:-1]
    spec = rfft_packed_model(_pair_frames_model(x, w, nfft, stride, total_segs, pad))
    X = spec[0] + 1j * spec[1]  # (rows * S, pad/2 + 1)
    if out == "complex":
        return X.reshape(*lead, total_segs, pad // 2 + 1)
    p = X.real * X.real + X.imag * X.imag
    if out == "power":
        return p.reshape(*lead, total_segs, pad // 2 + 1)
    if out != "mel":
        raise ValueError(f"unknown out: {out}")
    fb = np.asarray(fb, np.float64)
    band = mel_band(torch.from_numpy(fb)).numpy() if band is None else np.asarray(band)
    mel = np.zeros((p.shape[0], fb.shape[0]))
    for j, (lo, hi) in enumerate(band):
        mel[:, j] = p[:, lo:hi + 1] @ fb[j, lo:hi + 1]
    return mel.reshape(*lead, total_segs, fb.shape[0])


def stft_mel_slot_words(pad: int, frames: int, slot, k) -> np.ndarray:
    """The 32-bit word of shared memory where K5's mel epilogue keeps
    |X_k|^2 of the frame in slot `slot` of a CTA of `frames` frames (slot
    and k broadcast together), as csrc/stft_kernel.cu lays it out in the
    frame's own slot (fft_regs.cuh: slot_of): the re plane at k < m =
    pad/2, the im plane at k - m for k = m; where a frame fills a warp (m =
    512, 1024) both rotated by 4 * slot words within the slot.  For the
    CPU tests' bank count."""
    m = pad // 2
    g = geometry(m)
    slots = -(-frames // g.q) * g.q if g.warp else frames
    slot, k = np.asarray(slot), np.asarray(k)
    base = (slot // g.q) * g.q * m + slot % g.q
    if g.warp and g.q == 1:
        rot = 4 * slot
        return np.where(k < m, base + (k + rot) % m, slots * m + base + k - m + rot)
    return np.where(k < m, base + k * g.q, slots * m + base + (k - m) * g.q)


def _launch(x, w, nfft, stride, total_segs, pad, out, fb=None, band=None, into=None,
            counts=None, name=None, radix2=False):
    """Run K5 in mode `out`; into: a contiguous tensor of the result's
    shape and dtype on x's device to write (a slice of a larger output).
    radix2 runs K5's first design (cuda_probes.stft_radix2), counted in
    counts[name]."""
    name = name or f"stft_{out}"
    counts = launches if counts is None else counts
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
    if w.data_ptr() % 8:  # the kernel reads the window as float2 pairs
        w = w.clone()
    if out == "mel":
        fb = fb.contiguous()
        band = (mel_band(fb) if band is None else band).to(x.device, torch.int32).contiguous()
    lib = _build.library()
    entry, table = ((lib.gdsp_stft_radix2, twiddle_table(pad, False, x.device)) if radix2
                    else (lib.gdsp_stft, rfft_table(pad, x.device)))
    with torch.cuda.device(x.device):
        rc = entry(
            x2.data_ptr(), w.data_ptr(), table.data_ptr(), res.data_ptr(), None if fb is None else fb.data_ptr(),
            None if band is None else band.data_ptr(),
            rows, L, total_segs, nfft, stride, pad.bit_length() - 1, _MODES[out],
            width if out == "mel" else 0, torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(rc, name)
    counts[name] += 1
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
