"""Fused cross-spectral (Welch CSD) kernel for Hopper, with its plain version and its model.

Counterpart of godsp_tpu/ops/pallas_csd.py.

  K7 csd_power_partials(ext_x, ext_y, mask, w, nfft, stride, pad)
     replaces pallas_csd.py: csd_power_partials (_csd_kernel)

The two-signal sibling of K4 (ops/cuda_pwelch.py): each CTA takes one
tile of one row's segments of BOTH signals straight from the raw
samples and sums mask[s] * conj(X_s) * Y_s over k = 0..pad/2
(csrc/csd_kernel.cu, whose header says what bounds it on the H100):

  re = xr*yr + xi*yi,   im = xr*yi - xi*yr.

The kernel is K4's body on two frames a segment, side by side: x's and
y's frames each through the framing load, K3's packed half-length
transform and split (csrc/frame_regs.cuh) in a warp of its own (a CTA
of two frames at pad >= 4096), then each frame hands the other half its
bins through its slot (partner_word) and sums mask[s] conj(X) Y over its
own half in registers (sums_in_smem: in its lanes' own words of shared
memory, sum_word), and K4's fixed-order sum of the CTA's segments, a
warp pair a group.  csd_regs_model is its float64 model, for the CPU
tests (no main-path call uses it).  The first design (radix-2 stages in
shared memory) stays as cuda_probes.csd_radix2.

Output: (re, im), each one partial row per tile, (..., n_tiles,
pad//2 + 1) in natural order.  The tiles, the geometry (any pad = 2^k in
2..16384 with pad >= nfft and stride > 0) and the mask semantics are
K4's; csd_power_sum takes the sum over tiles in torch.

A wrapper takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from godsp_tpu_torch.ops import _build
from godsp_tpu_torch.ops.cuda_fft import geometry, rfft_pow2_plain, rfft_table, twiddle_table
from godsp_tpu_torch.ops.cuda_pwelch import (
    _spectra_model,
    fused_supported,
    partials_model,
    segs_per_tile,
)

__all__ = [
    "csd_power_partials",
    "csd_power_partials_plain",
    "csd_power_sum",
    "csd_regs_model",
    "launches",
    "partner_word",
    "sum_word",
    "sums_in_smem",
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


def partner_word(pad: int, slot, k):
    """The 32-bit word of the re plane (the im plane's is the same word of
    its own) where K7's frame in slot `slot` puts its value of bin k for
    its partner frame, in its own slot as fft_regs.cuh lays slots out
    (slot_of: Q slots interleaved word by word, pad/2 words a slot a
    plane); slot and k broadcast together.  For the CPU tests' bank
    count."""
    g = geometry(pad // 2)
    slot, k = np.asarray(slot), np.asarray(k)
    return (slot // g.q) * g.q * (pad // 2) + slot % g.q + k * g.q


def sums_in_smem(pad: int) -> bool:
    """Whether K7 keeps its sums in shared memory at pad (csrc/csd_kernel.cu:
    Plan::kSumsInSmem, which gdsp_csd_geometry returns on the card): where
    the passes leave too few registers, pads 64..512, 8192 and 16384."""
    return 64 <= pad <= 512 or pad >= 8192


def sum_word(pad: int, seg, k):
    """The 32-bit word, counted from the start of the sums' re plane (the
    im plane's is the same word of its own), where K7 keeps segment slot
    `seg`'s sum of bin k where sums_in_smem(pad) (csrc/csd_kernel.cu:
    sum_word): the Q segment slots of a warp interleaved word by word,
    pad/2 + 1 words a slot; seg and k broadcast together.  For the CPU
    tests' bank count."""
    g = geometry(pad // 2)
    seg, k = np.asarray(seg), np.asarray(k)
    return (seg // g.q) * g.q * (pad // 2 + 1) + seg % g.q + k * g.q


def csd_regs_model(ext_x, ext_y, mask, w, nfft: int, stride: int,
                   pad: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """float64 model of K7 (csrc/csd_kernel.cu) on numpy arrays: each
    signal's frames as the kernel loads them (frames past the samples read
    zeros), the pad/2-point passes and K3's split
    (cuda_fft.rfft_packed_model), conj(X) Y, and the masked sums in the
    kernel's order (cuda_pwelch.partials_model, two frames a segment).
    Returns the wrapper's (re, im), each (..., n_tiles, pad//2 + 1) at
    segs_per_tile(S, rows).  For the CPU tests; no main-path call uses
    it."""
    pad = pad or nfft
    ext_x = np.asarray(ext_x, np.float64)
    lead = ext_x.shape[:-1]
    rows = int(np.prod(lead, dtype=np.int64))
    mask = np.asarray(mask, np.float64).reshape(rows, -1)
    S = mask.shape[-1]
    X = _spectra_model(ext_x, w, nfft, stride, S, pad)
    Y = _spectra_model(ext_y, w, nfft, stride, S, pad)
    out = partials_model(np.conj(X) * Y, mask, pad, segs_per_tile(S, rows), frames=2)
    out = out.reshape(*lead, *out.shape[1:])
    return out.real, out.imag


def _launch(ext_x, ext_y, mask, w, nfft, stride, pad, name, counts, radix2=False):
    """Run K7 (radix2: its first design, cuda_probes.csd_radix2, counted in
    counts[name]) over the rows of ext_x and ext_y."""
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
    for label, t in (("ext_x", ext_x), ("ext_y", ext_y), ("mask", mask), ("w", w)):
        if t.dtype != torch.float32 or t.device != ext_x.device:
            raise TypeError(f"{name}: {label} must be float32 on {ext_x.device}")
    re = torch.empty(*lead, n_tiles, lp, dtype=torch.float32, device=ext_x.device)
    im = torch.empty_like(re)
    if S == 0 or rows == 0:
        return re, im
    L = ext_x.shape[-1]
    ex2 = ext_x.reshape(rows, L).contiguous()
    ey2 = ext_y.reshape(rows, L).contiguous()
    mask2 = mask.reshape(rows, S).contiguous()
    w = w.contiguous()
    if w.data_ptr() % 8:  # the kernel reads the window as float2 pairs
        w = w.clone()
    lib = _build.library()
    args = [ex2.data_ptr(), ey2.data_ptr(), mask2.data_ptr(), w.data_ptr(), re.data_ptr(),
            im.data_ptr()]
    tail = [rows, L, S, nfft, stride, pad.bit_length() - 1, bt, n_tiles]
    stream = torch.cuda.current_stream(ext_x.device).cuda_stream
    with torch.cuda.device(ext_x.device):
        if radix2:
            rc = lib.gdsp_csd_radix2(*args, twiddle_table(pad, False, ext_x.device).data_ptr(),
                                     *tail, stream)
        else:
            rc = lib.gdsp_csd_partials(*args, rfft_table(pad, ext_x.device).data_ptr(), *tail,
                                       stream)
    _build.check(rc, name)
    counts[name] += 1
    return re, im


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
    return _launch(ext_x, ext_y, mask, w, nfft, stride, pad, "csd_power_partials", launches)


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
