"""Fused Welch-periodogram kernel for Hopper, with its plain version.

Counterpart of godsp_tpu/ops/pallas_pwelch.py.

  K4 pwelch_power_partials(ext, mask, w, nfft, stride, pad)
     replaces pallas_pwelch.py: pwelch_power_partials (_pwelch_kernel)

Grid rows x tiles; each block cuts its tile's overlapped segments from
the raw samples (block + halo), windows them with the pad-length taper,
zero-extends to pad, runs the FFT in shared memory and sums
mask[s] * |X_k|^2 over k = 0..pad/2 (csrc/pwelch_kernel.cu, whose header
says what bounds it on the H100).  Output: one partial row per tile,
(..., n_tiles, pad//2 + 1) in natural order.  The tile size is the
port's own (segs_per_tile); only the sum over tiles is contractual, and
pwelch_power_sum takes that sum in torch, as godsp_tpu sums its partials
outside the kernel.

Mask semantics of pallas_pwelch.py:501-515: ext must cover every masked
segment; unmasked segments and padded rows count 0.  The TPU's geometry
limits (nfft % 128, stride phase classes) were lane rules: here any
pad = 2^k in 2..16384 with pad >= nfft and stride > 0 is covered.

A wrapper takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import torch

from godsp_tpu_torch.ops import _build
from godsp_tpu_torch.ops.cuda_fft import rfft_pow2_plain, supported_size, twiddle_table

__all__ = [
    "fused_supported",
    "launches",
    "pwelch_power_partials",
    "pwelch_power_partials_plain",
    "pwelch_power_sum",
    "segs_per_tile",
]

# Kernel launches by wrapper, counted where each launches its kernel.
launches = {"pwelch_power_partials": 0}

# Blocks to aim for: four per SM of an H100 (132 SMs).
_TARGET_BLOCKS = 4 * 132
_MAX_SEGS_PER_TILE = 64


def fused_supported(nfft: int, pad: int, stride: int) -> bool:
    """True if the fused kernel covers this Pwelch geometry."""
    return nfft >= 1 and pad >= nfft and stride > 0 and supported_size(pad)


def segs_per_tile(n_segs: int, rows: int) -> int:
    """Segments a block sums: enough tiles to fill the card, at most 64."""
    bt = -(-(n_segs * rows) // _TARGET_BLOCKS)
    return max(1, min(_MAX_SEGS_PER_TILE, bt))


def _check(ext, mask, w, nfft, stride, pad):
    if not fused_supported(nfft, pad, stride):
        raise ValueError(
            f"geometry (nfft={nfft}, pad={pad}, stride={stride}) unsupported "
            "by the fused kernel"
        )
    if mask.shape[:-1] != ext.shape[:-1]:
        raise ValueError("ext and mask must share leading dimensions")
    if w.shape != (pad,):
        raise ValueError(f"window must have shape ({pad},), got {tuple(w.shape)}")


def pwelch_power_partials_plain(ext: torch.Tensor, mask: torch.Tensor, w: torch.Tensor,
                                nfft: int, stride: int, pad: int,
                                bt: int) -> torch.Tensor:
    """Plain torch version of K4: frames materialized, FFT by fft/four_step.py."""
    S = mask.shape[-1]
    lp = pad // 2 + 1
    n_tiles = -(-S // bt)
    need = (S - 1) * stride + nfft
    if ext.shape[-1] < need:
        ext = torch.nn.functional.pad(ext, (0, need - ext.shape[-1]))
    dev = ext.device
    idx = torch.arange(S, device=dev)[:, None] * stride + torch.arange(nfft, device=dev)[None, :]
    frames = ext[..., idx] * w[:nfft]
    frames = torch.nn.functional.pad(frames, (0, pad - nfft))
    yr, yi = rfft_pow2_plain(frames)
    p = (yr * yr + yi * yi) * mask[..., None]
    p = torch.nn.functional.pad(p, (0, 0, 0, n_tiles * bt - S))
    return p.reshape(*p.shape[:-2], n_tiles, bt, lp).sum(dim=-2)


def pwelch_power_partials(ext: torch.Tensor, mask: torch.Tensor, w: torch.Tensor,
                          nfft: int, stride: int, pad: int | None = None) -> torch.Tensor:
    """K4: masked per-tile periodogram sums, natural bin order.

    ext:  (..., L_ext) samples; segment s reads ext[..., s*stride : s*stride + nfft].
    mask: (..., S) validity (1 = count segment s, 0 = drop).
    w:    (pad,) window taper (pwelch.go:109, hoisted).
    pad:  FFT length >= nfft (default nfft), a power of 2 up to 16384.

    Returns (..., n_tiles, pad//2 + 1): per-tile sums over segments of
    mask[s] * |FFT(w * frame_s)|^2, bins 0..pad/2, with
    segs_per_tile(S, rows) segments a tile.
    """
    pad = pad or nfft
    _check(ext, mask, w, nfft, stride, pad)
    S = mask.shape[-1]
    lead = ext.shape[:-1]
    rows = 1
    for d in lead:
        rows *= d
    bt = segs_per_tile(S, rows)
    lp = pad // 2 + 1
    n_tiles = -(-S // bt)
    if not ext.is_cuda:
        return pwelch_power_partials_plain(ext, mask, w, nfft, stride, pad, bt)
    for name, t in (("ext", ext), ("mask", mask), ("w", w)):
        if t.dtype != torch.float32 or t.device != ext.device:
            raise TypeError(f"pwelch_power_partials: {name} must be float32 on {ext.device}")
    out = torch.empty(*lead, n_tiles, lp, dtype=torch.float32, device=ext.device)
    if S == 0 or rows == 0:
        return out
    L = ext.shape[-1]
    ext2 = ext.reshape(rows, L).contiguous()
    mask2 = mask.reshape(rows, S).contiguous()
    w = w.contiguous()
    lib = _build.library()
    with torch.cuda.device(ext.device):
        rc = lib.gdsp_pwelch_partials(
            ext2.data_ptr(), mask2.data_ptr(), w.data_ptr(), out.data_ptr(),
            twiddle_table(pad, False, ext.device).data_ptr(),
            rows, L, S, nfft, stride, pad.bit_length() - 1, bt, n_tiles,
            torch.cuda.current_stream(ext.device).cuda_stream,
        )
    _build.check(rc, "pwelch_power_partials")
    launches["pwelch_power_partials"] += 1
    return out


def pwelch_power_sum(x: torch.Tensor, w: torch.Tensor, nfft: int, stride: int,
                     total_segs: int, pad: int | None = None) -> torch.Tensor:
    """One-sided periodogram power sum of a raw signal, natural order.

    Segments s in [0, total_segs) of x (..., L).  Returns (..., pad//2 + 1),
    the sum over segments of |FFT(w * frame)|^2; the caller applies the
    interior doubling and 1/(nsegs * sum(w^2) * fs) (pwelch.go:113-136).
    """
    mask = torch.ones(*x.shape[:-1], total_segs, dtype=x.dtype, device=x.device)
    return pwelch_power_partials(x, mask, w, nfft, stride, pad=pad).sum(dim=-2)
