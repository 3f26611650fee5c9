"""K14a: the fused-Welch floor twins for Hopper, each beside its plain version.

Counterpart of tools/probe_pwfloor.py's Pallas twins (build_variant),
which take K4 apart.  Each twin is K4's own body (csrc/pwelch_kernel.cu)
with one part changed (csrc/pwelch_probe_kernels.cu, whose header says
what bounds them on the H100):

  pwfloor_loadonly(ext, mask, w, nfft, stride, pad)   replaces :189 loadonly
      the tile's samples, mask and window read once and summed:
      (..., n_tiles), one float a tile;
  pwfloor_frameonly(ext, mask, w, nfft, stride, pad)  replaces :189 frameonly
      K4's framing and window, then the masked sum of the windowed frames,
      no FFT: (..., n_tiles, pad) in time order;
  pwfloor_noframe(frames, mask, w)                    replaces :264 noframe
      frames given as (..., S, pad) rows (K3's layout): window, FFT, |X|^2,
      masked sum: (..., n_tiles, pad//2 + 1);
  pwfloor_staged(ext, mask, w, nfft, stride, pad)     replaces :229 full2d
      K4's function with each tile's span staged once in shared memory:
      (..., n_tiles, pad//2 + 1), equal to K4's partials at the same tiles.

The tiles are K4's (cuda_pwelch.segs_per_tile) unless `bt` says otherwise;
staged caps bt so that a block's span fits in 227 KB of shared memory.
The TPU twins' packed-half bin layout and their dimension_semantics A/B
have no counterpart: the bins are in natural order, and a CUDA grid has
no sequential dimension.

A wrapper takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import math

import torch

from godsp_tpu_torch.ops import _build
from godsp_tpu_torch.ops.cuda_fft import rfft_pow2_plain, twiddle_table
from godsp_tpu_torch.ops.cuda_pwelch import (
    fused_supported,
    pwelch_power_partials_plain,
    segs_per_tile,
)

__all__ = [
    "launches",
    "pwfloor_frameonly",
    "pwfloor_frameonly_plain",
    "pwfloor_loadonly",
    "pwfloor_loadonly_plain",
    "pwfloor_noframe",
    "pwfloor_noframe_plain",
    "pwfloor_staged",
    "pwfloor_staged_plain",
    "staged_segs_per_tile",
]

# Kernel launches by wrapper, counted where each launches its kernel.
launches = {"pwfloor_loadonly": 0, "pwfloor_frameonly": 0, "pwfloor_noframe": 0,
            "pwfloor_staged": 0}

_SMEM_BYTES = 232448  # shared memory a block may use on the H100 (227 KB)


def _staged_max_bt(nfft: int, stride: int, pad: int) -> int:
    """The most segments a tile whose staged span, FFT buffer and
    accumulator fit in one block's shared memory."""
    room = (_SMEM_BYTES - 8 * pad - 4 * (pad // 2 + 1)) // 4 - nfft
    if room < 0:
        raise ValueError(f"staged twin: nfft {nfft} and pad {pad} leave no room for a span")
    return room // stride + 1


def staged_segs_per_tile(n_segs: int, rows: int, nfft: int, stride: int, pad: int) -> int:
    """K4's tile (segs_per_tile), cut to what fits in shared memory."""
    return min(segs_per_tile(n_segs, rows), _staged_max_bt(nfft, stride, pad))


def _check(ext, mask, w, nfft, stride, pad):
    if not fused_supported(nfft, pad, stride):
        raise ValueError(f"geometry (nfft={nfft}, pad={pad}, stride={stride}) unsupported")
    if mask.shape[:-1] != ext.shape[:-1]:
        raise ValueError("ext and mask must share leading dimensions")
    if w.shape != (pad,):
        raise ValueError(f"window must have shape ({pad},), got {tuple(w.shape)}")


def _cuda_args(name: str, *ts: torch.Tensor) -> list[torch.Tensor]:
    dev = ts[0].device
    for t in ts:
        if t.dtype != torch.float32 or t.device != dev:
            raise TypeError(f"{name}: every operand must be float32 on {dev}")
    return [t.contiguous() for t in ts]


def _tile_sum(p: torch.Tensor, S: int, bt: int) -> torch.Tensor:
    """(..., S, w) -> (..., n_tiles, w): sums over each tile's segments."""
    n_tiles = -(-S // bt)
    p = torch.nn.functional.pad(p, (0, 0, 0, n_tiles * bt - S))
    return p.reshape(*p.shape[:-2], n_tiles, bt, p.shape[-1]).sum(dim=-2)


def _windowed_frames(ext, S, nfft, stride, pad, w):
    need = (S - 1) * stride + nfft
    ext = torch.nn.functional.pad(ext[..., :need], (0, max(0, need - ext.shape[-1])))
    frames = ext.unfold(-1, nfft, stride) * w[:nfft]
    return torch.nn.functional.pad(frames, (0, pad - nfft))


# ---------------------------------------------------------------------------
# Plain versions (any device, any float dtype: the float64 oracle on the card)
# ---------------------------------------------------------------------------


def pwfloor_loadonly_plain(ext, mask, w, nfft: int, stride: int, pad: int,
                           bt: int) -> torch.Tensor:
    """Per tile: the sum of its span of samples (clipped to the last
    segment's end), its mask entries and the window."""
    S = mask.shape[-1]
    n_tiles = -(-S // bt)
    span = (bt - 1) * stride + nfft
    need = (S - 1) * stride + nfft
    x = ext[..., :need]
    x = torch.nn.functional.pad(x, (0, (n_tiles - 1) * bt * stride + span - x.shape[-1]))
    samples = x.unfold(-1, span, bt * stride).sum(dim=-1)
    return samples + _tile_sum(mask[..., None], S, bt)[..., 0] + w.sum()


def pwfloor_frameonly_plain(ext, mask, w, nfft: int, stride: int, pad: int,
                            bt: int) -> torch.Tensor:
    """Per tile: sum over segments of mask[s] * w * frame_s, zero to pad."""
    S = mask.shape[-1]
    frames = _windowed_frames(ext, S, nfft, stride, pad, w)
    return _tile_sum(frames * mask[..., None], S, bt)


def pwfloor_noframe_plain(frames, mask, w, bt: int) -> torch.Tensor:
    """Per tile: sum over segments of mask[s] * |rfft(w * frames[s])|^2."""
    yr, yi = rfft_pow2_plain(frames * w)
    return _tile_sum((yr * yr + yi * yi) * mask[..., None], mask.shape[-1], bt)


def pwfloor_staged_plain(ext, mask, w, nfft: int, stride: int, pad: int,
                         bt: int) -> torch.Tensor:
    """K4's function (cuda_pwelch.pwelch_power_partials_plain)."""
    return pwelch_power_partials_plain(ext, mask, w, nfft, stride, pad, bt)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _launch(name: str, fn, out: torch.Tensor, *args) -> torch.Tensor:
    if out.numel() == 0:
        return out
    with torch.cuda.device(out.device):
        rc = fn(*args, torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(rc, name)
    launches[name] += 1
    return out


def pwfloor_loadonly(ext: torch.Tensor, mask: torch.Tensor, w: torch.Tensor, nfft: int,
                     stride: int, pad: int | None = None, bt: int | None = None) -> torch.Tensor:
    """The loadonly twin: (..., n_tiles) sums of each tile's inputs."""
    pad = pad or nfft
    _check(ext, mask, w, nfft, stride, pad)
    S, lead = mask.shape[-1], tuple(ext.shape[:-1])
    rows = math.prod(lead)
    bt = bt or segs_per_tile(S, rows)
    if not ext.is_cuda:
        return pwfloor_loadonly_plain(ext, mask, w, nfft, stride, pad, bt)
    ext, mask, w = _cuda_args("pwfloor_loadonly", ext, mask, w)
    n_tiles = -(-S // bt)
    out = torch.empty(*lead, n_tiles, dtype=torch.float32, device=ext.device)
    return _launch("pwfloor_loadonly", _build.library().gdsp_pwfloor_loadonly, out,
                   ext.data_ptr(), mask.data_ptr(), w.data_ptr(), out.data_ptr(),
                   rows, ext.shape[-1], S, nfft, stride, pad, bt, n_tiles)


def pwfloor_frameonly(ext: torch.Tensor, mask: torch.Tensor, w: torch.Tensor, nfft: int,
                      stride: int, pad: int | None = None, bt: int | None = None) -> torch.Tensor:
    """The frameonly twin: (..., n_tiles, pad) masked sums of windowed frames."""
    pad = pad or nfft
    _check(ext, mask, w, nfft, stride, pad)
    S, lead = mask.shape[-1], tuple(ext.shape[:-1])
    rows = math.prod(lead)
    bt = bt or segs_per_tile(S, rows)
    if not ext.is_cuda:
        return pwfloor_frameonly_plain(ext, mask, w, nfft, stride, pad, bt)
    ext, mask, w = _cuda_args("pwfloor_frameonly", ext, mask, w)
    n_tiles = -(-S // bt)
    out = torch.empty(*lead, n_tiles, pad, dtype=torch.float32, device=ext.device)
    return _launch("pwfloor_frameonly", _build.library().gdsp_pwfloor_frameonly, out,
                   ext.data_ptr(), mask.data_ptr(), w.data_ptr(), out.data_ptr(),
                   rows, ext.shape[-1], S, nfft, stride, pad.bit_length() - 1, bt, n_tiles)


def pwfloor_noframe(frames: torch.Tensor, mask: torch.Tensor, w: torch.Tensor,
                    bt: int | None = None) -> torch.Tensor:
    """The noframe twin: frames (..., S, pad) -> (..., n_tiles, pad//2 + 1)."""
    pad = frames.shape[-1]
    if frames.shape[:-1] != mask.shape or not fused_supported(pad, pad, pad):
        raise ValueError("frames must be (..., S, pad) over mask's (..., S), pad a power of 2")
    if w.shape != (pad,):
        raise ValueError(f"window must have shape ({pad},), got {tuple(w.shape)}")
    S, lead = mask.shape[-1], tuple(mask.shape[:-1])
    rows = math.prod(lead)
    bt = bt or segs_per_tile(S, rows)
    if not frames.is_cuda:
        return pwfloor_noframe_plain(frames, mask, w, bt)
    frames, mask, w = _cuda_args("pwfloor_noframe", frames, mask, w)
    n_tiles = -(-S // bt)
    out = torch.empty(*lead, n_tiles, pad // 2 + 1, dtype=torch.float32, device=frames.device)
    return _launch("pwfloor_noframe", _build.library().gdsp_pwfloor_noframe, out,
                   frames.data_ptr(), mask.data_ptr(), w.data_ptr(), out.data_ptr(),
                   twiddle_table(pad, False, frames.device).data_ptr(),
                   rows, S, pad.bit_length() - 1, bt, n_tiles)


def pwfloor_staged(ext: torch.Tensor, mask: torch.Tensor, w: torch.Tensor, nfft: int,
                   stride: int, pad: int | None = None, bt: int | None = None) -> torch.Tensor:
    """The staged twin: K4's partials with each tile's span staged once in
    shared memory, (..., n_tiles, pad//2 + 1)."""
    pad = pad or nfft
    _check(ext, mask, w, nfft, stride, pad)
    S, lead = mask.shape[-1], tuple(ext.shape[:-1])
    rows = math.prod(lead)
    if bt is None:
        bt = staged_segs_per_tile(S, rows, nfft, stride, pad)
    elif bt > _staged_max_bt(nfft, stride, pad):
        raise ValueError(f"staged twin: {bt} segments a tile do not fit in shared memory")
    if not ext.is_cuda:
        return pwfloor_staged_plain(ext, mask, w, nfft, stride, pad, bt)
    ext, mask, w = _cuda_args("pwfloor_staged", ext, mask, w)
    n_tiles = -(-S // bt)
    out = torch.empty(*lead, n_tiles, pad // 2 + 1, dtype=torch.float32, device=ext.device)
    return _launch("pwfloor_staged", _build.library().gdsp_pwfloor_staged, out,
                   ext.data_ptr(), mask.data_ptr(), w.data_ptr(), out.data_ptr(),
                   twiddle_table(pad, False, ext.device).data_ptr(),
                   rows, ext.shape[-1], S, nfft, stride, pad.bit_length() - 1, bt, n_tiles)
