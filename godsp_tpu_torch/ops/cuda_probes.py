"""K14a-c: the Hopper probes, each beside its plain version.

K14a: the fused-Welch floor twins.

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

K14b and K14c: the lane-DFT probes, twins of K13 (gmm_floor) and K12
(copy_split) in csrc/lane_probe_kernels.cu, whose header says what bounds
them on the H100.  Each takes two float32 planes (b, n), n = n1 x 128,
and returns natural (b, n) planes in K13's bin order (bin k2 of slice k1
at column 128 k1 + k2):

  fac_dft(xr, xi)      replaces tools/probe_facdft.py:175 fac_pallas
      K13's function factored as 128 = 16 x 8 (24 complex multiply-adds a
      point, not 128); plain version fac_dft_plain, the same factoring in
      the input's dtype (float64 on the card: the oracle), equal to
      cuda_metrics.gmm_floor_plain;
  slicestore(xr, xi)   replaces tools/probe_store.py:53 _call (_slicestore_kernel)
  concatstore(xr, xi)  replaces _call (_concatstore_kernel)
      copies: one slice of each row a pass, or the tile staged in shared
      memory and stored as whole rows; plain version
      cuda_metrics.copy_split_plain;
  gmm_concat(xr, xi)   replaces _call (_gmm_concat_kernel)
      K13's contraction with the outputs of every slice of a row tile
      stored as whole rows; plain version cuda_metrics.gmm_floor_plain.

The fac tables (W16 with 1/128 folded in, the mid twiddle W128^{j2 ka},
W8, the outer twiddle T) are built in float64 from the port's
dft_matrix/twiddle_2d, as tools/probe_facdft.py: _fac_tables builds them,
and rounded once to float32.  The TPU's layout A ((B, 16, 64), j1 in
sublanes) was a Mosaic workaround and is not ported.

A wrapper takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import math
from contextlib import nullcontext
from functools import lru_cache

import numpy as np
import torch

from godsp_tpu_torch.fft.four_step import _tf32_off, dft_matrix, twiddle_2d
from godsp_tpu_torch.ops import _build
from godsp_tpu_torch.ops.cuda_fft import rfft_pow2_plain, twiddle_table
from godsp_tpu_torch.ops.cuda_metrics import (
    LANES,
    _cuda_planes,
    copy_split_plain,
    gmm_floor_plain,
    gmm_tables,
)
from godsp_tpu_torch.ops.cuda_metrics import _check as _check_planes
from godsp_tpu_torch.ops.cuda_pwelch import (
    fused_supported,
    pwelch_power_partials_plain,
    segs_per_tile,
)

__all__ = [
    "concatstore",
    "fac_dft",
    "fac_dft_plain",
    "fac_tables",
    "gmm_concat",
    "launches",
    "pwfloor_frameonly",
    "pwfloor_frameonly_plain",
    "pwfloor_loadonly",
    "pwfloor_loadonly_plain",
    "pwfloor_noframe",
    "pwfloor_noframe_plain",
    "pwfloor_staged",
    "pwfloor_staged_plain",
    "slicestore",
    "staged_segs_per_tile",
]

# Kernel launches by wrapper, counted where each launches its kernel.
launches = {"pwfloor_loadonly": 0, "pwfloor_frameonly": 0, "pwfloor_noframe": 0,
            "pwfloor_staged": 0, "fac_dft": 0, "slicestore": 0, "concatstore": 0,
            "gmm_concat": 0}

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


# ---------------------------------------------------------------------------
# K14b and K14c: the lane-DFT probes
# ---------------------------------------------------------------------------

D1, D2 = 16, 8  # 128 = D1 x D2: j = 8 j1 + j2, k = ka + 16 kb


def _check_lane_planes(xr: torch.Tensor, xi: torch.Tensor, name: str) -> tuple[int, int]:
    b, n = _check_planes(xr, xi, name)
    if n < LANES or n % LANES:
        raise ValueError(f"{name}: n must be a multiple of {LANES}, got {n}")
    return b, n


@lru_cache(maxsize=None)
def _fac_host(n: int) -> dict:
    """complex128 tables: w16 (j1, ka) with 1/128 folded in, tmid (j2, ka)
    = W128^{j2 ka}, w8 (j2, kb), tw (slice, j) the outer twiddle."""
    return {"w16": dft_matrix(D1) / LANES, "tmid": twiddle_2d(D2, D1), "w8": dft_matrix(D2),
            "tw": twiddle_2d(n // LANES, LANES)}


def fac_tables(n: int) -> dict[str, np.ndarray]:
    """K14b's tables for n points, float32 numpy rounded once from float64:
    w16r/w16i (16, 16), tmr/tmi (8, 16), w8r/w8i (8, 8), twr/twi (n/128, 128)."""
    out = {}
    for key, name in (("w16", "w16"), ("tmid", "tm"), ("w8", "w8"), ("tw", "tw")):
        t = _fac_host(n)[key]
        out[name + "r"] = np.ascontiguousarray(t.real, np.float32)
        out[name + "i"] = np.ascontiguousarray(t.imag, np.float32)
    return out


@lru_cache(maxsize=None)
def _fac_packed(n: int, device: torch.device) -> torch.Tensor:
    """The kernel's table: w16r, w16i, tmr, tmi, w8r, w8i (896 floats),
    then T's real and imaginary planes (n each)."""
    t = fac_tables(n)
    order = ("w16r", "w16i", "tmr", "tmi", "w8r", "w8i", "twr", "twi")
    return torch.from_numpy(np.concatenate([t[k].ravel() for k in order])).to(device)


def fac_dft_plain(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of K14b: the outer twiddle, the 16-point DFTs over
    j1, the mid twiddle and the 8-point DFTs over j2, in the input's dtype
    (complex128 for float64 planes)."""
    b, n = _check_lane_planes(xr, xi, "fac_dft")
    cdt = torch.complex128 if xr.dtype == torch.float64 else torch.complex64
    tab = {k: torch.from_numpy(v).to(device=xr.device, dtype=cdt)
           for k, v in _fac_host(n).items()}
    n1 = n // LANES
    v = torch.complex(xr, xi).to(cdt).reshape(b, n1, D1, D2) * tab["tw"].reshape(n1, D1, D2)
    with _tf32_off() if v.is_cuda else nullcontext():
        u = torch.einsum("bsij,ia->bsaj", v, tab["w16"]) * tab["tmid"].T
        y = torch.einsum("bsaj,jk->bska", u, tab["w8"]).reshape(b, n)
    return y.real.contiguous(), y.imag.contiguous()


def _lane_launch(name: str, fn, xr: torch.Tensor, xi: torch.Tensor, *tables) -> tuple:
    b, n = xr.shape
    xr, xi = _cuda_planes(xr, xi, name)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    if b == 0:
        return yr, yi
    with torch.cuda.device(xr.device):
        rc = fn(xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                *(t.data_ptr() for t in tables), b, n,
                torch.cuda.current_stream(xr.device).cuda_stream)
    _build.check(rc, name)
    launches[name] += 1
    return yr, yi


def fac_dft(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K14b: K13's function (the twiddled 128-point DFT of every slice of
    two float32 planes (b, n)) computed as 128 = 16 x 8."""
    _check_lane_planes(xr, xi, "fac_dft")
    if not xr.is_cuda:
        return fac_dft_plain(xr, xi)
    return _lane_launch("fac_dft", _build.library().gdsp_fac_dft, xr, xi,
                        _fac_packed(xr.shape[1], xr.device))


def slicestore(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K14c slicestore: (yr, yi) = (xr, xi), stored one 128-column slice of
    each row a pass."""
    _check_lane_planes(xr, xi, "slicestore")
    if not xr.is_cuda:
        return copy_split_plain(xr, xi)
    return _lane_launch("slicestore", _build.library().gdsp_slicestore, xr, xi)


def concatstore(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K14c concatstore: (yr, yi) = (xr, xi), staged in shared memory and
    stored as whole rows."""
    _check_lane_planes(xr, xi, "concatstore")
    if not xr.is_cuda:
        return copy_split_plain(xr, xi)
    return _lane_launch("concatstore", _build.library().gdsp_concatstore, xr, xi)


def gmm_concat(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K14c gmm_concat: K13's contraction, every slice of a row tile stored
    as whole rows; equal to K13's result."""
    _check_lane_planes(xr, xi, "gmm_concat")
    if not xr.is_cuda:
        return gmm_floor_plain(xr, xi)
    return _lane_launch("gmm_concat", _build.library().gdsp_gmm_concat, xr, xi,
                        gmm_tables(xr.shape[1], xr.device))
