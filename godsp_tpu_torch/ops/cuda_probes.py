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

K14d: the anatomy twins of tools/probe_anatomy2.py's run_kernel_variant
(one pl.pallas_call at :87 over seven bodies), in
csrc/anatomy_probe_kernels.cu, whose header says what bounds them on the
H100.  The first body, v0copy, is K12 (cuda_metrics.copy_split).  Each
takes two float32 planes (b, n), n = n1 x 128:

  half3(xr, xi)        replaces v1half3 (:128): three rounds of
      a <- [u + v, u - v], u and v the row's halves, both planes, in
      shared memory; plain version half3_plain (equal in float32);
  slice8_add(xr, xi)   replaces v2slice8 (:140) and
  reshape_add(xr, xi)  replaces v3reshape (:148): x + 1, a 128-column
      slice a pass or one warp a row of the (b n / 128, 128) view; plain
      version add_one_plain (equal);
  bd_tf32(xr, xi)      replaces v4bd1 (:176): each plane's 128-point
      slices times Re F128 in one TF32 pass on the tensor cores (or times
      `table`, any (128, 128) float32 table); plain version bd_tf32_plain,
      which with tf32=True rounds both operands as cvt.rna.tf32.f32 does
      (round_tf32) and sums in the input's dtype;
  bd_hi(xr, xi)        replaces v5bd_hi (:190): the 128-point DFT of every
      slice, unscaled, by Karatsuba in 3xTF32 (float32 accuracy); plain
      version bd_hi_plain, the same Karatsuba in the input's dtype;
  anat_full(xr, xi, tw) replaces v6full (:203): half3, the row tw
      (ar = a tw - b tw, ai = a tw + b tw), then bd_hi, in one kernel;
      plain version anat_full_plain.

bd_tf32 is the port's only TF32 path, on purpose: it measures one
reduced-precision pass (the TPU's DEFAULT matmul) and changes no TF32
flag; nothing held to the 120 dB bar goes through it.  bd_hi's tables
are the big and small TF32 halves of Re F, Im F and Re F + Im F as
128-entry vectors over j k mod 128, split from float64 on the host
(hi_tables).

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
    "add_one_plain",
    "anat_full",
    "anat_full_plain",
    "bd_hi",
    "bd_hi_plain",
    "bd_tf32",
    "bd_tf32_plain",
    "concatstore",
    "fac_dft",
    "fac_dft_plain",
    "fac_tables",
    "gmm_concat",
    "half3",
    "half3_plain",
    "hi_tables",
    "launches",
    "pwfloor_frameonly",
    "pwfloor_frameonly_plain",
    "pwfloor_loadonly",
    "pwfloor_loadonly_plain",
    "pwfloor_noframe",
    "pwfloor_noframe_plain",
    "pwfloor_staged",
    "pwfloor_staged_plain",
    "re_f128",
    "reshape_add",
    "round_tf32",
    "slice8_add",
    "slicestore",
    "staged_segs_per_tile",
]

# Kernel launches by wrapper, counted where each launches its kernel.
launches = {"pwfloor_loadonly": 0, "pwfloor_frameonly": 0, "pwfloor_noframe": 0,
            "pwfloor_staged": 0, "fac_dft": 0, "slicestore": 0, "concatstore": 0,
            "gmm_concat": 0, "half3": 0, "slice8_add": 0, "reshape_add": 0, "bd_tf32": 0,
            "bd_hi": 0, "anat_full": 0}

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


# ---------------------------------------------------------------------------
# K14d: the anatomy twins
# ---------------------------------------------------------------------------

MAX_STAGED_N = 16384  # widest row half3 and anat_full stage in shared memory


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on the float32 bits of x: 10 mantissa bits, round
    to nearest, ties away from zero; returned in x's dtype (a float64 x is
    taken as the float32 values it holds)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32).to(x.dtype)



@lru_cache(maxsize=None)
def _f128() -> np.ndarray:
    return dft_matrix(LANES)


def re_f128(device=None, dtype=torch.float32) -> torch.Tensor:
    """Re F128, (128, 128), F[j, k] = exp(-2 pi i j k / 128), unscaled,
    from float64."""
    return torch.from_numpy(_f128().real.copy()).to(device=device, dtype=dtype)


def hi_tables() -> np.ndarray:
    """bd_hi's tables, (6, 128) float32: the TF32 big and small halves of
    Re F, Im F and Re F + Im F over m = j k mod 128 (F[j, k] = F[1, m]),
    split from float64: big = round_tf32(v), small = round_tf32(v - big)."""
    w = torch.from_numpy(_f128()[1])
    rows = []
    for v in (w.real, w.imag, w.real + w.imag):
        big = round_tf32(v.float())
        rows += [big, round_tf32((v - big.double()).float())]
    return torch.stack(rows).numpy()


@lru_cache(maxsize=None)
def _hi_packed(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(hi_tables().ravel()).to(device)


@lru_cache(maxsize=None)
def _re_f128_on(device: torch.device) -> torch.Tensor:
    return re_f128(device)


def _check_staged(xr: torch.Tensor, xi: torch.Tensor, name: str) -> tuple[int, int]:
    b, n = _check_lane_planes(xr, xi, name)
    if n > MAX_STAGED_N:
        raise ValueError(f"{name}: n must be at most {MAX_STAGED_N}, got {n}")
    return b, n


def _slices(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], x.shape[1] // LANES, LANES)


def half3_plain(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Three literal rounds of a <- [u + v, u - v], h = n / 2 each round,
    both planes, in the input's dtype."""
    _check_lane_planes(xr, xi, "half3")
    h = xr.shape[1] // 2
    for _ in range(3):
        xr = torch.cat([xr[:, :h] + xr[:, h:], xr[:, :h] - xr[:, h:]], dim=1)
        xi = torch.cat([xi[:, :h] + xi[:, h:], xi[:, :h] - xi[:, h:]], dim=1)
    return xr, xi


def add_one_plain(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x + 1, both planes, in the input's dtype."""
    return xr + 1.0, xi + 1.0


def bd_tf32_plain(xr: torch.Tensor, xi: torch.Tensor, tf32: bool = False,
                  table: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Each plane's 128-point slices times `table` (default Re F128), summed
    in the input's dtype; tf32 rounds both operands first as
    cvt.rna.tf32.f32 does (round_tf32: the kernel's function)."""
    b, n = _check_lane_planes(xr, xi, "bd_tf32")
    t = re_f128(xr.device, xr.dtype) if table is None else table.to(xr.device, xr.dtype)
    if tf32:
        xr, xi, t = round_tf32(xr), round_tf32(xi), round_tf32(t)
    with _tf32_off() if xr.is_cuda else nullcontext():
        return tuple((_slices(x) @ t).reshape(b, n) for x in (xr, xi))


def bd_hi_plain(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 128-point DFT of every slice, unscaled, by Karatsuba in the
    input's dtype: m1 = a F_r, m2 = b F_i, m3 = (a + b)(F_r + F_i),
    yr = m1 - m2, yi = m3 - m1 - m2 (F from float64)."""
    b, n = _check_lane_planes(xr, xi, "bd_hi")
    f = _f128()
    fr, fi, fs = (torch.from_numpy(np.ascontiguousarray(v)).to(xr.device, xr.dtype)
                  for v in (f.real, f.imag, f.real + f.imag))
    a, c = _slices(xr), _slices(xi)
    with _tf32_off() if xr.is_cuda else nullcontext():
        m1, m2, m3 = a @ fr, c @ fi, (a + c) @ fs
    return (m1 - m2).reshape(b, n), (m3 - m1 - m2).reshape(b, n)


def anat_full_plain(xr: torch.Tensor, xi: torch.Tensor,
                    tw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """half3, then ar = a tw - b tw, ai = a tw + b tw, then bd_hi."""
    a, c = half3_plain(xr, xi)
    tw = tw.to(a.dtype)
    return bd_hi_plain(a * tw - c * tw, a * tw + c * tw)


def half3(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K14d half3: three shared-memory butterfly rounds of both planes."""
    _check_staged(xr, xi, "half3")
    if not xr.is_cuda:
        return half3_plain(xr, xi)
    return _lane_launch("half3", _build.library().gdsp_half3, xr, xi)


def slice8_add(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K14d slice8: x + 1, one 128-column slice of each row a pass."""
    _check_lane_planes(xr, xi, "slice8_add")
    if not xr.is_cuda:
        return add_one_plain(xr, xi)
    return _lane_launch("slice8_add", _build.library().gdsp_slice8_add, xr, xi)


def reshape_add(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K14d reshape: x + 1 over the (b n / 128, 128) view, one warp a row."""
    _check_lane_planes(xr, xi, "reshape_add")
    if not xr.is_cuda:
        return add_one_plain(xr, xi)
    return _lane_launch("reshape_add", _build.library().gdsp_reshape_add, xr, xi)


def bd_tf32(xr: torch.Tensor, xi: torch.Tensor,
            table: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """K14d bd1: each plane's slices times Re F128 (or `table`, (128, 128)
    float32) in one TF32 pass on the tensor cores."""
    _check_lane_planes(xr, xi, "bd_tf32")
    if table is not None and tuple(table.shape) != (LANES, LANES):
        raise ValueError(f"bd_tf32: table must be ({LANES}, {LANES}), got {tuple(table.shape)}")
    if not xr.is_cuda:
        return bd_tf32_plain(xr, xi, tf32=True, table=table)
    t = _re_f128_on(xr.device) if table is None else _cuda_args("bd_tf32", xr, table)[1]
    return _lane_launch("bd_tf32", _build.library().gdsp_bd_tf32, xr, xi, t)


def bd_hi(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K14d bd_hi: the unscaled 128-point DFT of every slice, Karatsuba in
    3xTF32 on the tensor cores."""
    _check_lane_planes(xr, xi, "bd_hi")
    if not xr.is_cuda:
        return bd_hi_plain(xr, xi)
    return _lane_launch("bd_hi", _build.library().gdsp_bd_hi, xr, xi, _hi_packed(xr.device))


def anat_full(xr: torch.Tensor, xi: torch.Tensor,
              tw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K14d full: half3, the row tw, then bd_hi, in one kernel."""
    _, n = _check_staged(xr, xi, "anat_full")
    if tuple(tw.shape) != (n,):
        raise ValueError(f"anat_full: tw must have shape ({n},), got {tuple(tw.shape)}")
    if not xr.is_cuda:
        return anat_full_plain(xr, xi, tw)
    tw = _cuda_args("anat_full", xr, tw)[1]
    return _lane_launch("anat_full", _build.library().gdsp_anat_full, xr, xi, tw,
                        _hi_packed(xr.device))
