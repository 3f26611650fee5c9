"""K14a-f, K14h and K14i: the Hopper probes, each beside its plain version.

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

K14h and K14i: the butterfly twins of tools/probe_vdif.py and
tools/probe_sdif.py in csrc/dif_probe_kernels.cu, whose header says what
bounds them on the H100 and what their designs do.  Neither multiplies a
dense matrix:

  vdif(xr, xi, scale)  replaces tools/probe_vdif.py:116 (vdif_op over
      _vdif_kernel): two float32 planes (b, n), n = n1 x 128 with n1 in
      1, 2, 4, 8; per row the n1-point DFT across the slices, the twiddle
      T[k1, p] = W_n^{k1 p} x scale, then a 128-point radix-2 DIF along
      each slice; position k1 128 + p holds bin k1 + n1 brev7(p) (the vdif
      digit order, vdif_digit_order); plain version vdif_plain;
  sdif_peel(xr, xi)    replaces tools/probe_sdif.py:116 (sdif_peel over
      _sdif_kernel): (..., 128, m) float32 planes; seven radix-2 DIF
      stages across the 128 rows, then the post twiddle
      Tb[r, t] = W_N^{brev7(r) t}, N = 128 m; row r holds the dense peel's
      row brev7(r), i.e. cuda_outer.outer_dft_split(x, 128, 1)'s; plain
      version sdif_peel_plain.

Their tables are built in float64 and rounded once: the port carries the
lane DIF's arithmetic (brev7_perm, the stage twiddles W_{2w}^j) rather
than godsp_tpu's _lane_dft module, and Tb is K8's exact-exponent factored
table (cuda_outer._factor_tables).  The TPU's roll-and-select lane
stages and its hi x lo lane-grid layout of Tb were Mosaic workarounds and
are not ported.

K14e and K14f: the twins of tools/probe_r4.py's lane flip and of
tools/probe_r3.py's run_variant bodies, which take the TPU's lane-slice K1
(pallas_fft._fft_kernel_ls) apart, in csrc/lane_slice_probe_kernels.cu,
whose header says what bounds them on the H100.  The lane-slice twins take
two float32 planes (b, n), n = n1 x 128 with n1 in 1, 2, 4, 8:

  lane_flip(x)         replaces tools/probe_r4.py:67 (kf): y[..., 127 - c]
      = 2 x[..., c] over a last axis of 128 points, by warp shuffles,
      exactly; plain version lane_flip_plain;
  ls_network(xr, xi)   replaces tools/probe_r3.py:157 k_step1_only: the
      n1-point DFT across a row's slices (slice k1 out at columns
      128 k1 ..); plain version ls_network_plain;
  gmm_tf32(xr, xi)     replaces k_gmm_default: K13's Karatsuba contraction
      with each product in one TF32 pass on the tensor cores (or with any
      (n1, 3, 128, 128) tables g); plain version gmm_tf32_plain, which with
      tf32=True rounds a, b, a + b and the tables as cvt.rna.tf32.f32 does;
  ls_full(xr, xi, store, chunks, rows_per_block)  replaces k_full,
      k_full_concat, make_subtiled(2/4/8) and k_full at bt 512 / 1024: the
      n-point DFT of every row, the network then K13's contraction with
      unscaled G (ls_tables) in one kernel, position 128 k1 + k2 holding bin
      k1 + n1 k2 (ls_digit_order); every setting gives the same result;
      plain version ls_full_plain;
  fft_pow2_rows(xr, xi, rows_per_block)  K1 (csrc/fft_kernels.cu) at a
      given rows a block, the TPU probes' batch-tile sweep; equal to
      cuda_fft.fft_pow2; raises where the rows pass one block's 227 KB.

gmm_tf32 is the port's second TF32 path on purpose (after bd_tf32): it
measures the TPU's one-pass DEFAULT matmul of the dense step and changes
no TF32 flag.

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
from godsp_tpu_torch.ops.cuda_fft import (
    MAX_N,
    fft_pow2_plain,
    rfft_pow2_plain,
    supported_size,
    twiddle_table,
)
from godsp_tpu_torch.ops.cuda_metrics import (
    LANES,
    _cuda_planes,
    copy_split_plain,
    gmm_floor_plain,
    gmm_groups,
    gmm_tables,
)
from godsp_tpu_torch.ops.cuda_metrics import _check as _check_planes
from godsp_tpu_torch.ops.cuda_outer import _exp_table, _factor_tables
from godsp_tpu_torch.ops.cuda_pwelch import (
    fused_supported,
    pwelch_power_partials_plain,
    segs_per_tile,
)

__all__ = [
    "LS_CHUNKS",
    "LS_N1",
    "LS_STORES",
    "LS_TILE",
    "add_one_plain",
    "anat_full",
    "anat_full_plain",
    "bd_hi",
    "bd_hi_plain",
    "bd_tf32",
    "bd_tf32_plain",
    "brev7_perm",
    "concatstore",
    "fac_dft",
    "fac_dft_plain",
    "fac_tables",
    "fft_pow2_rows",
    "fft_rows_fit",
    "gmm_concat",
    "gmm_tf32",
    "gmm_tf32_plain",
    "half3",
    "half3_plain",
    "hi_tables",
    "lane_flip",
    "lane_flip_plain",
    "launches",
    "ls_digit_order",
    "ls_full",
    "ls_full_plain",
    "ls_network",
    "ls_network_plain",
    "ls_tables",
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
    "sdif_peel",
    "sdif_peel_plain",
    "sdif_tables",
    "slice8_add",
    "slicestore",
    "staged_segs_per_tile",
    "vdif",
    "vdif_digit_order",
    "vdif_plain",
    "vdif_tables",
]

# Kernel launches by wrapper, counted where each launches its kernel.
launches = {"pwfloor_loadonly": 0, "pwfloor_frameonly": 0, "pwfloor_noframe": 0,
            "pwfloor_staged": 0, "fac_dft": 0, "slicestore": 0, "concatstore": 0,
            "gmm_concat": 0, "half3": 0, "slice8_add": 0, "reshape_add": 0, "bd_tf32": 0,
            "bd_hi": 0, "anat_full": 0, "vdif": 0, "sdif_peel": 0, "ls_network": 0,
            "gmm_tf32": 0, "ls_full": 0, "lane_flip": 0, "fft_pow2_rows": 0}

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


# ---------------------------------------------------------------------------
# K14h and K14i: the butterfly twins
# ---------------------------------------------------------------------------

VDIF_N1 = (1, 2, 4, 8)  # slices of a row vdif takes: n = n1 x 128
PEEL_ROWS = 128  # rows of sdif_peel's column DFT
_STAGE_WS = (64, 32, 16, 8, 4, 2, 1)  # half-widths of the seven radix-2 DIF stages


def brev7_perm() -> torch.Tensor:
    """p -> the 7-bit reversal of p, p < 128, int64: the bin at lane p of
    vdif's slices and the dense peel row at sdif's row p."""
    p = torch.arange(LANES)
    return sum(((p >> k) & 1) << (6 - k) for k in range(7))


@lru_cache(maxsize=None)
def _stage_twiddles() -> np.ndarray:
    """complex128 (127,): W_{2w}^j, j < w, for w = 64, 32, ..., 1 one after
    another (stage w at offset 128 - 2w)."""
    return np.concatenate([np.exp(-1j * np.pi * np.arange(w, dtype=np.float64) / w)
                           for w in _STAGE_WS])


def _c32(t: np.ndarray, device) -> tuple[torch.Tensor, torch.Tensor]:
    return tuple(torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(device)
                 for v in (t.real, t.imag))


def vdif_tables(n1: int, scale: float = 1.0, device=None) -> dict[str, torch.Tensor]:
    """K14h's tables, float32 rounded once from float64: "tr"/"ti" (n1, 128),
    T[k1, p] = W_{128 n1}^{k1 p} x scale (four_step.twiddle_2d), and
    "sr"/"si" (127,), the seven lane stages' W_{2w}^j (offset 128 - 2w)."""
    tr, ti = _c32(twiddle_2d(n1, LANES) * scale, device)
    sr, si = _c32(_stage_twiddles(), device)
    return {"tr": tr, "ti": ti, "sr": sr, "si": si}


@lru_cache(maxsize=None)
def _vdif_packed(n1: int, scale: float, device: torch.device) -> torch.Tensor:
    """The kernel's table: T then the stages, (n1 128 + 127, 2) float32."""
    t = vdif_tables(n1, scale, device)
    return torch.cat([torch.stack([t["tr"].reshape(-1), t["ti"].reshape(-1)], -1),
                      torch.stack([t["sr"], t["si"]], -1)]).contiguous()


@lru_cache(maxsize=None)
def _sdif_columns() -> np.ndarray:
    """complex128 (7, 128): stage s's column, W_{2h}^{i mod h} on b rows
    (i // h odd, h = 64 >> s) and 1 on a rows."""
    i = np.arange(PEEL_ROWS)
    return np.stack([np.where((i // h) % 2 == 1, np.exp(-1j * np.pi * (i % h) / h), 1.0 + 0j)
                     for h in (64 >> s for s in range(7))])


def sdif_tables(m: int, device=None) -> dict:
    """K14i's tables for (128, m) planes: "cr"/"ci" (7, 128) float32, stage
    s's column (h = 64 >> s): W_{2h}^{i mod h} on b rows (i // h odd) and 1
    on a rows, rounded once from float64; "hi", "lo", "lo_bits": the post
    twiddle's W_N^p = hi[p >> lo_bits] lo[p & (2^lo_bits - 1)], N = 128 m,
    K8's factored tables (cuda_outer._factor_tables)."""
    cr, ci = _c32(_sdif_columns(), device)
    hi, lo, lo_bits = _factor_tables(PEEL_ROWS * m, False, torch.device(device or "cpu"))
    return {"cr": cr, "ci": ci, "hi": hi, "lo": lo, "lo_bits": lo_bits}


@lru_cache(maxsize=None)
def _sdif_cols_packed(device: torch.device) -> torch.Tensor:
    cr, ci = _c32(_sdif_columns(), device)
    return torch.stack([cr, ci], -1).contiguous()


def _cdtype(x: torch.Tensor) -> torch.dtype:
    return torch.complex128 if x.dtype == torch.float64 else torch.complex64


def _check_vdif(xr: torch.Tensor, xi: torch.Tensor) -> tuple[int, int]:
    b, n = _check_planes(xr, xi, "vdif")
    if n % LANES or n // LANES not in VDIF_N1:
        raise ValueError(f"vdif: n must be n1 x {LANES} with n1 in {VDIF_N1}, got {n}")
    return b, n


def _check_sdif(xr: torch.Tensor, xi: torch.Tensor) -> int:
    if xr.shape != xi.shape or xr.dim() < 2 or xr.shape[-2] != PEEL_ROWS or xr.shape[-1] < 1:
        raise ValueError(f"sdif_peel: two (..., {PEEL_ROWS}, m) planes of one shape, got "
                         f"{tuple(xr.shape)} and {tuple(xi.shape)}")
    return xr.shape[-1]


def vdif_digit_order(f: torch.Tensor, n1: int) -> torch.Tensor:
    """A natural spectrum (..., n) in vdif digit order: position k1 128 + p
    holds bin k1 + n1 brev7(p)."""
    v = f.reshape(*f.shape[:-1], f.shape[-1] // n1, n1).transpose(-1, -2)
    return v[..., brev7_perm().to(f.device)].reshape(f.shape)


def vdif_plain(xr: torch.Tensor, xi: torch.Tensor,
               scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of K14h in the input's dtype (complex128 for
    float64 planes): the n1-point DFT across the slices, T, then the seven
    radix-2 DIF stages along each slice; the vdif digit order out."""
    b, n = _check_vdif(xr, xi)
    n1, dev, cdt = n // LANES, xr.device, _cdtype(xr)
    f = torch.from_numpy(dft_matrix(n1)).to(dev, cdt)
    t = torch.from_numpy(twiddle_2d(n1, LANES) * scale).to(dev, cdt)
    x = torch.complex(xr, xi).to(cdt).reshape(b, n1, LANES)
    with _tf32_off() if x.is_cuda else nullcontext():
        z = torch.einsum("kj,bjp->bkp", f, x) * t
    tw = torch.from_numpy(_stage_twiddles()).to(dev, cdt)
    for w in _STAGE_WS:
        z = z.reshape(b, n1, LANES // (2 * w), 2, w)
        lo, hi = z[..., 0, :], z[..., 1, :]
        z = torch.stack([lo + hi, (lo - hi) * tw[LANES - 2 * w:LANES - w]], dim=-2)
    z = z.reshape(b, n)
    return z.real.contiguous(), z.imag.contiguous()


def sdif_peel_plain(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of K14i in the input's dtype: the seven radix-2
    DIF stages across the 128 rows of (..., 128, m) planes, then
    Tb[r, t] = W_N^{brev7(r) t} (the exponent exact in int64)."""
    m = _check_sdif(xr, xi)
    lead, dev, cdt = xr.shape[:-2], xr.device, _cdtype(xr)
    x = torch.complex(xr, xi).to(cdt).reshape(-1, PEEL_ROWS, m)
    cols = torch.from_numpy(_sdif_columns()).to(dev, cdt)
    for s in range(7):
        h = 64 >> s
        x = x.reshape(x.shape[0], PEEL_ROWS // (2 * h), 2, h, m)
        a, c = x[:, :, 0], x[:, :, 1]
        wb = cols[s].reshape(PEEL_ROWS // (2 * h), 2, h)[:, 1, :, None]
        x = torch.stack([a + c, (a - c) * wb], dim=2)
    tb = _exp_table(PEEL_ROWS * m, brev7_perm().to(dev),
                    torch.arange(m, device=dev), False).to(cdt)
    y = (x.reshape(-1, PEEL_ROWS, m) * tb).reshape(*lead, PEEL_ROWS, m)
    return y.real.contiguous(), y.imag.contiguous()


def vdif(xr: torch.Tensor, xi: torch.Tensor,
         scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """K14h: the n-point DFT (n = n1 x 128, n1 in 1, 2, 4, 8) of every row of
    two float32 planes (b, n), times scale, by the slice network, T and a
    warp-shuffle 128-point DIF; the vdif digit order out."""
    _, n = _check_vdif(xr, xi)
    if not xr.is_cuda:
        return vdif_plain(xr, xi, scale)
    return _lane_launch("vdif", _build.library().gdsp_vdif, xr, xi,
                        _vdif_packed(n // LANES, float(scale), xr.device))


def sdif_peel(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K14i: the 128-point peel of (..., 128, m) float32 planes by seven
    shared-memory radix-2 stages, then Tb; row r holds
    outer_dft_split(x, 128, 1)'s row brev7(r)."""
    m = _check_sdif(xr, xi)
    if not xr.is_cuda:
        return sdif_peel_plain(xr, xi)
    xr, xi = _cuda_planes(xr, xi, "sdif_peel")
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    dev = xr.device
    hi, lo, lo_bits = _factor_tables(PEEL_ROWS * m, False, dev)
    _launch("sdif_peel", _build.library().gdsp_sdif_peel, yr,
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            _sdif_cols_packed(dev).data_ptr(), hi.data_ptr(), lo.data_ptr(), m,
            xr.numel() // (PEEL_ROWS * m), lo_bits)
    return yr, yi


# ---------------------------------------------------------------------------
# K14e and K14f: the lane flip and the lane-slice K1 taken apart
# ---------------------------------------------------------------------------

LS_N1 = (1, 2, 4, 8)  # slices of a row the lane-slice twins take: n = n1 x 128
LS_TILE = 16  # rows of an ls_full tile
LS_CHUNKS = (1, 2, 4, 8)  # ls_full's chunks of a tile (make_subtiled's n_sub)
LS_STORES = ("slices", "rows")  # ls_full's stores: k_full's and k_full_concat's


def _check_ls(xr: torch.Tensor, xi: torch.Tensor, name: str) -> tuple[int, int]:
    b, n = _check_planes(xr, xi, name)
    if n % LANES or n // LANES not in LS_N1:
        raise ValueError(f"{name}: n must be n1 x {LANES} with n1 in {LS_N1}, got {n}")
    return b, n


def ls_digit_order(f: torch.Tensor, n1: int) -> torch.Tensor:
    """A natural spectrum (..., n) in the lane-slice digit order: position
    128 k1 + k2 holds bin k1 + n1 k2 (pallas_fft._digit_to_natural's
    inverse)."""
    return f.reshape(*f.shape[:-1], LANES, n1).transpose(-1, -2).reshape(f.shape)


@lru_cache(maxsize=None)
def ls_tables(n: int, device: torch.device) -> torch.Tensor:
    """ls_full's G tables: K13's (gmm_tables) times 128, exactly
    pallas_fft._ls_tables(n, False, False)'s gr, gi, gs rounded once from
    float64 (a power-of-2 scale commutes with the rounding)."""
    return gmm_tables(n, device) * float(LANES)


def ls_network_plain(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of ls_network in the input's dtype: slice k1 of
    the output is sum_j x[128 j + p] W_n1^{j k1}, the n1-point DFT across
    the slices (dft_matrix, float64-built)."""
    b, n = _check_ls(xr, xi, "ls_network")
    n1, cdt = n // LANES, _cdtype(xr)
    f = torch.from_numpy(dft_matrix(n1)).to(xr.device, cdt)
    x = torch.complex(xr, xi).to(cdt).reshape(b, n1, LANES)
    with _tf32_off() if x.is_cuda else nullcontext():
        z = torch.einsum("kj,bjp->bkp", f, x).reshape(b, n)
    return z.real.contiguous(), z.imag.contiguous()


def gmm_tf32_plain(xr: torch.Tensor, xi: torch.Tensor, tf32: bool = False,
                   g: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """K13's Karatsuba contraction of every slice with the (n1, 3, 128, 128)
    tables g (default K13's, gmm_tables): m1 = a G_r, m2 = b G_i,
    m3 = (a + b) G_s, yr = m1 - m2, yi = m3 - m1 - m2, summed in the input's
    dtype; tf32 rounds a, b, a + b (added in float32) and the tables first,
    as the kernel's cvt.rna.tf32.f32 does (round_tf32)."""
    b, n = _check_lane_planes(xr, xi, "gmm_tf32")
    g = gmm_tables(n, xr.device) if g is None else g.to(xr.device)
    a, c = (_slices(v).transpose(0, 1) for v in (xr, xi))
    s = a + c
    gr, gi, gs = (g[:, p].to(xr.dtype) for p in range(3))
    if tf32:
        a, c, s, gr, gi, gs = (round_tf32(v) for v in (a, c, s, gr, gi, gs))
    with _tf32_off() if xr.is_cuda else nullcontext():
        m1, m2, m3 = a @ gr, c @ gi, s @ gs
    return ((m1 - m2).transpose(0, 1).reshape(b, n),
            (m3 - m1 - m2).transpose(0, 1).reshape(b, n))


def ls_full_plain(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of ls_full in the input's dtype: ls_network, then
    K13's twiddled 128-point DFT of each slice times 128: the n-point DFT of
    every row in the lane-slice digit order (ls_digit_order)."""
    _check_ls(xr, xi, "ls_full")
    yr, yi = gmm_floor_plain(*ls_network_plain(xr, xi))
    return yr * float(LANES), yi * float(LANES)


def lane_flip_plain(x: torch.Tensor) -> torch.Tensor:
    """2 x with its last axis (128 points) reversed, in x's dtype."""
    return torch.flip(x, (-1,)) * 2.0


def fft_rows_fit(n: int, rows_per_block: int) -> bool:
    """Whether rows_per_block rows of n complex float32 values fit in the
    shared memory of one block (227 KB)."""
    return rows_per_block >= 1 and rows_per_block * n * 8 <= _SMEM_BYTES


def ls_network(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K14f network: the n1-point DFT across the slices of every row of two
    float32 planes (b, n), n = n1 x 128, n1 in 1, 2, 4, 8; slice k1 out at
    columns [128 k1, 128 k1 + 128)."""
    _check_ls(xr, xi, "ls_network")
    if not xr.is_cuda:
        return ls_network_plain(xr, xi)
    return _lane_launch("ls_network", _build.library().gdsp_ls_network, xr, xi)


def gmm_tf32(xr: torch.Tensor, xi: torch.Tensor,
             g: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """K14f gmm_default: K13's contraction (or with the (n1, 3, 128, 128)
    float32 tables g) with each Karatsuba product in one TF32 pass on the
    tensor cores; no TF32 flag is touched."""
    b, n = _check_lane_planes(xr, xi, "gmm_tf32")
    if g is not None and tuple(g.shape) != (n // LANES, 3, LANES, LANES):
        raise ValueError(f"gmm_tf32: g must be ({n // LANES}, 3, {LANES}, {LANES}), "
                         f"got {tuple(g.shape)}")
    if not xr.is_cuda:
        return gmm_tf32_plain(xr, xi, tf32=True, g=g)
    g = gmm_tables(n, xr.device) if g is None else _cuda_args("gmm_tf32", xr, g)[1]
    xr, xi = _cuda_planes(xr, xi, "gmm_tf32")
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    _launch("gmm_tf32", _build.library().gdsp_gmm_tf32, yr, xr.data_ptr(), xi.data_ptr(),
            yr.data_ptr(), yi.data_ptr(), g.data_ptr(), b, n, gmm_groups(b, n))
    return yr, yi


def ls_full(xr: torch.Tensor, xi: torch.Tensor, store: str = "slices", chunks: int = 1,
            rows_per_block: int = LS_TILE) -> tuple[torch.Tensor, torch.Tensor]:
    """K14f full: the n-point DFT (n = n1 x 128, n1 in 1, 2, 4, 8) of every
    row of two float32 planes, the TPU's lane-slice K1 (slice network, then
    K13's contraction with unscaled G), in the lane-slice digit order.
    store "slices" stores each slice as its contraction ends (k_full),
    "rows" whole rows after a tile (k_full_concat); chunks 1, 2, 4, 8 runs
    network and contraction on 16 / chunks rows of a tile at a time
    (make_subtiled); rows_per_block 16, 32, 64 rows a block are the TPU's
    bt 256, 512, 1024 (x1, x2, x4).  Every setting gives the same result."""
    b, n = _check_ls(xr, xi, "ls_full")
    if store not in LS_STORES:
        raise ValueError(f"ls_full: store must be one of {LS_STORES}, got {store!r}")
    if chunks not in LS_CHUNKS:
        raise ValueError(f"ls_full: chunks must be one of {LS_CHUNKS}, got {chunks}")
    if rows_per_block < LS_TILE or rows_per_block % LS_TILE:
        raise ValueError(f"ls_full: rows_per_block must be a positive multiple of {LS_TILE}, "
                         f"got {rows_per_block}")
    if not xr.is_cuda:
        return ls_full_plain(xr, xi)
    xr, xi = _cuda_planes(xr, xi, "ls_full")
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    _launch("ls_full", _build.library().gdsp_ls_full, yr, xr.data_ptr(), xi.data_ptr(),
            yr.data_ptr(), yi.data_ptr(), ls_tables(n, xr.device).data_ptr(), b, n,
            rows_per_block, LS_TILE // chunks, int(store == "rows"))
    return yr, yi


def lane_flip(x: torch.Tensor) -> torch.Tensor:
    """K14e: y[..., 127 - c] = 2 x[..., c] over a float32 tensor whose last
    axis holds 128 points, by warp shuffles; exact."""
    if x.dim() < 1 or x.shape[-1] != LANES:
        raise ValueError(f"lane_flip: the last axis must hold {LANES} points, got "
                         f"{tuple(x.shape)}")
    if not x.is_cuda:
        return lane_flip_plain(x)
    x = _cuda_args("lane_flip", x)[0]
    if x.data_ptr() % 16:
        x = x.clone()
    y = torch.empty_like(x)
    return _launch("lane_flip", _build.library().gdsp_lane_flip, y, x.data_ptr(), y.data_ptr(),
                   x.numel() // LANES)


def fft_pow2_rows(xr: torch.Tensor, xi: torch.Tensor,
                  rows_per_block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 (cuda_fft.fft_pow2's forward DFT of split float32 planes (..., n),
    natural order) launched with rows_per_block rows a block, the probes'
    batch-tile sweep; raises where those rows pass one block's shared
    memory.  Every setting gives fft_pow2's result."""
    n = xr.shape[-1]
    if xi.shape != xr.shape or not supported_size(n):
        raise ValueError(f"fft_pow2_rows: two (..., n) planes of one shape, n a power of 2 "
                         f"up to {MAX_N}, got {tuple(xr.shape)} and {tuple(xi.shape)}")
    if not fft_rows_fit(n, rows_per_block):
        raise ValueError(f"fft_pow2_rows: {rows_per_block} rows of {n} points a block do not "
                         f"fit in {_SMEM_BYTES} bytes of shared memory")
    if not xr.is_cuda:
        return fft_pow2_plain(xr, xi)
    xr, xi = _cuda_args("fft_pow2_rows", xr, xi)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    _launch("fft_pow2_rows", _build.library().gdsp_fft_pow2_rows, yr, xr.data_ptr(),
            xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            twiddle_table(n, False, xr.device).data_ptr(), n.bit_length() - 1, n,
            xr.numel() // n, 1.0, rows_per_block)
    return yr, yi
