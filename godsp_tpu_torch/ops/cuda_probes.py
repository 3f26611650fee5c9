"""K14a-i: the Hopper probes, each beside its plain version.

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
      (..., n_tiles, pad//2 + 1), equal to the partials of K4's first
      design (pwelch_radix2) at the same tiles.

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
      given rows a CTA, the TPU probes' batch-tile sweep; equal to
      cuda_fft.fft_pow2; raises where the CTA passes the kernel's launch
      bound (512 threads a CTA for n <= 1024, 1024 above) or one block's
      227 KB of shared memory (cuda_fft.cta_fits).

The first designs of K1, K4, K5, K7 and K8, kept off the main path as
the yardsticks of their redesigns (csrc/radix2_probe_kernels.cu; they
replace no TPU kernel of their own):

  fft_pow2_radix2(xr, xi|None, inverse, scale, bins)  the radix-2
      fft_pow2_kernel K1 first ran (bit-reversed load into shared memory,
      log2 n stages of fft_block.cuh's block_fft_rows; bins = n/2 + 1 with
      a real input is K3's first design); plain version
      cuda_fft.fft_pow2_plain;
  stft_radix2(x, w, nfft, stride, total_segs, pad, out, fb)  the stft_kernel
      K5 first ran (frames loaded bit-reversed into shared memory, the
      pad-point complex FFT by block_fft_rows, the mode's epilogue), any
      mode; plain version cuda_stft.stft_pallas_plain;
  outer_dft_radix2(xr, xi, d1, d2, inverse)  the outer_dft_kernel K8 first
      ran (a column tile staged bit-reversed in shared memory, block_fft_rows,
      the hi/lo twiddle); plain version cuda_outer.outer_dft_split_plain;
  pwelch_radix2(ext, mask, w, nfft, stride, pad)  the pwelch_partials_kernel
      K4 first ran (each segment loaded bit-reversed into shared memory, the
      pad-point complex FFT by block_fft_rows, |X|^2 summed in shared
      memory); plain version cuda_pwelch.pwelch_power_partials_plain;
  csd_radix2(ext_x, ext_y, mask, w, nfft, stride, pad)  the
      csd_partials_kernel K7 first ran (the same for x, then for y in the
      same buffer, X_k in registers); plain version
      cuda_csd.csd_power_partials_plain.
      Nothing under fft/, models/, spectral/ or parallel/ calls them.

gmm_tf32 is the port's second TF32 path on purpose (after bd_tf32): it
measures the TPU's one-pass DEFAULT matmul of the dense step and changes
no TF32 flag.

K14g: the int8-limb contraction twins of tools/probe_int8.py (_call :71
over three bodies; the int8 dot at :213) and K14c's last store twin,
tools/probe_store.py:53 over _i8_concat_kernel, in
csrc/int8_probe_kernels.cu, whose header says what bounds them on the H100
and what the designs do.  Every product is an int8 mma.sync with an exact
int32 sum.  The plane twins take two float32 planes (b, n), n = n1 x 128,
n1 <= 8:

  i8_dot(a, b)          replaces :213 (tiny :204): int8 a (m, k) @ b (k, n)
      into int32, exactly; plain version i8_dot_plain;
  i8mm(xr, xi, tables)  replaces _i8mm_kernel (:93): each slice's a, b,
      a + b quantized (x 100, x 100, x 50, truncated, saturated to int8)
      against random tables (i8mm_tables: default_rng(7) as
      make_i8mm_tables); plain version i8mm_plain;
  i8dec(xr, xi, tables) replaces _i8dec_kernel (:123): the row scales and
      digit ladder with only d0's stacked product; plain version
      i8dec_plain;
  i8full(xr, xi)        replaces _i8full_kernel (:162): karatsuba_g_i8 of
      every slice with the digits of K13's unscaled G (i8full_tables, as
      make_i8full_tables) and extra_scale 1/128: K13's function to ~127
      dB against float64; plain version i8full_plain;
  i8_concat(xr, xi)     replaces _i8_concat_kernel (probe_store.py:101):
      i8full's kernel storing whole rows of a 16-row tile; equal to i8full.

The port keeps its own copy of godsp_tpu/ops/_int8_contract.py's
arithmetic (K_I8, digits3, row_quant_scales, table_digits_np,
stack_tables_np).  Its row_quant_scales reads floor(log2 m) from the
exponent bits and builds 2^k from bits, exactly; the kernels do the same,
and repeat the plain versions' float32 operations in order, so each
equals its plain version bit for bit.  The plain versions make the limb
products in float64, exactly (torch has no integer matmul on CUDA).

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
from godsp_tpu_torch.ops import _build, cuda_csd, cuda_outer, cuda_pwelch, cuda_stft
from godsp_tpu_torch.ops.cuda_fft import (
    MAX_N,
    MAX_SMEM,
    cta_fits,
    fft_pow2_plain,
    rfft_pow2_plain,
    stockham_table,
    supported_size,
    twiddle_table,
)
from godsp_tpu_torch.ops.cuda_metrics import (
    LANES,
    _cuda_planes,
    _g_host,
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
    "I8_MAX_N1",
    "K_I8",
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
    "csd_radix2",
    "digits3",
    "fac_dft",
    "fac_dft_plain",
    "fac_tables",
    "fft_pow2_radix2",
    "fft_pow2_rows",
    "fft_rows_fit",
    "gmm_concat",
    "gmm_tf32",
    "gmm_tf32_plain",
    "half3",
    "half3_plain",
    "hi_tables",
    "i8_concat",
    "i8_dot",
    "i8_dot_plain",
    "i8dec",
    "i8dec_plain",
    "i8full",
    "i8full_plain",
    "i8full_tables",
    "i8mm",
    "i8mm_plain",
    "i8mm_tables",
    "lane_flip",
    "lane_flip_plain",
    "launches",
    "ls_digit_order",
    "ls_full",
    "ls_full_plain",
    "ls_network",
    "ls_network_plain",
    "ls_tables",
    "outer_dft_radix2",
    "pwelch_radix2",
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
    "row_quant_scales",
    "sdif_peel",
    "sdif_peel_plain",
    "sdif_tables",
    "slice8_add",
    "slicestore",
    "stack_tables_np",
    "staged_segs_per_tile",
    "stft_radix2",
    "table_digits_np",
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
            "gmm_tf32": 0, "ls_full": 0, "lane_flip": 0, "fft_pow2_rows": 0, "i8_dot": 0,
            "i8mm": 0, "i8dec": 0, "i8full": 0, "i8_concat": 0, "fft_pow2_radix2": 0,
            "stft_radix2": 0, "outer_dft_radix2": 0, "pwelch_radix2": 0, "csd_radix2": 0}

def _staged_max_bt(nfft: int, stride: int, pad: int) -> int:
    """The most segments a tile whose staged span, FFT buffer and
    accumulator fit in one block's shared memory."""
    room = (MAX_SMEM - 8 * pad - 4 * (pad // 2 + 1)) // 4 - nfft
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
    """Whether K1 launches with rows_per_block rows of n points a CTA: at
    least one row, within the launch bound's threads, and the slots' two
    float32 planes within one block's 227 KB of shared memory
    (cuda_fft.cta_fits)."""
    return cta_fits(n, rows_per_block)


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
    natural order) launched with rows_per_block rows a CTA, the probes'
    batch-tile sweep; raises where that CTA does not fit (fft_rows_fit).
    Every setting gives fft_pow2's result."""
    n = xr.shape[-1]
    if xi.shape != xr.shape or not supported_size(n):
        raise ValueError(f"fft_pow2_rows: two (..., n) planes of one shape, n a power of 2 "
                         f"up to {MAX_N}, got {tuple(xr.shape)} and {tuple(xi.shape)}")
    if not fft_rows_fit(n, rows_per_block):
        raise ValueError(f"fft_pow2_rows: {rows_per_block} rows of {n} points a CTA do not "
                         f"fit the kernel's threads and {MAX_SMEM} bytes of shared memory")
    if not xr.is_cuda:
        return fft_pow2_plain(xr, xi)
    xr, xi = _cuda_args("fft_pow2_rows", xr, xi)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    _launch("fft_pow2_rows", _build.library().gdsp_fft_pow2_rows, yr, xr.data_ptr(),
            xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            stockham_table(n, False, xr.device).data_ptr(), n.bit_length() - 1,
            xr.numel() // n, 1.0, 0, rows_per_block)
    return yr, yi


def fft_pow2_radix2(xr: torch.Tensor, xi: torch.Tensor | None, inverse: bool = False,
                    scale: float = 1.0, bins: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's first design (csrc/radix2_probe_kernels.cu): scale * DFT (or the
    conjugate-table inverse) of split float32 planes (..., n), n = 2..16384,
    natural order, xi None a real input, bins 0..bins-1 of each row stored
    (default n; n/2 + 1 with xi None is K3's first design).  fft_pow2's
    function by the radix-2 shared-memory kernel K1 first ran: a yardstick
    off the main path."""
    n = xr.shape[-1]
    bins = n if bins is None else bins
    if (xi is not None and xi.shape != xr.shape) or not supported_size(n) or not 1 <= bins <= n:
        raise ValueError(f"fft_pow2_radix2: (..., n) planes of one shape, n a power of 2 up "
                         f"to {MAX_N}, 1 <= bins <= n, got {tuple(xr.shape)}, bins {bins}")
    if xi is None and inverse:
        raise ValueError("fft_pow2_radix2: real-input mode is forward-only (xi=None)")
    if not xr.is_cuda:
        yr, yi = fft_pow2_plain(xr, xi, inverse, scale)
        return yr[..., :bins].contiguous(), yi[..., :bins].contiguous()
    planes = _cuda_args("fft_pow2_radix2", *((xr,) if xi is None else (xr, xi)))
    xr, xi = planes[0], (planes[1] if xi is not None else None)
    yr = torch.empty(*xr.shape[:-1], bins, dtype=torch.float32, device=xr.device)
    yi = torch.empty_like(yr)
    _launch("fft_pow2_radix2", _build.library().gdsp_fft_pow2_radix2, yr, xr.data_ptr(),
            None if xi is None else xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            twiddle_table(n, inverse, xr.device).data_ptr(), n.bit_length() - 1, bins,
            xr.numel() // n, float(scale))
    return yr, yi


def stft_radix2(x: torch.Tensor, w: torch.Tensor, nfft: int, stride: int, total_segs: int,
                pad: int | None = None, out: str = "complex",
                fb: torch.Tensor | None = None) -> torch.Tensor:
    """K5's first design (csrc/radix2_probe_kernels.cu): cuda_stft's
    function in mode `out` (complex, power or mel with fb), the same
    shapes and checks, by the radix-2 shared-memory kernel K5 first ran: a
    yardstick off the main path."""
    return cuda_stft._launch(x, w, nfft, stride, total_segs, pad, out, fb,
                             counts=launches, name="stft_radix2", radix2=True)


def outer_dft_radix2(xr: torch.Tensor, xi: torch.Tensor, d1: int, d2: int,
                     inverse: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """K8's first design (csrc/radix2_probe_kernels.cu): outer_dft_split's
    function by the radix-2 shared-memory kernel K8 first ran: a yardstick
    off the main path."""
    if not xr.is_cuda:
        return cuda_outer.outer_dft_split_plain(xr, xi, d1, d2, inverse)
    return cuda_outer._launch(xr, xi, d1, d2, inverse, launches, "outer_dft_radix2", radix2=True)


def pwelch_radix2(ext: torch.Tensor, mask: torch.Tensor, w: torch.Tensor, nfft: int,
                  stride: int, pad: int | None = None) -> torch.Tensor:
    """K4's first design (csrc/radix2_probe_kernels.cu): pwelch_power_partials'
    function, the same shapes, tiles and checks, by the radix-2
    shared-memory kernel K4 first ran: a yardstick off the main path."""
    return cuda_pwelch._launch(ext, mask, w, nfft, stride, pad, "pwelch_radix2", launches,
                               radix2=True)


def csd_radix2(ext_x: torch.Tensor, ext_y: torch.Tensor, mask: torch.Tensor, w: torch.Tensor,
               nfft: int, stride: int,
               pad: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """K7's first design (csrc/radix2_probe_kernels.cu): csd_power_partials'
    function, the same shapes, tiles and checks, by the radix-2
    shared-memory kernel K7 first ran: a yardstick off the main path."""
    return cuda_csd._launch(ext_x, ext_y, mask, w, nfft, stride, pad, "csd_radix2", launches,
                            radix2=True)


# ---------------------------------------------------------------------------
# K14g: the int8-limb contraction twins
# ---------------------------------------------------------------------------

# The port's copy of godsp_tpu/ops/_int8_contract.py's arithmetic (K_I8,
# the ladder offsets, digits3, row_quant_scales, table_digits_np,
# stack_tables_np), in torch and host numpy.
K_I8 = float(2**23 - 2**15 - 2**8)  # ~24 bits, with headroom for the ladder's roundings
_B0 = np.float32(2**15 + 2**7 + 0.5)
_B1 = np.float32(2**7 + 0.5)
_INV_K2 = float(np.float32(1.0 / (K_I8 * K_I8)))
I8_MAX_N1 = 8  # slices of a row the int8 twins take: n = n1 x 128, n1 <= 8
_I8_TABLE_SHAPES = ((LANES, 3 * LANES), (LANES, 2 * LANES), (LANES, LANES))  # w0, w1, w2 a slice


def digits3(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The balanced base-256 digits (d0, d1, d2), int8, of float32 v in
    [-K_I8, K_I8]: v = d0 2^16 + d1 2^8 + d2 + eps, |eps| <= 1/2, by the
    float32 floor ladder of _int8_contract.digits3, operation for
    operation."""
    if v.dtype != torch.float32:
        raise TypeError(f"digits3: the ladder is float32's, got {v.dtype}")
    d0 = torch.floor((v + float(_B0)) * 2.0**-16)
    r0 = v - d0 * 65536.0
    d1 = torch.floor((r0 + float(_B1)) * 2.0**-8)
    r1 = r0 - d1 * 256.0
    d2 = torch.floor(r1 + 0.5)
    return d0.to(torch.int8), d1.to(torch.int8), d2.to(torch.int8)


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """2^k as float32 for integer k in [-126, 127], from its exponent bits."""
    return ((k + 127) << 23).to(torch.int32).view(torch.float32)


def row_quant_scales(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(ck, s_out) of _int8_contract.row_quant_scales for a positive float32
    row bound m: v = x ck is the digit split's input (ck = K / S, S =
    2^(e + 1) >= m) and s_out = S 2^32 / K^2 takes the recombined limbs
    back to x @ T units.  e = floor(log2 max(m, 1e-30)) is read exactly from
    the exponent bits; JAX's float32 log2 may round up to the next integer
    at an m just under a power of two, and then picks the next S."""
    m = m.clamp_min(1e-30)
    e = ((m.view(torch.int32) >> 23) & 0xFF) - 127
    return _pow2(-e - 1) * K_I8, _pow2(e + 33) * _INV_K2


def table_digits_np(t: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The digits (int8) of a table with |t| <= 1 by digits3's ladder in
    float64, exactly (K_I8 |t| < 2^24; every step integer or half)."""
    v = np.asarray(t, np.float64) * K_I8
    if np.any(np.abs(v) > K_I8):
        raise ValueError("table entries must satisfy |t| <= 1")
    d0 = np.floor((v + float(_B0)) * 2.0**-16)
    r0 = v - d0 * 65536.0
    d1 = np.floor((r0 + float(_B1)) * 2.0**-8)
    r1 = r0 - d1 * 256.0
    d2 = np.floor(r1 + 0.5)
    for d in (d0, d1, d2):
        assert d.min() >= -128 and d.max() <= 127
    return d0.astype(np.int8), d1.astype(np.int8), d2.astype(np.int8)


def stack_tables_np(t: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A table's digits stacked for the three-matmul form: w0 = [t0 | t1 |
    t2] (c, 384), w1 = [t0 | t1] (c, 256), w2 = t0 (c, 128); the six
    products d_i t_j of i + j <= 2."""
    t0, t1, t2 = table_digits_np(t)
    return (np.ascontiguousarray(np.concatenate([t0, t1, t2], axis=1)),
            np.ascontiguousarray(np.concatenate([t0, t1], axis=1)),
            np.ascontiguousarray(t0))


@lru_cache(maxsize=None)
def i8mm_tables(n1: int = 8) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """i8mm's and i8dec's random int8 tables w0 (n1, 128, 384), w1
    (n1, 128, 256), w2 (n1, 128, 128) in [-100, 100), drawn from
    default_rng(7) as tools/probe_int8.py's make_i8mm_tables (n1 = 8)."""
    rng = np.random.default_rng(7)
    return tuple(rng.integers(-100, 100, size=(n1, *shape)).astype(np.int8)
                 for shape in _I8_TABLE_SHAPES)


@lru_cache(maxsize=None)
def i8full_tables(n: int = 1024) -> tuple[np.ndarray, ...]:
    """i8full's nine int8 tables (wr0, wr1, wr2, wi0, wi1, wi2, ws0, ws1,
    ws2), each (n1, 128, 384 / 256 / 128): the stacked digits of every
    slice's Gr and Gi (ls_tables' float32 G, unscaled) and of (Gr + Gi) / 2
    formed in float64, as make_i8full_tables."""
    g = _g_host(n).astype(np.float64) * LANES
    parts = [[stack_tables_np(mat) for mat in (gk[0], gk[1], (gk[0] + gk[1]) / 2.0)] for gk in g]
    return tuple(np.stack([p[key][j] for p in parts]) for key in range(3) for j in range(3))


def _check_i8(xr: torch.Tensor, xi: torch.Tensor, name: str) -> tuple[int, int]:
    b, n = _check_planes(xr, xi, name)
    if n < LANES or n % LANES or n // LANES > I8_MAX_N1:
        raise ValueError(f"{name}: n must be n1 x {LANES} with 1 <= n1 <= {I8_MAX_N1}, got {n}")
    if xr.dtype != torch.float32 or xi.dtype != torch.float32:
        raise TypeError(f"{name}: float32 planes (the quantization is float32's), got "
                        f"{xr.dtype}, {xi.dtype}")
    if xi.device != xr.device:
        raise ValueError(f"{name}: both planes must be on one device")
    return b, n


def _i8_user_tables(tables, n1: int, device: torch.device, name: str) -> tuple:
    """(w0, w1, w2) as int8 tensors on `device`: numpy arrays or tensors there."""
    if len(tables) != 3:
        raise ValueError(f"{name}: tables are (w0, w1, w2)")
    out = []
    for w, shape in zip(tables, _I8_TABLE_SHAPES):
        w = torch.from_numpy(np.ascontiguousarray(w)) if isinstance(w, np.ndarray) else w
        if w.dtype != torch.int8:
            raise TypeError(f"{name}: int8 tables, got {w.dtype}")
        if tuple(w.shape) != (n1, *shape):
            raise ValueError(f"{name}: a table of shape {(n1, *shape)}, got {tuple(w.shape)}")
        if w.device.type != "cpu" and w.device != device:
            raise ValueError(f"{name}: tables on {w.device}, planes on {device}")
        out.append(w.to(device))
    return tuple(out)


@lru_cache(maxsize=None)
def _i8mm_default(n1: int, device: torch.device) -> tuple:
    return tuple(torch.from_numpy(w).to(device) for w in i8mm_tables(n1))


def _i8mm_host(tables, n1: int, device: torch.device, name: str) -> tuple:
    if tables is None:
        return _i8mm_default(n1, device)
    return _i8_user_tables(tables, n1, device, name)


@lru_cache(maxsize=None)
def _i8full_t64(n: int, device: torch.device) -> tuple:
    """i8full's tables as float64 on `device`: ((wr0, wr1, wr2), (wi..), (ws..))."""
    t = [torch.from_numpy(w).to(device, torch.float64) for w in i8full_tables(n)]
    return tuple(tuple(t[3 * p:3 * p + 3]) for p in range(3))


def _frag_planes(planes: torch.Tensor) -> torch.Tensor:
    """(..., 128 [i2], 128 [col]) int8 planes in the kernels' B-fragment
    order: for n-tile nt, k-step ks, lane 4 g + t, the 8 bytes
    T[32 ks + 16 h + 4 t + q][8 nt + g] over (h, q); (..., 16384) bytes."""
    lead = planes.shape[:-2]
    v = planes.reshape(*lead, 4, 2, 4, 4, 16, 8)  # ks, h, t, q, nt, g
    k = len(lead)
    v = v.permute(*range(k), k + 4, k + 0, k + 5, k + 2, k + 1, k + 3)
    return v.reshape(*lead, LANES * LANES).contiguous()


def _split_blocks(w: torch.Tensor) -> list[torch.Tensor]:
    """(n1, 128, 128 c) -> its c 128-column blocks."""
    return [w[..., LANES * j:LANES * (j + 1)] for j in range(w.shape[-1] // LANES)]


def _pack_i8(w0, w1, w2, dec: bool) -> torch.Tensor:
    """i8mm's (w0's three blocks, w1's two, w2) or i8dec's (w0's three)
    planes a slice, packed: (n1, planes, 16384) int8."""
    planes = _split_blocks(w0) + ([] if dec else _split_blocks(w1) + [w2])
    return _frag_planes(torch.stack(planes, dim=1))


@lru_cache(maxsize=None)
def _i8mm_packed(n1: int, dec: bool, device: torch.device) -> torch.Tensor:
    return _pack_i8(*_i8mm_default(n1, device), dec)


@lru_cache(maxsize=None)
def _i8full_packed(n: int, device: torch.device) -> torch.Tensor:
    """The digits t0, t1, t2 of Gr, Gi, (Gr + Gi) / 2 (each product's w0
    blocks: its w1 and w2 repeat them) a slice, packed: (n1, 9, 16384)."""
    t = i8full_tables(n)
    w0s = [torch.from_numpy(t[3 * p]).to(device) for p in range(3)]
    return _frag_planes(torch.stack([b for w in w0s for b in _split_blocks(w)], dim=1))


def _i8_slices(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], x.shape[1] // LANES, LANES).transpose(0, 1)


def _i8_unslice(y: torch.Tensor, b: int, n: int) -> torch.Tensor:
    return y.transpose(0, 1).reshape(b, n)


def _mm64(d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """d (n1, b, 128) @ w (n1, 128, c) of integers, exactly, in float64
    (every sum stays far below 2^53)."""
    return torch.matmul(d.to(torch.float64), w.to(torch.float64))


def _mm_stacked(d, w) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """_int8_contract.mm_i8_stacked: (q0, q1, q2) of digits d and stacked
    tables w, exact float64."""
    p0, p1, p2 = (_mm64(di, wi) for di, wi in zip(d, w))
    L = LANES
    return p0[..., :L], p0[..., L:2 * L] + p1[..., :L], p0[..., 2 * L:] + p1[..., L:] + p2


def _recombine(q, s_out: torch.Tensor) -> torch.Tensor:
    """(q0 + 2^-8 q1 + 2^-16 q2) s_out in float32, _int8_contract's order."""
    f = [v.to(torch.float32) for v in q]
    return (f[0] + f[1] * 2.0**-8 + f[2] * 2.0**-16) * s_out


def _sat_trunc(x: torch.Tensor) -> torch.Tensor:
    return torch.trunc(x).clamp(-128.0, 127.0)


def i8_dot_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (m, k) int8 @ b (k, n) int8 into int32, exactly (through float64)."""
    _check_i8_dot(a, b)
    return _mm64(a, b).to(torch.int32)


def i8mm_plain(xr: torch.Tensor, xi: torch.Tensor,
               tables=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of i8mm: per slice a = trunc(xr 100), b =
    trunc(xi 100), s = trunc((xr + xi) 50) (float32, saturated to int8's
    range) through mm_i8_stacked against (w0, w1, w2) (default i8mm_tables);
    yr = f32(sum of q0 + q1) 1e-5, yi = f32(sum of q2) 1e-5."""
    b, n = _check_i8(xr, xi, "i8mm")
    w = _i8mm_host(tables, n // LANES, xr.device, "i8mm")
    ar, ai = _i8_slices(xr), _i8_slices(xi)
    acc_r = acc_i = 0.0
    for x in (ar * 100.0, ai * 100.0, (ar + ai) * 50.0):
        d = _sat_trunc(x)
        q0, q1, q2 = _mm_stacked((d, d, d), w)
        acc_r = acc_r + q0 + q1
        acc_i = acc_i + q2
    return (_i8_unslice(acc_r.to(torch.float32) * 1e-5, b, n),
            _i8_unslice(acc_i.to(torch.float32) * 1e-5, b, n))


def i8dec_plain(xr: torch.Tensor, xi: torch.Tensor,
                tables=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of i8dec: per slice the row scales of max |xr| +
    |xi|, the first digit d0 of xr ck, xi ck and (xr + xi) ck against w0
    (default i8mm_tables); yr = f32(sum of d0 w0[:, :256]'s two blocks)
    s_out / 128, yi = f32(sum of d0 w0[:, 256:]) s_out / 128."""
    b, n = _check_i8(xr, xi, "i8dec")
    w0 = _i8mm_host(tables, n // LANES, xr.device, "i8dec")[0]
    ar, ai = _i8_slices(xr), _i8_slices(xi)
    ck, s_out = row_quant_scales((ar.abs() + ai.abs()).amax(dim=-1, keepdim=True))
    s_out = s_out * (1.0 / LANES)
    L = LANES
    acc_r = acc_i = 0.0
    for x in (ar, ai, ar + ai):
        q = _mm64(digits3(x * ck)[0], w0)
        acc_r = acc_r + (q[..., :L] + q[..., L:2 * L])
        acc_i = acc_i + q[..., 2 * L:]
    return (_i8_unslice(acc_r.to(torch.float32) * s_out, b, n),
            _i8_unslice(acc_i.to(torch.float32) * s_out, b, n))


def i8full_plain(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of i8full and i8_concat: karatsuba_g_i8 of every
    slice with i8full_tables (extra_scale 1/128): K13's function (the
    twiddled 128-point DFT of each slice, over 128) in int8 limbs, the
    Karatsuba +- on the exact partials, one float32 recombination each."""
    b, n = _check_i8(xr, xi, "i8full")
    wr, wi, ws = _i8full_t64(n, xr.device)
    ar, ai = _i8_slices(xr), _i8_slices(xi)
    ck, s_out = row_quant_scales((ar.abs() + ai.abs()).amax(dim=-1, keepdim=True))
    s_out = s_out * (1.0 / LANES)
    q_r = _mm_stacked(digits3(ar * ck), wr)
    q_i = _mm_stacked(digits3(ai * ck), wi)
    q_s = _mm_stacked(digits3((ar + ai) * ck), ws)
    re = _recombine([a - c for a, c in zip(q_r, q_i)], s_out)
    im = _recombine([2 * s - a - c for s, a, c in zip(q_s, q_r, q_i)], s_out)
    return _i8_unslice(re, b, n), _i8_unslice(im, b, n)


def _check_i8_dot(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int, int]:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"i8_dot: a (m, k) and b (k, n), got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"i8_dot: int8 operands, got {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"i8_dot: operands on {a.device} and {b.device}")
    return a.shape[0], a.shape[1], b.shape[1]


def i8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K14g's dot: a (m, k) int8 @ b (k, n) int8 into int32, exactly, on the
    int8 tensor cores."""
    m, k, n = _check_i8_dot(a, b)
    if not a.is_cuda:
        return i8_dot_plain(a, b)
    a, b = a.contiguous(), b.contiguous()
    c = torch.empty(m, n, dtype=torch.int32, device=a.device)
    return _launch("i8_dot", _build.library().gdsp_i8_dot, c, a.data_ptr(), b.data_ptr(),
                   c.data_ptr(), m, k, n)


def _i8_launch(name: str, fn, xr: torch.Tensor, xi: torch.Tensor, packed: torch.Tensor,
               *extra) -> tuple[torch.Tensor, torch.Tensor]:
    xr, xi = _cuda_planes(xr, xi, name)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    _launch(name, fn, yr, xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            packed.data_ptr(), xr.shape[0], xr.shape[1], *extra)
    return yr, yi


def _i8mm_packed_for(tables, n: int, dec: bool, device: torch.device, name: str) -> torch.Tensor:
    if tables is None:
        return _i8mm_packed(n // LANES, dec, device)
    return _pack_i8(*_i8_user_tables(tables, n // LANES, device, name), dec)


def i8mm(xr: torch.Tensor, xi: torch.Tensor, tables=None) -> tuple[torch.Tensor, torch.Tensor]:
    """K14g i8mm: the raw int8 MAC stream at the full contraction's count
    (2304 MACs a point): the quantized a, b, a + b of each slice of two
    float32 planes (b, n), n = n1 x 128, n1 <= 8, against (w0, w1, w2)
    (default i8mm_tables: (n1, 128, 384 / 256 / 128) int8)."""
    _check_i8(xr, xi, "i8mm")
    if not xr.is_cuda:
        return i8mm_plain(xr, xi, tables)
    return _i8_launch("i8mm", _build.library().gdsp_i8mm, xr, xi,
                      _i8mm_packed_for(tables, xr.shape[1], False, xr.device, "i8mm"))


def i8dec(xr: torch.Tensor, xi: torch.Tensor, tables=None) -> tuple[torch.Tensor, torch.Tensor]:
    """K14g i8dec: the row scales and digit ladder of the contraction with
    only d0's stacked product against w0 (1152 MACs a point)."""
    _check_i8(xr, xi, "i8dec")
    if not xr.is_cuda:
        return i8dec_plain(xr, xi, tables)
    return _i8_launch("i8dec", _build.library().gdsp_i8dec, xr, xi,
                      _i8mm_packed_for(tables, xr.shape[1], True, xr.device, "i8dec"))


def _i8_contract(name: str, xr: torch.Tensor, xi: torch.Tensor,
                 store_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    _check_i8(xr, xi, name)
    if not xr.is_cuda:
        return i8full_plain(xr, xi)
    return _i8_launch(name, _build.library().gdsp_i8full, xr, xi,
                      _i8full_packed(xr.shape[1], xr.device), store_rows)


def i8full(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K14g i8full: K13's function (gmm_floor: the twiddled 128-point DFT of
    every slice, over 128) by the exact int8-limb Karatsuba contraction,
    each slice's outputs stored as they come; equal to i8full_plain."""
    return _i8_contract("i8full", xr, xi, 0)


def i8_concat(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K14c i8_concat: i8full's kernel with a 16-row tile's outputs of every
    slice gathered in shared memory and stored as whole rows; equal to
    i8full."""
    return _i8_contract("i8_concat", xr, xi, 1)
