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
      no FFT: (..., n_tiles, pad) in time order, on K4's own CTA, tiles and
      frame order with the sums in registers and the CTA's warps added in
      a fixed order (frameonly_regs_model), so K4 less it prices K4's
      transform; its first design, a segment at a time through a
      bit-reversed round trip in shared memory, stays as the yardstick
      pwfloor_frameonly_shared;
  pwfloor_noframe(frames, mask, w)                    replaces :264 noframe
      frames given as (..., S, pad) rows (K3's layout): window, FFT, |X|^2,
      masked sum: (..., n_tiles, pad//2 + 1), on K4's own CTA, transform
      and sums with each frame read from its row 16 bytes a lane
      (noframe_load_map), equal to K4 on the frames flattened to (..., S
      pad) at nfft = stride = pad bit for bit; its first design, a segment
      at a time through K4's first design's radix-2 stages, stays as the
      yardstick pwfloor_noframe_radix2;
  pwfloor_staged(ext, mask, w, nfft, stride, pad)     replaces :229 full2d
      K4's function with each tile's span staged once in shared memory by
      the TMA and every frame cut from there, on K4's own CTA, transform
      and sums: (..., n_tiles, pad//2 + 1), equal to K4
      (cuda_pwelch.pwelch_power_partials) at the same tiles bit for bit;
      its first design, a segment at a time through K4's first design's
      radix-2 stages, stays as the yardstick pwfloor_staged_radix2, equal
      to pwelch_radix2's partials.

The tiles are K4's (cuda_pwelch.segs_per_tile) unless `bt` says otherwise;
staged caps bt so that a block's slots and span fit in 227 KB of shared
memory (staged_segs_per_tile, staged_cta; the first design's own cap,
_staged_max_bt, is smaller at pad <= 2048 and larger at pad 16384).
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
      copies: one slice of each row a pass (every slice's loads of a row's
      chunk issued first: csrc/slice_walk.cuh, as slice8_add), or the tile
      staged in shared memory and stored as whole rows; plain version
      cuda_metrics.copy_split_plain;
  gmm_concat(xr, xi)   replaces _call (_gmm_concat_kernel)
      K13's contraction with the outputs of every slice of a row tile
      stored as whole rows, on a thread-block cluster a 1024-column chunk
      (a CTA a slice, its G[k1] resident, the tile's slices gathered over
      distributed shared memory: csrc/lane_contract.cuh); plain version
      cuda_metrics.gmm_floor_plain.

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
      `table`, any (128, 128) float32 table), by wgmma m64n128k8 with A
      from registers on a persistent grid of one CTA an SM that keeps the
      rounded table resident and walks the (plane, 64-row tile, slice)
      items through a ring of TMA stages, storing each tile back by TMA
      (bd_tf32_plan); plain version bd_tf32_plain, which with tf32=True
      rounds both operands as cvt.rna.tf32.f32 does (round_tf32) and sums
      in the input's dtype;
  bd_hi(xr, xi)        replaces v5bd_hi (:190): the 128-point DFT of every
      slice, unscaled, by Karatsuba in 3xTF32 (float32 accuracy), on
      wgmma with A from registers, fed by TMA, on pairs of CTAs that keep
      half a slice's bins of the six TF32 planes resident (bd_hi_plan);
      plain version bd_hi_plain, the same Karatsuba in the input's dtype;
  anat_full(xr, xi, tw) replaces v6full (:203): half3, the row tw
      (ar = a tw - b tw, ai = a tw + b tw), then bd_hi, in one kernel on
      bd_hi's walk: each stage brings a 32-column k-box of both planes and
      its partner n / 2 columns away (half3 pairs columns c and c + n / 2
      in every round), the CTA makes the rounds and the row once a stage
      in shared memory and each warp the split in registers
      (anat_full_plan); plain version anat_full_plain.

bd_tf32 is the port's only TF32 path, on purpose: it measures one
reduced-precision pass (the TPU's DEFAULT matmul) and changes no TF32
flag; nothing held to the 120 dB bar goes through it.  bd_hi's tables
are the big and small TF32 halves of Re F, Im F and Re F + Im F as
128-entry vectors over j k mod 128, split from float64 on the host
(hi_tables); bd_hi expands them once a CTA into its resident planes.

The first designs of slicestore, bd_hi, bd_tf32 and anat_full stay as the
yardsticks of their redesigns: slicestore_sync (one slice's load and store
in turn), bd_hi_sync (mma.sync m16n8k8, A read from device memory, the
tables gathered over j k mod 128 from 3 KB of shared memory), bd_tf32_sync
(mma.sync m16n8k8, a warp a 16-row tile of one slice, A read from device
memory in fragment order, 8-byte stores) and anat_full_sync (whole rows
staged a block, the rounds and the row there behind barriers, then
bd_hi_sync's contraction from shared memory).

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
      digit order, vdif_digit_order); a warp a row, the row brought by
      16-byte cp.async into the warp's shared buffer while the block reads
      T into shared memory (vdif_plan); its first design, eight rows a
      block loaded 4 bytes a lane with T and the stage twiddles read from
      device memory, stays as the yardstick vdif_sync; plain version
      vdif_plain;
  sdif_peel(xr, xi)    replaces tools/probe_sdif.py:116 (sdif_peel over
      _sdif_kernel): (..., 128, m) float32 planes; seven radix-2 DIF
      stages across the 128 rows, then the post twiddle
      Tb[r, t] = W_N^{brev7(r) t}, N = 128 m; row r holds the dense peel's
      row brev7(r), i.e. cuda_outer.outer_dft_split(x, 128, 1)'s; on K8's
      column tile (sdif_plan: 32 columns a CTA, 16 rows a thread), the
      stages in registers with one exchange (sdif_regs_model), Tb as W_N^{k
      c0} of the row times K8's tile table (sdif_tb_model); its first
      design, the tile staged in shared memory with a barrier a stage and
      Tb gathered a point, stays as the yardstick sdif_peel_sync; plain
      version sdif_peel_plain (its stages alone sdif_stages_plain).

Their tables are built in float64 and rounded once: the port carries the
lane DIF's arithmetic (brev7_perm, the stage twiddles W_{2w}^j) rather
than godsp_tpu's _lane_dft module, and Tb is K8's exact-exponent factored
table (cuda_outer._factor_tables) and, in sdif_peel, its tile table
(cuda_outer._tile_table).  The TPU's roll-and-select lane
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
      (n1, 3, 128, 128) tables g), by wgmma on a pair of CTAs a slice
      (each half the slice's bins of G resident), the 64-row tiles of
      a and b brought by TMA tensor copies, both operands read from shared
      memory, the outputs stored by TMA (gmm_tf32_plan); plain version
      gmm_tf32_plain, which with tf32=True
      rounds a, b, a + b and the tables as cvt.rna.tf32.f32 does;
  ls_full(xr, xi, store, chunks, rows_per_block)  replaces k_full,
      k_full_concat, make_subtiled(2/4/8) and k_full at bt 512 / 1024: the
      n-point DFT of every row, the network then K13's contraction with
      unscaled G (ls_tables) in one kernel on a cluster of n1 CTAs (the
      network an all-to-all over distributed shared memory, then each
      CTA's slice against its resident G[k1]), position 128 k1 + k2
      holding bin k1 + n1 k2 (ls_digit_order); every setting gives the same
      result; plain version ls_full_plain;
  fft_pow2_rows(xr, xi, rows_per_block)  K1 (csrc/fft_kernels.cu) at a
      given rows a CTA, the TPU probes' batch-tile sweep; equal to
      cuda_fft.fft_pow2; raises where the CTA passes the kernel's launch
      bound (512 threads a CTA for n <= 1024, 1024 above) or one block's
      227 KB of shared memory (cuda_fft.cta_fits).

The first designs of K1, K4, K5, K6, K7, K8 and K9, kept off the main
path as the yardsticks of their redesigns (csrc/radix2_probe_kernels.cu;
they replace no TPU kernel of their own):

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
  istft_radix2(spec, w, nfft, hop, onesided)  the istft_kernel K6 first
      ran (a block a tile, one frame at a time: a bit-reversed load
      completing the pad-point spectrum, block_fft_rows, the windowed real
      part added into the tile's span; its tiles istft_radix2_tiles, their
      tails stitched by the wrapper); plain version
      cuda_istft.istft_overlap_add_plain;
  peel_rows_radix2(xr, xi, inverse, scale)  the peel_rows_kernel K9 first
      ran (R rows a block re-reading every input row, a radix-(128/R) step
      and an R-point DFT, bit-reversed stores, block_fft_rows); plain
      version cuda_outer.peel_rows_fused_split_plain.
      Nothing under fft/, models/, spectral/ or parallel/ calls them.

The first designs of K14c gmm_concat and K14f ls_full stay beside their
cluster redesigns (csrc/lane_probe_kernels.cu, lane_slice_probe_kernels.cu)
as their yardsticks: a CTA covers every slice of a 16-row tile and G[k1]
streams through shared memory 32 rows of i2 at a time, again for every
tile:

  gmm_concat_stream(xr, xi)  equal to gmm_concat and K13;
  ls_full_stream(xr, xi, store, chunks, rows_per_block)  equal to ls_full
      at every setting.

So do the first designs of K14c i8_concat and K14f gmm_tf32:

  i8_concat_stream(xr, xi)  a block a 16-row tile walking its slices, each
      product's three int8 table planes staged in turn; equal to i8_concat;
  gmm_tf32_sync(xr, xi, g)  a block a slice and a row group, mma.sync
      m16n8k8 with A read from device memory; >= 120 dB against gmm_tf32.

lane_cluster_plan is the cluster redesigns' launch plan (gmm_concat,
ls_full and i8_concat; the kernels' gdsp_lane_cluster_geometry holds the
same), lane_cluster_walk the tiles each cluster takes, lane_gather_map the
whole-row stores over distributed shared memory, i8_push_map i8_concat's
pushes of its rows to their owners and lane_network_scatter ls_full's
network all-to-all.  gmm_tf32_plan is gmm_tf32's
(gdsp_gmm_tf32_geometry), gmm_tf32_walk its pairs' slices and tiles,
gmm_tf32_bins its CTAs' bins and gmm_tf32_offset its operands' swizzled
layout.

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
      into int32, exactly, on 32 x 32 tiles of c whose whole depth (k <=
      512; deeper k through a ring of 128-deep chunks) arrives in one round
      of 16-byte copies, or of predicated byte loads where k or n is not a
      multiple of 16 or an operand is not 16-byte aligned (i8_dot_plan,
      i8_dot_tiles); plain version i8_dot_plain;
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
      dB against float64, on one CTA an SM whose digit warps make each
      16-row step's digits (by round-down adds, no conversion) while its
      product warps run the last step's mma, handing two digit buffers
      over on named barriers (i8full_plan, i8full_walk, i8full_digit_map,
      i8full_store_map; i8full_steps_model runs the same steps on the
      host); its first design, a block a slice and a row group with the
      digits and products of a step in turn, stays as the yardstick
      i8full_sync; plain version i8full_plain;
  i8_concat(xr, xi)     replaces _i8_concat_kernel (probe_store.py:101):
      i8full's arithmetic storing whole rows of a 16-row tile, on a
      thread-block cluster of n1 CTAs, each a slice with its 144 KB of int8
      tables resident, each row's slices pushed to the CTA that stores it
      over distributed shared memory (lane_cluster_plan "i8_concat",
      i8_push_map); equal to i8full.

The first designs of i8_dot and of K13 (cuda_metrics.gmm_floor) stay as
the yardsticks of their redesigns:

  i8_dot_bytes(a, b)     64 x 64 tiles of c, each 32-deep k-step staged a
      byte a load; equal to i8_dot;
  gmm_floor_sync(xr, xi) a block a slice and a row group (gmm_groups) with
      all of G[k1] resident, 4 x 4 register tiles over 32-row tiles loaded
      synchronously; equal to gmm_floor.

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
from typing import NamedTuple

import numpy as np
import torch

from godsp_tpu_torch.fft.four_step import _tf32_off, dft_matrix, twiddle_2d
from godsp_tpu_torch.ops import _build, cuda_csd, cuda_istft, cuda_outer, cuda_pwelch, cuda_stft
from godsp_tpu_torch.ops.cuda_fft import (
    MAX_N,
    MAX_SMEM,
    cta_fits,
    fft_pow2_plain,
    geometry,
    rfft_pow2_plain,
    rfft_table,
    stockham_table,
    supported_size,
    twiddle_table,
)
from godsp_tpu_torch.ops.cuda_metrics import (
    LANES,
    _check_gmm,
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
    partials_cta,
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
    "ANAT_BOXES",
    "ANAT_K_STAGE",
    "ANAT_SMEM",
    "ANAT_STAGES",
    "AnatPlan",
    "anat_a_model",
    "anat_box_offset",
    "anat_fragment_offsets",
    "anat_full",
    "anat_prepass_offsets",
    "anat_full_plain",
    "anat_full_plan",
    "anat_full_stages",
    "anat_full_sync",
    "BD_HI_CHAIN",
    "HiPlan",
    "bd_hi",
    "bd_hi_fragment_offsets",
    "bd_hi_plain",
    "bd_hi_plan",
    "bd_hi_sync",
    "bd_hi_walk",
    "bd_tf32",
    "bd_tf32_plan",
    "bd_tf32_store_offsets",
    "bd_tf32_sync",
    "bd_tf32_walk",
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
    "frameonly_regs_model",
    "gmm_concat",
    "gmm_concat_stream",
    "gmm_floor_sync",
    "I8DotPlan",
    "LanePlan",
    "i8_push_map",
    "lane_cluster_plan",
    "lane_cluster_walk",
    "lane_gather_map",
    "lane_i8_smem",
    "lane_network_scatter",
    "Tf32Plan",
    "gmm_tf32",
    "gmm_tf32_bins",
    "gmm_tf32_offset",
    "gmm_tf32_plain",
    "gmm_tf32_plan",
    "gmm_tf32_sync",
    "gmm_tf32_walk",
    "half3",
    "half3_plain",
    "hi_tables",
    "i8_concat",
    "i8_concat_stream",
    "i8_dot",
    "i8_dot_bytes",
    "i8_dot_plain",
    "i8_dot_plan",
    "i8_dot_tiles",
    "i8dec",
    "i8dec_plain",
    "i8full",
    "i8full_plain",
    "i8full_sync",
    "i8full_steps_model",
    "i8full_store_map",
    "smem_wavefronts",
    "i8full_wavefronts",
    "i8full_digit_map",
    "i8full_walk",
    "i8full_plan",
    "I8FullPlan",
    "I8FULL_SMEM",
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
    "ls_full_stream",
    "ls_network",
    "ls_network_plain",
    "ls_tables",
    "istft_radix2",
    "istft_radix2_tiles",
    "outer_dft_radix2",
    "peel_rows_radix2",
    "pwelch_radix2",
    "pwfloor_frameonly",
    "pwfloor_frameonly_plain",
    "pwfloor_frameonly_shared",
    "pwfloor_loadonly",
    "pwfloor_loadonly_plain",
    "pwfloor_noframe",
    "pwfloor_noframe_plain",
    "pwfloor_noframe_radix2",
    "NOFRAME_VEC",
    "noframe_load_map",
    "pwfloor_staged",
    "pwfloor_staged_plain",
    "pwfloor_staged_radix2",
    "re_f128",
    "reshape_add",
    "round_tf32",
    "row_quant_scales",
    "sdif_peel",
    "sdif_peel_plain",
    "sdif_peel_sync",
    "sdif_regs_model",
    "sdif_stages_plain",
    "sdif_tb_model",
    "sdif_plan",
    "sdif_walk",
    "SdifPlan",
    "SDIF_COLS",
    "SDIF_ROWS",
    "sdif_tables",
    "slice8_add",
    "slice8_add_sync",
    "slicestore",
    "slicestore_sync",
    "stack_tables_np",
    "staged_cta",
    "staged_max_bt",
    "staged_span",
    "staged_segs_per_tile",
    "stft_radix2",
    "table_digits_np",
    "vdif",
    "vdif_digit_order",
    "vdif_plain",
    "vdif_plan",
    "vdif_sync",
    "vdif_tables",
    "vdif_walk",
]

# Kernel launches by wrapper, counted where each launches its kernel.
launches = {"pwfloor_loadonly": 0, "pwfloor_frameonly": 0, "pwfloor_noframe": 0,
            "pwfloor_staged": 0, "fac_dft": 0, "slicestore": 0, "concatstore": 0,
            "gmm_concat": 0, "half3": 0, "slice8_add": 0, "reshape_add": 0, "bd_tf32": 0,
            "bd_hi": 0, "anat_full": 0, "vdif": 0, "sdif_peel": 0, "ls_network": 0,
            "gmm_tf32": 0, "ls_full": 0, "lane_flip": 0, "fft_pow2_rows": 0, "i8_dot": 0,
            "i8mm": 0, "i8dec": 0, "i8full": 0, "i8_concat": 0, "fft_pow2_radix2": 0,
            "stft_radix2": 0, "outer_dft_radix2": 0, "pwelch_radix2": 0, "csd_radix2": 0,
            "istft_radix2": 0, "peel_rows_radix2": 0, "gmm_concat_stream": 0,
            "ls_full_stream": 0, "i8_concat_stream": 0, "gmm_tf32_sync": 0, "i8_dot_bytes": 0,
            "gmm_floor_sync": 0, "slice8_add_sync": 0, "slicestore_sync": 0,
            "bd_hi_sync": 0, "bd_tf32_sync": 0, "vdif_sync": 0, "anat_full_sync": 0,
            "pwfloor_staged_radix2": 0, "pwfloor_noframe_radix2": 0, "sdif_peel_sync": 0,
            "i8full_sync": 0, "pwfloor_frameonly_shared": 0}

def _staged_max_bt(nfft: int, stride: int, pad: int) -> int:
    """The most segments a tile of the first design (pwfloor_staged_radix2)
    whose staged span, FFT buffer and accumulator fit in one block's shared
    memory."""
    room = (MAX_SMEM - 8 * pad - 4 * (pad // 2 + 1)) // 4 - nfft
    if room < 0:
        raise ValueError(f"staged twin: nfft {nfft} and pad {pad} leave no room for a span")
    return room // stride + 1


def staged_cta(pad: int, tile: int, nfft: int, stride: int) -> tuple[int, int, int, int]:
    """(segments it holds at once, threads, slots, bytes of shared memory)
    of the staged redesign's CTA at pad over tiles of `tile` segments
    (csrc/pwelch_probe_kernels.cu: staged_smem): K4's CTA (partials_cta),
    its slots in whole 16-byte units, then the span, (tile - 1) stride +
    nfft samples and up to 3 floats before them so that the span and the
    row agree mod 16 bytes, in whole units, then 16 bytes for the span's
    mbarrier.  gdsp_pwfloor_staged_geometry returns the same on the card."""
    fpc, threads, slots = partials_cta(pad, tile, tile)
    slot_words = -(-2 * slots * (pad // 2) // 4) * 4
    span_words = -(-((tile - 1) * stride + nfft + 3) // 4) * 4
    return fpc, threads, slots, 4 * (slot_words + span_words) + 16


def staged_max_bt(nfft: int, stride: int, pad: int) -> int:
    """The most segments a tile of the staged redesign whose slots, span and
    mbarrier (staged_cta) fit in one block's shared memory: its slots are
    K4's default CTA's, the most a tile holds."""
    slots = partials_cta(pad, 1 << 30, 1 << 30)[2]
    room = (MAX_SMEM - 16) // 4 - -(-2 * slots * (pad // 2) // 4) * 4
    span = room // 4 * 4 - nfft - 3
    if span < 0:
        raise ValueError(f"staged twin: nfft {nfft} and pad {pad} leave no room for a span")
    return span // stride + 1


def staged_segs_per_tile(n_segs: int, rows: int, nfft: int, stride: int, pad: int) -> int:
    """K4's tile (segs_per_tile), cut to what the redesign's shared memory
    holds (staged_max_bt): equal to K4's wherever the span fits."""
    return min(segs_per_tile(n_segs, rows), staged_max_bt(nfft, stride, pad))


def staged_span(S: int, bt: int, nfft: int, stride: int, L: int,
                offset: int) -> list[tuple[int, int, int, int, int]]:
    """What each tile of a row stages, as the redesign's CTA does (for a row
    whose sample 0 lies offset floats past a 16-byte boundary): (a0, a1,
    o, u0, u1) with the span the samples a0 .. a1 - 1 of the row (a1 =
    min(L, the end of the tile's last frame)), sample a0 at span word o
    (its float in its 16-byte unit), words u0 .. u1 - 1 from the row's
    16-byte units by the TMA, the up to 3 words before u0 and after u1 by
    thread loads (all of them where no whole unit lies in the span)."""
    out = []
    for s0 in range(0, S, bt):
        n = min(S - s0, bt)
        a0 = s0 * stride
        a1 = min((s0 + n - 1) * stride + nfft, L)
        o = (offset + a0) % 4
        u0 = (4 - o) % 4 if a0 < a1 else 0
        u1 = u0 + (a1 - a0 - u0) // 4 * 4 if a0 < a1 else 0
        out.append((a0, a1, o, u0, max(u0, u1)))
    return out


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


def frameonly_regs_model(ext, mask, w, nfft: int, stride: int, pad: int,
                         bt: int) -> torch.Tensor:
    """pwfloor_frameonly's kernel order in the inputs' dtype (csrc/
    pwelch_probe_kernels.cu: frameonly_partials_kernel): K4's CTA
    (partials_cta) on each tile, slot s taking the tile's frames it fpc + s
    in order, each the windowed frame (x w, zero past nfft and the signal)
    times its mask added into the slot's sums; the Q slots of a warp summed
    by the xor butterfly over their index bits; then the warps in order.
    (..., n_tiles, pad)."""
    S = mask.shape[-1]
    frames = _windowed_frames(ext, S, nfft, stride, pad, w) * mask[..., None]
    fpc, _, slots = partials_cta(pad, S, bt)
    g = geometry(pad // 2)
    q = 32 // g.threads if g.warp else 1  # slots a warp
    tiles = []
    for s0 in range(0, S, bt):
        n = min(S - s0, bt)
        sums = [torch.zeros_like(frames[..., 0, :]) for _ in range(slots)]
        for it in range(-(-n // fpc)):
            for slot in range(min(fpc, n - it * fpc)):
                sums[slot] = sums[slot] + frames[..., s0 + it * fpc + slot, :]
        groups = []
        for w0 in range(0, slots, q):
            v = sums[w0:w0 + q]
            d = 1
            while d < q:
                v = [v[i] + v[i ^ d] for i in range(q)]
                d <<= 1
            groups.append(v[0])
        total = groups[0]
        for grp in groups[1:]:
            total = total + grp
        tiles.append(total)
    return torch.stack(tiles, dim=-2)


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


def _frameonly_launch(name: str, ext: torch.Tensor, mask: torch.Tensor, w: torch.Tensor,
                      nfft: int, stride: int, pad: int | None, bt: int | None) -> torch.Tensor:
    pad = pad or nfft
    _check(ext, mask, w, nfft, stride, pad)
    S, lead = mask.shape[-1], tuple(ext.shape[:-1])
    rows = math.prod(lead)
    bt = bt or segs_per_tile(S, rows)
    if not ext.is_cuda:
        return pwfloor_frameonly_plain(ext, mask, w, nfft, stride, pad, bt)
    ext, mask, w = _cuda_args(name, ext, mask, w)
    if name == "pwfloor_frameonly" and w.data_ptr() % 8:  # read as float2 pairs, as K4
        w = w.clone()
    n_tiles = -(-S // bt)
    out = torch.empty(*lead, n_tiles, pad, dtype=torch.float32, device=ext.device)
    return _launch(name, getattr(_build.library(), f"gdsp_{name}"), out,
                   ext.data_ptr(), mask.data_ptr(), w.data_ptr(), out.data_ptr(),
                   rows, ext.shape[-1], S, nfft, stride, pad.bit_length() - 1, bt, n_tiles)


def pwfloor_frameonly(ext: torch.Tensor, mask: torch.Tensor, w: torch.Tensor, nfft: int,
                      stride: int, pad: int | None = None, bt: int | None = None) -> torch.Tensor:
    """The frameonly twin: (..., n_tiles, pad) masked sums of windowed frames."""
    return _frameonly_launch("pwfloor_frameonly", ext, mask, w, nfft, stride, pad, bt)


def pwfloor_frameonly_shared(ext: torch.Tensor, mask: torch.Tensor, w: torch.Tensor, nfft: int,
                             stride: int, pad: int | None = None,
                             bt: int | None = None) -> torch.Tensor:
    """pwfloor_frameonly's first design, its yardstick: a segment at a time
    through a bit-reversed round trip in shared memory behind two block
    barriers (K4's first design's framing), (..., n_tiles, pad)."""
    return _frameonly_launch("pwfloor_frameonly_shared", ext, mask, w, nfft, stride, pad, bt)


def _noframe_launch(name: str, entry: str, frames: torch.Tensor, mask: torch.Tensor,
                    w: torch.Tensor, bt: int | None) -> torch.Tensor:
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
    frames, mask, w = _cuda_args(name, frames, mask, w)
    redesign = name == "pwfloor_noframe"
    if redesign and frames.data_ptr() % NOFRAME_VEC:  # the redesign's loads are that wide
        frames = frames.clone()
    if redesign and w.data_ptr() % 8:  # and the window as float2 pairs, as K4
        w = w.clone()
    table = rfft_table(pad, frames.device) if redesign else twiddle_table(pad, False, frames.device)
    n_tiles = -(-S // bt)
    out = torch.empty(*lead, n_tiles, pad // 2 + 1, dtype=torch.float32, device=frames.device)
    return _launch(name, getattr(_build.library(), entry), out,
                   frames.data_ptr(), mask.data_ptr(), w.data_ptr(), out.data_ptr(),
                   table.data_ptr(), rows, S, pad.bit_length() - 1, bt, n_tiles)


NOFRAME_VEC = 16  # bytes a lane of pwfloor_noframe's kernel reads from a frame row at once


def noframe_load_map(pad: int) -> tuple[np.ndarray, np.ndarray]:
    """pwfloor_noframe's 16-byte frame load (csrc/pwelch_probe_kernels.cu:
    load_row at kNoframeVec 16; at 8, the copy probes/noframe_sdif.py
    prices, each lane reads its pairs t + r T itself) at pad, lane by lane:
    (units, pairs).  units[t, u] is the 16-byte unit of the frame lane t
    reads at its load u (at pad 2, whose one pair is read 8 bytes wide,
    the pair); pairs[t, r] the pair (floats 2 p, 2 p + 1) in lane t's
    register r after the loads and their even/odd exchange, which the
    transform needs to be t + r T (P registers, T lanes:
    cuda_fft.geometry(pad // 2))."""
    g = geometry(pad // 2)
    T, P = g.threads, g.points
    if P == 1:
        pairs = np.arange(T)[:, None] + T * np.arange(P)[None, :]
        return pairs.copy(), pairs
    units = np.zeros((T, P // 2), dtype=np.int64)
    pairs = np.zeros((T, P), dtype=np.int64)
    for u in range(P // 2):
        held = {}
        for t in range(T):  # the loads: pairs 2 unit, 2 unit + 1 of the frame
            unit = u if T == 1 else u * T + (t >> 1) + (T // 2 if t & 1 else 0)
            units[t, u] = unit
            held[t] = (2 * unit, 2 * unit + 1)
        for t in range(T):
            if T == 1:
                pairs[t, 2 * u], pairs[t, 2 * u + 1] = held[t]
                continue
            a, b = held[t]
            got = held[t ^ 1][0] if (t ^ 1) & 1 else held[t ^ 1][1]  # the partner's send
            pairs[t, 2 * u], pairs[t, 2 * u + 1] = (got, b) if t & 1 else (a, got)
    return units, pairs


def pwfloor_noframe(frames: torch.Tensor, mask: torch.Tensor, w: torch.Tensor,
                    bt: int | None = None) -> torch.Tensor:
    """The noframe twin: frames (..., S, pad) -> (..., n_tiles, pad//2 + 1),
    on K4's body (its tiles, CTA, transform and sums) with each frame read
    from its row NOFRAME_VEC bytes a lane; equal to K4 on the frames
    flattened to (..., S pad) at nfft = stride = pad, bit for bit.  A
    frames tensor off a NOFRAME_VEC-byte boundary is cloned first."""
    return _noframe_launch("pwfloor_noframe", "gdsp_pwfloor_noframe", frames, mask, w, bt)


def pwfloor_noframe_radix2(frames: torch.Tensor, mask: torch.Tensor, w: torch.Tensor,
                           bt: int | None = None) -> torch.Tensor:
    """pwfloor_noframe's first design, its yardstick: a segment at a time a
    bit-reversed load and log2 pad radix-2 stages behind block barriers."""
    return _noframe_launch("pwfloor_noframe_radix2", "gdsp_pwfloor_noframe_radix2", frames,
                           mask, w, bt)


def pwfloor_staged(ext: torch.Tensor, mask: torch.Tensor, w: torch.Tensor, nfft: int,
                   stride: int, pad: int | None = None, bt: int | None = None) -> torch.Tensor:
    """The staged twin: K4's partials with each tile's span staged once in
    shared memory by the TMA and every frame cut from there, on K4's CTA,
    transform and sums, (..., n_tiles, pad//2 + 1); equal to K4
    (cuda_pwelch.pwelch_power_partials) at the same tiles bit for bit.  Its
    tiles are K4's capped so that the span fits (staged_segs_per_tile)."""
    pad = pad or nfft
    _check(ext, mask, w, nfft, stride, pad)
    S, lead = mask.shape[-1], tuple(ext.shape[:-1])
    rows = math.prod(lead)
    if bt is None:
        bt = staged_segs_per_tile(S, rows, nfft, stride, pad)
    elif bt > staged_max_bt(nfft, stride, pad):
        raise ValueError(f"staged twin: {bt} segments a tile do not fit in shared memory")
    if not ext.is_cuda:
        return pwfloor_staged_plain(ext, mask, w, nfft, stride, pad, bt)
    ext, mask, w = _cuda_args("pwfloor_staged", ext, mask, w)
    if w.data_ptr() % 8:  # the kernel reads the window as float2 pairs, as K4
        w = w.clone()
    n_tiles = -(-S // bt)
    out = torch.empty(*lead, n_tiles, pad // 2 + 1, dtype=torch.float32, device=ext.device)
    return _launch("pwfloor_staged", _build.library().gdsp_pwfloor_staged, out,
                   ext.data_ptr(), mask.data_ptr(), w.data_ptr(), out.data_ptr(),
                   rfft_table(pad, ext.device).data_ptr(),
                   rows, ext.shape[-1], S, nfft, stride, pad.bit_length() - 1, bt, n_tiles)


def pwfloor_staged_radix2(ext: torch.Tensor, mask: torch.Tensor, w: torch.Tensor, nfft: int,
                          stride: int, pad: int | None = None,
                          bt: int | None = None) -> torch.Tensor:
    """pwfloor_staged's first design, its yardstick: each tile's span staged
    once in shared memory, then a segment at a time a bit-reversed load and
    log2 pad radix-2 stages behind block barriers (K4's first design,
    pwelch_radix2), (..., n_tiles, pad//2 + 1); its tiles capped by its own
    shared memory (_staged_max_bt)."""
    pad = pad or nfft
    _check(ext, mask, w, nfft, stride, pad)
    S, lead = mask.shape[-1], tuple(ext.shape[:-1])
    rows = math.prod(lead)
    if bt is None:
        bt = min(segs_per_tile(S, rows), _staged_max_bt(nfft, stride, pad))
    elif bt > _staged_max_bt(nfft, stride, pad):
        raise ValueError(f"staged twin: {bt} segments a tile do not fit in shared memory")
    if not ext.is_cuda:
        return pwfloor_staged_plain(ext, mask, w, nfft, stride, pad, bt)
    ext, mask, w = _cuda_args("pwfloor_staged_radix2", ext, mask, w)
    n_tiles = -(-S // bt)
    out = torch.empty(*lead, n_tiles, pad // 2 + 1, dtype=torch.float32, device=ext.device)
    return _launch("pwfloor_staged_radix2", _build.library().gdsp_pwfloor_staged_radix2, out,
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
    each row a pass, every slice's loads of a warp's row chunk issued
    before its first store."""
    _check_lane_planes(xr, xi, "slicestore")
    if not xr.is_cuda:
        return copy_split_plain(xr, xi)
    return _lane_launch("slicestore", _build.library().gdsp_slicestore, xr, xi)


def slicestore_sync(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """slicestore's first design, its yardstick: one warp a row, a slice's
    load and store in turn."""
    _check_lane_planes(xr, xi, "slicestore_sync")
    if not xr.is_cuda:
        return copy_split_plain(xr, xi)
    return _lane_launch("slicestore_sync", _build.library().gdsp_slicestore_sync, xr, xi)


def concatstore(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K14c concatstore: (yr, yi) = (xr, xi), staged in shared memory and
    stored as whole rows."""
    _check_lane_planes(xr, xi, "concatstore")
    if not xr.is_cuda:
        return copy_split_plain(xr, xi)
    return _lane_launch("concatstore", _build.library().gdsp_concatstore, xr, xi)


def gmm_concat(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K14c gmm_concat: K13's contraction, every slice of a row tile stored
    as whole rows, on thread-block clusters (lane_cluster_plan); equal to
    K13's result."""
    b, n = _check_lane_planes(xr, xi, "gmm_concat")
    if not xr.is_cuda:
        return gmm_floor_plain(xr, xi)
    xr, xi = _cuda_planes(xr, xi, "gmm_concat")
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    _launch("gmm_concat", _build.library().gdsp_gmm_concat, yr, xr.data_ptr(), xi.data_ptr(),
            yr.data_ptr(), yi.data_ptr(), gmm_tables(n, xr.device).data_ptr(), b, n,
            _cluster_resident("gmm_concat", n, xr.device))
    return yr, yi


# ---------------------------------------------------------------------------
# The cluster plan of gmm_concat, ls_full and i8_concat (csrc/lane_contract.cuh)
# ---------------------------------------------------------------------------

LANE_PITCH = 132  # words a staged tile row: rows 4 banks apart
LANE_MAX_CLUSTER = 8  # portable cluster size
LANE_CHUNK = LANE_MAX_CLUSTER * LANES  # columns a gmm_concat cluster covers
LANE_TILE_WORDS = 16 * LANE_PITCH  # one plane of a tile buffer
# G[k1]'s three planes and two two-plane tile buffers a CTA.
LANE_SMEM = (3 * LANES * LANES + 4 * LANE_TILE_WORDS) * 4
LANE_KINDS = ("gmm_concat", "ls_full", "i8_concat")  # the kernels' kind 0, 1 and 2


def lane_i8_smem(n1: int) -> int:
    """i8_concat's bytes of shared memory a CTA at n1 slices: nine 16 KB
    table planes, nine 2 KB digit planes, 16 row scales, a two-plane 16-row
    input tile, two rows buffers of the ceil(16 / n1) whole rows of a tile
    the CTA stores and their four mbarriers (lane_contract.cuh: i8_smem)."""
    return (9 * 16384 + 9 * 2048 + 16 * 4 + 2 * 16 * LANES * 4
            + 2 * 2 * -(-16 // n1) * n1 * LANES * 4 + 4 * 8)


class LanePlan(NamedTuple):
    """The launch plan of gmm_concat's, ls_full's or i8_concat's cluster
    kernel (gdsp_lane_cluster_geometry returns the same fields in this
    order)."""

    cluster: int  # CTAs a cluster: a CTA a 128-column slice
    clusters: int  # clusters of the grid
    ctas: int  # CTAs of the grid
    rows_tile: int  # rows of a tile
    tiles_unit: int  # tiles a cluster takes as one unit of work
    buffers: int  # two-plane tile buffers a CTA
    smem: int  # bytes of dynamic shared memory a CTA
    store_rows: int  # 1: whole rows over distributed shared memory; 0: 512-byte runs
    chunk_rows: int  # rows the network and contraction take at a time
    chunks: int  # 1024-column chunks of a row, each its own clusters


def lane_cluster_plan(kind: str, b: int, n: int, rows_per_block: int = 16,
                      chunk_rows: int = 16, store_rows: int = 0,
                      resident: int = 16) -> LanePlan:
    """The cluster kernels' plan (csrc/lane_contract.cuh: make_plan) at b x n.

    gmm_concat: n a multiple of 128; a cluster of min(n / 128, 8) CTAs
    covers a 1024-column chunk, the resident clusters split evenly among
    the chunks (at least one a chunk, at most one a tile), each walking its
    chunk's 16-row tiles; two tile buffers; whole-row stores.  ls_full:
    n = n1 x 128 with n1 in 1, 2, 4, 8, a cluster of n1 CTAs; a unit of
    rows_per_block / 16 tiles (the TPU's bt 256/512/1024 as 16/32/64 rows);
    at most `resident` clusters, each walking units cluster, cluster +
    clusters, ...; the tile buffer and the network's staging buffer;
    chunk_rows rows of a tile at a time; store_rows 0 (512-byte runs of
    each slice) or 1 (whole rows).  i8_concat: n = n1 x 128 with
    1 <= n1 <= 8, a cluster of n1 CTAs (a slice's int8 tables resident in
    each), at most `resident` clusters walking tiles cluster, cluster +
    clusters, ...; two rows buffers (lane_i8_smem); whole-row stores.  Raises ValueError
    for what the kernels do not take and RuntimeError where no cluster fits
    (resident < 1)."""
    if b < 0 or n < LANES or n % LANES:
        raise ValueError(f"lane_cluster_plan: bad shape {b} x {n}")
    n1, tiles = n // LANES, -(-b // LS_TILE)
    if kind == "gmm_concat":
        cluster, chunks = min(n1, LANE_MAX_CLUSTER), -(-n // LANE_CHUNK)
        tiles_unit, store, rows = 1, 1, LS_TILE
    elif kind == "ls_full":
        if (n1 not in LS_N1 or rows_per_block < LS_TILE or rows_per_block % LS_TILE
                or chunk_rows not in (2, 4, 8, 16) or store_rows not in (0, 1)):
            raise ValueError(f"lane_cluster_plan: ls_full does not take n {n}, rows_per_block "
                             f"{rows_per_block}, chunk_rows {chunk_rows}, store_rows {store_rows}")
        cluster, chunks = n1, 1
        tiles_unit, store, rows = rows_per_block // LS_TILE, store_rows, chunk_rows
    elif kind == "i8_concat":
        if n1 > LANE_MAX_CLUSTER:
            raise ValueError(f"lane_cluster_plan: i8_concat takes n1 <= {LANE_MAX_CLUSTER}, "
                             f"got n {n}")
        cluster, chunks, tiles_unit, store, rows = n1, 1, 1, 1, LS_TILE
    else:
        raise ValueError(f"lane_cluster_plan: kind must be one of {LANE_KINDS}, got {kind!r}")
    smem = lane_i8_smem(n1) if kind == "i8_concat" else LANE_SMEM
    if resident < 1:
        raise RuntimeError(f"{kind}: no cluster of {cluster} CTAs with {smem} bytes of "
                           f"shared memory fits on the card")
    units = -(-tiles // tiles_unit)
    per = min(max(resident // chunks, 1), units)
    clusters = per * chunks
    return LanePlan(cluster, clusters, clusters * cluster, LS_TILE, tiles_unit, 2, smem,
                    store, rows, chunks)


def lane_cluster_walk(kind: str, plan: LanePlan, b: int) -> list[tuple[int, list[int]]]:
    """(column chunk, tiles in order) of each cluster of the grid, as the
    kernels walk them: gmm_concat's cluster cl serves chunk cl % chunks and
    tiles cl // chunks, + clusters a chunk, ...; ls_full's takes units cl,
    cl + clusters, ... of tiles_unit tiles each (i8_concat's: tiles cl,
    cl + clusters, ..., a unit a tile)."""
    tiles = -(-b // LS_TILE)
    out = []
    for cl in range(plan.clusters):
        if kind == "gmm_concat":
            per = plan.clusters // plan.chunks
            out.append((cl % plan.chunks, list(range(cl // plan.chunks, tiles, per))))
        else:
            units = -(-tiles // plan.tiles_unit)
            out.append((0, [t for u in range(cl, units, plan.clusters)
                            for t in range(u * plan.tiles_unit,
                                           min((u + 1) * plan.tiles_unit, tiles))]))
    return out


def lane_gather_map(cols: int, cluster: int) -> list[list[tuple[int, int, int, int]]]:
    """The whole-row store of a tile over cols columns (lane_contract.cuh:
    gather_rows): for each CTA rank of a cluster of `cluster`, the (tile
    row, column, source CTA, source word in its buffer's plane) of every
    16-byte store it makes, in the order its threads take them.  Rank r
    stores rows r, r + cluster, ... < 16; column c comes from CTA c // 128,
    word row x 132 + c % 128."""
    quads = cols // 4
    out = []
    for rank in range(cluster):
        mine = -(-(LS_TILE - rank) // cluster)
        out.append([(rank + cluster * (e // quads), 4 * (e % quads), 4 * (e % quads) // LANES,
                     (rank + cluster * (e // quads)) * LANE_PITCH + 4 * (e % quads) % LANES)
                    for e in range(mine * quads)])
    return out


def i8_push_map(n1: int) -> list[list[tuple[int, int, int, int]]]:
    """i8_concat's pushes of a tile (csrc/int8_probe_kernels.cu): for each
    CTA k1 of a cluster of n1, the (tile row, column, owner CTA, word in the
    owner's rows-buffer plane) of every two-float store its threads make
    (warp w, lane 4 g + t: rows g and g + 8, columns 128 k1 + 16 w + 8 j +
    2 t).  Row r's owner is CTA r % n1, at its local row r // n1 of
    ceil(16 / n1); the owner then stores its rows whole."""
    n = n1 * LANES
    out = []
    for k1 in range(n1):
        stores = []
        for w in range(8):
            for lane in range(32):
                g, t = lane // 4, lane % 4
                for j in range(2):
                    for h in range(2):
                        r, c = g + 8 * h, LANES * k1 + 16 * w + 8 * j + 2 * t
                        stores.append((r, c, r % n1, (r // n1) * n + c))
        out.append(stores)
    return out


def lane_network_scatter(n1: int) -> dict[str, list]:
    """ls_full's network all-to-all on a cluster of n1 CTAs (P = 128 / n1
    points of a slice a CTA), as the kernel's load_points and network run:

      loads[c]:  (tile row, staged word, input column) of CTA c's 16-byte
                 copies: row r's slice j1 points c P .. c P + P - 1 at
                 words r x 132 + j1 P ..;
      reads[c]:  for each (row, point) thread pair, the staged words of its
                 n1 inputs, slice j1 in order;
      writes[c]: for each pair, (target CTA k1, word of its tile buffer)
                 of output slice k1: row r, position c P + p."""
    if n1 not in LS_N1:
        raise ValueError(f"lane_network_scatter: n1 must be one of {LS_N1}, got {n1}")
    P = LANES // n1
    loads, reads, writes = [], [], []
    for c in range(n1):
        loads.append([(w // 32, (w // 32) * LANE_PITCH + 4 * (w % 32),
                       (4 * (w % 32) // P) * LANES + c * P + 4 * (w % 32) % P)
                      for w in range(LS_TILE * 32)])
        pairs = [(e // P, e % P) for e in range(LS_TILE * P)]
        reads.append([[r * LANE_PITCH + j1 * P + p for j1 in range(n1)] for r, p in pairs])
        writes.append([[(k1, r * LANE_PITCH + c * P + p) for k1 in range(n1)] for r, p in pairs])
    return {"loads": loads, "reads": reads, "writes": writes}


@lru_cache(maxsize=None)
def _cluster_resident(kind: str, n: int, device: torch.device) -> int:
    """Clusters of kind's kernel (gmm_concat, ls_full, i8_concat) at n
    points the card holds at once (cudaOccupancyMaxActiveClusters with the
    plan's shared memory), asked once a (kind, n, device); 0 or a negative
    CUDA error where none fits: the launch then refuses."""
    lib = _build.library()
    with torch.cuda.device(device):
        fn = {"gmm_concat": lib.gdsp_gmm_concat_resident, "ls_full": lib.gdsp_ls_full_resident,
              "i8_concat": lib.gdsp_i8_concat_resident}[kind]
        return int(fn(n, 0))


def gmm_concat_stream(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """gmm_concat's first design (csrc/lane_probe_kernels.cu: a CTA every
    slice of a 16-row tile, G streamed through shared memory each tile): a
    yardstick off the main path, equal to gmm_concat and K13."""
    _check_lane_planes(xr, xi, "gmm_concat_stream")
    if not xr.is_cuda:
        return gmm_floor_plain(xr, xi)
    return _lane_launch("gmm_concat_stream", _build.library().gdsp_gmm_concat_stream, xr, xi,
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
    """K14d slice8: x + 1, one 128-column slice of each row a pass, a warp
    a row, every slice's loads issued before the first add and store."""
    _check_lane_planes(xr, xi, "slice8_add")
    if not xr.is_cuda:
        return add_one_plain(xr, xi)
    return _lane_launch("slice8_add", _build.library().gdsp_slice8_add, xr, xi)


def slice8_add_sync(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """slice8_add's first design, its yardstick: one warp a row, a slice's
    load, add and store in turn."""
    _check_lane_planes(xr, xi, "slice8_add_sync")
    if not xr.is_cuda:
        return add_one_plain(xr, xi)
    return _lane_launch("slice8_add_sync", _build.library().gdsp_slice8_add_sync, xr, xi)


def reshape_add(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K14d reshape: x + 1 over the (b n / 128, 128) view, one warp a row."""
    _check_lane_planes(xr, xi, "reshape_add")
    if not xr.is_cuda:
        return add_one_plain(xr, xi)
    return _lane_launch("reshape_add", _build.library().gdsp_reshape_add, xr, xi)


def _check_bd_tf32(xr: torch.Tensor, xi: torch.Tensor, table, name: str) -> tuple[int, int]:
    b, n = _check_lane_planes(xr, xi, name)
    if table is not None and tuple(table.shape) != (LANES, LANES):
        raise ValueError(f"{name}: table must be ({LANES}, {LANES}), got {tuple(table.shape)}")
    return b, n


def _bd_tf32_table(xr: torch.Tensor, table, name: str) -> torch.Tensor:
    return _re_f128_on(xr.device) if table is None else _cuda_args(name, xr, table)[1]


def bd_tf32(xr: torch.Tensor, xi: torch.Tensor,
            table: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """K14d bd1: each plane's slices times Re F128 (or `table`, (128, 128)
    float32) in one TF32 pass on the tensor cores, by wgmma m64n128k8 with
    A from registers on a persistent grid fed by TMA (bd_tf32_plan); no TF32
    flag is touched."""
    b, n = _check_bd_tf32(xr, xi, table, "bd_tf32")
    if not xr.is_cuda:
        return bd_tf32_plain(xr, xi, tf32=True, table=table)
    xr, xi = _cuda_planes(xr, xi, "bd_tf32")
    t = _bd_tf32_table(xr, table, "bd_tf32")
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    _launch("bd_tf32", _build.library().gdsp_bd_tf32, yr, xr.data_ptr(), xi.data_ptr(),
            yr.data_ptr(), yi.data_ptr(), t.data_ptr(), b, n, _b1_resident(xr.device))
    return yr, yi


def bd_tf32_sync(xr: torch.Tensor, xi: torch.Tensor,
                 table: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """bd_tf32's first design, its yardstick: mma.sync m16n8k8, a warp a
    16-row tile of one slice, A read from device memory in fragment order,
    the rounded table staged in shared memory, 8-byte stores."""
    _check_bd_tf32(xr, xi, table, "bd_tf32_sync")
    if not xr.is_cuda:
        return bd_tf32_plain(xr, xi, tf32=True, table=table)
    t = _bd_tf32_table(xr, table, "bd_tf32_sync")
    return _lane_launch("bd_tf32_sync", _build.library().gdsp_bd_tf32_sync, xr, xi, t)


def bd_hi(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K14d bd_hi: the unscaled 128-point DFT of every slice, Karatsuba in
    3xTF32 on the tensor cores, by wgmma on pairs of CTAs (bd_hi_plan), the
    tensor cores chaining BD_HI_CHAIN k-steps; no TF32 flag is touched."""
    b, n = _check_lane_planes(xr, xi, "bd_hi")
    if not xr.is_cuda:
        return bd_hi_plain(xr, xi)
    xr, xi = _cuda_planes(xr, xi, "bd_hi")
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    _launch("bd_hi", _build.library().gdsp_bd_hi, yr, xr.data_ptr(), xi.data_ptr(),
            yr.data_ptr(), yi.data_ptr(), _hi_packed(xr.device).data_ptr(), b, n,
            _hi_resident(xr.device))
    return yr, yi


def bd_hi_sync(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """bd_hi's first design, its yardstick: mma.sync m16n8k8, a warp a
    16-row tile of one slice, A read from device memory in fragment order,
    the tables gathered over j k mod 128, each k-step summed from zero and
    added on the CUDA cores; >= 120 dB against bd_hi."""
    _check_lane_planes(xr, xi, "bd_hi_sync")
    if not xr.is_cuda:
        return bd_hi_plain(xr, xi)
    return _lane_launch("bd_hi_sync", _build.library().gdsp_bd_hi_sync, xr, xi,
                        _hi_packed(xr.device))


# ---------------------------------------------------------------------------
# bd_tf32's plan (csrc/anatomy_probe_kernels.cu: make_bd1_plan)
# ---------------------------------------------------------------------------

B1_ROWS = 64  # rows of a tile: wgmma's M
B1_K = 32  # columns of a TMA box: one 128-byte swizzled row
B1_STAGES = 5  # the ring of stages, a (64-row, 128-column) tile of one plane each
B1_THREADS = 288  # two warpgroups, an item each, and a producer warp
B1_STORE_ROWS = 16  # rows of a TMA store box: one warp's
# round(table) as wgmma's B (128 x 128), the stages, a full and an empty
# mbarrier a stage, 1 KB to align the 128-byte swizzle's atoms.
B1_SMEM = LANES * LANES * 4 + B1_STAGES * B1_ROWS * LANES * 4 + 2 * B1_STAGES * 8 + 1024


class Bd1Plan(NamedTuple):
    """bd_tf32's launch plan (gdsp_bd_tf32_geometry returns the same fields
    in this order)."""

    ctas: int  # CTAs of the grid: the resident ones, at most the items
    per_cta: int  # items the busiest CTA walks
    rows_tile: int  # rows of a tile
    bins: int  # bins a warpgroup's product (wgmma's N)
    stages: int  # the ring of stages a CTA
    threads: int  # threads a CTA
    smem: int  # bytes of dynamic shared memory a CTA
    store_rows: int  # rows of a TMA store box


def bd_tf32_plan(b: int, n: int, resident: int = 132) -> Bd1Plan:
    """bd_tf32's plan at b x n (any multiple of 128): a persistent grid of
    the CTAs the card holds (one an SM) but no more than the (plane, 64-row
    tile, slice) items, which they take in turn.  Raises ValueError for what
    the kernel does not take and RuntimeError where no CTA fits."""
    if b < 0 or n < LANES or n % LANES or b >= 2**31:
        raise ValueError(f"bd_tf32_plan: bad shape {b} x {n}")
    if resident < 1:
        raise RuntimeError(f"bd_tf32: no CTA with {B1_SMEM} bytes of shared memory fits on "
                           f"the card")
    items = 2 * -(-b // B1_ROWS) * (n // LANES)
    ctas = max(1, min(resident, items))
    return Bd1Plan(ctas, -(-items // ctas), B1_ROWS, LANES, B1_STAGES, B1_THREADS, B1_SMEM,
                   B1_STORE_ROWS)


def bd_tf32_walk(plan: Bd1Plan, b: int, n: int) -> list[list[tuple[int, int, int]]]:
    """The (plane, 64-row tile, slice) items of each CTA in the order the
    kernel walks them: CTA c takes items c, c + ctas, ..., item i being
    plane i // (tiles n1), then the tile, then the slice (fastest); its k-th
    item lands in stage k % stages and warpgroup k % 2 contracts it."""
    n1, tiles = n // LANES, -(-b // B1_ROWS)
    items = 2 * tiles * n1
    return [[(i // (tiles * n1), i % (tiles * n1) // n1, i % n1)
             for i in range(c, items, plan.ctas)] for c in range(plan.ctas)]


def bd_tf32_store_offsets(j: int) -> list[list[int]]:
    """Byte offsets in a 64-row x 32-column box (the 128-byte swizzle) of
    the two float2 outputs each lane of warp 0 writes for the accumulators'
    8-column block j (rows g and g + 8, columns 8 (j % 4) + 2 t, lane =
    4 g + t); warp w adds 2048 w."""
    return [[gmm_tf32_offset(g + 8 * hh, 8 * (j % 4) + 2 * t, B1_ROWS) for hh in (0, 1)]
            for g, t in (divmod(lane, 4) for lane in range(32))]


@lru_cache(maxsize=None)
def _b1_resident(device: torch.device) -> int:
    """CTAs of bd_tf32's kernel (B1_THREADS threads and B1_SMEM bytes each)
    the card holds at once, asked once a device; 0 or a negative CUDA error
    where none fits: the launch then refuses."""
    with torch.cuda.device(device):
        return int(_build.library().gdsp_bd_tf32_resident(0))


# ---------------------------------------------------------------------------
# bd_hi's plan (csrc/anatomy_probe_kernels.cu: make_hi_plan)
# ---------------------------------------------------------------------------

# k-steps the tensor cores sum before each add on the CUDA cores (the
# kernel's kHiChain; PERF.md, section 6: the dB of each chain measured).
BD_HI_CHAIN = 4
HI_ROWS = 64  # rows of a tile: wgmma's M
HI_BINS = 64  # bins a CTA: half a slice (two warpgroups of wgmma's N = 32)
HI_STAGES = 2  # the ring of stages
HI_K_STAGE = 32  # columns of a slice a stage: one TMA box (128 bytes a row)
# The six resident planes (64 bins x 128 j), the stages (a and b), an
# mbarrier and a count of the warps that have read it a slot, 1 KB to align
# the 128-byte swizzle's atoms.
HI_SMEM = (6 * HI_BINS * LANES * 4 + HI_STAGES * 2 * HI_ROWS * HI_K_STAGE * 4 + HI_STAGES * 12
           + 1024)


class HiPlan(NamedTuple):
    """bd_hi's launch plan (gdsp_bd_hi_geometry returns the same fields in
    this order)."""

    pair: int  # CTAs an item: the two halves of a slice's bins
    pairs: int  # pairs of the grid: the resident pairs, at most the items
    ctas: int  # CTAs of the grid
    rows_tile: int  # rows of a tile
    bins_cta: int  # bins a CTA
    stages: int  # the ring of stages a CTA
    k_stage: int  # columns of a slice a stage
    smem: int  # bytes of dynamic shared memory a CTA
    per_pair: int  # items the busiest pair walks
    chain: int  # k-steps the tensor cores sum before an add on the CUDA cores


def bd_hi_plan(b: int, n: int, resident: int = 66) -> HiPlan:
    """bd_hi's plan at b x n (any multiple of 128): pairs of CTAs (2 p and
    2 p + 1 of a plain grid), as many as the card holds (one CTA an SM) but
    no more than the (64-row tile, slice) items, which they share out in
    turn.  Raises ValueError for what the kernel does not take and
    RuntimeError where no CTA fits (resident < 1)."""
    if b < 0 or n < LANES or n % LANES or b >= 2**31:
        raise ValueError(f"bd_hi_plan: bad shape {b} x {n}")
    if resident < 1:
        raise RuntimeError(f"bd_hi: no pair of CTAs with {HI_SMEM} bytes of shared memory "
                           f"fits on the card")
    items = -(-b // HI_ROWS) * (n // LANES)
    pairs = max(1, min(resident, items))
    return HiPlan(2, pairs, 2 * pairs, HI_ROWS, HI_BINS, HI_STAGES, HI_K_STAGE, HI_SMEM,
                  -(-items // pairs), BD_HI_CHAIN)


def bd_hi_walk(plan: HiPlan, b: int, n: int) -> list[list[tuple[int, int]]]:
    """The (slice, 64-row tile) items of each pair of the grid, in the
    order the kernel walks them: pair p takes items p, p + pairs, ..., item
    i being tile i // n1 and slice i % n1; each of the pair's CTAs h = 0, 1
    contracts and stores bins 64 h .. 64 h + 63 of each."""
    n1 = n // LANES
    items = -(-b // HI_ROWS) * n1
    return [[(i % n1, i // n1) for i in range(p, items, plan.pairs)] for p in range(plan.pairs)]


def bd_hi_fragment_offsets(kk: int) -> list[list[int]]:
    """Byte offsets in a landed 64-row x 32-column box (the 128-byte
    swizzle) of the four A values each lane of warp 0 reads at k-step kk
    of a stage (the kernel's hi_fragment: rows g and g + 8, columns
    8 kk + t and 8 kk + t + 4, lane = 4 g + t); warp w adds 2048 w."""
    out = []
    for lane in range(32):
        g, t = divmod(lane, 4)
        out.append([gmm_tf32_offset(r, 8 * kk + t + c, HI_ROWS)
                    for r, c in ((g, 0), (g + 8, 0), (g, 4), (g + 8, 4))])
    return out


@lru_cache(maxsize=None)
def _hi_resident(device: torch.device) -> int:
    """Pairs of bd_hi's CTAs (256 threads and HI_SMEM bytes each) the card
    holds at once, asked once a device; 0 or a negative CUDA error where
    none fits: the launch then refuses."""
    with torch.cuda.device(device):
        return int(_build.library().gdsp_bd_hi_resident(0))


# ---------------------------------------------------------------------------
# anat_full's plan (csrc/anatomy_probe_kernels.cu: make_anat_plan): bd_hi's
# walk, each stage a 16-column k-box of a and b and its partner k-box
# ---------------------------------------------------------------------------

ANAT_K_STAGE = 32  # columns of a k-box: 128 bytes a row, the TMA's 128-byte swizzle
ANAT_BOXES = 4  # boxes a stage: a and b at the k-box and at its partner
# The ring fills bd_hi's 32 KB: stages of four 64-row boxes.
ANAT_STAGES = HI_STAGES * 2 * HI_ROWS * HI_K_STAGE * 4 // (ANAT_BOXES * HI_ROWS * ANAT_K_STAGE * 4)
ANAT_SMEM = 6 * HI_BINS * LANES * 4 + HI_STAGES * 2 * HI_ROWS * HI_K_STAGE * 4 + ANAT_STAGES * 12 \
    + 1024


class AnatPlan(NamedTuple):
    """anat_full's launch plan (gdsp_anat_full_geometry returns the same
    fields in this order): bd_hi's (HiPlan) with 16-column stages, then
    the boxes a stage and the columns from a k-box to its partner."""

    pair: int  # CTAs an item: the two halves of a slice's bins
    pairs: int  # pairs of the grid: the resident pairs, at most the items
    ctas: int  # CTAs of the grid
    rows_tile: int  # rows of a tile
    bins_cta: int  # bins a CTA
    stages: int  # the ring of stages a CTA
    k_stage: int  # columns of a k-box
    smem: int  # bytes of dynamic shared memory a CTA
    per_pair: int  # items the busiest pair walks
    chain: int  # k-steps the tensor cores sum before an add on the CUDA cores
    boxes: int  # boxes a stage
    partner: int  # columns from a k-box to its partner: n / 2


def anat_full_plan(b: int, n: int, resident: int = 66) -> AnatPlan:
    """anat_full's plan at b x n (a multiple of 128 up to MAX_STAGED_N):
    bd_hi's pairs of CTAs, 64 bins of the six planes resident a CTA, over the
    same (64-row tile, slice) items (bd_hi_walk gives each pair's), in 16 KB
    stages of four 16-column boxes.  Raises ValueError for what the kernel
    does not take and RuntimeError where no CTA fits (resident < 1)."""
    if n > MAX_STAGED_N:
        raise ValueError(f"anat_full_plan: n must be at most {MAX_STAGED_N}, got {n}")
    hi = bd_hi_plan(b, n, resident)
    return AnatPlan(*hi._replace(k_stage=ANAT_K_STAGE, stages=ANAT_STAGES, smem=ANAT_SMEM),
                    ANAT_BOXES, n // 2)


def anat_full_stages(plan: AnatPlan, b: int, n: int) -> list[list[tuple[int, int, int]]]:
    """Each pair's stages in the order its CTAs read them: (the tile's first
    row, the k-box's first column, its partner's first column), the k-boxes
    of each item's slice in turn; the partner is n / 2 columns on or back,
    in the same row (half3 maps columns c and c + n / 2 to the same two
    columns every round)."""
    h = n // 2
    out = []
    for items in bd_hi_walk(plan, b, n):
        stages = []
        for sl, tile in items:
            for kb in range(LANES // plan.k_stage):
                c = sl * LANES + kb * plan.k_stage
                stages.append((tile * plan.rows_tile, c, c + h if c < h else c - h))
        out.append(stages)
    return out


def anat_box_offset(r: int, k: int, k_box: int = ANAT_K_STAGE) -> int:
    """Byte offset of element (row r, column k < k_box) of a 64-row x k_box
    box as the TMA lands it in the swizzle of its k_box x 4-byte rows (128,
    64 or 32 bytes): the 16-byte unit u of row r at u ^ (r >> s) & (units -
    1), units = k_box / 4 a row, s = 3 - log2(units) (the 128-byte swizzle
    of gmm_tf32_offset at 32 columns)."""
    units = k_box // 4
    s = 3 - (units.bit_length() - 1)
    return r * 4 * k_box + (((k >> 2) ^ ((r >> s) & (units - 1))) << 4) + (k & 3) * 4


def anat_fragment_offsets(kk: int) -> list[list[int]]:
    """Byte offsets in a landed anat_full box of the four A values each lane
    of warp 0 reads at k-step kk of a stage (the kernel's an_fragment: rows
    g and g + 8, columns 8 kk + t and 8 kk + t + 4, lane = 4 g + t); warp w
    adds 16 x 4 k_box w."""
    out = []
    for lane in range(32):
        g, t = divmod(lane, 4)
        out.append([anat_box_offset(r, 8 * kk + t + c)
                    for r, c in ((g, 0), (g + 8, 0), (g, 4), (g + 8, 4))])
    return out


def anat_prepass_offsets(k_box: int = ANAT_K_STAGE) -> list[list[int]]:
    """Byte offsets in a landed box of the elements each of a CTA's 256
    threads makes into A values (the kernel's an_prepass): thread x takes
    column x % k_box of rows x // k_box + (256 // k_box) i; a warp's
    accesses at one i are one a thread."""
    per = 256 // k_box
    return [[anat_box_offset(x // k_box + per * i, x % k_box, k_box)
             for i in range(HI_ROWS // per)] for x in range(256)]


def anat_a_model(xr: np.ndarray, xi: np.ndarray, tw: np.ndarray,
                 k_box: int = ANAT_K_STAGE) -> tuple[np.ndarray, np.ndarray]:
    """The A values anat_full's CTAs write over each landed stage, made box
    by box as the kernel makes them (float32 numpy): for each k-box of k_box columns
    and its partner n / 2 columns away, half3's three rounds of each value
    with its partner (u + v, u - v, u the lower column's), the half the
    value's column owns, then ar = a w - b w and ai = a w + b w."""
    f = np.float32
    xr, xi, tw = (np.asarray(v, dtype=f) for v in (xr, xi, tw))
    n = xr.shape[1]
    h = n // 2
    ar, ai = np.empty_like(xr), np.empty_like(xi)
    for c in range(0, n, k_box):
        own, other = slice(c, c + k_box), slice(c + h, c + h + k_box) if c < h else \
            slice(c - h, c - h + k_box)
        y = []
        for x in (xr, xi):
            lo, hi = (x[:, own], x[:, other]) if c < h else (x[:, other], x[:, own])
            r1a, r1b = lo + hi, lo - hi
            r2a, r2b = r1a + r1b, r1a - r1b
            y.append(r2a + r2b if c < h else r2a - r2b)
        w = tw[own]
        at, bt = y[0] * w, y[1] * w
        ar[:, own], ai[:, own] = at - bt, at + bt
    return ar, ai


@lru_cache(maxsize=None)
def _anat_resident(device: torch.device) -> int:
    """Pairs of anat_full's CTAs (256 threads and HI_SMEM bytes each) the
    card holds at once, asked once a device; 0 or a negative CUDA error
    where none fits: the launch then refuses."""
    with torch.cuda.device(device):
        return int(_build.library().gdsp_anat_full_resident(0))


def anat_full(xr: torch.Tensor, xi: torch.Tensor,
              tw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K14d full: half3, the row tw, then bd_hi, in one kernel on bd_hi's
    walk (anat_full_plan): each stage brings a 32-column k-box of both
    planes and its partner n / 2 columns away by TMA, the CTA makes the
    rounds and the row once a stage in shared memory and each warp the
    3xTF32 split in registers before wgmma; nothing returns to device
    memory between the steps."""
    b, n = _check_staged(xr, xi, "anat_full")
    if tuple(tw.shape) != (n,):
        raise ValueError(f"anat_full: tw must have shape ({n},), got {tuple(tw.shape)}")
    if not xr.is_cuda:
        return anat_full_plain(xr, xi, tw)
    xr, xi = _cuda_planes(xr, xi, "anat_full")
    tw = _cuda_args("anat_full", xr, tw)[1]
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    _launch("anat_full", _build.library().gdsp_anat_full, yr, xr.data_ptr(), xi.data_ptr(),
            yr.data_ptr(), yi.data_ptr(), tw.data_ptr(), _hi_packed(xr.device).data_ptr(), b, n,
            _anat_resident(xr.device))
    return yr, yi


def anat_full_sync(xr: torch.Tensor, xi: torch.Tensor,
                   tw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """anat_full's first design, its yardstick: min(16, 16384 / n) whole
    rows of both planes staged a block, half3's rounds and the row there
    behind barriers, then bd_hi_sync's contraction (mma.sync m16n8k8, the
    tables gathered over j k mod 128) from shared memory."""
    _, n = _check_staged(xr, xi, "anat_full_sync")
    if tuple(tw.shape) != (n,):
        raise ValueError(f"anat_full_sync: tw must have shape ({n},), got {tuple(tw.shape)}")
    if not xr.is_cuda:
        return anat_full_plain(xr, xi, tw)
    tw = _cuda_args("anat_full_sync", xr, tw)[1]
    return _lane_launch("anat_full_sync", _build.library().gdsp_anat_full_sync, xr, xi, tw,
                        _hi_packed(xr.device))


# ---------------------------------------------------------------------------
# K14h and K14i: the butterfly twins
# ---------------------------------------------------------------------------

VDIF_N1 = (1, 2, 4, 8)  # slices of a row vdif takes: n = n1 x 128
PEEL_ROWS = 128  # rows of sdif_peel's column DFT
SDIF_COLS = 32  # columns of a sdif tile (a CTA's)
SDIF_ROWS = 16  # rows a thread of sdif_peel's kernel holds
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


def _cmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a w as the kernels' cmul writes it, each real operation a torch call
    of its own: the same rounding at every shape (torch's complex multiply
    rounds by a path that depends on the shape)."""
    return torch.complex(a.real * w.real - a.imag * w.imag, a.real * w.imag + a.imag * w.real)


def _sdif_stages(x: torch.Tensor) -> torch.Tensor:
    """The seven radix-2 DIF stages across the rows of complex (B, 128, m)."""
    cols = torch.from_numpy(_sdif_columns()).to(x.device, x.dtype)
    B, m = x.shape[0], x.shape[-1]
    for s in range(7):
        h = 64 >> s
        x = x.reshape(B, PEEL_ROWS // (2 * h), 2, h, m)
        a, c = x[:, :, 0], x[:, :, 1]
        wb = cols[s].reshape(PEEL_ROWS // (2 * h), 2, h)[:, 1, :, None]
        x = torch.stack([a + c, _cmul(a - c, wb)], dim=2)
    return x.reshape(B, PEEL_ROWS, m)


def sdif_stages_plain(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """sdif_peel_plain's seven stages alone, without Tb, in the input's dtype."""
    m = _check_sdif(xr, xi)
    x = _sdif_stages(torch.complex(xr, xi).to(_cdtype(xr)).reshape(-1, PEEL_ROWS, m))
    return x.real.reshape(xr.shape).contiguous(), x.imag.reshape(xr.shape).contiguous()


def sdif_peel_plain(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of K14i in the input's dtype: the seven radix-2
    DIF stages across the 128 rows of (..., 128, m) planes, then
    Tb[r, t] = W_N^{brev7(r) t} (the exponent exact in int64)."""
    m = _check_sdif(xr, xi)
    lead, dev, cdt = xr.shape[:-2], xr.device, _cdtype(xr)
    x = _sdif_stages(torch.complex(xr, xi).to(cdt).reshape(-1, PEEL_ROWS, m))
    tb = _exp_table(PEEL_ROWS * m, brev7_perm().to(dev),
                    torch.arange(m, device=dev), False).to(cdt)
    y = (x * tb).reshape(*lead, PEEL_ROWS, m)
    return y.real.contiguous(), y.imag.contiguous()


def sdif_regs_model(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """sdif_peel's stages as its kernel moves the data (csrc/dif_probe_kernels.cu:
    sdif_peel_kernel), each butterfly the plain version's operations: row
    group j of a column holds rows j + 8 q (q < 16) for the stages at h =
    64, 32, 16, 8 (registers q and q + h / 8), the exchange, then rows
    16 j + e (e < 16) for h = 4, 2, 1 (registers e and e + h).  Equal to
    sdif_stages_plain bit for bit in either dtype."""
    m = _check_sdif(xr, xi)
    groups = PEEL_ROWS // SDIF_ROWS
    cols = torch.from_numpy(_sdif_columns()).to(xr.device, _cdtype(xr))
    x = torch.complex(xr, xi).to(_cdtype(xr)).reshape(-1, PEEL_ROWS, m)
    z = list(x.reshape(-1, SDIF_ROWS, groups, m).unbind(1))  # z[q][:, j] = row j + 8 q
    j = torch.arange(groups, device=xr.device)
    for s in range(4):
        h = 64 >> s
        g = h // groups
        for q in (q for q in range(SDIF_ROWS) if not q & g):
            a, v = z[q], z[q + g]
            z[q], z[q + g] = a + v, _cmul(a - v, cols[s, j + groups * q + h][:, None])
    rows = torch.stack(z, 1).reshape(-1, PEEL_ROWS, m)  # the exchange: row j + 8 q
    z = list(rows.reshape(-1, groups, SDIF_ROWS, m).unbind(2))  # z[e][:, j] = row 16 j + e
    for s in range(4, 7):
        h = 64 >> s
        for e in (e for e in range(SDIF_ROWS) if not e & h):
            a, v = z[e], z[e + h]
            z[e], z[e + h] = a + v, _cmul(a - v, cols[s, SDIF_ROWS * j + e + h][:, None])
    y = torch.stack(z, 2).reshape(xr.shape)
    return y.real.contiguous(), y.imag.contiguous()


def sdif_tb_model(m: int, columns: np.ndarray | None = None) -> np.ndarray:
    """complex64 (128, len(columns)): the Tb sdif_peel's kernel applies at
    rows r < 128 and the given columns t (default all of m): W_N^{k c0}
    from K8's factored hi and lo times the tile table's W_N^{k cc}, k =
    brev7(r), c0 = t - cc the tile's first column, each complex product
    rounded to float32 as the kernel's."""
    t = np.arange(m) if columns is None else np.asarray(columns)
    n = PEEL_ROWS * m
    hi, lo, lo_bits = _factor_tables(n, False, torch.device("cpu"))
    hi = hi[:, 0].numpy() + 1j * hi[:, 1].numpy()
    lo = lo[:, 0].numpy() + 1j * lo[:, 1].numpy()
    tt = cuda_outer._tile_table(n, PEEL_ROWS, SDIF_COLS, False, torch.device("cpu"))
    tt = tt[:, 0].numpy() + 1j * tt[:, 1].numpy()
    k = brev7_perm().numpy()[:, None]
    cc = t % SDIF_COLS
    p = k * (t - cc)[None, :]
    c64 = np.complex64
    w = (hi[p >> lo_bits].astype(c64) * lo[p & ((1 << lo_bits) - 1)].astype(c64)).astype(c64)
    return (w * tt[k * SDIF_COLS + cc[None, :]].astype(c64)).astype(c64)


def vdif(xr: torch.Tensor, xi: torch.Tensor,
         scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """K14h: the n-point DFT (n = n1 x 128, n1 in 1, 2, 4, 8) of every row of
    two float32 planes (b, n), times scale, by the slice network, T and a
    warp-shuffle 128-point DIF; the vdif digit order out.  A warp a row,
    the row brought by 16-byte cp.async into the warp's shared buffer
    (vdif_plan)."""
    _, n = _check_vdif(xr, xi)
    if not xr.is_cuda:
        return vdif_plain(xr, xi, scale)
    return _lane_launch("vdif", _build.library().gdsp_vdif, xr, xi,
                        _vdif_packed(n // LANES, float(scale), xr.device))


def vdif_sync(xr: torch.Tensor, xi: torch.Tensor,
              scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """vdif's first design, its yardstick: one warp a row and one row a
    warp, eight rows a block on a grid of every row, T and the stage
    twiddles read from device memory."""
    _, n = _check_vdif(xr, xi)
    if not xr.is_cuda:
        return vdif_plain(xr, xi, scale)
    return _lane_launch("vdif_sync", _build.library().gdsp_vdif_sync, xr, xi,
                        _vdif_packed(n // LANES, float(scale), xr.device))


VD_WARPS = 4  # warps a block of vdif's kernel, a row each
VD_MIN_BLOCKS = 4  # blocks an SM its registers are sized for (16 warps)


def vdif_smem(n1: int) -> int:
    """Bytes of shared memory a block of vdif's kernel takes at n1 slices:
    T, then each warp's row buffer (both planes of a row)."""
    return n1 * LANES * 8 + VD_WARPS * n1 * LANES * 8


class VdifPlan(NamedTuple):
    """vdif's launch plan (gdsp_vdif_geometry returns the same fields in
    this order)."""

    threads: int  # threads a block
    blocks: int  # blocks of the grid: a warp a row
    smem: int  # bytes of dynamic shared memory a block


def vdif_plan(b: int, n: int) -> VdifPlan:
    """vdif's plan for b rows of n points: blocks of VD_WARPS warps, warp g
    of the grid taking row g.  Raises ValueError for b < 0 or a width vdif
    does not take."""
    if b < 0 or n % LANES or n // LANES not in VDIF_N1:
        raise ValueError(f"vdif_plan: bad shape {b} x {n}")
    return VdifPlan(32 * VD_WARPS, max(1, -(-b // VD_WARPS)), vdif_smem(n // LANES))


def vdif_walk(plan: VdifPlan, b: int) -> list[list[int]]:
    """The rows each warp of the grid takes: warp g row g, if there is one."""
    return [[g] if g < b else [] for g in range(plan.blocks * VD_WARPS)]


def _sdif_launch_tables(m: int, device: torch.device, tile_table: bool) -> tuple:
    """The tables a sdif kernel reads at (128, m): the stage columns, K8's
    factored hi and lo of W_N (N = 128 m) and, where tile_table, K8's tile
    table W_N^{k cc} (k < 128, cc < SDIF_COLS) that the redesign's Tb reads
    at k = brev7(r)."""
    hi, lo, _ = _factor_tables(PEEL_ROWS * m, False, device)
    tables = (_sdif_cols_packed(device), hi, lo)
    if tile_table:
        tables += (cuda_outer._tile_table(PEEL_ROWS * m, PEEL_ROWS, SDIF_COLS, False, device),)
    return tables


def _sdif_launch(name: str, entry: str, xr: torch.Tensor,
                 xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    m = _check_sdif(xr, xi)
    if not xr.is_cuda:
        return sdif_peel_plain(xr, xi)
    xr, xi = _cuda_planes(xr, xi, name)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    tables = _sdif_launch_tables(m, xr.device, name == "sdif_peel")
    _launch(name, getattr(_build.library(), entry), yr,
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            *(t.data_ptr() for t in tables), m, xr.numel() // (PEEL_ROWS * m),
            cuda_outer.lo_bits_of(PEEL_ROWS * m))
    return yr, yi


class SdifPlan(NamedTuple):
    """sdif_peel's launch plan (gdsp_sdif_geometry returns the same fields in
    this order)."""

    threads: int  # threads a block: SDIF_COLS columns x 8 row groups
    columns: int  # columns a tile (a CTA's)
    tiles: int  # tiles a (128, m) plane: grid.x
    smem: int  # bytes of shared memory a block: the exchange of both planes


def sdif_plan(m: int, batch: int) -> SdifPlan:
    """sdif_peel's plan for `batch` (128, m) planes: a CTA a (batch element,
    32-column tile), the last tile ragged.  Raises ValueError for m < 1 or
    batch < 0."""
    if m < 1 or batch < 0:
        raise ValueError(f"sdif_plan: bad shape {batch} x (128, {m})")
    return SdifPlan(SDIF_COLS * PEEL_ROWS // SDIF_ROWS, SDIF_COLS, -(-m // SDIF_COLS),
                    2 * PEEL_ROWS * SDIF_COLS * 4)


def sdif_walk(plan: SdifPlan, m: int, batch: int) -> dict[tuple[int, int], list[int]]:
    """The columns each CTA (batch element, tile) of the grid takes."""
    return {(b, t): [c for c in range(t * plan.columns, (t + 1) * plan.columns) if c < m]
            for b in range(batch) for t in range(plan.tiles)}


def sdif_peel(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K14i: the 128-point peel of (..., 128, m) float32 planes by seven
    radix-2 stages in registers on K8's column tile (sdif_plan), then Tb as
    W_N^{k c0} of the row times K8's tile table; row r holds
    outer_dft_split(x, 128, 1)'s row brev7(r)."""
    return _sdif_launch("sdif_peel", "gdsp_sdif_peel", xr, xi)


def sdif_peel_sync(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """sdif_peel's first design, its yardstick: a 128 x 32 tile staged in
    shared memory, seven radix-2 stages there behind a barrier each, Tb
    gathered a point from K8's factored tables."""
    return _sdif_launch("sdif_peel_sync", "gdsp_sdif_peel_sync", xr, xi)


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


def _check_gmm_tf32(xr: torch.Tensor, xi: torch.Tensor, g, name: str) -> tuple[int, int]:
    b, n = _check_lane_planes(xr, xi, name)
    if g is not None and tuple(g.shape) != (n // LANES, 3, LANES, LANES):
        raise ValueError(f"{name}: g must be ({n // LANES}, 3, {LANES}, {LANES}), "
                         f"got {tuple(g.shape)}")
    return b, n


def _gmm_tf32_cuda(name: str, xr: torch.Tensor, xi: torch.Tensor, g, *extra) -> tuple:
    """Launch C entry `name` (gdsp_<name>) on the card: the planes, the
    tables (K13's by default), b, n and extra."""
    b, n = xr.shape
    g = gmm_tables(n, xr.device) if g is None else _cuda_args(name, xr, g)[1]
    if g.data_ptr() % 16:  # gmm_tf32 reads the tables 16 bytes at a time
        g = g.clone()
    xr, xi = _cuda_planes(xr, xi, name)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    _launch(name, getattr(_build.library(), f"gdsp_{name}"), yr, xr.data_ptr(), xi.data_ptr(),
            yr.data_ptr(), yi.data_ptr(), g.data_ptr(), b, n, *extra)
    return yr, yi


# k-steps the tensor cores sum before each add on the CUDA cores (the
# kernel's kWgChain; PERF.md, section 6: the dB of each chain measured).
GMM_TF32_CHAIN = 4


@lru_cache(maxsize=None)
def _tf32_resident(device: torch.device) -> int:
    """Pairs of gmm_tf32's CTAs (288 threads and 230,448 bytes each) the
    card holds at once, asked once a device; 0 or a negative CUDA error
    where none fits: the launch then refuses."""
    with torch.cuda.device(device):
        return int(_build.library().gdsp_gmm_tf32_resident(0))


def gmm_tf32(xr: torch.Tensor, xi: torch.Tensor,
             g: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """K14f gmm_default: K13's contraction (or with the (n1, 3, 128, 128)
    float32 tables g) with each Karatsuba product in one TF32 pass on the
    tensor cores, by wgmma on pairs of CTAs a slice (gmm_tf32_plan), the
    tensor cores chaining GMM_TF32_CHAIN k-steps; no TF32 flag is
    touched."""
    _check_gmm_tf32(xr, xi, g, "gmm_tf32")
    if not xr.is_cuda:
        return gmm_tf32_plain(xr, xi, tf32=True, g=g)
    return _gmm_tf32_cuda("gmm_tf32", xr, xi, g, _tf32_resident(xr.device))


def gmm_tf32_sync(xr: torch.Tensor, xi: torch.Tensor,
                  g: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """gmm_tf32's first design (csrc/lane_slice_probe_kernels.cu: mma.sync
    m16n8k8, A read from device memory in fragment order, each k-step
    summed from zero and added on the CUDA cores): a yardstick off the main
    path, >= 120 dB against gmm_tf32."""
    b, n = _check_gmm_tf32(xr, xi, g, "gmm_tf32_sync")
    if not xr.is_cuda:
        return gmm_tf32_plain(xr, xi, tf32=True, g=g)
    return _gmm_tf32_cuda("gmm_tf32_sync", xr, xi, g, gmm_groups(b, n))


# ---------------------------------------------------------------------------
# gmm_tf32's plan (csrc/lane_slice_probe_kernels.cu: make_tf32_plan)
# ---------------------------------------------------------------------------

TF32_ROWS = 64  # rows of a tile: wgmma's M
TF32_BINS = 64  # bins a CTA: half a slice (two warpgroups of wgmma's N = 32)
TF32_STAGES = 3  # the ring of stages
TF32_K_STAGE = 64  # columns of a slice a stage: two TMA boxes of 32 (128 bytes)
# G's three half planes, the stages (a and b), two stages' round(a + b), six
# mbarriers, 1 KB to align the 128-byte swizzle's atoms.
TF32_SMEM = (3 * TF32_BINS * LANES * 4 + TF32_STAGES * 2 * TF32_ROWS * TF32_K_STAGE * 4
             + 2 * TF32_ROWS * TF32_K_STAGE * 4 + 48 + 1024)


class Tf32Plan(NamedTuple):
    """gmm_tf32's launch plan (gdsp_gmm_tf32_geometry returns the same
    fields in this order)."""

    pair: int  # CTAs a slice's tile: the two halves of its bins
    pairs: int  # pairs of the grid: per_slice x n1
    ctas: int  # CTAs of the grid
    rows_tile: int  # rows of a tile
    bins_cta: int  # bins a CTA
    stages: int  # the ring of stages a CTA
    k_stage: int  # columns of a slice a stage
    smem: int  # bytes of dynamic shared memory a CTA
    per_slice: int  # pairs a slice
    chain: int  # k-steps the tensor cores sum before an add on the CUDA cores


def gmm_tf32_plan(b: int, n: int, resident: int = 66) -> Tf32Plan:
    """gmm_tf32's plan at b x n (any multiple of 128): pairs of CTAs (2 p
    and 2 p + 1 of a plain grid), the `resident` pairs the card holds (one
    CTA an SM) split evenly among the n1 slices (at least one a slice, at
    most one a 64-row tile).  Raises ValueError for what the kernel does not
    take and RuntimeError where no CTA fits (resident < 1)."""
    if b < 0 or n < LANES or n % LANES:
        raise ValueError(f"gmm_tf32_plan: bad shape {b} x {n}")
    if resident < 1:
        raise RuntimeError(f"gmm_tf32: no pair of CTAs with {TF32_SMEM} bytes of shared "
                           f"memory fits on the card")
    n1, tiles = n // LANES, -(-b // TF32_ROWS)
    per = min(max(resident // n1, 1), max(tiles, 1))
    return Tf32Plan(2, per * n1, 2 * per * n1, TF32_ROWS, TF32_BINS, TF32_STAGES, TF32_K_STAGE,
                    TF32_SMEM, per, GMM_TF32_CHAIN)


def gmm_tf32_walk(plan: Tf32Plan, b: int, n: int) -> list[tuple[int, list[int]]]:
    """(slice, 64-row tiles in order) of each pair of the grid, as the
    kernel walks them: pair p serves slice p % n1 and tiles
    p // n1, + per_slice, ..."""
    n1, tiles = n // LANES, -(-b // TF32_ROWS)
    return [(p % n1, list(range(p // n1, tiles, plan.per_slice))) for p in range(plan.pairs)]


def gmm_tf32_bins(plan: Tf32Plan) -> list[range]:
    """The bins of a slice each CTA h = 0, 1 of a pair contracts and stores."""
    return [range(h * plan.bins_cta, (h + 1) * plan.bins_cta) for h in range(plan.pair)]


def gmm_tf32_offset(r: int, k: int, rows: int) -> int:
    """Byte offset of element (row r, column k) of a K-major wgmma operand
    in the 128-byte swizzle (hopper_async.cuh: b128_offset): chunks of 32
    columns, each `rows` rows of 128 bytes, the 16-byte units of a row XORed
    with the row's index mod 8.  A stage's plane (64 rows, as a 32-column TMA box
    lands it) and G's resident planes (the CTA's 64 bins as rows) share it."""
    return (k >> 5) * rows * 128 + r * 128 + ((((k & 31) >> 2) ^ (r & 7)) << 4) + (k & 3) * 4


def _check_ls_full(xr: torch.Tensor, xi: torch.Tensor, store: str, chunks: int,
                   rows_per_block: int, name: str) -> tuple[int, int]:
    b, n = _check_ls(xr, xi, name)
    if store not in LS_STORES:
        raise ValueError(f"{name}: store must be one of {LS_STORES}, got {store!r}")
    if chunks not in LS_CHUNKS:
        raise ValueError(f"{name}: chunks must be one of {LS_CHUNKS}, got {chunks}")
    if rows_per_block < LS_TILE or rows_per_block % LS_TILE:
        raise ValueError(f"{name}: rows_per_block must be a positive multiple of {LS_TILE}, "
                         f"got {rows_per_block}")
    return b, n


def ls_full(xr: torch.Tensor, xi: torch.Tensor, store: str = "slices", chunks: int = 1,
            rows_per_block: int = LS_TILE) -> tuple[torch.Tensor, torch.Tensor]:
    """K14f full: the n-point DFT (n = n1 x 128, n1 in 1, 2, 4, 8) of every
    row of two float32 planes, the TPU's lane-slice K1 (slice network, then
    K13's contraction with unscaled G), in the lane-slice digit order, on
    clusters of n1 CTAs (lane_cluster_plan).  store "slices" stores each
    slice's 512-byte run of a row as its contraction ends (k_full), "rows"
    whole rows of a tile gathered over the cluster (k_full_concat); chunks
    1, 2, 4, 8 runs network and contraction on 16 / chunks rows of a tile
    at a time, a cluster barrier between (make_subtiled); rows_per_block
    16, 32, 64 rows a cluster takes as one unit of work are the TPU's bt
    256, 512, 1024 (x1, x2, x4).  Every setting gives the same result."""
    b, n = _check_ls_full(xr, xi, store, chunks, rows_per_block, "ls_full")
    if not xr.is_cuda:
        return ls_full_plain(xr, xi)
    xr, xi = _cuda_planes(xr, xi, "ls_full")
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    _launch("ls_full", _build.library().gdsp_ls_full, yr, xr.data_ptr(), xi.data_ptr(),
            yr.data_ptr(), yi.data_ptr(), ls_tables(n, xr.device).data_ptr(), b, n,
            rows_per_block, LS_TILE // chunks, int(store == "rows"),
            _cluster_resident("ls_full", n, xr.device))
    return yr, yi


def ls_full_stream(xr: torch.Tensor, xi: torch.Tensor, store: str = "slices", chunks: int = 1,
                   rows_per_block: int = LS_TILE) -> tuple[torch.Tensor, torch.Tensor]:
    """ls_full's first design (csrc/lane_slice_probe_kernels.cu: a CTA
    rows_per_block rows walked in 16-row tiles, the network in shared
    memory, G streamed through shared memory each tile and chunk): a
    yardstick off the main path, equal to ls_full at every setting."""
    b, n = _check_ls_full(xr, xi, store, chunks, rows_per_block, "ls_full_stream")
    if not xr.is_cuda:
        return ls_full_plain(xr, xi)
    xr, xi = _cuda_planes(xr, xi, "ls_full_stream")
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    _launch("ls_full_stream", _build.library().gdsp_ls_full_stream, yr, xr.data_ptr(),
            xi.data_ptr(), yr.data_ptr(), yi.data_ptr(), ls_tables(n, xr.device).data_ptr(), b,
            n, rows_per_block, LS_TILE // chunks, int(store == "rows"))
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


def istft_radix2_tiles(n_frames: int, rows: int, nfft: int, hop: int) -> int:
    """Frames a block of istft_radix2 owns: K6's tile count
    (cuda_istft.tile_frames before its rounding to whole rounds), never
    fewer than the tail stitch needs (bt*hop >= nfft - hop)."""
    bt = max(1, min(cuda_istft._MAX_FRAMES_PER_TILE,
                    -(-(n_frames * rows) // cuda_istft._TARGET_BLOCKS)))
    return max(bt, -(-(nfft - hop) // hop))


def _istft_stitch(out: torch.Tensor, bt: int, hop: int, nfft: int, length: int) -> torch.Tensor:
    """istft_radix2's (rows, tiles, span) tile spans -> (rows, length): each
    tile owns bt*hop samples; its nfft - hop tail lands on the head of the
    next tile's (bt*hop >= nfft - hop), and the last tile's tail ends the
    signal.  One shifted add, no scatter (pallas_istft.py:274-296)."""
    rows, n_tiles, _ = out.shape
    own, tail = bt * hop, nfft - hop
    main = out[..., :own].contiguous()
    if tail > 0 and n_tiles > 1:
        main[:, 1:, :tail] += out[:, :-1, own:]
    y = torch.cat([main.reshape(rows, n_tiles * own), out[:, -1, own:]], dim=-1)
    return y[:, :length]


def istft_radix2(spec: torch.Tensor, w: torch.Tensor, nfft: int, hop: int,
                 onesided: bool = True) -> torch.Tensor:
    """K6's first design (csrc/radix2_probe_kernels.cu): istft_overlap_add's
    function, the same shapes and checks, by the radix-2 shared-memory
    kernel K6 first ran on tiles of istft_radix2_tiles frames, their tails
    stitched here: a yardstick off the main path."""
    pad = cuda_istft._check(spec, w, nfft, hop, onesided)
    if not spec.is_cuda:
        return cuda_istft.istft_overlap_add_plain(spec, w, nfft, hop, onesided)
    name, lead = "istft_radix2", spec.shape[:-2]
    args = cuda_istft._cuda_args(spec, w, nfft, hop, name)
    if args is None:
        length = (spec.shape[-2] - 1) * hop + nfft if spec.shape[-2] else 0
        return torch.zeros(*lead, length, dtype=torch.float32, device=spec.device)
    rows, F, bins, length, s2, w = args
    dev = spec.device
    bt = istft_radix2_tiles(F, rows, nfft, hop)
    n_tiles = -(-F // bt)
    out = torch.empty(rows, n_tiles, (bt - 1) * hop + nfft, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _build.library().gdsp_istft_radix2(
            s2.data_ptr(), w.data_ptr(), twiddle_table(pad, True, dev).data_ptr(),
            out.data_ptr(), rows, F, bins, int(onesided), nfft, hop, pad.bit_length() - 1, bt,
            n_tiles, 1.0 / pad, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, name)
    launches[name] += 1
    return _istft_stitch(out, bt, hop, nfft, length).reshape(*lead, length)


def peel_rows_radix2(xr: torch.Tensor, xi: torch.Tensor, inverse: bool = False,
                     scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """K9's first design (csrc/radix2_probe_kernels.cu): peel_rows_fused_split's
    function by the radix-2 shared-memory kernel K9 first ran: a yardstick
    off the main path."""
    n3 = cuda_outer._check_peel(xr, xi)
    if not xr.is_cuda:
        return cuda_outer.peel_rows_fused_split_plain(xr, xi, inverse, scale)
    name = "peel_rows_radix2"
    xr, xi, yr, yi, batch = cuda_outer._peel_planes(xr, xi, name)
    if batch == 0:
        return yr, yi
    dev = xr.device
    hi, lo, lo_bits = _factor_tables(cuda_outer.PEEL * n3, inverse, dev)
    with torch.cuda.device(dev):
        rc = _build.library().gdsp_peel_rows_radix2(
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            cuda_outer._dft_table(cuda_outer.PEEL, inverse, dev).data_ptr(),
            twiddle_table(n3, inverse, dev).data_ptr(), hi.data_ptr(), lo.data_ptr(),
            n3.bit_length() - 1, batch, lo_bits, float(scale),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, name)
    launches[name] += 1
    return yr, yi


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


def _i8_dot_cuda(name: str, a: torch.Tensor, b: torch.Tensor, m: int, k: int,
                 n: int) -> torch.Tensor:
    a, b = a.contiguous(), b.contiguous()
    c = torch.empty(m, n, dtype=torch.int32, device=a.device)
    return _launch(name, getattr(_build.library(), f"gdsp_{name}"), c, a.data_ptr(),
                   b.data_ptr(), c.data_ptr(), m, k, n)


def i8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K14g's dot: a (m, k) int8 @ b (k, n) int8 into int32, exactly, on the
    int8 tensor cores (i8_dot_plan: 32 x 32 tiles of c, the tile's bytes in
    one round of 16-byte copies where k % 16 == n % 16 == 0 and both
    operands are 16-byte aligned, else predicated byte loads)."""
    m, k, n = _check_i8_dot(a, b)
    if not a.is_cuda:
        return i8_dot_plain(a, b)
    return _i8_dot_cuda("i8_dot", a, b, m, k, n)


def i8_dot_bytes(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """i8_dot's first design (64 x 64 tiles of c, each 32-deep k-step staged
    a byte a load): a yardstick off the main path, equal to i8_dot."""
    m, k, n = _check_i8_dot(a, b)
    if not a.is_cuda:
        return i8_dot_plain(a, b)
    return _i8_dot_cuda("i8_dot_bytes", a, b, m, k, n)


# i8_dot's plan (csrc/int8_probe_kernels.cu: make_dot_plan).
I8_DOT_TILE = 32  # rows and columns of a CTA's tile of c
I8_DOT_CHUNK = 128  # k of a chunk of the ring
I8_DOT_STAGES = 4  # chunks in flight: k <= 512 in one round
I8_DOT_PITCH = I8_DOT_CHUNK + 16  # bytes a staged row of a and of b transposed
I8_DOT_THREADS = 128  # four warps of 16 x 16


class I8DotPlan(NamedTuple):
    """i8_dot's launch plan (gdsp_i8_dot_geometry returns the same fields
    in this order)."""

    tile: int  # rows and columns of a CTA's tile of c
    ctas: int  # CTAs of the grid, gx gy gz
    gx: int  # column tiles
    gy: int  # row tiles a z slice (<= 65535)
    gz: int  # z slices: past the last row tile a CTA returns
    vec: int  # 1: 16-byte cp.async; 0: predicated byte loads
    k_chunk: int  # k of a chunk
    stages: int  # chunks in flight: min(chunks, I8_DOT_STAGES)
    smem: int  # bytes of dynamic shared memory a CTA
    threads: int  # threads a CTA


def i8_dot_plan(m: int, k: int, n: int, aligned: bool = True) -> I8DotPlan:
    """i8_dot's plan at a (m, k) @ b (k, n), `aligned` where both operands'
    pointers are 16-byte aligned: ceil(n / 32) x ceil(m / 32) tiles on a
    launch.cuh row_grid, the 16-byte path exactly where aligned and k and n
    are multiples of 16.  Raises ValueError for a negative extent."""
    if m < 0 or k < 0 or n < 0:
        raise ValueError(f"i8_dot_plan: bad shape ({m}, {k}) @ ({k}, {n})")
    chunks = -(-k // I8_DOT_CHUNK)
    stages = min(chunks, I8_DOT_STAGES)
    gx = gy = gz = 0
    if m and n:
        rows = -(-m // I8_DOT_TILE)
        gx, gy = -(-n // I8_DOT_TILE), min(rows, 65535)
        gz = -(-rows // gy)
    stage = I8_DOT_TILE * I8_DOT_PITCH + I8_DOT_CHUNK * I8_DOT_TILE
    return I8DotPlan(I8_DOT_TILE, gx * gy * gz, gx, gy, gz,
                     int(aligned and k % 16 == 0 and n % 16 == 0), I8_DOT_CHUNK, stages,
                     stages * stage + I8_DOT_TILE * I8_DOT_PITCH, I8_DOT_THREADS)


def i8_dot_tiles(plan: I8DotPlan, m: int) -> list[tuple[int, int] | None]:
    """The (first row, first column) of c that each CTA of the grid owns, in
    block order (x fastest, then y, then z); None for a CTA past the last
    row tile, which returns at once."""
    rows = -(-m // plan.tile)
    return [(r * plan.tile, x * plan.tile) if (r := y + plan.gy * z) < rows else None
            for z in range(plan.gz) for y in range(plan.gy) for x in range(plan.gx)]


def gmm_floor_sync(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K13's first design (csrc/metrics_kernels.cu: a block a slice and a
    row group, all of G[k1] resident, 4 x 4 register tiles over 32-row tiles
    loaded synchronously): a yardstick off the main path, equal to
    cuda_metrics.gmm_floor."""
    b, n = _check_gmm(xr, xi, "gmm_floor_sync")
    if not xr.is_cuda:
        return gmm_floor_plain(xr, xi)
    xr, xi = _cuda_planes(xr, xi, "gmm_floor_sync")
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    g = gmm_tables(n, xr.device)
    _launch("gmm_floor_sync", _build.library().gdsp_gmm_floor_sync, yr, xr.data_ptr(),
            xi.data_ptr(), yr.data_ptr(), yi.data_ptr(), g.data_ptr(), b, n, gmm_groups(b, n))
    return yr, yi


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


def i8full(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K14g i8full: K13's function (gmm_floor: the twiddled 128-point DFT of
    every slice, over 128) by the exact int8-limb Karatsuba contraction,
    each slice's outputs stored as they come, on one CTA an SM with digit
    warps and product warps overlapped (i8full_plan); equal to
    i8full_plain."""
    _check_i8(xr, xi, "i8full")
    if not xr.is_cuda:
        return i8full_plain(xr, xi)
    return _i8_launch("i8full", _build.library().gdsp_i8full, xr, xi,
                      _i8full_packed(xr.shape[1], xr.device), 0, _i8full_resident(xr.device))


@lru_cache(maxsize=None)
def _i8full_resident(device: torch.device) -> int:
    """CTAs of i8full's kernel the card holds at once (gdsp_i8full_resident:
    SMs x blocks a SM), asked once a device; 0 or a negative CUDA error
    where none fits: the launch then refuses."""
    with torch.cuda.device(device):
        return int(_build.library().gdsp_i8full_resident())


def i8full_sync(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """i8full's first design (csrc/int8_probe_kernels.cu: a block a slice
    and a row group, each 16-row step's digits then its products behind two
    block barriers): a yardstick off the main path, equal to i8full."""
    _check_i8(xr, xi, "i8full_sync")
    if not xr.is_cuda:
        return i8full_plain(xr, xi)
    return _i8_launch("i8full_sync", _build.library().gdsp_i8full_sync, xr, xi,
                      _i8full_packed(xr.shape[1], xr.device))


# i8full's redesign (csrc/int8_probe_kernels.cu: i8full_kernel, make_fu_plan).
I8FULL_DIGIT_WARPS = 4  # warps making a step's nine digit planes
I8FULL_MMA_WARPS = 8  # warps running the products: 16 columns of the slice each
I8FULL_THREADS = 32 * (I8FULL_DIGIT_WARPS + I8FULL_MMA_WARPS)
I8FULL_STAGES = 2  # steps of inputs in the cp.async ring
I8FULL_BUFS = 2  # digit buffers: the digit warps make step i + 1 while step i's products run
I8FULL_LOADS = 8  # 16-byte copies a digit thread a step
I8_TILE = 16  # rows of a step: one m16 tile
_I8_PLANE = LANES * LANES  # bytes of a table plane
_I8_DIGITS = 9 * I8_TILE * LANES  # bytes of a step's nine digit planes
I8FULL_SMEM = (9 * _I8_PLANE + I8FULL_BUFS * _I8_DIGITS
               + I8FULL_STAGES * 32 * I8FULL_DIGIT_WARPS * I8FULL_LOADS * 16
               + I8FULL_BUFS * I8_TILE * 4)


class I8FullPlan(NamedTuple):
    """i8full's launch plan (gdsp_i8full_geometry returns the same fields in
    this order)."""

    ctas: int  # one a SM: min(max(resident, slices), slices x steps)
    threads: int  # digit warps and product warps
    digit_warps: int
    mma_warps: int
    stages: int  # steps of inputs in flight
    smem: int  # bytes of dynamic shared memory a CTA


def i8full_plan(b: int, n: int, resident: int = 132) -> I8FullPlan:
    """i8full's plan at (b, n): a persistent grid of `resident` CTAs (one an
    SM) at most, but one a slice at least, CTA c on slice c % n1 with its
    144 KB of tables resident, the slice's 16-row steps split evenly among
    that slice's CTAs (i8full_walk).  Raises ValueError for a shape the
    kernel refuses."""
    if b < 0 or n < LANES or n % LANES or n // LANES > I8_MAX_N1 or resident < 1:
        raise ValueError(f"i8full_plan: bad shape ({b}, {n}) or resident {resident}")
    items = -(-b // I8_TILE) * (n // LANES)  # every slice needs a CTA: at least n1
    return I8FullPlan(min(max(resident, n // LANES), items), I8FULL_THREADS,
                      I8FULL_DIGIT_WARPS, I8FULL_MMA_WARPS, I8FULL_STAGES, I8FULL_SMEM)


def i8full_walk(plan: I8FullPlan, b: int, n: int) -> list[tuple[int, range]]:
    """(slice, its 16-row steps) of each CTA of the plan, in block order:
    CTA c takes slice k1 = c % n1, and the G CTAs of that slice split its T
    steps as [g T / G, (g + 1) T / G), g = c // n1."""
    n1, steps = n // LANES, -(-b // I8_TILE)
    out = []
    for c in range(plan.ctas):
        k1, g = c % n1, c // n1
        G = (plan.ctas - k1 + n1 - 1) // n1
        out.append((k1, range(g * steps // G, (g + 1) * steps // G)))
    return out


def i8full_digit_map() -> tuple[np.ndarray, np.ndarray]:
    """Where i8full's digit threads read and write a step (csrc/
    int8_probe_kernels.cu: fu_digit_step): (loads, units).  loads[d, j] =
    (row, first column) of the 4 floats that digit thread d's copy j brings
    (plane j // 4: re then im); units[d] = the 16-byte unit of a digit plane
    it writes, the A fragment of lane 4 g + t at k-step ks (mma_s8.cuh:
    rows g, g + 8, columns 32 ks + 4 t .. and 32 ks + 16 + 4 t ..).  Digit
    thread d is lane 8 ks + 4 (g % 2) + t of digit warp g // 2."""
    threads = 32 * I8FULL_DIGIT_WARPS
    loads = np.zeros((threads, I8FULL_LOADS, 2), dtype=np.int64)
    units = np.zeros(threads, dtype=np.int64)
    for d in range(threads):
        w, lane = divmod(d, 32)
        ks, g, t = lane >> 3, 2 * w + ((lane >> 2) & 1), lane & 3
        for j in range(I8FULL_LOADS):
            loads[d, j] = (g + 8 * ((j >> 1) & 1), 32 * ks + 16 * (j & 1) + 4 * t)
        units[d] = ks * 32 + 4 * g + t
    return loads, units


def smem_wavefronts(addresses, width: int) -> int:
    """Shared-memory wavefronts of one warp access: the lanes' byte addresses
    (None: an inactive lane), each reading or writing `width` bytes (4, 8
    or 16).  The warp goes in phases of 128 / width * 4 lanes (32 lanes of
    4 bytes, 16 of 8, 8 of 16); a phase takes as many wavefronts as the
    most distinct 4-byte words any of the 32 banks holds among its lanes'
    words."""
    per = 32 * 4 // width
    total = 0
    for p in range(0, 32, per):
        banks: dict[int, set] = {}
        for a in addresses[p:p + per]:
            if a is None:
                continue
            for word in range(a // 4, (a + width) // 4):
                banks.setdefault(word % 32, set()).add(word)
        total += max((len(v) for v in banks.values()), default=0)
    return total


def i8full_wavefronts(design: str) -> dict[str, int]:
    """Shared-memory wavefronts of one 16-row step of i8full's CTA, by its
    accesses: "A" the product warps' digit fragment loads (a uint4 a lane
    for each of nine planes and four k-steps), "B" their table fragment
    loads (a uint2 for each of nine planes, two n-tiles and four k-steps),
    "digits" the digit planes' stores, "ring" (the redesign) its inputs'
    cp.async writes and reads; design "first" (i8full_sync: a thread a row
    and 8 columns storing four-byte words) or "redesign" (i8full_digit_map:
    a uint4 a plane)."""
    a_unit = smem_wavefronts([16 * lane for lane in range(32)], 16)
    b_unit = smem_wavefronts([8 * lane for lane in range(32)], 8)
    out = {"A": I8FULL_MMA_WARPS * 9 * 4 * a_unit, "B": I8FULL_MMA_WARPS * 9 * 2 * 4 * b_unit}
    if design == "first":
        digits = 0
        for w in range(8):
            for u in range(2):
                addrs = []
                for lane in range(32):
                    tid = 32 * w + lane
                    row, part = tid >> 4, tid & 15
                    c = 8 * part + 4 * u
                    at = ((c >> 5) * 32 + 4 * (row & 7) + ((c >> 2) & 3)) * 4 + (row >> 3) \
                        + 2 * ((c >> 4) & 1)
                    addrs.append(4 * at)
                digits += 9 * smem_wavefronts(addrs, 4)
        out["digits"] = digits
    elif design == "redesign":
        _, units = i8full_digit_map()
        per_warp = [smem_wavefronts([16 * int(u) for u in units[32 * w:32 * w + 32]], 16)
                    for w in range(I8FULL_DIGIT_WARPS)]
        out["digits"] = 9 * sum(per_warp)
        ring = smem_wavefronts([16 * lane for lane in range(32)], 16)
        out["ring"] = 2 * I8FULL_DIGIT_WARPS * I8FULL_LOADS * ring
    else:
        raise ValueError(f"i8full_wavefronts: design {design!r}")
    out["total"] = sum(out.values())
    return out


def i8full_store_map() -> list[tuple[int, int, int, int, list[tuple[int, int]]]]:
    """i8full's 16-byte stores a product warp, lane by lane (csrc/
    int8_probe_kernels.cu: i8full_kernel): (lane, h, row, first column,
    [(lane, column) of each of the four floats]): row g + 8 h of the step
    and four columns of the warp's 16, and where each float was made (the
    C fragment of lane 4 g + t holds columns 8 j + 2 t, + 1 of n-tile j,
    mma_s8.cuh).  Even t keeps its n-tile 0 pair and takes lane t + 1's,
    odd t takes lane t - 1's n-tile 1 pair and keeps its own."""
    out = []
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for h in range(2):
            if t & 1:
                src = [(lane ^ 1, 8 + 2 * (t - 1)), (lane ^ 1, 9 + 2 * (t - 1)),
                       (lane, 8 + 2 * t), (lane, 9 + 2 * t)]
                col = 6 + 2 * t
            else:
                src = [(lane, 2 * t), (lane, 2 * t + 1), (lane ^ 1, 2 * (t + 1)),
                       (lane ^ 1, 2 * (t + 1) + 1)]
                col = 2 * t
            out.append((lane, h, g + 8 * h, col, src))
    return out


def _fragment_index() -> tuple[np.ndarray, np.ndarray]:
    """(rows, columns) of A-fragment unit 32 ks + 4 g + t, register r, byte e
    (mma_s8.cuh: rows g + 8 (r % 2), columns 32 ks + 16 (r / 2) + 4 t + e):
    (128, 4, 1) and (128, 4, 4)."""
    unit = np.arange(128)[:, None, None]
    r, e = np.arange(4)[None, :, None], np.arange(4)[None, None, :]
    ks, g, t = unit >> 5, (unit & 31) >> 2, unit & 3
    return g + 8 * (r & 1), 32 * ks + 16 * (r >> 1) + 4 * t + e


def i8full_steps_model(xr: torch.Tensor, xi: torch.Tensor,
                       resident: int = 132) -> tuple[torch.Tensor, torch.Tensor]:
    """i8full's redesign as its CTAs run it, on the host: i8full_walk's
    steps a CTA; the digit warps' copies (i8full_digit_map) and row max over
    a row's 16 lanes, the scales and digits3's digits packed into digit
    buffer i % 2 in A-fragment order, ahead of the product warps by one step
    (step i + 1's digits are made before step i's products read buffer i %
    2, step i + 2's only after), the row scales beside; the product warps'
    fragments read back from the buffer, the six products of each digit
    triple with the tables' digits exact in int64, the Karatsuba +- and
    recombination in float32, each row stored through i8full_store_map.
    Equal to i8full_plain bit for bit where the maps are right."""
    b, n = _check_i8(xr, xi, "i8full_steps_model")
    n1 = n // LANES
    plan = i8full_plan(b, n, resident)
    loads, units = i8full_digit_map()
    g_of = torch.from_numpy(loads[:, 0, 0])  # a digit thread's row g
    plane_of = torch.arange(I8FULL_LOADS)[None, :, None] >> 2
    ld_r = torch.from_numpy(loads[:, :, 0])[..., None]
    ld_c = torch.from_numpy(loads[:, :, 1])[..., None] + torch.arange(4)
    frag_r, frag_c = _fragment_index()
    t = i8full_tables(n)
    tab = [[np.asarray(t[3 * p][k1], np.int64) for p in range(3)] for k1 in range(n1)]
    # Every product warp's stores: destination row and columns, source columns.
    st_row, st_dst, st_src = [], [], []
    for mw in range(I8FULL_MMA_WARPS):
        for _, _, row, col, src in i8full_store_map():
            st_row.append(row)
            st_dst.append([16 * mw + col + e for e in range(4)])
            st_src.append([16 * mw + c for _, c in src])
    st_row, st_dst, st_src = (torch.tensor(v) for v in (st_row, st_dst, st_src))
    yr, yi = torch.zeros(b, n, dtype=torch.float32), torch.zeros(b, n, dtype=torch.float32)
    xr_h, xi_h = xr.detach().cpu(), xi.detach().cpu()

    def produce(k1: int, step: int) -> tuple[np.ndarray, torch.Tensor]:
        rows = step * I8_TILE + torch.arange(I8_TILE)
        live = rows < b
        tile = torch.zeros(2, I8_TILE, LANES, dtype=torch.float32)
        for c, x in enumerate((xr_h, xi_h)):
            tile[c, live] = x[rows[live], k1 * LANES:(k1 + 1) * LANES]
        q = tile[plane_of, ld_r, ld_c]  # (threads, 8 copies, 4): each thread's own
        a = q[:, :4].abs() + q[:, 4:].abs()  # copy c = 2 hi + h
        mx = torch.stack([a[:, 0:2].amax(dim=(1, 2)), a[:, 2:4].amax(dim=(1, 2))], dim=1)
        row_max = torch.zeros(I8_TILE, dtype=torch.float32)
        for g in range(8):  # the 16 lanes of rows g and g + 8, by shuffles
            row_max[g], row_max[g + 8] = mx[g_of == g, 0].max(), mx[g_of == g, 1].max()
        ck, s_out = row_quant_scales(row_max)
        rows_c = g_of[:, None] + 8 * (torch.arange(4)[None, :] >> 1)  # (threads, copy)
        ar, ai = q[:, :4], q[:, 4:]
        buf = np.zeros((9, 128, 4, 4), dtype=np.int64)
        reg = [(c >> 1) + 2 * (c & 1) for c in range(4)]  # copy 2 hi + h -> A register hi + 2 h
        for p, v in enumerate((ar, ai, ar + ai)):
            for e, digit in enumerate(digits3(v * ck[rows_c][..., None])):
                buf[3 * p + e][units[:, None], reg] = digit.numpy()
        return buf, s_out * (1.0 / LANES)

    def consume(k1: int, step: int, buf: np.ndarray, s_row: torch.Tensor) -> None:
        dg = np.zeros((9, I8_TILE, LANES), dtype=np.int64)
        dg[:, frag_r, frag_c] = buf
        q = []
        for p in range(3):
            d0, d1, d2 = dg[3 * p], dg[3 * p + 1], dg[3 * p + 2]
            t0, t1, t2 = (tab[k1][p][:, LANES * j:LANES * (j + 1)] for j in range(3))
            q.append([torch.from_numpy(v) for v in
                      (d0 @ t0, d0 @ t1 + d1 @ t0, d0 @ t2 + d1 @ t1 + d2 @ t0)])
        qr, qi, qs = q
        re = _recombine([a - c for a, c in zip(qr, qi)], s_row[:, None])
        im = _recombine([2 * s - a - c for s, a, c in zip(qs, qr, qi)], s_row[:, None])
        r = step * I8_TILE + st_row
        keep = r < b
        at = k1 * LANES + st_dst[keep]
        yr[r[keep][:, None], at] = re[st_row[keep][:, None], st_src[keep]]
        yi[r[keep][:, None], at] = im[st_row[keep][:, None], st_src[keep]]

    for k1, steps in i8full_walk(plan, b, n):
        bufs: dict[int, tuple] = {}
        steps = list(steps)
        for i in range(len(steps) + 1):
            if i < len(steps):  # the digit warps: step i into buffer i % 2 ...
                if i % I8FULL_BUFS in bufs:
                    raise AssertionError("a digit buffer overwritten before its products read it")
                bufs[i % I8FULL_BUFS] = (i, *produce(k1, steps[i]))
            if i >= 1:  # ... while the product warps run step i - 1 from buffer (i - 1) % 2
                j, buf, s_row = bufs.pop((i - 1) % I8FULL_BUFS)
                if j != i - 1:
                    raise AssertionError(f"product step {i - 1} found step {j}'s digits")
                consume(k1, steps[j], buf, s_row)
    return yr.to(xr.device), yi.to(xr.device)


def i8_concat(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K14c i8_concat: i8full's arithmetic with a 16-row tile's outputs of
    every slice stored as whole rows, on thread-block clusters of n1 CTAs
    (lane_cluster_plan "i8_concat": a slice's int8 tables resident a CTA,
    each row's slices pushed to the CTA that stores it over distributed
    shared memory); equal to i8full."""
    _check_i8(xr, xi, "i8_concat")
    if not xr.is_cuda:
        return i8full_plain(xr, xi)
    n = xr.shape[1]
    return _i8_launch("i8_concat", _build.library().gdsp_i8full, xr, xi,
                      _i8full_packed(n, xr.device), 1,
                      _cluster_resident("i8_concat", n, xr.device))


def i8_concat_stream(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """i8_concat's first design (csrc/int8_probe_kernels.cu: a block a
    16-row tile walking its slices, each product's three table planes
    staged in turn): a yardstick off the main path, equal to i8_concat."""
    _check_i8(xr, xi, "i8_concat_stream")
    if not xr.is_cuda:
        return i8full_plain(xr, xi)
    return _i8_launch("i8_concat_stream", _build.library().gdsp_i8_concat_stream, xr, xi,
                      _i8full_packed(xr.shape[1], xr.device))
