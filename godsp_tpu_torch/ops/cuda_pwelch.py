"""Fused Welch-periodogram kernel for Hopper, with its plain version and its model.

Counterpart of godsp_tpu/ops/pallas_pwelch.py.

  K4 pwelch_power_partials(ext, mask, w, nfft, stride, pad)
     replaces pallas_pwelch.py: pwelch_power_partials (_pwelch_kernel)

Each CTA takes one tile of one row's overlapped segments straight from
the raw samples (block + halo) and sums mask[s] * |X_k|^2 over k =
0..pad/2 (csrc/pwelch_kernel.cu, whose header says what bounds it on the
H100).  Output: one partial row per tile, (..., n_tiles, pad//2 + 1) in
natural order.  The tile size is the port's own (segs_per_tile); only
the sum over tiles is contractual, and pwelch_power_sum takes that sum
in torch, as godsp_tpu sums its partials outside the kernel.

The kernel is K5's framing load and K3's packed half-length transform
(csrc/frame_regs.cuh: a segment read as pad/2 complex pairs of windowed
samples, the pad/2-point transform on csrc/fft_regs.cuh's register-radix
passes with cuda_fft.rfft_table(pad), K3's split), the masked power sums
in registers, and a fixed-order sum of the CTA's frames (partials_cta:
the frames a CTA holds; reduce_word: where the sum keeps each warp's
partials).  pwelch_regs_model is its float64 model, for the CPU tests
(no main-path call uses it): the frames as the kernel loads them (K11's
halo source chosen per sample), cuda_fft.rfft_packed_model's passes and
split, and the sums in the kernel's order.  The first design (radix-2
stages in shared memory) stays as cuda_probes.pwelch_radix2.

Mask semantics of pallas_pwelch.py:501-515: ext must cover every masked
segment; unmasked segments and padded rows count 0.  The TPU's geometry
limits (nfft % 128, stride phase classes) were lane rules: here any
pad = 2^k in 2..16384 with pad >= nfft and stride > 0 is covered.

A wrapper takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from godsp_tpu_torch.ops import _build
from godsp_tpu_torch.ops.cuda_fft import (
    cta_shape,
    geometry,
    rfft_packed_model,
    rfft_pow2_plain,
    rfft_table,
    supported_size,
    twiddle_table,
)

__all__ = [
    "fused_supported",
    "launches",
    "partials_cta",
    "partials_model",
    "pwelch_power_partials",
    "pwelch_power_partials_plain",
    "pwelch_power_sum",
    "pwelch_regs_model",
    "reduce_word",
    "segs_per_tile",
]

# Kernel launches by wrapper, counted where each launches its kernel.
launches = {"pwelch_power_partials": 0}

# Tiles to aim for: eight a SM of an H100 (132 SMs), finer than the CTAs
# a SM holds at once so that the last wave is short (the fastest of
# tools/probe_torch_welch_tiles.py's settings for K4 and K7, PERF.md §6).
_TARGET_BLOCKS = 8 * 132
_MAX_SEGS_PER_TILE = 64


def fused_supported(nfft: int, pad: int, stride: int) -> bool:
    """True if the fused kernel covers this Pwelch geometry."""
    return nfft >= 1 and pad >= nfft and stride > 0 and supported_size(pad)


def segs_per_tile(n_segs: int, rows: int) -> int:
    """Segments a CTA sums: eight tiles a SM, at most 64 segments a tile."""
    bt = -(-(n_segs * rows) // _TARGET_BLOCKS)
    return max(1, min(_MAX_SEGS_PER_TILE, bt))


def partials_cta(pad: int, n_segs: int, bt: int, frames: int = 1) -> tuple[int, int, int]:
    """(segments, threads, slots) of a K4 (frames 1) or K7 (frames 2: a
    segment's x and y frames) CTA at pad over tiles of bt of n_segs
    segments (csrc/frame_regs.cuh: frames_per_cta): the segments it holds
    at once are the default eight warps' frames (cuda_fft.geometry's
    default_rows) over `frames`, or whole warps enough for a tile; one
    segment a CTA in the block route (pad >= 4096).  gdsp_pwelch_geometry
    and gdsp_csd_geometry return the kernels' own on the card."""
    g = geometry(pad // 2)
    tile = max(1, min(n_segs, bt))
    fpc = min(-(-tile // g.q) * g.q, g.default_rows // frames) if g.warp else 1
    threads, slots = cta_shape(pad // 2, frames * fpc)
    return fpc, threads, slots


def reduce_word(pad: int, group, k):
    """The 32-bit word of shared memory where a warp-route CTA's sum of its
    slots (frame_regs.cuh: store_partials) keeps group `group`'s partial
    of bin k (K4: a warp, K7: a warp pair; group and k broadcast
    together): a run of pad/2 + 1 words a group.  For the CPU tests' bank
    count."""
    return np.asarray(group) * (pad // 2 + 1) + np.asarray(k)


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


def _spectra_model(x, w, nfft: int, stride: int, S: int, pad: int, halo=None) -> np.ndarray:
    """(rows, S, pad/2 + 1) complex128 one-sided spectra of the frames as
    the kernel loads them (frame_regs.cuh: load_frame): sample e of frame
    s is j = s*stride + e, x[j] for j < L, halo[j - L] for L <= j < L + H
    (chosen per sample), 0 past both or past nfft, times w[e]; then
    cuda_fft.rfft_packed_model's passes and split."""
    from godsp_tpu_torch.ops.cuda_stft import _pair_frames_model

    x = np.asarray(x, np.float64)
    rows = x.reshape(-1, x.shape[-1])
    frames = _pair_frames_model(rows, w, nfft, stride, S, pad).reshape(len(rows), S, pad)
    if halo is not None and np.shape(halo)[-1] > 0:
        h = np.asarray(halo, np.float64).reshape(len(rows), -1)
        L, H = rows.shape[-1], h.shape[-1]
        e = np.arange(pad)
        j = np.arange(S)[:, None] * stride + e - L  # index into h
        take = (e < nfft) & (j >= 0) & (j < H)
        wt = np.where(e < nfft, np.asarray(w, np.float64)[e], 0.0)
        frames = frames + np.where(take, h[:, np.clip(j, 0, max(H - 1, 0))] * wt, 0.0)
    spec = rfft_packed_model(frames)
    return spec[0] + 1j * spec[1]


def partials_model(p: np.ndarray, mask: np.ndarray, pad: int, bt: int,
                   frames: int = 1) -> np.ndarray:
    """The per-tile sums of mask[s] * p[s] (p: (rows, S, bins), any dtype)
    in K4's order (frames 1) or K7's (frames 2): a tile's segment j to
    segment slot j mod fpc at step j // fpc (partials_cta), each summing
    its steps in turn (K7: each bin in the lane of the frame that owns
    it); in the warp route the Q segment slots of a warp by a xor
    butterfly (slot q takes q ^ d, d = 1, 2, .., Q/2), then the groups
    (K4: warps, K7: warp pairs) in order.  Returns (rows, n_tiles, bins)."""
    rows, S, bins = p.shape
    n_tiles = -(-S // bt)
    fpc = partials_cta(pad, S, bt, frames)[0]
    g = geometry(pad // 2)
    slots = -(-fpc // g.q) * g.q if g.warp else 1
    steps = -(-min(S, bt) // fpc)
    tiles = np.zeros((rows, n_tiles, steps * fpc, bins), p.dtype)
    for tile in range(n_tiles):
        n = min(bt, S - tile * bt)
        s0 = tile * bt
        tiles[:, tile, :n] = mask[:, s0:s0 + n, None] * p[:, s0:s0 + n]
    tiles = tiles.reshape(rows, n_tiles, steps, fpc, bins)
    slot_sums = np.zeros((rows, n_tiles, slots, bins), p.dtype)
    for it in range(steps):
        slot_sums[:, :, :fpc] += tiles[:, :, it]
    if not g.warp:
        return slot_sums[:, :, 0]
    d = 1
    q = np.arange(slots)
    while d < g.q:
        slot_sums = slot_sums + slot_sums[:, :, q ^ d]
        d *= 2
    groups = slot_sums[:, :, ::g.q]
    out = groups[:, :, 0]
    for gp in range(1, groups.shape[2]):
        out = out + groups[:, :, gp]
    return out


def pwelch_regs_model(ext, mask, w, nfft: int, stride: int, pad: int | None = None,
                      halo=None) -> np.ndarray:
    """float64 model of K4 (csrc/pwelch_kernel.cu) on numpy arrays, and of
    K11 with halo given (the samples after each row's block, as
    pwelch_power_partials_halo's halo_src): the frames as the kernel
    loads them (frames past the samples read zeros), the pad/2-point
    passes and K3's split (cuda_fft.rfft_packed_model), the masked power
    sums in the kernel's order (partials_model).  mask (..., S), or (S,)
    for every row.  Returns the wrapper's (..., n_tiles, pad//2 + 1) at
    segs_per_tile(S, rows).  For the CPU tests; no main-path call uses
    it."""
    pad = pad or nfft
    ext = np.asarray(ext, np.float64)
    lead = ext.shape[:-1]
    rows = int(np.prod(lead, dtype=np.int64))
    mask = np.broadcast_to(np.asarray(mask, np.float64), (*lead, np.shape(mask)[-1]))
    S = mask.shape[-1]
    bt = segs_per_tile(S, rows)
    X = _spectra_model(ext, w, nfft, stride, S, pad, halo)
    out = partials_model(X.real * X.real + X.imag * X.imag, mask.reshape(rows, S), pad, bt)
    return out.reshape(*lead, *out.shape[1:])


def _launch(ext, mask, w, nfft, stride, pad, name, counts, radix2=False):
    """Run K4 (radix2: its first design, cuda_probes.pwelch_radix2, counted
    in counts[name]) over the rows of ext."""
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
    for label, t in (("ext", ext), ("mask", mask), ("w", w)):
        if t.dtype != torch.float32 or t.device != ext.device:
            raise TypeError(f"{name}: {label} must be float32 on {ext.device}")
    out = torch.empty(*lead, n_tiles, lp, dtype=torch.float32, device=ext.device)
    if S == 0 or rows == 0:
        return out
    L = ext.shape[-1]
    ext2 = ext.reshape(rows, L).contiguous()
    mask2 = mask.reshape(rows, S).contiguous()
    w = w.contiguous()
    if w.data_ptr() % 8:  # the kernel reads the window as float2 pairs
        w = w.clone()
    lib = _build.library()
    entry, table = ((lib.gdsp_pwelch_radix2, twiddle_table(pad, False, ext.device)) if radix2
                    else (lib.gdsp_pwelch_partials, rfft_table(pad, ext.device)))
    with torch.cuda.device(ext.device):
        rc = entry(
            ext2.data_ptr(), mask2.data_ptr(), w.data_ptr(), out.data_ptr(), table.data_ptr(),
            rows, L, S, nfft, stride, pad.bit_length() - 1, bt, n_tiles,
            torch.cuda.current_stream(ext.device).cuda_stream,
        )
    _build.check(rc, name)
    counts[name] += 1
    return out


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
    return _launch(ext, mask, w, nfft, stride, pad, "pwelch_power_partials", launches)


def pwelch_power_sum(x: torch.Tensor, w: torch.Tensor, nfft: int, stride: int,
                     total_segs: int, pad: int | None = None) -> torch.Tensor:
    """One-sided periodogram power sum of a raw signal, natural order.

    Segments s in [0, total_segs) of x (..., L).  Returns (..., pad//2 + 1),
    the sum over segments of |FFT(w * frame)|^2; the caller applies the
    interior doubling and 1/(nsegs * sum(w^2) * fs) (pwelch.go:113-136).
    """
    mask = torch.ones(*x.shape[:-1], total_segs, dtype=x.dtype, device=x.device)
    return pwelch_power_partials(x, mask, w, nfft, stride, pad=pad).sum(dim=-2)
