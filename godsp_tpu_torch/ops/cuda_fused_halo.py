"""Welch partial sums with the cross-shard halo read inside the kernel.

Counterpart of godsp_tpu/parallel/fused_halo.py.

  K11 pwelch_power_partials_halo(x, halo_src, mask, w, nfft, stride, pad)
      replaces fused_halo.py: pwelch_power_partials_rdma (_kernel, _rdma)

K4 (ops/cuda_pwelch.py) over one shard's block x (..., L) whose frames
run past the block's end into halo_src (..., H'): segment s reads sample
j = s*stride + i from x[..., j] for j < L and from halo_src[..., j - L]
beyond (zeros past H').  halo_src is the right neighbour's block itself,
or the injected tail (the next chunk's head) on the last shard; the
caller picks it, as the TPU kernel's SMEM `islast` flag did.  On the TPU
the neighbour's head travelled by remote DMA, overlapped with the
interior tiles; on Hopper the kernel reads it in place
(csrc/pwelch_kernel.cu, gdsp_pwelch_partials_halo: K4's register-radix
body, the source of each sample of a pair chosen apart, since a pair may
straddle the block's end at an odd hop), so no block + halo
concatenation is written to device memory.  x and halo_src may be views
with the whole signal's row stride.  cuda_pwelch.pwelch_regs_model with
halo given is its float64 model.

The same mask semantics, tiles (segs_per_tile) and natural bin order as
K4: (..., n_tiles, pad//2 + 1) per-tile sums, summed over tiles in
torch by the caller.  mask is (S,) for every row, or (..., S).  Any pad =
2^k <= 16384 with pad >= nfft and stride > 0.

halo_src on another card is read over peer access (ops/cuda_halo.py:
peer_read), or the wrapper raises ValueError naming ("ppermute", ...);
that branch needs two cards and has not run on a machine with one.

A wrapper takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import torch

from godsp_tpu_torch.ops import _build
from godsp_tpu_torch.ops.cuda_fft import rfft_table
from godsp_tpu_torch.ops.cuda_halo import peer_read, row_layout
from godsp_tpu_torch.ops.cuda_pwelch import (
    fused_supported,
    pwelch_power_partials_plain,
    segs_per_tile,
)

__all__ = ["launches", "pwelch_power_partials_halo", "pwelch_power_partials_halo_plain"]

# Kernel launches by wrapper, counted where each launches its kernel.
launches = {"pwelch_power_partials_halo": 0}


def pwelch_power_partials_halo_plain(x: torch.Tensor, halo_src: torch.Tensor, mask: torch.Tensor,
                                     w: torch.Tensor, nfft: int, stride: int, pad: int,
                                     bt: int) -> torch.Tensor:
    """Plain torch version of K11: the block and the head of halo_src
    concatenated, then K4's plain version."""
    S = mask.shape[-1]
    need = max((S - 1) * stride + nfft - x.shape[-1], 0)
    ext = torch.cat([x, halo_src[..., :need].to(x.device)], dim=-1)
    return pwelch_power_partials_plain(ext, mask.expand(*x.shape[:-1], S), w, nfft, stride, pad,
                                       bt)


def pwelch_power_partials_halo(x: torch.Tensor, halo_src: torch.Tensor, mask: torch.Tensor,
                               w: torch.Tensor, nfft: int, stride: int,
                               pad: int | None = None) -> torch.Tensor:
    """K11: masked per-tile periodogram sums of one shard, natural bin order.

    x:        (..., L) this shard's block.
    halo_src: (..., H') samples that follow the block: the right
              neighbour's block, or the tail on the last shard.
    mask:     (S,) or (..., S) validity of the shard's segments.
    w:        (pad,) window taper; pad (default nfft) a power of 2 <= 16384.

    Returns (..., n_tiles, pad//2 + 1), segs_per_tile(S, rows) segments a tile.
    """
    pad = pad or nfft
    if not fused_supported(nfft, pad, stride):
        raise ValueError(
            f"geometry (nfft={nfft}, pad={pad}, stride={stride}) unsupported by the fused kernel"
        )
    lead = x.shape[:-1]
    if halo_src.shape[:-1] != lead:
        raise ValueError("x and halo_src must share leading dimensions")
    if mask.dim() != 1 and mask.shape[:-1] != lead:
        raise ValueError("mask must be (S,) or share x's leading dimensions")
    if w.shape != (pad,):
        raise ValueError(f"window must have shape ({pad},), got {tuple(w.shape)}")
    S = mask.shape[-1]
    rows = 1
    for d in lead:
        rows *= d
    bt = segs_per_tile(S, rows)
    lp = pad // 2 + 1
    n_tiles = -(-S // bt)
    if not x.is_cuda:
        return pwelch_power_partials_halo_plain(x, halo_src, mask, w, nfft, stride, pad, bt)
    for name, t in (("x", x), ("mask", mask), ("w", w)):
        if t.dtype != torch.float32 or t.device != x.device:
            raise TypeError(f"pwelch_power_partials_halo: {name} must be float32 on {x.device}")
    if not halo_src.is_cuda or halo_src.dtype != torch.float32:
        raise TypeError("pwelch_power_partials_halo: halo_src must be a float32 CUDA tensor")
    out = torch.empty(*lead, n_tiles, lp, dtype=torch.float32, device=x.device)
    if S == 0 or rows == 0:
        return out
    _, xs = row_layout(x, "pwelch_power_partials_halo")
    _, hs = row_layout(halo_src, "pwelch_power_partials_halo")
    if mask.dim() == 1:
        mask, ms = mask.contiguous(), 0
    else:
        mask, ms = mask.reshape(rows, S).contiguous(), S
    peer_read(x.device, halo_src, "pwelch_power_partials_halo")
    w = w.contiguous()
    if w.data_ptr() % 8:  # the kernel reads the window as float2 pairs
        w = w.clone()
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.gdsp_pwelch_partials_halo(
            x.data_ptr(), xs, x.shape[-1], halo_src.data_ptr(), hs, halo_src.shape[-1],
            mask.data_ptr(), ms, w.data_ptr(), out.data_ptr(),
            rfft_table(pad, x.device).data_ptr(),
            rows, S, nfft, stride, pad.bit_length() - 1, bt, n_tiles,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(rc, "pwelch_power_partials_halo")
    launches["pwelch_power_partials_halo"] += 1
    return out
