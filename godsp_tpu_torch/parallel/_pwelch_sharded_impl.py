"""Distributed Welch PSD: the time axis sharded over a mesh's "sp" axis.

Port of godsp_tpu/parallel/_pwelch_sharded_impl.py:

  * the signal's time axis is cut into n_sp equal shard blocks (views of
    the signal when it lies on the shards' device);
  * segments that straddle a shard boundary need the next nfft - stride
    samples of the RIGHT neighbour: the ring halo;
  * each shard reduces its segments to a partial periodogram sum, and a
    psum in shard order over "sp" combines them on the row's first
    device; the sum is associative, so the result equals the one-device
    pwelch up to rounding.

Segment s of the whole signal counts iff s < total_segs
(spectral.go:26-33): candidate segments past the global tail are masked
on the last shard, so its ring-wrapped halo never counts, and the
streaming driver (parallel.streaming) replaces that halo by the head of
the next chunk (`tail`).

Three halo routes, halo_impl[0] as in godsp_tpu:

  "ppermute"  the plain ring shift (parallel/_collectives.py; a view when
              the shards share a device), then per shard K4 on block + halo
              (ops/cuda_pwelch.py) or the batched frames;
  "pallas"    K10 ring_halo (ops/cuda_halo.py), one launch a ring, then K4;
  "fused"     K11 alone (ops/cuda_fused_halo.py): each shard's kernel reads
              its neighbour's head (or the tail) past its block's end.

godsp_tpu's second halo_impl element (interpret mode) is accepted and has
no effect: CPU tensors always take the plain versions.  The fused route
goes where K11 serves the geometry (fused_path_eligible) with a halo to
read; elsewhere it takes the ppermute route, as godsp_tpu does, and the
results are equal either way.  A leading batch axis is split over "dp"
(a 1-D signal runs on the first dp row).  The result lands on the mesh's
first device: written there when every shard shares it, gathered there
from distinct cards.
"""

from __future__ import annotations

from typing import Optional

import torch

from godsp_tpu_torch import window as win
from godsp_tpu_torch._dtypes import as_real_array
from godsp_tpu_torch.dsputils.utils import zero_pad
from godsp_tpu_torch.fft.core import fft_real
from godsp_tpu_torch.ops import cuda_fused_halo, cuda_halo, cuda_pwelch
from godsp_tpu_torch.parallel import _collectives as coll
from godsp_tpu_torch.parallel.mesh import Mesh, make_mesh
from godsp_tpu_torch.spectral._pwelch_impl import (
    PwelchOptions,
    _doubled,
    fused_path_eligible,
)
from godsp_tpu_torch.spectral._segment_impl import num_segments

__all__ = [
    "partial_periodogram",
    "pwelch_sharded",
    "resolve_geometry",
    "sharded_partial_step",
]

HALO_ROUTES = ("ppermute", "pallas", "fused")


def _power_sum(frames, w_pad, mask, pad: int, lp: int):
    """Masked sum over segments of |FFT(w * frame)|^2, bins 0..lp-1."""
    spec = fft_real(zero_pad(frames, pad) * w_pad)[..., :lp]
    p = spec.real * spec.real + spec.imag * spec.imag
    return torch.sum(p * mask[..., None], dim=-2)


def partial_periodogram(frames, w_pad, mask, pad: int, lp: int):
    """(masked periodogram sum over segments, masked count).

    frames: (..., nsegs, nfft) real; mask: (..., nsegs) 0/1 validity.
    One-sided interior-bin doubling and |FFT|^2 as in pwelch.go:111-121;
    normalization happens after the reduction.
    """
    return _doubled(_power_sum(frames, w_pad, mask, pad, lp)), torch.sum(mask, dim=-1)


def _frames_from_block(block, halo, nfft: int, stride: int, segs: int):
    """Frame a (..., B) block extended by its (..., H) right halo."""
    ext = torch.cat([block, halo], dim=-1)
    dev = ext.device
    idx = torch.arange(segs, device=dev)[:, None] * stride + torch.arange(nfft, device=dev)[None, :]
    return ext[..., idx]


def _shard_sum(block, halo, w_pad, mask, nfft: int, pad: int, stride: int, lp: int):
    """One shard's undoubled power sum (..., lp) over block + halo: K4 on
    the concatenation, or the batched frames."""
    mask = mask.expand(*block.shape[:-1], mask.shape[-1])
    if fused_path_eligible(block, nfft, pad, stride):
        ext = torch.cat([block, halo], dim=-1)
        partials = cuda_pwelch.pwelch_power_partials(ext, mask, w_pad, nfft, stride, pad=pad)
        return partials.sum(dim=-2)[..., :lp]
    frames = _frames_from_block(block, halo, nfft, stride, mask.shape[-1])
    return _power_sum(frames, w_pad, mask, pad, lp)


def _row_step(x, tail, w_pad, devices, nfft: int, pad: int, stride: int, S: int, lp: int,
              total_segs: int, route: str):
    """One dp row: (undoubled power sum, count) on devices[0]."""
    H = max(nfft - stride, 0)
    blocks = coll.shard_time(x, devices)
    tail = tail.to(devices[-1])
    ws = {d: w_pad.to(d) for d in set(devices)}
    masks = [((i * S + torch.arange(S, device=d)) < total_segs).to(x.dtype)
             for i, d in enumerate(devices)]
    if route == "fused" and H > 0 and fused_path_eligible(blocks[0], nfft, pad, stride):
        sources = blocks[1:] + [tail]
        parts = [cuda_fused_halo.pwelch_power_partials_halo(
                     b, h, m, ws[b.device], nfft, stride, pad=pad).sum(dim=-2)[..., :lp]
                 for b, h, m in zip(blocks, sources, masks)]
    else:
        if H == 0:
            halos = [b[..., :0] for b in blocks]
        elif route == "pallas":
            halos = cuda_halo.ring_halo(blocks, H)
        else:
            halos = coll.ring_left([b[..., :H] for b in blocks])
        halos[-1] = tail  # the ring wraps to shard 0: the stream's next samples instead
        parts = [_shard_sum(b, h, ws[b.device], m, nfft, pad, stride, lp)
                 for b, h, m in zip(blocks, halos, masks)]
    count = coll.psum([m.sum() for m in masks], devices[0])
    return coll.psum(parts, devices[0]), count.expand(x.shape[:-1])


def sharded_partial_step(
    x,
    tail_halo,
    w_pad,
    mesh: Mesh,
    nfft: int,
    pad: int,
    stride: int,
    segs_per_shard: int,
    lp: int,
    total_segs: int,
    halo_impl: tuple = ("ppermute", False),
):
    """One sharded accumulation step.

    x: (..., L) with L = n_sp * segs_per_shard * stride; its time axis is
    cut over "sp", and a leading batch axis over "dp" when the mesh has
    more than one dp row.  tail_halo: (..., H) samples that follow x in
    the stream (zeros in one-shot use: the global-tail mask makes them
    irrelevant).  pad is the FFT/window length max(options.pad, nfft); lp
    may be smaller than pad//2 + 1 when options.pad < nfft.  total_segs
    is a plain argument per call: the streaming driver's remainder chunk
    changes it.  Returns (periodogram_sum (..., lp), segment_count (...))
    on the mesh's first device, summed over "sp" in shard order.
    """
    route = halo_impl[0]
    if route not in HALO_ROUTES:
        raise ValueError(f"unknown halo_impl {halo_impl!r}: one of {HALO_ROUTES}")
    n_sp, n_dp = mesh.shape["sp"], mesh.shape["dp"]
    if x.shape[-1] != n_sp * segs_per_shard * stride:
        raise ValueError(f"x has {x.shape[-1]} samples, want n_sp*segs_per_shard*stride = "
                         f"{n_sp * segs_per_shard * stride}")
    rows = [(x, tail_halo)]
    if x.dim() > 1 and n_dp > 1:
        B = x.shape[0]
        if B % n_dp:
            raise ValueError(f"batch axis ({B}) must divide over the dp axis ({n_dp})")
        b = B // n_dp
        rows = [(x[d * b : (d + 1) * b], tail_halo[d * b : (d + 1) * b]) for d in range(n_dp)]
    outs = [_row_step(xd, td, w_pad, mesh.devices[d], nfft, pad, stride, segs_per_shard, lp,
                      total_segs, route)
            for d, (xd, td) in enumerate(rows)]
    p = torch.cat([o[0].to(mesh.first) for o in outs]) if len(outs) > 1 else outs[0][0]
    count = torch.cat([o[1].to(mesh.first) for o in outs]) if len(outs) > 1 else outs[0][1]
    return _doubled(p), count


def resolve_geometry(options: Optional[PwelchOptions]):
    """(nfft, window_fn, pad, fft_len, noverlap, scaling, stride, lp).

    fft_len = max(pad, nfft): the reference's ZeroPadF(seg, pad) is a
    no-op when pad < nfft (dsputils.go:60-63), so the transform then runs
    at nfft and only the first lp = pad//2 + 1 bins are kept.
    """
    o = options or PwelchOptions()
    nfft, wf, pad, noverlap, enable_scaling = o.resolved()
    stride = nfft - noverlap
    if stride <= 0:
        raise ValueError("noverlap must be < nfft")
    return (nfft, wf, pad, max(pad, nfft), noverlap, enable_scaling, stride,
            pad // 2 + 1)


def pwelch_sharded(
    x,
    fs: float,
    options: Optional[PwelchOptions] = None,
    mesh: Optional[Mesh] = None,
    halo_impl: tuple = ("ppermute", False),
) -> tuple[torch.Tensor, torch.Tensor]:
    """Welch PSD of x with the time axis sharded over mesh axis "sp".

    x: (..., L) real; a leading batch axis (if present and mesh.dp > 1)
    is split over "dp".  Host data goes to the mesh's first device.
    Returns (Pxx, freqs) on the mesh's first device, equal (within
    rounding) to spectral.pwelch.

    L must be divisible by n_sp * stride; the streaming driver
    (parallel.streaming) handles arbitrary lengths.
    """
    if mesh is None:
        mesh = make_mesh()
    x = as_real_array(x, None if isinstance(x, torch.Tensor) else mesh.first)
    n_sp = mesh.shape["sp"]

    (nfft, wf, pad, fft_len, noverlap, enable_scaling, stride,
     lp) = resolve_geometry(options)
    if x.shape[-1] < nfft:
        x = zero_pad(x, nfft)  # pwelch.go:97-99
    L = x.shape[-1]
    if L % (n_sp * stride) != 0:
        raise ValueError(
            f"signal length {L} must be divisible by n_sp*stride = {n_sp * stride}; "
            "use parallel.streaming for arbitrary lengths"
        )
    segs_per_shard = L // (n_sp * stride)
    if max(nfft - stride, 0) > segs_per_shard * stride:
        raise ValueError(
            f"per-shard block ({segs_per_shard * stride} samples) must hold the "
            f"{nfft - stride}-sample overlap halo; use fewer sp shards or a longer signal"
        )
    total_segs = num_segments(L, nfft, noverlap)

    fdt, dev = x.dtype, mesh.first
    w_fft = win.window_table(wf, fft_len, device=dev, dtype=fdt)
    w_nfft = win.window_table(wf, nfft, device=dev, dtype=fdt)
    w_norm = torch.sum(w_nfft * w_nfft)
    if enable_scaling:
        w_norm = w_norm * fs

    H = max(nfft - stride, 0)
    tail = x.new_zeros(*x.shape[:-1], H)
    p_sum, count = sharded_partial_step(
        x, tail, w_fft, mesh, nfft, fft_len, stride, segs_per_shard, lp, total_segs,
        halo_impl=halo_impl,
    )
    pxx = p_sum / (count[..., None] * w_norm)
    freqs = torch.arange(lp, dtype=fdt, device=dev) * (fs / pad)
    return pxx, freqs
