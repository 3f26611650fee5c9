"""Sequence-parallel spectrogram and ISTFT: the time axis sharded over "sp".

Port of godsp_tpu/parallel/stft_sharded.py.  For giant signals each
shard computes its own frames with the left-neighbour halo exchange, so
frames that straddle a shard boundary are exact (spectrogram_sharded);
the synthesis twin overlap-adds each shard's frames and sends the
(nfft - hop)-sample spill past its block to the RIGHT neighbour
(istft_sharded).

Geometry matches models.stft / models.istft exactly (n_frames =
(L - nfft)//hop + 1 globally; the tail remainder is dropped globally, not
per shard).  Per shard on CUDA float32: K5 power (ops/cuda_stft.py) on the
block plus its halo, K6 (ops/cuda_istft.py) for the overlap-add; the
plain routes elsewhere.  godsp_tpu leaves the output sharded over the
mesh; the port returns one tensor on the mesh's first device, which each
shard's result is written into directly when every shard shares that
device, and gathered onto from distinct cards.
"""

from __future__ import annotations

from typing import Optional

import torch

from godsp_tpu_torch._dtypes import as_complex_array, as_real_array
from godsp_tpu_torch.fft.core import fft_real
from godsp_tpu_torch.models._stft_impl import (
    WindowSpec,
    _fused_window,
    _istft_fused_eligible,
    _ola_unnorm,
    _resolve_window,
    _settle_ola_block,
)
from godsp_tpu_torch.ops import cuda_stft
from godsp_tpu_torch.parallel import _collectives as coll
from godsp_tpu_torch.parallel.mesh import Mesh
from godsp_tpu_torch.spectral._pwelch_impl import fused_path_eligible

__all__ = ["istft_sharded", "spectrogram_sharded"]


def _on_mesh(x, mesh: Mesh, as_array):
    """Host data to the mesh's first device; tensors stay where they are."""
    return as_array(x, None if isinstance(x, torch.Tensor) else mesh.first)


def _shard_power(ext, w_pad, nfft: int, hop: int, pad: int, frames: int, into):
    """|X|^2 of `frames` frames of ext (..., B + H) into `into` (..., frames, lp)."""
    if fused_path_eligible(ext, nfft, pad, hop):
        if into.is_contiguous():
            return cuda_stft.stft_power(ext, w_pad, nfft, hop, frames, pad=pad, into=into)
        return into.copy_(cuda_stft.stft_power(ext, w_pad, nfft, hop, frames, pad=pad))
    idx = torch.arange(frames, device=ext.device)[:, None] * hop + torch.arange(
        nfft, device=ext.device)
    fr = torch.nn.functional.pad(ext[..., idx] * w_pad[:nfft], (0, pad - nfft))
    spec = fft_real(fr)[..., : pad // 2 + 1]
    return into.copy_(spec.real * spec.real + spec.imag * spec.imag)


def spectrogram_sharded(
    x,
    mesh: Mesh,
    nfft: int,
    hop: Optional[int] = None,
    window: WindowSpec = None,
    pad: Optional[int] = None,
) -> torch.Tensor:
    """Power spectrogram of a long signal, frames computed per "sp" shard.

    Returns (..., total_frames, pad//2 + 1) on the mesh's first device,
    equal to models.spectrogram(x, ...).  L must divide by n_sp * hop;
    each shard's block must hold the (nfft - hop) halo.  Leading axes are
    carried along on every shard (godsp_tpu replicates them over "dp"):
    the first dp row computes.
    """
    x = _on_mesh(x, mesh, as_real_array)
    hop = nfft // 2 if hop is None else hop
    if hop <= 0:
        raise ValueError("hop must be positive")
    pad = pad or nfft
    n_sp = mesh.shape["sp"]
    L = x.shape[-1]
    if L % (n_sp * hop) != 0:
        raise ValueError(f"L={L} must divide by n_sp*hop={n_sp * hop}")
    fps = L // (n_sp * hop)
    H = max(nfft - hop, 0)
    if H > fps * hop:
        raise ValueError("per-shard block must hold the nfft-hop halo; use fewer shards")
    total = (L - nfft) // hop + 1

    devices = mesh.devices[0]
    w_pad = _fused_window(_resolve_window(window, nfft, x.dtype, x.device), pad)
    blocks = coll.shard_time(x, devices)
    halos = coll.ring_left([b[..., :H] for b in blocks])
    out = torch.empty(*x.shape[:-1], total, pad // 2 + 1, dtype=x.dtype, device=mesh.first)
    for i, (b, h) in enumerate(zip(blocks, halos)):
        frames = min(max(total - i * fps, 0), fps)  # the global tail is dropped
        if frames == 0:
            continue
        sl = out[..., i * fps : i * fps + frames, :]
        ext = torch.cat([b, h], dim=-1)
        if b.device == mesh.first:
            _shard_power(ext, w_pad.to(b.device), nfft, hop, pad, frames, sl)
        else:
            res = torch.empty(sl.shape, dtype=sl.dtype, device=b.device)
            sl.copy_(_shard_power(ext, w_pad.to(b.device), nfft, hop, pad, frames, res))
    return out


def istft_sharded(
    spec,
    mesh: Mesh,
    nfft: int,
    hop: Optional[int] = None,
    window: WindowSpec = None,
    pad: Optional[int] = None,
    onesided: bool = True,
) -> torch.Tensor:
    """Inverse STFT of spectra whose frame axis is cut over "sp".

    spec: (..., n_frames, bins) complex.  Returns (..., n_frames * hop)
    real on the mesh's first device: models.istft(spec, ...)[...,
    :n_frames*hop]; the final (nfft - hop)-sample coda past n_frames*hop
    stays truncated so every shard owns an equal block, as in godsp_tpu.
    Requires n_frames divisible by n_sp, hop <= nfft, and each shard's
    time block >= the (nfft - hop) spill: (n_frames/n_sp)*hop >= nfft - hop.
    """
    spec = _on_mesh(spec, mesh, as_complex_array)
    hop = nfft // 2 if hop is None else hop
    if hop <= 0:
        raise ValueError("hop must be positive")
    if hop > nfft:
        raise ValueError("istft_sharded requires hop <= nfft")
    bins = spec.shape[-1]
    if onesided:
        pad = pad if pad is not None else 2 * (bins - 1)
        if pad // 2 + 1 != bins:
            raise ValueError(f"pad={pad} inconsistent with {bins} one-sided bins")
    else:
        if pad is not None and pad != bins:
            raise ValueError(f"pad={pad} != two-sided bin count {bins}")
        pad = bins
    n_sp = mesh.shape["sp"]
    n_frames = spec.shape[-2]
    if n_frames == 0 or n_frames % n_sp != 0:
        raise ValueError(f"n_frames={n_frames} must be a positive multiple of n_sp={n_sp}")
    fps = n_frames // n_sp
    if nfft - hop > fps * hop:
        raise ValueError("per-shard time block must hold the nfft-hop spill; use fewer shards")

    devices = mesh.devices[0]
    own_len = fps * hop
    w = _resolve_window(window, nfft, spec.real.dtype, spec.device)
    parts = [spec[..., i * fps : (i + 1) * fps, :].to(d) for i, d in enumerate(devices)]
    ys = []
    for p in parts:
        wd = w.to(p.device)
        ys.append(_ola_unnorm(p, wd, nfft, hop, pad, onesided,
                              _istft_fused_eligible(p, nfft, pad, hop)))
    recv = coll.ring_right([y[..., own_len:] for y in ys])
    out = torch.empty(*spec.shape[:-2], n_frames * hop, dtype=w.dtype, device=mesh.first)
    for i, (y, r) in enumerate(zip(ys, recv)):
        # Shard 0's head has no predecessor frames: its (ring-wrapped)
        # spill and norm tail are dropped, as in the one-device istft.
        sl = out[..., i * own_len : (i + 1) * own_len]
        wd = w.to(y.device)
        if y.device == mesh.first:
            _settle_ola_block(y[..., :own_len], r, i == 0, wd, nfft, hop, fps, out=sl)
        else:
            sl.copy_(_settle_ola_block(y[..., :own_len], r, i == 0, wd, nfft, hop, fps))
    return out
