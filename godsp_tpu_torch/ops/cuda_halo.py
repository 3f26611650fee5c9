"""Ring-halo kernel for Hopper, with its plain version.

Counterpart of godsp_tpu/parallel/halo.py.

  K10 ring_halo(blocks, halo)   replaces halo.py: ring_halo_pallas (_halo_kernel)

For the n_sp shard blocks of one mesh row, in shard order, each (..., L):
out[i] = blocks[(i+1) % n_sp][..., :halo], the head of the RIGHT
neighbour's block (the ppermute contract [(i, (i-1) % n)]).  One launch
serves every destination shard on one device (csrc/halo_kernel.cu, whose
header says what bounds it); the kernel reads the source blocks through
a table of their pointers and row strides, so blocks may be views of one
signal with its full row stride.  When the shards share a device the
result is one (n_sp, ..., halo) tensor and out[i] are its slices.

Shards on distinct cards: the kernel on device i reads device i+1's
block over peer access, switched on through gdsp_enable_peer once
torch.cuda.can_device_access_peer says the pair can; otherwise the
wrapper raises ValueError, and ("ppermute", ...) is the route that serves
such a mesh.  Nothing is staged on the host.  This branch needs two
cards and has not run on a machine with one.

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from godsp_tpu_torch.ops import _build

__all__ = ["launches", "peer_read", "ring_halo", "ring_halo_plain", "row_layout"]

# Kernel launches by wrapper, counted where each launches its kernel.
launches = {"ring_halo": 0}

_MAX_SHARDS = 64  # csrc/halo_kernel.cu kMaxShards
_peers: set[tuple[int, int]] = set()


def row_layout(t: torch.Tensor, name: str) -> tuple[int, int]:
    """(rows, row stride in elements) of t (..., L) read as rows of its last
    axis: the last axis unit-strided, the leading axes one uniform stride
    (a view of a contiguous signal qualifies).  Raises otherwise."""
    if t.dim() == 0:
        raise ValueError(f"{name}: expected (..., L), got a scalar")
    L = t.shape[-1]
    if L > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: the last axis must be unit-strided")
    lead = [(n, s) for n, s in zip(t.shape[:-1], t.stride()[:-1]) if n != 1]
    if not lead:
        return 1, L
    for (_, s0), (n1, s1) in zip(lead, lead[1:]):
        if s0 != s1 * n1:
            raise ValueError(f"{name}: leading axes must collapse to one row stride")
    rows = 1
    for n, _ in lead:
        rows *= n
    return rows, lead[-1][1]


def enable_peer(device: torch.device, peer: torch.device, route: str) -> None:
    """Let kernels on `device` read `peer`'s memory, or raise ValueError."""
    if device == peer:
        return
    key = (device.index, peer.index)
    if key in _peers:
        return
    if not torch.cuda.can_device_access_peer(device.index, peer.index):
        raise ValueError(
            f"{route}: {device} cannot read {peer} (no peer access); the "
            "('ppermute', ...) halo route serves a mesh of such cards"
        )
    _build.check(_build.library().gdsp_enable_peer(device.index, peer.index), "enable_peer")
    _peers.add(key)


def peer_read(device: torch.device, src: torch.Tensor, route: str) -> None:
    """Make src readable by a kernel on `device`: peer access on, the
    reading stream ordered after src's stream, src's memory held for it."""
    if src.device == device:
        return
    enable_peer(device, src.device, route)
    stream = torch.cuda.current_stream(device)
    stream.wait_stream(torch.cuda.current_stream(src.device))
    src.record_stream(stream)


def ring_halo_plain(blocks: Sequence[torch.Tensor], halo: int) -> list[torch.Tensor]:
    """Plain torch version of K10: each shard takes its right neighbour's head."""
    n = len(blocks)
    return [blocks[(i + 1) % n][..., :halo].to(blocks[i].device) for i in range(n)]


def _check(blocks: Sequence[torch.Tensor], halo: int) -> None:
    if not blocks:
        raise ValueError("ring_halo: no blocks")
    lead = blocks[0].shape[:-1]
    for b in blocks:
        if b.shape[:-1] != lead:
            raise ValueError("ring_halo: blocks must share leading dimensions")
        if b.shape[-1] < halo:
            raise ValueError(f"ring_halo: a block of {b.shape[-1]} samples cannot give a "
                             f"{halo}-sample halo")


def ring_halo(blocks: Sequence[torch.Tensor], halo: int) -> list[torch.Tensor]:
    """K10: out[i] = blocks[(i+1) % n][..., :halo], each on blocks[i]'s device.

    blocks: the n shard blocks (..., L_i) of one mesh row, in shard order,
    float32, L_i >= halo.  One launch per run of consecutive shards on one
    device (one for the whole ring when they share a device).
    """
    n = len(blocks)
    _check(blocks, halo)
    if halo <= 0:
        return [b[..., :0] for b in blocks]
    if not blocks[0].is_cuda:
        return ring_halo_plain(blocks, halo)
    if n > _MAX_SHARDS:
        raise ValueError(f"ring_halo: at most {_MAX_SHARDS} shards, got {n}")
    lead = blocks[0].shape[:-1]
    layouts = []
    for b in blocks:
        if not b.is_cuda or b.dtype != torch.float32:
            raise TypeError("ring_halo: every block must be a float32 CUDA tensor")
        layouts.append(row_layout(b, "ring_halo"))
    rows = layouts[0][0]
    ptrs = (ctypes.c_int64 * n)(*[b.data_ptr() for b in blocks])
    strides = (ctypes.c_int64 * n)(*[s for _, s in layouts])
    vec = int(halo % 4 == 0 and all(b.data_ptr() % 16 == 0 and (rows == 1 or s % 4 == 0)
                                    for b, (_, s) in zip(blocks, layouts)))
    out: list[torch.Tensor] = []
    lib = _build.library()
    first = 0
    while first < n:
        dev = blocks[first].device
        last = first
        while last + 1 < n and blocks[last + 1].device == dev:
            last += 1
        n_dst = last - first + 1
        for i in range(first, last + 1):
            peer_read(dev, blocks[(i + 1) % n], "ring_halo")
        res = torch.empty(n_dst, *lead, halo, dtype=torch.float32, device=dev)
        if rows > 0:
            with torch.cuda.device(dev):
                rc = lib.gdsp_ring_halo(
                    ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(strides, ctypes.c_void_p),
                    n, first, n_dst, res.data_ptr(), rows, halo, vec,
                    torch.cuda.current_stream(dev).cuda_stream,
                )
            _build.check(rc, "ring_halo")
            launches["ring_halo"] += 1
        out.extend(res.unbind(0))
        first = last + 1
    return out
