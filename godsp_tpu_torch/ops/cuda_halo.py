"""Ring-halo kernel for Hopper, with its plain version.

Counterpart of godsp_tpu/parallel/halo.py.

  K10 ring_halo(blocks, halo)   replaces halo.py: ring_halo_pallas (_halo_kernel)

For the n_sp shard blocks of one mesh row, in shard order, each (..., L):
out[i] = blocks[(i+1) % n_sp][..., :halo], the head of the RIGHT
neighbour's block (the ppermute contract [(i, (i-1) % n)]).  One launch
serves every destination shard on one device (csrc/halo_kernel.cu, whose
header says what bounds it).  When the shards share a device the result
is one (n_sp, ..., halo) tensor and out[i] are its slices.

The kernel is microseconds at the mesh paths' shapes, so a call costs
what the wrapper does on the host.  ring_plan picks one of two routes:

- "view": every block a view of one tensor with blocks[0]'s shape and
  strides, their starts one spacing apart, as coll.shard_time gives a
  mesh's blocks on one card.  The kernel takes blocks[0]'s pointer, the
  spacing and the row stride and finds each source itself: the wrapper
  reads one row layout and each block's pointer, shape and strides, and
  builds no table.
- "table": any other ring (separate tensors, ragged spacing, mixed row
  strides, blocks on distinct cards): the blocks' pointers and row
  strides travel in a table in the kernel's parameters, one launch per
  run of consecutive shards on one device.  ring_halo_table always takes
  this route, with a launch count of its own: the first design, kept as
  the yardstick of the view route.

Shards on distinct cards: the kernel on device i reads device i+1's
block over peer access, switched on through gdsp_enable_peer once
torch.cuda.can_device_access_peer says the pair can; otherwise the
wrapper raises ValueError, and ("ppermute", ...) is the route that serves
such a mesh.  Nothing is staged on the host.  This branch needs two
cards and has not run on a machine with one.  peer_read runs only for a
source on another card, and a launch enters torch.cuda.device only where
its device is not the current one.

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from contextlib import nullcontext
from typing import NamedTuple, Sequence

import torch

from godsp_tpu_torch.ops import _build

__all__ = ["RingPlan", "launches", "peer_read", "ring_halo", "ring_halo_plain", "ring_halo_table",
           "ring_plan", "row_layout"]

# Kernel launches by wrapper, counted where each launches its kernel.
launches = {"ring_halo": 0, "ring_halo_table": 0}

_MAX_SHARDS = 64  # csrc/halo_kernel.cu kMaxShards: the table's entries
_peers: set[tuple[int, int]] = set()


class RingPlan(NamedTuple):
    """How K10 launches for one ring (ring_plan): the route and its integers."""

    route: str  # "view" or "table"
    rows: int  # rows of every block (its leading axes collapsed)
    vec: int  # 1: every row start 16-byte aligned and halo % 4 == 0
    stride: int = 0  # view: the blocks' one row stride, in floats
    spacing: int = 0  # view: floats from one block's start to the next
    strides: tuple[int, ...] = ()  # table: each block's row stride


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


def _table_plan(blocks: Sequence[torch.Tensor], halo: int) -> RingPlan:
    _check(blocks, halo)
    if len(blocks) > _MAX_SHARDS:
        raise ValueError(f"ring_halo: at most {_MAX_SHARDS} shards, got {len(blocks)}")
    layouts = [row_layout(b, "ring_halo") for b in blocks]
    rows = layouts[0][0]
    vec = int(halo % 4 == 0 and all(b.data_ptr() % 16 == 0 and (rows == 1 or s % 4 == 0)
                                    for b, (_, s) in zip(blocks, layouts)))
    return RingPlan("table", rows, vec, strides=tuple(s for _, s in layouts))


def ring_plan(blocks: Sequence[torch.Tensor], halo: int) -> RingPlan:
    """K10's route for the float32 blocks of one ring and a halo > 0.

    "view" where every block is a view of one tensor with blocks[0]'s shape
    and strides and the blocks start one spacing apart (coll.shard_time's
    blocks on one device): the kernel finds block s at blocks[0] + s x
    spacing.  "table" otherwise: each block's pointer and row stride in the
    kernel's table.  Raises what ring_halo raises for blocks it cannot
    take.  Reads pointers, shapes and strides only, so it runs on CPU
    tensors too."""
    if not blocks:
        raise ValueError("ring_halo: no blocks")
    b0 = blocks[0]
    rows, stride = row_layout(b0, "ring_halo")
    root = b0 if b0._base is None else b0._base
    shape, strides, p0 = b0.shape, b0.stride(), b0.data_ptr()
    step = blocks[1].data_ptr() - p0 if len(blocks) > 1 else 0
    view = shape[-1] >= halo and step % 4 == 0
    at = p0
    for b in blocks:
        if b.dtype is not torch.float32:
            raise TypeError("ring_halo: every block must be a float32 CUDA tensor")
        if view:
            base = b._base
            view = ((b if base is None else base) is root and b.data_ptr() == at
                    and b.stride() == strides and b.shape == shape)
            at += step
    if not view:
        return _table_plan(blocks, halo)
    spacing = step // 4
    vec = int(halo % 4 == 0 and p0 % 16 == 0 and spacing % 4 == 0
              and (rows == 1 or stride % 4 == 0))
    return RingPlan("view", rows, vec, stride, spacing)


def _on(dev: torch.device):
    """torch.cuda.device(dev) where dev is not the current device."""
    return nullcontext() if dev.index == torch.cuda.current_device() else torch.cuda.device(dev)


def _launch_view(blocks: Sequence[torch.Tensor], halo: int, plan: RingPlan) -> list[torch.Tensor]:
    b0 = blocks[0]
    dev = b0.device
    res = torch.empty(len(blocks), *b0.shape[:-1], halo, dtype=torch.float32, device=dev)
    if plan.rows > 0:
        with _on(dev):
            rc = _build.library().gdsp_ring_halo_view(
                b0.data_ptr(), plan.spacing, plan.stride, len(blocks), res.data_ptr(), plan.rows,
                halo, plan.vec, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(rc, "ring_halo")
        launches["ring_halo"] += 1
    return list(res.unbind(0))


def _launch_table(blocks: Sequence[torch.Tensor], halo: int, plan: RingPlan,
                  name: str) -> list[torch.Tensor]:
    n = len(blocks)
    for b in blocks:
        if not b.is_cuda:
            raise TypeError(f"{name}: every block must be a float32 CUDA tensor")
    lead = blocks[0].shape[:-1]
    ptrs = (ctypes.c_int64 * n)(*[b.data_ptr() for b in blocks])
    strides = (ctypes.c_int64 * n)(*plan.strides)
    out: list[torch.Tensor] = []
    lib = _build.library()
    first = 0
    while first < n:
        dev = blocks[first].device
        last = first
        while last + 1 < n and blocks[last + 1].device == dev:
            last += 1
        for i in range(first, last + 1):
            src = blocks[(i + 1) % n]
            if src.device != dev:
                peer_read(dev, src, name)
        res = torch.empty(last - first + 1, *lead, halo, dtype=torch.float32, device=dev)
        if plan.rows > 0:
            with _on(dev):
                rc = lib.gdsp_ring_halo(
                    ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(strides, ctypes.c_void_p),
                    n, first, last - first + 1, res.data_ptr(), plan.rows, halo, plan.vec,
                    torch.cuda.current_stream(dev).cuda_stream,
                )
            _build.check(rc, name)
            launches[name] += 1
        out.extend(res.unbind(0))
        first = last + 1
    return out


def ring_halo(blocks: Sequence[torch.Tensor], halo: int) -> list[torch.Tensor]:
    """K10: out[i] = blocks[(i+1) % n][..., :halo], each on blocks[i]'s device.

    blocks: the n shard blocks (..., L_i) of one mesh row, in shard order,
    float32, L_i >= halo.  One launch for the whole ring when the blocks
    share a device (the view route where ring_plan finds one, else the
    table), one per run of consecutive shards on one device otherwise.
    """
    if halo <= 0 or not blocks or not blocks[0].is_cuda:
        _check(blocks, halo)
        if halo <= 0:
            return [b[..., :0] for b in blocks]
        return ring_halo_plain(blocks, halo)
    plan = ring_plan(blocks, halo)
    if plan.route == "view":
        return _launch_view(blocks, halo, plan)
    return _launch_table(blocks, halo, plan, "ring_halo")


def ring_halo_table(blocks: Sequence[torch.Tensor], halo: int) -> list[torch.Tensor]:
    """K10's first design, the yardstick of the view route: ring_halo
    always through the pointer table, counted as ring_halo_table."""
    _check(blocks, halo)
    if halo <= 0:
        return [b[..., :0] for b in blocks]
    if not blocks[0].is_cuda:
        return ring_halo_plain(blocks, halo)
    for b in blocks:
        if b.dtype is not torch.float32:
            raise TypeError("ring_halo_table: every block must be a float32 CUDA tensor")
    return _launch_table(blocks, halo, _table_plan(blocks, halo), "ring_halo_table")
