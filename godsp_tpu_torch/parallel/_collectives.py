"""The collectives shard_map gave godsp_tpu, over per-shard blocks in mesh order.

Plain torch, one controller: a list holds one tensor per shard of a
mesh row, in shard order, each on its shard's device.  Every collective
is a slice or a `.to(device)`: a view or no copy at all when the shards
share a device, one explicit device-to-device copy a block when they do
not.  Nothing is staged on the host.  These stand where XLA's collectives
stood; they are not ports of a Pallas kernel (the ring-halo kernel K10 is
ops/cuda_halo.py).

  shard_time     the trailing axis cut into equal blocks, block i on devices[i]
  ring_left      ppermute [(i, (i-1) % n)]: shard i receives shard i+1's block
  ring_right     ppermute [(i, (i+1) % n)]: shard i receives shard i-1's block
  psum           the sum over shards, in shard order, on one device
  all_to_all     jax.lax.all_to_all(split_axis=a, concat_axis=a)
  psum_scatter   jax.lax.psum_scatter(scatter_dimension=0, tiled=False)
  all_gather     jax.lax.all_gather (a new leading shard axis)
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["all_gather", "all_to_all", "psum", "psum_scatter", "ring_left", "ring_right",
           "shard_time"]


def shard_time(x: torch.Tensor, devices: Sequence[torch.device]) -> list[torch.Tensor]:
    """x (..., L) -> n blocks (..., L/n), block i on devices[i].  A block on
    x's own device is a view with x's row stride."""
    n = len(devices)
    b = x.shape[-1] // n
    return [x[..., i * b : (i + 1) * b].to(devices[i]) for i in range(n)]


def ring_left(blocks: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Shard i receives shard (i+1) % n's block (the analysis halo)."""
    n = len(blocks)
    return [blocks[(i + 1) % n].to(blocks[i].device) for i in range(n)]


def ring_right(blocks: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Shard i receives shard (i-1) % n's block (the synthesis spill)."""
    n = len(blocks)
    return [blocks[(i - 1) % n].to(blocks[i].device) for i in range(n)]


def psum(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """sum_i parts[i] on device, added in shard order: deterministic."""
    acc = parts[0].to(device)
    for p in parts[1:]:
        acc = acc + p.to(device)
    return acc


def all_to_all(blocks: Sequence[torch.Tensor], axis: int) -> list[torch.Tensor]:
    """Shard j receives chunk j (of n along `axis`) of every shard's block,
    concatenated along `axis` in shard order."""
    n = len(blocks)
    chunks = [b.chunk(n, dim=axis) for b in blocks]
    return [torch.cat([chunks[i][j].to(blocks[j].device) for i in range(n)], dim=axis)
            for j in range(n)]


def psum_scatter(parts: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """parts[i] (n, ...) -> shard k receives sum_i parts[i][k], in shard order."""
    n = len(parts)
    return [psum([p[k] for p in parts], parts[k].device) for k in range(n)]


def all_gather(blocks: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """(n, ...) stack of every shard's block on device."""
    return torch.stack([b.to(device) for b in blocks])
