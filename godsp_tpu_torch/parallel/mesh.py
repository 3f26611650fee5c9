"""Device mesh of the port: a ("dp", "sp") grid of torch devices.

Port of godsp_tpu/parallel/mesh.py.  godsp_tpu's mesh is a
jax.sharding.Mesh over one process's devices, driven by shard_map under
one controller; here the same single controller holds a (dp, sp) grid of
torch.device entries, and the sharded paths (parallel/_pwelch_sharded_impl,
stft_sharded, _fft_sharded_impl) loop over its shards:

  * dp — data parallel over independent signals/channels;
  * sp — sequence parallel over the time axis of one long signal, with
    overlap halos passed between neighbour shards.

A grid may repeat a device: eight shards on cuda:0 are the card's twin of
the eight-device virtual CPU mesh of godsp_tpu's tests, and every ring,
mask and psum then runs on the one card.  A grid of distinct cards reads
a neighbour's memory over peer access (ops/cuda_halo.py); that branch has
not run on a machine with one card.

godsp_tpu's init_distributed (multi-host JAX) has no counterpart yet:
multi-process runs over torch.distributed wait for a machine with more
than one card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from godsp_tpu_torch._dtypes import default_device, resolve_device

__all__ = ["Mesh", "MeshConfig", "canonical_device", "make_mesh"]


@dataclass(frozen=True)
class MeshConfig:
    """Frozen mesh description (no process-global knobs)."""

    dp: int = 1  # data-parallel (channel/batch) axis size
    sp: int = 1  # sequence-parallel (time) axis size

    @property
    def n_devices(self) -> int:
        return self.dp * self.sp


def canonical_device(device) -> torch.device:
    """device with a CUDA index filled in, so cuda and cuda:0 compare equal;
    a CUDA device on a machine without one raises (resolve_device)."""
    d = resolve_device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A ("dp", "sp") grid of torch devices; devices[d][i] holds shard i of
    data-parallel row d.  shape is {"dp": .., "sp": ..}, as jax's Mesh."""

    axis_names = ("dp", "sp")

    def __init__(self, devices: Sequence[Sequence]):
        grid = tuple(tuple(canonical_device(d) for d in row) for row in devices)
        if not grid or not grid[0] or any(len(row) != len(grid[0]) for row in grid):
            raise ValueError("a mesh is a non-empty (dp, sp) grid of devices")
        self.devices = grid
        self.shape = {"dp": len(grid), "sp": len(grid[0])}

    @property
    def first(self) -> torch.device:
        """The device a sharded result lands on."""
        return self.devices[0][0]

    @property
    def one_device(self) -> bool:
        """True when every shard shares one device."""
        return all(d == self.first for row in self.devices for d in row)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and other.devices == self.devices

    def __hash__(self) -> int:
        return hash(self.devices)

    def __repr__(self) -> str:
        return f"Mesh(dp={self.shape['dp']}, sp={self.shape['sp']}, devices={self.devices})"


def make_mesh(
    config: Optional[MeshConfig] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a ("dp", "sp") mesh from the first config.n_devices devices.

    devices may repeat an entry ([cuda:0] * 8, ["cpu"] * 8).  Default:
    every visible CUDA device when default_device() is the card (raises
    without one), else default_device() alone; config defaults to all of
    them on the sp axis.
    """
    if devices is None:
        dev = resolve_device(default_device())
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if dev.type == "cuda" else [dev])
    devices = list(devices)
    if config is None:
        config = MeshConfig(dp=1, sp=len(devices))
    if config.n_devices > len(devices):
        raise ValueError(f"mesh needs {config.n_devices} devices, have {len(devices)}")
    flat = devices[: config.n_devices]
    return Mesh([flat[d * config.sp : (d + 1) * config.sp] for d in range(config.dp)])
