"""The measurement path's reference kernels for Hopper, with their plain versions.

Counterpart of godsp_tpu/utils/metrics.py's two Pallas kernels.

  K12 copy_split(xr, xi)   replaces metrics.py: copy_split_pallas
  K13 gmm_floor(xr, xi)    replaces metrics.py: gmm_floor_pallas

Both take two float32 planes (b, n).  K12 copies them: the same
device-memory traffic as K1 with no compute, so its time is the
session's copy ceiling.  K13 computes, for every row and every 128-point
lane slice k1 of n = n1 x 128,

    y[:, 128 k1 : 128 (k1 + 1)] = FFT_128(x[:, 128 k1 + i2] exp(-2 pi i k1 i2 / n)) / 128,

the twiddled 128-point DFT of each slice (steps 2-3 of a four-step
n1 x 128 FFT) as a dense contraction with G[k1][i2, k2] =
exp(-2 pi i k1 i2 / n) exp(-2 pi i i2 k2 / 128) / 128.  On the TPU it is
K1's contraction stream without its butterflies; on the H100, whose K1 is
register-radix Stockham passes (csrc/fft_regs.cuh), its time says what
the TPU's dense-DFT design of one K1 step costs on this card
(csrc/metrics_kernels.cu, whose header says what bounds each kernel).

K13's kernel keeps one float32 Karatsuba chain (m1, m2, m3 by fmaf over
i2 = 0 .. 127 in order; Re y = m1 - m2, Im y = (m3 - m1) - m2), so it
equals gmm_concat and ls_full's contraction bit for bit.  Its schedule
(gmm_floor_plan): a persistent grid of one CTA an SM, each CTA owning half
a slice's bins at a time with their three G planes resident (96 KB), 8 x 4
register tiles (8 rows x 4 bins a thread) over 128-row tiles whose x
arrives by TMA through a ring of four 32-column stages; CTA c walks the
(slice, half, row tile) items c I / C .. (c + 1) I / C - 1 in slice-major
order (gmm_floor_walk).  Its first design, all of G[k1] resident and 4 x 4
tiles over synchronously loaded 32-row tiles (gmm_groups row groups a
slice), stays as cuda_probes.gmm_floor_sync.

The G tables are built in float64 on the host as godsp_tpu builds them
(ops/pallas_fft.py: _ls_tables: the twiddle times the scaled DFT matrix;
the third plane Re G + Im G for the Karatsuba form), rounded once to
float32, and cached per n on each device.  The plain versions are
`xr.clone(), xi.clone()` and (x.view(b, n1, 128) * T) @ F128 / 128 in the
input's dtype (TF32 off on the card): the float64 oracle.

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

from contextlib import nullcontext
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from godsp_tpu_torch.fft.four_step import _tf32_off, dft_matrix, twiddle_2d
from godsp_tpu_torch.ops import _build

__all__ = [
    "FloorPlan",
    "LANES",
    "copy_split",
    "copy_split_plain",
    "gmm_floor",
    "gmm_floor_plain",
    "gmm_floor_plan",
    "gmm_floor_walk",
    "gmm_groups",
    "gmm_tables",
    "launches",
]

LANES = 128  # points of one slice: the TPU's lane width, G's side
_SMS = 132  # H100 SXM streaming multiprocessors: gmm_groups' blocks an SM

# Kernel launches by wrapper, counted where each launches its kernel.
launches = {"copy_split": 0, "gmm_floor": 0}


def _check(xr: torch.Tensor, xi: torch.Tensor, name: str) -> tuple[int, int]:
    if xr.shape != xi.shape or xr.dim() != 2:
        raise ValueError(f"{name}: two (b, n) planes of one shape, got {tuple(xr.shape)} "
                         f"and {tuple(xi.shape)}")
    return xr.shape[0], xr.shape[1]


def _check_gmm(xr: torch.Tensor, xi: torch.Tensor, name: str = "gmm_floor") -> tuple[int, int]:
    b, n = _check(xr, xi, name)
    if n < LANES or n % LANES:
        raise ValueError(f"{name}: n must be a multiple of {LANES}, got {n}")
    return b, n


def _cuda_planes(xr: torch.Tensor, xi: torch.Tensor, name: str):
    """Contiguous, 16-byte-aligned float32 CUDA planes on one device, or raise."""
    if xr.dtype != torch.float32 or xi.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32 planes, got {xr.dtype}, {xi.dtype}")
    if not xi.is_cuda or xi.device != xr.device:
        raise ValueError(f"{name}: both planes must be on one CUDA device")
    planes = []
    for t in (xr, xi):
        t = t.contiguous()
        planes.append(t if t.data_ptr() % 16 == 0 else t.clone())
    return planes


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _g_host(n: int) -> np.ndarray:
    """(n1, 3, 128, 128) float32: Re G, Im G, Re G + Im G of every slice,
    built in float64 as godsp_tpu's _ls_tables(n, False, False, 1/128) and
    rounded once."""
    g = twiddle_2d(n // LANES, LANES)[:, :, None] * (dft_matrix(LANES) * (1.0 / LANES))[None]
    return np.ascontiguousarray(np.stack([g.real, g.imag, g.real + g.imag], axis=1),
                                dtype=np.float32)


@lru_cache(maxsize=None)
def gmm_tables(n: int, device: torch.device) -> torch.Tensor:
    """K13's G tables for n points on `device` (n * 1.5 KB of float32)."""
    return torch.from_numpy(_g_host(n)).to(device)


@lru_cache(maxsize=None)
def _plain_tables(n: int, device: torch.device, dtype: torch.dtype):
    """(T (n1, 128), F128 (128, 128)) in `dtype` on `device`, float64-built."""
    t = torch.from_numpy(twiddle_2d(n // LANES, LANES)).to(device=device, dtype=dtype)
    return t, torch.from_numpy(dft_matrix(LANES)).to(device=device, dtype=dtype)


def gmm_groups(b: int, n: int) -> int:
    """Row groups a slice is split into by K13's first design
    (cuda_probes.gmm_floor_sync) and gmm_tf32_sync: about two blocks for
    each SM over the whole grid, never more groups than 32-row tiles."""
    return max(1, min(-(-b // 32), -(-2 * _SMS // (n // LANES)), 65535))


# K13's plan (csrc/metrics_kernels.cu: make_floor_plan).
FLOOR_ROWS = 128  # rows of a tile
FLOOR_BINS = 64  # bins a CTA: half a slice
FLOOR_K = 32  # i2 a stage: one 128-byte swizzled TMA box row
FLOOR_STAGES = 4  # the ring of x stages
FLOOR_THREADS = 256  # 8 warps, thread 0 also keeping the ring full
# The ring (xr and xi boxes of 128 rows x 128 bytes a stage), G's three
# half planes, the stages' full and empty mbarriers, 1 KB to align the
# swizzle's atoms.
FLOOR_SMEM = (FLOOR_STAGES * 2 * FLOOR_ROWS * FLOOR_K * 4 + 3 * LANES * FLOOR_BINS * 4
              + 2 * FLOOR_STAGES * 8 + 1024)


class FloorPlan(NamedTuple):
    """K13's launch plan (gdsp_gmm_floor_geometry returns the same fields in
    this order)."""

    ctas: int  # CTAs of the persistent grid: min(resident, items)
    rows_tile: int  # rows of a tile
    bins_cta: int  # bins a CTA: half a slice
    stages: int  # the ring of x stages
    smem: int  # bytes of dynamic shared memory a CTA
    items: int  # (slice, half, row tile) items: n1 x 2 x tiles
    threads: int  # threads a CTA


def gmm_floor_plan(b: int, n: int, resident: int = 132) -> FloorPlan:
    """K13's plan at b x n (any multiple of 128): the n1 x 2 x ceil(b / 128)
    (slice, half, row tile) items over min(resident, items) CTAs, `resident`
    the CTAs the card holds at once (one an SM).  Raises ValueError for what
    the kernel does not take and RuntimeError where no CTA fits (resident <
    1)."""
    if b < 0 or n < LANES or n % LANES:
        raise ValueError(f"gmm_floor_plan: bad shape {b} x {n}")
    if resident < 1:
        raise RuntimeError(f"gmm_floor: no CTA with {FLOOR_SMEM} bytes of shared memory fits "
                           f"on the card")
    items = -(-b // FLOOR_ROWS) * 2 * (n // LANES)
    return FloorPlan(min(resident, items), FLOOR_ROWS, FLOOR_BINS, FLOOR_STAGES, FLOOR_SMEM,
                     items, FLOOR_THREADS)


def gmm_floor_walk(plan: FloorPlan, b: int) -> list[list[tuple[int, int, range]]]:
    """The (slice k1, half h, rows) items each CTA walks, in its order: CTA
    c takes items c I / C .. (c + 1) I / C - 1 of the I items in
    slice-major order, item i being slice i // tiles // 2, half
    i // tiles % 2 (bins 64 h .. 64 h + 63 of the slice) and the rows of
    tile i % tiles (the last one ragged where b is not a multiple of 128)."""
    tiles = -(-b // FLOOR_ROWS)
    cut = [c * plan.items // max(plan.ctas, 1) for c in range(plan.ctas + 1)]
    return [[(i // tiles // 2, i // tiles % 2,
              range(i % tiles * FLOOR_ROWS, min(b, (i % tiles + 1) * FLOOR_ROWS)))
             for i in range(cut[c], cut[c + 1])] for c in range(plan.ctas)]


@lru_cache(maxsize=None)
def _floor_resident(device: torch.device) -> int:
    """CTAs of K13's kernel (256 threads and FLOOR_SMEM bytes each) the card
    holds at once, asked once a device; 0 or a negative CUDA error where
    none fits: the launch then refuses."""
    with torch.cuda.device(device):
        return int(_build.library().gdsp_gmm_floor_resident(0))


# ---------------------------------------------------------------------------
# Plain versions (any device, any float dtype: the float64 oracle on the card)
# ---------------------------------------------------------------------------


def copy_split_plain(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of K12."""
    _check(xr, xi, "copy_split")
    return xr.clone(), xi.clone()


def gmm_floor_plain(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of K13: (x.view(b, n1, 128) * T) @ F128 / 128 in
    the input's dtype (complex128 for float64 planes)."""
    b, n = _check_gmm(xr, xi)
    cdt = torch.complex128 if xr.dtype == torch.float64 else torch.complex64
    t, f = _plain_tables(n, xr.device, cdt)
    z = torch.complex(xr, xi).to(cdt).reshape(b, n // LANES, LANES)
    with _tf32_off() if z.is_cuda else nullcontext():
        y = (torch.matmul(z * t, f) / LANES).reshape(b, n)
    return y.real.contiguous(), y.imag.contiguous()


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def copy_split(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K12: (yr, yi) = (xr, xi), two float32 planes (b, n) read and written."""
    _check(xr, xi, "copy_split")
    if not xr.is_cuda:
        return copy_split_plain(xr, xi)
    xr, xi = _cuda_planes(xr, xi, "copy_split")
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    n = xr.numel()
    if n == 0:
        return yr, yi
    with torch.cuda.device(xr.device):
        rc = _build.library().gdsp_copy_split(
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(), n,
            torch.cuda.current_stream(xr.device).cuda_stream,
        )
    _build.check(rc, "copy_split")
    launches["copy_split"] += 1
    return yr, yi


def gmm_floor(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K13: the twiddled 128-point DFT of every lane slice of two float32
    planes (b, n), n a multiple of 128, on gmm_floor_plan's persistent grid
    (see the module docstring)."""
    b, n = _check_gmm(xr, xi)
    if not xr.is_cuda:
        return gmm_floor_plain(xr, xi)
    xr, xi = _cuda_planes(xr, xi, "gmm_floor")
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    if b == 0:
        return yr, yi
    g = gmm_tables(n, xr.device)
    with torch.cuda.device(xr.device):
        rc = _build.library().gdsp_gmm_floor(
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(), g.data_ptr(), b, n,
            _floor_resident(xr.device), torch.cuda.current_stream(xr.device).cuda_stream,
        )
    _build.check(rc, "gmm_floor")
    launches["gmm_floor"] += 1
    return yr, yi
