"""Outer DFT levels of the giant-N FFT plan for Hopper, with their plain versions.

Counterpart of godsp_tpu/ops/pallas_outer.py.

  K8 outer_dft_split(xr, xi, d1, d2, inverse)
     replaces pallas_outer.py: outer_dft_split (_outer_kernel)
  K9 peel_rows_fused_split(xr, xi, inverse, scale)
     replaces pallas_outer.py: peel_rows_fused_split (_peel_rows_kernel)

For a length-N transform viewed as (..., m, n3) float32 planes, m = d1*d2
rows and N = m*n3, the result's row k1*d2 + k2, column t holds

    W_N^{k t} * sum_i x[i, t] W_m^{k i},   k = k1 + d1*k2,

godsp_tpu's two dense outer levels and both twiddles (pallas_outer.py:6-9)
in its row order, so that the n3-point FFT of every row finishes the
transform (fft/large.py).  d2 = 1 is the single-level form.  The kernel
(csrc/outer_kernel.cu, whose header says what bounds it on the H100) runs
the m-point column DFT on csrc/fft_regs.cuh's register-radix Stockham
passes down the columns of a tile of C adjacent columns (tile(m): C, its
threads and shared memory), the W_N twiddle from the factored hi/lo
tables at the store, for any pow-2 m = 2..2048 and any n3; the TPU's
d <= 128 and n3 % 128 rules are not ported.  outer_dft_regs_model is its
float64 model, for the CPU tests (no main-path call uses it): the column
passes (cuda_fft's row model, the columns as rows), the hi/lo twiddle in
the kernel's order and the row permutation.  The first design (radix-2
stages in shared memory) stays as cuda_probes.outer_dft_radix2.

The plain version is godsp_tpu's einsum form (fft/large.py:378-404): the
dense DFT over d1, the factored twiddle, the dense DFT over d2 and its
twiddle, in the input's dtype; the tables are built in float64 with the
exponents reduced in exact integer arithmetic.  It is the float64
oracle on the card (TF32 off around its matmuls).

K9 fuses the last 128-point peel of the large plan with the row FFT: for
(..., 128, n3) planes, n3 a power of 2 in 256..8192 (godsp_tpu's
peel_rows_supported), row k1 of the result is

    scale * sum_t W_n3^{k3 t} W_{128 n3}^{k1 t} sum_i x[i, t] W_128^{k1 i},

outer_dft_split(d1=128, d2=1) followed by the n3-point row FFT, in one
pass over device memory (csrc/peel_rows_kernel.cu).  Its rows are in
natural bin order, where godsp_tpu stores digit order, and `scale` (the
public ifft's 1/N) is applied in its store.  The kernel runs on a cluster
of CTAs that hand the column step's results to the CTA owning each row
through distributed shared memory; peel_plan is its plan (cluster, rows a
CTA, the column DFT's points, the clusters a batch element reads its input
with), peel_scatter its phase-A store map, peel_rows_regs_model its
float64 model for the CPU tests (no main-path call uses either).  Its
plain version is godsp_tpu's form: the dense F(128) contraction and the
(128, n3) twiddle of K8's plain version, then the plain row FFT, in the
input's dtype.  The first design stays as cuda_probes.peel_rows_radix2.

A wrapper takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

from contextlib import nullcontext
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from godsp_tpu_torch.fft.four_step import _tf32_off, dft_matrix
from godsp_tpu_torch.ops import _build
from godsp_tpu_torch.ops.cuda_fft import (
    _row_dft_model,
    fft_pow2_plain,
    geometry,
    out_index,
    stockham_table,
    twiddle_table,
)

__all__ = [
    "MAX_ROWS",
    "PEEL",
    "PeelPlan",
    "launches",
    "Tile",
    "outer_dft_regs_model",
    "outer_dft_split",
    "outer_dft_split_plain",
    "outer_supported",
    "peel_rows_fused_split",
    "peel_plan",
    "peel_rows_fused_split_plain",
    "peel_rows_regs_model",
    "peel_rows_supported",
    "peel_scatter",
    "tile",
]

MAX_ROWS = 2048  # m rows x 8 columns of float2 in shared memory: 128 KB a block
PEEL = 128  # points of K9's fused peel

# Kernel launches by wrapper, counted where each launches its kernel.
launches = {"outer_dft_split": 0, "peel_rows_fused_split": 0}


def outer_supported(d1: int, d2: int, n3: int) -> bool:
    """Row factors d1, d2 >= 1 with m = d1*d2 a power of 2 in 2..MAX_ROWS, any n3 >= 1."""
    m = d1 * d2
    return d1 >= 1 and d2 >= 1 and 2 <= m <= MAX_ROWS and m & (m - 1) == 0 and n3 >= 1


def peel_rows_supported(n3: int) -> bool:
    """Row lengths K9 takes: a power of 2 from 256 to 8192 (godsp_tpu's
    n3 % 128 == 0 and 2 <= n3 / 128 <= 64, at the pow-2 sizes its plan
    gives)."""
    return 256 <= n3 <= 8192 and n3 & (n3 - 1) == 0


class Tile(NamedTuple):
    """K8's column tile of m rows (gdsp_outer_dft_geometry returns the same
    on the card)."""

    columns: int  # C adjacent columns a CTA, interleaved word by word in shared memory
    threads: int  # T C: T = m / P threads a column
    smem: int  # bytes of shared memory: two float planes of C m words (none for one pass)


def tile(m: int) -> Tile:
    """The column tile of m rows, m a power of 2 in 2..MAX_ROWS: 256
    threads (max(32, 256 / T) columns while T <= 16, 8 columns above;
    m = 2048 runs 1024 threads)."""
    if m < 2 or m & (m - 1) or m > MAX_ROWS:
        raise ValueError(f"tile: m must be a power of 2 in 2..{MAX_ROWS}, got {m}")
    g = geometry(m)
    c = max(32, 256 // g.threads) if g.threads <= 16 else 8
    return Tile(c, g.threads * c, c * m * 8 if len(g.radices) >= 2 else 0)


class PeelPlan(NamedTuple):
    """K9's plan at one n3 (gdsp_peel_rows_geometry returns the same on the
    card)."""

    cluster: int  # C CTAs a cluster
    rows: int  # R rows of the result a CTA holds in shared memory
    points: int  # M = C R rows a cluster: the column DFT's points
    clusters: int  # G = 128 / M clusters a batch element: its L2 re-read factor
    threads: int  # a CTA's
    tile_columns: int  # Ct columns a phase-A tile (K8's tile(M))
    tiles: int  # phase-A tiles side by side in a CTA
    smem: int  # bytes: the R rows' two planes, then each tile's exchange


PEEL_CLUSTER = 8  # CTAs a cluster: the portable size
PEEL_THREADS = 512
_PEEL_SLAB = 16384  # R n3 float2 a CTA at most: 128 KB


@lru_cache(maxsize=None)
def peel_plan(n3: int) -> PeelPlan:
    """K9's cluster plan at n3 (peel_rows_supported): R = min(16, 16384 /
    n3) rows a CTA, clusters of 8 CTAs, the column step at M = 8 R points
    in K8's tile(M), two tiles side by side in 512 threads."""
    if not peel_rows_supported(n3):
        raise ValueError(f"peel_plan: n3 must be a power of 2 in 256..8192, got {n3}")
    r = min(16, _PEEL_SLAB // n3)
    m = PEEL_CLUSTER * r
    t = tile(m)
    tiles = PEEL_THREADS // t.threads
    exchange = t.columns * m * 2 if len(geometry(m).radices) >= 2 else 0
    return PeelPlan(PEEL_CLUSTER, r, m, PEEL // m, PEEL_THREADS, t.columns, tiles,
                    4 * (r * n3 * 2 + tiles * exchange))


def _peel_slot_word(n3: int, rows: int, slot, c):
    """Word of column c of row slot `slot` in a CTA's plane of rows of n3
    points (fft_regs.cuh's slot_of: Q rows interleaved word by word)."""
    q = geometry(n3).q
    return (slot // q) * q * n3 + slot % q + c * q


def peel_scatter(n3: int) -> dict[str, np.ndarray]:
    """K9's phase-A stores of one cluster, as the kernel makes them: for
    source CTA `src` (C), loop step `it`, thread `tid` (512) and output
    register `i` (P), the bin j of the column DFT (k1 = g + G j), the
    column c, whether the tile is live, the target CTA j mod C and the word
    of its planes (row slot j / C, position c).  Arrays of shape (C, steps,
    512, P)."""
    plan = peel_plan(n3)
    g = geometry(plan.points)
    ct, tt = plan.tile_columns, g.threads * plan.tile_columns
    cols = n3 // plan.cluster
    tiles = cols // ct
    steps = -(-tiles // plan.tiles)
    src, it, tid, i = np.meshgrid(np.arange(plan.cluster), np.arange(steps),
                                  np.arange(plan.threads), np.arange(g.points), indexing="ij")
    tl = it * plan.tiles + tid // tt
    t, cc = (tid % tt) // ct, (tid % tt) % ct
    live = tl < tiles
    c = src * cols + np.where(live, tl, 0) * ct + cc
    j = t + out_index(plan.points)[i] * g.threads
    dst = j % plan.cluster
    word = _peel_slot_word(n3, plan.rows, j // plan.cluster, c)
    return dict(j=j, c=c, live=live, dst=dst, word=word, tid=tid)


def peel_rows_regs_model(xr, xi, inverse: bool = False,
                         scale: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """float64 model of K9 (csrc/peel_rows_kernel.cu) on numpy planes (...,
    128, n3), step by step: for each cluster g of a batch element, the
    radix-G decimation u[i0] = W_128^{g i0} sum_i1 x[i0 + M i1] W_128^{g M
    i1}, the M-point column passes (cuda_fft's row model, the columns as
    rows), the twiddle W_{128 n3}^{k1 c}, the phase-A stores into each CTA's planes at peel_scatter's words, then
    each CTA's rows read back from its planes, the n3-point row passes and
    `scale`.  The twiddle is formed as the kernel forms it, hi[p >> s] lo[p
    & (2^s - 1)] at p = k1 c.  For the CPU tests; no main-path call uses
    it."""
    xr = np.asarray(xr, np.float64)
    shape = xr.shape
    n3 = shape[-1]
    if shape[-2] != PEEL or not peel_rows_supported(n3):
        raise ValueError(f"unsupported fused peel-rows shape {shape[-2:]}")
    x = (xr + 1j * np.asarray(xi, np.float64)).reshape(-1, PEEL, n3)
    b = x.shape[0]
    plan = peel_plan(n3)
    C, R, M, G = plan.cluster, plan.rows, plan.points, plan.clusters
    n = PEEL * n3
    sign = 2.0 if inverse else -2.0
    lo_bits = lo_bits_of(n)
    mp = peel_scatter(n3)
    keep = mp["live"]
    jj, cc, dst, word = (mp[k][keep] for k in ("j", "c", "dst", "word"))
    y = np.empty_like(x)
    i0, i1 = np.arange(M), np.arange(G)
    for g in range(G):
        w1 = np.exp(1j * sign * np.pi * ((g * M * i1) % PEEL) / PEEL)  # W_128^{g M i1}
        w0 = np.exp(1j * sign * np.pi * ((g * i0) % PEEL) / PEEL)  # W_128^{g i0}
        u = np.einsum("bhmc,h->bmc", x.reshape(b, G, M, n3), w1) * w0[None, :, None]
        cols = np.swapaxes(u, 1, 2).reshape(-1, M)
        f = np.swapaxes(_row_dft_model(cols, inverse).reshape(b, n3, M), 1, 2)  # (b, j, c)
        p = (g + G * np.arange(M))[:, None] * np.arange(n3)[None, :]  # k1 c, exact
        w = (np.exp(1j * sign * np.pi * ((p >> lo_bits) << lo_bits) / n)
             * np.exp(1j * sign * np.pi * (p & ((1 << lo_bits) - 1)) / n))
        f = f * w
        planes = np.full((b, C, R * n3), np.nan + 0j)
        planes[:, dst, word] = f[:, jj, cc]
        for q in range(C):
            slots = np.arange(R)
            rows = planes[:, q][:, _peel_slot_word(n3, R, slots[:, None], np.arange(n3)[None, :])]
            out = _row_dft_model(rows.reshape(-1, n3), inverse).reshape(b, R, n3) * scale
            y[:, g + G * (slots * C + q), :] = out
    y = y.reshape(shape)
    return y.real, y.imag


def _exp_table(n: int, kk: torch.Tensor, tt: torch.Tensor, inverse: bool) -> torch.Tensor:
    """complex128 exp(-+2 pi i (kk (x) tt mod n) / n), the exponent exact in int64."""
    p = torch.remainder(kk[:, None] * tt[None, :], n).to(torch.float64)
    ang = p * ((2.0 if inverse else -2.0) * np.pi / n)
    return torch.polar(torch.ones_like(ang), ang)


def lo_bits_of(n: int) -> int:
    """Bits of the lo half of _factor_tables(n)."""
    return ((n - 1).bit_length() + 1) // 2


@lru_cache(maxsize=None)
def _factor_tables(n: int, inverse: bool, device: torch.device):
    """(hi, lo, lo_bits): W_n^p = hi[p >> lo_bits] * lo[p & (2^lo_bits - 1)],
    two (entries, 2) float32 tables built in float64 and rounded once."""
    lo_bits = lo_bits_of(n)
    n_hi = (n + (1 << lo_bits) - 1) >> lo_bits
    sign = 2.0 if inverse else -2.0

    def table(p):
        ang = sign * np.pi * p / n
        return torch.from_numpy(np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32))

    hi = table(np.arange(n_hi, dtype=np.float64) * float(1 << lo_bits))
    lo = table(np.arange(1 << lo_bits, dtype=np.float64))
    return hi.to(device), lo.to(device), lo_bits


@lru_cache(maxsize=None)
def _dft_table(n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """(n, 2) float32 table W_n^p, p < n, built in float64 and rounded once."""
    ang = (2.0 if inverse else -2.0) * np.pi * np.arange(n, dtype=np.float64) / n
    return torch.from_numpy(np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)).to(device)


def _check(xr, xi, d1: int, d2: int) -> tuple[int, int]:
    if xr.shape != xi.shape:
        raise ValueError("re/im planes must have identical shapes")
    if xr.dim() < 2:
        raise ValueError("outer_dft_split takes (..., d1*d2, n3) planes")
    rows, n3 = xr.shape[-2], xr.shape[-1]
    if rows != d1 * d2:
        raise ValueError(f"row dim {rows} != d1*d2 = {d1 * d2}")
    if not outer_supported(d1, d2, n3):
        raise ValueError(f"unsupported outer plan ({d1}, {d2}, {n3}): "
                         f"d1*d2 must be a power of 2 in 2..{MAX_ROWS}")
    return rows, n3


def _check_peel(xr, xi) -> int:
    if xr.shape != xi.shape:
        raise ValueError("re/im planes must have identical shapes")
    if xr.dim() < 2 or xr.shape[-2] != PEEL or not peel_rows_supported(xr.shape[-1]):
        raise ValueError(f"unsupported fused peel-rows shape {tuple(xr.shape[-2:])}: "
                         f"(..., {PEEL}, n3), n3 a power of 2 in 256..8192")
    return xr.shape[-1]


# ---------------------------------------------------------------------------
# Plain versions (any device, any float dtype: the float64 oracle on the card)
# ---------------------------------------------------------------------------


def outer_dft_split_plain(xr: torch.Tensor, xi: torch.Tensor, d1: int, d2: int,
                          inverse: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Both outer levels + twiddles as dense contractions (godsp_tpu's
    einsum form), same layout as outer_dft_split."""
    rows, n3 = _check(xr, xi, d1, d2)
    n = rows * n3
    dev = xr.device
    cdt = torch.complex128 if xr.dtype == torch.float64 else torch.complex64
    lead = xr.shape[:-2]
    x = torch.complex(xr, xi).to(cdt).reshape(-1, d1, d2, n3)

    def ar(v):
        return torch.arange(v, device=dev, dtype=torch.int64)

    f1, f2 = dft_matrix(d1), dft_matrix(d2)
    if inverse:
        f1, f2 = np.conj(f1), np.conj(f2)
    f1 = torch.from_numpy(f1).to(device=dev, dtype=cdt)
    f2 = torch.from_numpy(f2).to(device=dev, dtype=cdt)
    ta = _exp_table(n, ar(d1), ar(d2) * n3, inverse).to(cdt)  # (d1, d2): W_N^{k1 i2 n3}
    tb = _exp_table(n, ar(d1), ar(n3), inverse).to(cdt)  # (d1, n3): W_N^{k1 t}
    with _tf32_off() if x.is_cuda else nullcontext():
        a = torch.einsum("ki,bijn->bkjn", f1, x)  # level 1 over i1
        a = a * ta[:, :, None] * tb[:, None, :]
        if d2 > 1:
            tc = _exp_table(d2 * n3, ar(d2), ar(n3), inverse).to(cdt)  # W_{d2 n3}^{k2 t}
            a = torch.einsum("cj,bkjn->bkcn", f2, a) * tc  # level 2 over i2
    y = a.reshape(*lead, rows, n3)
    return y.real.contiguous(), y.imag.contiguous()


def outer_dft_regs_model(xr, xi, d1: int, d2: int,
                         inverse: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """float64 model of K8 (csrc/outer_kernel.cu) on numpy planes (..., m,
    n3): each column's m-point transform by the kernel's passes (cuda_fft's
    row model: plan, table indices, swizzled exchanges), the twiddle
    W_N^{k c} as the kernel forms it for column c = c0 + cc of its tile of
    C = tile(m).columns: hi[p >> s] lo[p & (2^s - 1)] at p = k c0 (exact),
    times W_N^{k cc} (_tile_table), and bin k stored at row (k % d1) d2 +
    k / d1.  For the CPU tests; no main-path call uses it."""
    xr = np.asarray(xr, np.float64)
    m, n3 = xr.shape[-2], xr.shape[-1]
    if m != d1 * d2:
        raise ValueError(f"row dim {m} != d1*d2 = {d1 * d2}")
    n = m * n3
    z = (xr + 1j * np.asarray(xi, np.float64)).reshape(-1, m, n3)
    cols = np.swapaxes(z, 1, 2).reshape(-1, m)  # every column a row of the model
    f = np.swapaxes(_row_dft_model(cols, inverse).reshape(-1, n3, m), 1, 2)  # (b, k, c)
    lo_bits = lo_bits_of(n)
    sign = 2.0 if inverse else -2.0
    k = np.arange(m)[:, None]
    c = np.arange(n3)[None, :]
    cc = c % tile(m).columns
    p = k * (c - cc)  # k c0 < N, exact
    w = (np.exp(1j * sign * np.pi * ((p >> lo_bits) << lo_bits) / n)
         * np.exp(1j * sign * np.pi * (p & ((1 << lo_bits) - 1)) / n)
         * np.exp(1j * sign * np.pi * (k * cc) / n))
    kk = np.arange(m)
    y = np.empty_like(f)
    y[:, (kk % d1) * d2 + kk // d1, :] = f * w
    y = y.reshape(xr.shape)
    return y.real, y.imag


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def outer_dft_split(xr: torch.Tensor, xi: torch.Tensor, d1: int, d2: int,
                    inverse: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """K8: the outer levels of (..., d1*d2, n3) float32 planes in one
    device-memory pass; row k1*d2 + k2 of the result is ready for its
    n3-point row FFT.  inverse conjugates every table (no scale)."""
    if not xr.is_cuda:
        return outer_dft_split_plain(xr, xi, d1, d2, inverse)
    return _launch(xr, xi, d1, d2, inverse, launches, "outer_dft_split")


@lru_cache(maxsize=None)
def _tile_table(n: int, m: int, c: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """(m C, 2) float32 W_n^{k cc}, k < m, cc < C, at k C + cc: float64, rounded once."""
    p = np.arange(m)[:, None] * np.arange(c)[None, :]
    ang = (2.0 if inverse else -2.0) * np.pi * p.reshape(-1) / n
    return torch.from_numpy(np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)).to(device)


def _launch(xr, xi, d1: int, d2: int, inverse: bool, counts: dict, name: str,
            radix2: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Run K8 (radix2: its first design, cuda_probes.outer_dft_radix2) on
    CUDA planes, counted in counts[name]."""
    rows, n3 = _check(xr, xi, d1, d2)
    if xr.dtype != torch.float32 or xi.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32 planes, got {xr.dtype}")
    if xi.device != xr.device:
        raise ValueError(f"{name}: re/im planes must be on one device")
    xr, xi = xr.contiguous(), xi.contiguous()
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    batch = xr.numel() // (rows * n3)
    if batch == 0:
        return yr, yi
    dev = xr.device
    hi, lo, lo_bits = _factor_tables(rows * n3, inverse, dev)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if radix2:
            rc = lib.gdsp_outer_dft_radix2(
                xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                twiddle_table(rows, inverse, dev).data_ptr(), hi.data_ptr(), lo.data_ptr(),
                rows.bit_length() - 1, d2, n3, batch, lo_bits, stream)
        else:
            tt = _tile_table(rows * n3, rows, tile(rows).columns, inverse, dev)
            rc = lib.gdsp_outer_dft(
                xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                stockham_table(rows, inverse, dev).data_ptr(), hi.data_ptr(), lo.data_ptr(),
                tt.data_ptr(), rows.bit_length() - 1, d2, n3, batch, lo_bits, int(inverse),
                stream)
    _build.check(rc, name)
    counts[name] += 1
    return yr, yi


def peel_rows_fused_split_plain(xr: torch.Tensor, xi: torch.Tensor, inverse: bool = False,
                                scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """The 128-point peel and its twiddle as dense contractions (K8's plain
    version at d1 = 128, d2 = 1), then the plain n3-point row FFT times
    scale: K9's result, in the input's dtype."""
    _check_peel(xr, xi)
    yr, yi = outer_dft_split_plain(xr, xi, PEEL, 1, inverse)
    return fft_pow2_plain(yr, yi, inverse, scale)


def peel_rows_fused_split(xr: torch.Tensor, xi: torch.Tensor, inverse: bool = False,
                          scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """K9: the last 128-point peel, its twiddle and the n3-point row FFT of
    (..., 128, n3) float32 planes in one device-memory pass, times scale;
    row k1 holds its natural-order bins k3.  inverse conjugates every
    table."""
    _check_peel(xr, xi)
    if not xr.is_cuda:
        return peel_rows_fused_split_plain(xr, xi, inverse, scale)
    return _launch_peel(xr, xi, inverse, scale, launches, "peel_rows_fused_split")


@lru_cache(maxsize=None)
def _peel_args(n3: int, inverse: bool, device: torch.device) -> tuple:
    """K9's table pointers and log2 n3, the tables held by the caches they
    come from."""
    hi, lo, _ = _factor_tables(PEEL * n3, inverse, device)
    rows = (stockham_table(peel_plan(n3).points, inverse, device),
            stockham_table(n3, inverse, device))
    return (_dft_table(PEEL, inverse, device).data_ptr(), *(t.data_ptr() for t in rows),
            hi.data_ptr(), lo.data_ptr(), n3.bit_length() - 1)


def _peel_planes(xr, xi, name: str):
    """(xr, xi contiguous, yr, yi, batch) for a launch on CUDA planes."""
    if xr.dtype != torch.float32 or xi.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32 planes, got {xr.dtype}")
    if xi.device != xr.device:
        raise ValueError(f"{name}: re/im planes must be on one device")
    xr, xi = xr.contiguous(), xi.contiguous()
    return xr, xi, torch.empty_like(xr), torch.empty_like(xi), xr.numel() // (PEEL * xr.shape[-1])


def _launch_peel(xr, xi, inverse: bool, scale: float, counts: dict,
                 name: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Run K9 on CUDA planes, counted in counts[name]."""
    n3 = _check_peel(xr, xi)
    xr, xi, yr, yi, batch = _peel_planes(xr, xi, name)
    if batch == 0:
        return yr, yi
    dev = xr.device
    with torch.cuda.device(dev):
        rc = _build.library().gdsp_peel_rows(
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            *_peel_args(n3, inverse, dev), batch, lo_bits_of(PEEL * n3), int(inverse),
            float(scale), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, name)
    counts[name] += 1
    return yr, yi
