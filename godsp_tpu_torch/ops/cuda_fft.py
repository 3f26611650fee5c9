"""Batched power-of-2 FFT kernels for Hopper, with their plain versions.

Counterpart of godsp_tpu/ops/pallas_fft.py.  Three wrappers, each with
its own launch count, over the two kernels of csrc/fft_kernels.cu:

  K1 fft_pow2(xr, xi|None, inverse, scale)   replaces pallas_fft.py: fft_pow2_split
  K2 ifft_pow2(yr, yi, scale)                replaces pallas_fft.py: ifft_pow2_digit_split
                                             (fft_pow2_kernel's inverse mode)
  K3 rfft_pow2(xr)                           replaces pallas_fft.py: rfft_pow2_split
                                             (rfft_pow2_kernel: the packed
                                             half-length transform and its split)

The TPU kernels contracted DFT tables on the MXU and emitted a digit bin
order; on Hopper each row is 2-4 register-radix Stockham passes
(csrc/fft_regs.cuh: radix 16 or 32 a pass, natural order in and out, one
shared-memory exchange a pass, rows of n <= 1024 inside one warp) with a
float64-built twiddle table laid out in the order the passes read it, and
every output is in natural order (K2 takes natural-order input).  K3 runs
the n/2-point transform of the row read as complex pairs and splits it into
bins 0..n/2 in the same kernel.  The pow-2 range is N = 2..16384: the
TPU's 256 floor was a lane rule, and 16384 points (128 KB) are what one
block's shared memory holds beside nothing else.  What bounds each kernel
on the H100 is in the source's header: device-memory traffic, one read
and one write a point.

Here also the host side of that design: the plan (radix_plan, geometry,
cta_fits), the tables (stockham_table, rfft_table: float64, rounded
once), and a float64 model of the kernels' passes (fft_pow2_stockham_model,
rfft_packed_model) that the CPU tests hold to the plain versions, since
the kernels cannot run there.  No main-path call uses the model.

Beside each wrapper stands its plain PyTorch version (fft/four_step.py),
and a launch count.  A wrapper takes the plain version only for a tensor
on the CPU; for a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from godsp_tpu_torch.fft.four_step import four_step_fft
from godsp_tpu_torch.ops import _build

__all__ = [
    "MAX_N",
    "MAX_SMEM",
    "Geometry",
    "cta_fits",
    "cta_shape",
    "exchange_swizzle",
    "fft_pow2",
    "fft_pow2_plain",
    "fft_pow2_stockham_model",
    "geometry",
    "ifft_pow2",
    "ifft_pow2_plain",
    "launches",
    "oct32",
    "out_index",
    "radix_plan",
    "rfft_packed_model",
    "rfft_pow2",
    "rfft_pow2_plain",
    "rfft_table",
    "rfft_table64",
    "stockham_table",
    "stockham_table64",
    "supported_size",
    "twiddle_table",
]

MAX_N = 16384
MAX_SMEM = 232448  # bytes of shared memory one block may use (227 KB)

# Kernel launches by wrapper, counted where each launches its kernel.
launches = {"fft_pow2": 0, "ifft_pow2": 0, "rfft_pow2": 0}


def supported_size(n: int) -> bool:
    """Power-of-2 sizes the kernels cover: 2..16384."""
    return n >= 2 and n & (n - 1) == 0 and n <= MAX_N


@lru_cache(maxsize=None)
def twiddle_table(n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """(n/2, 2) float32 table exp(-+2 pi i j / n), built in float64, rounded once."""
    j = np.arange(n // 2, dtype=np.float64)
    ang = (2.0 if inverse else -2.0) * np.pi * j / n
    tab = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    return torch.from_numpy(tab).to(device)


# ---------------------------------------------------------------------------
# The register-radix plan (csrc/fft_regs.cuh), its tables and its model
# ---------------------------------------------------------------------------


class Geometry(NamedTuple):
    """How fft_regs.cuh lays out a row of n points (gdsp_fft_pow2_geometry
    returns the same on the card)."""

    points: int  # P, points a thread holds in registers
    threads: int  # T = n / P threads a row
    warp: bool  # a row inside one warp (T <= 32): __syncwarp fences only
    q: int  # rows a warp interleaves word by word in shared memory
    max_threads: int  # the kernels' launch bound: threads a CTA at most
    default_rows: int  # rows a CTA of gdsp_fft_pow2 / gdsp_rfft_pow2
    radices: tuple[int, ...]  # one a Stockham pass


def _points_log2(log2n: int) -> int:
    return log2n if log2n <= 4 else 5 if log2n == 10 else 4


@lru_cache(maxsize=None)
def geometry(n: int) -> Geometry:
    """The plan of an n-point row, n = 1..16384 a power of 2 (n = 1 is K3's
    half-length row at n = 2: no pass)."""
    if n < 1 or n & (n - 1) or n > MAX_N:
        raise ValueError(f"geometry: n must be a power of 2 in 1..{MAX_N}, got {n}")
    lg = n.bit_length() - 1
    pb = _points_log2(lg)
    radices, left = [], lg
    while left > 0:
        radices.append(1 << min(pb, left))
        left -= min(pb, left)
    p = 1 << pb
    t = n // p
    warp = t <= 32
    q = 32 // t if warp else 1
    default = 8 * q if warp else 1
    return Geometry(p, t, warp, q, 512 if warp else 1024, default, tuple(radices))


def radix_plan(n: int) -> tuple[int, ...]:
    """The radix of each Stockham pass of the n-point kernel transform: the
    points a thread, but the last pass takes what is left."""
    return geometry(n).radices


def cta_shape(n: int, rows: int) -> tuple[int, int]:
    """(threads, slots) of a CTA of `rows` rows of n points: the warp route
    rounds rows up to whole warps (slots), the block route runs T a row."""
    g = geometry(n)
    if g.warp:
        warps = -(-rows // g.q)
        return 32 * warps, g.q * warps
    return rows * g.threads, rows


def cta_fits(n: int, rows: int, split: bool = False) -> bool:
    """Whether `rows` rows of n points make a CTA the kernels launch: within
    the launch bound's threads and 227 KB of shared memory (two float
    planes a slot where a row has an exchange; K3's split always has one)."""
    if rows < 1:
        return False
    threads, slots = cta_shape(n, rows)
    g = geometry(n)
    smem = slots * n * 8 if len(g.radices) >= 2 or split else 0
    return threads <= g.max_threads and smem <= MAX_SMEM


def out_index(n: int) -> np.ndarray:
    """c of each output register i after the last pass: register i holds
    bin t + c T (fft_regs.cuh: out_index)."""
    g = geometry(n)
    if not g.radices:
        return np.zeros(1, np.int64)
    r = g.radices[-1]
    i = np.arange(g.points)
    return (i % r) * (g.points // r) + i // r


def exchange_swizzle(i, ns: int, r: int):
    """L(i): where the exchange written by a pass of stride ns and radix r
    puts logical index i of a row (an XOR inside each 32-word line)."""
    if ns >= 32:
        return i
    m_bits, ns_bits = (ns * r).bit_length() - 1, ns.bit_length() - 1
    return i ^ (((i >> m_bits) << ns_bits) & 31)


def oct32() -> np.ndarray:
    """cos(2 pi e / 32), e = 0..8, as the float32 constants of fft_regs.cuh's
    oct32 (float64 rounded once; e = 8 exactly 0: rot32 takes -i exact)."""
    c = np.cos(2.0 * np.pi * np.arange(9) / 32).astype(np.float32)
    c[8] = 0.0
    return c


@lru_cache(maxsize=None)
def stockham_table64(n: int, inverse: bool = False) -> np.ndarray:
    """The n-entry complex128 table of the n-point kernel transform in the
    order its passes read it: pass p (stride Ns, radix R) at [Ns, Ns R),
    entry r Ns + k = W_{Ns R}^{r k}, r >= 1; entry 0 is 1.  The inverse
    table is its conjugate."""
    tab = np.ones(n, np.complex128)
    ns = 1
    for r in radix_plan(n) if n > 1 else ():
        m = ns * r
        rr, k = np.meshgrid(np.arange(1, r), np.arange(ns), indexing="ij")
        e = (rr * k) % m
        ang = (2.0 if inverse else -2.0) * np.pi * e / m
        tab[rr * ns + k] = np.cos(ang) + 1j * np.sin(ang)
        ns = m
    tab.flags.writeable = False
    return tab


def _f32_pairs(tab: np.ndarray, device) -> torch.Tensor:
    pairs = np.stack([tab.real, tab.imag], axis=-1).astype(np.float32)
    return torch.from_numpy(pairs).to(device)


@lru_cache(maxsize=None)
def stockham_table(n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """(n, 2) float32 stockham_table64(n, inverse), rounded once."""
    return _f32_pairs(stockham_table64(n, inverse), device)


@lru_cache(maxsize=None)
def rfft_table64(n: int) -> np.ndarray:
    """K3's n-entry complex128 table at n = 2m: the m-point forward
    Stockham table, then W_n^k, k < m (the split's twiddles)."""
    m = n // 2
    k = np.arange(m)
    ang = -2.0 * np.pi * k / n
    tab = np.concatenate([stockham_table64(m), np.cos(ang) + 1j * np.sin(ang)])
    tab.flags.writeable = False
    return tab


@lru_cache(maxsize=None)
def rfft_table(n: int, device: torch.device) -> torch.Tensor:
    """(n, 2) float32 rfft_table64(n), rounded once."""
    return _f32_pairs(rfft_table64(n), device)


def _dft_regs_model(v: np.ndarray, inverse: bool) -> np.ndarray:
    """fft_regs.cuh's dft_regs over the last axis (R points) in float64:
    radix-2 DIF stages, then bit-reversed order renamed to natural."""
    v = v.copy()
    r = v.shape[-1]
    bits = r.bit_length() - 1
    sign = 1.0 if inverse else -1.0
    for s in range(bits):
        h = r >> (s + 1)
        for i in range(r):
            if i & h:
                continue
            a, b = v[..., i].copy(), v[..., i + h].copy()
            e = (i & (h - 1)) * (16 // h)  # W_{2h}^{i mod h} = W_32^e
            v[..., i] = a + b
            v[..., i + h] = (a - b) * np.exp(sign * 2j * np.pi * e / 32)
    rev = [int(format(k, f"0{bits}b")[::-1], 2) if bits else 0 for k in range(r)]
    return v[..., rev]


def _row_dft_model(z: np.ndarray, inverse: bool) -> np.ndarray:
    """The kernels' n-point row transform over z (rows, n) in float64, pass
    by pass as fft_regs.cuh runs it: thread t, butterfly b, element r, the
    table entries r Ns + k, and each exchange through a row of shared
    memory at the swizzled positions the pass wrote."""
    rows, n = z.shape
    g = geometry(n)
    tw = stockham_table64(n, inverse)
    P, T = g.points, g.threads
    t = np.arange(T)[:, None]
    v = z[:, t + T * np.arange(P)[None, :]]  # (rows, T, P): v[r] = x[t + r T]
    ns = 1
    for p, r in enumerate(g.radices):
        b_count = P // r
        j = t + T * np.arange(b_count)[None, :]  # (T, B)
        vb = v.reshape(rows, T, b_count, r)
        if p > 0:
            k = j & (ns - 1)
            vb = vb.copy()
            vb[..., 1:] *= tw[np.arange(1, r)[None, None, :] * ns + k[..., None]]
        vb = _dft_regs_model(vb, inverse)
        if p + 1 < len(g.radices):
            out = ((j // ns) * ns * r + (j & (ns - 1)))[..., None] + ns * np.arange(r)
            smem = np.full((rows, n), np.nan + 0j)
            smem[:, exchange_swizzle(out, ns, r)] = vb
            r2 = g.radices[p + 1]
            j2 = t + T * np.arange(P // r2)[None, :]
            idx = j2[..., None] + (n // r2) * np.arange(r2)
            v = smem[:, exchange_swizzle(idx, ns, r)].reshape(rows, T, P)
        else:
            v = vb.reshape(rows, T, P)
        ns *= r
    out = np.empty_like(z)
    out[:, t + T * out_index(n)[None, :]] = v
    return out


def _planes64(xr, xi=None) -> tuple[np.ndarray, tuple[int, ...]]:
    xr = np.asarray(xr, np.float64)
    z = xr + 1j * (0.0 if xi is None else np.asarray(xi, np.float64))
    return z.reshape(-1, xr.shape[-1]), xr.shape


def fft_pow2_stockham_model(xr, xi=None, inverse: bool = False,
                            scale: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """float64 model of K1/K2 (fft_pow2_kernel) on numpy planes (..., n):
    the kernel's passes with its plan, table indices and exchanges; xi None
    is the real-input mode.  For the CPU tests; no main-path call uses it."""
    z, shape = _planes64(xr, xi)
    y = (_row_dft_model(z, inverse) * scale).reshape(shape)
    return y.real, y.imag


def rfft_packed_model(xr) -> tuple[np.ndarray, np.ndarray]:
    """float64 model of K3 (rfft_pow2_kernel) on a numpy plane (..., n):
    z = x[0::2] + i x[1::2], the kernel's m = n/2-point passes, then its
    split with rfft_table64's W_n^k; bins 0..n/2."""
    x = np.asarray(xr, np.float64)
    n = x.shape[-1]
    m = n // 2
    z = (x[..., 0::2] + 1j * x[..., 1::2]).reshape(-1, m)
    zf = _row_dft_model(z, False)
    k = np.arange(m)
    a, b = zf, np.conj(zf[:, (m - k) & (m - 1)])
    e, d = 0.5 * (a + b), 0.5 * (a - b)
    out = np.empty((z.shape[0], m + 1), np.complex128)
    out[:, :m] = e - 1j * rfft_table64(n)[m:] * d
    out[:, m] = zf[:, 0].real - zf[:, 0].imag
    out = out.reshape(*x.shape[:-1], m + 1)
    return out.real, out.imag


# ---------------------------------------------------------------------------
# Plain versions (any device, any float dtype: the float64 oracle on the card)
# ---------------------------------------------------------------------------


def fft_pow2_plain(xr: torch.Tensor, xi: torch.Tensor | None, inverse: bool = False,
                   scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """scale * DFT (or conjugate-table inverse DFT) of split planes, natural order."""
    z = torch.complex(xr, torch.zeros_like(xr) if xi is None else xi)
    y = four_step_fft(z, inverse)
    if scale != 1.0:
        y = y * scale
    return y.real.contiguous(), y.imag.contiguous()


def ifft_pow2_plain(yr: torch.Tensor, yi: torch.Tensor,
                    scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """scale * inverse DFT of natural-order planes."""
    return fft_pow2_plain(yr, yi, inverse=True, scale=scale)


def rfft_pow2_plain(xr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Bins 0..N/2 of the DFT of a real plane: (..., N/2 + 1) x 2."""
    n = xr.shape[-1]
    yr, yi = fft_pow2_plain(xr, None)
    return yr[..., : n // 2 + 1].contiguous(), yi[..., : n // 2 + 1].contiguous()


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _cuda_plane(t: torch.Tensor, n: int, name: str) -> torch.Tensor:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32 planes, got {t.dtype}")
    if not supported_size(n):
        raise ValueError(f"{name}: unsupported kernel size {n} (pow-2 2..{MAX_N})")
    return t.contiguous()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(xr, xi, inverse: bool, scale: float, name: str):
    """Run fft_pow2_kernel over the rows of xr (and xi)."""
    n = xr.shape[-1]
    xr = _cuda_plane(xr, n, name)
    if xi is not None:
        if xi.shape != xr.shape or xi.device != xr.device:
            raise ValueError(f"{name}: re/im planes must match in shape and device")
        xi = _cuda_plane(xi, n, name)
    yr = torch.empty_like(xr)
    yi = torch.empty_like(yr)
    rows = xr.numel() // n
    if rows == 0:
        return yr, yi
    lib = _build.library()
    with torch.cuda.device(xr.device):
        rc = lib.gdsp_fft_pow2(
            xr.data_ptr(), None if xi is None else xi.data_ptr(),
            yr.data_ptr(), yi.data_ptr(),
            stockham_table(n, inverse, xr.device).data_ptr(),
            n.bit_length() - 1, rows, float(scale), int(inverse), _stream(xr),
        )
    _build.check(rc, name)
    launches[name] += 1
    return yr, yi


def _launch_rfft(xr):
    """Run rfft_pow2_kernel over the rows of xr: bins 0..n/2."""
    n = xr.shape[-1]
    xr = _cuda_plane(xr, n, "rfft_pow2")
    if xr.data_ptr() % 8:  # the kernel reads pairs as 8-byte float2
        xr = xr.clone()
    yr = torch.empty(*xr.shape[:-1], n // 2 + 1, dtype=torch.float32, device=xr.device)
    yi = torch.empty_like(yr)
    rows = xr.numel() // n
    if rows == 0:
        return yr, yi
    lib = _build.library()
    with torch.cuda.device(xr.device):
        rc = lib.gdsp_rfft_pow2(xr.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                                rfft_table(n, xr.device).data_ptr(), n.bit_length() - 1, rows,
                                _stream(xr))
    _build.check(rc, "rfft_pow2")
    launches["rfft_pow2"] += 1
    return yr, yi


def fft_pow2(xr: torch.Tensor, xi: torch.Tensor | None, inverse: bool = False,
             scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """K1: batched scale * DFT over split float32 planes (..., N), natural order.

    xi=None marks a real input (one plane read).  inverse runs the
    conjugate-table transform (unnormalized unless scale says so).
    """
    if xi is None and inverse:
        raise ValueError("real-input mode is forward-only (xi=None)")
    if not xr.is_cuda:
        return fft_pow2_plain(xr, xi, inverse, scale)
    return _launch(xr, xi, inverse, scale, "fft_pow2")


def ifft_pow2(yr: torch.Tensor, yi: torch.Tensor,
              scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """K2: scale * inverse DFT of natural-order float32 planes (..., N)."""
    if not yr.is_cuda:
        return ifft_pow2_plain(yr, yi, scale)
    return _launch(yr, yi, True, scale, "ifft_pow2")


def rfft_pow2(xr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: one-sided DFT of a real float32 plane (..., N) -> (..., N/2 + 1) x 2."""
    if not xr.is_cuda:
        return rfft_pow2_plain(xr)
    return _launch_rfft(xr)
