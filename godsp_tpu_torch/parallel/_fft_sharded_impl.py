"""Tensor-parallel FFT: one giant transform cut across the mesh's "sp" axis.

Port of godsp_tpu/parallel/_fft_sharded_impl.py.  A single N-point DFT
factored N = p x N2 (p = number of "sp" shards), so each shard computes
local batched FFTs while the data between shards moves by the
collectives of parallel/_collectives.py:

  X[i1, i2] = x[N2*i1 + i2]  (i1 = shard, i2 local)
  step 1:    A[k1, i2] = sum_i1 F1[k1, i1] X[i1, i2]
             - even path (N2 % p == 0): all_to_all block transpose so
               each shard holds all i1 for an i2 slice, a local p x p
               contraction, then all_to_all back;
             - uneven path (any N % p == 0): each shard forms its
               F1-column outer product F1[:, i1] * X[i1, :] and one
               psum_scatter hands shard k1 its reduced row;
  step 2:    B = A * W_N^{k1 i2}  (tables split exactly in float64)
  step 3:    Y[k1, k2] = FFT_N2(B[k1, :])[k2]  (local: fft/pow2.py, the
             K1/K2 kernels or, above 16384, the large plan's K8 + rows)
  output:    Y[k1 + p*k2] — "digit" shard order; order="natural"
             makes one more all_to_all block transpose.

Leading axes are batched and carried on every shard.  The p-point DFT is
a contraction over float64-built tables in the working complex type
(TF32 off).  The result is one tensor on the mesh's first device: each
shard's rows are written into it directly when every shard shares that
device, gathered there from distinct cards.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from godsp_tpu_torch._dtypes import as_complex_array
from godsp_tpu_torch.dsputils.utils import is_power_of_2
from godsp_tpu_torch.fft.four_step import _tf32_off
from godsp_tpu_torch.fft.pow2 import pow2_fft
from godsp_tpu_torch.parallel import _collectives as coll
from godsp_tpu_torch.parallel.mesh import Mesh

__all__ = ["fft_sharded"]


@lru_cache(maxsize=None)
def _f1_twiddle(p: int, inverse: bool) -> np.ndarray:
    """F1[k1, i1] = W_p^{k1 i1} (conjugated for the inverse), float64."""
    k1 = np.arange(p, dtype=np.float64)
    f1 = np.exp(-2j * np.pi * np.outer(k1, k1) / p)
    return np.conj(f1) if inverse else f1


@lru_cache(maxsize=None)
def _twiddle_tables(p: int, n2: int, inverse: bool):
    """Exact float64 split of the step-2 twiddle W_N^{k1 * i2} for the
    all_to_all slices (m = n2 // p): with i2 = s*m + t,
      row[s, k1] = W_N^{k1 * s * m}   (indexed by shard s)
      col[k1, t] = W_N^{k1 * t}       (shared)."""
    n = p * n2
    m = n2 // p
    w = -2j * np.pi / n
    k1 = np.arange(p, dtype=np.float64)
    col = np.exp(w * np.outer(k1, np.arange(m, dtype=np.float64)))
    row = np.exp(w * np.outer(k1 * m, k1))  # [s, k1] = W^{k1 s m}
    if inverse:
        col, row = np.conj(col), np.conj(row)
    return col, row


@lru_cache(maxsize=None)
def _twiddle_full_row(p: int, n2: int, inverse: bool) -> np.ndarray:
    """Uneven path: T[k1, i2] = W_N^{k1 i2}, float64, indexed by shard."""
    n = p * n2
    k1 = np.arange(p, dtype=np.float64)
    i2 = np.arange(n2, dtype=np.float64)
    t = np.exp(-2j * np.pi * np.outer(k1, i2) / n)
    return np.conj(t) if inverse else t


@lru_cache(maxsize=None)
def _device_tables(p: int, n2: int, inverse: bool, even: bool, device: torch.device,
                   dtype: torch.dtype):
    """F1 and the step-2 tables on device in dtype, uploaded once per
    geometry, as godsp_tpu embeds its tables at trace time: (F1, row,
    col) on the even path, (F1, T) on the uneven one."""
    up = lambda a: torch.from_numpy(a).to(device, dtype)
    f1 = up(_f1_twiddle(p, inverse))
    if even:
        col, row = _twiddle_tables(p, n2, inverse)
        return f1, up(row), up(col)
    return f1, up(_twiddle_full_row(p, n2, inverse))


def fft_sharded(
    x,
    mesh: Mesh,
    inverse: bool = False,
    order: str = "natural",
) -> torch.Tensor:
    """DFT of the trailing axis of x, cut over the mesh's "sp" axis.

    x: (..., N) complex or real with N % p == 0 and N/p a power of 2;
    leading axes are batched.  Host data goes to the mesh's first device.
    Returns the unnormalized forward (or conjugated inverse) DFT on the
    mesh's first device.  order="natural" gives standard bin order;
    order="digit" skips the final transpose and returns Y[k1 + p*k2] at
    position k1*N2 + k2.  The inverse conjugates the tables and does NOT
    apply 1/N (scale externally, as the public ifft would).
    """
    if order not in ("natural", "digit"):
        raise ValueError(f"unknown order: {order}")
    x = as_complex_array(x, None if isinstance(x, torch.Tensor) else mesh.first)
    n = x.shape[-1]
    devices = mesh.devices[0]
    p = len(devices)
    if n % p != 0:
        raise ValueError(f"N={n} must be divisible by the shard count p={p}")
    n2 = n // p
    if not is_power_of_2(n2):
        raise ValueError(f"local length N/p={n2} must be a power of 2")
    lead = x.shape[:-1]
    b = x.numel() // n if n else 0
    xs = coll.shard_time(x.reshape(b, n), devices)  # X[i1, :] on shard i1: (b, n2)

    with _tf32_off():
        if n2 % p == 0:
            rows = _even_rows(xs, p, n2, inverse)
        else:
            rows = _uneven_rows(xs, p, n2, inverse)
    ys = [pow2_fft(r, inverse=inverse) for r in rows]  # shard k1: Y[k1 + p*k2]

    out = torch.empty(b, n, dtype=x.dtype, device=mesh.first)
    if order == "digit":
        for k, y in enumerate(ys):
            out[:, k * n2 : (k + 1) * n2].copy_(y)
    elif n2 % p == 0:
        # All_to_all of the (p, n2/p) digit blocks, then a local transpose:
        # shard j gets bins j*n2 .. (j+1)*n2 in natural order.
        got = coll.all_to_all([y.reshape(b, p, n2 // p) for y in ys], axis=1)
        for j, g in enumerate(got):
            out[:, j * n2 : (j + 1) * n2].view(b, n2 // p, p).copy_(g.transpose(1, 2))
    else:
        gathered = coll.all_gather(ys, mesh.first)  # (p, b, n2)
        g = torch.arange(n, device=mesh.first)
        out.copy_(gathered[g % p, :, g // p].transpose(0, 1))
    return out.reshape(*lead, n)


def _even_rows(xs, p: int, n2: int, inverse: bool) -> list[torch.Tensor]:
    """Steps 1-2 on the all_to_all path: shard k1 ends with B[k1, :] (b, n2)."""
    b = xs[0].shape[0]
    cols = coll.all_to_all([x.reshape(b, p, n2 // p) for x in xs], axis=1)
    out = []
    for s, c in enumerate(cols):  # c[:, i1, t] = X[i1, s*(n2/p) + t]
        f1, row, col = _device_tables(p, n2, inverse, True, c.device, c.dtype)
        out.append(torch.einsum("ki,bin->bkn", f1, c) * (row[s][:, None] * col))
    return [r.reshape(b, n2) for r in coll.all_to_all(out, axis=1)]


def _uneven_rows(xs, p: int, n2: int, inverse: bool) -> list[torch.Tensor]:
    """Steps 1-2 by one psum_scatter of the F1-column outer products."""
    contrib = []
    for i, x in enumerate(xs):
        f1, _ = _device_tables(p, n2, inverse, False, x.device, x.dtype)
        contrib.append(torch.einsum("k,bn->kbn", f1[:, i], x))
    rows = coll.psum_scatter(contrib)  # shard k1: (b, n2)
    return [r * _device_tables(p, n2, inverse, False, r.device, r.dtype)[1][k]
            for k, r in enumerate(rows)]
