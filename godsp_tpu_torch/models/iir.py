"""IIR filtering as a blocked parallel scan, in plain torch.

Port of godsp_tpu/models/iir.py (the reference has no IIR surface;
go-dsp stops at FFT-domain convolution, fft/fft.go:55-69).  The
transposed-direct-form-II recurrence

    s[n] = A s[n-1] + g x[n]          (k = filter order states)
    y[n] = b0 x[n] + s[n-1][0]

runs in two levels, neither of them a loop over samples or blocks:

  1. Within blocks of T samples (default 128) each block's own inputs
     give its outputs and its end state through one matmul of the
     (rows x blocks, T) signal against a (T, T + k) table: the
     causal output kernel (b0 on the diagonal, the impulse response
     above it) beside the block's own end state.  The entering state h
     adds its free response to each output.
  2. Across the B = N/T blocks, h[b+1] = A^T h[b] + pend[b] composes
     associatively: one log-depth scan over (k x k, rows x k) pairs
     (models/_scan.py), 2 log2(B) batched matmul passes.

godsp_tpu keeps the whole TDF-II state (T, k) a sample and reads its
slot 0; the port keeps only what the output and the carries need, and
carries the state in a balanced basis (_balancing), converting zi and zf
at the ends: in float32 the TDF-II carry of a low-cutoff (b, a) filter
loses the output's digits (the layout is free, the result is not).  The
tables are built in float64 numpy on the host, cached per (b, a, T), and
moved to a device once per geometry.
On the card every matmul runs with TF32 off (fft.four_step._tf32_off),
the counterpart of godsp_tpu's precision=HIGHEST (ROADMAP fault class
a).

API mirrors scipy.signal: lfilter (with zi/zf streaming state),
lfilter_zi, lfiltic, sosfilt, sosfilt_zi, sosfiltfilt, filtfilt ('pad'
method, odd extension).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from godsp_tpu_torch._dtypes import (
    as_complex_array,
    as_real_array,
    as_tensor,
    resolve_device,
    working_float,
)
from godsp_tpu_torch.fft.four_step import _tf32_off
from godsp_tpu_torch.models._scan import associative_scan

__all__ = [
    "filtfilt",
    "lfilter",
    "lfilter_zi",
    "sosfilt",
    "sosfilt_zi",
    "sosfiltfilt",
    "lfiltic",
]


def _norm_ba(b, a):
    """float64 (b, a) padded to equal length, a[0] normalized to 1."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if b.ndim != 1 or a.ndim != 1:
        raise ValueError("b and a must be 1-D coefficient vectors")
    if a[0] == 0.0:
        raise ValueError("a[0] must be nonzero")
    n = max(len(b), len(a))
    b = np.pad(b, (0, n - len(b))) / a[0]
    a = np.pad(a, (0, n - len(a))) / a[0]
    return b, a


def _tdf2(b, a):
    """Transposed-direct-form-II state matrices (float64).

    A = companion(a).T (first column -a[1:], ones on the superdiagonal),
    g[i] = b[i+1] - a[i+1] * b[0], y[n] = b0 x[n] + s[n-1][0].
    """
    k = len(a) - 1
    A = np.zeros((k, k))
    A[:, 0] = -a[1:]
    A[: k - 1, 1:] = np.eye(k - 1)
    g = b[1:] - a[1:] * b[0]
    return A, g, b[0]


def _dlyap(A: np.ndarray, G: np.ndarray) -> np.ndarray:
    """X = A X A^T + G, by one Kronecker solve (k <= _BALANCE_MAX_K)."""
    k = A.shape[0]
    x = np.linalg.solve(np.eye(k * k) - np.kron(A, A), G.reshape(-1))
    return x.reshape(k, k)


_BALANCE_MAX_K = 32


def _balancing(A: np.ndarray, g: np.ndarray) -> np.ndarray:
    """Q with s = Q z taking the TDF-II state s to a balanced basis z
    (equal, diagonal controllability and observability Gramians of
    (A, g, e0)); the identity where no balanced basis exists or helps: a
    filter that is not strictly stable, an FIR filter, an uncontrollable
    pair, or more than _BALANCE_MAX_K states.

    Why: for a low cutoff the TDF-II states of the (b, a) form are large
    sums that cancel in y, so a float32 carry loses the output's digits:
    butter(4, 1000, fs=44100) in float32 stays below 110 dB against scipy
    in float64 with the carry in TDF-II and reaches 130 dB in the
    balanced basis (tests/test_torch_iir.py); float64 results are
    unchanged beyond rounding."""
    k = A.shape[0]
    eye = np.eye(k)
    if k > _BALANCE_MAX_K or not np.any(A[:, 0]):
        return eye
    try:
        if np.max(np.abs(np.linalg.eigvals(A))) >= 1.0:
            return eye
        Wc = _dlyap(A, np.outer(g, g))
        Wo = _dlyap(A.T, np.outer(eye[0], eye[0]))
        L = np.linalg.cholesky(Wc)
        U, sv, _ = np.linalg.svd(L.T @ Wo @ L)
        Q = L @ U @ np.diag(sv ** -0.25)
        if not np.all(np.isfinite(Q)) or np.linalg.cond(Q) > 1e6:
            return eye
    except np.linalg.LinAlgError:
        return eye
    return Q


@lru_cache(maxsize=None)
def _block_tables(ba_key, T: int):
    """Host float64 tables for one (b, a, T) geometry, in the basis z of
    _balancing (s = Q z).

    Returns (W (T, T + k): columns 0..T-1 the causal output kernel
    W[j, m] = d(y[m])/d(x[j]), columns T.. the end-state kernel
    Az^(T-1-j) gz; C (T, k): row m = c Az^m, the entering state's share
    of y[m]; AzT = Az^T; Qi = Q^-1 (zi into z); V (T, k): V[d] = Az^d gz;
    Pw (T + 1, k, k): Pw[d] = Az^d; Q)."""
    b, a = ba_key
    A, g, b0 = _tdf2(np.asarray(b), np.asarray(a))
    Q = _balancing(A, g)
    Qi = np.linalg.inv(Q)
    Az, gz, c = Qi @ A @ Q, Qi @ g, Q[0]
    k = A.shape[0]
    V = np.empty((T, k))
    Pw = np.empty((T + 1, k, k))
    Pw[0] = np.eye(k)
    V[0] = gz
    for d in range(1, T + 1):
        Pw[d] = Az @ Pw[d - 1]
        if d < T:
            V[d] = Az @ V[d - 1]
    m = np.arange(T)
    d = m[None, :] - 1 - m[:, None]  # output m from input j: c Az^(m-1-j) gz
    W = np.zeros((T, T + k))
    W[:, :T] = np.where(d >= 0, (V @ c)[d.clip(min=0)], 0.0)
    W[m, m] = b0
    W[:, T:] = V[T - 1 - m]
    return W, np.einsum("i,mij->mj", c, Pw[:T]), Pw[T], Qi, V, Pw, Q


@lru_cache(maxsize=None)
def _device_tables(ba_key, T: int, device: torch.device, dtype: torch.dtype):
    """(W, C, AzT, Qi) of _block_tables on `device`, moved there once."""
    return tuple(torch.from_numpy(t).to(device=device, dtype=dtype)
                 for t in _block_tables(ba_key, T)[:4])


def _carry_combine(lo, hi):
    """(M2, v2) o (M1, v1) = (M2 M1, M2 v1 + v2); v rows of states."""
    M1, v1 = lo
    M2, v2 = hi
    return torch.matmul(M2, M1), torch.matmul(v1, M2.transpose(-1, -2)) + v2


def _carry_scan(AT, pend, zi):
    """h[b] = state entering block b (h[0] = zi), via associative scan.

    pend: (B, r, k) = each block's own-input state at its last sample;
    returns (B, r, k).
    """
    B = pend.shape[0]
    Ms = AT.expand(B, *AT.shape)
    Mc, vc = associative_scan(_carry_combine, (Ms, pend))
    # exclusive: block b sees the composition of blocks 0..b-1 applied
    # to zi; block 0 sees zi itself.
    hz = torch.matmul(zi, Mc[:-1].transpose(-1, -2)) + vc[:-1]
    return torch.cat([zi[None], hz], dim=0)


def _lfilter_core(x2, zi2, ba_key, T: int, N: int):
    """x2: (r, B*T) zero-padded; zi2: (r, k) TDF-II.  Returns (y (r, N), zf (r, k))."""
    W, C, AT, Qi = _device_tables(ba_key, T, x2.device, x2.dtype)
    r = x2.shape[0]
    B = x2.shape[1] // T
    X = x2.reshape(r, B, T)
    with _tf32_off():
        own = torch.matmul(X, W)  # (r, B, T + k): outputs and end states
        h = _carry_scan(AT, own[:, :, T:].transpose(0, 1), torch.matmul(zi2, Qi.T))
        y = own[:, :, :T] + torch.matmul(h.transpose(0, 1), C.T)
        # zf: the TDF-II state after sample N - 1, in block bl at position m.
        bl, m = divmod(N - 1, T)
        _, _, _, _, V, Pw, Q = _block_tables(ba_key, T)
        tail = Q @ np.concatenate([Pw[m + 1], V[m::-1].T], axis=1)  # (k, k + m + 1)
        zf = torch.matmul(torch.cat([h[bl], X[:, bl, : m + 1]], dim=1),
                          torch.from_numpy(tail.T).to(device=x2.device, dtype=x2.dtype))
    return y.reshape(r, B * T)[:, :N], zf


def _resolve_block(N: int, T: int | None) -> int:
    if T is None:
        T = 128
    return max(8, min(T, int(N)))


def lfilter(b, a, x, zi=None, axis: int = -1, block_size: int | None = None):
    """Apply the IIR/FIR filter (b, a) along `axis` of x.

    scipy.signal.lfilter semantics: returns y, or (y, zf) when an
    initial state zi (shape (..., max(len(a), len(b)) - 1), transposed
    direct-form II) is given — feeding zf of one chunk as zi of the
    next streams a long signal in blocks with exact continuity.
    block_size tunes the internal matmul tile (default 128 samples).
    Host x lands on default_device(); a CUDA float64 x runs in float32.
    """
    bn, an = _norm_ba(b, a)
    ba_key = (tuple(bn.tolist()), tuple(an.tolist()))
    k = len(an) - 1
    x = as_tensor(x)
    if x.dtype.is_complex:
        x = as_complex_array(x)
        zr = zim = None
        if zi is not None:
            z = as_complex_array(zi, device=x.device)
            zr, zim = z.real, z.imag
        yr = lfilter(bn, an, x.real, zr, axis, block_size)
        yi = lfilter(bn, an, x.imag, zim, axis, block_size)
        if zi is None:
            return torch.complex(yr, yi)
        return torch.complex(yr[0], yi[0]), torch.complex(yr[1], yi[1])
    x = as_real_array(x).movedim(axis, -1)
    lead, N = tuple(x.shape[:-1]), x.shape[-1]
    if N == 0:
        raise ValueError("x must have at least one sample along axis")
    if k == 0:
        # Pure gain (len(b) == len(a) == 1): no state.
        y = (float(bn[0]) * x).movedim(-1, axis)
        if zi is None:
            return y
        return y, torch.zeros(lead + (0,), dtype=x.dtype, device=x.device)

    r = int(np.prod(lead, dtype=np.int64)) if lead else 1
    x2 = x.reshape(r, N)
    want_zf = zi is not None
    if zi is None:
        zi2 = torch.zeros(r, k, dtype=x.dtype, device=x.device)
    else:
        zi2 = as_tensor(zi, device=x.device).to(x.dtype).expand(lead + (k,)).reshape(r, k)
    T = _resolve_block(N, block_size)
    pad = (-N) % T
    if pad:
        x2 = torch.nn.functional.pad(x2, (0, pad))
    y2, zf2 = _lfilter_core(x2, zi2, ba_key, T, N)
    y = y2.reshape(lead + (N,)).movedim(-1, axis)
    if not want_zf:
        return y
    return y, zf2.reshape(lead + (k,))


def _lfilter_zi_np(b, a) -> np.ndarray:
    bn, an = _norm_ba(b, a)
    A, g, _ = _tdf2(bn, an)
    k = A.shape[0]
    if k == 0:
        return np.zeros(0)
    # steady state: s = A s + g  =>  (I - A) s = g; y offset handled by
    # the b0 feed-through exactly as scipy does.
    return np.linalg.solve(np.eye(k) - A, g)


def _on_default(zi: np.ndarray) -> torch.Tensor:
    dev = resolve_device()
    return torch.from_numpy(zi).to(device=dev, dtype=working_float(dev))


def lfilter_zi(b, a):
    """Steady-state TDF-II initial conditions for a unit step input
    (scipy.signal.lfilter_zi): lfilter(b, a, ones, zi=zi * x[0]) starts
    with no transient.  Solved in float64 on the host; returned on
    default_device()."""
    return _on_default(_lfilter_zi_np(b, a))


def sosfilt(sos, x, zi=None, axis: int = -1, block_size: int | None = None):
    """Cascade of second-order sections (scipy.signal.sosfilt).

    sos: (n_sections, 6); zi: (n_sections, ..., 2).  Returns y, or
    (y, zf) when zi is given."""
    sos = np.asarray(sos, np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError("sos must have shape (n_sections, 6)")
    y = x
    zfs = []
    for i, sec in enumerate(sos):
        zi_i = None if zi is None else zi[i]
        out = lfilter(sec[:3], sec[3:], y, zi_i, axis, block_size)
        if zi is None:
            y = out
        else:
            y, zf = out
            zfs.append(zf)
    if zi is None:
        return y
    return y, torch.stack(zfs, dim=0)


def _sosfilt_zi_np(sos) -> np.ndarray:
    sos = np.asarray(sos, np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError("sos must have shape (n_sections, 6)")
    zi = np.empty((sos.shape[0], 2))
    scale = 1.0
    for i, sec in enumerate(sos):
        b, a = _norm_ba(sec[:3], sec[3:])
        zi[i] = scale * _lfilter_zi_np(b, a)
        scale *= b.sum() / a.sum()
    return zi


def sosfilt_zi(sos):
    """Steady-state initial conditions for sosfilt under a unit step
    (scipy.signal.sosfilt_zi): per-section lfilter_zi scaled by the
    cumulative DC gain of the preceding sections.  Shape
    (n_sections, 2), solved in float64 on the host, returned on
    default_device()."""
    return _on_default(_sosfilt_zi_np(sos))


def _odd_extend(x: torch.Tensor, edge: int) -> torch.Tensor:
    """2*x[0] - x[edge..1], x, 2*x[-1] - x[-2..-edge-1] along the last axis."""
    if edge == 0:
        return x
    head = 2.0 * x[..., :1] - x[..., 1 : edge + 1].flip(-1)
    tail = 2.0 * x[..., -1:] - x[..., -edge - 1 : -1].flip(-1)
    return torch.cat([head, x, tail], dim=-1)


def _as_signal(x, axis: int) -> torch.Tensor:
    x = as_tensor(x)
    x = as_complex_array(x) if x.dtype.is_complex else as_real_array(x)
    return x.movedim(axis, -1)


def sosfiltfilt(sos, x, axis: int = -1, padlen: int | None = None,
                block_size: int | None = None):
    """Zero-phase forward-backward SOS filtering (scipy.signal.sosfiltfilt,
    padtype='odd')."""
    sos = np.asarray(sos, np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError("sos must have shape (n_sections, 6)")
    n_sections = sos.shape[0]
    if padlen is None:
        # scipy's default: 3 * (2*n_sections + 1 - min(trailing zero
        # counts of the b and a sides))
        ntaps = 2 * n_sections + 1
        ntaps -= min((sos[:, 2] == 0).sum(), (sos[:, 5] == 0).sum())
        edge = int(3 * ntaps)
    else:
        edge = int(padlen)
    x = _as_signal(x, axis)
    N = x.shape[-1]
    if edge >= N:
        raise ValueError(
            f"padlen ({edge}) must be less than the signal length ({N})"
        )
    ext = _odd_extend(x, edge)
    zi = torch.from_numpy(_sosfilt_zi_np(sos)).to(device=ext.device, dtype=ext.dtype)
    zi_shaped = zi.reshape((n_sections,) + (1,) * (ext.dim() - 1) + (2,))
    y, _ = sosfilt(sos, ext, zi=zi_shaped * ext[None, ..., :1],
                   block_size=block_size)
    y = y.flip(-1)
    y, _ = sosfilt(sos, y, zi=zi_shaped * y[None, ..., :1],
                   block_size=block_size)
    y = y.flip(-1)
    if edge > 0:
        y = y[..., edge:-edge]
    return y.movedim(-1, axis)


def filtfilt(b, a, x, axis: int = -1, padlen: int | None = None,
             block_size: int | None = None):
    """Zero-phase forward-backward filtering (scipy.signal.filtfilt,
    method='pad', padtype='odd')."""
    bn, an = _norm_ba(b, a)
    ntaps = len(bn)
    edge = 3 * ntaps if padlen is None else int(padlen)
    x = _as_signal(x, axis)
    N = x.shape[-1]
    if edge >= N:
        raise ValueError(
            f"padlen ({edge}) must be less than the signal length ({N})"
        )
    ext = _odd_extend(x, edge)
    zi = torch.from_numpy(_lfilter_zi_np(bn, an)).to(device=ext.device, dtype=ext.dtype)
    y, _ = lfilter(bn, an, ext, zi=zi * ext[..., :1], block_size=block_size)
    y = y.flip(-1)
    y, _ = lfilter(bn, an, y, zi=zi * y[..., :1], block_size=block_size)
    y = y.flip(-1)
    if edge > 0:
        y = y[..., edge:-edge]
    return y.movedim(-1, axis)


def lfiltic(b, a, y, x=None) -> np.ndarray:
    """Initial conditions zi for lfilter given past outputs y (newest
    first) and optional past inputs x (scipy.signal.lfiltic): the
    direct-II-transposed state
    zi[m] = sum_i b[i+m+1] x[i] - sum_i a[i+m+1] y[i]."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if a[0] == 0:
        raise ValueError("a[0] must be nonzero")
    b = b / a[0]
    a = a / a[0]
    Nn = len(a) - 1
    Mm = len(b) - 1
    K = max(Mm, Nn)
    y = np.atleast_1d(np.asarray(y, np.float64))[:Nn]
    x = (np.zeros(0) if x is None
         else np.atleast_1d(np.asarray(x, np.float64)))[:Mm]
    zi = np.zeros(K)
    for m in range(K):
        for i, xi in enumerate(x):
            if m + 1 + i <= Mm:
                zi[m] += b[m + 1 + i] * xi
        for i, yi in enumerate(y):
            if m + 1 + i <= Nn:
                zi[m] -= a[m + 1 + i] * yi
    return zi
