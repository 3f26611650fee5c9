"""Fused inverse-STFT kernel for Hopper, with its plain version.

Counterpart of godsp_tpu/ops/pallas_istft.py.

  K6 istft_overlap_add(spec, w, nfft, hop, onesided)
     replaces pallas_istft.py: istft_overlap_add (_istft_kernel)

spec (..., F, bins) complex64 in natural bin order, one-sided
(bins = pad//2 + 1, even pad) or full (bins = pad); w the (nfft,)
synthesis window.  Returns (..., (F-1)*hop + nfft) float32, the
un-normalized windowed overlap-add
    y[t] = sum_f w[t - f*hop] * real(ifft_pad(spec_f))[t - f*hop];
the caller divides by the NOLA window-energy sum (models/_stft_impl.py).

The kernel (csrc/istft_kernel.cu, whose header says what bounds it on the
H100) runs a one-sided frame as K3's split run backwards into an m =
pad/2-point inverse on csrc/fft_regs.cuh's register-radix passes, whose
output holds the frame's real samples in pairs (a full frame: the
pad-point inverse, its real part), a frame a warp at pad <= 2048, then
sums the windowed frames of a round into each output sample in frame
order, without atomics, and sums the row's end samples where the window
is small (edge_runs) again in float64.  Here also its host side: the CTA
(istft_cta), the tables (irfft_table), the tiles (tile_frames, CTAs of
bt frames that first recompute the frames reaching into their tile) and
a float64 model of the kernel (istft_regs_model) for the CPU tests; no
main-path call uses the model.  The first design (a block a frame at a
time, radix-2 stages in shared memory) stays as cuda_probes.istft_radix2,
with its own tiles and a wrapper-side stitch of their tails.

Geometry: any pad = 2^k in 2..16384 with pad >= nfft and 0 < hop <= nfft
(the TPU's nfft % 128 and nfft % hop lane rules are not ported).

A wrapper takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from godsp_tpu_torch.ops import _build
from godsp_tpu_torch.ops.cuda_fft import (
    _row_dft_model,
    geometry,
    ifft_pow2_plain,
    out_index,
    rfft_table64,
    stockham_table64,
    supported_size,
)

__all__ = [
    "EDGE_TAU",
    "IstftCta",
    "edge_runs",
    "edge_table",
    "irfft_table",
    "istft_cta",
    "istft_overlap_add",
    "istft_overlap_add_plain",
    "istft_regs_model",
    "istft_supported",
    "launches",
    "overlap_add",
    "run_stride",
    "run_words",
    "tile_frames",
    "window_words",
]

# Kernel launches by wrapper, counted where each launches its kernel.
launches = {"istft_overlap_add": 0}

# Blocks to aim for: four per SM of an H100 (132 SMs).
_TARGET_BLOCKS = 4 * 132
_MAX_FRAMES_PER_TILE = 64
MAX_SMEM = 232448  # bytes of shared memory one block may use (227 KB)
# The window's samples below EDGE_TAU max|w| at each end of a row are summed
# directly in float64 (istft_kernel.cu: kEdgeTau).
EDGE_TAU = 2e-3


def istft_supported(nfft: int, pad: int, hop: int) -> bool:
    """True if the fused ISTFT kernel covers this geometry."""
    return supported_size(pad) and 1 <= nfft <= pad and 0 < hop <= nfft


class IstftCta(NamedTuple):
    """K6's CTA at one pad (gdsp_istft_geometry returns the same on the card)."""

    points: int  # of the row transform: pad/2 one-sided, pad full
    threads: int
    frames: int  # transformed at once, a round
    stride: int  # words of a frame's run in the frame buffer
    exchange: int  # words of the passes' exchange (two planes a frame)
    region: int  # words before the window of partial sums: max(exchange, frames x stride)


@lru_cache(maxsize=None)
def istft_cta(pad: int, onesided: bool = True) -> IstftCta:
    """The CTA of K6 at pad: a frame a warp (eight warps' frames a round,
    Q = 32 / T a warp) while the row transform stays in a warp, else a
    frame a CTA; the frame runs padded by 2T (one-sided pairs) or T (full)
    words where a (half-)warp's store spans several frames, else pad words
    (run_stride adds hop mod 32), the region sized for the longest."""
    if not supported_size(pad):
        raise ValueError(f"istft_cta: pad must be a power of 2 in 2..16384, got {pad}")
    n = pad // 2 if onesided else pad
    g = geometry(n)
    frames = g.default_rows
    threads = 32 * -(-frames // g.q) if g.warp else g.threads
    p = g.points
    one_frame = g.threads >= (16 if onesided else 32)  # a (half-)warp's store: one frame
    if one_frame or p < 2:
        stride = pad
    else:
        stride = pad + (2 if onesided else 1) * g.threads
    exchange = frames * n * 2 if len(g.radices) >= 2 else 0
    fbuf = frames * (pad + 31 if one_frame else stride)
    return IstftCta(n, threads, frames, stride, exchange, max(exchange, fbuf))


def run_stride(pad: int, onesided: bool, hop: int) -> int:
    """Words of a frame's run at this hop: istft_cta's, or, where a
    (half-)warp's store holds one frame, pad + (hop mod 32) (even for the
    one-sided pairs' 8-byte stores), so that the sums read two frames at
    one step on distinct banks."""
    c = istft_cta(pad, onesided)
    one_frame = geometry(c.points).threads >= (16 if onesided else 32)
    return pad + (hop & (30 if onesided else 31)) if one_frame else c.stride


def window_words(pad: int, onesided: bool, nfft: int, hop: int) -> int:
    """Words of the window of partial sums: the power of 2 at least a
    round's span, (frames - 1) hop + nfft."""
    span = (istft_cta(pad, onesided).frames - 1) * hop + nfft
    return 1 << (span - 1).bit_length()


def smem_bytes(pad: int, onesided: bool, nfft: int, hop: int) -> int:
    return 4 * (istft_cta(pad, onesided).region + window_words(pad, onesided, nfft, hop))


def run_words(pad: int, onesided: bool, hop: int) -> np.ndarray:
    """The frame-buffer words each lane of the CTA's first warp writes, a
    warp access a register: (registers, lanes, 2) for the one-sided pairs
    (8-byte stores, words 2j and 2j + 1 of its frame's run), (registers,
    lanes, 1) for the full frame."""
    c = istft_cta(pad, onesided)
    g = geometry(c.points)
    lane = np.arange(min(32, c.threads))
    slot, t = lane // g.threads, lane % g.threads
    j = t[None, :] + out_index(c.points)[:, None] * g.threads  # (P, lanes)
    run = slot[None, :] * run_stride(pad, onesided, hop)
    if onesided:
        return np.stack([run + 2 * j, run + 2 * j + 1], axis=-1)
    return (run + j)[..., None]


def edge_runs(w, nfft: int) -> tuple[int, int]:
    """Samples of the window's leading and trailing runs below EDGE_TAU
    max|w| in float32, each at most nfft // 2: the row's first and last
    samples K6 sums again in float64 (istft_kernel.cu: edge_run).  Hann
    gives 15 at nfft 1024 and 59 at 4096; a window that stays above the
    threshold, none."""
    a = np.abs(np.asarray(w, np.float32)[:nfft])
    thr = np.float32(EDGE_TAU) * (a.max() if a.size else np.float32(0))
    half = nfft // 2

    def run(v):
        big = np.flatnonzero(v[:half] >= thr)
        return int(big[0]) if big.size else half

    return run(a), run(a[::-1])


@lru_cache(maxsize=None)
def irfft_table(pad: int, device: torch.device) -> torch.Tensor:
    """(pad, 2) float32 conjugate of rfft_table64(pad), rounded once: the
    inverse m-point Stockham table, then W_pad^{-k}, k < m = pad/2."""
    tab = np.conj(rfft_table64(pad))
    return torch.from_numpy(np.stack([tab.real, tab.imag], -1).astype(np.float32)).to(device)


@lru_cache(maxsize=None)
def edge_table(pad: int, device: torch.device) -> torch.Tensor:
    """(pad, 2) float64 W_pad^{-k} = exp(2 pi i k / pad), k < pad: the
    edge samples' twiddles (istft_kernel.cu: edge_samples reads entry
    k n mod pad), kept in float64."""
    ang = 2.0 * np.pi * np.arange(pad, dtype=np.float64) / pad
    return torch.from_numpy(np.stack([np.cos(ang), np.sin(ang)], -1)).to(device)


@lru_cache(maxsize=None)
def _inverse_table(pad: int, device: torch.device) -> torch.Tensor:
    """(pad, 2) float32 inverse pad-point Stockham table, rounded once."""
    tab = stockham_table64(pad, True)
    return torch.from_numpy(np.stack([tab.real, tab.imag], -1).astype(np.float32)).to(device)


def tile_frames(n_frames: int, rows: int, nfft: int, hop: int, pad: int,
                onesided: bool = True) -> int:
    """Frames a CTA owns: enough tiles to fill the card, at most 64,
    rounded up so that the recomputed frames before a tile and the tile
    make whole rounds of istft_cta(pad).frames."""
    bt = max(1, min(_MAX_FRAMES_PER_TILE, -(-(n_frames * rows) // _TARGET_BLOCKS)))
    fr = istft_cta(pad, onesided).frames
    e = recomputed_frames(nfft, hop)
    return -(-(bt + e) // fr) * fr - e


def recomputed_frames(nfft: int, hop: int) -> int:
    """Frames before a tile that reach into it: ceil(nfft / hop) - 1."""
    return -(-nfft // hop) - 1


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(..., F, n) frames -> (..., (F-1)*hop + n): frame f added at f*hop.

    Scatter-free and deterministic: the frames are cut into m = ceil(n/hop)
    hop-chunks and chunk k of every frame is added with one shifted slice
    add, m adds in all."""
    F, n = frames.shape[-2:]
    lead = frames.shape[:-2]
    m = -(-n // hop)
    chunks = torch.nn.functional.pad(frames, (0, m * hop - n)).reshape(*lead, F, m, hop)
    out = frames.new_zeros(*lead, F + m - 1, hop)
    for k in range(m):
        out[..., k : k + F, :] += chunks[..., k, :]
    return out.reshape(*lead, (F + m - 1) * hop)[..., : (F - 1) * hop + n]


def istft_overlap_add_plain(spec: torch.Tensor, w: torch.Tensor, nfft: int, hop: int,
                            onesided: bool = True) -> torch.Tensor:
    """Plain torch version of K6: full spectrum materialized, inverse FFT by
    fft/four_step.py, then the scatter-free overlap_add.  Any device and
    dtype (the float64 oracle on the card)."""
    bins = spec.shape[-1]
    pad = 2 * (bins - 1) if onesided else bins
    if onesided:  # the conjugate-symmetric pad-bin spectrum (even pad)
        spec = torch.cat([spec, torch.conj(torch.flip(spec[..., 1:-1], dims=(-1,)))], dim=-1)
    yr, _ = ifft_pow2_plain(spec.real, spec.imag, scale=1.0 / pad)
    return overlap_add(yr[..., :nfft] * w, hop)


def istft_regs_model(spec, w, nfft: int, hop: int, onesided: bool = True,
                     bt: int | None = None) -> np.ndarray:
    """float64 model of K6 (csrc/istft_kernel.cu) on numpy spectra (..., F,
    bins), step by step: a one-sided frame's backward split (bins 0 and m
    taken real), the m-point inverse passes (cuda_fft's row model with the
    inverse table), the pairs as samples 2j, 2j + 1 (a full frame: the
    pad-point inverse passes, the real part), scale 1/pad and the window;
    the row's edge samples (edge_runs: frame 0's first, frame F - 1's last)
    summed directly from the bins (the kernel's edge_samples, in float64);
    then the overlap-add as the CTAs make it: tiles of bt frames
    (tile_frames), each summing into each of its own samples every frame
    that covers it, the recomputed frames before the tile first, in frame
    order.  For the CPU tests; no main-path call uses it."""
    spec = np.asarray(spec, np.complex128)
    w = np.asarray(w, np.float64)
    *lead, F, bins = spec.shape
    pad = 2 * (bins - 1) if onesided else bins
    rows = int(np.prod(lead, dtype=np.int64)) if lead else 1
    x = spec.reshape(rows * F, bins)
    if onesided:
        m = pad // 2
        k = np.arange(m)
        a, b = x[:, k].copy(), x[:, m - k].copy()
        a[:, 0], b[:, 0] = a[:, 0].real, b[:, 0].real
        z = (a + np.conj(b)) + 1j * np.conj(rfft_table64(pad)[m:]) * (a - np.conj(b))
        zt = _row_dft_model(z, True) / pad
        frames = np.stack([zt.real, zt.imag], axis=-1).reshape(rows * F, pad)
    else:
        frames = _row_dft_model(x, True).real / pad
    frames = (frames[:, :nfft] * w[:nfft]).reshape(rows, F, nfft)
    # The row's edge samples, frame 0's leading run and frame F - 1's
    # trailing one: the inverse DFT of the frame's bins summed directly
    # (edge_samples).
    eh, et = edge_runs(w, nfft)
    for f, ns in ((0, np.arange(eh)), (F - 1, np.arange(nfft - et, nfft))):
        k = np.arange(bins)
        tw = np.exp(2j * np.pi * ((k[:, None] * ns[None, :]) % pad) / pad)  # W_pad^{-k n}
        terms = (spec.reshape(rows, F, bins)[:, f, :, None] * tw).real
        if onesided:
            terms[:, 1:-1] *= 2.0  # the mirror bins
        frames[:, f, ns] = terms.sum(axis=1) / pad * w[ns]
    if bt is None:
        bt = tile_frames(F, rows, nfft, hop, pad, onesided)
    e = recomputed_frames(nfft, hop)
    length = (F - 1) * hop + nfft
    y = np.zeros((rows, length))
    for f0 in range(0, F, bt):
        f1 = min(F, f0 + bt)
        lo, hi = f0 * hop, (f1 * hop if f1 < F else length)
        acc = np.zeros((rows, length))
        for f in range(max(0, f0 - e), f1):  # frame order
            acc[:, f * hop:f * hop + nfft] += frames[:, f]
        y[:, lo:hi] = acc[:, lo:hi]
    return y.reshape(*lead, length)


def istft_overlap_add(spec: torch.Tensor, w: torch.Tensor, nfft: int, hop: int,
                      onesided: bool = True) -> torch.Tensor:
    """K6: the un-normalized windowed overlap-add of the spectra's inverse
    FFTs, (..., F, bins) -> (..., (F-1)*hop + nfft)."""
    pad = _check(spec, w, nfft, hop, onesided)
    if not spec.is_cuda:
        return istft_overlap_add_plain(spec, w, nfft, hop, onesided)
    return _launch(spec, w, nfft, hop, onesided, pad, launches, "istft_overlap_add")


def _check(spec, w, nfft: int, hop: int, onesided: bool) -> int:
    if spec.dim() < 2:
        raise ValueError(f"spectra must be (..., F, bins), got {tuple(spec.shape)}")
    bins = spec.shape[-1]
    pad = 2 * (bins - 1) if onesided else bins
    if not istft_supported(nfft, pad, hop):
        raise ValueError(
            f"geometry (nfft={nfft}, pad={pad}, hop={hop}) unsupported by the fused ISTFT kernel"
        )
    if w.shape != (nfft,):
        raise ValueError(f"window must have shape ({nfft},), got {tuple(w.shape)}")
    return pad


def _cuda_args(spec, w, nfft: int, hop: int, name: str):
    """(rows, F, bins, length, spec as (rows, F, bins, 2) float32, w 8-byte
    aligned) for a kernel launch, or None for an empty result."""
    if spec.dtype != torch.complex64 or w.dtype != torch.float32 or w.device != spec.device:
        raise TypeError(f"{name}: spec must be complex64 and w float32 on {spec.device}")
    F, bins = spec.shape[-2:]
    rows = 1
    for d in spec.shape[:-2]:
        rows *= d
    length = (F - 1) * hop + nfft if F else 0
    if F == 0 or rows == 0:
        return None
    if length >= 1 << 31:
        raise ValueError(f"{name}: a row of {length} samples (the kernel indexes a row in 32 bits)")
    s2 = torch.view_as_real(spec.reshape(rows, F, bins).contiguous())
    w = w.contiguous()
    if w.data_ptr() % 8:  # the kernel reads the window as 8-byte pairs
        w = w.clone()
    return rows, F, bins, length, s2, w


def _launch(spec, w, nfft: int, hop: int, onesided: bool, pad: int, counts: dict,
            name: str) -> torch.Tensor:
    """Run K6 on a CUDA tensor, counted in counts[name]."""
    lead = spec.shape[:-2]
    args = _cuda_args(spec, w, nfft, hop, name)
    if args is None:
        length = (spec.shape[-2] - 1) * hop + nfft if spec.shape[-2] else 0
        return torch.zeros(*lead, length, dtype=torch.float32, device=spec.device)
    rows, F, bins, length, s2, w = args
    dev = spec.device
    bt = tile_frames(F, rows, nfft, hop, pad, onesided)
    y = torch.empty(rows, length, dtype=torch.float32, device=dev)
    tw = irfft_table(pad, dev) if onesided else _inverse_table(pad, dev)
    with torch.cuda.device(dev):
        rc = _build.library().gdsp_istft_ola(
            s2.data_ptr(), w.data_ptr(), tw.data_ptr(), edge_table(pad, dev).data_ptr(),
            y.data_ptr(), rows, F, bins, int(onesided), nfft, hop, pad.bit_length() - 1, bt,
            -(-F // bt),
            window_words(pad, onesided, nfft, hop), 1.0 / pad,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, name)
    counts[name] += 1
    return y.reshape(*lead, length)
