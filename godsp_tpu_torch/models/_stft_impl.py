"""Short-time Fourier transform, inverse, and spectrogram.

Port of godsp_tpu/models/_stft_impl.py.  The reference library stops at
Welch PSD (spectral/pwelch.go); STFT/ISTFT/spectrogram use the same
framing/window/FFT machinery (spectral.Segment's geometry,
spectral.go:26-33, and window/window.go tapers) but keep per-frame
spectra instead of averaging them.

Routes.  A CUDA float32 input at a supported geometry runs the fused
kernels while fft.kernels_enabled(): K5 (ops/cuda_stft.py) for the
one-sided stft, the power spectrogram and the mel front end, at any
stride (on the TPU an odd hop needed frames cut in XLA first), and K6
(ops/cuda_istft.py) for the overlap-add of istft and the streaming
synthesis.  Every other input takes the unfused route: frames in torch,
the FFT through fft.core (the FFT kernels on CUDA, Bluestein for other
lengths), a scatter-free overlap-add.  Both routes give the same result.

Everything batches over leading axes and runs on the input's device;
host data becomes a CPU tensor, or goes to the `device` the streaming
classes are given.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from godsp_tpu_torch import window as win
from godsp_tpu_torch._dtypes import (
    as_complex_array,
    as_real_array,
    as_tensor,
    resolve_device,
    working_float,
)
from godsp_tpu_torch.dsputils.utils import zero_pad
from godsp_tpu_torch.fft.core import fft_real, ifft
from godsp_tpu_torch.fft.pow2 import kernels_enabled
from godsp_tpu_torch.ops import cuda_istft, cuda_stft
from godsp_tpu_torch.ops.cuda_istft import overlap_add
from godsp_tpu_torch.spectral._pwelch_impl import fused_path_eligible

__all__ = [
    "StreamingISTFT",
    "StreamingSTFT",
    "check_cola",
    "check_nola",
    "istft",
    "spectrogram",
    "stft",
    "stft_frames",
    "stream_istft",
    "stream_stft",
    "check_COLA",
    "check_NOLA",
]

WindowSpec = Union[str, Callable[[int], torch.Tensor], None]


def _overlap_bin_sums(w: np.ndarray, step: int) -> np.ndarray:
    """sum_k w[i + k*step] over one step period (float64 host math)."""
    nper = w.shape[0]
    sums = np.zeros(step)
    for start in range(0, nper, step):
        seg = w[start : start + step]
        sums[: seg.shape[0]] += seg
    return sums


def check_cola(window: WindowSpec, nperseg: int, noverlap: int,
               tol: float = 1e-10) -> bool:
    """Whether (window, hop) satisfies the Constant-OverLap-Add
    constraint (scipy.signal.check_COLA): shifted copies of the window
    sum to a constant, so an unwindowed inverse STFT is exact."""
    nperseg, noverlap = int(nperseg), int(noverlap)
    if nperseg < 1 or not 0 <= noverlap < nperseg:
        raise ValueError("need nperseg >= 1 and 0 <= noverlap < nperseg")
    w = win.window_table_np(window if window is not None else win.hann, nperseg)
    sums = _overlap_bin_sums(w, nperseg - noverlap)
    return bool(np.max(np.abs(sums - np.median(sums))) < tol)


def check_nola(window: WindowSpec, nperseg: int, noverlap: int,
               tol: float = 1e-10) -> bool:
    """Whether (window, hop) satisfies the NOnzero-OverLap-Add
    constraint (scipy.signal.check_NOLA): shifted squared windows sum
    strictly above tol everywhere, so the windowed-normalized istft
    inverts the stft."""
    nperseg, noverlap = int(nperseg), int(noverlap)
    if nperseg < 1 or not 0 <= noverlap < nperseg:
        raise ValueError("need nperseg >= 1 and 0 <= noverlap < nperseg")
    w = win.window_table_np(window if window is not None else win.hann, nperseg)
    sums = _overlap_bin_sums(w * w, nperseg - noverlap)
    return bool(np.min(sums) > tol)


def _resolve_window(window: WindowSpec, nfft: int, dtype, device) -> torch.Tensor:
    wf = window if window is not None else win.hann
    return win.window_table(wf, nfft, device=device, dtype=dtype)


def stft_frames(x, nfft: int, hop: int) -> torch.Tensor:
    """Frame a signal into overlapping segments (..., frames, nfft).

    Same geometry as spectral.Segment (spectral.go:26-33): frame count is
    (L - nfft)//hop + 1; trailing remainder samples are dropped.
    """
    if hop <= 0:
        raise ValueError("hop must be positive")
    x = as_tensor(x)
    L = x.shape[-1]
    if L < nfft:
        raise ValueError(f"signal length {L} < nfft {nfft}")
    n_frames = (L - nfft) // hop + 1
    idx = torch.arange(n_frames, device=x.device)[:, None] * hop + torch.arange(
        nfft, device=x.device)
    return x[..., idx]


def _stft_unfused(x, w, nfft: int, hop: int, pad: int, onesided: bool) -> torch.Tensor:
    """Frames windowed, zero-extended to pad, FFT'd through fft.core."""
    frames = stft_frames(x, nfft, hop) * w
    if pad > nfft:
        frames = zero_pad(frames, pad)
    spec = fft_real(frames)
    if onesided:
        spec = spec[..., : pad // 2 + 1]
    return spec


def _fused_window(w: torch.Tensor, pad: int) -> torch.Tensor:
    """NFFT-length window zero-extended to pad: the fused kernel windows
    AFTER zero-extension, so this reproduces stft's window-then-pad
    semantics exactly."""
    return torch.nn.functional.pad(w, (0, pad - w.shape[0]))


def stft(
    x,
    nfft: int,
    hop: Optional[int] = None,
    window: WindowSpec = None,
    pad: Optional[int] = None,
    onesided: bool = True,
) -> torch.Tensor:
    """Short-time Fourier transform of a real signal.

    x: (..., L) real.  Returns (..., n_frames, bins) complex with
    n_frames = (L - nfft)//hop + 1 and bins = pad//2 + 1 (one-sided) or
    pad.  Defaults: hop = nfft//2, window = Hann, pad = nfft — matching
    Pwelch's conventions (pwelch.go:85-95) so stft |.|^2 averages
    reproduce pwelch exactly.
    """
    x = as_real_array(x)
    hop = nfft // 2 if hop is None else hop
    if hop <= 0:
        raise ValueError("hop must be positive")
    pad = pad or nfft
    if pad < nfft:
        raise ValueError("pad must be >= nfft")
    w = _resolve_window(window, nfft, x.dtype, x.device)
    if onesided and x.shape[-1] >= nfft and fused_path_eligible(x, nfft, pad, hop):
        n_frames = (x.shape[-1] - nfft) // hop + 1
        return cuda_stft.stft_complex(x, _fused_window(w, pad), nfft, hop, n_frames, pad=pad)
    return _stft_unfused(x, w, nfft, hop, pad, onesided)


def _mirror_full_spectrum(spec: torch.Tensor, pad: int) -> torch.Tensor:
    """One-sided (..., F, pad//2+1) complex -> full conjugate-symmetric
    pad-bin spectrum; odd pad has no real Nyquist bin (scipy irfft(n))."""
    mirrored = spec[..., 1:-1] if pad % 2 == 0 else spec[..., 1:]
    return torch.cat([spec, torch.conj(torch.flip(mirrored, dims=(-1,)))], dim=-1)


def _nola_norm(w: torch.Tensor, n_frames: int, hop: int, length: int) -> torch.Tensor:
    """Least-squares denominator sum_f w^2[t - f*hop], length samples,
    floored at finfo(w.dtype).tiny.  The m = ceil(nfft/hop) hop-chunks of
    w^2 are added with one shifted slice add each (no scatter)."""
    nfft = w.shape[0]
    m = -(-nfft // hop)
    chunks = torch.nn.functional.pad(w * w, (0, m * hop - nfft)).reshape(m, hop)
    acc = w.new_zeros(n_frames + m - 1, hop)
    for k in range(m):
        acc[k : k + n_frames] += chunks[k]
    norm = zero_pad(acc.reshape(-1)[:length], length)
    return torch.clamp_min(norm, torch.finfo(w.dtype).tiny)


def _istft_fused_eligible(spec: torch.Tensor, nfft: int, pad: int, hop: int) -> bool:
    """True when K6 serves this geometry for spec: a CUDA complex64 tensor
    while the kernels are on, pow-2 pad <= 16384, 0 < hop <= nfft."""
    return (
        spec.is_cuda
        and spec.dtype == torch.complex64
        and kernels_enabled()
        and cuda_istft.istft_supported(nfft, pad, hop)
    )


def _ola_unnorm_plain(spec, w, nfft: int, hop: int, pad: int, onesided: bool) -> torch.Tensor:
    """Un-normalized windowed overlap-add over the covered span: the
    inverse FFT through fft.core, then the scatter-free overlap_add."""
    if onesided:
        spec = _mirror_full_spectrum(spec, pad)
    return overlap_add(ifft(spec).real[..., :nfft] * w, hop)


def _ola_unnorm(spec, w, nfft: int, hop: int, pad: int, onesided: bool,
                fused: bool) -> torch.Tensor:
    """Un-normalized windowed OLA: K6, or the unfused route."""
    if fused:
        return cuda_istft.istft_overlap_add(spec, w, nfft, hop, onesided)
    return _ola_unnorm_plain(spec, w, nfft, hop, pad, onesided)


def istft(
    spec,
    nfft: int,
    hop: Optional[int] = None,
    window: WindowSpec = None,
    length: Optional[int] = None,
    onesided: bool = True,
    pad: Optional[int] = None,
) -> torch.Tensor:
    """Inverse STFT by weighted overlap-add (least-squares synthesis).

    spec: (..., n_frames, bins) complex from stft() with the same nfft,
    hop, and window.  Reconstructs the signal over the covered span
    (length defaults to (n_frames-1)*hop + nfft); exact wherever the
    window overlap satisfies NOLA (non-zero overlapped sum), e.g. Hann
    with hop <= nfft/2:
    y[t] = sum_f w*frames_f[t - f*hop] / sum_f w^2[t - f*hop].

    pad disambiguates the one-sided FFT length (as scipy's irfft takes
    n): bins = pad//2 + 1 holds for both pad = 2*(bins-1) and the odd
    pad = 2*bins - 1.  Defaults to the even choice; pass the stft call's
    pad explicitly when it was odd.
    """
    spec = as_complex_array(spec)
    hop = nfft // 2 if hop is None else hop
    if hop <= 0:
        raise ValueError("hop must be positive")
    bins = spec.shape[-1]
    if onesided:
        pad = pad if pad is not None else 2 * (bins - 1)
        if pad // 2 + 1 != bins:
            raise ValueError(
                f"pad={pad} inconsistent with {bins} one-sided bins "
                f"(need pad//2 + 1 == bins)"
            )
    else:
        if pad is not None and pad != bins:
            raise ValueError(f"pad={pad} != two-sided bin count {bins}")
        pad = bins
    n_frames = spec.shape[-2]
    length = length or (n_frames - 1) * hop + nfft
    w = _resolve_window(window, nfft, spec.real.dtype, spec.device)
    fused = n_frames > 0 and _istft_fused_eligible(spec, nfft, pad, hop)
    y = _ola_unnorm(spec, w, nfft, hop, pad, onesided, fused)
    span = (n_frames - 1) * hop + nfft
    y = zero_pad(y, length) if length > span else y[..., :length]
    return y / _nola_norm(w, n_frames, hop, length)


def spectrogram(
    x,
    nfft: int,
    hop: Optional[int] = None,
    window: WindowSpec = None,
    pad: Optional[int] = None,
    scale: str = "power",
) -> torch.Tensor:
    """Magnitude spectrogram (..., n_frames, pad//2+1).

    scale: "power" -> |X|^2, "magnitude" -> |X|, "db" -> 10 log10(|X|^2)
    floored at -200 dB.  On the fused route no complex spectrum is
    written to device memory (K5's power mode).
    """
    if scale not in ("power", "magnitude", "db"):
        raise ValueError(f"unknown scale: {scale}")
    x = as_real_array(x)
    hop = nfft // 2 if hop is None else hop
    if hop <= 0:
        raise ValueError("hop must be positive")
    pad_r = pad or nfft
    if x.shape[-1] >= nfft and fused_path_eligible(x, nfft, pad_r, hop):
        w = _resolve_window(window, nfft, x.dtype, x.device)
        n_frames = (x.shape[-1] - nfft) // hop + 1
        p = cuda_stft.stft_power(x, _fused_window(w, pad_r), nfft, hop, n_frames, pad=pad_r)
    else:
        spec = stft(x, nfft, hop, window, pad, onesided=True)
        p = spec.real * spec.real + spec.imag * spec.imag
    if scale == "magnitude":
        return torch.sqrt(p)
    if scale == "db":
        return 10.0 * torch.log10(torch.clamp_min(p, 1e-20))
    return p


def _settle_ola_block(own, spill_in, first: bool, w, nfft: int, hop: int, F: int, out=None):
    """NOLA-normalize a block of F frames' un-normalized OLA whose head
    may receive a predecessor's spill.

    own: (..., F*hop) un-normalized OLA of the block's own frames (updated
    in place); spill_in: (..., nfft-hop) the predecessor's overlap spill.
    first: no predecessor frames exist, so neither the spill nor its
    norm tail is added and boundary normalization is exactly the one-shot
    pattern.  The norm tail is block-size-invariant given F*hop >=
    nfft-hop (the caller's validation), which is what lets streaming
    chunks and mesh shards (parallel/stft_sharded.py) share this
    arithmetic.  out: where to write the result (a slice of a larger
    signal), else a new tensor.
    """
    H = nfft - hop
    own_len = F * hop
    norm_loc = _nola_norm(w, F, hop, (F - 1) * hop + nfft)
    norm = norm_loc[:own_len]
    if H > 0 and not first:
        own[..., :H] += spill_in
        norm = torch.cat([norm[:H] + norm_loc[own_len:], norm[H:]])
    return torch.div(own, torch.clamp_min(norm, torch.finfo(w.dtype).tiny), out=out)


def _coda_finalize(carry, w, F: int, hop: int):
    """Normalize the final spill: only the last chunk's frames cover it."""
    nfft = w.shape[0]
    norm = _nola_norm(w, F, hop, (F - 1) * hop + nfft)[F * hop :]
    return carry / torch.clamp_min(norm, torch.finfo(w.dtype).tiny)


class StreamingISTFT:
    """Chunked inverse STFT: synthesis twin of parallel.stream_pwelch.

    Push spectra chunks (..., F_k, bins) in frame order; each push returns
    the (..., F_k*hop) time block it fully determines (K6 once on the
    fused route).  flush() returns the final (nfft - hop)-sample coda.
    The concatenation of all pushed blocks plus the coda equals
    models.istft of the concatenated spectra — the overlap spill crossing
    each chunk boundary is carried on the chunks' device, never
    re-normalized twice.  Every chunk needs F_k*hop >= nfft - hop so a
    spill reaches only its immediate successor.  Host chunks go to
    `device` (default: default_device()).
    """

    def __init__(
        self,
        nfft: int,
        hop: Optional[int] = None,
        window: WindowSpec = None,
        pad: Optional[int] = None,
        onesided: bool = True,
        device=None,
    ):
        self.nfft = nfft
        self.hop = nfft // 2 if hop is None else hop
        if self.hop <= 0:
            raise ValueError("hop must be positive")
        if self.hop > nfft:
            raise ValueError("streaming synthesis requires hop <= nfft")
        self.pad = pad or nfft
        if self.pad < nfft:
            raise ValueError("pad must be >= nfft")
        self.onesided = onesided
        self.window = window
        self.device = device
        self.w = None  # resolved at the first push, in the chunks' dtype and device
        self._carry = None
        self._first = True
        self._last_frames = 0
        self._flushed = False

    def push(self, spec) -> torch.Tensor:
        """Consume one spectra chunk, return its settled time block."""
        if self._flushed:
            raise RuntimeError("push() after flush()")
        spec = as_complex_array(spec, self.device)
        bins = self.pad // 2 + 1 if self.onesided else self.pad
        if spec.dim() < 2 or spec.shape[-1] != bins:
            raise ValueError(
                f"chunk must be (..., F, {bins}), got {tuple(spec.shape)}"
            )
        F = spec.shape[-2]
        nfft, hop = self.nfft, self.hop
        H = nfft - hop
        if F * hop < H:
            raise ValueError(
                f"chunk too short: F*hop = {F * hop} < nfft-hop = {H}"
            )
        if self._carry is None:
            self.w = _resolve_window(self.window, nfft, spec.real.dtype, spec.device)
            self._carry = self.w.new_zeros(spec.shape[:-2] + (H,))
        fused = F > 0 and _istft_fused_eligible(spec, nfft, self.pad, hop)
        y = _ola_unnorm(spec, self.w, nfft, hop, self.pad, self.onesided, fused)
        own_len = F * hop
        out = _settle_ola_block(y[..., :own_len], self._carry, self._first, self.w, nfft,
                                hop, F)
        self._carry = y[..., own_len:].clone()  # the spill alone, not the whole chunk
        self._first = False
        self._last_frames = F
        return out

    def flush(self) -> torch.Tensor:
        """Return the final coda (the spill past the last owned block)."""
        if self._flushed:
            raise RuntimeError("flush() called twice")
        self._flushed = True
        if self._carry is None:
            dev = resolve_device(self.device)
            return torch.zeros(0, dtype=working_float(dev), device=dev)
        if self.nfft == self.hop:
            return torch.zeros_like(self._carry)
        return _coda_finalize(self._carry, self.w, self._last_frames, self.hop)


def stream_istft(chunks, nfft: int, hop: Optional[int] = None,
                 window: WindowSpec = None, pad: Optional[int] = None,
                 onesided: bool = True, device=None):
    """Generator over StreamingISTFT: yields each chunk's time block,
    then the final coda.  torch.cat(list(...), -1) == models.istft of the
    concatenated spectra."""
    s = StreamingISTFT(nfft, hop, window, pad, onesided, device)
    for spec in chunks:
        yield s.push(spec)
    yield s.flush()


def _host(block) -> np.ndarray:
    if isinstance(block, torch.Tensor):
        return block.detach().cpu().numpy()
    return np.asarray(block)


class _StreamingFramer:
    """Host-side frame-boundary bookkeeping for chunked analysis.

    Accumulates sample blocks (..., L_k) and hands back the longest
    prefix covering whole frames (frame count (L - nfft)//hop + 1, the
    spectral.Segment geometry, spectral.go:26-33); the tail past the
    last consumed frame start (< nfft samples) is carried into the next
    block on the host — the block itself then makes ONE device trip.
    """

    def __init__(self, nfft: int, hop: int):
        self.nfft, self.hop = nfft, hop
        self._carry = None

    def push(self, block):
        block = _host(block)
        buf = (
            block
            if self._carry is None
            else np.concatenate([self._carry, block], axis=-1)
        )
        if buf.shape[-1] < self.nfft:
            self._carry = buf
            return None
        k = (buf.shape[-1] - self.nfft) // self.hop + 1
        self._carry = buf[..., k * self.hop :]
        return buf[..., : (k - 1) * self.hop + self.nfft]

    @property
    def leftover(self) -> int:
        """Samples carried (or buffered pre-first-frame) right now."""
        return 0 if self._carry is None else self._carry.shape[-1]


class StreamingSTFT:
    """Chunked forward STFT: the analysis twin of StreamingISTFT.

    Push sample blocks (..., L_k) in time order; each push returns the
    (..., F_k, bins) spectra block it fully determines (or None while
    fewer than nfft samples have arrived), computed on `device` (default:
    the CPU).  The concatenation of all returned blocks equals
    models.stft of the concatenated signal, exactly — per-frame math is
    batch-independent, and the (< nfft)-sample tail behind the last frame
    start is carried on the host into the next block.  Like the one-shot
    stft (and spectral.Segment, spectral.go:36-44), the final remainder
    that never fills a frame is dropped.
    """

    def __init__(
        self,
        nfft: int,
        hop: Optional[int] = None,
        window: WindowSpec = None,
        pad: Optional[int] = None,
        onesided: bool = True,
        device=None,
    ):
        self.nfft = nfft
        self.hop = nfft // 2 if hop is None else hop
        if self.hop <= 0:
            raise ValueError("hop must be positive")
        self.pad = pad or nfft
        if self.pad < nfft:
            raise ValueError("pad must be >= nfft")
        self.window = window
        self.onesided = onesided
        self.device = device
        self._framer = _StreamingFramer(nfft, self.hop)

    def update(self, block) -> Optional[torch.Tensor]:
        """Consume one sample block; return its spectra block (or None)."""
        seg = self._framer.push(block)
        if seg is None:
            return None
        return stft(as_tensor(seg, self.device), self.nfft, self.hop, self.window, self.pad,
                    self.onesided)

    @property
    def leftover(self) -> int:
        """Samples buffered toward the next frame."""
        return self._framer.leftover


def stream_stft(chunks, nfft: int, hop: Optional[int] = None,
                window: WindowSpec = None, pad: Optional[int] = None,
                onesided: bool = True, device=None):
    """Generator over StreamingSTFT: yields one spectra block per input
    block once frames are available.  torch.cat(list(...), -2) ==
    models.stft of the concatenated signal."""
    s = StreamingSTFT(nfft, hop, window, pad, onesided, device)
    for block in chunks:
        spec = s.update(block)
        if spec is not None:
            yield spec


# scipy.signal's exported capitalizations
check_COLA = check_cola
check_NOLA = check_nola
