"""Griffin-Lim phase reconstruction from a magnitude spectrogram.

Port of godsp_tpu/models/griffin.py: recover a time signal whose STFT
magnitude matches a target, by alternating projections between the set
of consistent spectrograms (STFT of some signal) and the set with the
given magnitude [Griffin & Lim 1984], with the momentum acceleration of
Perraudin, Balazs & Sondergaard 2013 ("fast GLA").

The JAX package ran the iteration as one compiled lax.fori_loop; here it
is a Python loop over the same body.  On a CUDA float32 input at a
supported geometry each iteration is one K6 (ops/cuda_istft.py: inverse
FFT, window, overlap-add) and one K5 complex launch (ops/cuda_stft.py),
and one more K6 synthesizes the result; elsewhere the same loop runs
over the unfused stft/istft bodies.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from godsp_tpu_torch._dtypes import as_real_array, complex_for
from godsp_tpu_torch.dsputils.utils import zero_pad
from godsp_tpu_torch.models._stft_impl import (
    WindowSpec,
    _fused_window,
    _istft_fused_eligible,
    _nola_norm,
    _ola_unnorm,
    _resolve_window,
    _stft_unfused,
)
from godsp_tpu_torch.ops import cuda_stft
from godsp_tpu_torch.spectral._pwelch_impl import fused_path_eligible

__all__ = ["griffin_lim"]


def _gl_loop(mag: torch.Tensor, w: torch.Tensor, hop: int, length: int, n_iter: int,
             momentum: float, fwd: Callable, ola: Callable) -> torch.Tensor:
    """The fast-GLA iteration (griffin.py:50-100 of the JAX package).

    fwd(y) -> one-sided spectra of a signal; ola(s) -> the un-normalized
    windowed overlap-add of spectra.  Runs in mag's dtype on its device,
    so a float64 reference on the card passes the kernels' plain versions
    as fwd and ola."""
    fdt = mag.dtype
    cdt = complex_for(fdt)
    n_frames = mag.shape[-2]
    span = (n_frames - 1) * hop + w.shape[0]
    tiny = torch.finfo(fdt).tiny
    # The NOLA denominator is loop-invariant: hoisted, divided in the body.
    norm = _nola_norm(w, n_frames, hop, span)

    def inv(s):
        return ola(s) / norm

    def project(c):
        """Replace c's magnitude with the target, keep its phase."""
        r = torch.sqrt(c.real * c.real + c.imag * c.imag)
        return (mag / torch.clamp_min(r, tiny)).to(cdt) * c

    s = mag.to(cdt)  # zero-phase init
    prev = torch.zeros_like(s)
    for _ in range(n_iter):
        r = fwd(inv(s)).to(cdt)
        # Fast GLA: extrapolate along the consistency step before the
        # magnitude projection (momentum = 0 recovers classic GL).
        c = r + momentum * (r - prev) if momentum else r
        s, prev = project(c), r
    y = inv(s)
    return zero_pad(y, length) if length > span else y[..., :length]


def griffin_lim(
    mag,
    nfft: int,
    hop: Optional[int] = None,
    window: WindowSpec = None,
    pad: Optional[int] = None,
    n_iter: int = 32,
    momentum: float = 0.99,
    length: Optional[int] = None,
) -> torch.Tensor:
    """Signal whose STFT magnitude approximates `mag`.

    mag: (..., n_frames, pad//2 + 1) non-negative one-sided magnitudes
    (e.g. models.spectrogram(..., scale="magnitude")), batched over
    leading axes.  nfft/hop/window/pad must match the analysis that
    produced it (defaults as models.stft: hop = nfft//2, Hann,
    pad = nfft).  momentum in [0, 1) is the fast-GLA extrapolation
    (0 = classic Griffin-Lim).  Returns (..., length) real, length
    defaulting to the covered span (n_frames - 1)*hop + nfft.
    """
    mag = as_real_array(mag)
    hop = nfft // 2 if hop is None else hop
    if hop <= 0:
        raise ValueError("hop must be positive")
    pad = pad or nfft
    if pad < nfft:
        raise ValueError("pad must be >= nfft")
    if mag.dim() < 2:
        raise ValueError("mag must be (..., n_frames, bins)")
    bins = mag.shape[-1]
    if pad // 2 + 1 != bins:
        raise ValueError(
            f"pad={pad} inconsistent with {bins} one-sided bins "
            f"(need pad//2 + 1 == bins)"
        )
    if not 0.0 <= momentum < 1.0:
        raise ValueError("momentum must be in [0, 1)")
    if n_iter < 0:
        raise ValueError("n_iter must be >= 0")
    n_frames = mag.shape[-2]
    if n_frames == 0:
        raise ValueError("mag has no frames")
    length = length or (n_frames - 1) * hop + nfft
    w = _resolve_window(window, nfft, mag.dtype, mag.device)

    if fused_path_eligible(mag, nfft, pad, hop):
        wf = _fused_window(w, pad)

        def fwd(y):
            return cuda_stft.stft_complex(y, wf, nfft, hop, n_frames, pad=pad)
    else:

        def fwd(y):
            return _stft_unfused(y, w, nfft, hop, pad, True)

    spectra = mag.new_empty(0, dtype=complex_for(mag.dtype))  # the iterates' type and device
    fused_inv = _istft_fused_eligible(spectra, nfft, pad, hop)

    def ola(s):
        return _ola_unnorm(s, w, nfft, hop, pad, True, fused_inv)

    return _gl_loop(mag, w, hop, length, n_iter, float(momentum), fwd, ola)
