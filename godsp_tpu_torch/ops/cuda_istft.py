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

Grid rows x tiles of bt frames; each block inverse-transforms its frames
one by one in shared memory (the one-sided spectrum is completed in the
loader), windows them and overlap-adds them into a span of
(bt-1)*hop + nfft samples (csrc/istft_kernel.cu, whose header says what
bounds it on the H100).  Each tile's nfft - hop tail is added onto its
successor's head by one shifted add here, as pallas_istft.py:274-296
does; bt*hop >= nfft - hop keeps every tail inside the next tile.

Geometry: any pad = 2^k in 2..16384 with pad >= nfft and 0 < hop <= nfft
(the TPU's nfft % 128 and nfft % hop lane rules are not ported).

A wrapper takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import torch

from godsp_tpu_torch.ops import _build
from godsp_tpu_torch.ops.cuda_fft import ifft_pow2_plain, supported_size, twiddle_table

__all__ = [
    "istft_overlap_add",
    "istft_overlap_add_plain",
    "istft_supported",
    "launches",
    "overlap_add",
    "tile_frames",
]

# Kernel launches by wrapper, counted where each launches its kernel.
launches = {"istft_overlap_add": 0}

# Blocks to aim for: four per SM of an H100 (132 SMs).
_TARGET_BLOCKS = 4 * 132
_MAX_FRAMES_PER_TILE = 64


def istft_supported(nfft: int, pad: int, hop: int) -> bool:
    """True if the fused ISTFT kernel covers this geometry."""
    return supported_size(pad) and 1 <= nfft <= pad and 0 < hop <= nfft


def tile_frames(n_frames: int, rows: int, nfft: int, hop: int) -> int:
    """Frames a block overlap-adds: enough tiles to fill the card, at most
    64, and never fewer than the tail needs (bt*hop >= nfft - hop)."""
    need = max(1, -(-(nfft - hop) // hop))
    bt = -(-(n_frames * rows) // _TARGET_BLOCKS)
    return max(need, min(_MAX_FRAMES_PER_TILE, bt))


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


def istft_overlap_add(spec: torch.Tensor, w: torch.Tensor, nfft: int, hop: int,
                      onesided: bool = True) -> torch.Tensor:
    """K6: the un-normalized windowed overlap-add of the spectra's inverse
    FFTs, (..., F, bins) -> (..., (F-1)*hop + nfft), tile_frames frames a
    tile."""
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
    if not spec.is_cuda:
        return istft_overlap_add_plain(spec, w, nfft, hop, onesided)
    if spec.dtype != torch.complex64 or w.dtype != torch.float32 or w.device != spec.device:
        raise TypeError(f"istft_overlap_add: spec must be complex64 and w float32 on {spec.device}")
    F = spec.shape[-2]
    lead = spec.shape[:-2]
    rows = 1
    for d in lead:
        rows *= d
    length = (F - 1) * hop + nfft if F else 0
    if F == 0 or rows == 0:
        return torch.zeros(*lead, length, dtype=torch.float32, device=spec.device)
    bt = tile_frames(F, rows, nfft, hop)
    H = nfft - hop
    n_tiles = -(-F // bt)
    span = (bt - 1) * hop + nfft
    out = torch.empty(rows, n_tiles, span, dtype=torch.float32, device=spec.device)
    s2 = torch.view_as_real(spec.reshape(rows, F, bins).contiguous())
    w = w.contiguous()
    lib = _build.library()
    with torch.cuda.device(spec.device):
        rc = lib.gdsp_istft_ola(
            s2.data_ptr(), w.data_ptr(), twiddle_table(pad, True, spec.device).data_ptr(),
            out.data_ptr(), rows, F, bins, int(onesided), nfft, hop, pad.bit_length() - 1,
            bt, n_tiles, 1.0 / pad, torch.cuda.current_stream(spec.device).cuda_stream,
        )
    _build.check(rc, "istft_overlap_add")
    launches["istft_overlap_add"] += 1
    # Stitch: each tile owns bt*hop samples; its H-sample tail lands on the
    # head of the next tile's (bt*hop >= H), and the last tile's tail ends
    # the signal.  One shifted add, no scatter.
    own = bt * hop
    main = out[..., :own].contiguous()
    if H > 0 and n_tiles > 1:
        main[:, 1:, :H] += out[:, :-1, own:]
    y = torch.cat([main.reshape(rows, n_tiles * own), out[:, -1, own:]], dim=-1)
    return y[:, :length].reshape(*lead, length)
