"""L2 spectral analysis (reference spectral/): Welch PSD, cross-spectra,
and the scipy-convention estimators.

PyTorch counterpart of godsp_tpu.spectral:
  pwelch, periodogram, pwelch_from_frames — the reference's Pwelch;
  csd, coherence — the same conventions over pairs of signals;
  welch, welch_csd, welch_coherence, spectrogram_scipy, lombscargle —
  scipy.signal's vocabulary (periodic windows, detrend, median).
"""

from godsp_tpu_torch.spectral._csd_impl import coherence, csd
from godsp_tpu_torch.spectral._pwelch_impl import (
    PwelchOptions,
    fused_path_eligible,
    periodogram,
    pwelch,
    pwelch_from_frames,
)
from godsp_tpu_torch.spectral._segment_impl import num_segments, segment
from godsp_tpu_torch.spectral._welch_impl import (
    lombscargle,
    spectrogram_scipy,
    welch,
    welch_coherence,
    welch_csd,
)

__all__ = [
    "PwelchOptions",
    "coherence",
    "csd",
    "fused_path_eligible",
    "lombscargle",
    "num_segments",
    "periodogram",
    "pwelch",
    "pwelch_from_frames",
    "segment",
    "spectrogram_scipy",
    "welch",
    "welch_coherence",
    "welch_csd",
]
