"""L2 spectral analysis: Welch PSD (reference spectral/).

PyTorch counterpart of godsp_tpu.spectral.  Cross-spectra (csd,
coherence) and the scipy-convention welch family wait for later slices.
"""

from godsp_tpu_torch.spectral._pwelch_impl import (
    PwelchOptions,
    fused_path_eligible,
    periodogram,
    pwelch,
    pwelch_from_frames,
)
from godsp_tpu_torch.spectral._segment_impl import num_segments, segment

__all__ = [
    "PwelchOptions",
    "fused_path_eligible",
    "num_segments",
    "periodogram",
    "pwelch",
    "pwelch_from_frames",
    "segment",
]
