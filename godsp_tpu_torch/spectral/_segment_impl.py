"""Integer-overlap Welch framing (reference spectral/spectral.go:22-47).

Port of godsp_tpu/spectral/_segment_impl.py: overlap is an integer point
count, frames are a stacked copy, and the segment count follows the data
length: (len(x) - size) / (size - noverlap) + 1.
"""

from __future__ import annotations

import torch

from godsp_tpu_torch._dtypes import as_tensor

__all__ = ["segment", "num_segments"]


def num_segments(lx: int, size: int, noverlap: int) -> int:
    """Segment count formula of spectral.go:26-33 (host-side)."""
    stride = size - noverlap
    if lx == size:
        return 1
    if lx > size:
        return (lx - size) // stride + 1
    return 0


def segment(x, size: int, noverlap: int) -> torch.Tensor:
    """Frame the trailing axis into (..., segments, size) with integer overlap.

    Values identical to the reference's copied frames (spectral.go:36-45);
    trailing samples that do not fill a frame are discarded.
    """
    x = as_tensor(x)
    lx = x.shape[-1]
    segments = num_segments(lx, size, noverlap)
    if segments == 0:
        return x.new_zeros(x.shape[:-1] + (0, size))
    stride = size - noverlap
    idx = torch.arange(segments, device=x.device)[:, None] * stride + torch.arange(
        size, device=x.device
    )[None, :]
    return x[..., idx]
