"""Streaming Welch PSD on one device, in the reference's conventions
(stream_pwelch) and scipy's (stream_welch); the mesh-sharded paths wait
for ROADMAP queue 1 item 10."""

from godsp_tpu_torch.parallel._pwelch_sharded_impl import (
    partial_periodogram,
    partial_step,
    resolve_geometry,
)
from godsp_tpu_torch.parallel.streaming import (
    StreamingMetrics,
    StreamingPwelch,
    stream_pwelch,
    stream_welch,
)

__all__ = [
    "StreamingMetrics",
    "StreamingPwelch",
    "partial_periodogram",
    "partial_step",
    "resolve_geometry",
    "stream_pwelch",
    "stream_welch",
]
