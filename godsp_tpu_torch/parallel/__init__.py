"""Device meshes and the sharded paths: sharded and streaming Welch PSD,
the sharded spectrogram/ISTFT and the tensor-parallel FFT.

Port of godsp_tpu/parallel: data parallelism over channels ("dp"),
sequence parallelism over the time axis ("sp") with the overlap halo
passed by a plain ring shift, the ring-halo kernel K10 or inside the
Welch kernel K11, and a psum of the partial periodograms.  One
controller drives a (dp, sp) grid of torch devices (parallel/mesh.py),
which may repeat a device.
"""

from godsp_tpu_torch.ops.cuda_halo import ring_halo
from godsp_tpu_torch.parallel._fft_sharded_impl import fft_sharded
from godsp_tpu_torch.parallel._pwelch_sharded_impl import (
    partial_periodogram,
    pwelch_sharded,
    resolve_geometry,
    sharded_partial_step,
)
from godsp_tpu_torch.parallel.mesh import Mesh, MeshConfig, make_mesh
from godsp_tpu_torch.parallel.stft_sharded import istft_sharded, spectrogram_sharded
from godsp_tpu_torch.parallel.streaming import (
    StreamingMetrics,
    StreamingPwelch,
    stream_pwelch,
    stream_welch,
)

__all__ = [
    "Mesh",
    "MeshConfig",
    "StreamingMetrics",
    "StreamingPwelch",
    "fft_sharded",
    "istft_sharded",
    "make_mesh",
    "partial_periodogram",
    "pwelch_sharded",
    "resolve_geometry",
    "ring_halo",
    "sharded_partial_step",
    "spectrogram_sharded",
    "stream_pwelch",
    "stream_welch",
]
