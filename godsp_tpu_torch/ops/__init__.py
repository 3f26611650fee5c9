"""Hand-written CUDA kernels for Hopper, each beside its plain torch version.

  cuda_fft     — K1 fft_pow2, K2 ifft_pow2, K3 rfft_pow2 (batched pow-2 FFT)
  cuda_pwelch  — K4 pwelch_power_partials (fused frame->window->FFT->|.|^2->sum)

Sources live in godsp_tpu_torch/csrc and build with nvcc at first use
(ops/_build.py).  reset_launch_counts() zeroes every wrapper's count.
"""

from godsp_tpu_torch.ops import cuda_fft, cuda_pwelch
from godsp_tpu_torch.ops.cuda_fft import fft_pow2, ifft_pow2, rfft_pow2, supported_size
from godsp_tpu_torch.ops.cuda_pwelch import (
    fused_supported,
    pwelch_power_partials,
    pwelch_power_sum,
)

__all__ = [
    "cuda_fft",
    "cuda_pwelch",
    "fft_pow2",
    "fused_supported",
    "ifft_pow2",
    "launch_counts",
    "pwelch_power_partials",
    "pwelch_power_sum",
    "reset_launch_counts",
    "rfft_pow2",
    "supported_size",
]


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {**cuda_fft.launches, **cuda_pwelch.launches}


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0."""
    for d in (cuda_fft.launches, cuda_pwelch.launches):
        for k in d:
            d[k] = 0
