"""Hand-written CUDA kernels for Hopper, each beside its plain torch version.

  cuda_fft     — K1 fft_pow2, K2 ifft_pow2, K3 rfft_pow2 (batched pow-2 FFT)
  cuda_pwelch  — K4 pwelch_power_partials (fused frame->window->FFT->|.|^2->sum)
  cuda_csd     — K7 csd_power_partials (the same for two signals, conj(X)Y->sum)
  cuda_stft    — K5 stft_complex, stft_power, stft_mel (fused per-frame STFT)
  cuda_istft   — K6 istft_overlap_add (fused inverse FFT->window->overlap-add)
  cuda_outer   — K8 outer_dft_split (the giant-N FFT's outer levels + twiddles)
  cuda_halo    — K10 ring_halo (the sharded Welch's overlap halo, one launch a ring)
  cuda_fused_halo — K11 pwelch_power_partials_halo (K4 reading the right
                 neighbour shard's head past its block's end)

Sources live in godsp_tpu_torch/csrc and build with nvcc at first use
(ops/_build.py).  launch_counts() reads every wrapper's count and
reset_launch_counts() zeroes them.
"""

from godsp_tpu_torch.ops import (
    cuda_csd,
    cuda_fft,
    cuda_fused_halo,
    cuda_halo,
    cuda_istft,
    cuda_outer,
    cuda_pwelch,
    cuda_stft,
)
from godsp_tpu_torch.ops.cuda_csd import csd_power_partials, csd_power_sum
from godsp_tpu_torch.ops.cuda_fft import fft_pow2, ifft_pow2, rfft_pow2, supported_size
from godsp_tpu_torch.ops.cuda_fused_halo import pwelch_power_partials_halo
from godsp_tpu_torch.ops.cuda_halo import ring_halo
from godsp_tpu_torch.ops.cuda_istft import istft_overlap_add, istft_supported
from godsp_tpu_torch.ops.cuda_outer import outer_dft_split, outer_supported
from godsp_tpu_torch.ops.cuda_pwelch import (
    fused_supported,
    pwelch_power_partials,
    pwelch_power_sum,
)
from godsp_tpu_torch.ops.cuda_stft import stft_complex, stft_mel, stft_power

__all__ = [
    "csd_power_partials",
    "csd_power_sum",
    "cuda_csd",
    "cuda_fft",
    "cuda_fused_halo",
    "cuda_halo",
    "cuda_istft",
    "cuda_outer",
    "cuda_pwelch",
    "cuda_stft",
    "fft_pow2",
    "fused_supported",
    "ifft_pow2",
    "istft_overlap_add",
    "istft_supported",
    "launch_counts",
    "outer_dft_split",
    "outer_supported",
    "pwelch_power_partials",
    "pwelch_power_partials_halo",
    "pwelch_power_sum",
    "reset_launch_counts",
    "rfft_pow2",
    "ring_halo",
    "stft_complex",
    "stft_mel",
    "stft_power",
    "supported_size",
]

_COUNTS = (
    cuda_fft.launches,
    cuda_pwelch.launches,
    cuda_csd.launches,
    cuda_stft.launches,
    cuda_istft.launches,
    cuda_outer.launches,
    cuda_halo.launches,
    cuda_fused_halo.launches,
)


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {k: v for d in _COUNTS for k, v in d.items()}


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0."""
    for d in _COUNTS:
        for k in d:
            d[k] = 0
