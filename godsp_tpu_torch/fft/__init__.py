"""L1 transforms: FFT/IFFT (1-D/2-D, real/complex), convolution, split planes.

PyTorch counterpart of godsp_tpu.fft (reference fft/).  Power-of-2
transforms pass through fft/pow2.py: the Hopper kernels for CUDA
float32 tensors (ops/cuda_fft.py), the plain four-step version
(fft/four_step.py) on the CPU.  Other lengths take Bluestein over the
same choke point.
"""

from godsp_tpu_torch.fft.bluestein import bluestein_fft
from godsp_tpu_torch.fft.core import (
    convolve,
    fft,
    fft2,
    fft2_real,
    fft_real,
    ifft,
    ifft2,
    ifft2_real,
    ifft_real,
)
from godsp_tpu_torch.fft.four_step import four_step_fft
from godsp_tpu_torch.fft.pow2 import kernels_enabled, pow2_fft, set_kernels_enabled
from godsp_tpu_torch.fft.split import fft_split, ifft_split, rfft_split

__all__ = [
    "bluestein_fft",
    "convolve",
    "fft",
    "fft2",
    "fft2_real",
    "fft_real",
    "fft_split",
    "four_step_fft",
    "ifft",
    "ifft2",
    "ifft2_real",
    "ifft_real",
    "ifft_split",
    "kernels_enabled",
    "pow2_fft",
    "rfft_split",
    "set_kernels_enabled",
]
