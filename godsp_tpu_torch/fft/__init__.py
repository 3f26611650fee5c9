"""L1 transforms: FFT/IFFT (1-D/2-D/N-D, real/complex), convolution,
split planes, the rfft/irfft/hfft family, hilbert, frequency grids.

PyTorch counterpart of godsp_tpu.fft (reference fft/).  Power-of-2
transforms pass through fft/pow2.py: the Hopper kernels for CUDA
float32 tensors (ops/cuda_fft.py up to 16384 points, the large plan of
fft/large.py over ops/cuda_outer.py through 2^28), the plain four-step
version (fft/four_step.py) on the CPU.  Other lengths take Bluestein
over the same choke point.  stockham_fft is the independent radix-2
oracle.  czt/zoom_fft, dct/dst and fht wait for a later slice.
"""

from godsp_tpu_torch.fft.bluestein import bluestein_fft
from godsp_tpu_torch.fft.core import (
    convolve,
    fft,
    fft2,
    fft2_real,
    fft_real,
    fftn,
    ifft,
    ifft2,
    ifft2_real,
    ifft_real,
    ifftn,
)
from godsp_tpu_torch.fft.four_step import four_step_fft
from godsp_tpu_torch.fft.helpers import (
    fftfreq,
    fftshift,
    hfft,
    hfft2,
    hfftn,
    hilbert,
    ifftshift,
    ihfft,
    ihfft2,
    ihfftn,
    irfft,
    irfft2,
    irfftn,
    next_fast_len,
    prev_fast_len,
    rfft,
    rfft2,
    rfftfreq,
    rfftn,
)
from godsp_tpu_torch.fft.large import set_large_min
from godsp_tpu_torch.fft.pow2 import kernels_enabled, pow2_fft, set_kernels_enabled
from godsp_tpu_torch.fft.split import fft_split, ifft_split, rfft_split
from godsp_tpu_torch.fft.stockham import ensure_radix2_factors, stockham_fft, twiddles

__all__ = [
    "bluestein_fft",
    "convolve",
    "ensure_radix2_factors",
    "fft",
    "fft2",
    "fft2_real",
    "fft_real",
    "fft_split",
    "fftfreq",
    "fftn",
    "fftshift",
    "four_step_fft",
    "hfft",
    "hfft2",
    "hfftn",
    "hilbert",
    "ifft",
    "ifft2",
    "ifft2_real",
    "ifft_real",
    "ifft_split",
    "ifftn",
    "ifftshift",
    "ihfft",
    "ihfft2",
    "ihfftn",
    "irfft",
    "irfft2",
    "irfftn",
    "kernels_enabled",
    "next_fast_len",
    "pow2_fft",
    "prev_fast_len",
    "rfft",
    "rfft2",
    "rfft_split",
    "rfftfreq",
    "rfftn",
    "set_kernels_enabled",
    "set_large_min",
    "stockham_fft",
    "twiddles",
]
