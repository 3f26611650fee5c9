"""godsp_tpu_torch — the PyTorch/CUDA port of godsp_tpu for NVIDIA Hopper.

Same public names and semantics as godsp_tpu (go-dsp's quirks
included); plain tensor code is PyTorch, and every TPU kernel on the
ported path is a hand-written CUDA kernel for sm_90a (godsp_tpu_torch/csrc,
built at first use).  It never imports jax.

Packages:
  dsputils  — L0 primitives: conversion, padding, segmentation, compare,
              the host-side N-D Matrix
  window    — symmetric window tapers
  fft       — FFT/IFFT (1-D/2-D/N-D, real/complex, split planes) through
              2^28 points, convolution, the rfft/irfft/hilbert family
  spectral  — Welch PSD
  wav       — RIFF/WAVE streaming ingest
  native    — C++ host decode and stream buffer (shared source)
  ops       — the CUDA kernels and their plain versions
  parallel  — streaming Welch PSD with checkpoint/resume
  models    — wav_psd, and the STFT family: stft/istft/spectrogram and
              their streaming forms, mel, Griffin-Lim, WAV <-> spectra

Host data (numpy, lists, paths, Matrix) goes to default_device(), the
card unless set_default_device("cpu") or a call's device="cpu" says
otherwise; tensors stay on their own device.
"""

__version__ = "0.1.0"

from godsp_tpu_torch import dsputils, fft, spectral, wav, window  # noqa: F401
from godsp_tpu_torch._dtypes import default_device, set_default_device

__all__ = [
    "default_device",
    "dsputils",
    "fft",
    "set_default_device",
    "spectral",
    "wav",
    "window",
    "__version__",
]
