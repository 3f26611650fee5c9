"""Dtype policy of the PyTorch port.

The reference library computes in float64/complex128 (go-dsp
dsputils/dsputils.go:25, fft/fft.go:25).  The port keeps that on the CPU,
where it is the parity mode held against godsp_tpu at 1e-8.  On CUDA the
working type is float32/complex64, the type the hand-written kernels take
(ops/cuda_fft.py, ops/cuda_pwelch.py): public entry points cast CUDA
inputs to it, as godsp_tpu does on the TPU with x64 off, whichever route
(kernels or plain, fft.set_kernels_enabled) then runs.  A float64
computation on the card calls the plain functions beneath the public
entry points (fft/four_step.py, the *_plain versions in ops/).

There is no put/to_host: the split-plane transfer workaround was a TPU
transport issue.  Functions on tensors run on the tensor's device; host
data (numpy, lists, paths, Matrix) lands on the device the caller names,
else on default_device(): the card ("cuda") unless
set_default_device("cpu") says otherwise, as godsp_tpu puts host data on
its default device.  With the default at "cuda" and no card, host input
raises; nothing falls back to the CPU on its own.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "as_complex_array",
    "as_real_array",
    "as_tensor",
    "complex_for",
    "default_device",
    "np_float_for",
    "real_for",
    "resolve_device",
    "set_default_device",
    "working_float",
]

_default_device = torch.device("cuda")


def default_device() -> torch.device:
    """Where host data goes when no device is named (default: "cuda")."""
    return _default_device


def set_default_device(device) -> None:
    """Set default_device(): "cpu" for CPU runs and tests, "cuda" for the card."""
    global _default_device
    _default_device = torch.device(device)


def resolve_device(device=None) -> torch.device:
    """`device`, or default_device() when None.  Raises RuntimeError for
    a CUDA device on a machine without one, rather than computing on the
    CPU."""
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: godsp_tpu_torch puts host data on the card by "
            "default; pass device='cpu' or call set_default_device('cpu')"
        )
    return dev


def working_float(device) -> torch.dtype:
    """The real working dtype on `device`: float32 on CUDA, float64 on the CPU."""
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64


def np_float_for(device) -> np.dtype:
    """Host (numpy) dtype that feeds `device` without a second conversion."""
    return np.dtype(np.float32) if working_float(device) == torch.float32 else np.dtype(np.float64)


def complex_for(dtype: torch.dtype) -> torch.dtype:
    """Complex dtype matching the precision of a real (or complex) dtype."""
    if dtype.is_complex:
        return dtype
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def real_for(dtype: torch.dtype) -> torch.dtype:
    """Real dtype matching the precision of a complex (or real) dtype."""
    if not dtype.is_complex:
        return dtype
    return torch.float64 if dtype == torch.complex128 else torch.float32


def as_tensor(x, device=None) -> torch.Tensor:
    """x as a tensor: a tensor stays on its device unless `device` is
    given; host data lands on `device` (default: default_device())."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    arr = np.asarray(x)
    if any(s < 0 for s in arr.strides):  # a reversed view: torch takes no negative strides
        arr = arr.copy()
    return torch.as_tensor(arr, device=resolve_device(device))


def _cuda_cast(x: torch.Tensor) -> torch.Tensor:
    if x.is_cuda:
        if x.dtype == torch.float64:
            return x.to(torch.float32)
        if x.dtype == torch.complex128:
            return x.to(torch.complex64)
    return x


def as_real_array(x, device=None) -> torch.Tensor:
    """A real floating tensor at policy precision (ints lift to the working float)."""
    x = as_tensor(x, device)
    if x.dtype.is_complex:
        raise ValueError("expected real input, got complex")
    if not x.dtype.is_floating_point:
        x = x.to(working_float(x.device))
    return _cuda_cast(x)


def as_complex_array(x, device=None) -> torch.Tensor:
    """A complex tensor at policy precision (dsputils.go:25-31 as a dtype lift)."""
    x = as_tensor(x, device)
    if not x.dtype.is_complex:
        if not x.dtype.is_floating_point:
            x = x.to(working_float(x.device))
        x = x.to(complex_for(x.dtype))
    return _cuda_cast(x)
