"""L0 primitives: conversion, padding, segmentation, detrend,
comparison, the N-D Matrix.

PyTorch counterpart of godsp_tpu.dsputils (reference dsputils/).
"""

from godsp_tpu_torch.dsputils.compare import (
    CLOSE_FACTOR,
    complex_equal,
    float_equal,
    pretty_close,
    pretty_close_2,
    pretty_close_2f,
    pretty_close_c,
    snr_db,
)
from godsp_tpu_torch.dsputils.matrix import (
    Matrix,
    make_empty_matrix,
    make_matrix,
    make_matrix_2,
)
from godsp_tpu_torch.dsputils.utils import (
    detrend,
    is_power_of_2,
    next_power_of_2,
    segment,
    segment_bounds,
    to_complex,
    to_complex_2,
    zero_pad,
    zero_pad_2,
    zero_pad_f,
)

__all__ = [
    "CLOSE_FACTOR",
    "Matrix",
    "complex_equal",
    "detrend",
    "float_equal",
    "is_power_of_2",
    "make_empty_matrix",
    "make_matrix",
    "make_matrix_2",
    "next_power_of_2",
    "pretty_close",
    "pretty_close_2",
    "pretty_close_2f",
    "pretty_close_c",
    "segment",
    "segment_bounds",
    "snr_db",
    "to_complex",
    "to_complex_2",
    "zero_pad",
    "zero_pad_2",
    "zero_pad_f",
]
