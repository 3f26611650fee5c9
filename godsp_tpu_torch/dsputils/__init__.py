"""L0 primitives: predicates, padding, comparison, the N-D Matrix.

PyTorch counterpart of the part of godsp_tpu.dsputils (reference
dsputils/) that the ported slices use.  Detrend and to_complex_2 wait
for later slices.
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
from godsp_tpu_torch.dsputils.utils import is_power_of_2, next_power_of_2, zero_pad

__all__ = [
    "CLOSE_FACTOR",
    "Matrix",
    "complex_equal",
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
    "snr_db",
    "zero_pad",
]
