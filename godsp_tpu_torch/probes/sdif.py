"""K14i, the 128-point peel by seven radix-2 row stages (sdif), beside
K12's copy and K8's dense peel on the card.

    python3 -m godsp_tpu_torch.probes.sdif

The counterpart of tools/probe_sdif.py (main), at its shape: N = 2^24
points seen as (1, 128, 131072), two float32 planes N(0, 0.01^2) made on
the device from a torch.Generator seeded with 0.  First the numerics
(check_numerics, at the full shape): sdif_peel >= 120 dB against its
float64 plain version and against K8's outer_dft_split(x, 128, 1) with the
rows mapped by brev7 (row r of sdif holds K8's row brev7(r); the TPU probe
gave 137.1 dB there).  Then each row, timed with
utils.metrics.time_chain_diff (two chains of launches between CUDA
events; their difference over the extra launches):

  copy   K12 copy_split of the (2048, 8192) view, as the TPU probe's
         st_copy (:181);
  sdif   K14i sdif_peel: seven radix-2 stages across the 128 rows of
         each 32-column tile, in registers with one exchange through
         shared memory, then the post twiddle Tb;
  dense  K8 outer_dft_split(x, 128, 1): the TPU probe's dense peel (:174),
         here the register-radix passes [16, 8] down each column of a
         32-column tile (csrc/outer_kernel.cu);

each beside its multiple of the copy, its bound (utils.metrics.bound_ms:
16 B a point over 3.35 TB/s, or the float32 operations over 67 TFLOP/s:
41 a point for sdif (seven stages of 5 and Tb's 6), 47 for K8 (5 log2 128
and its factored twiddle's 12)) and its library yardstick: copy_ into
preallocated planes for the copy, none for sdif and dense (no one PyTorch
call computes a twiddled column DFT, as for K8).

run(device="cpu", m=...) sends the same rows through the plain versions
at a cut size (N = 128 m), for tests; a CPU time is not a device number.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from godsp_tpu_torch._dtypes import resolve_device
from godsp_tpu_torch.dsputils import snr_db
from godsp_tpu_torch.ops import cuda_metrics, cuda_outer, cuda_probes
from godsp_tpu_torch.probes._common import lane_main, lane_planes, time_lane_rows

__all__ = ["COPY_N", "D", "M", "OPS_PER_POINT", "ROWS", "SNR_DB", "check_numerics", "main",
           "ops", "run"]

D, M = 128, 1 << 17  # (D, M) = (128, 131072): N = 2^24
COPY_N = 8192  # row length of the copy's view, as st_copy's
ROWS = ("copy", "sdif", "dense")
OPS_PER_POINT = {"copy": 0.0, "sdif": 7 * 5.0 + 6.0, "dense": 5.0 * 7 + 12.0}
SNR_DB = 120.0


def _c(planes) -> np.ndarray:
    return (planes[0].double() + 1j * planes[1].double()).cpu().numpy()


def check_numerics(xr: torch.Tensor, xi: torch.Tensor) -> dict:
    """sdif_peel against its float64 plain version and against K8's peel
    with the rows mapped by brev7; raises on the card where one falls
    short.  "max_abs_err" holds sdif_peel's largest absolute error against
    the float64 plain version."""
    got = _c(cuda_probes.sdif_peel(xr, xi))
    want = _c(cuda_probes.sdif_peel_plain(xr.double(), xi.double()))
    perm = cuda_probes.brev7_perm().to(xr.device)
    dense = cuda_outer.outer_dft_split(xr, xi, D, 1)
    dense = _c((dense[0][..., perm, :], dense[1][..., perm, :]))
    out = {"sdif_vs_float64_db": float(snr_db(got, want)),
           "sdif_vs_dense_db": float(snr_db(got, dense)),
           "max_abs_err": {"sdif_peel": float(np.abs(got - want).max(initial=0.0))}}
    if xr.is_cuda and min(out["sdif_vs_float64_db"], out["sdif_vs_dense_db"]) < SNR_DB:
        raise AssertionError(f"sdif numerics {out}: below {SNR_DB} dB, timing would be "
                             "meaningless")
    return out


def ops(xr: torch.Tensor, xi: torch.Tensor) -> dict:
    """Each row: (the op, its library yardstick or None), ops of no arguments."""
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    vr, vi = xr.view(-1, COPY_N), xi.view(-1, COPY_N)
    return {
        "copy": (lambda: cuda_metrics.copy_split(vr, vi), lambda: (yr.copy_(xr), yi.copy_(xi))),
        "sdif": (lambda: cuda_probes.sdif_peel(xr, xi), None),
        "dense": (lambda: cuda_outer.outer_dft_split(xr, xi, D, 1), None),
    }


def run(device=None, m: int | None = None, emit=print) -> dict:
    """The numerics check, then every row at (1, 128, m) planes (default
    m = M) on `device` (default: the card); returns {"check": {...}, row:
    {"ms", "bound_ms", "bound_by", "library_ms", "of_copy"}} and emits one
    line a row."""
    dev = resolve_device(device)
    m = M if m is None else m
    xr, xi = (p.view(1, D, m) for p in lane_planes(dev, D, m))
    out = {"check": check_numerics(xr, xi)}
    emit(f"check: {out['check']}  [{dev.type}]")
    out.update(time_lane_rows(xr, ops(xr, xi), OPS_PER_POINT, emit))
    return out


def main() -> int:
    return lane_main("sdif", run, D, M)


if __name__ == "__main__":
    sys.exit(main())
