"""K13's lane DFT factored as 128 = 16 x 8 (K14b) beside the dense form
(K13) and the copy ceiling (K12) on the card.

    python3 -m godsp_tpu_torch.probes.facdft

The counterpart of tools/probe_facdft.py (main), at its shape: n = 1024
points a row (eight 128-point slices), b = 16384 rows, two float32 planes
made on the device from a torch.Generator seeded with 0.  First the
numerics: fac_dft against gmm_floor on the card (both float32) and
against the float64 plain version, each >= 120 dB, as the TPU probe's
check_numerics.  Then each row, timed with utils.metrics.time_chain_diff
(two chains of launches between CUDA events; their difference over the
extra launches):

  copy  K12 copy_split: the same bytes, no compute (the copy ceiling);
  gmm   K13 gmm_floor: the dense 128-point contraction, 128 complex
        multiply-adds a point (768 float32 operations);
  fac   K14b fac_dft: the factored form, 24 complex multiply-adds a
        point (204 operations);

each beside its bound (utils.metrics.bound_ms: bytes over 3.35 TB/s or
operations over 67 TFLOP/s) and its library yardstick, one PyTorch call
of the same function timed the same way: copy_ into preallocated planes
for the copy, torch.matmul of the complex64 slices with K13's G tables
(TF32 off) for gmm and fac.  On the TPU the factored form took 25x the
dense one (the probe's VERDICT); the question here is whether 5.3x fewer
multiply-adds make it faster than K13 on CUDA cores.

run(device="cpu", b=...) sends the same rows through the plain versions
at a cut size, for tests; a CPU time is not a device number.
"""

from __future__ import annotations

import sys

import torch

from godsp_tpu_torch._dtypes import resolve_device
from godsp_tpu_torch.dsputils import snr_db
from godsp_tpu_torch.ops import cuda_metrics, cuda_probes
from godsp_tpu_torch.probes._common import complex_matmul, lane_main, lane_planes, time_lane_rows

__all__ = ["B", "N", "OPS_PER_POINT", "ROWS", "SNR_DB", "check_numerics", "main", "run"]

N, B = 1024, 16384
ROWS = ("copy", "gmm", "fac")
OPS_PER_POINT = {"copy": 0.0, "gmm": 768.0, "fac": 204.0}
SNR_DB = 120.0
CHECK_ROWS = 256  # rows of the numerics check, as the TPU probe's BT


def _db(got, want) -> float:
    g = (got[0].double() + 1j * got[1].double()).cpu().numpy()
    w = (want[0].double() + 1j * want[1].double()).cpu().numpy()
    return snr_db(g, w)


def check_numerics(xr: torch.Tensor, xi: torch.Tensor) -> dict:
    """fac_dft against gmm_floor and against its float64 plain version on
    the first CHECK_ROWS rows; raises below SNR_DB on the card."""
    xr, xi = xr[:CHECK_ROWS], xi[:CHECK_ROWS]
    fac = cuda_probes.fac_dft(xr, xi)
    out = {"fac_vs_gmm_db": float(_db(fac, cuda_metrics.gmm_floor(xr, xi))),
           "fac_vs_float64_db": float(_db(fac, cuda_probes.fac_dft_plain(xr.double(),
                                                                        xi.double())))}
    if xr.is_cuda and min(out.values()) < SNR_DB:
        raise AssertionError(f"fac_dft numerics {out}: below {SNR_DB} dB, timing would be "
                             "meaningless")
    return out


def ops(xr: torch.Tensor, xi: torch.Tensor) -> dict:
    """Each row: (the op, its library yardstick), ops of no arguments."""
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    matmul = complex_matmul(xr, xi)
    return {
        "copy": (lambda: cuda_metrics.copy_split(xr, xi), lambda: (yr.copy_(xr), yi.copy_(xi))),
        "gmm": (lambda: cuda_metrics.gmm_floor(xr, xi), matmul),
        "fac": (lambda: cuda_probes.fac_dft(xr, xi), matmul),
    }


def run(device=None, b: int | None = None, emit=print) -> dict:
    """The numerics check, then every row at b rows (default B) of N points
    on `device` (default: the card); returns {"check": {...}, row: {"ms",
    "bound_ms", "bound_by", "library_ms", "of_copy"}} and emits one line a
    row."""
    dev = resolve_device(device)
    b = B if b is None else b
    xr, xi = lane_planes(dev, b, N)
    out = {"check": check_numerics(xr, xi)}
    emit(f"fac_dft vs gmm_floor {out['check']['fac_vs_gmm_db']:.2f} dB, vs float64 plain "
         f"{out['check']['fac_vs_float64_db']:.2f} dB  [{dev.type}]")
    out.update(time_lane_rows(xr, ops(xr, xi), OPS_PER_POINT, emit))
    return out


def main() -> int:
    return lane_main("facdft", run, B, N)


if __name__ == "__main__":
    sys.exit(main())
