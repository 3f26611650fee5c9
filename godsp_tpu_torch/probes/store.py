"""Store-pattern twins of K12 and K13 (K14c) on the card: do whole-row
stores close the gap between a contraction and the copy ceiling, and what
does a cluster design of the same contraction cost?

    python3 -m godsp_tpu_torch.probes.store

The counterpart of tools/probe_store.py (main), at its shape: n = 1024
points a row, b = 16384 rows, two float32 planes made on the device from
a torch.Generator seeded with 0.  First the numerics: slicestore and
concatstore must return their input (torch.equal), gmm_concat K13's
result (torch.equal, the same fmaf chains; else >= 120 dB against the
float64 plain version).  Then each row, timed with
utils.metrics.time_chain_diff (two chains of launches between CUDA
events; their difference over the extra launches):

  copy         K12 copy_split: a grid-stride copy (the copy ceiling);
  slicestore   a copy storing one 128-column slice of each row a pass,
               as K13 stores;
  concatstore  a copy staging its rows in shared memory, then storing
               whole rows;
  gmm          K13 gmm_floor: one block a (slice, row group), per-slice
               stores;
  gmm_concat   K13's arithmetic over every slice of a row tile, stored
               as whole rows, on a thread-block cluster: a CTA a slice
               with its G[k1] resident, 4 x 4 register tiles, the tile's
               slices gathered over distributed shared memory
               (csrc/lane_contract.cuh).  It differs from the gmm row in
               how G arrives and in its register tiles as well as in its
               stores, so the two rows compare two designs of the same
               arithmetic (equal bit for bit), not the stores alone;
  i8_concat    K13's function by the int8-limb contraction
               (godsp_tpu/ops/_int8_contract.py's scheme, K14g's
               arithmetic), a 16-row tile's every slice stored as whole
               rows, on a thread-block cluster: a CTA a slice with its int8
               tables resident, each row pushed to the CTA that stores it;

each beside its bound (utils.metrics.bound_ms; i8_concat's 4608 int8
operations a point over 1,979 TOPS too) and its library yardstick (copy_
for the copies, torch.matmul of the complex64 slices with K13's G tables,
TF32 off, for the contractions).  i8_concat must equal its plain version
(the same integer and float32 arithmetic; else >= 120 dB against it); its
dB against float64 is reported, not gated (probes/int8.py says why).

run(device="cpu", b=...) sends the same rows through the plain versions
at a cut size, for tests; a CPU time is not a device number.
"""

from __future__ import annotations

import sys

import torch

from godsp_tpu_torch._dtypes import resolve_device
from godsp_tpu_torch.dsputils import snr_db
from godsp_tpu_torch.ops import cuda_metrics, cuda_probes
from godsp_tpu_torch.probes import int8
from godsp_tpu_torch.probes._common import (
    complex_matmul,
    lane_main,
    lane_planes,
    planes_db,
    planes_equal,
    time_lane_rows,
)

__all__ = ["B", "N", "ROWS", "SNR_DB", "check_numerics", "main", "run"]

N, B = 1024, 16384
ROWS = ("copy", "slicestore", "concatstore", "gmm", "gmm_concat", "i8_concat")
OPS_PER_POINT = {"copy": 0.0, "slicestore": 0.0, "concatstore": 0.0, "gmm": 768.0,
                 "gmm_concat": 768.0, "i8_concat": int8.OPS_PER_POINT["i8_concat"]}
INT8_PER_POINT = {"i8_concat": int8.INT8_PER_POINT["i8_concat"]}
SNR_DB = 120.0


def check_numerics(xr: torch.Tensor, xi: torch.Tensor) -> dict:
    """The copies equal their input; gmm_concat equals K13 (or, if not,
    holds >= SNR_DB against the float64 plain version); i8_concat equals
    its plain version (or holds >= SNR_DB against it).  Raises otherwise."""
    out = {}
    for name in ("slicestore", "concatstore"):
        got = getattr(cuda_probes, name)(xr, xi)
        out[f"{name}_equal"] = torch.equal(got[0], xr) and torch.equal(got[1], xi)
        if not out[f"{name}_equal"]:
            raise AssertionError(f"{name}: differs from its input")
    got = cuda_probes.gmm_concat(xr, xi)
    k13 = cuda_metrics.gmm_floor(xr, xi)
    out["gmm_concat_equal_k13"] = torch.equal(got[0], k13[0]) and torch.equal(got[1], k13[1])
    want = cuda_metrics.gmm_floor_plain(xr.double(), xi.double())
    out["gmm_concat_vs_float64_db"] = float(snr_db(
        (got[0].double() + 1j * got[1].double()).cpu().numpy(),
        (want[0] + 1j * want[1]).cpu().numpy()))
    if xr.is_cuda and out["gmm_concat_vs_float64_db"] < SNR_DB:
        raise AssertionError(f"gmm_concat: {out['gmm_concat_vs_float64_db']:.2f} dB < {SNR_DB}")
    got = cuda_probes.i8_concat(xr, xi)
    want = cuda_probes.i8full_plain(xr, xi)
    out["i8_concat_equal_plain"] = planes_equal(got, want)
    out["i8_concat_vs_plain_db"] = planes_db(got, want, {}, "i8_concat")
    out["i8_concat_vs_float64_db"] = planes_db(
        got, cuda_probes.gmm_tf32_plain(xr.double(), xi.double()), {}, "float64")
    if xr.is_cuda and out["i8_concat_vs_plain_db"] < SNR_DB:
        raise AssertionError(f"i8_concat: {out['i8_concat_vs_plain_db']:.2f} dB < {SNR_DB}")
    return out


def ops(xr: torch.Tensor, xi: torch.Tensor) -> dict:
    """Each row: (the op, its library yardstick), ops of no arguments."""
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    copy = lambda: (yr.copy_(xr), yi.copy_(xi))  # noqa: E731
    matmul = complex_matmul(xr, xi)
    return {
        "copy": (lambda: cuda_metrics.copy_split(xr, xi), copy),
        "slicestore": (lambda: cuda_probes.slicestore(xr, xi), copy),
        "concatstore": (lambda: cuda_probes.concatstore(xr, xi), copy),
        "gmm": (lambda: cuda_metrics.gmm_floor(xr, xi), matmul),
        "gmm_concat": (lambda: cuda_probes.gmm_concat(xr, xi), matmul),
        "i8_concat": (lambda: cuda_probes.i8_concat(xr, xi), matmul),
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
    emit(f"check: {out['check']}  [{dev.type}]")
    out.update(time_lane_rows(xr, ops(xr, xi), OPS_PER_POINT, emit,
                              int8_per_point=INT8_PER_POINT))
    return out


def main() -> int:
    return lane_main("store", run, B, N)


if __name__ == "__main__":
    sys.exit(main())
