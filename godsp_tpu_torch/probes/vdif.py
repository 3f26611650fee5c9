"""K14h, the lane DIF by warp shuffles (vdif), beside K12's copy, K14b's
factored DFT and K1 on the card.

    python3 -m godsp_tpu_torch.probes.vdif

The counterpart of tools/probe_vdif.py (main), at its timing shape: n =
1024 points a row (n1 = 8 slices of 128), b = 16384 rows, two float32
planes made on the device from a torch.Generator seeded with 0, scale
1/sqrt(n).  First the numerics (check_numerics, at the full shape): vdif
>= 120 dB against its float64 plain version and against float64
torch.fft.fft in vdif digit order, and the digit order exact: for a single
complex exponential at bin k the largest output sits at position
(k mod n1) 128 + brev7(k // n1) (digit_order_exact).  Then each row, timed
with utils.metrics.time_chain_diff (two chains of launches between CUDA
events; their difference over the extra launches):

  copy     K12 copy_split: the copy ceiling;
  vdif     K14h vdif: the slice network, the twiddle T and a 128-point
           radix-2 DIF by warp shuffles (the TPU probe's vdif row);
  fac_dft  K14b fac_dft: K13's twiddled 128-point slice DFT factored as
           16 x 8;
  fft1024  K1 fft_pow2 of the same planes;

each beside its multiple of the copy, its bound (utils.metrics.bound_ms:
16 B a point over 3.35 TB/s, or the float32 operations over 67 TFLOP/s:
5 log2 n + 6 = 56 a point for vdif (a radix-2 FFT and T), 204 for fac_dft,
5 log2 n for K1) and its library yardstick: copy_ into preallocated planes
for the copy, torch.fft.fft of the complex rows for vdif (norm="ortho":
the same scale; natural order, a permutation of vdif's bins) and for
fft1024, torch.matmul of the complex64 slices with K13's G (TF32 off) for
fac_dft, as probes.facdft.

run(device="cpu", b=...) sends the same rows through the plain versions
at a cut size, for tests; a CPU time is not a device number.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from godsp_tpu_torch._dtypes import resolve_device
from godsp_tpu_torch.dsputils import snr_db
from godsp_tpu_torch.ops import cuda_fft, cuda_metrics, cuda_probes
from godsp_tpu_torch.probes._common import complex_matmul, lane_main, lane_planes, time_lane_rows

__all__ = ["B", "N", "OPS_PER_POINT", "ROWS", "SCALE", "SNR_DB", "check_numerics",
           "digit_order_exact", "main", "ops", "run"]

N, B = 1024, 16384
SCALE = 1.0 / np.sqrt(N)
ROWS = ("copy", "vdif", "fac_dft", "fft1024")
OPS_PER_POINT = {"copy": 0.0, "vdif": 5.0 * 10 + 6.0, "fac_dft": 204.0, "fft1024": 5.0 * 10}
SNR_DB = 120.0
DIGIT_BINS = (0, 1, 2, 7, 8, 9, 127, 128, 129, 500, 511, 640, 1000, 1023)


def _c(planes) -> np.ndarray:
    return (planes[0].double() + 1j * planes[1].double()).cpu().numpy()


def digit_order_exact(device, n: int = N, scale: float = SCALE) -> bool:
    """vdif of single complex exponentials at the bins DIGIT_BINS (those
    below n) peaks, row by row, at position (k mod n1) 128 + brev7(k // n1)."""
    n1 = n // 128
    ks = torch.tensor([k for k in DIGIT_BINS if k < n], dtype=torch.float64)
    ang = 2.0 * np.pi * torch.outer(ks, torch.arange(n, dtype=torch.float64)) / n
    xr, xi = (v.float().to(device) for v in (torch.cos(ang), torch.sin(ang)))
    yr, yi = cuda_probes.vdif(xr, xi, scale)
    peak = (yr * yr + yi * yi).argmax(dim=1).cpu()
    kk = ks.long()
    want = (kk % n1) * 128 + cuda_probes.brev7_perm()[kk // n1]
    return bool(torch.equal(peak, want))


def check_numerics(xr: torch.Tensor, xi: torch.Tensor, scale: float = SCALE) -> dict:
    """vdif against its float64 plain version and against float64
    torch.fft.fft in digit order, and the digit order; raises on the card
    where one falls short.  "max_abs_err" holds vdif's largest absolute
    error against the float64 plain version."""
    n1 = xr.shape[1] // 128
    got = _c(cuda_probes.vdif(xr, xi, scale))
    want = _c(cuda_probes.vdif_plain(xr.double(), xi.double(), scale))
    fft = cuda_probes.vdif_digit_order(
        torch.fft.fft(torch.complex(xr.double(), xi.double())) * scale, n1).cpu().numpy()
    out = {"vdif_vs_float64_db": float(snr_db(got, want)),
           "vdif_vs_fft_db": float(snr_db(got, fft)),
           "digit_order_exact": digit_order_exact(xr.device, xr.shape[1], scale),
           "max_abs_err": {"vdif": float(np.abs(got - want).max(initial=0.0))}}
    if xr.is_cuda and (min(out["vdif_vs_float64_db"], out["vdif_vs_fft_db"]) < SNR_DB
                       or not out["digit_order_exact"]):
        raise AssertionError(f"vdif numerics {out}: fall short, timing would be meaningless")
    return out


def ops(xr: torch.Tensor, xi: torch.Tensor) -> dict:
    """Each row: (the op, its library yardstick), ops of no arguments."""
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    z = torch.complex(xr, xi)
    return {
        "copy": (lambda: cuda_metrics.copy_split(xr, xi), lambda: (yr.copy_(xr), yi.copy_(xi))),
        "vdif": (lambda: cuda_probes.vdif(xr, xi, SCALE), lambda: torch.fft.fft(z, norm="ortho")),
        "fac_dft": (lambda: cuda_probes.fac_dft(xr, xi), complex_matmul(xr, xi)),
        "fft1024": (lambda: cuda_fft.fft_pow2(xr, xi), lambda: torch.fft.fft(z)),
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
    out.update(time_lane_rows(xr, ops(xr, xi), OPS_PER_POINT, emit))
    return out


def main() -> int:
    return lane_main("vdif", run, B, N)


if __name__ == "__main__":
    sys.exit(main())
