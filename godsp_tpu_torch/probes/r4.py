"""K14e, the lane flip, and K3's and K1's rows beside it on the card.

    python3 -m godsp_tpu_torch.probes.r4

The counterpart of tools/probe_r4.py (main): its "flip" stage asked
whether a lane reversal runs inside a kernel, exactly (the even/odd fold
of a real FFT would need it); its "rfft" stage timed K3 at 16384 x 1024;
its "8192" stage timed K1 at 2048 x 8192 with two batch tiles against
1024 x 16384 at the same point count.  Here, on two float32 planes of
b = 16384 rows x n = 1024 points made on the device from a
torch.Generator seeded with 0, first the numerics (check_numerics):
lane_flip of the TPU probe's (8, 128) input (each row 0..127) equal to
2 x its reversal, and of the (b n / 128, 128) view of a plane torch.equal
to its plain version; K3 rfft_pow2 of 256 x 1024 seeded N(0, 0.1^2)
samples >= 120 dB against float64 numpy.fft.rfft (the TPU probe's
one-shot SNR). Then each row, timed with utils.metrics.time_chain_diff:

  copy   K12 copy_split of the two planes: the copy ceiling;
  flip   lane_flip of the (b n / 128, 128) view of one plane (8 B a point
         moved: one plane read and written);
  rfft   K3 rfft_pow2 of one plane (4 B a point read, n/2 + 1 bins of 8 B
         a row written);

each beside its multiple of the copy, its bound (bytes over 3.35 TB/s, or
float32 operations over 67 TFLOP/s: 1 a point for the flip's doubling,
2.5 log2 n for the real FFT) and its library yardstick: copy_ for the
copy, torch.flip(v, (-1,)).mul_(2) for the flip, torch.fft.rfft for K3.
The TPU timed K3 as a chain of packed transforms minus its concatenation
glue, because its packed layout needed the glue; K3 here stores the
n/2 + 1 natural bins, and the packed layout is not part of the contract,
so the row is K3 alone.  Then the sweep (probes.r3.sweep) at SWEEP:
K12's copy and K1 (fft_pow2_rows) at 2048 x 8192 with 1 (K1's default)
and 2 rows a CTA, and at 1024 x 16384 with its only fit, 1 row, each
equal to fft_pow2's result, then K1's radix-2 first design
(fft_pow2_radix2), each beside torch.fft.fft.  The TPU stage's
"arbitrary" dimension_semantics cells have no CUDA meaning and are not
ported.

run(device="cpu", b=..., shapes=...) sends the same rows through the
plain versions at a cut size, for tests; a CPU time is not a device
number.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from godsp_tpu_torch._dtypes import resolve_device
from godsp_tpu_torch.dsputils import snr_db
from godsp_tpu_torch.ops import cuda_fft, cuda_metrics, cuda_probes
from godsp_tpu_torch.probes import r3
from godsp_tpu_torch.probes._common import lane_main, lane_planes, time_lane_rows

__all__ = ["B", "BYTES_PER_POINT", "LANE_ROWS", "N", "OPS_PER_POINT", "RFFT_ROWS", "ROWS",
           "SNR_DB", "SWEEP", "check_numerics", "flip_input", "main", "ops", "run"]

N, B = 1024, 16384
RFFT_ROWS = 256  # rows of the one-shot rfft check
LANE_ROWS = ("copy", "flip", "rfft")
SWEEP = {(2048, 8192): (1, 2), (1024, 16384): (1,)}
ROWS = LANE_ROWS + r3.row_names(SWEEP)
OPS_PER_POINT = {"copy": 0.0, "flip": 1.0, "rfft": 2.5 * 10}
BYTES_PER_POINT = {"copy": 16.0, "flip": 8.0, "rfft": 4.0 + 8.0 * (N // 2 + 1) / N}
SNR_DB = 120.0


def flip_input(device) -> torch.Tensor:
    """The TPU probe's flip input: (8, 128) float32, each row 0, 1, .., 127."""
    return torch.arange(128, dtype=torch.float32, device=device).repeat(8, 1)


def check_numerics(xr: torch.Tensor) -> dict:
    """lane_flip exact on the TPU probe's input and on the (b n / 128, 128)
    view of xr; K3 against float64 numpy at RFFT_ROWS x N; raises on the
    card where one falls short.  "max_abs_err" holds each kernel's largest
    absolute error against the reference it is held to."""
    x8 = flip_input(xr.device)
    want8 = 2.0 * np.arange(128, dtype=np.float32)[::-1]
    got8 = cuda_probes.lane_flip(x8).cpu().numpy()
    v = xr.view(-1, 128)
    flip = cuda_probes.lane_flip(v)
    out = {"flip_tpu_input_exact": bool((got8 == want8).all()),
           "flip_exact": bool(torch.equal(flip, cuda_probes.lane_flip_plain(v)))}
    del flip
    xs = (np.random.default_rng(0).normal(size=(RFFT_ROWS, N)) * 0.1).astype(np.float32)
    yr, yi = cuda_fft.rfft_pow2(torch.from_numpy(xs).to(xr.device))
    got = yr.double().cpu().numpy() + 1j * yi.double().cpu().numpy()
    want = np.fft.rfft(xs.astype(np.float64))
    out["rfft_vs_float64_db"] = float(snr_db(got, want))
    out["max_abs_err"] = {
        "lane_flip": 0.0 if out["flip_tpu_input_exact"] and out["flip_exact"] else float("inf"),
        "rfft_pow2": float(np.abs(got - want).max())}
    if xr.is_cuda and not (out["flip_tpu_input_exact"] and out["flip_exact"]
                           and out["rfft_vs_float64_db"] >= SNR_DB):
        raise AssertionError(f"r4 numerics {out}: fall short, timing would be meaningless")
    return out


def ops(xr: torch.Tensor, xi: torch.Tensor) -> dict:
    """Each row of LANE_ROWS: (the op, its library yardstick), ops of no
    arguments."""
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    v = xr.view(-1, 128)
    return {
        "copy": (lambda: cuda_metrics.copy_split(xr, xi), lambda: (yr.copy_(xr), yi.copy_(xi))),
        "flip": (lambda: cuda_probes.lane_flip(v), lambda: torch.flip(v, (-1,)).mul_(2.0)),
        "rfft": (lambda: cuda_fft.rfft_pow2(xr), lambda: torch.fft.rfft(xr)),
    }


def run(device=None, b: int | None = None, shapes: dict | None = None, emit=print) -> dict:
    """The numerics check, then every row of LANE_ROWS at b rows (default B)
    of N points, then K1's sweep over shapes (default SWEEP), on `device`
    (default: the card); returns {"check": {...}, row: {"ms", "bound_ms",
    "bound_by", "library_ms", "of_copy"}} and emits one line a row."""
    dev = resolve_device(device)
    b = B if b is None else b
    xr, xi = lane_planes(dev, b, N)
    out = {"check": check_numerics(xr)}
    emit(f"check: {out['check']}  [{dev.type}]")
    out.update(time_lane_rows(xr, ops(xr, xi), OPS_PER_POINT, emit,
                              bytes_per_point=BYTES_PER_POINT))
    del xr, xi
    rows, equal = r3.sweep(dev, SWEEP if shapes is None else shapes, emit)
    out["check"]["k1_rows_equal"] = equal
    emit(f"sweep: fft_pow2_rows torch.equal to fft_pow2: {equal}")
    out.update(rows)
    return out


def main() -> int:
    return lane_main("r4", run, B, N)


if __name__ == "__main__":
    sys.exit(main())
