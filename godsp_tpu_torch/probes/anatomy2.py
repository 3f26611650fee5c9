"""The anatomy twins (K14d) on the card: what a shared-memory butterfly
pass, a sliced or reshaped add, and a dense 128-point DFT on the tensor
cores (one TF32 pass, then float32 accuracy by 3xTF32) cost beside the
copy ceiling and K1.

    python3 -m godsp_tpu_torch.probes.anatomy2

The counterpart of tools/probe_anatomy2.py (main), at its shape: n = 1024
points a row (eight 128-point slices), b = 16384 rows, two float32 planes
made on the device from a torch.Generator seeded with 0, and a row tw of
n floats (seed 1), random as the TPU probe's.  First the numerics
(check_numerics, at the full shape): half3, slice8 and reshape equal to
their float32 plain versions (torch.equal); bd_hi and full >= 120 dB
against their float64 plain versions; bd1 >= 120 dB against its plain
version with both operands rounded to TF32 (round_tf32) and summed in
float64, and its dB against the exact float64 product printed (one TF32
pass keeps ~11 bits an operand).  Then each row, timed with
utils.metrics.time_chain_diff (two chains of launches between CUDA
events; their difference over the extra launches):

  copy     K12 copy_split (the TPU probe's v0copy): the copy ceiling;
  half3    three butterfly rounds in shared memory (v1half3);
  slice8   x + 1 a 128-column slice a pass (v2slice8);
  reshape  x + 1 over the (b n / 128, 128) view (v3reshape);
  bd1      each slice times Re F128, one TF32 pass (v4bd1);
  bd_hi    the slices' 128-point DFT, Karatsuba in 3xTF32 (v5bd_hi);
  full     half3, the tw row and bd_hi in one kernel (v6full);
  fft1024  K1 fft_pow2 of the same planes: the kernel whose floor the
           probe takes apart;

each beside its multiple of the copy, its bound (the largest of 16 B a
point over 3.35 TB/s, the float32 operations over 67 TFLOP/s: 6 a point
for half3, 2 for the adds, 10 for full's rounds and row, 5 log2 n for the
FFT; and the TF32 operations over 495 TFLOP/s, kept as tf32_ms: 512 a
point for bd1, 2304 for the 3xTF32 Karatsuba of bd_hi and full, which do
their products on the tensor cores) and its library yardstick: copy_ for the copy,
torch.add(x, 1.0, out=y) a plane for the adds, torch.matmul of the
(b, 8, 128) real views with Re F128 WITH TF32 ON for that call only for
bd1 (cuBLAS's TF32 GEMM of the same reduced-precision function; the flag
is restored after), torch.matmul of the complex64 slices with complex64
F128, TF32 off, for bd_hi, torch.fft.fft of the complex rows for
fft1024; none for half3 and full (no one call does three rounds, or the
rounds, the row and the contraction).

run(device="cpu", b=...) sends the same rows through the plain versions
at a cut size, for tests; a CPU time is not a device number.
"""

from __future__ import annotations

import sys

import torch

from godsp_tpu_torch._dtypes import resolve_device
from godsp_tpu_torch.fft.four_step import dft_matrix
from godsp_tpu_torch.ops import cuda_fft, cuda_metrics, cuda_probes
from godsp_tpu_torch.probes._common import (
    lane_main,
    lane_planes,
    planes_db,
    planes_equal,
    tf32_matmul_on,
    time_lane_rows,
)

__all__ = ["B", "N", "OPS_PER_POINT", "ROWS", "SNR_DB", "TF32_PER_POINT", "check_numerics",
           "main", "ops", "run", "tw_row"]

N, B = 1024, 16384
ROWS = ("copy", "half3", "slice8", "reshape", "bd1", "bd_hi", "full", "fft1024")
OPS_PER_POINT = {"copy": 0.0, "half3": 6.0, "slice8": 2.0, "reshape": 2.0, "bd1": 0.0,
                 "bd_hi": 0.0, "full": 10.0, "fft1024": 5.0 * 10}
TF32_PER_POINT = {"bd1": 512.0, "bd_hi": 2304.0, "full": 2304.0}
SNR_DB = 120.0


def tw_row(device, n: int = N) -> torch.Tensor:
    """The v6full row: n float32 N(0, 1) values from a torch.Generator
    seeded with 1 (random on purpose, not a twiddle)."""
    g = torch.Generator(device=device).manual_seed(1)
    return torch.randn(n, generator=g, device=device)


def check_numerics(xr: torch.Tensor, xi: torch.Tensor, tw: torch.Tensor) -> dict:
    """Each twin against its plain version (see the module's docstring),
    one call of each wrapper; raises on the card where one falls short.
    "max_abs_err" holds each twin's largest absolute error against the
    plain version it is held to (bd_tf32: the TF32-rounded one)."""
    cp = cuda_probes
    x64 = (xr.double(), xi.double())
    errs: dict[str, float] = {}
    out = {"half3_equal": planes_equal(cp.half3(xr, xi), cp.half3_plain(xr, xi)),
           "slice8_equal": planes_equal(cp.slice8_add(xr, xi), cp.add_one_plain(xr, xi)),
           "reshape_equal": planes_equal(cp.reshape_add(xr, xi), cp.add_one_plain(xr, xi))}
    for name, key in (("half3", "half3_equal"), ("slice8_add", "slice8_equal"),
                      ("reshape_add", "reshape_equal")):
        errs[name] = 0.0 if out[key] else float("inf")
    bd1 = cp.bd_tf32(xr, xi)
    out["bd1_vs_tf32_plain_db"] = planes_db(bd1, cp.bd_tf32_plain(*x64, tf32=True), errs,
                                            "bd_tf32")
    out["bd1_vs_exact_db"] = planes_db(bd1, cp.bd_tf32_plain(*x64), {}, "exact")
    del bd1
    out["bd_hi_vs_float64_db"] = planes_db(cp.bd_hi(xr, xi), cp.bd_hi_plain(*x64), errs, "bd_hi")
    out["full_vs_float64_db"] = planes_db(cp.anat_full(xr, xi, tw),
                                          cp.anat_full_plain(*x64, tw), errs, "anat_full")
    if xr.is_cuda:
        bad = [k for k, v in out.items() if v is False]
        bad += [k for k in ("bd1_vs_tf32_plain_db", "bd_hi_vs_float64_db", "full_vs_float64_db")
                if out[k] < SNR_DB]
        if bad:
            raise AssertionError(f"anatomy2 numerics {out}: {bad} fall short, timing would be "
                                 "meaningless")
    out["max_abs_err"] = errs
    return out


def ops(xr: torch.Tensor, xi: torch.Tensor, tw: torch.Tensor) -> dict:
    """Each row: (the op, its library yardstick or None), ops of no arguments."""
    cp = cuda_probes
    b, n = xr.shape
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    vr, vi = xr.view(b, n // 128, 128), xi.view(b, n // 128, 128)
    fr = cp.re_f128(xr.device)
    z = torch.complex(xr, xi)
    zs = z.view(b, n // 128, 128)
    f = torch.from_numpy(dft_matrix(128)).to(xr.device, torch.complex64)

    def tf32_matmul():
        with tf32_matmul_on():
            return torch.matmul(vr, fr), torch.matmul(vi, fr)

    return {
        "copy": (lambda: cuda_metrics.copy_split(xr, xi), lambda: (yr.copy_(xr), yi.copy_(xi))),
        "half3": (lambda: cp.half3(xr, xi), None),
        "slice8": (lambda: cp.slice8_add(xr, xi),
                   lambda: (torch.add(xr, 1.0, out=yr), torch.add(xi, 1.0, out=yi))),
        "reshape": (lambda: cp.reshape_add(xr, xi),
                    lambda: (torch.add(xr, 1.0, out=yr), torch.add(xi, 1.0, out=yi))),
        "bd1": (lambda: cp.bd_tf32(xr, xi), tf32_matmul),
        "bd_hi": (lambda: cp.bd_hi(xr, xi), lambda: torch.matmul(zs, f)),
        "full": (lambda: cp.anat_full(xr, xi, tw), None),
        "fft1024": (lambda: cuda_fft.fft_pow2(xr, xi), lambda: torch.fft.fft(z)),
    }


def run(device=None, b: int | None = None, emit=print) -> dict:
    """The numerics check, then every row at b rows (default B) of N points
    on `device` (default: the card); returns {"check": {...}, row: {"ms",
    "bound_ms", "bound_by", "library_ms", "of_copy"[, "tf32_ms"]}} and
    emits one line a row."""
    dev = resolve_device(device)
    b = B if b is None else b
    xr, xi = lane_planes(dev, b, N)
    tw = tw_row(dev)
    out = {"check": check_numerics(xr, xi, tw)}
    emit(f"check: {out['check']}  [{dev.type}]")
    out.update(time_lane_rows(xr, ops(xr, xi, tw), OPS_PER_POINT, emit, TF32_PER_POINT))
    return out


def main() -> int:
    return lane_main("anatomy2", run, B, N)


if __name__ == "__main__":
    sys.exit(main())
