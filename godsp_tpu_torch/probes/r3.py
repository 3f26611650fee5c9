"""K14f, the TPU's lane-slice K1 taken apart on the card: the slice
network, K13's contraction in one TF32 pass, and network and contraction
in one kernel with its store, chunk and rows-a-block settings, beside
K12's copy, K14c's sliced copy, K13 and K1; then K1's rows-a-block sweep.

    python3 -m godsp_tpu_torch.probes.r3

The counterpart of tools/probe_r3.py: its anatomy1024 section (run_variant
over thirteen bodies) at its shape, n = 1024 points a row (eight 128-point
slices), b = 16384 rows, two float32 planes made on the device from a
torch.Generator seeded with 0; then its bt4096, bt8192 and ls16384
sections as one sweep of K1's rows a block (SWEEP). First the numerics
(check_numerics, at the full shape): ls_network and ls_full >= 120 dB
against their float64 plain versions (ls_full also against float64
torch.fft.fft in the lane-slice digit order); gmm_tf32 >= 120 dB against
its plain version with TF32-rounded operands summed in float64, its dB
against the exact product printed (one TF32 pass keeps ~11 bits an
operand); every ls_full setting torch.equal to the default launch. Then
each row, timed with utils.metrics.time_chain_diff (two chains of launches
between CUDA events; their difference over the extra launches):

  copy         K12 copy_split (the TPU probe's k_copy);
  sliced       K14c slicestore (k_copy_sliced);
  network      ls_network (k_step1_only);
  gmm_hi       K13 gmm_floor (k_gmm_only: G at HIGHEST, float32 here);
  gmm_default  gmm_tf32 (k_gmm_default: one TF32 pass a product, by
               wgmma fed by TMA);
  full         ls_full, slices stored as each contraction ends (k_full);
  full_concat  ls_full(store="rows"): whole rows after the tile
               (k_full_concat);
  sub2, sub4, sub8  ls_full(chunks=2, 4, 8) (make_subtiled(2, 4, 8));
  full_rows32, full_rows64  ls_full(rows_per_block=32, 64): the TPU's
               bt 512 and 1024 (its rows a grid step) mapped x2 and x4 of
               the default 16 rows a block (bt 256): 512 and 256 blocks of
               the 132 SMs' one block each;
  fft1024      K1 fft_pow2 of the same planes;

each beside its multiple of the copy, its bound (16 B a point over 3.35
TB/s, or the float32 operations the function needs over 67 TFLOP/s: 15 a
point for the network's n1-point DFT, 768 for K13's contraction, 5 log2 n
for the 1024-point DFT of ls_full's rows and K1, so bytes bound both; and
gmm_tf32's 768 TF32 operations a point over 495 TFLOP/s, kept as tf32_ms;
ls_full's method does 768 + 15 float32 operations a point, 0.196 ms, not
its bound) and its library yardstick: copy_ into preallocated planes for
the copies; torch.fft.fft across the slices of the complex rows (dim 1 of
their (b, n1, 128) view) for the network;
torch.matmul of the complex64 slices with K13's G, TF32 off, for gmm_hi;
the three real torch.matmuls of the Karatsuba form WITH TF32 ON for that
call only for gmm_default (the flag restored after); torch.fft.fft of the
complex rows for ls_full's rows and fft1024 (natural order, a permutation
of ls_full's bins).  The TPU probe's "full kernel PARALLEL sem" row is a
dimension_semantics knob with no CUDA meaning and is not ported.

The sweep (sweep): at each shape of SWEEP, b x n rows x points (2^24
points each), K12's copy, then K1 (fft_pow2_rows) at each rows a CTA,
its result torch.equal to fft_pow2's first, then K1's radix-2 first
design (cuda_probes.fft_pow2_radix2), each beside torch.fft.fft.  16384 x
1024 and 65536 x 256 hold K1's default 8 rows a CTA and 16 (a row in one
warp, eight warps a CTA; 16 warps is the launch bound); 4096 x 4096,
2048 x 8192 and 1024 x 16384 are the TPU's bt4096, bt8192 and ls16384
sections (a row a CTA of 256, 512 and 1024 threads, the default; 16384
points take 128 KB and 1024 threads, so 2 rows do not fit).  The
TPU's ls16384 timed its lane-slice kernel at n1 = 128, a choice inside K1
there; ls_full is written for n1 <= 8 (at n1 = 128 it would stream 24 MB
of G a row), so that row is K1 at 16384.

run(device="cpu", b=..., shapes=...) sends the same rows through the plain
versions at a cut size, for tests; a CPU time is not a device number.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from godsp_tpu_torch._dtypes import resolve_device
from godsp_tpu_torch.ops import cuda_fft, cuda_metrics, cuda_probes
from godsp_tpu_torch.probes._common import (
    complex_matmul,
    lane_main,
    lane_planes,
    planes_db,
    planes_equal,
    tf32_matmul_on,
    time_lane_rows,
)

__all__ = ["B", "FULL_SETTINGS", "LANE_ROWS", "N", "OPS_PER_POINT", "ROWS", "SNR_DB", "SWEEP",
           "TF32_PER_POINT", "check_numerics", "main", "ops", "row_names", "run", "sweep"]

N, B = 1024, 16384
# ls_full's settings by row: the TPU body each one twins.
FULL_SETTINGS = {"full": {}, "full_concat": {"store": "rows"}, "sub2": {"chunks": 2},
                 "sub4": {"chunks": 4}, "sub8": {"chunks": 8},
                 "full_rows32": {"rows_per_block": 32}, "full_rows64": {"rows_per_block": 64}}
LANE_ROWS = ("copy", "sliced", "network", "gmm_hi", "gmm_default", *FULL_SETTINGS, "fft1024")
# K1's rows a CTA swept at each (rows, points): 2^24 points each.
SWEEP = {(16384, 1024): (1, 2, 4, 8, 16), (65536, 256): (4, 8, 16, 32), (4096, 4096): (1, 2, 4),
         (2048, 8192): (1, 2), (1024, 16384): (1,)}
# The float32 operations a point each row's function needs: ls_full's rows
# compute the DFT of the row, as K1 does (its method does 768 + 15).
OPS_PER_POINT = {"copy": 0.0, "sliced": 0.0, "network": 15.0, "gmm_hi": 768.0,
                 "gmm_default": 0.0, **{name: 5.0 * 10 for name in FULL_SETTINGS},
                 "fft1024": 5.0 * 10}
TF32_PER_POINT = {"gmm_default": 768.0}
SNR_DB = 120.0


def row_names(shapes: dict) -> tuple[str, ...]:
    """The sweep's rows over shapes ({(b, n): rows a block}): each shape's
    copy, then K1 at each rows a block, then K1's radix-2 first design."""
    return tuple(name for (b, n), rpbs in shapes.items()
                 for name in (f"copy_{b}x{n}", *(f"k1_{b}x{n}_rows{r}" for r in rpbs),
                              f"k1_{b}x{n}_radix2"))


ROWS = LANE_ROWS + row_names(SWEEP)


def check_numerics(xr: torch.Tensor, xi: torch.Tensor) -> dict:
    """The twins against their plain versions (see the module's docstring),
    one call of ls_network and gmm_tf32 and one of ls_full a setting; raises
    on the card where one falls short.  "max_abs_err" holds each twin's
    largest absolute error against the plain version it is held to
    (gmm_tf32: the TF32-rounded one)."""
    cp = cuda_probes
    x64 = (xr.double(), xi.double())
    n1 = xr.shape[1] // 128
    errs: dict[str, float] = {}
    out = {"network_vs_float64_db": planes_db(cp.ls_network(xr, xi),
                                              cp.ls_network_plain(*x64), errs, "ls_network")}
    g = cp.gmm_tf32(xr, xi)
    out["gmm_default_vs_tf32_plain_db"] = planes_db(g, cp.gmm_tf32_plain(*x64, tf32=True),
                                                    errs, "gmm_tf32")
    out["gmm_default_vs_exact_db"] = planes_db(g, cp.gmm_tf32_plain(*x64), {}, "exact")
    del g
    full = cp.ls_full(xr, xi)
    out["full_vs_float64_db"] = planes_db(full, cp.ls_full_plain(*x64), errs, "ls_full")
    fft = cp.ls_digit_order(torch.fft.fft(torch.complex(*x64)), n1)
    out["full_vs_fft_db"] = planes_db(full, (fft.real, fft.imag), {}, "fft")
    del fft
    out["full_settings_equal"] = {name: planes_equal(cp.ls_full(xr, xi, **kw), full)
                                  for name, kw in FULL_SETTINGS.items() if kw}
    if xr.is_cuda:
        bad = [k for k, v in out["full_settings_equal"].items() if not v]
        bad += [k for k in ("network_vs_float64_db", "gmm_default_vs_tf32_plain_db",
                            "full_vs_float64_db", "full_vs_fft_db") if out[k] < SNR_DB]
        if bad:
            raise AssertionError(f"r3 numerics {out}: {bad} fall short, timing would be "
                                 "meaningless")
    out["max_abs_err"] = errs
    return out


def ops(xr: torch.Tensor, xi: torch.Tensor) -> dict:
    """Each row of LANE_ROWS: (the op, its library yardstick), ops of no
    arguments."""
    cp = cuda_probes
    b, n = xr.shape
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    z = torch.complex(xr, xi)
    zs = z.view(b, n // 128, 128)
    a, c = (v.view(b, n // 128, 128).transpose(0, 1).contiguous() for v in (xr, xi))
    s = a + c
    gt = cuda_metrics.gmm_tables(n, xr.device)
    gr, gi, gs = (gt[:, p].contiguous() for p in range(3))

    def tf32_matmuls():
        with tf32_matmul_on():
            return a @ gr, c @ gi, s @ gs

    def copy():
        return yr.copy_(xr), yi.copy_(xi)

    def fft():
        return torch.fft.fft(z)

    return {
        "copy": (lambda: cuda_metrics.copy_split(xr, xi), copy),
        "sliced": (lambda: cp.slicestore(xr, xi), copy),
        "network": (lambda: cp.ls_network(xr, xi), lambda: torch.fft.fft(zs, dim=1)),
        "gmm_hi": (lambda: cuda_metrics.gmm_floor(xr, xi), complex_matmul(xr, xi)),
        "gmm_default": (lambda: cp.gmm_tf32(xr, xi), tf32_matmuls),
        **{name: (lambda kw=kw: cp.ls_full(xr, xi, **kw), fft)
           for name, kw in FULL_SETTINGS.items()},
        "fft1024": (lambda: cuda_fft.fft_pow2(xr, xi), fft),
    }


def sweep(device, shapes: dict, emit) -> tuple[dict, dict]:
    """K1's rows-a-CTA sweep over shapes ({(b, n): rows a CTA}): at each
    shape K12's copy, then fft_pow2_rows at each setting (its result
    torch.equal to fft_pow2's first; raises on the card where one is not),
    then fft_pow2_radix2 (K1's first design, the same function), each
    beside torch.fft.fft.  Returns ({row: timing}, {shape: equal})."""
    rows, equal = {}, {}
    for (b, n), rpbs in shapes.items():
        xr, xi = lane_planes(device, b, n, seed=n)
        k1 = cuda_fft.fft_pow2(xr, xi)
        same = all(planes_equal(cuda_probes.fft_pow2_rows(xr, xi, r), k1) for r in rpbs)
        del k1
        equal[f"{b}x{n}"] = same
        if xr.is_cuda and not same:
            raise AssertionError(f"fft_pow2_rows at {b} x {n}: a setting differs from K1")
        yr, yi = torch.empty_like(xr), torch.empty_like(xi)
        z = torch.complex(xr, xi)
        timed = {"copy": (lambda: cuda_metrics.copy_split(xr, xi),
                          lambda: (yr.copy_(xr), yi.copy_(xi))),
                 **{f"rows{r}": (lambda r=r: cuda_probes.fft_pow2_rows(xr, xi, r),
                                 lambda: torch.fft.fft(z)) for r in rpbs},
                 "radix2": (lambda: cuda_probes.fft_pow2_radix2(xr, xi),
                            lambda: torch.fft.fft(z))}
        flops = {"copy": 0.0, "radix2": 5.0 * np.log2(n),
                 **{f"rows{r}": 5.0 * np.log2(n) for r in rpbs}}
        res = time_lane_rows(xr, timed, flops, emit)
        rows[f"copy_{b}x{n}"] = res.pop("copy")
        rows.update({f"k1_{b}x{n}_{k}": v for k, v in res.items()})
        del xr, xi, yr, yi, z
    return rows, equal


def run(device=None, b: int | None = None, shapes: dict | None = None, emit=print) -> dict:
    """The numerics check, then every row of LANE_ROWS at b rows (default B)
    of N points, then the sweep over shapes (default SWEEP), on `device`
    (default: the card); returns {"check": {...}, row: {"ms", "bound_ms",
    "bound_by", "library_ms", "of_copy"[, "tf32_ms"]}} and emits one line a
    row."""
    dev = resolve_device(device)
    b = B if b is None else b
    xr, xi = lane_planes(dev, b, N)
    out = {"check": check_numerics(xr, xi)}
    emit(f"check: {out['check']}  [{dev.type}]")
    out.update(time_lane_rows(xr, ops(xr, xi), OPS_PER_POINT, emit, TF32_PER_POINT))
    del xr, xi
    rows, equal = sweep(dev, SWEEP if shapes is None else shapes, emit)
    out["check"]["k1_rows_equal"] = equal
    emit(f"sweep: fft_pow2_rows torch.equal to fft_pow2: {equal}")
    out.update(rows)
    return out


def main() -> int:
    return lane_main("r3", run, B, N)


if __name__ == "__main__":
    sys.exit(main())
