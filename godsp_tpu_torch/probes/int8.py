"""K14g, the exact int8-limb contraction on the card, beside K13's float32
contraction floor and K12's copy ceiling: does the int8 tensor-core rate
(1,979 TOPS dense, four times TF32's) make K13's function cheaper?

    python3 -m godsp_tpu_torch.probes.int8

The counterpart of tools/probe_int8.py (main), at its shape: n = 1024
points a row (eight 128-point slices), b = 16384 rows, two float32 planes
N(0, 0.01^2) made on the device from a torch.Generator seeded with 0.
Its three stages:

  compile  i8_dot exact (torch.equal to the int32 product) on the TPU
           probe's int8 operands ((256, 128) @ (128, 128), default_rng(0))
           and on a ragged (1001, 128) @ (128, 384);
  snr      i8full's dB against the float64 exact product on the TPU
           probe's 256 rows of N(0, 0.1^2) (the same numpy draws), printed
           and not gated: the scheme sits near 120 dB by design (a row's
           block scale costs ~20 dB against float32's ~138);
  time     each row timed with utils.metrics.time_chain_diff (two chains
           of launches between CUDA events; their difference over the extra
           launches), beside its bound and its library yardstick:
    copy       K12 copy_split (the copy ceiling; copy_ into preallocated
               planes);
    gmm        K13 gmm_floor: K13's function in float32 on the CUDA cores
               (torch.matmul of the complex64 slices with K13's G, TF32 off);
    i8mm       the raw int8 MAC stream at the contraction's count (2304 MACs
               a point) on quantized inputs and random tables (none: no one
               PyTorch call quantizes three planes and sums six products);
    i8dec      the row scales and digit ladder with one stacked product a
               plane (1152 MACs a point; none, for the same reason);
    i8full     K13's function by the int8-limb Karatsuba contraction, each
               slice stored as it ends (torch.matmul, as gmm);
    i8_concat  the same with whole-row stores (probe_store.py's twin), on
               a thread-block cluster of slices with the tables resident.

Before the rows, the numerics (check_numerics, at the timed planes): i8mm
torch.equal to its plain version; i8dec, i8full and i8_concat equal to
theirs or >= 120 dB against them (the kernels repeat their plain versions'
float32 operations in order, so equality is expected); i8full and
i8_concat equal to each other.  Each wrapper's plain version does the same
integer arithmetic (the limb products exact in float64), so that is the
bar; the dB against float64 is reported beside it.  fragment_maps holds
i8mm and i8dec on identity and cyclic-shift digit tables (the mma
fragment maps).

Bounds (utils.metrics.bound_ms with the int8 operations over INT8_OPS):
16 B a point over 3.35 TB/s, 0.080 ms at 2^24 points, bounds every row;
4608 int8 operations a point (i8mm, i8full, i8_concat) take 0.039 ms,
2304 (i8dec) 0.020; K13's 768 float32 operations a point 0.192.

run(device="cpu", b=...) sends the same rows through the plain versions
at a cut size, for tests; a CPU time is not a device number.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from godsp_tpu_torch._dtypes import resolve_device
from godsp_tpu_torch.ops import cuda_metrics, cuda_probes
from godsp_tpu_torch.probes._common import (
    complex_matmul,
    lane_main,
    lane_planes,
    planes_db,
    planes_equal,
    time_lane_rows,
)

__all__ = ["B", "DOT_SHAPES", "INT8_PER_POINT", "N", "OPS_PER_POINT", "ROWS", "SNR_DB",
           "SNR_ROWS", "check_numerics", "dot_exact", "dot_inputs", "float64_db",
           "fragment_maps", "main", "ops", "run", "shift_tables"]

N, B = 1024, 16384
ROWS = ("copy", "gmm", "i8mm", "i8dec", "i8full", "i8_concat")
# The float32 operations a point each row does on the CUDA cores (quantizing,
# the digit ladder, the row max, the recombination) and its int8 operations
# on the tensor cores (two a MAC).
OPS_PER_POINT = {"copy": 0.0, "gmm": 768.0, "i8mm": 6.0, "i8dec": 14.0, "i8full": 43.0,
                 "i8_concat": 43.0}
INT8_PER_POINT = {"i8mm": 4608.0, "i8dec": 2304.0, "i8full": 4608.0, "i8_concat": 4608.0}
SNR_DB = 120.0
SNR_ROWS = 256  # rows of the float64 stage, as the TPU probe's
DOT_SHAPES = ((256, 128, 128), (1001, 128, 384))  # (m, k, n): the TPU probe's, a ragged one
_PLAIN = {"i8dec": cuda_probes.i8dec_plain, "i8full": cuda_probes.i8full_plain,
          "i8_concat": cuda_probes.i8full_plain}


def dot_inputs(device, m: int, k: int, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 a (m, k), b (k, n) uniform over [-128, 128): at (256, 128, 128)
    the TPU probe's draws from default_rng(0), else from default_rng(m)."""
    rng = np.random.default_rng(0 if (m, k, n) == DOT_SHAPES[0] else m)
    a = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
    b = rng.integers(-128, 128, size=(k, n)).astype(np.int8)
    return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)


def dot_exact(device) -> dict[str, bool]:
    """i8_dot torch.equal to the int32 product at each of DOT_SHAPES."""
    out = {}
    for m, k, n in DOT_SHAPES:
        a, b = dot_inputs(device, m, k, n)
        want = torch.from_numpy(a.cpu().numpy().astype(np.int64) @ b.cpu().numpy().astype(np.int64))
        out[f"{m}x{k}x{n}"] = torch.equal(cuda_probes.i8_dot(a, b).cpu(), want.to(torch.int32))
    return out


def float64_db(device) -> float:
    """i8full's dB against the float64 exact product (K13's function with
    its float32 G, over 128) on the TPU probe's SNR_ROWS rows of N(0, 0.1^2):
    default_rng(0) after its int8 operands, as tools/probe_int8.py:224-241."""
    rng = np.random.default_rng(0)
    rng.integers(-128, 128, size=(256, 128))
    rng.integers(-128, 128, size=(128, 128))
    xs = (rng.normal(size=(SNR_ROWS, N)) * 0.1).astype(np.float32)
    ys = (rng.normal(size=(SNR_ROWS, N)) * 0.1).astype(np.float32)
    xr, xi = torch.from_numpy(xs).to(device), torch.from_numpy(ys).to(device)
    return planes_db(cuda_probes.i8full(xr, xi),
                     cuda_probes.gmm_tf32_plain(xr.double(), xi.double()), {}, "float64")


def shift_tables(n1: int, roll: int, device) -> tuple[torch.Tensor, ...]:
    """(w0, w1, w2) whose every 128-column block is the cyclic shift
    E[i, (i + roll) mod 128] = 1 (roll 0: the identity)."""
    e = torch.roll(torch.eye(128, dtype=torch.int8, device=device), roll, dims=1)
    return tuple(e.repeat(1, k).expand(n1, -1, -1).contiguous() for k in (3, 2, 1))


def fragment_maps(xr: torch.Tensor, xi: torch.Tensor) -> dict[str, bool]:
    """With shift_tables at rolls 0 and 1, i8mm must give 3 x the sum of
    the quantized a, b, s with each slice rolled, times 1e-5, in both
    planes, exactly, and i8dec its plain version exactly (the A, B and C
    maps of the int8 mma); two launches each."""
    b, n = xr.shape
    q = sum(torch.trunc(x).clamp(-128.0, 127.0) for x in (xr * 100.0, xi * 100.0, (xr + xi) * 50.0))
    out = {}
    for roll, what in ((0, "identity"), (1, "cyclic_shift")):
        t = shift_tables(n // 128, roll, xr.device)
        y = torch.roll(q.view(b, -1, 128), roll, dims=2).reshape(b, n) * 3.0 * 1e-5
        out[what] = (planes_equal(cuda_probes.i8mm(xr, xi, t), (y, y))
                     and planes_equal(cuda_probes.i8dec(xr, xi, t),
                                      cuda_probes.i8dec_plain(xr, xi, t)))
    if xr.is_cuda and not all(out.values()):
        raise AssertionError(f"int8 fragment maps: {out}")
    return out


def check_numerics(xr: torch.Tensor, xi: torch.Tensor) -> dict:
    """The stages compile and snr, and each twin against its plain version
    at the planes (see the module's docstring): i8_dot twice, i8mm, i8dec
    and i8_concat once, i8full twice (the planes, the snr rows).  Raises on
    the card where one falls short.  "max_abs_err" holds each twin's
    largest absolute error against its plain version."""
    cp = cuda_probes
    errs: dict[str, float] = {"i8_dot": 0.0}
    out: dict = {"dot_exact": dot_exact(xr.device)}
    got = cp.i8mm(xr, xi)
    want = cp.i8mm_plain(xr, xi)
    out["i8mm_equal"] = planes_equal(got, want)
    planes_db(got, want, errs, "i8mm")
    res = {}
    for name, plain in _PLAIN.items():
        res[name] = getattr(cp, name)(xr, xi)
        want = plain(xr, xi)
        out[f"{name}_equal"] = planes_equal(res[name], want)
        out[f"{name}_vs_plain_db"] = planes_db(res[name], want, errs, name)
    out["i8full_equal_i8_concat"] = planes_equal(res["i8full"], res["i8_concat"])
    out["i8full_vs_float64_db"] = planes_db(
        res["i8full"], cp.gmm_tf32_plain(xr.double(), xi.double()), {}, "float64")
    del res, got, want
    out["i8full_vs_float64_db_snr_rows"] = float64_db(xr.device)
    if xr.is_cuda:
        bad = [k for k, v in out["dot_exact"].items() if not v]
        bad += [k for k in ("i8mm_equal", "i8full_equal_i8_concat") if not out[k]]
        bad += [k for k in (f"{name}_vs_plain_db" for name in _PLAIN) if out[k] < SNR_DB]
        if bad:
            raise AssertionError(f"int8 numerics {out}: {bad} fall short, timing would be "
                                 "meaningless")
    out["max_abs_err"] = errs
    return out


def ops(xr: torch.Tensor, xi: torch.Tensor) -> dict:
    """Each row: (the op, its library yardstick or None), ops of no arguments."""
    cp = cuda_probes
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    matmul = complex_matmul(xr, xi)
    return {
        "copy": (lambda: cuda_metrics.copy_split(xr, xi), lambda: (yr.copy_(xr), yi.copy_(xi))),
        "gmm": (lambda: cuda_metrics.gmm_floor(xr, xi), matmul),
        "i8mm": (lambda: cp.i8mm(xr, xi), None),
        "i8dec": (lambda: cp.i8dec(xr, xi), None),
        "i8full": (lambda: cp.i8full(xr, xi), matmul),
        "i8_concat": (lambda: cp.i8_concat(xr, xi), matmul),
    }


def run(device=None, b: int | None = None, emit=print) -> dict:
    """The numerics check, then every row at b rows (default B) of N points
    on `device` (default: the card); returns {"check": {...}, row: {"ms",
    "bound_ms", "bound_by", "library_ms", "of_copy"[, "int8_ms"]}} and emits
    one line a row."""
    dev = resolve_device(device)
    b = B if b is None else b
    xr, xi = lane_planes(dev, b, N)
    out = {"check": check_numerics(xr, xi)}
    emit(f"check: {out['check']}  [{dev.type}]")
    out.update(time_lane_rows(xr, ops(xr, xi), OPS_PER_POINT, emit,
                              int8_per_point=INT8_PER_POINT))
    return out


def main() -> int:
    return lane_main("int8", run, B, N)


if __name__ == "__main__":
    sys.exit(main())
