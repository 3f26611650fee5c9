"""K14g's i8full and K14a's pwfloor_frameonly as redesigned for Hopper, on
one GPU: their first designs and redesigns read from ptxas and SASS, their
times beside the first designs, the kernels they compete with, K12's copy
and the bound, and copies of the sources that split the first designs'
time or price a part of the redesigns.

    python3 -m godsp_tpu_torch.probes.i8full_frameonly [--ptxas] [--sass] [--times] [--variants]

--ptxas compiles csrc/int8_probe_kernels.cu and csrc/pwelch_probe_kernels.cu
with `-Xptxas -v` and prints the registers, stack frame, spill stores and
loads and blocks a SM (from the registers, threads and shared memory) of
i8full_kernel and i8_probe_kernel<kFULL, false> (the first design,
i8full_sync), frameonly_partials_kernel<9> (pad 1024) and frameonly_kernel
(the first design, pwfloor_frameonly_shared); a kernel not in the sources
is skipped.

--sass reads both sources' SASS (cuobjdump; the first designs' listings in
the package's git-ignored _build/i8full_sync_sass.txt and
pwfloor_frameonly_shared_sass.txt) and prints for each kernel the counts by
opcode (IMMA, LDS, STS, LDG, BAR, the float32 and conversion instructions,
...) of the loop holding its marker opcode (anat_staged.loop_counts),
scaled to its unit: for i8_probe_kernel<kFULL, false> a 16-row step a warp
(144 IMMA), for i8full_kernel a 16-row step of a product warp (144 IMMA)
and of a digit warp (its 8 cp.async), for frameonly_kernel a segment (two
BAR) and for frameonly_partials_kernel<9> a pass of its frame loop (a
segment a warp).  Beside them, the shared-memory wavefronts a step that
the products' fragment loads take, from their addresses
(cuda_probes.i8full_wavefronts).

--times times, by chain (utils.metrics.time_chain_diff) and alone (the
profiler's events of the kernel), in turns (redesign, first design, first
design, redesign): i8full at 16384 x 1024 beside i8full_sync, i8mm (the
same int8 MACs on quantized inputs, no digit ladder), i8_concat (the same
function on thread-block clusters), torch.matmul of the complex64 slices
and K13's G with TF32 off (the library call) and K12's copy;
pwfloor_frameonly at the probe geometry (16384 segments, nfft = pad =
1024, hop 512) and at 52,428 segments of hop 160 beside
pwfloor_frameonly_shared, pwfloor_loadonly and K4
(cuda_pwelch.pwelch_power_partials) on the same samples, with K4 minus
frameonly: what K4's transform, split and |X|^2 cost.  Each with its
bound, its dB against float64 (frameonly) or whether it equals its plain
version, its first design and i8_concat (i8full).

--variants builds copies of the two sources (VARIANTS) and prints each
copy's registers and time by chain beside the kernel it changes as it is:
i8full_sync with its digits and no products, with its products on fixed
digits and no digit step, with its loads and stores only, and with its
digit ladder by round-down adds in place of floor and float-to-int
conversions (checked bit for bit); pwfloor_frameonly_shared with its
segments loaded and summed without the bit-reversed round trip (checked
bit for bit) and with that round trip on values made in registers, no
load; then i8full priced with digits3's floors and conversions in place
of its round-down adds (checked bit for bit), with its digit warps alone,
its product warps alone, and with its recombination's int-to-float
conversions made by sums, always (exact at the probe's data, |q| < 2^22)
or where a vote finds a warp's limbs under 2^22 (exact for any limbs);
both checked bit for bit, the kernel keeps the conversions.  The copies
that drop work give another result on purpose.  Whether ncu is on the
machine is printed first; the wavefronts a step come from the addresses
(--sass), not from its counters.

All by default.  Prints the card's name and power limit first.  Needs a
CUDA device; imports nothing of JAX.  The checks and the redesign lines of
the smoke are chip_smoke.py's phase_i8full_frameonly_redesign.
"""

from __future__ import annotations

import ctypes
import shutil
import sys
import tempfile

import torch

from godsp_tpu_torch.probes.anat_staged import (HOP160_SEGS, _db, _line, _source_path,
                                                loop_counts, pwelch_inputs)
from godsp_tpu_torch.probes.bd1_vdif import blocks_per_sm, call_device_ms
from godsp_tpu_torch.probes.bd_hi import _compile, _function, variant_source
from godsp_tpu_torch.probes.floor_dot import _chain_ms, kernel_alone_ms

__all__ = ["B", "FRAME_GEOMETRIES", "N", "NFFT", "VARIANTS", "main"]

B, N = 16384, 1024  # the int8 probe's planes
NFFT = 1024  # the frameonly probe's frames: nfft = pad = 1024
FRAME_GEOMETRIES = ((512, 16384), (160, HOP160_SEGS))  # (hop, segments)

_I = "int8_probe_kernels.cu"
_P = "pwelch_probe_kernels.cu"
# (label, source, mangled-name part, threads a block, shared bytes at the
# probe's shapes: i8full's tables, digit buffers, input ring and row scales
# (cuda_probes.I8FULL_SMEM); the first design's tables, one digit buffer and
# row scales; frameonly's eight warps' sums (K4's slots); the first design's
# pad-point buffer and sums)
_KERNELS = (("i8full_kernel", _I, "13i8full_kernel", 384, 217_216),
            ("i8_probe_kernel<kFULL, false>", _I, "15i8_probe_kernelILi2ELb0E", 256,
             9 * 16384 + 9 * 2048 + 64),
            ("frameonly_partials_kernel<9>", _P, "25frameonly_partials_kernelILi9E", 256,
             8 * 1024 * 4),
            ("frameonly_kernel", _P, "16frameonly_kernel", 512, 1024 * 12))

# What the SASS counts are per: [(marker opcode, its count a unit, the unit)].
_UNITS = {"13i8full_kernel": [("IMMA", 144, "16-row step of a product warp"),
                              ("LDGSTS", 8, "16-row step of a digit warp")],
          "15i8_probe_kernelILi2ELb0E": [("IMMA", 144, "16-row step a warp")],
          "25frameonly_partials_kernelILi9E": [("FFMA", 0, "segment a warp")],
          "16frameonly_kernel": [("BAR", 2, "segment")]}
_SASS_FILES = {"15i8_probe_kernelILi2ELb0E": "i8full_sync_sass.txt",
               "16frameonly_kernel": "pwfloor_frameonly_shared_sass.txt"}
_SHOWN = ("IMMA", "LDS", "STS", "LDG", "LDGSTS", "STG", "BAR", "SHFL", "FADD", "FMUL", "FFMA",
          "FMNMX", "FRND", "F2I", "I2F", "I2FP", "F2IP", "PRMT", "LOP3", "IADD3", "LDL", "STL")

# i8_probe_kernel's step loop (kFULL, kRows false): its digits, its products,
# its loads.
_I8_PRODUCTS = ("        products<kMode, 0>(sd, st2, 0, acc);\n"
                "        products<kMode, 1>(sd, st2, 0, acc);\n"
                "        products<kMode, 2>(sd, st2, 0, acc);\n")
_I8_DIGITS = ("      __syncthreads();  // the tables are staged; every warp has read the last "
              "step's digits\n      digit_step<kMode>(in, sd1, s_row);\n")
_I8_FIXED = ("      __syncthreads();  // the tables are staged; every warp has read the last "
             "step's digits\n      if (t0 == r0) digit_step<kMode>(in, sd1, s_row);\n"
             "      asm volatile(\"\" ::\"f\"(in.r[0].x), \"f\"(in.r[0].y), \"f\"(in.r[0].z), "
             "\"f\"(in.r[0].w), \"f\"(in.r[1].x), \"f\"(in.r[1].y), \"f\"(in.r[1].z), "
             "\"f\"(in.r[1].w), \"f\"(in.i[0].x), \"f\"(in.i[0].y), \"f\"(in.i[0].z), "
             "\"f\"(in.i[0].w), \"f\"(in.i[1].x), \"f\"(in.i[1].y), \"f\"(in.i[1].z), "
             "\"f\"(in.i[1].w));\n")
# digits3 by round-down adds (i8full_kernel's ladder): with M = 1.5 2^(23 +
# s), x + M rounded down is M + 2^s floor(x / 2^s) for |x| < 2^(22 + s), so
# the digit is its bits less M's and 2^s times it that sum less M, exactly.
_I8_LADDER = """  const float f0 = floorf(__fmul_rn(__fadd_rn(v, kB0), 0x1p-16f));
  const float r0 = __fsub_rn(v, __fmul_rn(f0, 65536.f));
  const float f1 = floorf(__fmul_rn(__fadd_rn(r0, kB1), 0x1p-8f));
  const float r1 = __fsub_rn(r0, __fmul_rn(f1, 256.f));
  d0 = static_cast<int>(f0);
  d1 = static_cast<int>(f1);
  d2 = static_cast<int>(floorf(__fadd_rn(r1, 0.5f)));
"""
_I8_LADDER_RD = """  const float t0 = __fadd_rd(__fadd_rn(v, kB0), 0x1.8p39f);
  const float r0 = __fsub_rn(v, __fsub_rn(t0, 0x1.8p39f));
  const float t1 = __fadd_rd(__fadd_rn(r0, kB1), 0x1.8p31f);
  const float r1 = __fsub_rn(r0, __fsub_rn(t1, 0x1.8p31f));
  const float t2 = __fadd_rd(__fadd_rn(r1, 0.5f), 0x1.8p23f);
  d0 = __float_as_int(t0) - 0x53400000;
  d1 = __float_as_int(t1) - 0x4f400000;
  d2 = __float_as_int(t2) - 0x4b400000;
"""
# frameonly_kernel's segment: the bit-reversed round trip, and the load.
_FO_TRIP = """    __syncthreads();
    for (int i = threadIdx.x; i < pad; i += blockDim.x) {
      float v = 0.f;
      if (i < nfft && base + i < L) v = x[base + i] * w[i];
      s[gdsp::bit_reverse(i, log2pad)] = make_float2(v, 0.f);
    }
    __syncthreads();
    // Each thread reads back the positions it will own: the frame in
    // time order, from K4's bit-reversed layout.
    for (int i = threadIdx.x; i < pad; i += blockDim.x)
      acc[i] += ms * s[gdsp::bit_reverse(i, log2pad)].x;
"""
_FO_DIRECT = """    for (int i = threadIdx.x; i < pad; i += blockDim.x) {
      float v = 0.f;
      if (i < nfft && base + i < L) v = x[base + i] * w[i];
      acc[i] += ms * v;
    }
"""
_FO_LOAD = "      if (i < nfft && base + i < L) v = x[base + i] * w[i];\n"
_FO_REGS = "      v = static_cast<float>((i * 37 + static_cast<int>(sg)) & 1023) * 0.001f;\n"

# i8full_kernel's ladder priced: digits3's floors and conversions in place
# of the round-down adds (the same digits, the same low bytes).
_FU_LADDER = """  const float t0 = __fadd_rd(__fadd_rn(v, kB0), 0x1.8p39f);
  const float r0 = __fsub_rn(v, __fsub_rn(t0, 0x1.8p39f));
  const float t1 = __fadd_rd(__fadd_rn(r0, kB1), 0x1.8p31f);
  const float r1 = __fsub_rn(r0, __fsub_rn(t1, 0x1.8p31f));
  const float t2 = __fadd_rd(__fadd_rn(r1, 0.5f), 0x1.8p23f);
  b0 = __float_as_uint(t0);
  b1 = __float_as_uint(t1);
  b2 = __float_as_uint(t2);
"""
_FU_LADDER_FLOOR = """  int d0, d1, d2;
  digits3(v, d0, d1, d2);
  b0 = static_cast<uint32_t>(d0);
  b1 = static_cast<uint32_t>(d1);
  b2 = static_cast<uint32_t>(d2);
"""

# i8full_kernel's parts priced: its products, its digit step, and the
# recombination's int-to-float conversions (by sums with 1.5 2^23, exact
# for |q| < 2^22: the probe's data; a copy, not the kernel).
_FU_PRODUCTS = ("      fu_products<0>(sdk, st2, mw, lane, acc);\n"
                "      fu_products<1>(sdk, st2, mw, lane, acc);\n"
                "      fu_products<2>(sdk, st2, mw, lane, acc);\n")
_FU_DIGITS = "      fu_digit_step(q, sd + k * kFuDigits4, s_row + k * kTile, ks, g, t);\n"
_FU_FIXED = ("      if (i < kFuBufs)\n"
             "        fu_digit_step(q, sd + k * kFuDigits4, s_row + k * kTile, ks, g, t);\n"
             "      float keep = 0.f;\n"
             "      for (int j = 0; j < kFuLoads; ++j) keep += q[j].x + q[j].y + q[j].z + q[j].w;\n"
             "      if (keep == 1e30f) s_row[k * kTile] = keep;\n")
_FU_I2F = ("  const float v = __fadd_rn(__fadd_rn(__int2float_rn(q0), __fmul_rn(0x1p-8f, "
           "__int2float_rn(q1))),\n")
_FU_I2F_SUM = ("  auto cvt = [](int q) {\n"
               "    return __fsub_rn(__int_as_float(q + 0x4b400000), 0x1.8p23f);\n"
               "  };\n"
               "  const float v = __fadd_rn(__fadd_rn(cvt(q0), __fmul_rn(0x1p-8f, cvt(q1))),\n")
_FU_I2F2 = "                            __fmul_rn(0x1p-16f, __int2float_rn(q2)));\n"
_FU_I2F2_SUM = "                            __fmul_rn(0x1p-16f, cvt(q2)));\n"

# The recombination's conversions by sums where every limb of the warp's
# values lies under 2^22 (one vote a value), else by the conversion: exact
# for any limbs.
_FU_RECOMBINE = """\
  const float v = __fadd_rn(__fadd_rn(__int2float_rn(q0), __fmul_rn(0x1p-8f, __int2float_rn(q1))),
                            __fmul_rn(0x1p-16f, __int2float_rn(q2)));
"""
_FU_RECOMBINE_VOTE = """  const unsigned span = static_cast<unsigned>(q0 + 0x400000) |
                        static_cast<unsigned>(q1 + 0x400000) | static_cast<unsigned>(q2 + 0x400000);
  float f0, f1, f2;
  if (__all_sync(0xffffffffu, span < 0x800000u)) {
    f0 = __fsub_rn(__int_as_float(q0 + 0x4b400000), 0x1.8p23f);
    f1 = __fsub_rn(__int_as_float(q1 + 0x4b400000), 0x1.8p23f);
    f2 = __fsub_rn(__int_as_float(q2 + 0x4b400000), 0x1.8p23f);
  } else {
    f0 = __int2float_rn(q0);
    f1 = __int2float_rn(q1);
    f2 = __int2float_rn(q2);
  }
  const float v = __fadd_rn(__fadd_rn(f0, __fmul_rn(0x1p-8f, f1)), __fmul_rn(0x1p-16f, f2));
"""

# (label, source, mangled-name part, C entry, edits, check): check None (the
# result differs on purpose) or "equal" (bit for bit against the kernel as
# it is).
VARIANTS = (
    ("i8full_sync, the digits and no products", _I, "15i8_probe_kernelILi2ELb0E",
     "gdsp_i8full_sync", ((_I8_PRODUCTS, ""),), None),
    ("i8full_sync, the products on fixed digits, no digit step", _I, "15i8_probe_kernelILi2ELb0E",
     "gdsp_i8full_sync", ((_I8_DIGITS, _I8_FIXED),), None),
    ("i8full_sync, the loads and stores only", _I, "15i8_probe_kernelILi2ELb0E",
     "gdsp_i8full_sync", ((_I8_DIGITS, _I8_FIXED), (_I8_PRODUCTS, "")), None),
    ("i8full_sync, the digit ladder by round-down adds (no floor, no conversion)", _I,
     "15i8_probe_kernelILi2ELb0E", "gdsp_i8full_sync", ((_I8_LADDER, _I8_LADDER_RD),), "equal"),
    ("pwfloor_frameonly_shared, the segments loaded and summed, no round trip", _P,
     "16frameonly_kernel", "gdsp_pwfloor_frameonly_shared", ((_FO_TRIP, _FO_DIRECT),), "equal"),
    ("pwfloor_frameonly_shared, the round trip on values made in registers, no load", _P,
     "16frameonly_kernel", "gdsp_pwfloor_frameonly_shared", ((_FO_LOAD, _FO_REGS),), None),
    ("i8full with digits3's floors and conversions (the first design's ladder)", _I,
     "13i8full_kernel", "gdsp_i8full", ((_FU_LADDER, _FU_LADDER_FLOOR),), "equal"),
    ("i8full, the digit warps alone (no products)", _I, "13i8full_kernel", "gdsp_i8full",
     ((_FU_PRODUCTS, ""),), None),
    ("i8full, the product warps alone (digits made twice, then stale)", _I, "13i8full_kernel",
     "gdsp_i8full", ((_FU_DIGITS, _FU_FIXED),), None),
    ("i8full, the recombination's int-to-float by sums, no conversion", _I, "13i8full_kernel",
     "gdsp_i8full", ((_FU_I2F, _FU_I2F_SUM), (_FU_I2F2, _FU_I2F2_SUM)), "equal"),
    ("i8full, the int-to-float by sums where a warp's limbs are under 2^22 (a vote)", _I,
     "13i8full_kernel", "gdsp_i8full", ((_FU_RECOMBINE, _FU_RECOMBINE_VOTE),), "equal"),
)


def _compiled(tmp: str):
    for src in (_I, _P):
        keys = [k for _, s, k, _, _ in _KERNELS if s == src]
        with open(_source_path(src)) as fh:
            yield (src,) + _compile(fh.read(), tmp, src[:-3], keys)


def ptxas() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        for src, _, info, _ in _compiled(tmp):
            for label, s, key, threads, smem in _KERNELS:
                if s == src and key in info:
                    regs, spill = info[key]
                    print(f"ptxas {label}: {regs} registers, {threads} threads, {smem} B shared, "
                          f"{blocks_per_sm(regs, threads, smem)} blocks a SM; {spill}", flush=True)


def _shown(counts: dict) -> str:
    return ", ".join(f"{k} {counts[k]:g}" for k in _SHOWN if k in counts)


def sass() -> None:
    from godsp_tpu_torch.ops import _build
    from godsp_tpu_torch.ops import cuda_probes as cp

    with tempfile.TemporaryDirectory() as tmp:
        for src, _, info, dump in _compiled(tmp):
            for label, s, key, _, _ in _KERNELS:
                if s != src or key not in info:
                    continue
                body = _function(dump, key)
                if key in _SASS_FILES:
                    path = _build.BUILD_DIR / _SASS_FILES[key]
                    path.parent.mkdir(parents=True, exist_ok=True)
                    path.write_text(body)
                for opcode, per, unit in _UNITS[key]:
                    units, counts = loop_counts(body, opcode, per)
                    print(f"sass {label}: the innermost loop holding {opcode} ({units:g} units); "
                          f"a {unit}: {_shown(counts)}; total {counts['total']:g}", flush=True)
    for design in ("first", "redesign"):
        print(f"wavefronts {design}: {cp.i8full_wavefronts(design)}", flush=True)


def times_i8full(dev) -> None:
    from godsp_tpu_torch.fft.four_step import _tf32_off
    from godsp_tpu_torch.ops import cuda_metrics
    from godsp_tpu_torch.ops import cuda_probes as cp
    from godsp_tpu_torch.probes._common import (INT8_OPS, complex_matmul, lane_planes,
                                                planes_equal)
    from godsp_tpu_torch.utils.metrics import FP32_FLOPS, bound_ms

    probe = torch.empty(1, device=dev)
    xr, xi = lane_planes(dev, B, N, seed=26)
    pts = float(B * N)
    new, first = (lambda: cp.i8full(xr, xi)), (lambda: cp.i8full_sync(xr, xi))
    mm, cat = (lambda: cp.i8mm(xr, xi)), (lambda: cp.i8_concat(xr, xi))
    copy = lambda: cuda_metrics.copy_split(xr, xi)  # noqa: E731
    got = new()
    dbs = (f"equal to i8full_plain {planes_equal(got, cp.i8full_plain(xr, xi))}, to the first "
           f"design {planes_equal(got, first())}, to i8_concat {planes_equal(got, cat())}; "
           f"{_db(got, cp.gmm_tf32_plain(xr.double(), xi.double())):.2f} dB against float64")
    bnd = bound_ms(16.0 * pts, max(43.0 * pts, 4608.0 * pts * FP32_FLOPS / INT8_OPS))
    with _tf32_off():
        matmul = complex_matmul(xr, xi)
        chains = [(label, _chain_ms(op, probe)) for label, op in (
            ("i8full", new), ("first design", first), ("first design", first), ("i8full", new),
            ("i8mm", mm), ("i8_concat", cat), ("torch.matmul", matmul), ("K12 copy", copy))]
        alone = [("i8full", kernel_alone_ms("i8full_kernel", new, 20)),
                 ("first design", kernel_alone_ms("i8_probe_kernel", first, 20)),
                 ("i8mm", kernel_alone_ms("i8_probe_kernel", mm, 20)),
                 ("i8_concat", kernel_alone_ms("i8_concat_kernel", cat, 20)),
                 ("torch.matmul", call_device_ms(matmul)),
                 ("K12 copy", kernel_alone_ms("copy_split_kernel", copy, 20))]
    _line("i8full", f"{B} x {N}", dbs, bnd, chains, alone)


def times_frameonly(dev) -> None:
    from godsp_tpu_torch.ops import cuda_probes as cp
    from godsp_tpu_torch.ops import cuda_pwelch
    from godsp_tpu_torch.utils.metrics import bound_ms

    for hop, segs in FRAME_GEOMETRIES:
        ext, mask, w = pwelch_inputs(dev, hop, segs)
        probe = torch.empty(1, device=dev)
        bt = cuda_pwelch.segs_per_tile(segs, 1)
        new = lambda: cp.pwfloor_frameonly(ext, mask, w, NFFT, hop)  # noqa: E731
        first = lambda: cp.pwfloor_frameonly_shared(ext, mask, w, NFFT, hop)  # noqa: E731
        load = lambda: cp.pwfloor_loadonly(ext, mask, w, NFFT, hop)  # noqa: E731
        k4 = lambda: cuda_pwelch.pwelch_power_partials(ext, mask, w, NFFT, hop)  # noqa: E731
        want = cp.pwfloor_frameonly_plain(ext.double(), mask.double(), w.double(), NFFT, hop,
                                          NFFT, bt)
        dbs = f"{_db(new(), want):.2f} dB, first design {_db(first(), want):.2f}; tiles of {bt}"
        tiles = -(-segs // bt)
        bnd = bound_ms(4.0 * (ext.numel() + segs + NFFT + tiles * NFFT), 2.0 * segs * NFFT)
        chains = [(label, _chain_ms(op, probe)) for label, op in (
            ("frameonly", new), ("first design", first), ("first design", first),
            ("frameonly", new), ("loadonly", load), ("K4", k4))]
        alone = [("frameonly", kernel_alone_ms("frameonly_partials_kernel", new, 20)),
                 ("first design", kernel_alone_ms("frameonly_kernel", first, 20)),
                 ("loadonly", kernel_alone_ms("loadonly_kernel", load, 20)),
                 ("K4", kernel_alone_ms("pwelch_partials_kernel", k4, 20))]
        _line("pwfloor_frameonly", f"{segs} segments of {NFFT}, hop {hop}", dbs, bnd, chains,
              alone)
        fo = (chains[0][1] + chains[3][1]) / 2
        print(f"K4 minus frameonly, hop {hop}: {chains[5][1] - fo:.4f} ms by chain (K4 "
              f"{chains[5][1]:.4f}, frameonly {fo:.4f}): K4's transform, split and |X|^2",
              flush=True)
        del ext, mask, w, want


def _i8_entry(lib, entry: str, xr, xi, packed):
    """entry (gdsp_i8full_sync, or gdsp_i8full with store_rows 0 and the
    card's resident CTAs) of a copy's library on the planes."""
    from godsp_tpu_torch.ops import cuda_probes as cp

    p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    extra = (0, cp._i8full_resident(xr.device)) if entry == "gdsp_i8full" else ()
    fn = getattr(lib, entry)
    fn.argtypes = [p, p, p, p, p, i64, i] + [i] * len(extra) + [p]
    fn.restype = i
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)

    def run():
        rc = fn(xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(), packed.data_ptr(),
                xr.shape[0], xr.shape[1], *extra,
                torch.cuda.current_stream(xr.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{entry}: CUDA error {rc}")
        return yr, yi
    return run


def _frameonly_entry(lib, entry: str, ext, mask, w, hop: int):
    from godsp_tpu_torch.ops import cuda_pwelch

    p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn = getattr(lib, entry)
    fn.argtypes = [p, p, p, p, i64, i64, i64, i, i, i, i, i, p]
    fn.restype = i
    S = mask.shape[-1]
    bt = cuda_pwelch.segs_per_tile(S, 1)
    out = torch.empty(-(-S // bt), NFFT, device=ext.device)

    def run():
        rc = fn(ext.data_ptr(), mask.data_ptr(), w.data_ptr(), out.data_ptr(), 1, ext.shape[-1],
                S, NFFT, hop, NFFT.bit_length() - 1, bt, -(-S // bt),
                torch.cuda.current_stream(ext.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{entry}: CUDA error {rc}")
        return out
    return run


def variants(dev) -> None:
    """Each VARIANTS copy against the kernel it changes, by chain: the i8full
    copies at 16384 x 1024, the frameonly copies at both FRAME_GEOMETRIES."""
    from godsp_tpu_torch.ops import cuda_probes as cp
    from godsp_tpu_torch.probes._common import lane_planes, planes_equal

    ncu = shutil.which("ncu")
    print(f"ncu: {'found at ' + ncu if ncu else 'not on this machine'}; the wavefronts a step "
          f"are counted from the fragment addresses (--sass)", flush=True)
    probe = torch.empty(1, device=dev)
    xr, xi = lane_planes(dev, B, N, seed=26)
    packed = cp._i8full_packed(N, dev)
    frames = [(f"hop {hop}", hop, *pwelch_inputs(dev, hop, segs))
              for hop, segs in FRAME_GEOMETRIES]
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for j, (label, src, key, entry, edits, check) in enumerate(VARIANTS):
            try:
                source = variant_source(src, edits)
            except LookupError as e:  # a copy's edit on a tree without its line
                print(f"variant {label}: not built ({e})", flush=True)
                continue
            lib, info, _ = _compile(source, tmp, f"variant_{j}", (key,))
            regs, spill = info[key]
            wrapper = getattr(cp, entry[len("gdsp_"):])  # the kernel as it is
            if src == _I:
                cases = [(label, _i8_entry(lib, entry, xr, xi, packed), (xr, xi))]
            else:
                cases = [(f"{label}, {at}", _frameonly_entry(lib, entry, e, m, w, hop),
                          (e, m, w, NFFT, hop)) for at, hop, e, m, w in frames]
            for text, run, args in cases:
                base = lambda args=args: wrapper(*args)  # noqa: E731
                got = run()
                torch.cuda.synchronize()
                note = "another result, on purpose"
                if check == "equal":
                    same = planes_equal(got, base()) if src == _I else torch.equal(got, base())
                    if not same:
                        raise AssertionError(f"{text}: not equal to the kernel as it is")
                    note = "equal to the kernel as it is"
                rows.append((text, _chain_ms(base, probe), _chain_ms(run, probe),
                             _chain_ms(base, probe), f"{regs} registers; {spill}; {note}"))
    for label, before, ms, after, regs in rows:
        print(f"variant {label}: {ms:.4f} ms by chain (the kernel as it is {before:.4f} / "
              f"{after:.4f}); {regs}", flush=True)


def main(argv: list[str] | None = None) -> int:
    from godsp_tpu_torch import set_default_device
    from godsp_tpu_torch.probes._common import card

    argv = sys.argv[1:] if argv is None else argv
    parts = [a.lstrip("-") for a in argv] or ["ptxas", "sass", "times", "variants"]
    if not torch.cuda.is_available():
        raise SystemExit("i8full_frameonly: needs an NVIDIA GPU (torch.cuda.is_available() is "
                         "false)")
    print(f"nvidia-smi: {card()}", flush=True)
    set_default_device("cuda")
    dev = torch.device("cuda", 0)
    for part in parts:
        {"ptxas": ptxas, "sass": sass,
         "times": lambda: (times_i8full(dev), times_frameonly(dev)),
         "variants": lambda: variants(dev)}[part]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
