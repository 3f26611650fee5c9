"""K14d's anat_full and K14a's pwfloor_staged as redesigned for Hopper, on one
GPU: their first designs and redesigns read from ptxas and SASS, their
times beside the first designs, the routes they compete with, K12's copy
and the bound, and copies of the first designs that split their time.

    python3 -m godsp_tpu_torch.probes.anat_staged [--ptxas] [--sass] [--times] [--variants]
                                                  [--tune]

--ptxas compiles csrc/anatomy_probe_kernels.cu and
csrc/pwelch_probe_kernels.cu with `-Xptxas -v` and prints the registers,
stack frame, spill stores and loads and blocks a SM (from the registers,
threads and shared memory) of anat_full_kernel, anat_full_sync_kernel,
staged_partials_kernel<9> (pad 1024) and spectral_twin_kernel<true>.

--sass reads both sources' SASS (cuobjdump; the first designs' listings in
the package's git-ignored _build/anat_full_sync_sass.txt and
pwfloor_staged_radix2_sass.txt) and prints for each kernel the counts by
opcode (HMMA/HGMMA, LDG, LDS, BAR, SHFL, FADD, FFMA, ...) of the innermost
loop holding its marker opcode (sass_counts), scaled to its unit: for
anat_full_sync the k-step loop of a warp's 16-row tile (72 HMMA a k-step;
a 64-row tile of a slice is 128 such k-steps: 4 warps' tiles x 2 bin
halves x 16), for anat_full the item loop (144 HGMMA a warpgroup: a
64-row tile of a slice, 32 bins), for spectral_twin_kernel<true> the
radix-2 stage loop (one BAR a stage, 10 a segment at pad 1024) and the
segment loop around it, and for staged_partials_kernel<9> the frame loop
(a segment a warp at pad 1024).

--times times, by chain (utils.metrics.time_chain_diff) and alone (the
profiler's events of the kernel; of a route of several launches, the
device time of all of them a call): anat_full at 16384 x 1024 beside
anat_full_sync, the unfused route (half3, the tw row as torch's
elementwise calls, bd_hi), bd_hi and half3 alone, and K12's copy;
pwfloor_staged beside pwfloor_staged_radix2 and K4
(cuda_pwelch.pwelch_power_partials) at the same tiles, at the probe
geometry (16384 segments, nfft = pad = 1024, hop 512) and at hop 160
(52,428 segments); in turns (redesign, first design, first design,
redesign), each with its bound and its dB against float64.

--variants builds copies of the two sources with a first design changed
(VARIANTS) and prints each copy's registers and time by chain beside the
first design as it is: anat_full_sync with its rows staged and stored
(no rounds, no row, no products), staged with the rounds and the row and
stored (no products), and staged without the rounds and the row, then
contracted; pwfloor_staged_radix2 with the span staged and summed, no
segment's transform.  Their results differ from the function on purpose.

--tune builds copies of the anatomy source with one part of anat_full
changed (TUNE), checks that each gives the redesign's result bit for bit,
and prints each copy's registers and time by chain beside the redesign as
it is: 16-column k-boxes in two 16 KB stages, or 8-column ones in four of
8 KB, in place of 32-column ones in one stage of 32 KB; then two copies that price a part, whose results differ on
purpose: without the partner k-boxes (half the bytes a stage), and without
the rounds and the row (the own values split as bd_hi splits them).

All by default.  Prints the card's name and power limit first.  Needs a
CUDA device; imports nothing of JAX.  The checks and the redesign lines of
the smoke are chip_smoke.py's phase 3 (phase_anat_staged_redesign).
"""

from __future__ import annotations

import collections
import sys
import tempfile

import torch

from godsp_tpu_torch.probes.bd1_vdif import _instructions, _opcode, blocks_per_sm, call_device_ms
from godsp_tpu_torch.probes.bd_hi import _compile, _entry, _function, variant_source
from godsp_tpu_torch.probes.floor_dot import _chain_ms, _fmt, kernel_alone_ms

__all__ = ["B", "HOP160_SEGS", "N", "TUNE", "VARIANTS", "loop_counts", "main", "unfused_route"]

B, N = 16384, 1024  # the anatomy probe's planes
HOP160_SEGS = (1 << 23) // 160  # 52,428 segments of hop 160 (phase 3's K4 line)

_A = "anatomy_probe_kernels.cu"
_P = "pwelch_probe_kernels.cu"
# (label, source, mangled-name part, threads a block, dynamic shared bytes at
# the probe's shapes: anat_full_sync's 16 staged rows of 1028 floats a plane
# and the tables; spectral_twin's pad-point buffer, its sums and a 16-segment
# span; staged_partials' eight 512-point slots and the span, 16-byte aligned,
# and its mbarrier)
_KERNELS = (("anat_full_kernel", _A, "16anat_full_kernel", 256, 230_412),
            ("bd_hi_kernel", _A, "12bd_hi_kernel", 256, 230_424),
            ("anat_full_sync_kernel", _A, "21anat_full_sync_kernel", 256,
             (768 + 2 * 16 * 1028) * 4),
            ("staged_partials_kernel<9>", _P, "22staged_partials_kernelILi9E", 256,
             8 * 512 * 8 + 8704 * 4 + 16 + 8),
            ("spectral_twin_kernel<true>", _P, "20spectral_twin_kernelILb1E", 512,
             1024 * 8 + 513 * 4 + 8704 * 4))

# What the SASS counts are per: (mangled-name part, marker opcode, its count
# a unit, the unit, the outer loop too).
_UNITS = {"16anat_full_kernel": ("HGMMA", 144, "64-row item of a warpgroup", False),
          "12bd_hi_kernel": ("HGMMA", 144, "64-row item of a warpgroup", False),
          "21anat_full_sync_kernel": ("HMMA", 72, "k-step of a warp's 16-row tile", True),
          "22staged_partials_kernelILi9E": ("FFMA", 0, "frame-loop iteration", False),
          "20spectral_twin_kernelILb1E": ("BAR", 1, "radix-2 stage", True)}
_SHOWN = ("HMMA", "HGMMA", "LDG", "LDS", "STS", "LDL", "STL", "BAR", "SHFL", "STG", "FADD",
          "FFMA", "FMUL", "SYNCS")

# anat_full_sync's three steps after its rows are staged.
_AF_ROUNDS = ("    half3_rounds(sr, si, R, n);\n"
              "    for (int e = threadIdx.x; e < R * n; e += kThreads) {\n"
              "      const int at = (e / n) * S + e % n;\n"
              "      const float w = __ldg(tw + e % n), a = sr[at], c = si[at];\n"
              "      sr[at] = a * w - c * w;\n"
              "      si[at] = a * w + c * w;\n"
              "    }\n"
              "    __syncthreads();\n")
_AF_PRODUCTS = ("    for (int s = warp; s < n1; s += kWarps) {\n"
                "      const size_t out = static_cast<size_t>(r0) * n + s * kLanes;\n"
                "      karatsuba_tile(sr + s * kLanes, si + s * kLanes, S, yr + out, yi + out, n, "
                "rows, st);\n"
                "    }\n")
_AF_STORE = "    store_rows(sr, si, yr, yi, r0, R, b, n);\n"
# spectral_twin_kernel<true>: the span staged, then summed a thread at a
# time into its sums row; no segment is transformed.
_ST_LOOP = ("  for (long long sg = s0; sg < s1; ++sg) {\n"
            "    const float ms = m[sg];\n"
            "    if (ms == 0.f) continue;\n"
            "    __syncthreads();  // the span is staged")
_ST_SPAN_ONLY = ("  if (kStaged) {  // the span staged and read once; no segment transformed\n"
                 "    __syncthreads();\n"
                 "    const int n_span = static_cast<int>((s1 - 1 - s0) * stride + nfft);\n"
                 "    float sum = 0.f;\n"
                 "    for (int j = threadIdx.x; j < n_span; j += blockDim.x) sum += span[j];\n"
                 "    if (threadIdx.x < lp) acc[threadIdx.x] = sum;\n"
                 "  }\n"
                 "  for (long long sg = s0; sg < (kStaged ? s0 : s1); ++sg) {\n"
                 "    const float ms = m[sg];\n"
                 "    if (ms == 0.f) continue;\n"
                 "    __syncthreads();  // the span is staged")

# (label, source, mangled-name part, C entry, edits (text, replacement)).
VARIANTS = (
    ("anat_full_sync, rows staged and stored (no rounds, row or products)", _A,
     "21anat_full_sync_kernel", "gdsp_anat_full_sync",
     ((_AF_ROUNDS, ""), (_AF_PRODUCTS, _AF_STORE))),
    ("anat_full_sync, staged, rounds and row, stored (no products)", _A, "21anat_full_sync_kernel",
     "gdsp_anat_full_sync", ((_AF_PRODUCTS, _AF_STORE),)),
    ("anat_full_sync, products of rows staged without the rounds and the row", _A,
     "21anat_full_sync_kernel", "gdsp_anat_full_sync", ((_AF_ROUNDS, ""),)),
    ("pwfloor_staged_radix2, the span staged and summed, no transform", _P,
     "20spectral_twin_kernelILb1E", "gdsp_pwfloor_staged_radix2", ((_ST_LOOP, _ST_SPAN_ONLY),)),
)


# anat_full with its partner k-boxes not copied (the stage's bytes halved;
# the partner values read from whatever the slots hold), and with no
# rounds and no row (the own values split as bd_hi splits them; the
# partner boxes still copied, not read; the CTA's barrier kept).
_NO_PARTNER = (("    hp::mbar_arrive_expect_tx(full + s, St::kBytes);",
                "    hp::mbar_arrive_expect_tx(full + s, kFull ? 2 * St::kBox : St::kBytes);"),
               ("    if constexpr (kFull) {\n      const int partner",
                "    if constexpr (false) {\n      const int partner"))
_NO_ROUNDS = (("      an_prepass(sa, col < k.n / 2, w, lane);\n", ""),)

# (label, source, mangled-name part, C entry, edits, exact): copies of a
# redesign with one part changed; each exact one equal to the redesign bit
# for bit, the others (what a part costs) of another result on purpose.
TUNE = (
    ("anat_full, 16-column k-boxes in two 16 KB stages (the 64-byte swizzle)", _A,
     "16anat_full_kernel", "gdsp_anat_full",
     (("constexpr int kAnK = 32;", "constexpr int kAnK = 16;"),), True),
    ("anat_full, 8-column k-boxes in four 8 KB stages (the 32-byte swizzle)", _A,
     "16anat_full_kernel", "gdsp_anat_full",
     (("constexpr int kAnK = 32;", "constexpr int kAnK = 8;"),), True),
    ("anat_full without its partner k-boxes (half the bytes a stage)", _A,
     "16anat_full_kernel", "gdsp_anat_full", _NO_PARTNER, False),
    ("anat_full without the rounds and the row (bd_hi's split of the own values)", _A,
     "16anat_full_kernel", "gdsp_anat_full", _NO_ROUNDS, False),
)


def _loops(body: str, opcode: str) -> list[list[str]]:
    """Every loop (a backward branch and its target) of a cuobjdump listing
    that holds `opcode`, innermost (shortest) first."""
    import re

    ins = _instructions(body)
    loops = []
    for addr, txt in ins:
        m = re.search(r"BRA\s+(?:!?U?P\w+,\s*)?(0x[0-9a-f]+)", txt)
        if m and int(m.group(1), 16) < addr:
            loop = [t for a, t in ins if int(m.group(1), 16) <= a <= addr]
            if any(_opcode(t) == opcode for t in loop if t):
                loops.append(loop)
    return sorted(loops, key=len)


def loop_counts(body: str, opcode: str, per_unit: int, outer: bool = False):
    """(units, {opcode: count a unit, "total": ...}) of the innermost loop
    holding at least per_unit of `opcode` (outer: the outermost), a unit
    being per_unit of `opcode` (0: one pass of the loop); the whole listing
    where no loop holds it.  (An mbarrier wait's retry branch, placed at
    the function's end, jumps back into the walk: a "loop" holding part of
    an item, which the count skips.)"""
    loops = [lp for lp in _loops(body, opcode)
             if sum(_opcode(t) == opcode for t in lp if t) >= per_unit]
    loop = (loops[-1] if outer else loops[0]) if loops else [t for _, t in _instructions(body)]
    ops = collections.Counter(_opcode(t) for t in loop if t)
    units = (ops[opcode] / per_unit if per_unit else 1.0) or 1.0
    out = {k: v / units for k, v in ops.most_common()}
    out["total"] = sum(ops.values()) / units
    return units, out


def _source_path(src: str):
    from godsp_tpu_torch.ops import _build

    return _build.CSRC / src


def _compiled(tmp: str):
    for src in (_A, _P):
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


def sass() -> None:
    from godsp_tpu_torch.ops import _build

    names = {"21anat_full_sync_kernel": "anat_full_sync_sass.txt",
             "20spectral_twin_kernelILb1E": "pwfloor_staged_radix2_sass.txt",
             "16anat_full_kernel": "anat_full_sass.txt"}
    with tempfile.TemporaryDirectory() as tmp:
        for src, _, info, dump in _compiled(tmp):
            for label, s, key, _, _ in _KERNELS:
                if s != src or key not in info:
                    continue
                body = _function(dump, key)
                if key in names:
                    path = _build.BUILD_DIR / names[key]
                    path.parent.mkdir(parents=True, exist_ok=True)
                    path.write_text(body)
                opcode, per, unit, outer = _UNITS[key]
                for which in (False, True) if outer else (False,):
                    units, counts = loop_counts(body, opcode, per if not which else 0, which)
                    shown = ", ".join(f"{k} {counts[k]:g}" for k in _SHOWN if k in counts)
                    what = "the loop around it, a pass" if which else f"a {unit}"
                    print(f"sass {label}: the {'outermost' if which else 'innermost'} loop "
                          f"holding {opcode} ({units:g} units); {what}: {shown}; total "
                          f"{counts['total']:g}", flush=True)


def unfused_route(xr, xi, tw):
    """anat_full's function by the unfused route: half3, the row as torch's
    elementwise calls (a tw and b tw once each, then their difference and
    sum), bd_hi: two kernel launches and four elementwise calls."""
    from godsp_tpu_torch.ops import cuda_probes as cp

    a, c = cp.half3(xr, xi)
    at, ct = a * tw, c * tw
    return cp.bd_hi(at - ct, at + ct)


def _db(got, want) -> float:
    from godsp_tpu_torch.dsputils import snr_db

    g = (got[0].double() + 1j * got[1].double()) if isinstance(got, tuple) else got.double()
    w = (want[0] + 1j * want[1]) if isinstance(want, tuple) else want
    return float(snr_db(g.cpu().numpy(), w.cpu().numpy()))


def _line(name, shape, dbs, bnd, chains, alone) -> None:
    print(f"{name} {shape} ({dbs}; bound {bnd[0]:.4f} ms, {bnd[1]}) by chain: " +
          "  ".join(f"{label} {ms:.4f} ms" for label, ms in chains) + "; alone: " +
          "  ".join(f"{label} {_fmt(ms)}" for label, ms in alone), flush=True)


def times_anat(dev) -> None:
    from godsp_tpu_torch.ops import cuda_metrics
    from godsp_tpu_torch.ops import cuda_probes as cp
    from godsp_tpu_torch.probes import anatomy2
    from godsp_tpu_torch.probes._common import TF32_FLOPS, lane_planes
    from godsp_tpu_torch.utils.metrics import FP32_FLOPS, bound_ms

    probe = torch.empty(1, device=dev)
    xr, xi = lane_planes(dev, B, N, seed=24)
    tw = anatomy2.tw_row(dev, N)
    pts = float(B * N)
    want = cp.anat_full_plain(xr.double(), xi.double(), tw)
    new, first = (lambda: cp.anat_full(xr, xi, tw)), (lambda: cp.anat_full_sync(xr, xi, tw))
    route = lambda: unfused_route(xr, xi, tw)  # noqa: E731
    hi, h3 = (lambda: cp.bd_hi(xr, xi)), (lambda: cp.half3(xr, xi))
    copy = lambda: cuda_metrics.copy_split(xr, xi)  # noqa: E731
    dbs = (f"{_db(new(), want):.2f} dB, first design {_db(first(), want):.2f}, "
           f"unfused {_db(route(), want):.2f}")
    bnd = bound_ms(16.0 * pts, max(10.0 * pts, 2304.0 * pts * FP32_FLOPS / TF32_FLOPS))
    chains = [(label, _chain_ms(op, probe)) for label, op in (
        ("anat_full", new), ("first design", first), ("first design", first), ("anat_full", new),
        ("unfused half3 + row + bd_hi", route), ("bd_hi", hi), ("half3", h3), ("K12 copy", copy))]
    alone = [("anat_full", kernel_alone_ms("anat_full_kernel", new, 20)),
             ("first design", kernel_alone_ms("anat_full_sync_kernel", first, 20)),
             ("unfused route", call_device_ms(route)),
             ("bd_hi", kernel_alone_ms("bd_hi_kernel", hi, 20)),
             ("K12 copy", kernel_alone_ms("copy_split_kernel", copy, 20))]
    _line("anat_full", f"{B} x {N}", dbs, bnd, chains, alone)


def pwelch_inputs(dev, hop: int, segs: int):
    """ext ((segs - 1) hop + 1024 samples, N(0, 0.01)), its mask ones and a
    periodic Hann of 1024, float32 on the card (seeded)."""
    from godsp_tpu_torch import window

    g = torch.Generator(device=dev).manual_seed(hop)
    ext = torch.randn((segs - 1) * hop + 1024, generator=g, device=dev) * 0.1
    return (ext, torch.ones(segs, device=dev),
            window.window_table("hann", 1024, device=dev, dtype=torch.float32))


def times_staged(dev) -> None:
    from godsp_tpu_torch.ops import cuda_probes as cp
    from godsp_tpu_torch.ops import cuda_pwelch
    from godsp_tpu_torch.utils.metrics import bound_ms, rfft_flops

    for hop, segs in ((512, 16384), (160, HOP160_SEGS)):
        ext, mask, w = pwelch_inputs(dev, hop, segs)
        probe = torch.empty(1, device=dev)
        bt = cp.staged_segs_per_tile(segs, 1, 1024, hop, 1024)
        new = lambda: cp.pwfloor_staged(ext, mask, w, 1024, hop)  # noqa: E731
        first = lambda: cp.pwfloor_staged_radix2(ext, mask, w, 1024, hop, bt=bt)  # noqa: E731
        k4 = lambda: cuda_pwelch.pwelch_power_partials(ext, mask, w, 1024, hop)  # noqa: E731
        want = cp.pwfloor_staged_plain(ext.double(), mask.double(), w.double(), 1024, hop, 1024,
                                       bt)
        dbs = (f"{_db(new(), want):.2f} dB, first design {_db(first(), want):.2f}; "
               f"equal to K4: {torch.equal(new(), k4())}, to the first design: "
               f"{torch.equal(new(), first())}; tiles of {bt}")
        tiles = -(-segs // bt)
        bnd = bound_ms(4.0 * (ext.numel() + segs + 1024 + tiles * 513),
                       segs * (1024 + rfft_flops(1024) + 3.0 * 513))
        chains = [(label, _chain_ms(op, probe)) for label, op in (
            ("staged", new), ("first design", first), ("first design", first), ("staged", new),
            ("K4", k4))]
        alone = [("staged", kernel_alone_ms("staged_partials_kernel", new, 20)),
                 ("first design", kernel_alone_ms("spectral_twin_kernel", first, 20)),
                 ("K4", kernel_alone_ms("pwelch_partials_kernel", k4, 20))]
        _line("pwfloor_staged", f"hop {hop}, {segs} segments", dbs, bnd, chains, alone)
        del ext, mask, w, want


def variants(dev) -> None:
    from godsp_tpu_torch.ops import cuda_probes as cp
    from godsp_tpu_torch.probes import anatomy2
    from godsp_tpu_torch.probes._common import lane_planes

    probe = torch.empty(1, device=dev)
    xr, xi = lane_planes(dev, B, N, seed=24)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    tw = anatomy2.tw_row(dev, N)
    ext, mask, w = pwelch_inputs(dev, 512, 16384)
    bt = cp.staged_segs_per_tile(16384, 1, 1024, 512, 1024)
    out = torch.empty(-(-16384 // bt), 513, device=dev)
    twiddles = cp.twiddle_table(1024, False, dev)
    bases = {"gdsp_anat_full_sync": lambda: cp.anat_full_sync(xr, xi, tw),
             "gdsp_pwfloor_staged_radix2":
                 lambda: cp.pwfloor_staged_radix2(ext, mask, w, 1024, 512, bt=bt)}
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for j, (label, src, key, entry, edits) in enumerate(VARIANTS):
            lib, info, _ = _compile(variant_source(src, edits), tmp, f"variant_{j}", (key,))
            if entry == "gdsp_anat_full_sync":
                op = _entry(lib, entry, (tw, cp._hi_packed(dev)))
                run = lambda op=op: op(xr, xi, yr, yi)  # noqa: E731
            else:
                run = _staged_entry(lib, entry, ext, mask, w, out, twiddles, bt)
            run()
            torch.cuda.synchronize()
            base = bases[entry]
            regs, spill = info[key]
            rows.append((label, _chain_ms(base, probe), _chain_ms(run, probe),
                         _chain_ms(base, probe), f"{regs} registers; {spill}"))
    for label, before, ms, after, regs in rows:
        print(f"variant {label}: {ms:.4f} ms by chain (the first design as it is {before:.4f} / "
              f"{after:.4f}); {regs}", flush=True)


def tune(dev) -> None:
    import ctypes

    from godsp_tpu_torch.ops import cuda_probes as cp
    from godsp_tpu_torch.probes import anatomy2
    from godsp_tpu_torch.probes._common import lane_planes, planes_equal

    probe = torch.empty(1, device=dev)
    xr, xi = lane_planes(dev, B, N, seed=24)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    tw = anatomy2.tw_row(dev, N)
    base = lambda: cp.anat_full(xr, xi, tw)  # noqa: E731
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for j, (label, src, key, entry, edits, exact) in enumerate(TUNE):
            lib, info, _ = _compile(variant_source(src, edits), tmp, f"tune_{j}", (key,))
            occupancy = lib.gdsp_anat_full_resident
            occupancy.argtypes, occupancy.restype = [ctypes.c_int], ctypes.c_int
            resident = occupancy(0)
            op = _entry(lib, entry, (tw, cp._hi_packed(dev)), (resident,))
            if exact and not planes_equal(op(xr, xi, yr, yi), base()):
                raise AssertionError(f"{label}: not equal to the redesign")
            regs, spill = info[key]
            run = lambda op=op: op(xr, xi, yr, yi)  # noqa: E731
            rows.append((label, _chain_ms(base, probe), _chain_ms(run, probe),
                         _chain_ms(base, probe), f"{resident} resident; {regs} registers; {spill}"
                         + ("" if exact else "; another result, on purpose")))
    for label, before, ms, after, regs in rows:
        print(f"tune {label}: {ms:.4f} ms by chain (the redesign as it is {before:.4f} / "
              f"{after:.4f}); {regs}", flush=True)


def _staged_entry(lib, entry, ext, mask, w, out, twiddles, bt):
    import ctypes

    p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn = getattr(lib, entry)
    fn.argtypes = [p, p, p, p, p, i64, i64, i64, i, i, i, i, i, p]
    fn.restype = i
    S = mask.shape[-1]

    def run():
        rc = fn(ext.data_ptr(), mask.data_ptr(), w.data_ptr(), out.data_ptr(),
                twiddles.data_ptr(), 1, ext.shape[-1], S, 1024, 512, 10, bt, -(-S // bt),
                torch.cuda.current_stream(ext.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{entry}: CUDA error {rc}")
        return out
    return run


def main(argv: list[str] | None = None) -> int:
    from godsp_tpu_torch import set_default_device
    from godsp_tpu_torch.probes._common import card

    argv = sys.argv[1:] if argv is None else argv
    parts = [a.lstrip("-") for a in argv] or ["ptxas", "sass", "times", "variants", "tune"]
    if not torch.cuda.is_available():
        raise SystemExit("anat_staged: needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    print(f"nvidia-smi: {card()}", flush=True)
    set_default_device("cuda")
    dev = torch.device("cuda", 0)
    for part in parts:
        {"ptxas": ptxas, "sass": sass,
         "times": lambda: (times_anat(dev), times_staged(dev)),
         "variants": lambda: variants(dev), "tune": lambda: tune(dev)}[part]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
