"""K14d's bd_hi and K14c's slicestore as redesigned for Hopper, on one GPU:
their first designs read from ptxas and SASS, their times beside the
first designs and library calls, variants that isolate the first designs'
gaps, and bd_hi's chain of k-steps.

    python3 -m godsp_tpu_torch.probes.bd_hi [--ptxas] [--sass] [--times] [--variants]
                                            [--chains]

--ptxas compiles csrc/anatomy_probe_kernels.cu and csrc/lane_probe_kernels.cu
with `-Xptxas -v` and prints the registers, spills and 256-thread blocks a
SM (from the registers alone; bd_hi_kernel one CTA an SM by its shared
memory) of bd_hi_kernel, bd_hi_sync_kernel, slicestore_kernel,
slicestore_sync_kernel and slice8_kernel.

--sass reads both sources' SASS (cuobjdump; bd_hi_sync_kernel's listing in
the package's git-ignored _build/bd_hi_sass.txt): bd_hi_sync_kernel's
k-step loop, its HMMA, LDS, LDG, IMAD and other instructions a k-step
(kstep_counts); slicestore_sync_kernel's and slicestore_kernel's slice
loop in issue order with the bytes of loads in flight a SM (probes.slice8's
sass_order and in_flight); and bd_hi_kernel's wgmma, LDS and F2F
(cvt.rna) a k-step.

--times times at 16384 x 1024, by chain (utils.metrics.time_chain_diff) and
alone (the profiler's events of the kernel), bd_hi beside bd_hi_sync and
torch.matmul of the complex64 slices and F128 (TF32 off), in turns (bd_hi,
first design, first design, bd_hi), and slicestore beside slicestore_sync,
concatstore, K12's copy and copy_ a plane, the same way.

--variants builds copies of the two sources with a kernel changed
(VARIANTS): bd_hi_sync with its table gather made conflict-free, with its
A values made in registers, and both; bd_hi with its TF32 rounding by
cvt.rna (exact), with a fold of its split values in place of its products
and with its A values made in registers (the others give wrong results on
purpose: they show what a part costs); slicestore_sync not unrolled and
with four slices' loads ahead (exact); prints each copy's registers and
times each by chain beside the kernel as it is.

--chains builds copies of csrc/anatomy_probe_kernels.cu with bd_hi's
kHiChain (the k-steps the tensor cores sum before an add on the CUDA
cores) at 1, 2, 4, 8 and 16 and prints each one's dB against bd_hi_plain
in float64 and against bd_hi_sync at 16384 x 1024 and (1001, 2048), with
its time by chain.

All by default.  Prints the card's name and power limit first.  Needs a
CUDA device; imports nothing of JAX.  The checks and the redesign lines of
the smoke are chip_smoke.py's phase 3 (phase_hi_store_redesign).
"""

from __future__ import annotations

import collections
import ctypes
import os
import re
import subprocess
import sys
import tempfile

import torch

from godsp_tpu_torch.probes.floor_dot import _chain_ms, _fmt, _nvcc, kernel_alone_ms
from godsp_tpu_torch.probes.slice8 import in_flight, sass_order

__all__ = ["B", "CHAINS", "N", "VARIANTS", "kstep_counts", "main", "ptxas_info",
           "variant_source"]

B, N = 16384, 1024  # the anatomy and store probes' planes
CHAINS = (1, 2, 4, 8, 16)

_KERNELS = (("bd_hi_kernel", "12bd_hi_kernel"), ("bd_hi_sync_kernel", "17bd_hi_sync_kernel"),
            ("slicestore_kernel", "17slicestore_kernel"),
            ("slicestore_sync_kernel", "22slicestore_sync_kernel"),
            ("slice8_kernel", "13slice8_kernel"))

# bd_hi_sync's gather of the split tables over j k mod 128, and a
# conflict-free index with no multiply in its place (wrong results).
_GATHER = "        const int i0 = (j0 * k) & (kLanes - 1), i1 = (j1 * k) & (kLanes - 1);\n"
_NO_GATHER = "        const int i0 = 8 * t + g + 32 * ((nt + ks) & 3), i1 = i0 ^ 64;\n"
# bd_hi_sync's A values from device memory, and values made in registers.
_A_LOADS = ("      a_values(va, pa, lda, rows, 8 * ks);\n"
            "      a_values(vb, pb, lda, rows, 8 * ks);\n")
_A_REGS = ("#pragma unroll\n"
           "      for (int q = 0; q < 4; ++q) {\n"
           "        va[q] = __int_as_float(0x3c000000 + ((ks * 4 + q) << 12) + threadIdx.x);\n"
           "        vb[q] = __int_as_float(0x3c400000 + ((ks * 4 + q) << 12) + threadIdx.x);\n"
           "      }\n")
_STORE_LOOP = (
    "    for (int s = 0; s < ch.slices; ++s) {\n"
    "      const size_t off = static_cast<size_t>(row) * n + ch.c0 + s * kLanes + 4 * lane;\n"
    "      const float4 ar = __ldg(reinterpret_cast<const float4*>(xr + off));\n"
    "      const float4 ai = __ldg(reinterpret_cast<const float4*>(xi + off));\n"
    "      *reinterpret_cast<float4*>(yr + off) = ar;\n"
    "      *reinterpret_cast<float4*>(yi + off) = ai;\n"
    "    }\n")
_STORE_FOUR = (
    "    for (int s0 = 0; s0 < ch.slices; s0 += 4) {\n"
    "      const size_t at = static_cast<size_t>(row) * n + ch.c0 + 4 * lane;\n"
    "      float4 va[4], vc[4];\n"
    "#pragma unroll\n"
    "      for (int s = 0; s < 4; ++s)\n"
    "        if (s0 + s < ch.slices) {\n"
    "          va[s] = __ldg(reinterpret_cast<const float4*>(xr + at + (s0 + s) * kLanes));\n"
    "          vc[s] = __ldg(reinterpret_cast<const float4*>(xi + at + (s0 + s) * kLanes));\n"
    "        }\n"
    "#pragma unroll\n"
    "      for (int s = 0; s < 4; ++s)\n"
    "        if (s0 + s < ch.slices) {\n"
    "          *reinterpret_cast<float4*>(yr + at + (s0 + s) * kLanes) = va[s];\n"
    "          *reinterpret_cast<float4*>(yi + at + (s0 + s) * kLanes) = vc[s];\n"
    "        }\n"
    "    }\n")

# The redesign's TF32 rounding by integer operations, and by cvt.rna (the
# same bits); its products, and a fold of the split values in their place
# (wrong results); its A values read from the stage, and made in registers.
_ROUND = "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
_ROUND_CVT = "  return gdsp::tf32(x);\n"
_PRODUCTS = ("      hi_products(d, x[j & 1], fb, (j >> 2) * (kHiBins * 128) + (j & 3) * 32,\n"
             "                  j % kHiChain != 0);\n")
_NO_PRODUCTS = ("#pragma unroll\n"
                "      for (int q = 0; q < 4; ++q) {\n"
                "        const HiA& y = x[j & 1];\n"
                "        d[0][q] += __uint_as_float(y.ab[q] ^ y.as[q] ^ y.bb[q] ^ y.bs[q] ^ y.sb[q]"
                " ^ y.ss[q]);\n"
                "      }\n")
_HI_LOADS = ("        hi_fragment(va[kk], sa, r0, kk, t);\n"
             "        hi_fragment(vb[kk], sa + kHiBox, r0, kk, t);\n")
_HI_REGS = ("#pragma unroll\n"
            "        for (int q = 0; q < 4; ++q) {\n"
            "          va[kk][q] = __int_as_float(0x3c000000 + ((kk * 4 + q) << 12) + threadIdx.x +"
            " static_cast<int>(c));\n"
            "          vb[kk][q] = __int_as_float(0x3c400000 + ((kk * 4 + q) << 12) + threadIdx.x +"
            " static_cast<int>(c));\n"
            "        }\n")

_A = "anatomy_probe_kernels.cu"
# (name, source file, kernel's mangled-name part, C entry, edits (text,
# replacement), exact): the exact variants must give the kernel's result
# bit for bit.
VARIANTS = (
    ("bd_hi_sync, gather without conflicts", _A, "17bd_hi_sync_kernel", "gdsp_bd_hi_sync",
     ((_GATHER, _NO_GATHER),), False),
    ("bd_hi_sync, A made in registers", _A, "17bd_hi_sync_kernel", "gdsp_bd_hi_sync",
     ((_A_LOADS, _A_REGS),), False),
    ("bd_hi_sync, both", _A, "17bd_hi_sync_kernel", "gdsp_bd_hi_sync",
     ((_GATHER, _NO_GATHER), (_A_LOADS, _A_REGS)), False),
    ("bd_hi, rounded by cvt.rna", _A, "12bd_hi_kernel", "gdsp_bd_hi", ((_ROUND, _ROUND_CVT),),
     True),
    ("bd_hi, no products", _A, "12bd_hi_kernel", "gdsp_bd_hi", ((_PRODUCTS, _NO_PRODUCTS),),
     False),
    ("bd_hi, A made in registers", _A, "12bd_hi_kernel", "gdsp_bd_hi", ((_HI_LOADS, _HI_REGS),),
     False),
    ("slicestore_sync, not unrolled", "lane_probe_kernels.cu", "22slicestore_sync_kernel",
     "gdsp_slicestore_sync", ((_STORE_LOOP, "#pragma unroll 1\n" + _STORE_LOOP),), True),
    ("slicestore_sync, four slices ahead", "lane_probe_kernels.cu", "22slicestore_sync_kernel",
     "gdsp_slicestore_sync", ((_STORE_LOOP, _STORE_FOUR),), True),
)
_CHAIN = "constexpr int kHiChain = 4;"


def _csrc():
    from godsp_tpu_torch.ops import _build

    return _build.CSRC


def variant_source(src: str, edits) -> str:
    """csrc/<src> with each (text, replacement) of edits made; each text must
    be there once."""
    with open(_csrc() / src) as fh:
        s = fh.read()
    for text, repl in edits:
        if s.count(text) != 1:
            raise LookupError(f"variant_source: {text[:40]!r} is not in {src} once")
        s = s.replace(text, repl)
    return s


def kstep_counts(body: str) -> tuple[float, dict[str, float]]:
    """The innermost loop with HMMA instructions (a backward branch and its
    target) of a cuobjdump listing: its k-steps (HMMA / 72, bd_hi_sync's
    mma.sync a k-step a warp) and its instructions a k-step by opcode."""
    ins = [(int(a, 16), t.strip()) for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", body)]
    loops = []
    for addr, txt in ins:
        m = re.search(r"BRA\s+(?:!?U?P\w+,\s*)?(0x[0-9a-f]+)", txt)
        if m and int(m.group(1), 16) < addr:
            loop = [t for a, t in ins if int(m.group(1), 16) <= a <= addr]
            if any(t.split()[0].startswith("HMMA") for t in loop if t):
                loops.append(loop)
    loop = min(loops, key=len) if loops else [t for _, t in ins]
    ops = collections.Counter(re.sub(r"^@!?U?P\w+\s+", "", t).split()[0].split(".")[0]
                              for t in loop if t)
    steps = ops["HMMA"] / 72 or 1.0
    return steps, {k: v / steps for k, v in ops.most_common()}


def _compile(source: str, tmp: str, name: str, keys) -> tuple[ctypes.CDLL, dict, str]:
    """source compiled into a loaded shared library and a cubin: the library,
    {key: (registers, spill line)} from ptxas for each mangled-name part in
    keys, and the cuobjdump listing."""
    from godsp_tpu_torch.ops import _build

    src, so, cubin = (os.path.join(tmp, f"{name}{ext}") for ext in (".cu", ".so", ".cubin"))
    with open(src, "w") as fh:
        fh.write(source)
    res = _nvcc(["-shared", "-Xptxas", "-v", src, "-o", so])
    if res.returncode != 0 or _nvcc(["-cubin", src, "-o", cubin]).returncode != 0:
        raise RuntimeError(f"nvcc {name}: {res.stderr[-4000:]}")
    dump = subprocess.run([os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"), "-sass",
                           cubin], capture_output=True, text=True, check=True).stdout
    return ctypes.CDLL(so), ptxas_info(res.stderr, keys), dump


def ptxas_info(text: str, keys) -> dict:
    """{key: (registers, the stack-frame and spill line)} from `-Xptxas -v`
    output for each mangled-name part in keys that names a function."""
    lines = text.splitlines()
    info = {}
    for i, line in enumerate(lines[:-2]):
        for key in keys:
            if "Function properties for" in line and key in line:
                m = re.search(r"Used (\d+) registers", lines[i + 2])
                info[key] = (int(m.group(1)) if m else 0, lines[i + 1].strip())
    return info


def _function(dump: str, key: str) -> str:
    body = dump[dump.index(key):]
    body = body[body.index("\n"):]
    return body[:body.index("Function :")] if "Function :" in body else body


def ptxas() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        for src in ("anatomy_probe_kernels.cu", "lane_probe_kernels.cu"):
            with open(_csrc() / src) as fh:
                _, info, _ = _compile(fh.read(), tmp, src[:-3], [k for _, k in _KERNELS])
            for label, key in _KERNELS:
                if key in info:
                    regs, spill = info[key]
                    blocks = 1 if label == "bd_hi_kernel" else min(
                        8, 65536 // (-(-regs // 8) * 8 * 256))
                    print(f"ptxas {label}: {regs} registers, {blocks} blocks of 256 threads a "
                          f"SM; {spill}", flush=True)


def sass() -> None:
    from godsp_tpu_torch.ops import _build

    with tempfile.TemporaryDirectory() as tmp:
        for src in ("anatomy_probe_kernels.cu", "lane_probe_kernels.cu"):
            with open(_csrc() / src) as fh:
                _, info, dump = _compile(fh.read(), tmp, src[:-3], [k for _, k in _KERNELS])
            for label, key in _KERNELS:
                if key not in info:
                    continue
                body = _function(dump, key)
                if label == "bd_hi_sync_kernel":
                    path = str(_build.BUILD_DIR / "bd_hi_sass.txt")
                    os.makedirs(os.path.dirname(path), exist_ok=True)
                    with open(path, "w") as fh:
                        fh.write(body)
                    steps, per = kstep_counts(body)
                    print(f"sass {label} (listing in {path}): the k-step loop holds {steps:g} "
                          f"k-steps; a k-step: " + ", ".join(f"{k} {v:g}" for k, v in
                                                             per.items()), flush=True)
                elif label == "bd_hi_kernel":
                    ops = collections.Counter(
                        re.sub(r"^@!?U?P\w+\s+", "", t.strip()).split()[0].split(".")[0]
                        for _, t in re.findall(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", body))
                    steps = ops["HGMMA"] / 9 or 1.0
                    print(f"sass {label}: {ops['HGMMA']} HGMMA ({steps:g} k-steps of a "
                          f"warpgroup's 9); a k-step: " + ", ".join(
                              f"{k} {v / steps:g}" for k, v in ops.most_common(14)),
                          flush=True)
                elif label.startswith("slice"):
                    seq, loads = sass_order(body)
                    blocks, nbytes = in_flight(info[key][0], loads)
                    print(f"sass {label}: {info[key][0]} registers, {blocks} blocks a SM, "
                          f"{loads} 16-byte loads a thread before its first store, {nbytes} B "
                          f"of loads in flight a SM; loop: {seq}", flush=True)


def times(dev) -> None:
    from godsp_tpu_torch.ops import cuda_metrics
    from godsp_tpu_torch.ops import cuda_probes as cp
    from godsp_tpu_torch.probes import anatomy2
    from godsp_tpu_torch.probes._common import lane_planes, planes_db, planes_equal

    probe = torch.empty(1, device=dev)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("torch.matmul's yardstick: TF32 is on")
    xr, xi = lane_planes(dev, B, N, seed=22)
    new = lambda: cp.bd_hi(xr, xi)  # noqa: E731
    first = lambda: cp.bd_hi_sync(xr, xi)  # noqa: E731
    errs: dict = {}
    db = planes_db(new(), first(), errs, "bd_hi")
    lib = anatomy2.ops(xr, xi, anatomy2.tw_row(dev, N))["bd_hi"][1]
    plan = cp.bd_hi_plan(B, N, cp._hi_resident(dev))
    chains = [(label, _chain_ms(op, probe)) for label, op in (
        ("bd_hi", new), ("first design", first), ("first design", first), ("bd_hi", new),
        ("torch.matmul", lib))]
    alone = [(label, kernel_alone_ms(symbol, op, 20)) for label, symbol, op in (
        ("bd_hi", "bd_hi_kernel", new), ("first design", "bd_hi_sync_kernel", first),
        ("torch.matmul", "gemm", lib))]
    print(f"bd_hi {B} x {N} ({plan.pairs} pairs, {plan.per_pair} items the busiest, chain "
          f"{plan.chain}; {db:.2f} dB against the first design) by chain: " + "  ".join(
              f"{label} {ms:.4f} ms" for label, ms in chains) + "; alone: " + "  ".join(
              f"{label} {_fmt(ms)}" for label, ms in alone), flush=True)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    new = lambda: cp.slicestore(xr, xi)  # noqa: E731
    first = lambda: cp.slicestore_sync(xr, xi)  # noqa: E731
    for label, got in (("slicestore", new()), ("slicestore_sync", first())):
        if not planes_equal(got, (xr, xi)):
            raise AssertionError(f"{label} {B} x {N}: differs from its input")
    chains = [(label, _chain_ms(op, probe)) for label, op in (
        ("slicestore", new), ("first design", first), ("first design", first),
        ("slicestore", new), ("concatstore", lambda: cp.concatstore(xr, xi)),
        ("K12 copy", lambda: cuda_metrics.copy_split(xr, xi)),
        ("copy_", lambda: (yr.copy_(xr), yi.copy_(xi))))]
    alone = [(label, kernel_alone_ms(symbol, op, 20)) for label, symbol, op in (
        ("slicestore", "slicestore_kernel", new), ("first design", "slicestore_sync_kernel", first),
        ("K12 copy", "copy_split_kernel", lambda: cuda_metrics.copy_split(xr, xi)))]
    print(f"slicestore {B} x {N} by chain: " + "  ".join(
        f"{label} {ms:.4f} ms" for label, ms in chains) + "; alone: " + "  ".join(
        f"{label} {_fmt(ms)}" for label, ms in alone), flush=True)


def _entry(lib: ctypes.CDLL, name: str, tables: tuple = (), extra: tuple = ()):
    """A C entry of lib as op(xr, xi) -> (yr, yi) on the current stream."""
    p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn = getattr(lib, name)
    fn.argtypes = [p] * (4 + len(tables)) + [i64, i] + [i] * len(extra) + [p]
    fn.restype = i

    def op(xr, xi, yr, yi):
        rc = fn(xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                *(t.data_ptr() for t in tables), xr.shape[0], xr.shape[1], *extra,
                torch.cuda.current_stream(xr.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA error {rc}")
        return yr, yi
    return op


def variants(dev) -> None:
    from godsp_tpu_torch.ops import cuda_probes as cp
    from godsp_tpu_torch.probes._common import lane_planes, planes_equal

    probe = torch.empty(1, device=dev)
    xr, xi = lane_planes(dev, B, N, seed=22)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    tab = cp._hi_packed(dev)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for j, (label, src, key, entry, edits, exact) in enumerate(VARIANTS):
            lib, info, _ = _compile(variant_source(src, edits), tmp, f"variant_{j}", (key,))
            if entry == "gdsp_bd_hi":
                op = _entry(lib, entry, (tab,), (cp._hi_resident(dev),))
                base = lambda: cp.bd_hi(xr, xi)  # noqa: E731
            elif entry == "gdsp_bd_hi_sync":
                op = _entry(lib, entry, (tab,))
                base = lambda: cp.bd_hi_sync(xr, xi)  # noqa: E731
            else:
                op = _entry(lib, entry)
                base = lambda: cp.slicestore_sync(xr, xi)  # noqa: E731
            got = op(xr, xi, yr, yi)
            if exact and not planes_equal(got, base()):
                raise AssertionError(f"{label}: not equal to the kernel as it is")
            regs, spill = info[key]
            run = lambda op=op: op(xr, xi, yr, yi)  # noqa: E731
            rows.append((label, base, _chain_ms(base, probe), _chain_ms(run, probe),
                         _chain_ms(base, probe), f"{regs} registers; {spill}"))
    for label, _, before, ms, after, regs in rows:
        print(f"variant {label}: {ms:.4f} ms by chain (the kernel as it is {before:.4f} / "
              f"{after:.4f}); {regs}", flush=True)


def chains(dev) -> None:
    from godsp_tpu_torch.ops import cuda_probes as cp
    from godsp_tpu_torch.probes._common import lane_planes, planes_db

    probe = torch.empty(1, device=dev)
    tab = cp._hi_packed(dev)
    resident = cp._hi_resident(dev)
    shapes = ((B, N), (1001, 2048))
    inputs = []
    for b, n in shapes:
        xr, xi = lane_planes(dev, b, n, seed=b + n)
        inputs.append((xr, xi, cp.bd_hi_plain(xr.double(), xi.double()), cp.bd_hi_sync(xr, xi)))
    with tempfile.TemporaryDirectory() as tmp:
        for c in CHAINS:
            source = variant_source("anatomy_probe_kernels.cu",
                                    ((_CHAIN, f"constexpr int kHiChain = {c};"),))
            lib, info, _ = _compile(source, tmp, f"chain_{c}", ("12bd_hi_kernel",))
            op = _entry(lib, "gdsp_bd_hi", (tab,), (resident,))
            errs: dict = {}
            line = []
            for (b, n), (xr, xi, want, first) in zip(shapes, inputs):
                yr, yi = torch.empty_like(xr), torch.empty_like(xi)
                got = op(xr, xi, yr, yi)
                line.append(f"{b} x {n}: {planes_db(got, want, errs, 'f64'):.2f} dB against "
                            f"float64, {planes_db(got, first, errs, 'sync'):.2f} against the "
                            f"first design")
            xr, xi = inputs[0][:2]
            yr, yi = torch.empty_like(xr), torch.empty_like(xi)
            ms = _chain_ms(lambda: op(xr, xi, yr, yi), probe)
            print(f"chain {c:2d}: {'; '.join(line)}; {ms:.4f} ms by chain at {B} x {N}; "
                  f"{info['12bd_hi_kernel'][0]} registers; {info['12bd_hi_kernel'][1]}",
                  flush=True)


def main(argv: list[str] | None = None) -> int:
    from godsp_tpu_torch import set_default_device
    from godsp_tpu_torch.probes._common import card

    argv = sys.argv[1:] if argv is None else argv
    parts = [a.lstrip("-") for a in argv] or ["ptxas", "sass", "times", "variants", "chains"]
    if not torch.cuda.is_available():
        raise SystemExit("bd_hi: needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    print(f"nvidia-smi: {card()}", flush=True)
    set_default_device("cuda")
    dev = torch.device("cuda", 0)
    for part in parts:
        {"ptxas": ptxas, "sass": sass, "times": lambda: times(dev),
         "variants": lambda: variants(dev), "chains": lambda: chains(dev)}[part]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
