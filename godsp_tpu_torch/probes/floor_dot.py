"""K13 (gmm_floor) and K14g's i8_dot as redesigned for Hopper, on one GPU:
their registers, their times beside their first designs and library calls,
i8_dot's phases inside a CTA, and K13's variants.

    python3 -m godsp_tpu_torch.probes.floor_dot [--ptxas] [--sass] [--times] [--split]
                                                [--variants]

--ptxas compiles csrc/metrics_kernels.cu and csrc/int8_probe_kernels.cu
with `-Xptxas -v` and prints the registers, stack and spills of
gmm_floor_kernel, gmm_floor_sync_kernel, i8_dot_kernel<true/false> and
i8_dot_bytes_kernel.

--sass writes gmm_floor_kernel's SASS (cuobjdump) to the package's
git-ignored _build/floor_sass.txt and prints its FMA loop's opcodes, reuse
flags and stall fields (loop_summary).

--times times K13 at 16384 x 1024 and 1024 x 16384 by chain
(utils.metrics.time_chain_diff) and alone (the profiler's events of the
kernel, averaged over the events it kept) beside gmm_floor_sync and
torch.matmul of the complex64 slices with G (TF32 off), in turns (K13,
first design, first design, K13); and i8_dot at both probes.int8.DOT_SHAPES
alone beside i8_dot_bytes and torch._int_mm's GEMM kernel, each averaged
the same way.

--split builds a copy of csrc/int8_probe_kernels.cu whose i8_dot_kernel
records, in thread 0 of every CTA, %globaltimer at its start and end and
clock64 after each phase (copies issued, the load round landed, b
transposed, the mma steps done, c stored), runs it at (256, 128) @ (128,
128) and prints each phase's median and largest cycles over the CTAs,
the spread of the CTAs' starts and the span from the first start to the
last end, beside the instrumented kernel alone: what is launch, what is
the load round and what is arithmetic.

--variants builds copies of csrc/metrics_kernels.cu with lines of
gmm_floor_kernel changed (VARIANTS: a ring of three stages, the i2 loop
unrolled, the FMAs of the three planes interleaved, each checked bit for
bit against K13; and the contraction with its x reads, its G reads or both
from shared memory replaced by register values, which gives wrong results
on purpose and shows what those reads cost), prints each copy's registers
and spills, and times each by chain at both shapes, with the kernel as it
is first and last.  Then it samples nvidia-smi's SM clock and power draw
while K13 runs back to back.

All by default.  Prints the card's name and power limit first.  Needs a
CUDA device; imports nothing of JAX.  The checks, the plans and the
redesign lines of the smoke are chip_smoke.py's phase 3
(phase_floor_dot_redesign).
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys
import tempfile

import torch

__all__ = ["K13_SHAPES", "SPLIT_MARKS", "VARIANTS", "clocks", "kernel_alone_ms", "main",
           "loop_summary", "split_source", "variant_source"]

K13_SHAPES = ((16384, 1024), (1024, 16384))

# (name, ((a line of metrics_kernels.cu, its replacement), ...), exact):
# exact variants must give K13's result bit for bit; the others take a
# part out on purpose (their results are wrong) to show what it costs.
_X_LOADS = ("          const float4 vr = *reinterpret_cast<const float4*>(xr_rows + off);\n"
            "          const float4 vi = *reinterpret_cast<const float4*>(xi_rows + off);\n")
_X_REGS = ("          const float4 vr = make_float4(__int_as_float(off), __int_as_float(off ^"
           " 1),\n"
           "              __int_as_float(off ^ 2), __int_as_float(off ^ 3));\n"
           "          const float4 vi = make_float4(__int_as_float(off ^ 4),\n"
           "              __int_as_float(off ^ 5), __int_as_float(off ^ 6),\n"
           "              __int_as_float(off ^ 7));\n")
_G_LOADS = ("          gr[e] = *reinterpret_cast<const float4*>(at);\n"
            "          gi[e] = *reinterpret_cast<const float4*>(at + kLanes * kFlBins);\n"
            "          gs[e] = *reinterpret_cast<const float4*>(at + 2 * kLanes * kFlBins);\n")
_G_REGS = ("          const int gv = static_cast<int>(at - sg);\n"
           "          gr[e] = make_float4(__int_as_float(gv), __int_as_float(gv ^ 1),\n"
           "                              __int_as_float(gv ^ 2), __int_as_float(gv ^ 3));\n"
           "          gi[e] = make_float4(__int_as_float(gv ^ 4), __int_as_float(gv ^ 5),\n"
           "                              __int_as_float(gv ^ 6), __int_as_float(gv ^ 7));\n"
           "          gs[e] = make_float4(__int_as_float(gv ^ 8), __int_as_float(gv ^ 9),\n"
           "                              __int_as_float(gv ^ 10), __int_as_float(gv ^ 11));\n")
# The contraction's FMA order (exact: the same fmaf chain an output).
_FMA_PLANES = ("            // A plane at a time: four FMAs in a row share their x operand.\n"
               "#pragma unroll\n"
               "            for (int q = 0; q < 4; ++q) m1[j][q] = fmaf(ar[e], gre[q],"
               " m1[j][q]);\n"
               "#pragma unroll\n"
               "            for (int q = 0; q < 4; ++q) m2[j][q] = fmaf(ai[e], gie[q],"
               " m2[j][q]);\n"
               "#pragma unroll\n"
               "            for (int q = 0; q < 4; ++q) m3[j][q] = fmaf(as, gse[q], m3[j][q]);\n")
_FMA_Q = ("#pragma unroll\n"
          "            for (int q = 0; q < 4; ++q) {\n"
          "              m1[j][q] = fmaf(ar[e], gre[q], m1[j][q]);\n"
          "              m2[j][q] = fmaf(ai[e], gie[q], m2[j][q]);\n"
          "              m3[j][q] = fmaf(as, gse[q], m3[j][q]);\n"
          "            }\n")
_QUADS = "#pragma unroll 1\n      for (int u = 0; u < kFlK / 4; ++u) {\n"
VARIANTS = (
    ("3 stages", (("constexpr int kFlStages = 4;", "constexpr int kFlStages = 3;"),), True),
    ("i2 quads unrolled by 2", ((_QUADS, _QUADS.replace("unroll 1", "unroll 2")),), True),
    ("i2 quads unrolled", ((_QUADS, _QUADS.replace("unroll 1", "unroll")),), True),
    ("FMAs interleaved", ((_FMA_PLANES, _FMA_Q),), True),
    ("no x reads", ((_X_LOADS, _X_REGS),), False),
    ("no G reads", ((_G_LOADS, _G_REGS),), False),
    ("neither", ((_X_LOADS, _X_REGS), (_G_LOADS, _G_REGS)), False),
)

# i8_dot_kernel's lines after which --split's copy stamps a phase (the
# stamp goes after the text, within the CTA's thread 0).
SPLIT_MARKS = (
    ("issued", "    if constexpr (kVec) ln::cp_async_commit();\n  }\n"),
    ("landed", "    __syncthreads();  // chunk ch is in; every thread is done with chunk ch - 1\n"),
    ("transposed", "    __syncthreads();\n    const int left = k - ch * kDotChunk;\n"),
)
_SPLIT_HEAD = "  if (r0 >= m) return;\n  const int c0 = blockIdx.x * kDotTile;\n"
_SPLIT_STORES = ("#pragma unroll\n  for (int nt = 0; nt < 2; ++nt) {\n#pragma unroll\n"
                 "    for (int hh = 0;")
_SPLIT_TAIL = "        if (col + 1 < n) at[1] = acc[nt][2 * hh + 1];\n      }\n    }\n  }\n}\n"
_STAMPS = 8  # globaltimer start, clock64 start, issued, landed, transposed, mma, stored, end


def _csrc():
    from godsp_tpu_torch.ops import _build

    return _build.CSRC


def _nvcc(args: list[str]) -> subprocess.CompletedProcess:
    from godsp_tpu_torch.ops import _build

    return subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                           "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-I", str(_csrc()), *args],
                          capture_output=True, text=True)


def _library(source: str, tmp: str, name: str, kernel: str | None = None):
    """source compiled alone into a shared library in tmp, loaded; where
    `kernel` is given, ptxas's registers and spills of the kernels whose
    mangled name holds it are printed."""
    src = os.path.join(tmp, f"{name}.cu")
    with open(src, "w") as fh:
        fh.write(source)
    so = os.path.join(tmp, f"lib{name}.so")
    res = _nvcc(["-shared", "-Xptxas", "-v", src, "-o", so])
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {name}: {res.stderr[-4000:]}")
    lines = res.stderr.splitlines()
    for i, line in enumerate(lines[:-2]):
        if kernel and "Function properties for" in line and kernel in line:
            print(f"  {name}: {lines[i + 1].strip()}; {lines[i + 2].strip()}", flush=True)
    return ctypes.CDLL(so)


def kernel_alone_ms(symbol: str, run, reps: int = 50):
    """ms a launch of the CUDA kernel whose name holds `symbol`, by the
    profiler's events over reps calls of run() (averaged over the events
    it kept), or None where it recorded none."""
    from godsp_tpu_torch.utils import trace_to

    run()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp, trace_to(tmp) as prof:
        for _ in range(reps):
            run()
    own = [e for e in prof.key_averages() if e.self_device_time_total > 0 and symbol in e.key]
    if not own:
        return None
    return sum(e.self_device_time_total for e in own) / 1e3 / sum(e.count for e in own)


def _fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def ptxas() -> None:
    names = ("16gmm_floor_kernel", "21gmm_floor_sync_kernel", "13i8_dot_kernel",
             "19i8_dot_bytes_kernel")
    with tempfile.TemporaryDirectory() as tmp:
        for src in ("metrics_kernels.cu", "int8_probe_kernels.cu"):
            res = _nvcc(["-Xptxas", "-v", "-c", str(_csrc() / src), "-o",
                         os.path.join(tmp, "k.o")])
            lines = (res.stdout + res.stderr).splitlines()
            print(f"ptxas {src}: rc {res.returncode}", flush=True)
            for i, line in enumerate(lines):
                if "Function properties for" in line and any(k in line for k in names):
                    print(f"  {line.split('for ')[-1][-60:]}: {lines[i + 1].strip()}; "
                          f"{lines[i + 2].strip()}", flush=True)


def sass(path: str | None = None) -> None:
    """gmm_floor_kernel's SASS (cuobjdump) written to `path`; prints
    loop_summary of it: the stall fields are the control bits 41-44 of each
    instruction's upper word, so their sum is the cycles one warp alone
    needs to issue the loop."""
    from godsp_tpu_torch.ops import _build

    path = path or str(_build.BUILD_DIR / "floor_sass.txt")
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "k.cubin")
        res = _nvcc(["-cubin", str(_csrc() / "metrics_kernels.cu"), "-o", cubin])
        if res.returncode != 0:
            raise RuntimeError(res.stderr[-4000:])
        dump = subprocess.run([os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"),
                               "-sass", cubin], capture_output=True, text=True, check=True).stdout
    body = dump[dump.index("16gmm_floor_kernel"):]
    body = body[:body.index("Function :")] if "Function :" in body else body
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        fh.write(body)
    print(f"gmm_floor_kernel SASS in {path}; {loop_summary(body)}", flush=True)


def loop_summary(body: str) -> str:
    """The innermost loop with 64 or more FFMAs (a backward branch and its
    target) of a cuobjdump listing: its opcodes, how many carry
    operand-reuse flags and the sum of their stall fields."""
    import collections
    import re

    lines = body.splitlines()
    ins = []  # (address, text, upper control word)
    for i, ln in enumerate(lines[:-1]):
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);\s*/\* (0x[0-9a-f]+) \*/", ln)
        m2 = re.match(r"\s*/\* (0x[0-9a-f]+) \*/", lines[i + 1])
        if m and m2:
            ins.append((int(m.group(1), 16), m.group(2).strip(), int(m2.group(1), 16)))
    loops = []
    for addr, txt, _ in ins:
        m = re.search(r"BRA\s+(?:!?U?P\w+,\s*)?(0x[0-9a-f]+)", txt)
        if m and int(m.group(1), 16) < addr:
            body_ = [x for x in ins if int(m.group(1), 16) <= x[0] <= addr]
            if sum(t.split()[0] == "FFMA" for _, t, _ in body_) >= 64:
                loops.append(body_)
    loop = min(loops, key=len) if loops else []
    span = (loop[0][0], loop[-1][0]) if loop else (0, 0)
    ops = collections.Counter(re.sub(r"^@!?U?P\w+\s+", "", t).split()[0] for _, t, _ in loop)
    stall = sum((hi >> 41) & 0xF for _, _, hi in loop)
    reuse = sum(1 for _, _, hi in loop if (hi >> 58) & 0xF)
    return (f"its FMA loop {span[0]:#x}-{span[1]:#x}: {len(loop)} instructions, {reuse} "
            f"with reuse flags, stall fields summing to {stall} cycles: " +
            ", ".join(f"{k} {v}" for k, v in ops.most_common()))


def _chain_ms(op, probe) -> float:
    from godsp_tpu_torch.probes._common import chained
    from godsp_tpu_torch.utils.metrics import time_chain_diff

    return time_chain_diff(chained(op), probe) * 1e3


def times(dev) -> None:
    from godsp_tpu_torch.ops import cuda_metrics
    from godsp_tpu_torch.ops import cuda_probes as cp
    from godsp_tpu_torch.probes import int8
    from godsp_tpu_torch.probes._common import complex_matmul, lane_planes, planes_equal

    probe = torch.empty(1, device=dev)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("torch.matmul's yardstick: TF32 is on")
    for b, n in K13_SHAPES:
        xr, xi = lane_planes(dev, b, n, seed=20)
        new = lambda: cuda_metrics.gmm_floor(xr, xi)  # noqa: E731
        first = lambda: cp.gmm_floor_sync(xr, xi)  # noqa: E731
        if not planes_equal(new(), first()):
            raise AssertionError(f"K13 {b} x {n}: not equal to gmm_floor_sync")
        lib = complex_matmul(xr, xi)
        chains = [(label, _chain_ms(op, probe)) for label, op in (
            ("K13", new), ("first design", first), ("first design", first), ("K13", new),
            ("torch.matmul", lib))]
        alone = [(label, kernel_alone_ms(symbol, op, 20)) for label, symbol, op in (
            ("K13", "gmm_floor_kernel", new), ("first design", "gmm_floor_sync_kernel", first))]
        plan = cuda_metrics.gmm_floor_plan(b, n, cuda_metrics._floor_resident(dev))
        print(f"K13 {b} x {n} ({plan.ctas} CTAs, {plan.items} items) by chain: " + "  ".join(
            f"{label} {ms:.4f} ms" for label, ms in chains) + "; alone: " + "  ".join(
            f"{label} {_fmt(ms)}" for label, ms in alone), flush=True)
        del xr, xi, lib
    for m, k, n in int8.DOT_SHAPES:
        a, b_ = int8.dot_inputs(dev, m, k, n)
        if not torch.equal(cp.i8_dot(a, b_), cp.i8_dot_bytes(a, b_)):
            raise AssertionError(f"i8_dot ({m}, {k}) @ ({k}, {n}): not equal to i8_dot_bytes")
        alone = [(label, kernel_alone_ms(symbol, op)) for label, symbol, op in (
            ("i8_dot", "i8_dot_kernel", lambda: cp.i8_dot(a, b_)),
            ("first design", "i8_dot_bytes_kernel", lambda: cp.i8_dot_bytes(a, b_)),
            ("torch._int_mm", "gemm", lambda: torch._int_mm(a, b_)),
            ("i8_dot", "i8_dot_kernel", lambda: cp.i8_dot(a, b_)))]
        print(f"i8_dot ({m}, {k}) @ ({k}, {n}) alone: " + "  ".join(
            f"{label} {_fmt(ms)}" for label, ms in alone), flush=True)


def split_source() -> str:
    """csrc/int8_probe_kernels.cu with i8_dot_kernel stamping its phases
    (thread 0 of each CTA, into the device array gdsp_dot_stamps) and an
    entry gdsp_dot_stamps_read(out, ctas) that copies them out."""
    s = (_csrc() / "int8_probe_kernels.cu").read_text()
    decl = ("__device__ unsigned long long gdsp_dot_stamps[4096 * %d];\n"
            "__device__ __forceinline__ unsigned long long gdsp_gtime() {\n"
            "  unsigned long long t;\n"
            "  asm volatile(\"mov.u64 %%0, %%%%globaltimer;\" : \"=l\"(t));\n"
            "  return t;\n}\n" % _STAMPS)
    stamp = ("    if (threadIdx.x == 0 && cta < 4096) gdsp_dot_stamps[cta * %d + %d] = "
             "clock64();\n")
    for text in (_SPLIT_HEAD, _SPLIT_STORES, _SPLIT_TAIL) + tuple(t for _, t in SPLIT_MARKS):
        if s.count(text) != 1:
            raise LookupError(f"split_source: {text!r} is not in the source once")
    s = s.replace("namespace {\n", decl + "namespace {\n", 1)
    s = s.replace(_SPLIT_HEAD, _SPLIT_HEAD + (
        "  const unsigned cta = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);\n"
        "  if (threadIdx.x == 0 && cta < 4096) {\n"
        "    gdsp_dot_stamps[cta * %d] = gdsp_gtime();\n"
        "    gdsp_dot_stamps[cta * %d + 1] = clock64();\n  }\n") % (_STAMPS, _STAMPS))
    for i, (_, text) in enumerate(SPLIT_MARKS):
        s = s.replace(text, text + stamp % (_STAMPS, 2 + i), 1)
    s = s.replace(_SPLIT_STORES, stamp % (_STAMPS, 5) + _SPLIT_STORES, 1)
    s = s.replace(_SPLIT_TAIL, _SPLIT_TAIL[:-2] + stamp % (_STAMPS, 6) + (
        "  if (threadIdx.x == 0 && cta < 4096) gdsp_dot_stamps[cta * %d + 7] = gdsp_gtime();\n"
        "}\n") % _STAMPS, 1)
    return s + (
        '\nextern "C" int gdsp_dot_stamps_read(unsigned long long* out, int ctas) {\n'
        "  return static_cast<int>(cudaMemcpyFromSymbol(out, gdsp_dot_stamps,\n"
        "                                               sizeof(unsigned long long) * %d * ctas));\n"
        "}\n") % _STAMPS


def split(dev) -> None:
    from godsp_tpu_torch.ops import cuda_probes as cp
    from godsp_tpu_torch.probes import int8

    m, k, n = int8.DOT_SHAPES[0]
    a, b = int8.dot_inputs(dev, m, k, n)
    plan = cp.i8_dot_plan(m, k, n)
    with tempfile.TemporaryDirectory() as tmp:
        lib = _library(split_source(), tmp, "dot_split")
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.gdsp_i8_dot.argtypes = [p, p, p, i64, i, i, p]
        lib.gdsp_dot_stamps_read.argtypes = [p, i]
        c = torch.empty(m, n, dtype=torch.int32, device=dev)

        def run():
            rc = lib.gdsp_i8_dot(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, k, n,
                                 torch.cuda.current_stream(dev).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"instrumented i8_dot: CUDA error {rc}")

        alone = kernel_alone_ms("i8_dot_kernel", run)
        run()
        torch.cuda.synchronize()
        if not torch.equal(c, cp.i8_dot_plain(a, b)):
            raise AssertionError("instrumented i8_dot: wrong result")
        out = (ctypes.c_ulonglong * (_STAMPS * plan.ctas))()
        if lib.gdsp_dot_stamps_read(out, plan.ctas) != 0:
            raise RuntimeError("gdsp_dot_stamps_read failed")
    st = [list(out[_STAMPS * j:_STAMPS * (j + 1)]) for j in range(plan.ctas)]
    names = ("issued", "landed", "transposed", "mma done", "stored")
    print(f"i8_dot phases at ({m}, {k}) @ ({k}, {n}), {plan.ctas} CTAs, clock64 cycles from "
          f"the CTA's start (median / largest over the CTAs):", flush=True)
    for j, name in enumerate(names):
        d = [s[2 + j] - s[1] for s in st]
        print(f"  {name:10s} {statistics.median(d):8.0f} / {max(d)} cycles", flush=True)
    starts = [s[0] for s in st]
    span = max(s[7] for s in st) - min(starts)
    print(f"  CTA starts spread {max(starts) - min(starts)} ns (%globaltimer); first start to "
          f"last end {span} ns; the instrumented kernel alone {_fmt(alone)}", flush=True)


def variant_source(edits) -> str:
    """csrc/metrics_kernels.cu with each (line, replacement) of edits made."""
    s = (_csrc() / "metrics_kernels.cu").read_text()
    for line, repl in edits:
        if s.count(line) != 1:
            raise LookupError(f"variant_source: {line!r} is not in metrics_kernels.cu once")
        s = s.replace(line, repl)
    return s


def variants(dev) -> None:
    from godsp_tpu_torch.ops import cuda_metrics
    from godsp_tpu_torch.probes._common import lane_planes

    probe = torch.empty(1, device=dev)
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    with tempfile.TemporaryDirectory() as tmp:
        libs = []
        for j, (name, edits, exact) in enumerate(VARIANTS):
            lib = _library(variant_source(edits), tmp, f"k13_{j}", "16gmm_floor_kernel")
            lib.gdsp_gmm_floor.argtypes = [p, p, p, p, p, i64, i, i, p]
            lib.gdsp_gmm_floor_resident.argtypes = [i]
            with torch.cuda.device(dev):
                libs.append((name, lib, int(lib.gdsp_gmm_floor_resident(0)), exact))
        for b, n in K13_SHAPES:
            xr, xi = lane_planes(dev, b, n, seed=20)
            g = cuda_metrics.gmm_tables(n, dev)
            want = cuda_metrics.gmm_floor(xr, xi)
            line = []
            for name, lib, resident, exact in libs:
                yr, yi = torch.empty_like(xr), torch.empty_like(xi)

                def run(lib=lib, yr=yr, yi=yi, resident=resident):
                    rc = lib.gdsp_gmm_floor(xr.data_ptr(), xi.data_ptr(), yr.data_ptr(),
                                            yi.data_ptr(), g.data_ptr(), b, n, resident,
                                            torch.cuda.current_stream(dev).cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"K13 variant: CUDA error {rc}")
                    return yr, yi

                run()
                if exact and not (torch.equal(yr, want[0]) and torch.equal(yi, want[1])):
                    raise AssertionError(f"K13 variant {name}: not equal to K13")
                line.append((name, _chain_ms(run, probe)))
            base = lambda: cuda_metrics.gmm_floor(xr, xi)  # noqa: E731
            line = [("as built", _chain_ms(base, probe))] + line + [("as built",
                                                                     _chain_ms(base, probe))]
            print(f"K13 variants {b} x {n} by chain: " + "  ".join(
                f"{name} {ms:.4f} ms" for name, ms in line), flush=True)
            del xr, xi, want
    clocks(dev)


def clocks(dev, seconds: float = 2.0) -> None:
    """nvidia-smi's SM clock and power draw, sampled every 100 ms while K13
    runs back to back at 16384 x 1024 for about `seconds`."""
    import time

    from godsp_tpu_torch.ops import cuda_metrics
    from godsp_tpu_torch.probes._common import lane_planes

    xr, xi = lane_planes(dev, 16384, 1024, seed=20)
    cuda_metrics.gmm_floor(xr, xi)
    torch.cuda.synchronize()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader", "-lms", "100"],
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0, calls = time.perf_counter(), 0
        while time.perf_counter() - t0 < seconds:
            for _ in range(200):
                cuda_metrics.gmm_floor(xr, xi)
            torch.cuda.synchronize()
            calls += 200
    finally:
        smi.terminate()
        out = smi.communicate(timeout=30)[0]
    ms = (time.perf_counter() - t0) * 1e3 / calls
    print(f"K13 16384 x 1024 back to back: {ms:.4f} ms a call (host clock); nvidia-smi "
          f"clocks.sm, power.draw: " + "; ".join(out.strip().splitlines()[2:12]), flush=True)


def main(argv: list[str] | None = None) -> int:
    from godsp_tpu_torch import set_default_device
    from godsp_tpu_torch.probes._common import card

    argv = sys.argv[1:] if argv is None else argv
    parts = [a.lstrip("-") for a in argv] or ["ptxas", "sass", "times", "split", "variants"]
    if not torch.cuda.is_available():
        raise SystemExit("floor_dot: needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    print(f"nvidia-smi: {card()}", flush=True)
    set_default_device("cuda")
    dev = torch.device("cuda", 0)
    for part in parts:
        {"ptxas": lambda: ptxas(), "sass": lambda: sass(), "times": lambda: times(dev),
         "split": lambda: split(dev), "variants": lambda: variants(dev)}[part]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
