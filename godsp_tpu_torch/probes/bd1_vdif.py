"""K14d's bd_tf32 and K14h's vdif as redesigned for Hopper, on one GPU: their
first designs and redesigns read from ptxas and SASS, their times beside
the first designs, library calls, K12's copy and the bound, and variants
of the first designs that isolate each suspected gap.

    python3 -m godsp_tpu_torch.probes.bd1_vdif [--ptxas] [--sass] [--times] [--variants]
                                               [--tune]

--ptxas compiles csrc/anatomy_probe_kernels.cu and csrc/dif_probe_kernels.cu
with `-Xptxas -v` and prints the registers, stack frame, spill stores and
loads and blocks a SM (from the registers, threads and shared memory) of
bd_tf32_kernel, bd_tf32_sync_kernel, vdif_kernel<8> and vdif_sync_kernel<8>.

--sass reads both sources' SASS (cuobjdump; the first designs' listings in
the package's git-ignored _build/bd1_sync_sass.txt and vdif_sync_sass.txt)
and prints, per k-step of bd_tf32_sync (its k-step loop, 16 HMMA a k-step
a warp), per 64-row item of bd_tf32 (its item loop, 16 HGMMA an item), and
per row of vdif_sync and vdif (the whole function, or the row loop, 320
SHFL a row at n1 = 8), the counts of HMMA/HGMMA, LDG, LDS, LDL/STL, SHFL,
STG, STS, F2F and the float32 arithmetic (sass_counts).

--times times at 16384 x 1024, by chain (utils.metrics.time_chain_diff) and
alone (the profiler's events of the kernel; of a library call, the device
time of all its kernels a call), bd_tf32 beside bd_tf32_sync,
torch.matmul of the (b, 8, 128) views and Re F128 with TF32 on for that
call, and K12's copy; vdif (n1 8, scale 1/32) beside vdif_sync,
torch.fft.fft(z, norm="ortho") and K12's copy; in turns (redesign, first
design, first design, redesign), each with its bound.

--variants builds copies of the two sources with a first design changed
(VARIANTS), checks that each gives the first design's result bit for bit,
and prints each copy's registers and time by chain beside the first
design as it is: vdif_sync with two rows a warp (the second row's loads
issued before the first row's shuffles), with 16-byte loads through
shared memory, with T from shared memory; bd_tf32_sync with A staged by
coalesced 16-byte copies, with its outputs stored through shared memory,
and with both.

--tune builds copies of the two sources with one part of a redesign
changed (TUNE), checks that each gives the redesign's result bit for bit,
and prints each copy's registers and time by chain beside the redesign as
it is: vdif with the outputs staged in a second buffer a warp and stored
16 bytes at a time, as a persistent grid whose warps walk rows and copy
each next row under the current row's butterflies, with registers for 2
blocks an SM, and with its row read into z[brev(k)] as the first design
loads it (which puts z in a stack frame); bd_tf32 with 4 stages.

All by default.  Prints the card's name and power limit first.  Needs a
CUDA device; imports nothing of JAX.  The checks and the redesign lines of
the smoke are chip_smoke.py's phase 3 (phase_bd1_vdif_redesign).
"""

from __future__ import annotations

import collections
import re
import sys
import tempfile

import torch

from godsp_tpu_torch.probes.bd_hi import _compile, _entry, _function, ptxas_info, variant_source
from godsp_tpu_torch.probes.floor_dot import _chain_ms, _fmt, kernel_alone_ms

__all__ = ["B", "N", "TUNE", "VARIANTS", "blocks_per_sm", "call_device_ms", "loop_of", "main",
           "ptxas_info", "sass_counts"]

B, N = 16384, 1024  # the anatomy and vdif probes' planes
VDIF_SCALE = N ** -0.5

_A = "anatomy_probe_kernels.cu"
_D = "dif_probe_kernels.cu"
# (label, source, mangled-name part, threads a block, dynamic shared bytes)
_KERNELS = (("bd_tf32_kernel", _A, "14bd_tf32_kernel", 288, 230_480),
            ("bd_tf32_sync_kernel", _A, "19bd_tf32_sync_kernel", 256, 69_632),
            ("vdif_kernel<8>", _D, "11vdif_kernelILi8E", 128, 40_960),
            ("vdif_sync_kernel<8>", _D, "16vdif_sync_kernelILi8E", 256, 0))

# What the SASS counts are per: (mangled-name part, the opcode that marks the
# loop, its count a unit, the unit).
_UNITS = {"14bd_tf32_kernel": ("HGMMA", 16, "64-row item"),
          "19bd_tf32_sync_kernel": ("HMMA", 16, "k-step"),
          "11vdif_kernelILi8E": ("SHFL", 320, "row"),
          "16vdif_sync_kernelILi8E": ("SHFL", 320, "row")}
_SHOWN = ("HMMA", "HGMMA", "LDG", "LDS", "LDL", "STL", "SHFL", "STG", "STS", "F2F", "F2FP",
          "FFMA", "FADD", "FMUL", "SEL", "FSEL", "BAR", "SYNCS")

# vdif_sync: two rows a warp, the second row's loads before the first row's
# butterflies (half the blocks).
_VD_BODY = ("  const long long row = gdsp::block_row() * kVdifRows + (threadIdx.x >> 5);\n"
            "  if (row >= b) return;  // the whole warp: its shuffles keep all 32 lanes\n"
            "  const int lane = threadIdx.x & 31;\n"
            "  const size_t base = static_cast<size_t>(row) * n + lane;\n"
            "  float2 z[N1][kQ];\n"
            "  vdif_sync_load(z, xr, xi, base);\n"
            "  vdif_sync_row(z, tab, tab + n, lane);\n"
            "  vdif_store(z, yr, yi, base);\n")
_VD_TWO = ("  const long long row = 2 * (gdsp::block_row() * kVdifRows + (threadIdx.x >> 5));\n"
           "  if (row >= b) return;\n"
           "  const int lane = threadIdx.x & 31;\n"
           "  const size_t base = static_cast<size_t>(row) * n + lane;\n"
           "  const bool two = row + 1 < b;\n"
           "  float2 z[N1][kQ], z2[N1][kQ];\n"
           "  vdif_sync_load(z, xr, xi, base);\n"
           "  if (two) vdif_sync_load(z2, xr, xi, base + n);\n"
           "  vdif_sync_row(z, tab, tab + n, lane);\n"
           "  vdif_store(z, yr, yi, base);\n"
           "  if (two) {\n"
           "    vdif_sync_row(z2, tab, tab + n, lane);\n"
           "    vdif_store(z2, yr, yi, base + n);\n"
           "  }\n")
_VD_GRID = "  const dim3 grid = gdsp::row_grid(1, (b + kVdifRows - 1) / kVdifRows);\n"
_VD_GRID2 = "  const dim3 grid = gdsp::row_grid(1, (b + 2 * kVdifRows - 1) / (2 * kVdifRows));\n"
# vdif_sync: each warp's row by 16-byte loads into shared memory, then read
# as the first design holds it (64 KB a block at n1 = 8).
_VD_LOAD = "  vdif_sync_load(z, xr, xi, base);\n  vdif_sync_row(z, tab, tab + n, lane);\n"
_VD_LOAD16 = (
    "  extern __shared__ float4 vsm[];\n"
    "  float4* w4 = vsm + (threadIdx.x >> 5) * (n / 2);\n"
    "  const float4* r4 = reinterpret_cast<const float4*>(xr + (base - lane));\n"
    "  const float4* i4 = reinterpret_cast<const float4*>(xi + (base - lane));\n"
    "#pragma unroll\n"
    "  for (int e = lane; e < n / 4; e += 32) {\n"
    "    w4[e] = __ldg(r4 + e);\n"
    "    w4[n / 4 + e] = __ldg(i4 + e);\n"
    "  }\n"
    "  __syncwarp();\n"
    "  const float* wf = reinterpret_cast<const float*>(w4);\n"
    "#pragma unroll\n"
    "  for (int j1 = 0; j1 < N1; ++j1) {\n"
    "#pragma unroll\n"
    "    for (int q = 0; q < kQ; ++q)\n"
    "      z[rev_bits(j1, log2_small(N1))][q] =\n"
    "          make_float2(wf[j1 * kLanes + lane + 32 * q], wf[n + j1 * kLanes + lane + 32 * q]);\n"
    "  }\n"
    "  vdif_sync_row(z, tab, tab + n, lane);\n")
_VD_LAUNCH8 = ("    default: vdif_sync_kernel<8><<<grid, kVdifThreads, 0, s>>>(xr, xi, yr, yi, tab, b);"
               " break;\n")
_VD_LAUNCH8_SMEM = (
    "    default:\n"
    "      if (cudaFuncSetAttribute(vdif_sync_kernel<8>, cudaFuncAttributeMaxDynamicSharedMemorySize,"
    " 65536) != cudaSuccess) return 1;\n"
    "      vdif_sync_kernel<8><<<grid, kVdifThreads, 65536, s>>>(xr, xi, yr, yi, tab, b);\n"
    "      break;\n")
# vdif_sync: T staged once a block in shared memory.
_VD_RET = "  if (row >= b) return;  // the whole warp: its shuffles keep all 32 lanes\n"
_VD_RET_T = ("  __shared__ float2 sT[n];\n"
             "  for (int e = threadIdx.x; e < n; e += kVdifThreads) sT[e] = __ldg(tab + e);\n"
             "  __syncthreads();\n" + _VD_RET)
_VD_ROW = "  vdif_sync_row(z, tab, tab + n, lane);\n"
_VD_ROW_T = "  vdif_sync_row(z, sT, tab + n, lane);\n"
_VD_TLOAD = "__ldg(&T[k1 * kLanes + lane + 32 * q])"
_VD_TLOAD_S = "T[k1 * kLanes + lane + 32 * q]"

# bd_tf32_sync: a 16-row x 128-column tile a warp in shared memory (rows 132
# floats apart), filled by coalesced 16-byte loads and/or drained by 16-byte
# stores.
_B1_SMEM = "constexpr int kTf32Smem = kLanes * kFS * sizeof(float);"
_B1_SMEM_TILES = ("constexpr int kTf32Smem =\n"
                  "    kLanes * kFS * sizeof(float) + kWarps * 16 * (kLanes + kPad) * sizeof(float);")
_B1_TILE = ("reinterpret_cast<float*>(smem4) + kLanes * kFS + (threadIdx.x >> 5) * 16 * "
            "(kLanes + kPad)")
_B1_X = "      const float* x = (p ? xi : xr) + base;\n"
_B1_X_STAGED = (
    "      const float* xg = (p ? xi : xr) + base;\n"
    f"      float* x = {_B1_TILE};\n"
    "      __syncwarp();\n"
    "#pragma unroll\n"
    "      for (int e = threadIdx.x & 31; e < 16 * kLanes / 4; e += 32) {\n"
    "        const int rr = e / (kLanes / 4), cc = 4 * (e % (kLanes / 4));\n"
    "        *reinterpret_cast<float4*>(x + rr * (kLanes + kPad) + cc) =\n"
    "            rr < rows ? __ldg(reinterpret_cast<const float4*>(xg + static_cast<size_t>(rr) * n"
    " + cc))\n"
    "                      : make_float4(0.f, 0.f, 0.f, 0.f);\n"
    "      }\n"
    "      __syncwarp();\n")
_B1_A = "        a_values(v, x, n, rows, 8 * ks);\n"
_B1_A_STAGED = "        a_values(v, x, kLanes + kPad, rows, 8 * ks);\n"
_B1_OUT = ("#pragma unroll\n"
           "      for (int nt = 0; nt < 16; ++nt)\n"
           "        store_c(y, n, rows, 8 * nt + 2 * t, acc[nt][0], acc[nt][1], acc[nt][2], "
           "acc[nt][3]);\n")
_B1_OUT_STAGED = (
    f"      float* o = {_B1_TILE};\n"
    "      __syncwarp();\n"
    "#pragma unroll\n"
    "      for (int nt = 0; nt < 16; ++nt)\n"
    "        store_c(o, kLanes + kPad, rows, 8 * nt + 2 * t, acc[nt][0], acc[nt][1], acc[nt][2],"
    " acc[nt][3]);\n"
    "      __syncwarp();\n"
    "#pragma unroll\n"
    "      for (int e = threadIdx.x & 31; e < 16 * kLanes / 4; e += 32) {\n"
    "        const int rr = e / (kLanes / 4), cc = 4 * (e % (kLanes / 4));\n"
    "        if (rr < rows)\n"
    "          *reinterpret_cast<float4*>(y + static_cast<size_t>(rr) * n + cc) =\n"
    "              *reinterpret_cast<const float4*>(o + rr * (kLanes + kPad) + cc);\n"
    "      }\n")
_B1_STAGE_A = ((_B1_SMEM, _B1_SMEM_TILES), (_B1_X, _B1_X_STAGED), (_B1_A, _B1_A_STAGED))
_B1_STAGE_OUT = ((_B1_SMEM, _B1_SMEM_TILES), (_B1_OUT, _B1_OUT_STAGED))

# (label, source, mangled-name part, C entry, edits (text, replacement)):
# each must give the first design's result bit for bit.
VARIANTS = (
    ("vdif_sync, two rows a warp", _D, "16vdif_sync_kernelILi8E", "gdsp_vdif_sync",
     ((_VD_BODY, _VD_TWO), (_VD_GRID, _VD_GRID2))),
    ("vdif_sync, 16-byte loads through shared memory", _D, "16vdif_sync_kernelILi8E",
     "gdsp_vdif_sync", ((_VD_LOAD, _VD_LOAD16), (_VD_LAUNCH8, _VD_LAUNCH8_SMEM))),
    ("vdif_sync, T from shared memory", _D, "16vdif_sync_kernelILi8E", "gdsp_vdif_sync",
     ((_VD_RET, _VD_RET_T), (_VD_ROW, _VD_ROW_T), (_VD_TLOAD, _VD_TLOAD_S))),
    ("bd_tf32_sync, A staged by 16-byte copies", _A, "19bd_tf32_sync_kernel",
     "gdsp_bd_tf32_sync", _B1_STAGE_A),
    ("bd_tf32_sync, outputs through shared memory", _A, "19bd_tf32_sync_kernel",
     "gdsp_bd_tf32_sync", _B1_STAGE_OUT),
    ("bd_tf32_sync, both", _A, "19bd_tf32_sync_kernel", "gdsp_bd_tf32_sync",
     _B1_STAGE_A + _B1_STAGE_OUT[1:]),
)

# vdif's store of its row, and the row staged in a second buffer a warp and
# stored 16 bytes at a time.
_VD_STORE = "  vdif_store(z, yr, yi, static_cast<size_t>(row) * n + lane);\n"
_VD_STORE16 = (
    "  float* out = buf + 2 * n;\n"
    "#pragma unroll\n"
    "  for (int k1 = 0; k1 < N1; ++k1) {\n"
    "#pragma unroll\n"
    "    for (int q = 0; q < kQ; ++q) {\n"
    "      out[k1 * kLanes + lane + 32 * q] = z[k1][q].x;\n"
    "      out[n + k1 * kLanes + lane + 32 * q] = z[k1][q].y;\n"
    "    }\n"
    "  }\n"
    "  __syncwarp();\n"
    "  const size_t base = static_cast<size_t>(row) * n;\n"
    "#pragma unroll\n"
    "  for (int e = 4 * lane; e < n; e += 128) {\n"
    "    *reinterpret_cast<float4*>(yr + base + e) = *reinterpret_cast<const float4*>(out + e);\n"
    "    *reinterpret_cast<float4*>(yi + base + e) = *reinterpret_cast<const float4*>(out + n + e);\n"
    "  }\n")
_VD_TWO_BUFS = (
    ("  return n1 * kLanes * 8 + kVdWarps * n1 * kLanes * 8;",
     "  return n1 * kLanes * 8 + 2 * kVdWarps * n1 * kLanes * 8;"),
    ("(threadIdx.x >> 5) * 2 * n;", "(threadIdx.x >> 5) * 4 * n;"),
    (_VD_STORE, _VD_STORE16))
# vdif as a persistent grid (the 4 x 132 blocks an H100 holds at once):
# warp g walks rows g, g + warps, ..., and copies its next row into the
# buffer as soon as it has read the current one.
_VD_LOOP = ("  const long long warps = static_cast<long long>(gridDim.x) * kVdWarps;\n"
            "  for (; row < b; row += warps) {\n")
_VD_NEXT = ("  __syncwarp();\n"
            "  if (row + warps < b) vdif_fetch<N1>(buf, xr, xi, row + warps, lane);\n"
            "  vdif_butterflies(z, sT, tw, lane);\n")
_PERSISTENT = (
    ("  const long long row = static_cast<long long>(blockIdx.x) * kVdWarps + (threadIdx.x >> 5);",
     "  long long row = static_cast<long long>(blockIdx.x) * kVdWarps + (threadIdx.x >> 5);"),
    ("  if (row >= b) return;  // the whole warp\n", _VD_LOOP),
    ("  vdif_butterflies(z, sT, tw, lane);\n", _VD_NEXT),
    (_VD_STORE, _VD_STORE + "  }\n"),
    ("  const long long blocks = need < 1 ? 1 : need;",
     "  const long long blocks = need < 1 ? 1 : (need < 528 ? need : 528);"))
# vdif's row read into z[brev(k)], as the first design loads it.
_VD_REV_ADDR = ("      const int at = rev_bits(k, kBits) * kLanes + lane + 32 * q;\n"
                "      z[k][q] = make_float2(buf[at], buf[n + at]);")
_VD_REV_REG = ("      const int at = k * kLanes + lane + 32 * q;\n"
               "      z[rev_bits(k, kBits)][q] = make_float2(buf[at], buf[n + at]);")

# (label, source, mangled-name part, C entry, edits): copies of a redesign
# with one part changed, each equal to the redesign bit for bit.
TUNE = (
    ("vdif, outputs staged, 16-byte stores", _D, "11vdif_kernelILi8E", "gdsp_vdif", _VD_TWO_BUFS),
    ("vdif, a persistent grid of 4 x 132 blocks, the next row copied early", _D,
     "11vdif_kernelILi8E", "gdsp_vdif", _PERSISTENT),
    ("vdif, registers for 2 blocks an SM", _D, "11vdif_kernelILi8E", "gdsp_vdif",
     (("constexpr int kVdMinBlocks = 4;", "constexpr int kVdMinBlocks = 2;"),)),
    ("vdif, z indexed by brev (the first design's load)", _D, "11vdif_kernelILi8E", "gdsp_vdif",
     ((_VD_REV_ADDR, _VD_REV_REG),)),
    ("bd_tf32, 4 stages", _A, "14bd_tf32_kernel", "gdsp_bd_tf32",
     (("constexpr int kB1Stages = 5;", "constexpr int kB1Stages = 4;"),)),
)


def blocks_per_sm(regs: int, threads: int, smem: int) -> int:
    """Blocks of `threads` threads, `regs` registers a thread (allocated in
    eights) and `smem` dynamic shared bytes an H100 SM holds: at most 32
    blocks, 2048 threads, 65,536 registers and 233,472 bytes of shared
    memory (1 KB a block reserved)."""
    by_regs = 65536 // (-(-max(regs, 1) // 8) * 8 * threads)
    return min(32, 2048 // threads, by_regs, 233472 // (smem + 1024))


def _instructions(body: str) -> list[tuple[int, str]]:
    return [(int(a, 16), t.strip()) for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", body)]


def _opcode(text: str) -> str:
    return re.sub(r"^@!?U?P\w+\s+", "", text).split()[0].split(".")[0]


def loop_of(body: str, opcode: str) -> list[str]:
    """The innermost loop (a backward branch and its target) of a cuobjdump
    listing that holds `opcode`, or the whole listing where none does."""
    ins = _instructions(body)
    loops = []
    for addr, txt in ins:
        m = re.search(r"BRA\s+(?:!?U?P\w+,\s*)?(0x[0-9a-f]+)", txt)
        if m and int(m.group(1), 16) < addr:
            loop = [t for a, t in ins if int(m.group(1), 16) <= a <= addr]
            if any(_opcode(t) == opcode for t in loop if t):
                loops.append(loop)
    return min(loops, key=len) if loops else [t for _, t in ins]


def sass_counts(body: str, opcode: str, per_unit: int) -> tuple[float, dict[str, float]]:
    """The units (opcode's count over per_unit) in the innermost loop holding
    `opcode` (loop_of) and that loop's instructions a unit by opcode, with
    "total"."""
    ops = collections.Counter(_opcode(t) for t in loop_of(body, opcode) if t)
    units = ops[opcode] / per_unit or 1.0
    out = {k: v / units for k, v in ops.most_common()}
    out["total"] = sum(ops.values()) / units
    return units, out


def ptxas() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        for src in (_A, _D):
            keys = [k for _, s, k, _, _ in _KERNELS if s == src]
            with open(_source_path(src)) as fh:
                _, info, _ = _compile(fh.read(), tmp, src[:-3], keys)
            for label, s, key, threads, smem in _KERNELS:
                if s == src and key in info:
                    regs, spill = info[key]
                    print(f"ptxas {label}: {regs} registers, {threads} threads, "
                          f"{blocks_per_sm(regs, threads, smem)} blocks a SM; {spill}", flush=True)


def _source_path(src: str):
    from godsp_tpu_torch.ops import _build

    return _build.CSRC / src


def sass() -> None:
    from godsp_tpu_torch.ops import _build

    with tempfile.TemporaryDirectory() as tmp:
        for src in (_A, _D):
            keys = [k for _, s, k, _, _ in _KERNELS if s == src]
            with open(_source_path(src)) as fh:
                _, info, dump = _compile(fh.read(), tmp, src[:-3], keys)
            for label, s, key, _, _ in _KERNELS:
                if s != src or key not in info:
                    continue
                body = _function(dump, key)
                if "sync" in key:
                    name = "bd1_sync_sass.txt" if src == _A else "vdif_sync_sass.txt"
                    path = _build.BUILD_DIR / name
                    path.parent.mkdir(parents=True, exist_ok=True)
                    path.write_text(body)
                opcode, per, unit = _UNITS[key]
                units, counts = sass_counts(body, opcode, per)
                shown = ", ".join(f"{k} {counts[k]:g}" for k in _SHOWN if k in counts)
                print(f"sass {label}: the loop holding {opcode} has {units:g} {unit}s; a {unit}: "
                      f"{shown}; total {counts['total']:g}", flush=True)


def _bd1_rows(dev, xr, xi):
    from godsp_tpu_torch.ops import cuda_probes as cp
    from godsp_tpu_torch.probes import anatomy2

    lib = anatomy2.ops(xr, xi, anatomy2.tw_row(dev, N))["bd1"][1]
    return (lambda: cp.bd_tf32(xr, xi), lambda: cp.bd_tf32_sync(xr, xi), lib,
            ("bd_tf32_kernel", "bd_tf32_sync_kernel"), "torch.matmul TF32")


def _vdif_rows(dev, xr, xi):
    from godsp_tpu_torch.ops import cuda_probes as cp

    z = torch.complex(xr, xi)
    return (lambda: cp.vdif(xr, xi, VDIF_SCALE), lambda: cp.vdif_sync(xr, xi, VDIF_SCALE),
            lambda: torch.fft.fft(z, norm="ortho"), ("vdif_kernel", "vdif_sync_kernel"),
            "torch.fft.fft")


def call_device_ms(run, reps: int = 20):
    """ms of device time a call of run(), all its kernels summed, by the
    profiler's events over reps calls (device events only: an operator's
    row may repeat its kernels' time), or None where it recorded none."""
    from godsp_tpu_torch.utils import trace_to

    run()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp, trace_to(tmp) as prof:
        for _ in range(reps):
            run()
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0
            and e.device_type != torch.autograd.DeviceType.CPU]
    return sum(e.self_device_time_total for e in rows) / 1e3 / reps if rows else None


def times(dev) -> None:
    from godsp_tpu_torch.ops import cuda_metrics
    from godsp_tpu_torch.ops import cuda_probes as cp
    from godsp_tpu_torch.probes._common import TF32_FLOPS, lane_planes, planes_db
    from godsp_tpu_torch.utils.metrics import FP32_FLOPS, bound_ms

    probe = torch.empty(1, device=dev)
    xr, xi = lane_planes(dev, B, N, seed=23)
    x64 = (xr.double(), xi.double())
    pts = float(B * N)
    copy = lambda: cuda_metrics.copy_split(xr, xi)  # noqa: E731
    for name, rows, want, flops in (
            ("bd_tf32", _bd1_rows, cp.bd_tf32_plain(*x64, tf32=True),
             512.0 * pts * FP32_FLOPS / TF32_FLOPS),
            ("vdif", _vdif_rows, cp.vdif_plain(*x64, VDIF_SCALE), 56.0 * pts)):
        new, first, lib, symbols, lib_label = rows(dev, xr, xi)
        errs: dict = {}
        dbs = (planes_db(new(), want, errs, "new"), planes_db(first(), want, errs, "first"))
        bnd, by = bound_ms(16.0 * pts, flops)
        chains = [(label, _chain_ms(op, probe)) for label, op in (
            (name, new), ("first design", first), ("first design", first), (name, new),
            (lib_label, lib), ("K12 copy", copy))]
        alone = [(label, kernel_alone_ms(symbol, op, 20)) for label, symbol, op in (
            (name, symbols[0], new), ("first design", symbols[1], first),
            ("K12 copy", "copy_split_kernel", copy))]
        alone.insert(2, (lib_label, call_device_ms(lib)))
        print(f"{name} {B} x {N} ({dbs[0]:.2f} dB, first design {dbs[1]:.2f}; bound {bnd:.4f} ms, "
              f"{by}) by chain: " + "  ".join(f"{label} {ms:.4f} ms" for label, ms in chains) +
              "; alone: " + "  ".join(f"{label} {_fmt(ms)}" for label, ms in alone), flush=True)


def variants(dev) -> None:
    from godsp_tpu_torch.ops import cuda_probes as cp
    from godsp_tpu_torch.probes._common import lane_planes, planes_equal

    probe = torch.empty(1, device=dev)
    xr, xi = lane_planes(dev, B, N, seed=23)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    tables = {"gdsp_bd_tf32_sync": cp.re_f128(dev),
              "gdsp_vdif_sync": cp._vdif_packed(N // 128, VDIF_SCALE, dev)}
    bases = {"gdsp_bd_tf32_sync": lambda: cp.bd_tf32_sync(xr, xi),
             "gdsp_vdif_sync": lambda: cp.vdif_sync(xr, xi, VDIF_SCALE)}
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for j, (label, src, key, entry, edits) in enumerate(VARIANTS):
            lib, info, _ = _compile(variant_source(src, edits), tmp, f"variant_{j}", (key,))
            op = _entry(lib, entry, (tables[entry],))
            base = bases[entry]
            if not planes_equal(op(xr, xi, yr, yi), base()):
                raise AssertionError(f"{label}: not equal to the first design")
            regs, spill = info[key]
            run = lambda op=op: op(xr, xi, yr, yi)  # noqa: E731
            rows.append((label, _chain_ms(base, probe), _chain_ms(run, probe),
                         _chain_ms(base, probe), f"{regs} registers; {spill}"))
    for label, before, ms, after, regs in rows:
        print(f"variant {label}: {ms:.4f} ms by chain (the first design as it is {before:.4f} / "
              f"{after:.4f}); {regs}", flush=True)


def tune(dev) -> None:
    import ctypes

    from godsp_tpu_torch.ops import cuda_probes as cp
    from godsp_tpu_torch.probes._common import lane_planes, planes_equal

    probe = torch.empty(1, device=dev)
    xr, xi = lane_planes(dev, B, N, seed=23)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    tables = {"gdsp_bd_tf32": cp.re_f128(dev),
              "gdsp_vdif": cp._vdif_packed(N // 128, VDIF_SCALE, dev)}
    bases = {"gdsp_bd_tf32": lambda: cp.bd_tf32(xr, xi),
             "gdsp_vdif": lambda: cp.vdif(xr, xi, VDIF_SCALE)}
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for j, (label, src, key, entry, edits) in enumerate(TUNE):
            lib, info, _ = _compile(variant_source(src, edits), tmp, f"tune_{j}", (key,))
            resident = None
            if entry == "gdsp_bd_tf32":
                occupancy = lib.gdsp_bd_tf32_resident
                occupancy.argtypes, occupancy.restype = [ctypes.c_int], ctypes.c_int
                resident = occupancy(0)
            op = _entry(lib, entry, (tables[entry],), () if resident is None else (resident,))
            base = bases[entry]
            if not planes_equal(op(xr, xi, yr, yi), base()):
                raise AssertionError(f"{label}: not equal to the redesign")
            regs, spill = info[key]
            run = lambda op=op: op(xr, xi, yr, yi)  # noqa: E731
            rows.append((label, _chain_ms(base, probe), _chain_ms(run, probe),
                         _chain_ms(base, probe), f"{resident} resident; {regs} registers; {spill}"))
    for label, before, ms, after, regs in rows:
        print(f"tune {label}: {ms:.4f} ms by chain (the redesign as it is {before:.4f} / "
              f"{after:.4f}); {regs}", flush=True)


def main(argv: list[str] | None = None) -> int:
    from godsp_tpu_torch import set_default_device
    from godsp_tpu_torch.probes._common import card

    argv = sys.argv[1:] if argv is None else argv
    parts = [a.lstrip("-") for a in argv] or ["ptxas", "sass", "times", "variants", "tune"]
    if not torch.cuda.is_available():
        raise SystemExit("bd1_vdif: needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    print(f"nvidia-smi: {card()}", flush=True)
    set_default_device("cuda")
    dev = torch.device("cuda", 0)
    for part in parts:
        {"ptxas": ptxas, "sass": sass, "times": lambda: times(dev),
         "variants": lambda: variants(dev), "tune": lambda: tune(dev)}[part]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
