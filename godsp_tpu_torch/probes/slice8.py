"""K14d's slice8_add on one GPU: why its first design trails the reshape
map that runs the same body: store width, blocks a SM and bytes in flight.

    python3 -m godsp_tpu_torch.probes.slice8

Builds csrc/anatomy_probe_kernels.cu as it is and copies of it whose first
design (add_one_kernel<false>, slice8_add_sync) is changed (VARIANTS: its
unrolled loop storing by st.global.v4 (inline PTX); the loop not
unrolled, one slice's load, add and store at a time, also with 36 KB of
dynamic shared memory a block so that a SM holds the first design's 6
blocks; four slices' loads issued before their stores, twice), each with
`-Xptxas -v` and as a cubin.  For each kernel it reads the registers a
thread (ptxas), hence the 256-thread blocks a SM, and from its SASS
(cuobjdump) the slice loop's global loads and stores with their bytes a
thread, and branches, in issue order (sass_order), and the 16-byte loads a
thread has issued before its first store.  Their product, 512 B a warp a
load, is the bytes of loads a SM has in flight when every warp waits at a
store.  Each variant is held
bit for bit to add_one_plain, then every row is timed at 16384 x 1024 by
chain (utils.metrics.time_chain_diff), the first design first and last,
beside slice8_add (the redesign: every slice's loads first), reshape_add,
K12's copy and torch.add a plane.  The first design's listing goes to the
package's git-ignored _build/slice8_sass.txt.

Prints the card's name and power limit first.  Needs a CUDA device;
imports nothing of JAX.  The checks and the redesign line of the smoke
are chip_smoke.py's phase 3 (phase_halo_slice8_redesign).
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import tempfile

import torch

from godsp_tpu_torch.probes.floor_dot import _chain_ms, _nvcc

__all__ = ["B", "N", "VARIANTS", "in_flight", "main", "sass_order", "variant_source"]

B, N = 16384, 1024  # the anatomy probe's planes

_LOOP = ("      for (int s = 0; s < slices; ++s)\n"
         "        add_one4(xr, xi, yr, yi, static_cast<size_t>(row) * n + c0 + s * kLanes + 4 * "
         "lane);\n")
_FOUR_AHEAD = (
    "      const size_t at = static_cast<size_t>(row) * n + c0 + 4 * lane;\n"
    "      for (int s0 = 0; s0 < slices; s0 += 4) {\n"
    "        float4 va[4], vc[4];\n"
    "#pragma unroll\n"
    "        for (int s = 0; s < 4; ++s)\n"
    "          if (s0 + s < slices) {\n"
    "            va[s] = __ldg(reinterpret_cast<const float4*>(xr + at + (s0 + s) * kLanes));\n"
    "            vc[s] = __ldg(reinterpret_cast<const float4*>(xi + at + (s0 + s) * kLanes));\n"
    "          }\n"
    "#pragma unroll\n"
    "        for (int s = 0; s < 4; ++s)\n"
    "          if (s0 + s < slices) {\n"
    "            const float4 a = va[s], c = vc[s];\n"
    "            *reinterpret_cast<float4*>(yr + at + (s0 + s) * kLanes) =\n"
    "                make_float4(a.x + 1.f, a.y + 1.f, a.z + 1.f, a.w + 1.f);\n"
    "            *reinterpret_cast<float4*>(yi + at + (s0 + s) * kLanes) =\n"
    "                make_float4(c.x + 1.f, c.y + 1.f, c.z + 1.f, c.w + 1.f);\n"
    "          }\n"
    "      }\n")

_STORE16 = (
    "#pragma unroll 4\n"
    "      for (int s = 0; s < slices; ++s) {\n"
    "        const size_t off = static_cast<size_t>(row) * n + c0 + s * kLanes + 4 * lane;\n"
    "        const float4 a = __ldg(reinterpret_cast<const float4*>(xr + off));\n"
    "        const float4 c = __ldg(reinterpret_cast<const float4*>(xi + off));\n"
    "        asm volatile(\"st.global.v4.f32 [%0], {%1, %2, %3, %4};\" :: \"l\"(yr + off),\n"
    "                     \"f\"(a.x + 1.f), \"f\"(a.y + 1.f), \"f\"(a.z + 1.f), \"f\"(a.w + 1.f) "
    ": \"memory\");\n"
    "        asm volatile(\"st.global.v4.f32 [%0], {%1, %2, %3, %4};\" :: \"l\"(yi + off),\n"
    "                     \"f\"(c.x + 1.f), \"f\"(c.y + 1.f), \"f\"(c.z + 1.f), \"f\"(c.w + 1.f) "
    ": \"memory\");\n"
    "      }\n")
# The first design's launch; 36 KB of dynamic shared memory a block leaves
# room for 6 blocks a SM, the first design's count, whatever the registers.
_LAUNCH = ("                          kThreads, 0, static_cast<cudaStream_t>(stream)>>>(xr, xi, "
           "yr, yi, b, n);")
_SIX = _LAUNCH.replace("kThreads, 0,", "kThreads, 36 * 1024,")

# (name, edits of the source as (text, replacement)): the first design's
# slice loop or launch changed; each gives add_one_plain's result bit for bit.
VARIANTS = (
    ("16-byte stores", ((_LOOP, _STORE16),)),
    ("one slice at a time", ((_LOOP, "#pragma unroll 1\n" + _LOOP),)),
    ("one at a time, 6 a SM", ((_LOOP, "#pragma unroll 1\n" + _LOOP), (_LAUNCH, _SIX))),
    ("four slices ahead", ((_LOOP, _FOUR_AHEAD),)),
)

_SYNC = "14add_one_kernelILb0E"  # mangled-name parts: the first design
_REDESIGN = "13slice8_kernel"
_RESHAPE = "14add_one_kernelILb1E"


def _src() -> str:
    from godsp_tpu_torch.ops import _build

    return str(_build.CSRC / "anatomy_probe_kernels.cu")


def variant_source(edits) -> str:
    """csrc/anatomy_probe_kernels.cu with each (text, replacement) of edits
    made; each text must be there once."""
    with open(_src()) as fh:
        s = fh.read()
    for text, repl in edits:
        if s.count(text) != 1:
            raise LookupError(f"variant_source: {text[:40]!r} is not in the source once")
        s = s.replace(text, repl)
    return s


def sass_order(body: str) -> tuple[str, int]:
    """The global loads (LDG), stores (STG), each tagged with its bytes a
    thread (16 or 4), and branches (BRA) of the innermost backward-branching
    loop of a cuobjdump listing that holds a global load, in issue order,
    and the loads before its first store (of the whole body where no loop
    holds a load)."""
    ins = [(int(a, 16), t.strip()) for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", body)]
    best = [t for _, t in ins]
    for addr, txt in ins:
        m = re.search(r"BRA\s+(?:!?U?P\w+,\s*)?(0x[0-9a-f]+)", txt)
        if m and int(m.group(1), 16) < addr:
            loop = [t for a, t in ins if int(m.group(1), 16) <= a <= addr]
            if any("LDG" in t for t in loop) and len(loop) < len(best):
                best = loop
    ops = [re.sub(r"^@!?U?P\w+\s+", "", t).split()[0] for t in best]
    seq = [op.split(".")[0] + ("16" if ".128" in op else "4" if op[:3] in ("LDG", "STG") else "")
           for op in ops if op.startswith(("LDG", "STG", "BRA"))]
    stores = [i for i, op in enumerate(seq) if op.startswith("STG")]
    return " ".join(seq), sum(op.startswith("LDG") for op in seq[:stores[0] if stores else None])


def in_flight(regs: int, loads: int, smem: int = 0) -> tuple[int, int]:
    """(256-thread blocks a SM, bytes of loads in flight a SM) for a kernel
    of `regs` registers a thread (allocated in eights) and `smem` bytes of
    shared memory a block whose threads each issue `loads` 16-byte loads
    before they wait: at most 8 blocks (2048 threads) in 65,536 registers
    and 233,472 bytes of shared memory (1 KB a block reserved), 512 B a
    warp a load."""
    blocks = min(8, 65536 // (-(-regs // 8) * 8 * 256), 233472 // (smem + 1024))
    return blocks, blocks * 8 * loads * 512


def _function(dump: str, key: str) -> str:
    body = dump[dump.index(key):]
    return body[:body.index("Function :")] if "Function :" in body else body


def build(source: str, tmp: str, name: str, keys: tuple[str, ...]):
    """source compiled into a shared library (loaded) and a cubin: the
    library and, for each mangled-name part in keys, (registers a thread,
    SASS listing)."""
    from godsp_tpu_torch.ops import _build

    src, so, cubin = (os.path.join(tmp, f"{name}{ext}") for ext in (".cu", ".so", ".cubin"))
    with open(src, "w") as fh:
        fh.write(source)
    res = _nvcc(["-shared", "-Xptxas", "-v", src, "-o", so])
    if res.returncode != 0 or _nvcc(["-cubin", src, "-o", cubin]).returncode != 0:
        raise RuntimeError(f"nvcc {name}: {res.stderr[-4000:]}")
    dump = subprocess.run([os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"), "-sass",
                           cubin], capture_output=True, text=True, check=True).stdout
    lines = res.stderr.splitlines()
    out = {}
    for key in keys:
        regs = next(int(m.group(1)) for i, line in enumerate(lines[:-2])
                    if "Function properties for" in line and key in line
                    for m in [re.search(r"Used (\d+) registers", lines[i + 2])] if m)
        out[key] = (regs, _function(dump, key))
    return ctypes.CDLL(so), out


def main(argv: list[str] | None = None) -> int:
    from godsp_tpu_torch import set_default_device
    from godsp_tpu_torch.ops import _build, cuda_metrics
    from godsp_tpu_torch.ops import cuda_probes as cp
    from godsp_tpu_torch.probes._common import card, lane_planes

    if not torch.cuda.is_available():
        raise SystemExit("slice8: needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    print(f"nvidia-smi: {card()}", flush=True)
    set_default_device("cuda")
    dev = torch.device("cuda", 0)
    xr, xi = lane_planes(dev, B, N, seed=21)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    want = cp.add_one_plain(xr, xi)
    probe = torch.empty(1, device=dev)
    p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    rows = []  # (label, registers, SASS listing or None, op)
    with tempfile.TemporaryDirectory() as tmp:
        with open(_src()) as fh:
            _, built = build(fh.read(), tmp, "as_built", (_SYNC, _REDESIGN, _RESHAPE))
        listing = str(_build.BUILD_DIR / "slice8_sass.txt")
        os.makedirs(os.path.dirname(listing), exist_ok=True)
        with open(listing, "w") as fh:
            fh.write(built[_SYNC][1])
        print(f"the first design's SASS in {listing}", flush=True)
        first = lambda: cp.slice8_add_sync(xr, xi)  # noqa: E731
        rows.append(("first design", *built[_SYNC], first))
        for j, (name, edits) in enumerate(VARIANTS):
            lib, info = build(variant_source(edits), tmp, f"slice8_{j}", (_SYNC,))
            lib.gdsp_slice8_add_sync.argtypes = [p, p, p, p, i64, i, p]

            def run(lib=lib, name=name):
                rc = lib.gdsp_slice8_add_sync(xr.data_ptr(), xi.data_ptr(), yr.data_ptr(),
                                              yi.data_ptr(), B, N,
                                              torch.cuda.current_stream(dev).cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"slice8 variant {name}: CUDA error {rc}")
                return yr, yi

            got = run()
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"slice8 variant {name}: not equal to add_one_plain")
            rows.append((name, *info[_SYNC], run))
        rows.append(("redesign (slice8_add)", *built[_REDESIGN], lambda: cp.slice8_add(xr, xi)))
        rows += [("reshape_add", *built[_RESHAPE], lambda: cp.reshape_add(xr, xi)),
                 ("K12 copy", None, None, lambda: cuda_metrics.copy_split(xr, xi)),
                 ("torch.add", None, None,
                  lambda: (torch.add(xr, 1.0, out=yr), torch.add(xi, 1.0, out=yi)))]
        times = [_chain_ms(op, probe) for *_, op in rows] + [_chain_ms(first, probe)]
    print(f"slice8 at {B} x {N} by chain (the first design first and last: "
          f"{times[0]:.4f} / {times[-1]:.4f} ms):", flush=True)
    for (label, regs, sass, _), ms in zip(rows, times):
        if sass is None:
            print(f"  {label:22s} {ms:.4f} ms", flush=True)
            continue
        seq, loads = sass_order(sass)
        blocks, nbytes = in_flight(regs, loads, 36 * 1024 if "6 a SM" in label else 0)
        print(f"  {label:22s} {ms:.4f} ms  {regs} registers, {blocks} blocks a SM, {loads} loads "
              f"a thread before its first store, {nbytes} B of loads in flight a SM; loop: {seq}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
