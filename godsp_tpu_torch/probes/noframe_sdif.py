"""K14a's pwfloor_noframe and K14i's sdif_peel as redesigned for Hopper, on
one GPU: their first designs and redesigns read from ptxas and SASS, their
times beside the first designs, the routes they compete with, K12's copy
and the bound, and copies of the sources that split the first designs'
time or price a part of the redesigns.

    python3 -m godsp_tpu_torch.probes.noframe_sdif [--ptxas] [--sass] [--times] [--variants]

--ptxas compiles csrc/pwelch_probe_kernels.cu and csrc/dif_probe_kernels.cu
with `-Xptxas -v` and prints the registers, stack frame, spill stores and
loads and blocks a SM (from the registers, threads and shared memory) of
noframe_partials_kernel<9> (pad 1024), spectral_twin_kernel<false> (the
first design, pwfloor_noframe_radix2), sdif_peel_kernel and
sdif_peel_sync_kernel.

--sass reads both sources' SASS (cuobjdump; the first designs' listings in
the package's git-ignored _build/pwfloor_noframe_radix2_sass.txt and
sdif_peel_sync_sass.txt) and prints for each kernel the counts by opcode
(LDG, LDS, STS, BAR, SHFL, FFMA, ...) of the loop holding its marker opcode
(anat_staged.loop_counts), scaled to its unit: for
spectral_twin_kernel<false> a radix-2 stage (one BAR) and the segment loop
around the stages, a pass a segment; for noframe_partials_kernel<9> the
frame loop, a pass a segment a warp; for sdif_peel_kernel the whole
listing (it has no loop), a warp's instructions for its eighth of a 128 x
32 tile; for sdif_peel_sync_kernel the loop holding its stage barrier (one
BAR a stage, seven a tile) and the whole listing as compiled.

--times times, by chain (utils.metrics.time_chain_diff) and alone (the
profiler's events of the kernel), in turns (redesign, first design, first
design, redesign): pwfloor_noframe beside pwfloor_noframe_radix2, K4
(cuda_pwelch.pwelch_power_partials) on the samples the frames were cut
from at the same tiles, K4 on the frames flattened (nfft = hop = pad: the
same function), pwfloor_staged on the frames flattened (each tile's frames
brought by one 1-D TMA copy: the other load) and K12's copy of the frames'
bytes, at the probe geometry (16384 frames of 1024, hop 512) and at the
52,428 frames of hop 160, cut on the card by unfold (215 MB); sdif_peel
beside sdif_peel_sync, K8 (cuda_outer.outer_dft_split(x, 128, 1)) on the
same planes and K12's copy, at (1, 128, 131072) and at 16 x (128, 8192).
Each with its bound, its dB against float64 and, for pwfloor_noframe,
whether it equals K4 on the flattened frames.

--variants builds copies of the two sources (VARIANTS) and prints each
copy's registers and time by chain beside the kernel it changes as it is
(the noframe copies at both of --times' geometries, the sdif copies at
(1, 128, 131072)): pwfloor_noframe_radix2 with its frames loaded and
summed, no transform, and with the transform of frames made in registers,
no load; sdif_peel_sync with its tile loaded and stored only, with the
stages but no Tb, and with Tb but no stages; then the redesigns priced:
pwfloor_noframe with 8-byte pair loads in place of 16-byte loads of two
pairs and a shuffle (kNoframeVec), and sdif_peel with Tb gathered a point
from K8's hi and lo tables (the first design's Tb) in place of a row's
W_N^{k c0} times the tile table.  The copies that drop
work give another result on purpose; the two pricing copies are checked
bit for bit: the 8-byte loads against the redesign, the gathered Tb
against the first design (the stages are the first design's operations).

All by default.  Prints the card's name and power limit first.  Needs a
CUDA device; imports nothing of JAX.  The checks and the redesign lines of
the smoke are chip_smoke.py's phase_noframe_sdif_redesign.
"""

from __future__ import annotations

import ctypes
import sys
import tempfile

import torch

from godsp_tpu_torch.probes.anat_staged import HOP160_SEGS, loop_counts, pwelch_inputs
from godsp_tpu_torch.probes.bd1_vdif import blocks_per_sm
from godsp_tpu_torch.probes.bd_hi import _compile, _function, variant_source
from godsp_tpu_torch.probes.floor_dot import _chain_ms, _fmt, kernel_alone_ms
from godsp_tpu_torch.probes.pwfloor import _copy_planes

__all__ = ["NFFT", "SDIF_SHAPES", "VARIANTS", "main", "noframe_inputs"]

NFFT = 1024  # the noframe probe's frames: nfft = pad = 1024
SDIF_SHAPES = ((1, 128, 1 << 17), (16, 128, 8192))  # 2^24 points each

_P = "pwelch_probe_kernels.cu"
_D = "dif_probe_kernels.cu"
# (label, source, mangled-name part, threads a block, shared bytes at the
# probe's shapes: noframe's eight 512-point slots (K4's); the first design's
# pad-point buffer and its sums; sdif's 128 x 32 tile of both planes)
_KERNELS = (("noframe_partials_kernel<9>", _P, "23noframe_partials_kernelILi9E", 256, 8 * 512 * 8),
            ("spectral_twin_kernel<false>", _P, "20spectral_twin_kernelILb0E", 512,
             1024 * 8 + 513 * 4),
            ("sdif_peel_kernel", _D, "16sdif_peel_kernel", 256, 2 * 128 * 32 * 4),
            ("sdif_peel_sync_kernel", _D, "21sdif_peel_sync_kernel", 256, 2 * 128 * 32 * 4))

# What the SASS counts are per: (marker opcode, its count a unit, the unit,
# the outer loop too, the whole listing too).
_UNITS = {"23noframe_partials_kernelILi9E": ("FFMA", 0, "segment a warp", False, False),
          "20spectral_twin_kernelILb0E": ("BAR", 1, "radix-2 stage", True, False),
          "16sdif_peel_kernel": ("BAR", 0, "warp's eighth of a tile (no loop)", False, False),
          "21sdif_peel_sync_kernel": ("BAR", 1, "stage", False, True)}
_SASS_FILES = {"20spectral_twin_kernelILb0E": "pwfloor_noframe_radix2_sass.txt",
               "21sdif_peel_sync_kernel": "sdif_peel_sync_sass.txt"}
_SHOWN = ("LDG", "LDS", "STS", "LDL", "STL", "BAR", "SHFL", "STG", "FADD", "FFMA", "FMUL", "SEL",
          "FSEL", "LDGSTS", "SYNCS")

# spectral_twin_kernel<false>'s segment: its frame loaded, or transformed.
_NF_FFT = "    gdsp::block_fft_rows(s, 1, pad, log2pad, tw);\n"
_NF_LOAD = "        v = x[sg * pad + i] * w[i];\n"
_NF_REGS = "        v = static_cast<float>((i * 37 + static_cast<int>(sg)) & 1023) * 0.001f;\n"
# sdif_peel_sync_kernel's stages and its Tb.
_SD_STAGES = """  for (int s = 0; s < 7; ++s) {
    const int h = 64 >> s;
    for (int k = r0; k < kPeel / 2; k += kColStep) {
      const int i = (k / h) * 2 * h + k % h;  // the a row; its b row is i + h
      const float2 a = make_float2(sr[i][c], si[i][c]);
      const float2 v = make_float2(sr[i + h][c], si[i + h][c]);
      const float2 d = cmul(csub(a, v), __ldg(&cols[s * kPeel + i + h]));
      sr[i][c] = a.x + v.x;
      si[i][c] = a.y + v.y;
      sr[i + h][c] = d.x;
      si[i + h][c] = d.y;
    }
    __syncthreads();
  }
"""
_SD_TB = """    const float2 wh = __ldg(&hi[p >> lo_bits]);
    const float2 wl = __ldg(&lo[p & lo_mask]);
    const float2 y = cmul(make_float2(sr[r][c], si[r][c]), cmul(wh, wl));
"""
_SD_NO_TB = """    const float2 y = make_float2(sr[r][c], si[r][c]) ;
"""
# The redesigns' pricing edits.
_NF_VEC = ("constexpr int kNoframeVec = 16;", "constexpr int kNoframeVec = 8;")
_SD_GATHER = ("constexpr bool kSdifTileTable = true;", "constexpr bool kSdifTileTable = false;")

# (label, source, mangled-name part, C entry, edits, check): check None (the
# result differs on purpose), "equal" (bit for bit against the redesign) or
# "first" (bit for bit against the first design, sdif_peel_sync: the same
# stages and Tb).
VARIANTS = (
    ("pwfloor_noframe_radix2, frames loaded and summed, no transform", _P,
     "20spectral_twin_kernelILb0E", "gdsp_pwfloor_noframe_radix2", ((_NF_FFT, ""),), None),
    ("pwfloor_noframe_radix2, the transform of frames made in registers, no load", _P,
     "20spectral_twin_kernelILb0E", "gdsp_pwfloor_noframe_radix2", ((_NF_LOAD, _NF_REGS),),
     None),
    ("sdif_peel_sync, the tile loaded and stored only", _D, "21sdif_peel_sync_kernel",
     "gdsp_sdif_peel_sync", ((_SD_STAGES, ""), (_SD_TB, _SD_NO_TB)), None),
    ("sdif_peel_sync, the stages, no Tb", _D, "21sdif_peel_sync_kernel", "gdsp_sdif_peel_sync",
     ((_SD_TB, _SD_NO_TB),), None),
    ("sdif_peel_sync, Tb, no stages", _D, "21sdif_peel_sync_kernel", "gdsp_sdif_peel_sync",
     ((_SD_STAGES, ""),), None),
    ("pwfloor_noframe with 8-byte pair loads (no shuffle)", _P, "23noframe_partials_kernelILi9E",
     "gdsp_pwfloor_noframe", (_NF_VEC,), "equal"),
    ("sdif_peel with Tb gathered a point (the first design's Tb)", _D, "16sdif_peel_kernel",
     "gdsp_sdif_peel", (_SD_GATHER,), "first"),
)


def _source_path(src: str):
    from godsp_tpu_torch.ops import _build

    return _build.CSRC / src


def _compiled(tmp: str):
    for src in (_P, _D):
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
                opcode, per, unit, outer, whole = _UNITS[key]
                for which in (False, True) if outer else (False,):
                    units, counts = loop_counts(body, opcode, 0 if which else per, which)
                    what = "the loop around it, a pass" if which else f"a {unit}"
                    print(f"sass {label}: the {'outermost' if which else 'innermost'} loop "
                          f"holding {opcode} ({units:g} units); {what}: {_shown(counts)}; total "
                          f"{counts['total']:g}", flush=True)
                if whole:
                    units, counts = loop_counts(body, "NO_SUCH_OPCODE", 1)
                    print(f"sass {label}: the whole listing (a warp's static instructions): "
                          f"{_shown(counts)}; total {counts['total']:g}", flush=True)


def _db(got, want) -> float:
    from godsp_tpu_torch.dsputils import snr_db

    g = (got[0].double() + 1j * got[1].double()) if isinstance(got, tuple) else got.double()
    w = (want[0] + 1j * want[1]) if isinstance(want, tuple) else want
    return float(snr_db(g.cpu().numpy(), w.cpu().numpy()))


def _line(name, shape, dbs, bnd, chains, alone) -> None:
    print(f"{name} {shape} ({dbs}; bound {bnd[0]:.4f} ms, {bnd[1]}) by chain: " +
          "  ".join(f"{label} {ms:.4f} ms" for label, ms in chains) + "; alone: " +
          "  ".join(f"{label} {_fmt(ms)}" for label, ms in alone), flush=True)


def noframe_inputs(dev, hop: int, segs: int):
    """(ext, frames, mask, w): anat_staged.pwelch_inputs' samples at hop and
    the segs frames of NFFT cut from them on the card, contiguous."""
    ext, mask, w = pwelch_inputs(dev, hop, segs)
    return ext, ext.unfold(-1, NFFT, hop).contiguous(), mask, w


def times_noframe(dev) -> None:
    from godsp_tpu_torch.ops import cuda_metrics, cuda_pwelch
    from godsp_tpu_torch.ops import cuda_probes as cp
    from godsp_tpu_torch.utils.metrics import bound_ms, rfft_flops

    for hop, segs in ((512, 16384), (160, HOP160_SEGS)):
        ext, frames, mask, w = noframe_inputs(dev, hop, segs)
        flat = frames.view(-1)
        probe = torch.empty(1, device=dev)
        bt = cuda_pwelch.segs_per_tile(segs, 1)
        fr, fi = _copy_planes(frames)
        new = lambda: cp.pwfloor_noframe(frames, mask, w)  # noqa: E731
        first = lambda: cp.pwfloor_noframe_radix2(frames, mask, w)  # noqa: E731
        k4 = lambda: cuda_pwelch.pwelch_power_partials(ext, mask, w, NFFT, hop)  # noqa: E731
        k4f = lambda: cuda_pwelch.pwelch_power_partials(flat, mask, w, NFFT, NFFT)  # noqa: E731
        staged = lambda: cp.pwfloor_staged(flat, mask, w, NFFT, NFFT)  # noqa: E731
        copy = lambda: cuda_metrics.copy_split(fr, fi)  # noqa: E731
        want = cp.pwfloor_noframe_plain(frames.double(), mask.double(), w.double(), bt)
        st_bt = cp.staged_segs_per_tile(segs, 1, NFFT, NFFT, NFFT)
        dbs = (f"{_db(new(), want):.2f} dB, first design {_db(first(), want):.2f}; equal to K4 "
               f"on the flattened frames: {torch.equal(new(), k4f())}; tiles of {bt}, the TMA "
               f"route's {st_bt}")
        tiles = -(-segs // bt)
        bnd = bound_ms(4.0 * (frames.numel() + segs + NFFT + tiles * (NFFT // 2 + 1)),
                       segs * (NFFT + rfft_flops(NFFT) + 3.0 * (NFFT // 2 + 1)))
        chains = [(label, _chain_ms(op, probe)) for label, op in (
            ("noframe", new), ("first design", first), ("first design", first), ("noframe", new),
            ("K4 on the samples", k4), ("K4 on the flattened frames", k4f),
            ("TMA route (pwfloor_staged, flattened)", staged), ("K12 copy of the frames", copy))]
        alone = [("noframe", kernel_alone_ms("noframe_partials_kernel", new, 20)),
                 ("first design", kernel_alone_ms("spectral_twin_kernel", first, 20)),
                 ("K4 on the samples", kernel_alone_ms("pwelch_partials_kernel", k4, 20)),
                 ("K4 on the flattened frames", kernel_alone_ms("pwelch_partials_kernel", k4f, 20)),
                 ("TMA route", kernel_alone_ms("staged_partials_kernel", staged, 20))]
        _line("pwfloor_noframe", f"{segs} frames of {NFFT} (hop {hop} segments)", dbs, bnd, chains,
              alone)
        del ext, frames, flat, want, fr, fi


def times_sdif(dev) -> None:
    from godsp_tpu_torch.ops import cuda_metrics, cuda_outer
    from godsp_tpu_torch.ops import cuda_probes as cp
    from godsp_tpu_torch.probes._common import lane_planes
    from godsp_tpu_torch.utils.metrics import bound_ms

    for shape in SDIF_SHAPES:
        xr, xi = (p.view(shape) for p in lane_planes(dev, shape[0] * shape[1], shape[2], seed=25))
        probe = torch.empty(1, device=dev)
        pts = float(xr.numel())
        new = lambda: cp.sdif_peel(xr, xi)  # noqa: E731
        first = lambda: cp.sdif_peel_sync(xr, xi)  # noqa: E731
        k8 = lambda: cuda_outer.outer_dft_split(xr, xi, 128, 1)  # noqa: E731
        vr, vi = xr.view(-1, 8192), xi.view(-1, 8192)
        copy = lambda: cuda_metrics.copy_split(vr, vi)  # noqa: E731
        want = cp.sdif_peel_plain(xr.double(), xi.double())
        dbs = f"{_db(new(), want):.2f} dB, first design {_db(first(), want):.2f}"
        bnd = bound_ms(16.0 * pts, 41.0 * pts)
        chains = [(label, _chain_ms(op, probe)) for label, op in (
            ("sdif_peel", new), ("first design", first), ("first design", first),
            ("sdif_peel", new), ("K8 outer_dft_split(x, 128, 1)", k8), ("K12 copy", copy))]
        alone = [("sdif_peel", kernel_alone_ms("sdif_peel_kernel", new, 20)),
                 ("first design", kernel_alone_ms("sdif_peel_sync_kernel", first, 20)),
                 ("K8", kernel_alone_ms("outer_dft_kernel", k8, 20)),
                 ("K12 copy", kernel_alone_ms("copy_split_kernel", copy, 20))]
        _line("sdif_peel", " x ".join(map(str, shape)), dbs, bnd, chains, alone)
        del xr, xi, want


def _noframe_entry(lib, entry: str, frames, mask, w, bt: int):
    from godsp_tpu_torch.ops import cuda_probes as cp

    p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn = getattr(lib, entry)
    fn.argtypes = [p, p, p, p, p, i64, i64, i, i, i, p]
    fn.restype = i
    S = mask.shape[-1]
    out = torch.empty(-(-S // bt), NFFT // 2 + 1, device=frames.device)
    table = (cp.rfft_table(NFFT, frames.device) if entry == "gdsp_pwfloor_noframe"
             else cp.twiddle_table(NFFT, False, frames.device))

    def run():
        rc = fn(frames.data_ptr(), mask.data_ptr(), w.data_ptr(), out.data_ptr(),
                table.data_ptr(), 1, S, NFFT.bit_length() - 1, bt, -(-S // bt),
                torch.cuda.current_stream(frames.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{entry}: CUDA error {rc}")
        return out
    return run


def _sdif_entry(lib, entry: str, xr, xi):
    from godsp_tpu_torch.ops import cuda_outer
    from godsp_tpu_torch.ops import cuda_probes as cp

    p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn = getattr(lib, entry)
    m = xr.shape[-1]
    tables = cp._sdif_launch_tables(m, xr.device, entry == "gdsp_sdif_peel")
    fn.argtypes = [p] * (4 + len(tables)) + [i64, i64, i, p]
    fn.restype = i
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    lo_bits = cuda_outer.lo_bits_of(128 * m)

    def run():
        rc = fn(xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                *(t.data_ptr() for t in tables), m, xr.numel() // (128 * m), lo_bits,
                torch.cuda.current_stream(xr.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{entry}: CUDA error {rc}")
        return yr, yi
    return run


def variants(dev) -> None:
    """Each VARIANTS copy against the kernel it changes, by chain: the noframe
    copies at the probe geometry and at hop 160's 52,428 frames, the sdif
    copies at (1, 128, 131072)."""
    from godsp_tpu_torch.ops import cuda_pwelch
    from godsp_tpu_torch.ops import cuda_probes as cp
    from godsp_tpu_torch.probes._common import lane_planes, planes_equal

    probe = torch.empty(1, device=dev)
    noframe = []
    for hop, segs in ((512, 16384), (160, HOP160_SEGS)):
        _, frames, mask, w = noframe_inputs(dev, hop, segs)
        noframe.append((f"{segs} frames", frames, mask, w, cuda_pwelch.segs_per_tile(segs, 1)))
    shape = SDIF_SHAPES[0]
    xr, xi = (p.view(shape) for p in lane_planes(dev, shape[0] * shape[1], shape[2], seed=25))
    want = cp.sdif_peel_plain(xr.double(), xi.double())
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for j, (label, src, key, entry, edits, check) in enumerate(VARIANTS):
            try:
                source = variant_source(src, edits)
            except LookupError as e:  # a redesign's edit on a tree without it
                print(f"variant {label}: not built ({e})", flush=True)
                continue
            lib, info, _ = _compile(source, tmp, f"variant_{j}", (key,))
            regs, spill = info[key]
            if src == _P:
                cases = [(f"{label}, {at}", _noframe_entry(lib, entry, f, m, w, bt), (f, m, w))
                         for at, f, m, w, bt in noframe]
            else:
                cases = [(label, _sdif_entry(lib, entry, xr, xi), (xr, xi))]
            wrapper = getattr(cp, entry[len("gdsp_"):])  # the kernel as it is
            for text, run, args in cases:
                base = lambda args=args: wrapper(*args)  # noqa: E731
                got = run()
                torch.cuda.synchronize()
                note = "another result, on purpose"
                if check == "equal":
                    same = torch.equal(got, base()) if src == _P else planes_equal(got, base())
                    if not same:
                        raise AssertionError(f"{text}: not equal to the redesign")
                    note = "equal to the redesign"
                elif check == "first":
                    if not planes_equal(got, cp.sdif_peel_sync(*args)):
                        raise AssertionError(f"{text}: not equal to the first design")
                    note = (f"equal to the first design, {_db(got, want):.2f} dB against float64 "
                            f"(the redesign {_db(base(), want):.2f})")
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
        raise SystemExit("noframe_sdif: needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    print(f"nvidia-smi: {card()}", flush=True)
    set_default_device("cuda")
    dev = torch.device("cuda", 0)
    for part in parts:
        {"ptxas": ptxas, "sass": sass,
         "times": lambda: (times_noframe(dev), times_sdif(dev)),
         "variants": lambda: variants(dev)}[part]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
