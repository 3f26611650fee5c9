"""The port's benchmark: batched FFT roofline, the giant FFTs and the
spectral cells, on the card.

    python3 -m godsp_tpu_torch.bench

Counterpart of the repo's bench.py (which measures godsp_tpu on a TPU),
with its sections under the same names, `pallas_` dropped.  Every cell
records the median of its reps (`wall_s`, with `wall_s_reps`), its GB/s
and `roofline_fraction` against hbm_bandwidth_gbs() where it has a
traffic model, and `snr_db` against a float64 oracle on the same card;
where one PyTorch call computes the same function, that call's time in
the same session (`library_wall_s`).  The flagship cell, fft1024_precise
(K1 at 1024 x 16384), co-measures in each rep K12 at the same planes
(copy_ceiling_gbs, fraction_of_copy_ceiling) and K13
(fraction_of_gmm_floor).  fft_2pow20_fused and fft_2pow24_fused time the
same transforms on the same inputs as fft_2pow20 and fft_2pow24 with the
large plan's fused peel + rows route (K9) on; the torch.fft and copy
chains they report are the unfused cells' own (measured once).

Timing (utils.metrics.time_chain_diff): each cell's op runs in two chains
of k_lo and k_hi launches between CUDA events; the difference over
k_hi - k_lo is the per-application time of a steady stream of launches,
free of the first launch's latency and the events' own cost.

Not ported: c64_conversion_roundtrip and public_pack_reconciliation,
which measure the TPU's split-plane transfer workaround (not ported), and
the phase-1 AOT compile pool (nothing here compiles ahead).

Output: diagnostics on stderr.  After every section stdout gets the full
detail as one JSON line ({"detail": ...}) and then the summary: one JSON
line of at most SUMMARY_MAX_CHARS characters, {"metric":
"fft1024_precise_roofline_fraction", "value", "unit", "vs_baseline",
"device", "cells": {name: {"ms", "db", ...}}}.  The last line wins.

GODSP_BENCH_BUDGET_S (default 600) bounds the measurement: past it the
optional sections (rep sweeps, the host-fed stream, 2^28) are shed and
named in "shed_sections".  A section that raises is named in
"failed_sections", the others run on, and the module then exits 1.
Inputs are made on the device from a torch.Generator seeded with 0.  main(device="cpu", scale=...) runs every
cell through the plain versions at a cut size (for tests); its numbers
are CPU numbers, never the card's.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

import torch

from godsp_tpu_torch import fft, models, parallel, spectral, window
from godsp_tpu_torch._dtypes import resolve_device
from godsp_tpu_torch.fft import large
from godsp_tpu_torch.ops import cuda_fft, cuda_pwelch
from godsp_tpu_torch.ops.cuda_metrics import gmm_floor_plain
from godsp_tpu_torch.parallel._pwelch_sharded_impl import sharded_partial_step
from godsp_tpu_torch.utils.metrics import (
    copy_split,
    fft_bytes,
    fft_flops,
    gmm_floor,
    hbm_bandwidth_gbs,
    measure_rtt,
    time_chain_diff,
)

__all__ = ["CORE", "SECTIONS", "SUMMARY_MAX_CHARS", "main", "run", "summary_line"]

BUDGET_S = float(os.environ.get("GODSP_BENCH_BUDGET_S", "600"))
SUMMARY_MAX_CHARS = 1800
FLAGSHIP = "fft1024_precise"
TARGET = 0.80  # BASELINE.json: >= 80 % of the device-memory roofline
GMM_NOTE = ("gmm_floor is K13: the twiddled 128-point DFT of every lane slice as a dense "
            "contraction, the TPU's dense-DFT design of one K1 step; K1 on this card is "
            "register-radix Stockham passes, so fraction_of_gmm_floor reads what that design "
            "would cost here beside K1's")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def fused_route(fn):
    """fn run with the large plan's fused peel + rows route on (K9,
    fft.large.set_fuse_rows_enabled), the switch restored after each call."""
    def run(*a, **k):
        was = large._fuse_rows_on
        large.set_fuse_rows_enabled(True)
        try:
            return fn(*a, **k)
        finally:
            large.set_fuse_rows_enabled(was)

    return run


def med(xs):
    """Median of recorded reps (the uniform aggregation of this bench)."""
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def snr_db(got: torch.Tensor, want: torch.Tensor) -> float:
    """dsputils.snr_db on the device, in float64."""
    g, w = got.to(torch.complex128), want.to(torch.complex128)
    sig = float((w.real ** 2 + w.imag ** 2).sum())
    err = float(((g - w).real ** 2 + (g - w).imag ** 2).sum())
    return float("inf") if err == 0.0 else 10.0 * math.log10(sig / err)


def _pow2(v: float, lo: int) -> int:
    return max(lo, 1 << int(math.floor(math.log2(max(v, 1.0)))))


def _c128(planes) -> torch.Tensor:
    return torch.complex(planes[0].double(), planes[1].double())


class Bench:
    """One session's inputs, chains, reps and results."""

    def __init__(self, device=None, scale: float = 1.0):
        self.dev = resolve_device(device)
        self.scale = float(scale)
        self.peak = hbm_bandwidth_gbs(self.dev)
        self.kind = (torch.cuda.get_device_name(self.dev) if self.dev.type == "cuda"
                     else "cpu")
        self.gen = torch.Generator(device=self.dev).manual_seed(0)
        self.results: dict = {}
        self.reps: dict[str, list[float]] = {}  # chain -> per-application seconds
        self.chains: dict[str, tuple] = {}  # chain -> (op, k_lo, k_hi, iters)
        self.sections: dict[str, tuple] = {}  # cell -> (chains, builder)
        self.giants: dict[int, tuple] = {}  # log2 n -> (input, tones, k_lo, k_hi)
        self.t0 = time.perf_counter()
        self._probe = torch.zeros(1, device=self.dev)
        self.b_f = self.rows(16384)
        self.n_f = 1024

    # ---- sizes and inputs ----------------------------------------------

    def rows(self, b: int) -> int:
        return _pow2(b * self.scale, 8)

    def points(self, n: int) -> int:
        return _pow2(n * self.scale, 1 << 12)

    def randn(self, *shape, sigma: float = 0.01) -> torch.Tensor:
        return torch.randn(*shape, generator=self.gen, device=self.dev) * sigma

    # ---- timing ---------------------------------------------------------

    def chain(self, name: str, op, k_lo: int, k_hi: int, iters: int = 8) -> None:
        self.chains[name] = (op, k_lo, k_hi, iters)

    def measure(self, name: str) -> float:
        op, k_lo, k_hi, iters = self.chains[name]

        def make(k):
            def run(_):
                for _ in range(k):
                    op()

            return run

        per = time_chain_diff(make, self._probe, k_lo=k_lo, k_hi=k_hi, iters=iters)
        self.reps.setdefault(name, []).append(per)
        return per

    def rebuild(self, key: str) -> dict:
        chains, build = self.sections[key]
        d = build({c: med(self.reps[c]) for c in chains})
        d.setdefault("wall_s_reps", list(self.reps[chains[0]]))
        self.results[key] = d
        return d

    def sec(self, key: str, chains: list[str], build, shared=()) -> dict:
        """Measure the cell's chains once and build it.  A chain in `shared`
        (a yardstick over an input two cells share) is measured only by
        the first cell that lists it."""
        for c in chains:
            if c not in shared or c not in self.reps:
                self.measure(c)
        self.sections[key] = (chains, build)
        return self.rebuild(key)

    def sweep(self, label: str) -> None:
        t0 = time.perf_counter()
        for c in list(self.reps):
            if c in self.chains:
                self.measure(c)
        for key in self.sections:
            self.rebuild(key)
        log(f"  rep sweep {label}: {time.perf_counter() - t0:.1f} s")

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def shed(self, section: str, scale: float = 1.0) -> bool:
        """True (and logged + recorded) if the section should be skipped."""
        if self.elapsed() > BUDGET_S * scale:
            log(f"BUDGET: shedding '{section}' at t={self.elapsed():.0f}s "
                f"(budget {BUDGET_S:.0f}s x {scale})")
            self.results.setdefault("shed_sections", []).append(section)
            return True
        return False

    def roofline(self, nbytes: float, per: float) -> dict:
        gbs = nbytes / per / 1e9
        return {"gbs": gbs, "roofline_fraction": gbs / self.peak if self.peak else None}

    # ---- FFT cells ------------------------------------------------------

    def fft_snr(self, xr: torch.Tensor, xi: torch.Tensor, rows: int) -> float:
        """K1 on the first rows vs torch.fft in complex128 on the same card."""
        got = _c128(cuda_fft.fft_pow2(xr[:rows].contiguous(), xi[:rows].contiguous()))
        return snr_db(got, torch.fft.fft(_c128((xr[:rows], xi[:rows]))))

    def flagship_inputs(self):
        if not hasattr(self, "xr_f"):
            self.xr_f = self.randn(self.b_f, self.n_f)
            self.xi_f = self.randn(self.b_f, self.n_f)
            xr, xi, bt = self.xr_f, self.xi_f, min(256, self.b_f)
            self.chain("flagship", lambda: cuda_fft.fft_pow2(xr, xi), 10, 26)
            self.chain("copy", lambda: copy_split(xr, xi, batch_tile=bt), 10, 50, iters=12)
            self.chain("gmm_floor", lambda: gmm_floor(xr, xi, batch_tile=bt), 10, 50, iters=12)
        return self.xr_f, self.xi_f

    def flagship_rep(self, label: str) -> None:
        """One rep of K1 with K12 and K13 at the same planes, back to back."""
        xr, xi = self.flagship_inputs()
        per, per_copy, per_gmm = (self.measure(c) for c in ("flagship", "copy", "gmm_floor"))
        fl, cp, gm = self.reps["flagship"], self.reps["copy"], self.reps["gmm_floor"]
        moved = 16.0 * self.b_f * self.n_f  # two float32 planes read, two written
        if FLAGSHIP not in self.results:
            rows = min(64, self.b_f)
            yr, yi = gmm_floor(xr[:rows].contiguous(), xi[:rows].contiguous(), batch_tile=rows)
            want = _c128(gmm_floor_plain(xr[:rows].double(), xi[:rows].double()))
            cr, ci = copy_split(xr, xi, batch_tile=min(256, self.b_f))
            self.results[FLAGSHIP] = {
                "snr_db": self.fft_snr(xr, xi, rows),
                "gmm_floor_snr_db": snr_db(_c128((yr, yi)), want),
                "copy_equal": bool(torch.equal(cr, xr) and torch.equal(ci, xi)),
                "gmm_floor_note": GMM_NOTE,
            }
        d = self.results[FLAGSHIP]
        d.update({
            "wall_s": med(fl), "wall_s_reps": list(fl), "wall_s_best": min(fl),
            **self.roofline(moved, med(fl)),
            "copy_ceiling_wall_s_reps": list(cp),
            "copy_ceiling_gbs": moved / med(cp) / 1e9,
            "fraction_of_copy_ceiling": med([c / f for f, c in zip(fl, cp)]),
            "gmm_floor_wall_s_reps": list(gm),
            "fraction_of_gmm_floor": med([g / f for f, g in zip(fl, gm)]),
        })
        log(f"  flagship rep ({label}): {per * 1e3:.4f} ms, copy {per_copy * 1e3:.4f} ms "
            f"(ratio {per_copy / per:.3f}), gmm floor {per_gmm * 1e3:.4f} ms "
            f"({per_gmm / per:.3f})")

    def s_flagship(self) -> None:
        self.flagship_rep("start")
        d = self.results[FLAGSHIP]
        log(f"fft n=1024 b={self.b_f}: {d['wall_s'] * 1e3:.4f} ms {d['gbs']:.0f} GB/s "
            f"roofline={d['roofline_fraction']} copy_ceiling={d['copy_ceiling_gbs']:.0f} GB/s "
            f"of_ceiling={d['fraction_of_copy_ceiling']:.3f} "
            f"of_gmm_floor={d['fraction_of_gmm_floor']:.3f} snr={d['snr_db']:.1f} dB "
            f"(K13 {d['gmm_floor_snr_db']:.1f} dB, K12 equal {d['copy_equal']})")

    def s_sizes(self) -> None:
        for n, batch in ((4096, 4096), (8192, 2048), (16384, 1024)):
            b = self.rows(batch)
            xr, xi = self.randn(b, n), self.randn(b, n)
            z = torch.complex(xr, xi)
            self.chain(f"fft{n}", lambda xr=xr, xi=xi: cuda_fft.fft_pow2(xr, xi), 10, 26)
            self.chain(f"torch_fft{n}", lambda z=z: torch.fft.fft(z), 10, 26, iters=6)
            snr = self.fft_snr(xr, xi, min(32, b))

            def build(meds, n=n, b=b, snr=snr):
                per = meds[f"fft{n}"]
                return {"wall_s": per, **self.roofline(16.0 * b * n, per), "snr_db": snr,
                        "library_wall_s": meds[f"torch_fft{n}"]}

            d = self.sec(f"fft{n}_precise", [f"fft{n}", f"torch_fft{n}"], build)
            log(f"fft n={n} batch={b}: {d['wall_s'] * 1e3:.4f} ms {d['gbs']:.0f} GB/s "
                f"roofline={d['roofline_fraction']} snr={snr:.1f} dB, torch.fft "
                f"{d['library_wall_s'] * 1e3:.4f} ms")

        def ratio(meds):
            # Same total points at both sizes: the per-point cost ratio is the wall ratio.
            return {"ratio": meds["fft16384"] / meds["fft8192"], "target": "<= 1.3"}

        self.sections["fft16384_vs_8192_per_element"] = (["fft16384", "fft8192"], ratio)
        d = self.rebuild("fft16384_vs_8192_per_element")
        d.pop("wall_s_reps", None)
        log(f"per-element 16384/8192 cost ratio: {d['ratio']:.3f}")

    def flagship_complex(self) -> torch.Tensor:
        """The flagship's shape as one complex64 array, and the yardstick's
        chain over it (torch.fft.fft, cuFFT)."""
        if not hasattr(self, "z_f"):
            self.z_f = torch.complex(self.randn(self.b_f, self.n_f), self.randn(self.b_f, self.n_f))
            self.chain("torch_fft", lambda: torch.fft.fft(self.z_f), 8, 24, iters=6)
        return self.z_f

    def s_torch_fft(self) -> None:
        b, n = self.b_f, self.n_f
        self.flagship_complex()
        d = self.sec("torch_fft1024", ["torch_fft"], lambda meds: {
            "wall_s": meds["torch_fft"], "gbs": fft_bytes(n, b, 8) / meds["torch_fft"] / 1e9,
            "note": "torch.fft.fft (cuFFT) of the same complex64 array: the yardstick"})
        log(f"torch.fft.fft n=1024: {d['wall_s'] * 1e3:.4f} ms {d['gbs']:.0f} GB/s")

    def s_public(self) -> None:
        b, n = self.b_f, self.n_f
        z = self.flagship_complex()
        xr, xi = self.randn(b, n), self.randn(b, n)
        rows = min(32, b)
        snr_pub = snr_db(fft.fft(z[:rows]), torch.fft.fft(z[:rows].to(torch.complex128)))
        snr_split = snr_db(_c128(fft.fft_split(xr[:rows], xi[:rows])),
                           torch.fft.fft(_c128((xr[:rows], xi[:rows]))))
        self.chain("public_fft", lambda: fft.fft(z), 8, 24)
        self.chain("fft_split", lambda: fft.fft_split(xr, xi), 10, 26)

        def pub(meds):
            per = meds["public_fft"]
            return {"wall_s": per, "gflops": fft_flops(n, b) / per / 1e9,
                    **self.roofline(fft_bytes(n, b, 8), per), "snr_db": snr_pub,
                    "library_wall_s": meds["torch_fft"]}

        def split(meds):
            per = meds["fft_split"]
            return {"wall_s": per, **self.roofline(16.0 * b * n, per), "snr_db": snr_split}

        for key, chains, build in (("public_fft1024", ["public_fft", "torch_fft"], pub),
                                   ("public_fft_split1024", ["fft_split"], split)):
            d = self.sec(key, chains, build)
            log(f"{key}: {d['wall_s'] * 1e3:.4f} ms {d['gbs']:.0f} GB/s snr={d['snr_db']:.1f} dB")

    def s_rfft(self) -> None:
        b, n = self.b_f, self.n_f
        x = self.randn(b, n)
        rows = min(64, b)
        snr = snr_db(_c128(cuda_fft.rfft_pow2(x[:rows].contiguous())),
                     torch.fft.rfft(x[:rows].double()))
        self.chain("rfft", lambda: cuda_fft.rfft_pow2(x), 10, 26)
        self.chain("torch_rfft", lambda: torch.fft.rfft(x), 10, 26, iters=6)
        traffic = 4.0 * b * n + 8.0 * b * (n // 2 + 1)  # real rows in, n/2+1 bins out

        def build(meds):
            per = meds["rfft"]
            return {"wall_s": per, "bytes_accessed": traffic, **self.roofline(traffic, per),
                    "snr_db": snr, "library_wall_s": meds["torch_rfft"]}

        d = self.sec("rfft1024", ["rfft", "torch_rfft"], build)
        log(f"rfft n=1024 b={b}: {d['wall_s'] * 1e3:.4f} ms {d['gbs']:.0f} GB/s snr={snr:.1f} dB, "
            f"torch.fft.rfft {d['library_wall_s'] * 1e3:.4f} ms")

    def input_2pow20(self) -> torch.Tensor:
        """The 2^20 cells' input and torch.fft's chain over it, made once and
        shared by the unfused and fused cells."""
        if not hasattr(self, "z_20"):
            n = self.points(1 << 20)
            self.z_20 = z = torch.complex(self.randn(n), self.randn(n))
            self.chain("torch_2pow20", lambda: torch.fft.fft(z), 32, 256, iters=6)
        return self.z_20

    def s_2pow20(self, fused: bool = False) -> None:
        z = self.input_2pow20()
        n = z.shape[-1]
        key, lib_key = "fft_2pow20_fused" if fused else "fft_2pow20", "torch_2pow20"
        fwd = fused_route(fft.fft) if fused else fft.fft
        snr = snr_db(fwd(z), torch.fft.fft(z.to(torch.complex128)))
        self.chain(key, lambda: fwd(z), 32, 256, iters=6)

        def build(meds):
            per, lib = meds[key], meds[lib_key]
            return {"n": n, "wall_s": per, **self.roofline(fft_bytes(n, 1, 8), per),
                    "snr_db": snr, "library_wall_s": lib,
                    "library_wall_s_reps": list(self.reps[lib_key]),
                    "speedup_vs_library": lib / per}

        d = self.sec(key, [key, lib_key], build, shared=[lib_key])
        log(f"fft 2^{n.bit_length() - 1} single{' (fused route)' if fused else ''}: "
            f"{d['wall_s'] * 1e3:.4f} ms snr={snr:.1f} dB vs torch.fft "
            f"{d['library_wall_s'] * 1e3:.4f} ms ({d['speedup_vs_library']:.2f}x)")

    def s_2pow20_fused(self) -> None:
        self.s_2pow20(fused=True)

    def giant_input(self, n: int):
        """Three tones at integer bins, built in float64 on the device with
        every phase reduced exactly (int64), then rounded once to complex64;
        their exact spectrum is n a_j e^{2 pi i ph_j} at bin f_j, 0 elsewhere."""
        tones = [(3, 0.5, 0.1), (12345 % n, 0.25, -0.3), ((n >> 1) + 7, 0.125, 0.7)]
        t = torch.arange(n, device=self.dev, dtype=torch.int64)
        z = torch.zeros(n, dtype=torch.complex128, device=self.dev)
        for f, a, ph in tones:
            ang = (torch.remainder(t * f, n).double() / n + ph) * (2.0 * math.pi)
            z += a * torch.polar(torch.ones_like(ang), ang)
            del ang
        del t
        return z.to(torch.complex64), tones

    def tone_snr(self, z: torch.Tensor, tones, op=fft.fft) -> float:
        """op(z) (default fft.fft) against the exact tones: the tone bins'
        errors plus the energy everywhere else (summed in float64), over the
        tones' energy."""
        n = z.shape[-1]
        X = op(z)
        sig = err = 0.0
        for f, a, ph in tones:
            want = n * a * complex(math.cos(2 * math.pi * ph), math.sin(2 * math.pi * ph))
            got = complex(X[f].item())
            sig += abs(want) ** 2
            err += abs(got - want) ** 2
            X[f] = 0
        for part in X.split(1 << 24):
            err += float(part.real.double().square().sum() + part.imag.double().square().sum())
        del X
        return 10.0 * math.log10(sig / max(err, 1e-300))

    def giant_setup(self, log2n: int):
        """The 2^log2n cells' multi-tone input and the torch.fft and copy
        chains over it, made once and shared by the unfused and fused cells."""
        if log2n not in self.giants:
            n = self.points(1 << log2n)
            z, tones = self.giant_input(n)
            zr, zi = (p.contiguous().reshape(-1, min(8192, n)) for p in (z.real, z.imag))
            k_lo, k_hi = (2, 8) if log2n <= 24 else (1, 4)
            self.chain(f"torch_2pow{log2n}", lambda: torch.fft.fft(z), k_lo, k_hi, iters=4)
            self.chain(f"copy_2pow{log2n}", lambda: copy_split(zr, zi, batch_tile=1), 4, 16,
                       iters=4)
            self.giants[log2n] = (z, tones, k_lo, k_hi)
        return self.giants[log2n]

    def giant(self, log2n: int, fused: bool = False) -> None:
        z, tones, k_lo, k_hi = self.giant_setup(log2n)
        n = z.shape[-1]
        fwd = fused_route(fft.fft) if fused else fft.fft
        inv = fused_route(fft.ifft) if fused else fft.ifft
        snr = self.tone_snr(z, tones, fwd)
        rt = None
        if log2n <= 24:
            rt = snr_db(inv(fwd(z)), z)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()  # the oracle's buffers go before the timing
        key = f"fft_2pow{log2n}{'_fused' if fused else ''}"
        lib_key, copy_key = f"torch_2pow{log2n}", f"copy_2pow{log2n}"
        self.chain(key, lambda: fwd(z), k_lo, k_hi, iters=4)

        def build(meds):
            per, lib, cp = meds[key], meds[lib_key], meds[copy_key]
            return {"n": n, "wall_s": per, **self.roofline(fft_bytes(n, 1, 8), per),
                    "snr_db": snr, "snr_oracle": "exact multi-tone spectrum",
                    "roundtrip_snr_db": rt, "library_wall_s": lib,
                    "copy_pass_s": cp, "copy_passes_equivalent": per / cp}

        d = self.sec(key, [key, lib_key, copy_key], build, shared=[lib_key, copy_key])
        log(f"fft 2^{n.bit_length() - 1} single{' (fused route)' if fused else ''}: "
            f"{d['wall_s'] * 1e3:.3f} ms = "
            f"{d['copy_passes_equivalent']:.2f} copy passes, snr={snr:.1f} dB (multi-tone)"
            + (f" roundtrip={rt:.1f} dB" if rt is not None else "")
            + f", torch.fft {d['library_wall_s'] * 1e3:.3f} ms")

    def s_2pow24(self) -> None:
        self.giant(24)

    def s_2pow24_fused(self) -> None:
        self.giant(24, fused=True)

    def s_2pow28(self) -> None:
        self.giant(28)

    # ---- spectral cells -------------------------------------------------

    def pwelch_ref(self, x: torch.Tensor, nfft: int, noverlap: int, fs: float = 2.0):
        """Reference-semantics Pwelch in float64 on the device (pwelch.go:74-145)."""
        stride = nfft - noverlap
        w = window.window_table("hann", nfft, device=self.dev)
        frames = x.double().unfold(-1, nfft, stride)
        p = torch.fft.rfft(frames * w).abs().square()
        p[..., 1:-1] *= 2.0
        return p.mean(dim=-2) / (float(w.square().sum()) * fs)

    def s_pwelch(self) -> None:
        rf = self.results.get("rfft1024")
        for nfft, stride in ((1024, 512), (256, 256), (1024, 160)):
            segs = max(16, int((1 << 23) // stride * self.scale))
            L = (segs - 1) * stride + nfft
            sig = torch.rand(1, L, generator=self.gen, device=self.dev) * 2 - 1
            w = window.window_table("hann", nfft, device=self.dev, dtype=torch.float32)
            name = f"pwelch{nfft}_s{stride}"
            self.chain(name, lambda s=sig, w=w, nfft=nfft, st=stride, S=segs:
                       cuda_pwelch.pwelch_power_sum(s, w, nfft, st, S), 6, 22)
            xs = sig[0, : min(L, stride * 2048 + nfft)]
            got, _ = spectral.pwelch(xs, 2.0, spectral.PwelchOptions(nfft=nfft,
                                                                      noverlap=nfft - stride))
            snr = snr_db(got, self.pwelch_ref(xs, nfft, nfft - stride))

            def build(meds, name=name, L=L, segs=segs, snr=snr, nfft=nfft):
                per = meds[name]
                row = {"wall_s": per, "msamples_per_s": L / per / 1e6,
                       "ns_per_frame": per / segs * 1e9, "snr_db": snr}
                if rf and nfft == self.n_f:
                    # The rfft kernel over the same frame count: the fused
                    # kernel's transform floor (1.0 = at the floor).
                    floor = rf["wall_s"] / self.b_f
                    row["floor_ns_per_frame"] = floor * 1e9
                    row["fraction_of_floor"] = floor / (per / segs)
                return row

            d = self.sec(name, [name], build)
            log(f"pwelch nfft={nfft} stride={stride}: {d['wall_s'] * 1e3:.4f} ms "
                f"{d['msamples_per_s']:.0f} Msamples/s {d['ns_per_frame']:.1f} ns/frame "
                f"snr={snr:.1f} dB")

    def s_spectrogram(self) -> None:
        segs = max(16, int((1 << 23) // 512 * self.scale))
        L = (segs - 1) * 512 + 1024
        sig = torch.rand(L, generator=self.gen, device=self.dev) * 2 - 1
        self.chain("spectrogram", lambda: models.spectrogram(sig, 1024, hop=512), 8, 24)
        xs = sig[: min(L, 512 * 255 + 1024)]
        w = window.window_table("hann", 1024, device=self.dev)
        ref = torch.fft.rfft(xs.double().unfold(-1, 1024, 512) * w).abs().square()
        snr = snr_db(models.spectrogram(xs, 1024, hop=512), ref)
        d = self.sec("spectrogram1024_s512", ["spectrogram"], lambda meds: {
            "wall_s": meds["spectrogram"], "msamples_per_s": L / meds["spectrogram"] / 1e6,
            "ns_per_frame": meds["spectrogram"] / segs * 1e9, "snr_db": snr})
        log(f"spectrogram 1024/512: {d['wall_s'] * 1e3:.4f} ms {d['ns_per_frame']:.1f} ns/frame "
            f"snr={snr:.1f} dB")

    def s_mel(self) -> None:
        frames = max(16, int(4096 * self.scale))
        L = 512 * frames + 1024
        sig = torch.rand(L, generator=self.gen, device=self.dev) * 2 - 1
        self.chain("mel", lambda: models.mel_spectrogram(sig, 44100.0, nfft=1024, hop=512,
                                                         n_mels=80), 8, 24)
        xs = sig[: 512 * min(frames, 255) + 1024]
        w = window.window_table("hann", 1024, device=self.dev)
        fb = models.mel_filterbank(80, 1024, 44100.0, device=self.dev, dtype=torch.float64)
        ref = torch.fft.rfft(xs.double().unfold(-1, 1024, 512) * w).abs().square() @ fb.T
        snr = snr_db(models.mel_spectrogram(xs, 44100.0, nfft=1024, hop=512, n_mels=80), ref)
        d = self.sec("mel_frontend_1024", ["mel"], lambda meds: {
            "wall_s": meds["mel"], "msamples_per_s": L / meds["mel"] / 1e6, "snr_db": snr})
        log(f"mel front end: {d['wall_s'] * 1e3:.4f} ms {d['msamples_per_s']:.0f} Msamples/s "
            f"snr={snr:.1f} dB")

    def s_istft(self) -> None:
        frames = max(16, int(4096 * self.scale))
        L = (frames - 1) * 512 + 1024
        x = torch.rand(L, generator=self.gen, device=self.dev) * 2 - 1
        spec = models.stft(x, 1024, hop=512, window="hann")

        def plain():
            fft.set_kernels_enabled(False)
            try:
                return models.istft(spec, 1024, hop=512, window="hann")
            finally:
                fft.set_kernels_enabled(True)

        y = models.istft(spec, 1024, hop=512, window="hann")
        snr = snr_db(y[1024:-1024], x[1024: y.shape[-1] - 1024])
        self.chain("istft_fused", lambda: models.istft(spec, 1024, hop=512, window="hann"), 8, 24,
                   iters=6)
        self.chain("istft_plain", plain, 8, 24, iters=4)
        d = self.sec("istft_fused_1024", ["istft_fused", "istft_plain"], lambda meds: {
            "wall_s": meds["istft_fused"], "msamples_per_s": L / meds["istft_fused"] / 1e6,
            "plain_wall_s": meds["istft_plain"],
            "plain_wall_s_reps": list(self.reps["istft_plain"]),
            "speedup_vs_plain": meds["istft_plain"] / meds["istft_fused"],
            "snr_db": snr, "snr_oracle": "istft(stft(x)) vs x over [nfft, L - nfft)"})
        log(f"istft 1024/512: {d['wall_s'] * 1e3:.4f} ms, plain route "
            f"{d['plain_wall_s'] * 1e3:.4f} ms -> {d['speedup_vs_plain']:.2f}x "
            f"roundtrip snr={snr:.1f} dB")

    def mesh1(self):
        return parallel.make_mesh(parallel.MeshConfig(dp=1, sp=1), devices=[self.dev])

    def s_fused_halo(self) -> None:
        L = 512 * max(16, int(4096 * self.scale))
        sig = torch.rand(L, generator=self.gen, device=self.dev) * 2 - 1
        opts, mesh = spectral.PwelchOptions(nfft=1024, noverlap=512), self.mesh1()

        def run():
            return parallel.pwelch_sharded(sig, 2.0, opts, mesh, halo_impl=("fused", False))[0]

        snr = snr_db(run(), self.pwelch_ref(sig, 1024, 512))
        self.chain("fused_halo", run, 6, 18, iters=6)
        d = self.sec("pwelch_fused_halo", ["fused_halo"], lambda meds: {
            "wall_s": meds["fused_halo"], "msamples_per_s": L / meds["fused_halo"] / 1e6,
            "snr_db": snr})
        log(f"fused-halo sharded pwelch (one-shard ring): {d['wall_s'] * 1e3:.4f} ms "
            f"{d['msamples_per_s']:.0f} Msamples/s snr={snr:.1f} dB")

    def s_stream_ondevice(self) -> None:
        """The streaming driver's per-chunk device program on a chunk
        already on the card (parallel.streaming: StreamingPwelch._process
        without its host-to-device copy)."""
        segs = max(16, int(4096 * self.scale))
        chunk = segs * 512
        ext = torch.rand(1, chunk + 512, generator=self.gen, device=self.dev) * 2 - 1
        w = window.window_table("hann", 1024, device=self.dev, dtype=torch.float32)
        mesh = self.mesh1()
        self.chain("stream_ondevice", lambda: sharded_partial_step(
            ext[..., :chunk], ext[..., chunk:], w, mesh, 1024, 1024, 512, segs, 513, segs,
            halo_impl=("ppermute", False)), 6, 18, iters=10)
        d = self.sec("pwelch_stream_ondevice", ["stream_ondevice"], lambda meds: {
            "wall_s": meds["stream_ondevice"],
            "msamples_per_s": chunk / meds["stream_ondevice"] / 1e6})
        log(f"pwelch streaming (on-device chunk program): {d['wall_s'] * 1e3:.4f} ms/chunk "
            f"{d['msamples_per_s']:.0f} Msamples/s")

    def s_stream(self) -> None:
        """stream_pwelch over host chunks, with the host-to-device copy rate
        of one chunk co-measured in each rep (fraction_of_h2d_bound)."""
        total, chunk = self.points(1 << 24), self.points(1 << 22)
        segs = max(16, chunk // 512 // 2)
        sig = (torch.randn(total, generator=self.gen, device=self.dev)).cpu().numpy()
        opts = spectral.PwelchOptions(nfft=1024, noverlap=512)

        def stream():
            return parallel.stream_pwelch((sig[i: i + chunk] for i in range(0, total, chunk)),
                                          44100.0, opts, device=self.dev,
                                          segs_per_chunk_shard=segs)

        stream()  # warm
        walls, h2d = [], []
        blob = sig[:chunk]
        for _ in range(3):
            t0 = time.perf_counter()
            torch.from_numpy(blob).to(self.dev)
            if self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)
            h2d.append(blob.nbytes / (time.perf_counter() - t0) / 1e9)
            t0 = time.perf_counter()
            stream()
            if self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)
            walls.append(time.perf_counter() - t0)
        wall, h2d_gbs = med(walls), med(h2d)
        achieved = total * 4 / wall / 1e9
        self.results["pwelch_stream"] = {
            "wall_s": wall, "wall_s_reps": walls, "msamples_per_s": total / wall / 1e6,
            "h2d_bound_gbs": h2d_gbs, "h2d_bound_gbs_reps": h2d,
            "achieved_h2d_gbs": achieved, "fraction_of_h2d_bound": achieved / h2d_gbs,
        }
        log(f"pwelch streaming (host-fed): {total / wall / 1e6:.1f} Msamples/s "
            f"(reps {'/'.join(f'{w:.3f}s' for w in walls)}); h2d {h2d_gbs:.3f} GB/s -> "
            f"{achieved / h2d_gbs:.2f} of bound")


# Sections in run order: name -> (method, optional).  An optional section
# is shed past its share of the budget.
SECTIONS = {
    "fft1024_precise": ("s_flagship", None),
    "fft_sizes": ("s_sizes", None),
    "torch_fft1024": ("s_torch_fft", None),
    "public_fft1024": ("s_public", None),
    "rfft1024": ("s_rfft", None),
    "fft_2pow20": ("s_2pow20", None),
    "fft_2pow20_fused": ("s_2pow20_fused", None),
    "fft_2pow24": ("s_2pow24", None),
    "fft_2pow24_fused": ("s_2pow24_fused", None),
    "pwelch": ("s_pwelch", None),
    "spectrogram1024_s512": ("s_spectrogram", None),
    "mel_frontend_1024": ("s_mel", None),
    "istft_fused_1024": ("s_istft", None),
    "pwelch_fused_halo": ("s_fused_halo", None),
    "pwelch_stream_ondevice": ("s_stream_ondevice", None),
    "pwelch_stream": ("s_stream", 1.5),
    "fft_2pow28": ("s_2pow28", 1.3),
}
# The cells chip_smoke.py drives (no sweeps): the flagship with its copy and
# floor reps, the three per-size rows, rfft, the yardstick, 2^20, pwelch.
CORE = ["fft1024_precise", "fft_sizes", "rfft1024", "torch_fft1024", "fft_2pow20", "pwelch"]


def summary(results: dict, kind: str, final: bool) -> dict:
    """The summary object: bench.py's north-star keys and a compact map of
    every cell's median ms and SNR."""
    fl = results.get(FLAGSHIP, {})
    frac = fl.get("roofline_fraction") or 0.0
    cells = {}
    for key, d in results.items():
        if not isinstance(d, dict) or "wall_s" not in d:
            continue
        c = {"ms": float(f"{d['wall_s'] * 1e3:.4g}")}
        if d.get("snr_db") is not None:
            c["db"] = round(d["snr_db"], 1)
        if d.get("library_wall_s") is not None:
            c["lib_ms"] = float(f"{d['library_wall_s'] * 1e3:.4g}")
        cells[key] = c
    for k in ("fraction_of_copy_ceiling", "fraction_of_gmm_floor"):
        if fl.get(k) is not None:
            cells[FLAGSHIP][k[12:]] = round(fl[k], 4)
    out = {
        "metric": "fft1024_precise_roofline_fraction",
        "value": round(frac, 4),
        "unit": "fraction_of_hbm_roofline",
        "vs_baseline": round(frac / TARGET, 4),
        "device": kind,
        "partial": not final,
        "cells": cells,
    }
    if results.get("shed_sections"):
        out["shed"] = results["shed_sections"]
    if results.get("failed_sections"):
        out["failed"] = results["failed_sections"]
    return out


def summary_line(results: dict, kind: str = "", final: bool = True) -> str:
    """The summary as one JSON line of at most SUMMARY_MAX_CHARS: past it,
    the per-cell extras go first, then the cells' SNRs."""
    s = summary(results, kind, final)
    line = json.dumps(s, separators=(",", ":"))
    for keep in (("ms", "db"), ("ms",)):
        if len(line) <= SUMMARY_MAX_CHARS:
            break
        s["cells"] = {k: {f: v for f, v in c.items() if f in keep} for k, c in s["cells"].items()}
        line = json.dumps(s, separators=(",", ":"))
    if len(line) > SUMMARY_MAX_CHARS:
        raise ValueError(f"summary line of {len(line)} characters")
    return line


def run(cells=None, device=None, scale: float = 1.0, sweeps: bool = True,
        emit: bool = True) -> dict:
    """Run the named sections (default: all, in SECTIONS order) and return
    the results.  emit prints the detail and summary lines after each;
    sweeps adds two rep sweeps and the flagship's later reps."""
    b = Bench(device, scale)
    names = list(SECTIONS) if cells is None else list(cells)
    log(f"device: {b.kind}, peak device memory {b.peak} GB/s, launch + readback "
        f"{measure_rtt() * 1e3:.3f} ms")

    def emit_now(final=False):
        if emit:
            print(json.dumps({"detail": b.results}, default=str), flush=True)
            print(summary_line(b.results, b.kind, final), flush=True)

    def sweep():
        for label, share in (("2/3", 1.0), ("3/3", 0.7)):
            if not b.shed(f"rep sweep {label}", share):
                b.sweep(label)
        if FLAGSHIP in b.results:
            b.flagship_rep("end")

    for name in names:
        method, optional = SECTIONS[name]
        if name == "fft_2pow28" and sweeps:
            sweep()  # 2^28 runs after the sweeps, as its working set is the largest
            sweeps = False
        if optional is not None and b.shed(name, optional):
            continue
        t0 = time.perf_counter()
        try:
            getattr(b, method)()
        except Exception as e:  # noqa: BLE001 - one failed section leaves the others
            log(f"section {name} failed: {e!r}")
            b.results.setdefault("failed_sections", []).append(name)
        log(f"  [t={b.elapsed():7.1f}s +{time.perf_counter() - t0:6.1f}s] after {name}")
        if name == "fft_2pow20" and sweeps and FLAGSHIP in b.results:
            b.flagship_rep("mid")
        emit_now()
    if sweeps:
        sweep()
    emit_now(final=True)
    return b.results


def main(device=None, scale: float = 1.0) -> dict:
    """The whole bench on `device` (default: default_device(), the card)."""
    return run(None, device, scale)


if __name__ == "__main__":
    sys.exit(1 if main().get("failed_sections") else 0)
