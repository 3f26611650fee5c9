"""What the probe scripts share: chains of launches for time_chain_diff,
the card's name and power limit, and the lane probes' inputs, yardstick,
timing loop and entry point."""

from __future__ import annotations

import json
import subprocess
import sys
from contextlib import nullcontext

import torch

from godsp_tpu_torch.fft.four_step import _tf32_off
from godsp_tpu_torch.ops import cuda_metrics
from godsp_tpu_torch.utils.metrics import bound_ms, time_chain_diff

__all__ = ["TF32_FLOPS", "card", "chained", "complex_matmul", "lane_main", "lane_planes",
           "time_lane_rows"]

TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor-core peak (NVIDIA's data sheet)


def chained(op):
    """make_chained(k) for utils.metrics.time_chain_diff: k calls of op()."""
    def make(k):
        def chain(_x):
            out = None
            for _ in range(k):
                out = op()
            return out
        return chain
    return make


def card() -> str:
    """nvidia-smi's name and power limit of the first card."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not available"


def lane_planes(device, b: int, n: int, seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Two float32 planes (b, n), N(0, 0.01^2), from a torch.Generator on the device."""
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(b, n, generator=g, device=device) * 0.01,
            torch.randn(b, n, generator=g, device=device) * 0.01)


def complex_matmul(xr: torch.Tensor, xi: torch.Tensor):
    """K13's library yardstick: one torch.matmul of the complex64 slices
    (n1, b, 128) with the complex64 G tables (n1, 128, 128), inputs built
    once; the caller keeps TF32 off.  Returns the op of no arguments."""
    b, n = xr.shape
    gt = cuda_metrics.gmm_tables(n, xr.device)
    G = torch.complex(gt[:, 0], gt[:, 1])
    z = torch.complex(xr, xi).view(b, n // 128, 128).transpose(0, 1)
    return lambda: torch.matmul(z, G)


def time_lane_rows(xr: torch.Tensor, ops: dict, ops_per_point: dict, emit,
                   tf32_per_point: dict | None = None) -> dict:
    """Each row of ops ({name: (op, library op or None)}, the copy first)
    timed with time_chain_diff beside its bound (16 B and
    ops_per_point[name] float32 operations a point of the planes, any shape;
    where tf32_per_point names the row, also its TF32 operations over
    TF32_FLOPS, kept as "tf32_ms", and the bound is the larger) and its
    library call, TF32 off on the card; returns {name: {"ms", "bound_ms",
    "bound_by", "library_ms", "of_copy"}} and emits one line a row."""
    pts = xr.numel()
    shape = " x ".join(map(str, xr.shape))
    tf32_per_point = tf32_per_point or {}
    out = {}
    with _tf32_off() if xr.is_cuda else nullcontext():
        for name, (op, lib) in ops.items():
            bnd, by = bound_ms(16.0 * pts, ops_per_point[name] * pts)
            r = dict(ms=time_chain_diff(chained(op), xr) * 1e3, bound_ms=bnd, bound_by=by,
                     library_ms=None if lib is None else time_chain_diff(chained(lib), xr) * 1e3)
            if name in tf32_per_point:
                r["tf32_ms"] = tf32_per_point[name] * pts / TF32_FLOPS * 1e3
                if r["tf32_ms"] > bnd:
                    r.update(bound_ms=r["tf32_ms"], bound_by="operations")
            out[name] = r
    copy_ms = out["copy"]["ms"]
    for name, r in out.items():
        r["of_copy"] = r["ms"] / copy_ms
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        tf32 = f"  (TF32 {r['tf32_ms']:.4f} ms)" if "tf32_ms" in r else ""
        emit(f"{name:11s} {r['ms']:.4f} ms  ({r['of_copy']:.2f}x the copy)  bound "
             f"{r['bound_ms']:.4f} ms ({r['bound_by']}){tf32}  library {lib}  "
             f"[{xr.device.type}, {shape}]")
    return out


def lane_main(name: str, run, b: int, n: int) -> int:
    """A lane probe's entry point: on the card, the card's line, then
    run("cuda"), then one JSON line {name: rows}; 1 without a card."""
    if not torch.cuda.is_available():
        print(f"{name}: needs an NVIDIA GPU (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    print(f"card: {card()}; torch device {torch.cuda.get_device_name(0)}", flush=True)
    print(f"shape: {b} rows x {n} points, two float32 planes", flush=True)
    rows = run("cuda", emit=lambda s: print(s, flush=True))
    print(json.dumps({name: rows}), flush=True)
    return 0
