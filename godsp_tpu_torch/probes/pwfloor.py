"""Take K4 apart on the card: its floor twins beside K4, K3 and K12.

    python3 -m godsp_tpu_torch.probes.pwfloor

The counterpart of tools/probe_pwfloor.py (main), at its geometry:
nfft = pad = 1024, stride 512, 16384 segments, L = 8,389,120 samples.
Each row is timed with utils.metrics.time_chain_diff (two chains of
launches between CUDA events; their difference over the extra launches):

  loadonly   the tile's samples, mask and window read once and summed;
  frameonly  K4's framing and window, masked sum, no FFT: K4's own body
             (its CTA, tiles, frame order and sums in registers) without
             the transform;
  noframe    the same frames given materialized (S, pad): window, FFT,
             |X|^2, masked sum (twice the bytes read);
  staged     K4's function with each tile's span staged once in shared
             memory instead of re-read through L2;
  full       K4 itself (ops/cuda_pwelch.pwelch_power_partials);
  rfft       K3 (ops/cuda_fft.rfft_pow2) on the materialized frames;

each beside K12's copy ceiling on the bytes it reads (ops/cuda_metrics
copy_split over the same tensor split in two planes: those bytes read
and written once) and beside its bound (bytes over 3.35 TB/s, utils.
metrics.bound_ms).  The gap from loadonly to frameonly prices K4's
framing; frameonly to full its transform, split and |X|^2 (frameonly is
K4's body without them); staged against full the L2 re-reads; noframe
against rfft the window, |X|^2 and sum.

The TPU probe's dimension_semantics A/B ("arbitrary" against "parallel"
grid axes) has no Hopper meaning: a CUDA grid has no sequential
dimension, so it is not ported.

Inputs are made on the device from a torch.Generator seeded with 0.
run(device="cpu", segs=...) sends the same rows through the plain
versions at a cut size, for tests; a CPU time is not a device number.
"""

from __future__ import annotations

import json
import sys

import torch

from godsp_tpu_torch import window
from godsp_tpu_torch._dtypes import resolve_device
from godsp_tpu_torch.ops import cuda_fft, cuda_metrics, cuda_probes, cuda_pwelch
from godsp_tpu_torch.probes._common import card, chained
from godsp_tpu_torch.utils.metrics import bound_ms, rfft_flops, time_chain_diff

__all__ = ["NFFT", "ROWS", "SEGS", "STRIDE", "inputs", "main", "run"]

NFFT = 1024  # = pad
STRIDE = 512
SEGS = 16384
ROWS = ("loadonly", "frameonly", "noframe", "staged", "full", "rfft")


def inputs(device, segs: int | None = None, seed: int = 0) -> dict:
    """ext ((segs - 1) * STRIDE + NFFT samples, N(0, 0.01)), its frames
    materialized (segs, NFFT), mask ones, periodic Hann, all float32
    (segs: default SEGS)."""
    dev = torch.device(device)
    segs = SEGS if segs is None else segs
    g = torch.Generator(device=dev).manual_seed(seed)
    L = (segs - 1) * STRIDE + NFFT
    ext = torch.randn(L, generator=g, device=dev, dtype=torch.float32) * 0.1
    return dict(ext=ext, frames=ext.unfold(-1, NFFT, STRIDE).contiguous(),
                mask=torch.ones(segs, device=dev, dtype=torch.float32),
                w=window.window_table("hann", NFFT, device=dev, dtype=torch.float32))


def ops(x: dict) -> dict:
    """Each row: (op of no arguments, the tensor it reads, its bound's
    bytes and operations)."""
    ext, frames, mask, w = x["ext"], x["frames"], x["mask"], x["w"]
    S = mask.shape[-1]
    bt = cuda_pwelch.segs_per_tile(S, 1)
    tiles, bins = -(-S // bt), NFFT // 2 + 1
    ins = 4.0 * (ext.numel() + S + NFFT)  # samples, mask, window, each read once
    spectral = 4.0 * tiles * bins
    fft_ops = S * (NFFT + rfft_flops(NFFT) + 3.0 * bins)
    st_bt = cuda_probes.staged_segs_per_tile(S, 1, NFFT, STRIDE, NFFT)
    return {
        "loadonly": (lambda: cuda_probes.pwfloor_loadonly(ext, mask, w, NFFT, STRIDE), ext,
                     ins + 4.0 * tiles, ext.numel() + S + NFFT),
        "frameonly": (lambda: cuda_probes.pwfloor_frameonly(ext, mask, w, NFFT, STRIDE), ext,
                      ins + 4.0 * tiles * NFFT, 2.0 * S * NFFT),
        "noframe": (lambda: cuda_probes.pwfloor_noframe(frames, mask, w), frames,
                    4.0 * (frames.numel() + S + NFFT) + spectral, fft_ops),
        "staged": (lambda: cuda_probes.pwfloor_staged(ext, mask, w, NFFT, STRIDE), ext,
                   ins + 4.0 * -(-S // st_bt) * bins, fft_ops),
        "full": (lambda: cuda_pwelch.pwelch_power_partials(ext, mask, w, NFFT, STRIDE), ext,
                 ins + spectral, fft_ops),
        "rfft": (lambda: cuda_fft.rfft_pow2(frames), frames,
                 4.0 * frames.numel() + 8.0 * S * bins, rfft_flops(NFFT, S)),
    }


def _copy_planes(t: torch.Tensor):
    flat = t.reshape(-1)
    half = flat.numel() // 2
    return flat[:half].reshape(1, half), flat[half : 2 * half].reshape(1, half)


def run(device=None, segs: int | None = None, emit=print) -> dict:
    """Time every row at `segs` segments (default SEGS) on `device`
    (default: the card); returns {row: {"ms", "ns_per_frame",
    "bytes_read", "ceiling_ms", "bound_ms", "bound_by"}} and emits one
    line a row."""
    dev = resolve_device(device)
    x = inputs(dev, segs)
    segs = x["mask"].shape[-1]
    ceilings = {}
    rows = {}
    for name, (op, read, nbytes, flops) in ops(x).items():
        key = read.data_ptr()
        if key not in ceilings:
            xr, xi = _copy_planes(read)
            ceilings[key] = time_chain_diff(
                chained(lambda xr=xr, xi=xi: cuda_metrics.copy_split(xr, xi)), read) * 1e3
        ms = time_chain_diff(chained(op), read) * 1e3
        b, by = bound_ms(nbytes, flops)
        rows[name] = dict(ms=ms, ns_per_frame=ms * 1e6 / segs, bytes_read=4.0 * read.numel(),
                          ceiling_ms=ceilings[key], bound_ms=b, bound_by=by)
        emit(f"{name:9s} {ms:.4f} ms ({ms * 1e6 / segs:.2f} ns/frame)  reads "
             f"{4.0 * read.numel() / 1e6:.1f} MB, K12 copy ceiling of those bytes "
             f"{ceilings[key]:.4f} ms, bound {b:.4f} ms ({by})  [{dev.type}]")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("pwfloor: needs an NVIDIA GPU (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    print(f"card: {card()}; torch device {torch.cuda.get_device_name(0)}", flush=True)
    print(f"geometry: nfft = pad = {NFFT}, stride {STRIDE}, {SEGS} segments, "
          f"L = {(SEGS - 1) * STRIDE + NFFT} samples", flush=True)
    rows = run("cuda", emit=lambda s: print(s, flush=True))
    print(json.dumps({"pwfloor": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
