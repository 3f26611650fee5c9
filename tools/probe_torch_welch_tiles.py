#!/usr/bin/env python3
"""K4, K11 and K7's device time at each tile setting, on one GPU.

    python3 tools/probe_torch_welch_tiles.py

The tile (ops/cuda_pwelch.py: segs_per_tile, the segments a CTA sums) is
the port's own choice: only the sum over tiles is contractual.  For each
setting of its two constants (_TARGET_BLOCKS, the tiles to aim for, and
_MAX_SEGS_PER_TILE), this times, by the profiler's events of each
kernel alone (chip_smoke.kernel_alone_ms, 40 calls), K4 and K11 at the
streaming chunk (256 segments at 1024/512; K11 one shard's block and its
neighbour's head), K4 at 16384 segments (1024/512) and at the bench's
52,428 (hop 160), and K7 over the ten-minute recording's length at
1024/512 (51,678 segments) and at hop 160 (nfft 1000, pad 1024; 165,369
segments); the first setting again last, for the spread.  Prints the
card's name and power limit first.  Needs a CUDA device; imports nothing
of JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

SETTINGS = ((528, 64), (1056, 64), (2112, 64), (1056, 32), (528, 64))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as cs
    from godsp_tpu_torch import set_default_device, window
    from godsp_tpu_torch.ops import cuda_csd, cuda_fused_halo, cuda_pwelch

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    set_default_device("cuda")
    cs.phase_build()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(16)
    w = window.window_table("hann", 1024, device=dev, dtype=torch.float32)

    def rand(n):
        return torch.rand(1, n, generator=g, device=dev) * 2 - 1

    def k4(segs, hop):
        ext, mask = rand((segs - 1) * hop + 1024), torch.ones(1, segs, device=dev)
        return lambda: cuda_pwelch.pwelch_power_partials(ext, mask, w, 1024, hop)

    def k7(segs, hop, nfft):
        x = rand((segs - 1) * hop + nfft)[0]
        y = 0.7 * torch.roll(x, 37)
        mask = torch.ones(segs, device=dev)
        return lambda: cuda_csd.csd_power_partials(x, y, mask, w, nfft, hop, 1024)

    chunk = rand(2 * 256 * 512)
    blk, src = chunk[:, : 256 * 512], chunk[:, 256 * 512:]
    ones = torch.ones(256, device=dev)
    cases = {
        "K4 chunk": ("pwelch_partials_kernel", k4(256, 512)),
        "K11 chunk": ("pwelch_partials_kernel", lambda: cuda_fused_halo.pwelch_power_partials_halo(
            blk, src, ones, w, 1024, 512)),
        "K4 16384": ("pwelch_partials_kernel", k4(16384, 512)),
        "K4 52428 hop 160": ("pwelch_partials_kernel", k4((1 << 23) // 160, 160)),
        "K7 51678": ("csd_partials_kernel", k7(51678, 512, 1024)),
        "K7 165369 hop 160": ("csd_partials_kernel", k7(165369, 160, 1000)),
    }
    keep = cuda_pwelch._TARGET_BLOCKS, cuda_pwelch._MAX_SEGS_PER_TILE
    try:
        for target, most in SETTINGS:
            cuda_pwelch._TARGET_BLOCKS, cuda_pwelch._MAX_SEGS_PER_TILE = target, most
            row = []
            for name, (symbol, run) in cases.items():
                ms = cs.kernel_alone_ms(symbol, run, reps=40)[0]
                row.append(f"{name} {'not measured' if ms is None else f'{ms:.4f}'}")
            print(f"tiles: target {target}, at most {most} segments (ms alone): "
                  + " | ".join(row), flush=True)
    finally:
        cuda_pwelch._TARGET_BLOCKS, cuda_pwelch._MAX_SEGS_PER_TILE = keep
    return 0


if __name__ == "__main__":
    sys.exit(main())
