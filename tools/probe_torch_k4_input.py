#!/usr/bin/env python3
"""K4's SNR against its float64 plain version under two phase-3 inputs, on one GPU.

    python3 tools/probe_torch_k4_input.py

chip_smoke.py phase 3 held K4 (pwelch_power_partials) to its float64
plain version on randn + 0.5 samples, whose mean puts the DC bin far
above the rest, so the SNR weighed that one bin; it now feeds zero-mean
samples in [-1, 1), as decoded PCM16 is.  This prints K4's SNR at phase
3's five shapes under both inputs, from the same generator seed.  Prints
the card's name and power limit first.  Needs a CUDA device; imports
nothing of JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from godsp_tpu_torch import window
    from godsp_tpu_torch.dsputils import snr_db
    from godsp_tpu_torch.ops import cuda_pwelch

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    whole = (44100 * 600 - 1024) // 512 + 1
    for nfft, stride, pad, S, keep in ((1024, 512, 1024, 256, 256), (1024, 512, 1024, whole, whole),
                                       (1024, 160, 1024, 4096, 4096), (1024, 512, 2048, 4096, 4096),
                                       (1024, 512, 1024, 5001, 4990)):
        L = (S - 1) * stride + nfft
        mask = (torch.arange(S, device=dev) < keep).float()[None]
        w = window.window_table("hann", pad, device=dev, dtype=torch.float32)
        bt = cuda_pwelch.segs_per_tile(S, 1)
        row = []
        for name in ("randn + 0.5", "uniform [-1, 1)"):
            g = torch.Generator(device=dev).manual_seed(0)
            ext = (torch.randn(1, L, generator=g, device=dev) + 0.5 if name == "randn + 0.5"
                   else torch.rand(1, L, generator=g, device=dev) * 2 - 1)
            got = cuda_pwelch.pwelch_power_partials(ext, mask, w, nfft, stride, pad=pad)
            want = cuda_pwelch.pwelch_power_partials_plain(ext.double(), mask.double(), w.double(),
                                                           nfft, stride, pad, bt)
            row.append(f"{name}: {snr_db(got.cpu().numpy(), want.cpu().numpy()):.2f} dB")
        print(f"K4 nfft {nfft} hop {stride} pad {pad} S {S} keep {keep}: " + ", ".join(row),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
