#!/usr/bin/env python3
"""Where the device time of godsp_tpu_torch's large FFTs goes, on one GPU.

    python3 tools/probe_torch_fft_profile.py

For fft of 16 x 2^20 and of 2^28 complex64 points, and hilbert of a
26,460,000-sample signal (the ten-minute recording's length, Bluestein at
pad 2^26), all on device tensors: one warm call each under
torch.profiler, then the device time by kernel name (the top rows) and
the call's total device time.  Prints the card's name and power limit
first.  Needs a CUDA device; imports nothing of JAX.
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
    from godsp_tpu_torch import fft

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def crand(*shape):
        return torch.complex(torch.randn(*shape, generator=g, device=dev),
                             torch.randn(*shape, generator=g, device=dev))

    cases = {
        "fft 16 x 2^20": (crand(16, 1 << 20), fft.fft),
        "fft 2^28": (crand(1 << 28), fft.fft),
        "hilbert 26,460,000": (torch.rand(26_460_000, generator=g, device=dev), fft.hilbert),
    }
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for label, (x, fn) in cases.items():
        fn(x)  # warm: tables, allocator
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=act) as prof:
            fn(x)
            torch.cuda.synchronize()
        # Device events only: an aten:: row repeats its kernels' time.
        rows = [e for e in prof.key_averages() if e.self_device_time_total > 0
                and not e.key.startswith(("aten::", "Activity Buffer"))]
        rows.sort(key=lambda e: -e.self_device_time_total)
        total = sum(e.self_device_time_total for e in rows) / 1e3
        print(f"{label}: device {total:.3f} ms in {sum(e.count for e in rows)} kernel calls",
              flush=True)
        for e in rows[:8]:
            print(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}",
                  flush=True)
        del x
    return 0


if __name__ == "__main__":
    sys.exit(main())
