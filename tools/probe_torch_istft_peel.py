#!/usr/bin/env python3
"""K6 and K9's register use and K6's tile setting on one GPU.

    python3 tools/probe_torch_istft_peel.py [--ptxas] [--tiles]

--ptxas compiles csrc/peel_rows_kernel.cu and csrc/istft_kernel.cu with
`-Xptxas -v` and prints each kernel's lines with spills (the whole output
goes to godsp_tpu_torch/_build/ptxas_k6_k9.txt).  --tiles times K6 alone
and by chain at phase 3's three shapes (chip_smoke.py: K6_SHAPES) for
each setting of ops/cuda_istft.py's _TARGET_BLOCKS (the CTAs tile_frames
aims for), the first setting again last, for the spread.  Both by
default.  Prints the card's name and power limit first.  Needs a CUDA
device; imports nothing of JAX.  The checks of both kernels, their times
beside their first designs and the ISTFT's whole-signal margins are
chip_smoke.py's phase 3 (phase_istft_peel_redesign, istft_margins).
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ptxas() -> None:
    from godsp_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lines = []
    for name in ("peel_rows_kernel.cu", "istft_kernel.cu"):
        with tempfile.TemporaryDirectory() as tmp:
            res = subprocess.run(
                [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                 "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(_build.CSRC), "-c",
                 str(_build.CSRC / name), "-o", os.path.join(tmp, "k.o")],
                capture_output=True, text=True)
        lines += [f"== {name} rc {res.returncode}", res.stdout, res.stderr]
        spills = [ln for ln in res.stderr.splitlines()
                  if "spill" in ln and " 0 bytes spill" not in ln]
        print(f"ptxas {name}: rc {res.returncode}, lines with spills: {len(spills)}", flush=True)
        for ln in spills[:20]:
            print("  " + ln.strip(), flush=True)
    with open(_build.BUILD_DIR / "ptxas_k6_k9.txt", "w") as fh:
        fh.write("\n".join(lines))


def tiles(dev) -> None:
    import chip_smoke as cs
    from godsp_tpu_torch import window
    from godsp_tpu_torch.ops import cuda_istft
    from godsp_tpu_torch.probes._common import chained
    from godsp_tpu_torch.utils.metrics import time_chain_diff

    probe = torch.empty(1, device=dev)
    g = torch.Generator(device=dev).manual_seed(18)
    w = window.window_table("hann", cs.NFFT, device=dev, dtype=torch.float32)
    specs = [(F, hop, pad, torch.complex(torch.randn(F, pad // 2 + 1, generator=g, device=dev),
                                         torch.randn(F, pad // 2 + 1, generator=g, device=dev)))
             for F, hop, pad in cs.K6_SHAPES]
    default = cuda_istft._TARGET_BLOCKS
    try:
        for target in (default, 2 * default, 4 * default, default // 2, default):
            cuda_istft._TARGET_BLOCKS = target
            for F, hop, pad, spec in specs:
                run = lambda: cuda_istft.istft_overlap_add(spec, w, cs.NFFT, hop)  # noqa: E731
                bt = cuda_istft.tile_frames(F, 1, cs.NFFT, hop, pad)
                chain = time_chain_diff(chained(run), probe) * 1e3
                alone = cs.kernel_alone_ms("istft_kernel", run)[0]
                print(f"  K6 tiles aim {target}: {F} frames hop {hop} pad {pad}: bt {bt}, "
                      f"{-(-F // bt)} CTAs; chain {chain:.4f} ms, alone "
                      f"{'not measured' if alone is None else f'{alone:.4f} ms'}", flush=True)
    finally:
        cuda_istft._TARGET_BLOCKS = default


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    from godsp_tpu_torch import set_default_device

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    set_default_device("cuda")
    dev = torch.device("cuda")
    args = set(sys.argv[1:]) or {"--ptxas", "--tiles"}
    if "--ptxas" in args:
        ptxas()
    if "--tiles" in args:
        import chip_smoke as cs

        cs.phase_build()
        tiles(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
