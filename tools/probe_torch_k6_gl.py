#!/usr/bin/env python3
"""K6 at the Griffin-Lim shape and griffin_lim's iteration, in one checkout.

    cd <checkout> && python3 <this file>

Run from the root of a checkout (it imports chip_smoke and godsp_tpu_torch
from the working directory, so the same file times any commit's tree): K6
(istft_overlap_add) on 60 s of random one-sided spectra at nfft 1024, hop
256, three times alone (the profiler's events) and by chain
(time_chain_diff), then griffin_lim on their magnitudes, n_iter 32, five
times by the host's clock, in ms an iteration.  To compare two commits,
unpack both and run parent, change, change, parent in one call.  Needs a
CUDA device; imports nothing of JAX.
"""

import os
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from godsp_tpu_torch import set_default_device, window  # noqa: E402
from godsp_tpu_torch.models import griffin_lim  # noqa: E402
from godsp_tpu_torch.ops import cuda_istft  # noqa: E402
from godsp_tpu_torch.probes._common import chained  # noqa: E402
from godsp_tpu_torch.utils.metrics import time_chain_diff  # noqa: E402


def main() -> None:
    set_default_device("cuda")
    dev = torch.device("cuda")
    cs.phase_build()
    g = torch.Generator(device=dev).manual_seed(5)
    F = (cs.FS * cs.GL_SECONDS - cs.NFFT) // 256 + 1
    spec = torch.complex(torch.randn(F, 513, generator=g, device=dev),
                         torch.randn(F, 513, generator=g, device=dev))
    w = window.window_table("hann", cs.NFFT, device=dev, dtype=torch.float32)
    op = lambda: cuda_istft.istft_overlap_add(spec, w, cs.NFFT, 256)  # noqa: E731
    alone = [cs.kernel_alone_ms("istft_kernel", op)[0] for _ in range(3)]
    chain = [time_chain_diff(chained(op), torch.empty(1, device=dev)) * 1e3 for _ in range(3)]
    mag = spec.abs()
    griffin_lim(mag, cs.NFFT, hop=256, n_iter=2, momentum=0.99)
    its = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        griffin_lim(mag, cs.NFFT, hop=256, n_iter=cs.GL_ITERS, momentum=0.99)
        torch.cuda.synchronize()
        its.append((time.perf_counter() - t) / cs.GL_ITERS * 1e3)
    print(os.path.basename(os.getcwd()), "K6 alone", " ".join(f"{a:.4f}" for a in alone),
          "chain", " ".join(f"{c:.4f}" for c in chain), "GL ms/iter",
          " ".join(f"{i:.3f}" for i in its), flush=True)


if __name__ == "__main__":
    main()
