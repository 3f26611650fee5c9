#!/usr/bin/env python3
"""K10 at phase 8's chunk and phase 8's mesh walls, in one checkout.

    cd <checkout> && python3 <this file>

Run from the root of a checkout (it imports chip_smoke and godsp_tpu_torch
from the working directory, so the same file times any commit's tree):
ring_halo on phase 8's chunk (the eight views of one 8 x 131,072 + 512
buffer, halo 512) three times by events (utils.metrics.time_ms) and three
times by chain (time_chain_diff), and alone (the profiler's events of every
kernel a call launches, over 50 calls); then chip_smoke.phase_mesh on the
seeded recording, whose lines (walls, launch checks, agreement) it prints.
To compare two commits, unpack both and run parent, change, change, parent
in one call.  Needs a CUDA device; imports nothing of JAX.
"""

import os
import sys
import tempfile

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from godsp_tpu_torch import set_default_device  # noqa: E402
from godsp_tpu_torch.ops import cuda_halo  # noqa: E402
from godsp_tpu_torch.probes._common import chained  # noqa: E402
from godsp_tpu_torch.utils.metrics import time_chain_diff, time_ms  # noqa: E402


def main() -> None:
    set_default_device("cuda")
    dev = torch.device("cuda", 0)
    cs.phase_build()
    g = torch.Generator(device=dev).manual_seed(21)
    block, halo = cs.SEGS * 512, 512
    ext = torch.rand(1, cs.SP * block + halo, generator=g, device=dev) * 2 - 1
    blocks = list(ext[:, : cs.SP * block].chunk(cs.SP, dim=-1))
    op = lambda: cuda_halo.ring_halo(blocks, halo)  # noqa: E731
    probe = torch.empty(1, device=dev)
    events = [time_ms(op) for _ in range(3)]
    chain = [time_chain_diff(chained(op), probe) * 1e3 for _ in range(3)]
    rows = cs.kernel_alone_ms("", op)[1]
    alone = sum(e.self_device_time_total for e in rows) / 1e3 / 50
    print(f"K10 {cs.SP} blocks x 1 row x {block}, halo {halo}: by events "
          + " / ".join(f"{t:.4f}" for t in events) + " ms, by chain "
          + " / ".join(f"{t:.4f}" for t in chain) + f" ms, alone {alone:.4f} ms", flush=True)
    del ext, blocks
    with tempfile.TemporaryDirectory() as tmp:
        path, stereo = os.path.join(tmp, "recording.wav"), os.path.join(tmp, "stereo.wav")
        cs.write_recording(path, stereo)
        cs.phase_mesh(dev, path, stereo)


if __name__ == "__main__":
    main()
