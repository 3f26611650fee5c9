#!/usr/bin/env python
"""Distributed streaming Pwelch on a device mesh, on godsp_tpu_torch.

The godsp_tpu_torch twin of examples/distributed_pwelch.py.  The mesh
spans every visible card on its "sp" (time) axis; with one card, or on the
CPU (set_default_device("cpu")), it is one shard, and the same code shards
over more cards unchanged.  parallel.make_mesh also takes an explicit
device list that may repeat a device ([cuda:0] * 8) to show the sharded
semantics on one card.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "..", ".."))

import os
import tempfile

import numpy as np

from godsp_tpu_torch import spectral
from godsp_tpu_torch.parallel import StreamingPwelch, make_mesh


def main():
    mesh = make_mesh()
    print(f"mesh: dp=1 sp={mesh.shape['sp']} over {mesh.first.type}")

    fs = 44100.0
    opts = spectral.PwelchOptions(nfft=1024, noverlap=512)
    ckpt = os.path.join(tempfile.gettempdir(), "pwelch_demo.ckpt.npz")
    sp_drv = StreamingPwelch(
        fs, opts, mesh,
        segs_per_chunk_shard=64,
        checkpoint_path=ckpt,
        checkpoint_every_chunks=4,
    )

    rng = np.random.default_rng(0)
    t = 0
    for _ in range(40):  # 40 blocks of 100k samples
        n = 100_000
        tt = (np.arange(n) + t) / fs
        block = np.sin(2 * np.pi * 5000 * tt) + 0.1 * rng.normal(size=n)
        sp_drv.update(block)
        t += n

    pxx, freqs = sp_drv.finalize()
    print("peak at", freqs[int(np.argmax(pxx[1:])) + 1], "Hz")
    print("metrics:", sp_drv.metrics.json_line())
    if os.path.exists(ckpt):
        os.remove(ckpt)


if __name__ == "__main__":
    main()
