#!/usr/bin/env python
"""Sustained streaming-Pwelch run with mid-stream checkpoint/resume, on
godsp_tpu_torch.

The godsp_tpu_torch twin of examples/long_stream_benchmark.py: an
hours-long recording is simulated with synthetic blocks (use
wav.Wav.blocks for real files), streamed through the device step with the
reduction state checkpointed periodically; the stream is then dropped
mid-stream and resumed from the checkpoint, and the resumed result is held
to a clean end-to-end run.

  python examples/torch/long_stream_benchmark.py [total_samples]

Runs on the card (default_device()); set_default_device("cpu") runs it
on the CPU.  Wall times are the host's clock around the whole stream.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "..", ".."))

import os
import sys
import tempfile
import time

import numpy as np

from godsp_tpu_torch import spectral
from godsp_tpu_torch.parallel import MeshConfig, StreamingPwelch, make_mesh


def blocks(total, block=1 << 20, seed=0):
    rng = np.random.default_rng(seed)
    t0 = 0
    while t0 < total:
        n = min(block, total - t0)
        t = (np.arange(n) + t0) / 44100.0
        yield (np.sin(2 * np.pi * 5000.0 * t) + 0.1 * rng.normal(size=n)).astype(np.float32)
        t0 += n


def main():
    total = int(sys.argv[1]) if len(sys.argv) > 1 else (1 << 25)
    opts = spectral.PwelchOptions(nfft=1024, noverlap=512)
    mesh = make_mesh(MeshConfig(dp=1, sp=1))
    ckpt = os.path.join(tempfile.gettempdir(), "long_stream.ckpt.npz")
    if os.path.exists(ckpt):
        os.remove(ckpt)

    # Run A: stream the first 60 %, checkpointing, then "crash".
    a = StreamingPwelch(44100.0, opts, mesh, segs_per_chunk_shard=1024,
                        checkpoint_path=ckpt, checkpoint_every_chunks=4)
    fed = 0
    for b in blocks(total):
        a.update(b)
        fed += len(b)
        if fed >= int(total * 0.6):
            break
    print(f"run A crashed after {fed} samples, {a.metrics.chunks_done} chunks "
          f"({a.metrics.samples_per_s / 1e6:.1f} Msamples/s device-fold rate)")

    # Run B: resume from the checkpoint, replay from the consumed offset.
    t0 = time.perf_counter()
    b_drv = StreamingPwelch(44100.0, opts, mesh, segs_per_chunk_shard=1024,
                            checkpoint_path=ckpt, checkpoint_every_chunks=4)
    already = b_drv.metrics.chunks_done * b_drv.chunk_len + len(b_drv._bufs[0])
    skipped = 0
    for blk in blocks(total):
        if skipped + len(blk) <= already:
            skipped += len(blk)
            continue
        b_drv.update(blk[max(0, already - skipped):])
        skipped += len(blk)
    pxx, freqs = b_drv.finalize()
    wall = time.perf_counter() - t0
    print(f"resumed + finished: {b_drv.metrics.json_line()}")
    print(f"wall (resume half): {wall:.1f}s -> "
          f"{(total - already) / wall / 1e6:.1f} Msamples/s end-to-end")

    # Clean reference run for equality.
    ref_drv = StreamingPwelch(44100.0, opts, mesh, segs_per_chunk_shard=1024)
    for blk in blocks(total):
        ref_drv.update(blk)
    ref, _ = ref_drv.finalize()
    err = np.linalg.norm(pxx - ref) / np.linalg.norm(ref)
    print(f"resumed == clean run: rel err {err:.2e}")
    print(f"peak: {freqs[int(np.argmax(pxx[1:])) + 1]:.0f} Hz (expect 5000)")
    os.remove(ckpt)


if __name__ == "__main__":
    main()
