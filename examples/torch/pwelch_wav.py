#!/usr/bin/env python
"""Welch PSD of a WAV file, streamed block by block, on godsp_tpu_torch.

The godsp_tpu_torch twin of examples/pwelch_wav.py.

Usage: python examples/torch/pwelch_wav.py [file.wav]
Falls back to a synthesized two-tone WAV when no file is given.  Runs on
the card (default_device()); set_default_device("cpu") runs it on the CPU.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "..", ".."))

import io
import sys

import numpy as np

from godsp_tpu_torch import spectral, wav
from godsp_tpu_torch.models import wav_psd


def synth_wav(fs=8000, seconds=5.0):
    t = np.arange(int(fs * seconds)) / fs
    sig = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1000 * t)
    buf = io.BytesIO()
    wav.write_wav(buf, sig.astype(np.float32), fs)
    return buf.getvalue()


def main():
    src = sys.argv[1] if len(sys.argv) > 1 else synth_wav()
    opts = spectral.PwelchOptions(nfft=1024, noverlap=512)

    # Streaming pipeline: blocks -> device step -> (Pxx, freqs).
    res = wav_psd(src, opts, block_size=1 << 18)
    peak = res.freqs[int(np.argmax(res.pxx[1:])) + 1]  # skip DC
    print(f"samples={res.samples} fs={res.sample_rate}")
    print(f"peak at {peak:.1f} Hz")
    print("metrics:", res.metrics_json)


if __name__ == "__main__":
    main()
