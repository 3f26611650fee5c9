#!/usr/bin/env python
"""STFT synthesis on godsp_tpu_torch: istft round trip, streaming
synthesis, Griffin-Lim.

The godsp_tpu_torch twin of examples/synthesis_tour.py.  On the card the
STFT and its inverse are K5 and K6; set_default_device("cpu") runs the
plain versions in float64.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "..", ".."))

import numpy as np

from godsp_tpu_torch.dsputils import snr_db
from godsp_tpu_torch.models import griffin_lim, istft, stft, stream_istft


def main():
    fs = 16000
    t = np.arange(fs * 2) / fs
    x = (np.sin(2 * np.pi * 440.0 * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)
    nfft, hop = 1024, 512

    # 1. Analysis -> synthesis round trip (least-squares overlap-add).
    s = stft(x, nfft, hop=hop)
    y = istft(s, nfft, hop=hop).cpu().numpy()
    span = len(y)  # frames cover [0, span); the tail remainder is dropped
    print(f"istft round-trip SNR: {snr_db(y[1:-1], x[1 : span - 1]):.1f} dB")

    # 2. Spectral gate, then streaming synthesis in 4 chunks: the
    #    concatenated blocks and coda equal the one-shot inverse.
    spec = s.cpu().numpy()
    mag = np.abs(spec)
    gated = np.where(mag > 0.1 * mag.max(), spec, 0.0)
    F = gated.shape[0]
    q = F // 4
    chunks = [gated[i : i + q] for i in range(0, q * 4, q)]
    if q * 4 < F:
        chunks.append(gated[q * 4 :])
    blocks = list(stream_istft(chunks, nfft, hop=hop))
    y_stream = np.concatenate([b.cpu().numpy() for b in blocks], axis=-1)
    y_once = istft(gated, nfft, hop=hop).cpu().numpy()
    print(f"streaming == one-shot: {snr_db(y_stream, y_once):.1f} dB ({len(blocks)} blocks)")

    # 3. Griffin-Lim: throw the phase away, get a signal back whose
    #    spectrogram matches.
    y_gl = griffin_lim(mag, nfft, hop=hop, n_iter=32)
    mag_gl = stft(y_gl, nfft, hop=hop).abs().cpu().numpy()
    rel = np.linalg.norm(mag_gl - mag) / np.linalg.norm(mag)
    print(f"griffin-lim spectral mismatch after 32 iters: {rel:.3%}")


if __name__ == "__main__":
    main()
