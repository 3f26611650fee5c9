#!/usr/bin/env python
"""The 2^20-point FFT, hop-160 Welch, an odd-hop mel front end and the
analytic signal, on godsp_tpu_torch.

The godsp_tpu_torch twin of examples/large_fft_and_hilbert.py.  On the card
the 2^20-point FFT is the large plan (fft/large.py: K8, then K1 rows), the
hop-160 Welch is the fused K4 kernel and the mel front end K5's mel mode;
set_default_device("cpu") runs the plain versions in float64.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "..", ".."))

import numpy as np

from godsp_tpu_torch import fft, spectral
from godsp_tpu_torch.models import mel_spectrogram


def main() -> None:
    rng = np.random.default_rng(0)

    # 1) The reference's benchmark workload: one 2^20-point complex FFT
    #    (fft/fft_test.go:262-280).
    n = 1 << 20
    z = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    Z = fft.fft(z).cpu().numpy()
    print(f"2^20 FFT: bins {Z.shape}, DC {Z[0]:.3f}")

    # 2) Welch PSD at an audio hop of 160 (nfft 1024 - noverlap 864).
    fs = 16000.0
    sig = np.sin(2 * np.pi * 440.0 * np.arange(1 << 18) / fs).astype(np.float32)
    pxx, freqs = spectral.pwelch(sig, fs, spectral.PwelchOptions(nfft=1024, noverlap=1024 - 160))
    peak_bin = int(np.argmax(pxx.cpu().numpy()))
    print(f"pwelch hop=160: peak at {float(freqs[peak_bin]):.1f} Hz (expect 440)")

    # 3) Odd-hop mel front end.
    m = mel_spectrogram(sig, fs, nfft=1024, hop=160, n_mels=40)
    print(f"mel spectrogram: {tuple(m.shape)} (frames x mels)")

    # 4) Analytic signal: the envelope of an AM tone through the Hilbert transform.
    t = np.arange(1 << 14) / fs
    am = (1 + 0.5 * np.sin(2 * np.pi * 5 * t)) * np.cos(2 * np.pi * 1000 * t)
    env = fft.hilbert(am.astype(np.float32)).abs().cpu().numpy()
    print(f"AM envelope range: [{env[200:-200].min():.3f}, {env[200:-200].max():.3f}] "
          f"(expect ~[0.5, 1.5])")


if __name__ == "__main__":
    main()
