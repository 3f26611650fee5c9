#!/usr/bin/env python3
"""How many end samples K6 must sum in float64: a CPU stand-in.

    python3 tools/sim_istft_edges.py

The caller of K6 divides the overlap-add by its window-energy sum, which at
a row's ends is one frame's w^2, so the float32 error of those samples is
scaled by 1/w.  This script stands torch's float32 inverse FFT (pocketfft on
the CPU, not K6) in for the kernel's float32 transform, on the complex64
spectra of 10 s of noise at 44.1 kHz (Hann, hop nfft/4), and prints the
whole signal's SNR against the float64 inverse of the same spectra at nfft
1024, 2048, 4096 and 16384 when the end samples are taken from the float64
inverse: none, a fixed 4 a side, or the window's runs below tau of its peak
(ops/cuda_istft.py: EDGE_TAU, edge_runs) for several tau.  No GPU; imports
nothing of JAX; a few seconds.
"""

from __future__ import annotations

import numpy as np
import torch


def main() -> None:
    x = np.random.default_rng(0).normal(size=441_000)
    for nfft in (1024, 2048, 4096, 16384):
        hop = nfft // 4
        w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(nfft) / nfft)
        F = (x.size - nfft) // hop + 1
        L = (F - 1) * hop + nfft
        idx = np.arange(nfft)[None, :] + hop * np.arange(F)[:, None]
        spec = np.fft.rfft(x[idx] * w, axis=-1).astype(np.complex64)
        exact = np.fft.irfft(spec.astype(np.complex128), n=nfft, axis=-1)
        f32 = torch.fft.irfft(torch.from_numpy(spec), n=nfft).numpy().astype(np.float64)
        wsum = np.zeros(L)
        for f in range(F):
            wsum[f * hop:f * hop + nfft] += w * w
        wsum = np.maximum(wsum, np.finfo(np.float64).tiny)

        def ola(frames):
            y = np.zeros(L)
            for f in range(F):
                y[f * hop:f * hop + nfft] += frames[f] * w
            return y / wsum

        want = ola(exact)
        for label, tau in (("none", None), ("4 a side", 0.0), ("tau 1e-4", 1e-4),
                           ("tau 1e-3", 1e-3), ("tau 2e-3", 2e-3), ("tau 3e-3", 3e-3)):
            e = 0 if tau is None else 4 if tau == 0.0 else int(np.argmax(w >= tau * w.max()))
            frames = f32.copy()
            if e:
                frames[0, :e], frames[-1, -e:] = exact[0, :e], exact[-1, -e:]
            err = ola(frames) - want
            db = 10 * np.log10(np.sum(want ** 2) / np.sum(err ** 2))
            print(f"nfft {nfft:5d} {label:9s} ({e:3d} a side): {db:.2f} dB", flush=True)


if __name__ == "__main__":
    main()
