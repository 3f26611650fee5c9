#!/usr/bin/env python
"""Tour of the signal-processing toolkit on godsp_tpu_torch: filter design
-> filtering -> spectral analysis -> LTI simulation -> splines ->
ShortTimeFFT -> peaks -> the 2-D filters.

The godsp_tpu_torch twin of examples/signal_toolkit_tour.py, plus a
Savitzky-Golay step and a 2-D step.  Everything follows scipy.signal's
semantics; the compute paths run on the port's FFT kernels (K1/K2 and the
large plan on the card) and scans.

  python examples/torch/signal_toolkit_tour.py

Host data goes to the card (float32); set_default_device("cpu") runs the
plain versions in float64.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "..", ".."))

import numpy as np

import godsp_tpu_torch.models as M
from godsp_tpu_torch import fft as gfft
from godsp_tpu_torch.spectral import welch


def host(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def main():
    rng = np.random.default_rng(0)
    fs = 8000.0
    t = np.arange(int(2 * fs)) / fs
    sig = (np.sin(2 * np.pi * 440 * t) + 0.5 * np.sin(2 * np.pi * 1800 * t)
           + 0.2 * rng.normal(size=t.shape))

    # 1. design the minimum-order elliptic bandpass for a spec
    wp, ws = [350, 550], [200, 700]  # Hz passband/stopband edges
    N, wn = M.ellipord(wp, ws, gpass=1, gstop=50, fs=fs)
    sos = M.ellip(N, 1, 50, wn, btype="bandpass", output="sos", fs=fs)
    print(f"elliptic bandpass: order {N} at wn = {np.round(wn, 1)} Hz")

    # 2. zero-phase filter, then measure the PSD before/after
    filtered = host(M.sosfiltfilt(sos, sig))
    f_b, p_before = (host(a) for a in welch(sig, fs=fs, nperseg=1024))
    _, p_after = (host(a) for a in welch(filtered, fs=fs, nperseg=1024))
    i440 = np.argmin(np.abs(f_b - 440))
    i1800 = np.argmin(np.abs(f_b - 1800))
    print(f"PSD @440 Hz: {p_before[i440]:.2e} -> {p_after[i440]:.2e}")
    print(f"PSD @1800 Hz: {p_before[i1800]:.2e} -> {p_after[i1800]:.2e} (stopband)")

    # 3. equiripple FIR + minimum-phase version
    taps = M.remez(101, [0, 500, 700, fs / 2], [1, 0], fs=fs)
    mp = M.minimum_phase(taps if len(taps) % 2 else taps[:-1])
    print(f"remez lowpass: {len(taps)} taps -> minimum-phase {len(mp)} taps")

    # 4. LTI: simulate the analog prototype's step response
    b_a, a_a = M.butter(3, 2 * np.pi * 500, analog=True)
    t_step, y_step = M.step((b_a, a_a))
    print(f"analog step response: settles to {float(np.ravel(host(y_step))[-1]):.4f} "
          f"over {host(t_step)[-1] * 1e3:.1f} ms")

    # 5. spline smoothing (exact DCT-II route)
    noisy = np.sin(2 * np.pi * 3 * np.linspace(0, 1, 400)) + 0.3 * rng.normal(size=400)
    coef = M.cspline1d(noisy, lamb=50.0)
    smooth = host(M.cspline1d_eval(coef, np.arange(400)))
    print(f"smoothing spline residual rms: {np.sqrt(np.mean((smooth - noisy) ** 2)):.3f}")

    # 6. ShortTimeFFT scalogram of a chirp
    chirp = host(M.chirp(t, f0=100, t1=2.0, f1=2000))
    S = M.ShortTimeFFT.from_window("hann", fs, 256, 192, scale_to="psd")
    spec = host(S.spectrogram(chirp))
    ridge = host(S.f)[np.argmax(spec, axis=0)]
    print(f"chirp ridge: {ridge[5]:.0f} Hz -> {ridge[-5]:.0f} Hz across {spec.shape[1]} slices")

    # 7. CWT peak picking
    peaks = M.find_peaks_cwt(np.sin(2 * np.pi * 2 * np.linspace(0, 1, 500)), np.arange(10, 60))
    print(f"find_peaks_cwt located maxima at samples {[int(p) for p in peaks]}")

    # 8. Savitzky-Golay smoothing, then find_peaks on the smoothed pulses
    n = 4000
    pulses = 0.2 * rng.normal(size=n)
    for c in range(200, n, 400):
        pulses += np.exp(-0.5 * ((np.arange(n) - c) / 12.0) ** 2)
    sg = M.savgol_filter(pulses, 31, 3)
    found, _ = M.find_peaks(sg, height=0.5, distance=100)
    print(f"savgol + find_peaks: {len(found)} pulses, first at {found[0]}, last at {found[-1]}")

    # 9. 2-D: Gaussian blur, Wiener denoise, median filter of a noisy image
    img = np.outer(np.hanning(64), np.hanning(64)) + 0.1 * rng.normal(size=(64, 64))
    g = np.exp(-0.5 * ((np.arange(9) - 4) / 2.0) ** 2)
    blur = host(M.convolve2d(img, np.outer(g, g) / g.sum() ** 2, "same", boundary="symm"))
    den = host(M.wiener(img, 5))
    med = host(M.medfilt2d(img, 3))
    clean = np.outer(np.hanning(64), np.hanning(64))
    errs = [np.sqrt(np.mean((a - clean) ** 2)) for a in (img, blur, den, med)]
    print("2-D rms error noisy / blur / wiener / median: "
          + " / ".join(f"{e:.3f}" for e in errs))

    # 10. one FFT sanity check through the kernel chain
    x = rng.normal(size=4096)
    err = np.abs(host(gfft.fft(x)) - np.fft.fft(x)).max()
    print(f"fft parity vs numpy at n=4096: {err:.2e}")


if __name__ == "__main__":
    main()
