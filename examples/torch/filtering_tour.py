#!/usr/bin/env python
"""Filtering tour on godsp_tpu_torch: FIR, IIR (parallel scan), zero-phase,
resampling.

The godsp_tpu_torch twin of examples/filtering_tour.py:

  1. fir_filter / overlap_save    — linear FIR over the FFT convolution chain
  2. lfilter / sosfilt            — IIR as a blocked matmul + log-depth scan
  3. filtfilt                     — zero-phase forward-backward
  4. resample_poly                — polyphase rational-rate resampling

  python examples/torch/filtering_tour.py

Host data goes to the card (float32: K1/K2 for the convolutions);
set_default_device("cpu") runs the plain versions in float64.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "..", ".."))

import numpy as np

from godsp_tpu_torch.models import (
    butter,
    decimate,
    filtfilt,
    fir_filter,
    firwin,
    lfilter,
    lfilter_zi,
    resample_poly,
    sosfilt,
)


def host(t):
    return t.detach().cpu().numpy()


def main():
    fs = 8000.0
    t = np.arange(int(fs)) / fs
    # two tones + noise: keep 440 Hz, reject 1800 Hz
    rng = np.random.default_rng(0)
    x = (
        np.sin(2 * np.pi * 440 * t)
        + 0.8 * np.sin(2 * np.pi * 1800 * t)
        + 0.1 * rng.normal(size=t.size)
    ).astype(np.float32)

    def tone_power(y, f):
        y = host(y) if not isinstance(y, np.ndarray) else y
        n = len(y)
        spec = np.fft.rfft(y * np.hanning(n))
        k = int(round(f * n / fs))
        return 20 * np.log10(np.abs(spec[k - 2 : k + 3]).max() + 1e-12)

    # 1. FIR lowpass at 1 kHz (window-method design on the host, filtering
    #    on the device).
    taps = firwin(101, 1000.0 / (fs / 2), window="hamming")
    y_fir = fir_filter(x, taps)
    print(
        f"FIR-101:  440 Hz {tone_power(y_fir, 440) - tone_power(x, 440):+5.1f} dB, "
        f"1800 Hz {tone_power(y_fir, 1800) - tone_power(x, 1800):+5.1f} dB"
    )

    # 2. IIR lowpass: designed on the host (models.design), run as the
    #    parallel-scan SOS cascade on the device.
    sos = butter(6, 1000.0 / (fs / 2), output="sos")
    y_iir = sosfilt(sos, x)
    print(
        f"butter-6: 440 Hz {tone_power(y_iir, 440) - tone_power(x, 440):+5.1f} dB, "
        f"1800 Hz {tone_power(y_iir, 1800) - tone_power(x, 1800):+5.1f} dB"
    )

    # 3. Zero-phase: filtfilt has no group delay — the filtered 440 Hz
    #    tone stays aligned with the input.
    b, a = butter(2, 1000.0 / (fs / 2))
    y_ff = host(filtfilt(b, a, x))
    ref = np.sin(2 * np.pi * 440 * t)
    lag = np.argmax(np.correlate(y_ff[:4000], ref[:4000], "full")) - 3999
    print(f"filtfilt: group delay {lag} samples (expect 0)")

    # 4. Streaming continuity: chunked lfilter with zi/zf chaining equals
    #    the one-shot run.
    zi = host(lfilter_zi(b, a)) * x[0]
    y1, zf = lfilter(b, a, x[:3000], zi=zi)
    y2, _ = lfilter(b, a, x[3000:], zi=zf)
    chunked = np.concatenate([host(y1), host(y2)])
    oneshot, _ = lfilter(b, a, x, zi=zi)
    print(f"chunked == one-shot: {np.abs(chunked - host(oneshot)).max():.2e}")

    # 5. Rate conversion 8 kHz -> 44.1 kHz and back (441/80, 80/441).
    y_up = resample_poly(x, 441, 80)
    y_rt = host(resample_poly(y_up, 80, 441))
    err = np.abs(y_rt[500:-500] - x[500 : len(y_rt) - 500]).max()
    print(f"8k->44.1k->8k: {len(x)} -> {y_up.shape[0]} -> "
          f"{len(y_rt)} samples, interior round-trip err {err:.3f}")

    # 6. Decimation: anti-alias + downsample in one call — the 1800 Hz
    #    tone would alias to 1400 Hz at fs/4 without the filter.
    y_dec = host(decimate(x, 4))
    ref_tone = np.sin(2 * np.pi * 440 * np.arange(len(y_dec)) * 4 / fs)
    corr = np.abs(np.vdot(y_dec, ref_tone)) / (
        np.linalg.norm(y_dec) * np.linalg.norm(ref_tone)
    )
    print(
        f"decimate 4x: {len(x)} -> {len(y_dec)} samples, "
        f"440 Hz tone correlation {corr:.3f}"
    )


if __name__ == "__main__":
    main()
