"""Parity of godsp_tpu_torch's ShortTimeFFT (models/shorttime.py) with godsp_tpu.

The cases of tests/test_shorttime.py as parametrised cases.  The port
runs on the CPU in float64 and is held to godsp_tpu's ShortTimeFFT (JAX
on the CPU, x64) on the same seeded inputs at go-dsp's 1e-8 abs-or-rel
bound (dsputils.pretty_close) and to scipy.signal.ShortTimeFFT at the
JAX tests' own absolute bounds (1e-10 for spectra, 1e-9 for detrended
spectra and round trips, 1e-8 in the seeded sweep).  The host-side
geometry is the same code in both packages and must agree exactly.
"""

import numpy as np
import pytest
import scipy.signal as ss
import scipy.signal.windows as sw
import torch

from godsp_tpu import models as jmodels
from godsp_tpu_torch import default_device, dsputils, models, set_default_device
from godsp_tpu_torch.models import ShortTimeFFT, closest_STFT_dual_window


@pytest.fixture(autouse=True)
def _host_data_on_cpu():
    """Host data goes to the CPU here; the port's default device is the card."""
    old = default_device()
    set_default_device("cpu")
    yield
    set_default_device(old)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def cmp(a, b, tol=1e-10):
    a, b = _np(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol)


def hold(got, jax_out, ref, tol=1e-10):
    """got against godsp_tpu at 1e-8 abs-or-rel and scipy at tol absolute."""
    assert dsputils.pretty_close(_np(got), np.asarray(jax_out))
    cmp(got, ref, tol)


def trio(*a, **k):
    return ShortTimeFFT(*a, **k), jmodels.ShortTimeFFT(*a, **k), ss.ShortTimeFFT(*a, **k)


SIG = np.random.default_rng(0).normal(size=57)

CONFIGS = [
    (8, 3, "onesided", "zeros", None, 0),
    (9, 4, "twosided", "even", None, 0),
    (8, 2, "centered", "edge", 16, 0),
    (7, 3, "onesided", "odd", 12, 0),
    (8, 3, "twosided", "zeros", None, None),
    (8, 3, "twosided", "zeros", None, 2),
]


@pytest.mark.parametrize("wlen,hop,mode,pad,mfft,pshift", CONFIGS)
def test_attributes_stft_istft(wlen, hop, mode, pad, mfft, pshift):
    w = sw.gaussian(wlen, wlen / 4, sym=True)
    mine, jx, ref = trio(w, hop=hop, fs=8.0, fft_mode=mode, mfft=mfft, phase_shift=pshift)
    n = len(SIG)
    for att in ["p_min", "k_min", "m_num", "m_num_mid", "f_pts", "delta_t", "delta_f"]:
        assert getattr(mine, att) == getattr(jx, att), att
        assert np.allclose(getattr(mine, att), getattr(ref, att)), att
    assert mine.p_max(n) == ref.p_max(n) and mine.k_max(n) == ref.k_max(n)
    assert mine.lower_border_end == ref.lower_border_end
    assert mine.upper_border_begin(n) == ref.upper_border_begin(n)
    np.testing.assert_allclose(mine.f, ref.f, rtol=1e-12)
    np.testing.assert_allclose(mine.t(n), ref.t(n), rtol=1e-12)
    np.testing.assert_allclose(mine.dual_win, ref.dual_win, rtol=1e-10)
    hold(mine.stft(SIG, padding=pad), jx.stft(SIG, padding=pad), ref.stft(SIG, padding=pad))
    back = mine.istft(mine.stft(SIG), k1=n)
    hold(back, jx.istft(jx.stft(SIG), k1=n), SIG, 1e-9)


@pytest.mark.parametrize("scale", ["psd", "magnitude"])
def test_scaling_modes(scale):
    w = sw.hann(10, sym=True)
    mine, jx, ref = trio(w, hop=4, fs=16.0, scale_to=scale)
    hold(mine.stft(SIG), jx.stft(SIG), ref.stft(SIG))
    assert mine.fac_psd == jx.fac_psd and abs(mine.fac_psd - ref.fac_psd) < 1e-12
    assert abs(mine.fac_magnitude - ref.fac_magnitude) < 1e-12
    for s in (mine, jx, ref):
        s.fft_mode = "onesided2X"
    hold(mine.stft(SIG), jx.stft(SIG), ref.stft(SIG))
    cmp(mine.istft(mine.stft(SIG), k1=len(SIG)), SIG, 1e-9)


def test_onesided2X_needs_scaling():
    mine = ShortTimeFFT(sw.hann(8, sym=True), hop=4, fs=1.0)
    with pytest.raises(ValueError):
        mine.fft_mode = "onesided2X"


@pytest.mark.parametrize("detr", [None, "linear", "constant", "callable"])
def test_spectrogram_and_detrend(detr):
    w = sw.gaussian(8, 2, sym=True)
    mine, jx, ref = trio(w, hop=3, fs=1.0)
    if detr is None:
        hold(mine.spectrogram(SIG), jx.spectrogram(SIG), ref.spectrogram(SIG))
        return
    if detr == "callable":  # the slices' mean, as a callable detrend
        hold(mine.stft_detrend(SIG, lambda f: f - f.mean(-1, keepdims=True)),
             jx.stft_detrend(SIG, lambda f: f - f.mean(-1, keepdims=True)),
             ref.stft_detrend(SIG, "constant"), 1e-9)
        return
    hold(mine.stft_detrend(SIG, detr), jx.stft_detrend(SIG, detr), ref.stft_detrend(SIG, detr),
         1e-9)


@pytest.mark.parametrize("shape,axis", [((57,), -1), ((3, 57), -1), ((57, 3), 0),
                                        ((2, 57, 3), 1)])
def test_from_window_and_axes(shape, axis):
    mine = ShortTimeFFT.from_window(("kaiser", 5.0), 8.0, 12, 8)
    jx = jmodels.ShortTimeFFT.from_window(("kaiser", 5.0), 8.0, 12, 8)
    ref = ss.ShortTimeFFT.from_window(("kaiser", 5.0), 8.0, 12, 8)
    x = np.random.default_rng(len(shape)).normal(size=shape)
    hold(mine.stft(x, axis=axis), jx.stft(x, axis=axis), ref.stft(x, axis=axis))


def test_invertible_gap():
    assert ShortTimeFFT(np.ones(4), hop=4, fs=1.0).invertible
    assert not ShortTimeFFT(np.ones(4), hop=6, fs=1.0).invertible


@pytest.mark.parametrize("call", [
    lambda M: M.ShortTimeFFT(np.ones((2, 2)), hop=1, fs=1.0),
    lambda M: M.ShortTimeFFT(np.ones(8), hop=0, fs=1.0),
    lambda M: M.ShortTimeFFT(np.ones(8), hop=2, fs=1.0, mfft=4),
    lambda M: M.ShortTimeFFT(np.ones(8), hop=2, fs=1.0, fft_mode="bogus"),
    lambda M: M.ShortTimeFFT(np.ones(8), hop=2, fs=1.0).stft(np.zeros(64), padding="bogus"),
    lambda M: M.ShortTimeFFT.from_window("hann", 1.0, 8, 8),
    lambda M: M.ShortTimeFFT(sw.hann(8, sym=True), hop=3, fs=1.0).stft(np.zeros(32) + 0j),
    lambda M: M.closest_STFT_dual_window(np.ones(8), 0),
    lambda M: M.closest_STFT_dual_window(np.ones(8), 4, np.ones(7)),
    lambda M: M.closest_STFT_dual_window(np.tile(np.r_[np.ones(2), np.zeros(2)], 2), 4),
], ids=["2d-win", "hop0", "mfft", "mode", "padding", "noverlap", "onesided-complex",
        "dual-hop0", "dual-shape", "dual-gap"])
def test_validation_matches_jax(call):
    with pytest.raises(ValueError) as want:
        call(jmodels)
    with pytest.raises(ValueError) as got:
        call(models)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("k0,k1", [(5, 40), (10, 57), (0, 20)])
def test_partial_istft_ranges(k0, k1):
    mine = ShortTimeFFT(sw.gaussian(8, 2, sym=True), hop=3, fs=8.0)
    Z = mine.stft(SIG)
    full = _np(mine.istft(Z, k1=len(SIG)))
    part = mine.istft(Z, k0=k0, k1=k1)
    cmp(part, full[k0:k1], 0)
    cmp(part, SIG[k0:k1], 1e-9)


def test_twosided_complex_roundtrip():
    rng = np.random.default_rng(9)
    z = rng.normal(size=40) + 1j * rng.normal(size=40)
    mine, jx, ref = trio(sw.gaussian(8, 2, sym=True), hop=3, fs=1.0, fft_mode="twosided")
    g = mine.istft(mine.stft(z), k1=40)
    assert g.dtype.is_complex
    hold(g, jx.istft(jx.stft(z), k1=40), z, 1e-9)
    cmp(g, np.asarray(ref.istft(ref.stft(z), k1=40)), 1e-9)


@pytest.mark.parametrize("wspec,hop", [("hann16p", 4), ("hann9s", 3), ("boxcar7", 7),
                                       ("padded", 3)])
def test_zero_edge_windows(wspec, hop):
    """Geometry follows the window's nonzero support: hann's zero first
    sample does not count as overlap."""
    w = {"hann16p": sw.hann(16, sym=False), "hann9s": sw.hann(9, sym=True),
         "boxcar7": sw.boxcar(7), "padded": np.r_[0.0, 0.0, sw.gaussian(6, 1.5), 0.0]}[wspec]
    x = np.random.default_rng(3).normal(size=237)
    mine, jx, ref = trio(w, hop=hop, fs=50.0)
    assert (mine.p_min, mine.k_min, mine.p_max(237), mine.k_max(237)) == \
        (ref.p_min, ref.k_min, ref.p_max(237), ref.k_max(237))
    assert mine.lower_border_end == ref.lower_border_end
    assert mine.upper_border_begin(237) == ref.upper_border_begin(237)
    r = ref.stft(x)
    hold(mine.stft(x), jx.stft(x), r)
    if mine.invertible:
        cmp(mine.istft(mine.stft(x), k1=237), np.asarray(ref.istft(r, k1=237)), 1e-9)


@pytest.mark.parametrize("scaled", [True, False])
def test_closest_dual_window(scaled):
    cases = [(sw.hann(16, sym=False), 4, sw.boxcar(16)),
             (sw.hann(16, sym=False), 4, sw.gaussian(16, 3)),
             (sw.gaussian(18, 4), 5, None),
             (sw.gaussian(12, 3) * np.exp(1j * np.linspace(0, 1, 12)), 3, None)]
    for w, hop, des in cases:
        g, fa = closest_STFT_dual_window(w, hop, des, scaled=scaled)
        j, fj = jmodels.closest_STFT_dual_window(w, hop, des, scaled=scaled)
        r, fr = ss.closest_STFT_dual_window(w, hop, des, scaled=scaled)
        np.testing.assert_array_equal(g, np.asarray(j))
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-12)
        assert fa == fj and abs(fa - fr) < 1e-12


def test_closest_dual_reconstructs():
    w = sw.hann(16, sym=False)
    d, _ = closest_STFT_dual_window(w, 4, sw.gaussian(16, 3))
    x = np.random.default_rng(0).normal(size=100)
    S = ShortTimeFFT(w, 4, fs=1.0, dual_win=d)
    cmp(S.istft(S.stft(x), k1=100), x, 1e-9)


def test_float32_and_torch_input():
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 300)).astype(np.float32))
    mine, _, ref = trio(sw.hann(32, sym=False), hop=8, fs=1.0)
    got = mine.stft(x)
    assert got.dtype == torch.complex64 and got.device.type == "cpu"
    assert dsputils.snr_db(_np(got), ref.stft(x.numpy().astype(np.float64))) >= 120.0


@pytest.mark.parametrize("trial", range(25))
def test_randomized_config_sweep(trial):
    """A seeded draw of (window, hop, mfft, mode, padding, phase shift)
    per case: geometry, stft values and istft round trips against scipy
    and godsp_tpu."""
    rng = np.random.default_rng(1234 + trial)
    x = rng.normal(size=193)
    wlen = int(rng.integers(4, 24))
    hop = int(rng.integers(1, wlen + 1))
    mfft = wlen + int(rng.integers(0, 9))
    mode = ["twosided", "centered", "onesided"][int(rng.integers(0, 3))]
    pad = ["zeros", "edge", "even", "odd"][int(rng.integers(0, 4))]
    w = [sw.gaussian(wlen, wlen / 4, sym=True), sw.hann(wlen, sym=False),
         sw.triang(wlen)][int(rng.integers(0, 3))]
    pshift = [0, None, min(2, mfft - 1)][int(rng.integers(0, 3))]
    mine, jx, ref = trio(w, hop=hop, fs=7.0, fft_mode=mode, mfft=mfft, phase_shift=pshift)
    n = len(x)
    assert (mine.p_min, mine.p_max(n)) == (ref.p_min, ref.p_max(n))
    assert mine.lower_border_end == ref.lower_border_end
    assert mine.upper_border_begin(n) == ref.upper_border_begin(n)
    hold(mine.stft(x, padding=pad), jx.stft(x, padding=pad), ref.stft(x, padding=pad), 1e-8)
    if mine.invertible:
        cmp(mine.istft(mine.stft(x), k1=n), x, 1e-8)


def test_long_reflect_pads_match_numpy():
    """Border pads longer than the signal reflect as numpy.pad does."""
    from godsp_tpu_torch.models.shorttime import _pad

    x = np.random.default_rng(7).normal(size=(2, 5))
    for padding, mode, kw in (("even", "reflect", {}), ("odd", "reflect", {"reflect_type": "odd"}),
                              ("edge", "edge", {}), ("zeros", "constant", {})):
        got = _pad(torch.from_numpy(x), 11, 7, padding)
        np.testing.assert_allclose(_np(got), np.pad(x, [(0, 0), (11, 7)], mode=mode, **kw),
                                   rtol=0, atol=1e-12)
