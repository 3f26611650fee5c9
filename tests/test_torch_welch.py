"""Parity of godsp_tpu_torch's scipy-convention spectra with godsp_tpu.

welch, welch_csd, welch_coherence, spectrogram_scipy, lombscargle and
stream_welch, the window catalogue (get_window, window.windows) and the
dsputils primitives (detrend, segment, ...) are held to the JAX package
at go-dsp's 1e-8 abs-or-rel bound on the CPU in float64.  The fused
branches (K4, K7, K5 on the card) are reached on the CPU through the
`fused_on_cpu` fixture, where the wrappers run their plain versions.
"""

import numpy as np
import pytest
import torch

from godsp_tpu import dsputils as jdsp
from godsp_tpu import spectral as jspec
from godsp_tpu import window as jwin
from godsp_tpu.parallel import stream_welch as jstream_welch
from godsp_tpu_torch import default_device, dsputils, parallel, set_default_device, spectral, window
from godsp_tpu_torch.models import _stft_impl
from godsp_tpu_torch.ops import cuda_csd, cuda_pwelch, cuda_stft
from godsp_tpu_torch.spectral import _pwelch_impl, _welch_impl


@pytest.fixture(autouse=True)
def _host_data_on_cpu():
    """Host data goes to the CPU here; the port's default device is the card."""
    old = default_device()
    set_default_device("cpu")
    yield
    set_default_device(old)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want) -> bool:
    """go-dsp's 1e-8 abs-or-rel bound, componentwise for complex values."""
    return dsputils.pretty_close(_np(got), np.asarray(want))


@pytest.fixture
def fused_on_cpu(monkeypatch):
    """Route CPU tensors through the fused branches (the K4/K5/K7 wrappers
    then run their plain versions) and count each wrapper's calls."""
    calls = {}

    def spy(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)

        monkeypatch.setattr(mod, name, wrapped)

    spy(cuda_pwelch, "pwelch_power_sum")
    spy(cuda_csd, "csd_power_sum")
    spy(cuda_stft, "stft_power")
    for mod in (_pwelch_impl, _stft_impl):
        monkeypatch.setattr(mod, "fused_path_eligible",
                            lambda x, nfft, pad, stride: cuda_pwelch.fused_supported(nfft, pad,
                                                                                     stride))
    return calls


def _signals(n=4224, seed=0):
    """x and a correlated y; 4224 samples give an even 32 segments at
    nperseg 256, hop 128."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n)
    return x, 0.5 * np.roll(x, 5) + rng.normal(size=n)


def _detrend_first(frames):
    """A callable detrend both packages accept."""
    return frames - frames[..., :1]


WINDOW_ARRAY = np.hanning(256) + 0.1

# welch / welch_csd keyword cases: windows (name, tuple, array), detrend
# (constant, linear, False, callable), scaling, mean and median at an
# even and an odd segment count, nfft > nperseg (odd included).
WELCH_CASES = {
    "default": dict(),
    "fs_hop": dict(fs=2.0, nperseg=512, noverlap=384, window="hamming"),
    "nfft_gt": dict(nperseg=256, nfft=512),
    "odd_nfft": dict(nperseg=200, nfft=301),
    "odd_nperseg": dict(nperseg=255, nfft=255),
    "linear": dict(nperseg=256, detrend="linear"),
    "no_detrend": dict(nperseg=256, detrend=False),
    "callable_detrend": dict(nperseg=256, detrend=_detrend_first),
    "spectrum": dict(nperseg=256, scaling="spectrum"),
    "median_even": dict(nperseg=256, average="median"),
    "median_odd": dict(nperseg=256, noverlap=64, average="median"),
    "kaiser_tuple": dict(window=("kaiser", 8.0), nperseg=256),
    "array_window": dict(window=WINDOW_ARRAY, nperseg=256),
    "two_sided": dict(nperseg=256, return_onesided=False),
}


@pytest.mark.parametrize("case", sorted(WELCH_CASES))
def test_welch_matches_jax(case):
    kw = WELCH_CASES[case]
    x, _ = _signals()
    f1, p1 = spectral.welch(x, **kw)
    f2, p2 = jspec.welch(x, **kw)
    assert _close(f1, f2) and _close(p1, p2)


@pytest.mark.parametrize("case", sorted(WELCH_CASES))
def test_welch_csd_matches_jax(case):
    kw = WELCH_CASES[case]
    x, y = _signals()
    f1, p1 = spectral.welch_csd(x, y, **kw)
    f2, p2 = jspec.welch_csd(x, y, **kw)
    assert p1.dtype == torch.complex128
    assert _close(f1, f2) and _close(p1, p2)


@pytest.mark.parametrize("name", ["welch_csd", "welch_coherence"])
def test_cross_spectra_put_host_y_on_x_device(name):
    """A CPU tensor x asks for the CPU: host-data y follows it there even
    when the default device is the card."""
    x, y = _signals()
    set_default_device("cuda")
    f1, p1 = getattr(spectral, name)(torch.from_numpy(x), y, nperseg=256)
    f2, p2 = getattr(jspec, name)(x, y, nperseg=256)
    assert p1.device.type == "cpu"
    assert _close(f1, f2) and _close(p1, p2)


def test_median_of_an_even_count_averages_the_middle_pair():
    p = torch.tensor([[4.0], [1.0], [3.0], [2.0]], dtype=torch.float64)
    assert float(_welch_impl._median(p)) == 2.5
    assert float(_welch_impl._median(p[:3])) == 3.0


def test_complex_input_is_two_sided():
    rng = np.random.default_rng(1)
    z1 = rng.normal(size=2048) + 1j * rng.normal(size=2048)
    z2 = rng.normal(size=2048) + 1j * rng.normal(size=2048)
    for kw in (dict(nperseg=200, nfft=300, average="median"),):
        f1, p1 = spectral.welch(z1, fs=5.0, **kw)
        f2, p2 = jspec.welch(z1, fs=5.0, **kw)
        assert _close(f1, f2) and _close(p1, p2)
        assert _close(spectral.welch_csd(z1, z2, **kw)[1], jspec.welch_csd(z1, z2, **kw)[1])
        # a complex and a real signal: two-sided as well
        assert _close(spectral.welch_csd(z1, z2.real, **kw)[1],
                      jspec.welch_csd(z1, z2.real, **kw)[1])


def test_batched_axis0_and_coherence():
    rng = np.random.default_rng(2)
    xb = rng.normal(size=(2176, 3))
    yb = xb + rng.normal(size=(2176, 3))
    for kw in (dict(nperseg=128, noverlap=32, axis=0, detrend="linear"),):
        assert _close(spectral.welch(xb, **kw)[1], jspec.welch(xb, **kw)[1])
        assert _close(spectral.welch_csd(xb, yb, **kw)[1], jspec.welch_csd(xb, yb, **kw)[1])
        f1, c1 = spectral.welch_coherence(xb, yb, fs=4.0, **kw)
        f2, c2 = jspec.welch_coherence(xb, yb, fs=4.0, **kw)
        assert _close(f1, f2) and _close(c1, c2)


def test_self_csd_is_welch():
    x, _ = _signals()
    for kw in (dict(nperseg=256), dict(nperseg=200, nfft=301, detrend="linear")):
        pxx = spectral.welch(x, **kw)[1]
        pself = spectral.welch_csd(x, x, **kw)[1]
        assert dsputils.pretty_close(_np(pself.real), _np(pxx))
        assert float(pself.imag.abs().max()) <= 1e-12 * float(pxx.max())


FUSED_CASES = {
    "hop128": dict(nperseg=256),
    "hop156": dict(nperseg=256, noverlap=100),
    "nperseg200_nfft256": dict(nperseg=200, nfft=256, noverlap=40),
    "spectrum": dict(nperseg=256, nfft=1024, scaling="spectrum", window=("tukey", 0.3)),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_branches_match_jax(fused_on_cpu, case):
    kw = dict(FUSED_CASES[case], detrend=False)
    x, y = _signals(n=3000)
    xb, yb = np.stack([x, y]), np.stack([y, x])
    assert _close(spectral.welch(xb, fs=3.0, **kw)[1], jspec.welch(xb, fs=3.0, **kw)[1])
    assert _close(spectral.welch_csd(xb, yb, fs=3.0, **kw)[1],
                  jspec.welch_csd(xb, yb, fs=3.0, **kw)[1])
    f1, t1, s1 = spectral.spectrogram_scipy(x, fs=3.0, **kw)
    f2, t2, s2 = jspec.spectrogram_scipy(x, fs=3.0, **kw)
    assert _close(f1, f2) and _close(t1, t2) and _close(s1, s2)
    assert fused_on_cpu == {"pwelch_power_sum": 1, "csd_power_sum": 1, "stft_power": 1}


def test_unfused_conditions_bypass_the_kernels(fused_on_cpu):
    x, y = _signals(n=3000)
    for kw in (dict(detrend="constant"), dict(detrend=False, average="median"),
               dict(detrend=False, return_onesided=False), dict(detrend=False, nfft=301)):
        spectral.welch(x, nperseg=256, **kw)
        spectral.welch_csd(x, y, nperseg=256, **kw)
    spectral.spectrogram_scipy(x, nperseg=256, mode="magnitude", detrend=False)
    assert fused_on_cpu == {}


SPECTROGRAM_CASES = {
    "default": dict(fs=4.0),
    "hop": dict(nperseg=512, noverlap=128),
    "nfft_gt": dict(nperseg=256, nfft=512),
    "hann": dict(window="hann", nperseg=256, noverlap=128),
    "magnitude": dict(nperseg=256, mode="magnitude"),
    "complex": dict(nperseg=256, mode="complex"),
    "spectrum": dict(nperseg=256, scaling="spectrum"),
    "linear": dict(nperseg=256, detrend="linear"),
    "two_sided": dict(nperseg=256, return_onesided=False),
    "odd_nfft": dict(nperseg=100, nfft=151, detrend=False),
}


@pytest.mark.parametrize("case", sorted(SPECTROGRAM_CASES))
def test_spectrogram_scipy_matches_jax(case):
    kw = SPECTROGRAM_CASES[case]
    x, _ = _signals(n=4096)
    f1, t1, s1 = spectral.spectrogram_scipy(x, **kw)
    f2, t2, s2 = jspec.spectrogram_scipy(x, **kw)
    assert _close(f1, f2) and _close(t1, t2) and _close(s1, s2)


def test_spectrogram_scipy_complex_input():
    rng = np.random.default_rng(3)
    z = rng.normal(size=(2, 2048)) + 1j * rng.normal(size=(2, 2048))
    for mode in ("psd", "complex"):
        got = spectral.spectrogram_scipy(z, nperseg=256, mode=mode)[2]
        assert _close(got, jspec.spectrogram_scipy(z, nperseg=256, mode=mode)[2])


@pytest.mark.parametrize("precenter,normalize", [(False, False), (True, False), (True, True)])
def test_lombscargle_matches_jax(precenter, normalize):
    rng = np.random.default_rng(4)
    t = np.sort(rng.uniform(0.0, 20.0, size=700))
    y = np.sin(2.1 * t) + 0.3 * rng.normal(size=t.size) + 0.5
    freqs = np.linspace(0.05, 6.0, 97)
    got = spectral.lombscargle(t, y, freqs, precenter=precenter, normalize=normalize)
    want = jspec.lombscargle(t, y, freqs, precenter=precenter, normalize=normalize)
    assert got.dtype == torch.float64 and _close(got, want)


@pytest.mark.parametrize("kw", [dict(nperseg=256), dict(nperseg=256, noverlap=64, nfft=512),
                                dict(nperseg=255, nfft=301), dict(nperseg=256, scaling="spectrum")],
                         ids=["default", "nfft512", "odd_nfft", "spectrum"])
def test_stream_welch_matches_jax(kw):
    rng = np.random.default_rng(5)
    x = rng.normal(size=20000)
    blocks = [x[i : i + 3001] for i in range(0, x.size, 3001)]  # unaligned with the hop
    f1, p1 = parallel.stream_welch(iter(blocks), fs=4.0, **kw)
    f2, p2 = jstream_welch(iter(blocks), fs=4.0, **kw)
    assert _close(f1, f2) and _close(p1, p2)
    # and the one-shot welch without detrend
    assert _close(p1, spectral.welch(x, fs=4.0, detrend=False, **kw)[1])


def test_validation():
    z = np.zeros(100)
    for call in (
        lambda: spectral.welch(z, nperseg=64, noverlap=64),
        lambda: spectral.welch(z, nperseg=64, nfft=32),
        lambda: spectral.welch(z, scaling="bogus"),
        lambda: spectral.welch(z, average="bogus"),
        lambda: spectral.welch(z, detrend="bogus"),
        lambda: spectral.welch(z, nperseg=64, window=np.ones(63)),
        lambda: spectral.welch_csd(z, np.zeros(99)),
        lambda: spectral.spectrogram_scipy(z, mode="bogus"),
        lambda: spectral.lombscargle(np.ones((2, 2)), np.ones(2), np.ones(2)),
        lambda: spectral.lombscargle(np.ones(3), np.ones(2), np.ones(2)),
        lambda: parallel.stream_welch(iter([np.zeros(512)]), nperseg=256, nfft=128),
        lambda: parallel.stream_welch(iter([np.zeros(512)]), scaling="bogus"),
    ):
        with pytest.raises(ValueError):
            call()
    with pytest.raises(TypeError, match="Mesh"):
        parallel.stream_welch(iter([z]), mesh=object())
    f, p = spectral.welch(np.zeros(0))
    assert f.shape == (0,) and p.shape == (0,)
    f, p = spectral.welch_csd(np.zeros((2, 0)), np.zeros((2, 0)))
    assert f.shape == (0,) and p.shape == (2, 0)


# ---------------------------------------------------------------- windows and dsputils

WINDOW_SPECS = [
    "hann", "hamming", "boxcar", "bartlett", "blackman", "flattop", "blackmanharris",
    "nuttall", "triang", "parzen", "bohman", "barthann", "cosine", "lanczos", 8.0,
    ("kaiser", 6.0), ("tukey", 0.25), ("tukey", 1.0), ("gaussian", 7.0),
    ("general_gaussian", 1.5, 7.0), ("chebwin", 80.0), ("exponential", None, 3.0),
    ("taylor",), ("dpss", 3.0),
]


@pytest.mark.parametrize("spec", WINDOW_SPECS, ids=str)
def test_get_window_matches_jax(spec):
    for n in (16, 51):
        for fftbins in (True, False):
            got = window.get_window(spec, n, fftbins=fftbins)
            want = jwin.get_window(spec, n, fftbins=fftbins)
            assert got.dtype == np.float64 and _close(got, want), (n, fftbins)


def test_windows_namespace_matches_jax():
    from godsp_tpu.window import windows as jw

    for n in (8, 33):
        for sym in (True, False):
            assert _close(window.windows.general_cosine(n, [0.5, 0.3, 0.2], sym),
                          jw.general_cosine(n, [0.5, 0.3, 0.2], sym))
            assert _close(window.windows.general_hamming(n, 0.6, sym), jw.general_hamming(n, 0.6, sym))
            assert _close(window.windows.kaiser(n, 5.0, sym), jw.kaiser(n, 5.0, sym))
            assert _close(window.windows.hann(n, sym), jw.hann(n, sym))
            assert _close(window.windows.dpss(n, 2.5, 3, sym), jw.dpss(n, 2.5, 3, sym))
    assert _close(window.windows.kaiser_bessel_derived(32, 4.0), jw.kaiser_bessel_derived(32, 4.0))
    with pytest.raises(ValueError):
        window.get_window("no_such_window", 8)


@pytest.mark.parametrize("kind", ["constant", "linear"])
def test_detrend_matches_jax(kind):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(5, 37)) + np.arange(37) * 0.3
    z = x + 1j * rng.normal(size=(5, 37))
    for arr, axis in ((x, 0), (z, -1)):
        got = dsputils.detrend(arr, type=kind, axis=axis)
        assert _close(got, jdsp.detrend(arr, type=kind, axis=axis))
    ints = np.arange(12)
    assert _close(dsputils.detrend(ints, type=kind), jdsp.detrend(ints, type=kind))
    with pytest.raises(ValueError):
        dsputils.detrend(x, type="quadratic")


def test_dsputils_primitives_match_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 100))
    assert _close(dsputils.to_complex(x), jdsp.to_complex(x))
    assert _close(dsputils.to_complex_2(x), jdsp.to_complex_2(x))
    assert _close(dsputils.zero_pad_2(x), jdsp.zero_pad_2(x))
    assert _close(dsputils.zero_pad_f(x, 130), jdsp.zero_pad_f(x, 130))
    for segs, nov in ((4, 0.5), (3, 0.9)):
        assert dsputils.segment_bounds(100, segs, nov) == jdsp.segment_bounds(100, segs, nov)
        assert _close(dsputils.segment(x, segs, nov), jdsp.segment(x, segs, nov))
    with pytest.raises(ValueError, match="too many segments"):
        dsputils.segment_bounds(10, 11, 0.0)
