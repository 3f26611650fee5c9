"""godsp_tpu_torch's waveforms, linear filtering and resampling
(models/waveforms.py, models/filter.py, models/_resample_impl.py) against
godsp_tpu, and the slice end to end.

The port runs on the CPU in float64 and is held to godsp_tpu (JAX on the
CPU, x64) on the same seeded numpy inputs at go-dsp's 1e-8 abs-or-rel
bound (dsputils.pretty_close).  The cases follow the waveform, filter and
resampling cases of tests/test_models.py and tests/test_design.py as
parametrised cases.  The route test sends float32 CPU tensors down the
CUDA route (kernel_route patched, the wrappers counting), so the wrappers
run their plain versions and show which kernels a convolution reaches: a
pad past 16384 takes the large plan (K8, then K1/K2 rows), a smaller one
K1 forward and K2 inverse.
"""

import functools

import numpy as np
import pytest
import scipy.signal as ss
import torch

import godsp_tpu.models as J
import godsp_tpu_torch.models as P
from godsp_tpu_torch import default_device, dsputils, set_default_device
from godsp_tpu_torch.fft import core, large, pow2
from godsp_tpu_torch.ops import cuda_fft, cuda_outer, launch_counts, reset_launch_counts


@pytest.fixture(autouse=True)
def _host_data_on_cpu():
    """Host data goes to the CPU here; the port's default device is the card."""
    old = default_device()
    set_default_device("cpu")
    yield
    set_default_device(old)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _hold(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _hold(g, w)
        return
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    close = dsputils.pretty_close_c if np.iscomplexobj(want) else dsputils.pretty_close
    assert close(got, want)


RNG = np.random.default_rng(8)
X = RNG.normal(size=(3, 700))
XC = X + 1j * RNG.normal(size=X.shape)
TAPS = RNG.normal(size=41)
T = np.linspace(0.0, 1.0, 500)

# ------------------------------------------------------------- waveforms

WAVEFORMS = [
    ("chirp", (T, 5.0, 1.0, 60.0), {"method": "linear", "phi": 30.0}),
    ("chirp", (T, 5.0, 1.0, 60.0), {"method": "quadratic"}),
    ("chirp", (T, 5.0, 1.0, 60.0), {"method": "quadratic", "vertex_zero": False}),
    ("chirp", (T, 5.0, 1.0, 60.0), {"method": "logarithmic"}),
    ("chirp", (T, 60.0, 1.0, 5.0), {"method": "hyperbolic"}),
    ("sweep_poly", (T, [2.0, -1.0, 3.0, 10.0]), {"phi": 45.0}),
    ("gausspulse", (T - 0.5, 20.0), {"bw": 0.3, "retquad": True, "retenv": True}),
    ("square", (T * 40,), {"duty": 0.3}),
    ("square", (T * 40,), {}),
    ("sawtooth", (T * 40,), {"width": 0.0}),
    ("sawtooth", (T * 40,), {"width": 0.5}),
    ("sawtooth", (T * 40,), {"width": 1.0}),
    ("unit_impulse", (7,), {}),
    ("unit_impulse", ((4, 6), "mid"), {}),
    ("unit_impulse", (9, 3), {}),
]


@pytest.mark.parametrize("name,args,kw", WAVEFORMS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(WAVEFORMS)])
def test_waveforms_match_godsp_tpu(name, args, kw):
    _hold(getattr(P, name)(*args, **kw), getattr(J, name)(*args, **kw))


@pytest.mark.parametrize("kw", [{"nbits": 10}, {"nbits": 7, "length": 300},
                                {"nbits": 5, "state": [1, 0, 0, 1, 0]},
                                {"nbits": 8, "taps": [6, 5, 1], "length": 100}])
def test_max_len_seq_matches_godsp_tpu_and_scipy(kw):
    got = P.max_len_seq(**kw)
    for want in (J.max_len_seq(**kw), ss.max_len_seq(**kw)):
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert got[0].dtype == np.int8


# ---------------------------------------------------------------- filter

FILTER = [
    ("fftconvolve", (X, TAPS), {"mode": "full"}),
    ("fftconvolve", (X, TAPS), {"mode": "same"}),
    ("fftconvolve", (TAPS, X[0]), {"mode": "valid"}),
    ("fftconvolve", (XC, TAPS[:9]), {}),
    ("fftconvolve", (X[:, :40], X[:2, :7]), {"mode": "same", "axes": (0, 1)}),
    ("fftconvolve", (XC[:, :30], X[:, :5]), {"axes": -1}),
    ("convolve", (X[0], TAPS), {"method": "direct"}),
    ("oaconvolve", (X[0], TAPS), {"mode": "same"}),
    ("correlate", (X, TAPS), {}),
    ("correlate", (XC[0], XC[1, :50]), {"mode": "same"}),
    ("correlate", (X[:, :40], X[:2, :7]), {"mode": "valid", "axes": (0, 1)}),
    ("medfilt", (X,), {"kernel_size": 5}),
    ("medfilt", (X[0],), {}),
    ("fir_filter", (X, TAPS), {}),
    ("overlap_save", (X, TAPS), {}),
    ("overlap_save", (XC, TAPS[:17]), {"block": 64}),
    ("envelope", (X[0],), {}),
    ("envelope", (X,), {"bp_in": (5, 120), "n_out": 333, "squared": True}),
    ("envelope", (X.T,), {"bp_in": (5, 120), "residual": "all", "axis": 0}),
    ("envelope", (XC[0],), {"bp_in": (-40, 90), "n_out": 256, "residual": None}),
    ("envelope", (XC[0],), {"bp_in": (-40, 90), "n_out": 500}),
]


@pytest.mark.parametrize("name,args,kw", FILTER, ids=[f"{c[0]}-{i}" for i, c in enumerate(FILTER)])
def test_filter_matches_godsp_tpu(name, args, kw):
    _hold(getattr(P, name)(*args, **kw), getattr(J, name)(*args, **kw))


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_correlation_lags_and_scipy(mode):
    _hold(P.correlation_lags(700, 41, mode), J.correlation_lags(700, 41, mode))
    _hold(P.correlation_lags(41, 700, mode), ss.correlation_lags(41, 700, mode))
    _hold(P.correlate(X[0], TAPS, mode), ss.correlate(X[0], TAPS, mode))


def test_deconvolve_and_conv_method():
    sig = np.convolve(TAPS[:6], X[0, :30]) + np.r_[np.zeros(30), RNG.normal(size=5)]
    _hold(P.deconvolve(sig, TAPS[:6]), J.deconvolve(sig, TAPS[:6]))
    assert P.choose_conv_method(X[0], TAPS) == "fft"
    method, times = P.choose_conv_method(X[0], TAPS, measure=True)
    assert method == "fft" and times["fft"] > 0


def test_filter_validation():
    for bad in (lambda: P.fftconvolve(X, TAPS, mode="bogus"), lambda: P.medfilt(X, 4),
                lambda: P.overlap_save(X, TAPS, block=16), lambda: P.convolve(X, X, method="x"),
                lambda: P.fftconvolve(TAPS[:3], X[0], "valid", axes=-1),
                lambda: P.envelope(X[0], (300, 10))):
        with pytest.raises(ValueError):
            bad()


# ----------------------------------------------------------- resampling

RESAMPLE = [
    ("resample", (X, 900), {}),
    ("resample", (X, 350), {}),
    ("resample", (XC, 351), {"window": "hann"}),
    ("resample", (X.T, 1000), {"axis": 0, "window": lambda f: np.exp(-f * f)}),
    ("resample", (X[0], 256), {"window": np.hanning(700)}),
    ("resample", (np.fft.fft(X[0]), 500), {"domain": "freq"}),
    ("resample", (X[0], 400), {"t": np.arange(700) * 0.5}),
    ("resample_poly", (X, 3, 2), {}),
    ("resample_poly", (X[0], 160, 441), {}),
    ("resample_poly", (X, 2, 5), {"window": "hamming"}),
    ("resample_poly", (X[0], 3, 1), {"window": TAPS}),
    ("resample_poly", (XC[0], 4, 3), {}),
    ("upfirdn", (TAPS, X, 3, 2), {}),
    ("upfirdn", (TAPS, X.T, 1, 4), {"axis": 0}),
    ("upfirdn", (TAPS[:7], XC[0], 5), {}),
    ("decimate", (X, 4), {}),
    ("decimate", (X, 3), {"ftype": "fir"}),
    ("decimate", (X, 2), {"n": 6, "zero_phase": False}),
    ("decimate", (X, 5), {"ftype": "fir", "zero_phase": False}),
    ("firwin", (51, 0.3), {}),
    ("firwin", (51, 0.3), {"pass_zero": False, "window": "hamming"}),
    ("firwin", (60, [0.2, 0.5]), {"pass_zero": False, "window": ("kaiser", 8.0)}),
    ("firwin", (61, [0.2, 0.5]), {"scale": False}),
    ("firwin2", (51, [0, 0.3, 0.5, 1], [1, 1, 0, 0]), {}),
    ("firwin2", (50, [0, 0.5, 0.5, 1], [1, 1, 0, 0]), {"window": None}),
    ("firwin2", (51, [0, 0.5, 1], [0, 1, 0]), {"antisymmetric": True, "nfreqs": 129}),
    ("kaiser_beta", (60.0,), {}),
    ("kaiser_beta", (30.0,), {}),
    ("kaiser_atten", (51, 0.1), {}),
    ("kaiserord", (65.0, 0.05), {}),
]


@pytest.mark.parametrize("name,args,kw", RESAMPLE,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(RESAMPLE)])
def test_resampling_matches_godsp_tpu(name, args, kw):
    got, want = getattr(P, name)(*args, **kw), getattr(J, name)(*args, **kw)
    if np.ndim(want) == 0 and not isinstance(want, tuple):
        got, want = np.atleast_1d(got), np.atleast_1d(want)
    _hold(got, want)


def test_resampling_matches_scipy():
    _hold(P.resample_poly(X, 160, 441), ss.resample_poly(X, 160, 441, axis=-1))
    _hold(P.upfirdn(TAPS, X, 3, 2), ss.upfirdn(TAPS, X, 3, 2))
    _hold(P.decimate(X, 4), ss.decimate(X, 4))
    _hold(P.firwin(255, 4000 / 22050), ss.firwin(255, 4000 / 22050, window=("kaiser", 5.0)))


# ------------------------------------------------------------ end to end


def test_slice_end_to_end():
    """butter -> sosfiltfilt -> resample_poly -> fftconvolve: the port
    against godsp_tpu step by step and against scipy at the end."""
    x = RNG.normal(size=(2, 4410))
    sos = P.butter(8, 4000, fs=44100, output="sos")
    taps = P.firwin(63, 0.25)
    got = P.fftconvolve(P.resample_poly(P.sosfiltfilt(sos, x), 160, 441), taps, mode="same")
    jsos = J.butter(8, 4000, fs=44100, output="sos")
    want = J.fftconvolve(J.resample_poly(J.sosfiltfilt(jsos, x), 160, 441), J.firwin(63, 0.25),
                         mode="same")
    _hold(got, want)
    ref = ss.fftconvolve(ss.resample_poly(ss.sosfiltfilt(sos, x), 160, 441, axis=-1),
                         taps[None], mode="same")
    assert dsputils.snr_db(_np(got), ref) >= 200.0


# ------------------------------------------------------------------ route


def _counting(mod, name, f):
    @functools.wraps(f)
    def g(*a, **k):
        mod.launches[name] += 1
        return f(*a, **k)
    return g


@pytest.fixture
def cuda_route(monkeypatch):
    """float32/complex64 CPU tensors take the CUDA route; each wrapper
    counts its launch and runs its plain version."""
    def route(x):
        n = x.shape[-1]
        return x.dtype in (torch.float32, torch.complex64) and (
            cuda_fft.supported_size(n) or large.large_supported(n))

    for mod in (pow2, core):
        monkeypatch.setattr(mod, "kernel_route", route)
    for mod, name in ((cuda_fft, "fft_pow2"), (cuda_fft, "ifft_pow2"),
                      (cuda_outer, "outer_dft_split")):
        monkeypatch.setattr(mod, name, _counting(mod, name, getattr(mod, name)))
    reset_launch_counts()


@pytest.mark.parametrize("n,want", [(5000, {"fft_pow2": 2, "ifft_pow2": 1}),
                                    (40000, {"outer_dft_split": 3, "fft_pow2": 2,
                                             "ifft_pow2": 1})])
def test_fftconvolve_routes_through_the_kernels(cuda_route, n, want):
    x = torch.from_numpy(RNG.normal(size=n).astype(np.float32))
    taps = TAPS.astype(np.float32)
    got = P.fftconvolve(x, taps)
    counts = {k: v for k, v in launch_counts().items() if v}
    assert counts == want
    assert dsputils.snr_db(_np(got), ss.fftconvolve(x.double().numpy(), taps)) >= 120.0
