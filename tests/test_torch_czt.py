"""Parity of godsp_tpu_torch's chirp-z/zoom FFT (fft/_czt_impl.py) and fast
Hankel transform (fft/fftlog.py) with godsp_tpu.

The cases of tests/test_fft.py (TestCZT, TestCztClasses, TestFftlog) as
parametrised cases: the port runs on the CPU in float64 and is held to
godsp_tpu (JAX on the CPU, x64) on the same seeded inputs at go-dsp's
1e-8 abs-or-rel bound (dsputils.pretty_close), and to scipy at the JAX
tests' own bars (>= 200 dB; 180 dB for the plans and the odd round trip).
The route test sends CPU tensors down the CUDA route, so the wrappers run
their plain versions, and shows that a zoom at a pad of 2^15 or more
reaches the large plan (K8 and the rows), as phase 10 of chip_smoke.py
counts on the card.
"""

import numpy as np
import pytest
import scipy.fft as sfft
import scipy.signal as ss
import torch

from godsp_tpu import fft as jfft
from godsp_tpu_torch import default_device, dsputils, fft, set_default_device
from godsp_tpu_torch.fft import core, pow2, split
from godsp_tpu_torch.ops import cuda_fft, cuda_outer

SNR_DB = 200.0


@pytest.fixture(autouse=True)
def _host_data_on_cpu():
    """Host data goes to the CPU here; the port's default device is the card."""
    old = default_device()
    set_default_device("cpu")
    yield
    set_default_device(old)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _hold(got, jax_out, ref, db=SNR_DB):
    got = _np(got)
    assert got.shape == ref.shape
    assert dsputils.pretty_close(got, np.asarray(jax_out))
    assert dsputils.snr_db(got, ref) >= db


# ---------------------------------------------------------------- czt


@pytest.mark.parametrize("n", [16, 37, 100])
def test_default_czt_is_the_dft(n):
    rng = np.random.default_rng(0)
    x = rng.normal(size=n) + 1j * rng.normal(size=n)
    _hold(fft.czt(x), jfft.czt(x), np.fft.fft(x))


@pytest.mark.parametrize("n,m,wa", [(100, 60, None), (37, 37, None), (64, 33, "mild_spiral"),
                                    (128, 65, "band"), (1, 1, None)])
def test_czt_matches_jax_and_scipy(n, m, wa):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n))
    if wa == "mild_spiral":
        w, a = np.exp(-0.001 - 2j * np.pi / m), 1.1 + 0.1j
    elif wa == "band":
        w, a = np.exp(-2j * np.pi * 0.3 / m), np.exp(2j * np.pi * 0.05)
    else:
        w, a = None, 1 + 0j
    _hold(fft.czt(x, m, w, a), jfft.czt(x, m, w, a), ss.czt(x, m, w, a))


# scipy's own _czt.py trips numpy's array-to-scalar deprecation
# internally (not the port's) — keep the oracle, drop its noise.
@pytest.mark.filterwarnings("ignore:Conversion of an array with ndim > 0:DeprecationWarning")
@pytest.mark.parametrize("n,fn,m,fs,ep", [(100, (0.1, 0.4), 50, 2.0, False),
                                          (77, 0.5, None, 2.0, False),
                                          (64, (100.0, 200.0), 40, 1000.0, True)])
def test_zoom_fft_matches_jax_and_scipy(n, fn, m, fs, ep):
    x = np.random.default_rng(n).normal(size=n)
    _hold(fft.zoom_fft(x, fn, m, fs=fs, endpoint=ep), jfft.zoom_fft(x, fn, m, fs=fs, endpoint=ep),
          ss.zoom_fft(x, np.atleast_1d(fn), m, fs=fs, endpoint=ep))


def test_zoom_band_picks_fft_bins():
    x = np.random.default_rng(9).normal(size=128)
    got = fft.zoom_fft(x, (16.0, 48.0), 32, fs=128.0)  # integer bins [16, 48)
    _hold(got, jfft.zoom_fft(x, (16.0, 48.0), 32, fs=128.0), np.fft.fft(x)[16:48])


def test_czt_plan_matches_jax_and_scipy():
    rng = np.random.default_rng(0)
    args = dict(m=64, w=np.exp(-2j * np.pi / 80), a=np.exp(0.3j))
    plan, jplan, ref = fft.CZT(96, **args), jfft.CZT(96, **args), ss.CZT(96, **args)
    for x in (rng.normal(size=96) + 1j * rng.normal(size=96), rng.normal(size=96)):
        _hold(plan(x), jplan(x), ref(x), 180.0)
    np.testing.assert_allclose(plan.points(), ref.points(), rtol=1e-12, atol=1e-13)
    with pytest.raises(ValueError):
        plan(np.zeros(50))


def test_zoom_plan_matches_jax_and_scipy():
    x = np.random.default_rng(1).normal(size=96)
    plan = fft.ZoomFFT(96, [0.2, 0.6], m=48, fs=2.0)
    ref = ss.ZoomFFT(96, [0.2, 0.6], m=48, fs=2.0)
    _hold(plan(x), jfft.ZoomFFT(96, [0.2, 0.6], m=48, fs=2.0)(x), ref(x), 180.0)
    np.testing.assert_allclose(plan.points(), ref.points(), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(fft.czt_points(48, plan.w, plan.a), ref.points(),
                               rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("call", [
    lambda f: f.czt(np.zeros(0, np.complex128)),
    lambda f: f.czt(np.ones(4, np.complex128), m=0),
    lambda f: f.czt(np.ones(4, np.complex128), w=0.0),
    lambda f: f.zoom_fft(np.ones(8), (0.1, 0.2, 0.3)),
    lambda f: f.zoom_fft(np.ones(8), 0.5, m=1, endpoint=True),
    lambda f: f.ZoomFFT(96, [0.1, 0.2, 0.3]),
    lambda f: f.czt_points(0),
], ids=["empty", "m0", "w0", "fn3", "endpoint-m1", "plan-fn3", "points-m0"])
def test_czt_errors_match_jax(call):
    with pytest.raises(ValueError) as want:
        call(jfft)
    with pytest.raises(ValueError) as got:
        call(fft)
    assert str(got.value) == str(want.value)


def test_zoom_at_a_large_pad_reaches_the_large_plan(monkeypatch):
    """n + m - 1 > 2^15: the chirp filter runs at pad 2^16 through the
    large plan (K8, then K1/K2 rows), twice."""
    calls = []
    for mod, name in ((cuda_outer, "outer_dft_split"), (cuda_fft, "fft_pow2"),
                      (cuda_fft, "ifft_pow2")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name,
                            lambda *a, _f=fn, _n=name, **k: calls.append(_n) or _f(*a, **k))
    for mod in (pow2, core, split):
        monkeypatch.setattr(mod, "kernel_route", lambda x: True)
    n, m = 30000, 4096
    x = np.random.default_rng(4).normal(size=n)
    got = fft.zoom_fft(x, (100.0, 4000.0), m, fs=44100.0)
    assert calls == ["outer_dft_split", "fft_pow2", "outer_dft_split", "ifft_pow2"]
    _hold(got, jfft.zoom_fft(x, (100.0, 4000.0), m, fs=44100.0),
          ss.zoom_fft(x, [100.0, 4000.0], m, fs=44100.0), 180.0)


# ---------------------------------------------------------------- fht


R64 = np.logspace(-2, 2, 64)
DLN64 = float(np.log(R64[1] / R64[0]))


@pytest.mark.parametrize("mu,off,q", [(0.5, 0.0, 0.0), (0.0, 0.2, 0.0),
                                      (1.0, sfft.fhtoffset(DLN64, 1.0), 0.0),
                                      (0.5, 0.1, 0.3), (2.0, 0.0, -0.2)])
def test_fht_ifht_match_jax_and_scipy(mu, off, q):
    a = R64 * np.exp(-R64**2 / 2)
    _hold(fft.fht(a, DLN64, mu, offset=off, bias=q), jfft.fht(a, DLN64, mu, offset=off, bias=q),
          sfft.fht(a, DLN64, mu, offset=off, bias=q))
    ref = sfft.fht(a, DLN64, mu, offset=off, bias=q)
    _hold(fft.ifht(ref, DLN64, mu, offset=off, bias=q),
          jfft.ifht(ref, DLN64, mu, offset=off, bias=q),
          sfft.ifht(ref, DLN64, mu, offset=off, bias=q))


@pytest.mark.parametrize("args", [(0.14387, 0.5), (0.14387, 0.5, -1.0, 0.2), (0.05, 2.0, 0.3, 0.0)])
def test_fhtoffset_matches_jax_and_scipy(args):
    assert fft.fhtoffset(*args) == jfft.fhtoffset(*args)
    assert abs(fft.fhtoffset(*args) - sfft.fhtoffset(*args)) < 1e-12


def test_fht_round_trip_odd_batched():
    r = np.logspace(-1, 1, 65)
    a = np.stack([r * np.exp(-r), r**2 * np.exp(-r)])
    dln = float(np.log(r[1] / r[0]))
    off = fft.fhtoffset(dln, 0.5)
    A = fft.fht(a, dln, 0.5, offset=off)
    assert dsputils.pretty_close(_np(A), np.asarray(jfft.fht(a, dln, 0.5, offset=off)))
    assert dsputils.snr_db(_np(fft.ifht(A, dln, 0.5, offset=off)), a) >= 180.0


def test_reversed_host_views_are_taken():
    """Host data with negative strides (a reversed view, as scipy.fft.fht
    returns) goes in as godsp_tpu takes it."""
    x = np.random.default_rng(8).normal(size=(3, 100))
    rev = x[:, ::-1]
    assert rev.strides[-1] < 0
    _hold(fft.fft(rev), jfft.fft(rev), np.fft.fft(rev))
    _hold(fft.czt(rev[0], 40), jfft.czt(rev[0], 40), ss.czt(rev[0], 40))
