"""godsp_tpu_torch's peak finding (models/peaks.py) against godsp_tpu and
scipy, and the slice end to end (savgol_filter -> find_peaks).

peaks.py is host float64 numpy in both packages: indices must be equal
and every property within go-dsp's 1e-8 abs-or-rel bound
(dsputils.pretty_close).  A tensor given to a peak function is brought to
the host once.  find_peaks_cwt builds its scalogram with each package's
own cwt.  The cases follow the peak cases of tests/test_design.py.
"""

import numpy as np
import pytest
import scipy.signal as ss
import torch

import godsp_tpu.models as J
import godsp_tpu_torch.models as P
from godsp_tpu_torch import default_device, dsputils, set_default_device


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
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if got.dtype.kind in "iub":
        assert np.array_equal(got, want)
    else:
        assert dsputils.pretty_close(got, want)


def _signal():
    rng = np.random.default_rng(0)
    return np.convolve(rng.normal(size=3000), np.hanning(40), "same")


SIG = _signal()
FIND = [{}, {"height": 0.5}, {"height": (0.2, 2.0)}, {"threshold": 0.001}, {"distance": 37},
        {"prominence": 1.0}, {"width": 10},
        {"prominence": 0.5, "width": (5, 40), "rel_height": 0.7},
        {"height": np.linspace(0, 1, SIG.size)},
        {"plateau_size": 1, "wlen": 301, "prominence": 0.2}]


@pytest.mark.parametrize("kw", FIND, ids=[str(i) for i in range(len(FIND))])
def test_find_peaks_matches_godsp_tpu_and_scipy(kw):
    g, gp = P.find_peaks(SIG, **kw)
    j, jp = J.find_peaks(SIG, **kw)
    r, rp = ss.find_peaks(SIG, **kw)
    assert np.array_equal(g, j) and np.array_equal(g, r)
    assert set(gp) == set(jp) == set(rp)
    for k in gp:
        _hold(gp[k], jp[k])


def test_find_peaks_takes_a_tensor():
    g, gp = P.find_peaks(torch.from_numpy(SIG), height=torch.tensor(0.3), distance=20)
    j, jp = J.find_peaks(SIG, height=0.3, distance=20)
    assert np.array_equal(g, j)
    _hold(gp["peak_heights"], jp["peak_heights"])


def test_plateaus():
    xp = np.array([0, 1, 1, 1, 0, 2, 2, 0, 3, 0], float)
    g, gp = P.find_peaks(xp, plateau_size=(2, None))
    j, jp = J.find_peaks(xp, plateau_size=(2, None))
    assert np.array_equal(g, j)
    for k in gp:
        _hold(gp[k], jp[k])


@pytest.mark.parametrize("kw", [{}, {"wlen": 101}])
def test_prominences_and_widths(kw):
    peaks, _ = P.find_peaks(SIG)
    for a, b in zip(P.peak_prominences(SIG, peaks, **kw), J.peak_prominences(SIG, peaks, **kw)):
        _hold(a, b)
    for a, b in zip(P.peak_widths(SIG, peaks, rel_height=0.8, **kw),
                    J.peak_widths(SIG, peaks, rel_height=0.8, **kw)):
        _hold(a, b)


@pytest.mark.parametrize("order", [1, 2, 5])
@pytest.mark.parametrize("mode", ["clip", "wrap"])
def test_argrel(order, mode):
    x = np.random.default_rng(0).normal(size=200)
    for name in ("argrelmax", "argrelmin"):
        for a, b in zip(getattr(P, name)(x, order=order, mode=mode),
                        getattr(J, name)(x, order=order, mode=mode)):
            assert np.array_equal(a, b)
    X = np.random.default_rng(1).normal(size=(20, 30))
    kw = dict(axis=1, order=order, mode=mode)
    for a, b in zip(P.argrelextrema(torch.from_numpy(X), np.greater, **kw),
                    J.argrelextrema(X, np.greater, **kw)):
        assert np.array_equal(a, b)


def test_vectorstrength():
    ev = np.sort(np.random.default_rng(2).uniform(0, 10, 200))
    for period in (0.5, np.array([0.3, 0.7, 1.1])):
        for a, b in zip(P.vectorstrength(ev, period), J.vectorstrength(ev, period)):
            _hold(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("case", ["sine", "noisy", "kwargs"])
def test_find_peaks_cwt_matches_godsp_tpu(case):
    t = np.linspace(0, 1, 500)
    x, widths, kw = {
        "sine": (np.sin(2 * np.pi * 2 * t), np.arange(10, 60), {}),
        "noisy": (SIG[:800], np.arange(1, 16), {}),
        "kwargs": (SIG[:600], np.arange(2, 20), {"min_snr": 2.0, "noise_perc": 20.0,
                                                 "gap_thresh": 3, "min_length": 4}),
    }[case]
    got = P.find_peaks_cwt(x, widths, **kw)
    assert np.array_equal(got, J.find_peaks_cwt(x, widths, **kw))
    if case == "sine":
        assert np.array_equal(got, ss.find_peaks_cwt(x, widths))


def test_validation():
    with pytest.raises(ValueError):
        P.find_peaks(np.zeros(10), distance=0.5)
    with pytest.raises(ValueError):
        P.peak_prominences(np.zeros(10), [20])
    with pytest.raises(ValueError):
        P.peak_prominences(np.arange(10.0), [5], wlen=2)
    with pytest.raises(ValueError):
        P.find_peaks(np.zeros((3, 3)))
    with pytest.raises(ValueError):
        P.argrelmax(np.zeros(10), order=0)


def test_savgol_then_find_peaks_end_to_end():
    """The slice end to end: smooth a noisy pulse train with savgol_filter,
    then pick its peaks; the port's indices and properties equal
    godsp_tpu's, and the pulses are found."""
    rng = np.random.default_rng(7)
    n = 4000
    x = 0.2 * rng.normal(size=n)
    centers = np.arange(200, n, 400)
    for c in centers:
        x += np.exp(-0.5 * ((np.arange(n) - c) / 12.0) ** 2)
    ys = P.savgol_filter(x, 31, 3)
    yj = J.savgol_filter(x, 31, 3)
    _hold(ys, yj)
    kw = dict(height=0.5, distance=100, prominence=0.4)
    g, gp = P.find_peaks(ys, **kw)
    j, jp = J.find_peaks(np.asarray(yj), **kw)
    assert np.array_equal(g, j)
    for k in gp:
        _hold(gp[k], jp[k])
    assert len(g) == len(centers) and np.all(np.abs(g - centers) < 15)
