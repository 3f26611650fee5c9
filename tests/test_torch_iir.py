"""godsp_tpu_torch's IIR filtering (models/iir.py) and its log-depth scan
(models/_scan.py) against godsp_tpu.

The port runs on the CPU in float64 and is held to godsp_tpu (JAX on the
CPU, x64) on the same seeded numpy inputs at go-dsp's 1e-8 abs-or-rel
bound (dsputils.pretty_close); the cases follow the lfilter/sosfilt/
filtfilt cases of tests/test_models.py and tests/test_design.py, over
filter families, orders, block sizes, streaming state and axes.  Beside
them: the scan against a sequential loop, and the float32 accuracy the
balanced carry buys (the card's working type, run here on the CPU).
"""

import numpy as np
import pytest
import scipy.signal as ss
import torch

import godsp_tpu.models as J
import godsp_tpu_torch.models as P
from godsp_tpu_torch import default_device, dsputils, set_default_device
from godsp_tpu_torch.models import _scan, iir


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


RNG = np.random.default_rng(3)
X = RNG.normal(size=(2, 3, 1000))
BA = {
    "butter4": ss.butter(4, 0.05),
    "cheby1-6-hp": ss.cheby1(6, 1.0, 0.3, "highpass"),
    "ellip4-bp": ss.ellip(4, 0.5, 40.0, [0.2, 0.4], "bandpass"),
    "fir": (ss.firwin(15, 0.3), [1.0]),
    "iir-first-order": ([0.3], [1.0, -0.7]),
    "b-longer": ([0.2, 0.3, 0.1, 0.05], [1.0, -0.5]),
    "gain": ([2.5], [2.0]),
}
SOS = {
    "butter8": ss.butter(8, 4000, fs=44100, output="sos"),
    "cheby2-bs": ss.cheby2(4, 40.0, [0.2, 0.3], "bandstop", output="sos"),
}


@pytest.mark.parametrize("name", sorted(BA))
@pytest.mark.parametrize("block", [None, 64])
def test_lfilter_matches_godsp_tpu_and_scipy(name, block):
    b, a = BA[name]
    got = P.lfilter(b, a, X, block_size=block)
    _hold(got, J.lfilter(b, a, X, block_size=block))
    _hold(got, ss.lfilter(b, a, X))


@pytest.mark.parametrize("name", ["butter4", "ellip4-bp", "iir-first-order"])
def test_lfilter_streams_with_zi(name):
    b, a = BA[name]
    k = max(len(a), len(b)) - 1
    zi = RNG.normal(size=(2, 3, k))
    got = P.lfilter(b, a, X, zi=zi, axis=-1)
    _hold(got, J.lfilter(b, a, X, zi=zi))
    _hold(got, ss.lfilter(b, a, X, zi=zi))
    y1, z1 = P.lfilter(b, a, X[..., :377], zi=zi)
    y2, _ = P.lfilter(b, a, X[..., 377:], zi=z1)
    _hold(torch.cat([y1, y2], dim=-1), got[0])


def test_lfilter_axis_complex_and_int():
    b, a = BA["butter4"]
    _hold(P.lfilter(b, a, X, axis=1), J.lfilter(b, a, X, axis=1))
    xc = X[0] + 1j * X[1]
    zi = RNG.normal(size=(3, 4)) + 1j * RNG.normal(size=(3, 4))
    _hold(P.lfilter(b, a, xc), J.lfilter(b, a, xc))
    _hold(P.lfilter(b, a, xc, zi=zi), ss.lfilter(b, a, xc, zi=zi))
    ints = np.arange(50)
    _hold(P.lfilter(b, a, ints), J.lfilter(b, a, ints))


@pytest.mark.parametrize("name", sorted(SOS))
def test_sosfilt_family_matches_godsp_tpu(name):
    sos = SOS[name]
    _hold(P.sosfilt(sos, X), J.sosfilt(sos, X))
    zi = RNG.normal(size=(sos.shape[0], 2, 3, 2))
    _hold(P.sosfilt(sos, X, zi=zi), J.sosfilt(sos, X, zi=zi))
    _hold(P.sosfiltfilt(sos, X), J.sosfiltfilt(sos, X))
    _hold(P.sosfiltfilt(sos, X, axis=1, padlen=2), ss.sosfiltfilt(sos, X, axis=1, padlen=2))
    _hold(P.sosfilt_zi(sos), J.sosfilt_zi(sos))


@pytest.mark.parametrize("name", ["butter4", "cheby1-6-hp", "fir"])
def test_filtfilt_and_zi_match_godsp_tpu(name):
    b, a = BA[name]
    _hold(P.filtfilt(b, a, X), J.filtfilt(b, a, X))
    _hold(P.filtfilt(b, a, X, padlen=0), ss.filtfilt(b, a, X, padlen=0))
    _hold(P.lfilter_zi(b, a), J.lfilter_zi(b, a))
    _hold(P.lfiltic(b, a, [0.5, -0.2, 0.1], [1.0, 0.3]), J.lfiltic(b, a, [0.5, -0.2, 0.1],
                                                                   [1.0, 0.3]))


def test_iir_validation():
    for bad in (lambda: P.lfilter([1.0], [0.0, 1.0], X), lambda: P.sosfilt(np.ones(6), X),
                lambda: P.filtfilt(*BA["butter4"], X[..., :10]),
                lambda: P.lfilter([[1.0]], [1.0], X)):
        with pytest.raises(ValueError):
            bad()


@pytest.mark.parametrize("B", [1, 2, 3, 7, 64, 1000])
def test_associative_scan_matches_a_loop(B):
    rng = np.random.default_rng(B)
    M = torch.from_numpy(rng.normal(size=(B, 3, 3)) * 0.5)
    v = torch.from_numpy(rng.normal(size=(B, 2, 3)))
    Mc, vc = _scan.associative_scan(iir._carry_combine, (M, v))
    accM, accv = torch.eye(3, dtype=M.dtype), torch.zeros(2, 3, dtype=M.dtype)
    for b in range(B):
        accM, accv = M[b] @ accM, accv @ M[b].T + v[b]
        assert torch.allclose(Mc[b], accM, rtol=1e-12, atol=1e-12)
        assert torch.allclose(vc[b], accv, rtol=1e-12, atol=1e-12)


def test_float32_carry_is_balanced():
    """In float32 (the card's working type) butter(4, 1 kHz at 44.1 kHz)
    in (b, a) form reaches the 120 dB bar against scipy in float64 only
    with the carry in the balanced basis; the TDF-II carry loses the
    output's digits to its cancelling states."""
    n = 1 << 17
    t = np.arange(n) / 44100.0
    x = (0.4 * np.sin(2 * np.pi * 440 * t) + 0.1 * RNG.normal(size=n)).astype(np.float32)
    b, a = ss.butter(4, 1000, fs=44100)
    want = ss.lfilter(b, a, x.astype(np.float64))
    got = P.lfilter(b, a, torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert dsputils.snr_db(_np(got), want) >= 130.0
    bn, an = iir._norm_ba(b, a)
    A, g, _ = iir._tdf2(bn, an)
    assert not np.allclose(iir._balancing(A, g), np.eye(4))
    # The same algorithm with the TDF-II carry (no balancing) falls short.
    saved = iir._balancing
    try:
        iir._balancing = lambda A, g: np.eye(A.shape[0])
        iir._block_tables.cache_clear()
        iir._device_tables.cache_clear()
        tdf2 = P.lfilter(b, a, torch.from_numpy(x))
    finally:
        iir._balancing = saved
        iir._block_tables.cache_clear()
        iir._device_tables.cache_clear()
    assert dsputils.snr_db(_np(tdf2), want) < 110.0


def test_balancing_falls_back_to_tdf2():
    eye = np.eye(2)
    for b, a in (([1.0, 0.0, 0.0], [1.0, -2.0, 1.0]),   # double pole on the unit circle
                 ([1.0, 1.0, 1.0], [1.0, 0.0, 0.0]),    # FIR
                 ([1.0, -0.5, 0.0], [1.0, -0.5, 0.0])):  # cancelling, uncontrollable
        A, g, _ = iir._tdf2(*iir._norm_ba(b, a))
        assert np.array_equal(iir._balancing(A, g), eye[: len(g), : len(g)])
