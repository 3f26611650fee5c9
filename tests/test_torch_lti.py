"""godsp_tpu_torch's LTI toolkit (models/_lti_impl.py) against godsp_tpu.

The port runs on the CPU in float64 and is held to godsp_tpu (JAX on the
CPU, x64) on the same inputs at go-dsp's 1e-8 abs-or-rel bound
(dsputils.pretty_close): the conversions, cont2discrete, the one-scan
simulation (lsim/dlsim/impulse/step and their discrete forms), the
analog and discrete responses, the residue family, the lti/dlti classes
and place_poles, following tests/test_lti.py's cases.  The simulation
also runs in float32 (the card's working type) against scipy in float64.
"""

import numpy as np
import pytest
import scipy.signal as ss
import torch

import godsp_tpu.models as J
import godsp_tpu_torch.models as P
from godsp_tpu_torch import default_device, dsputils, set_default_device
from godsp_tpu_torch.models import _lti_impl


@pytest.fixture(autouse=True)
def _host_data_on_cpu():
    """Host data goes to the CPU here; the port's default device is the card."""
    old = default_device()
    set_default_device("cpu")
    yield
    set_default_device(old)


def _hold(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _hold(g, w)
        return
    got, want = np.atleast_1d(np.asarray(got)), np.atleast_1d(np.asarray(want))
    assert got.shape == want.shape
    if want.size:
        close = dsputils.pretty_close_c if np.iscomplexobj(want) else dsputils.pretty_close
        assert close(got, want)


SYSC = ss.tf2ss(*ss.butter(3, 2.0, analog=True))
SYSD = ss.cont2discrete(SYSC, 0.05)
MIMO = (np.array([[-1.0, 0.5], [0.0, -2.0]]), np.array([[1.0, 0.0], [0.5, 1.0]]),
        np.eye(2), np.zeros((2, 2)))
BA = ss.butter(4, 0.3)
T = np.linspace(0, 5, 201)
U = np.sin(T * 3.0) + 0.2 * np.random.default_rng(1).normal(size=T.shape)

CASES = [
    ("tf2ss", ([1.0, 3.0, 3.0], [1.0, 2.0, 1.0]), {}),
    ("tf2ss", ([2.0, 1.0], [1.0, 0.5]), {}),
    ("ss2tf", ss.tf2ss(*BA), {}),
    ("ss2tf", MIMO, {"input": 1}),
    ("zpk2ss", ss.butter(3, 0.4, output="zpk"), {}),
    ("ss2zpk", ss.tf2ss(*BA), {}),
    ("abcd_normalize", (MIMO[0], MIMO[1]), {"C": MIMO[2]}),
    ("cont2discrete", (SYSC, 0.05), {"method": "zoh"}),
    ("cont2discrete", (SYSC, 0.05), {"method": "foh"}),
    ("cont2discrete", (SYSC, 0.05), {"method": "impulse"}),
    ("cont2discrete", (SYSC, 0.05), {"method": "gbt", "alpha": 0.3}),
    ("cont2discrete", (SYSC, 0.05), {"method": "bilinear"}),
    ("cont2discrete", (ss.butter(2, 3.0, analog=True), 0.1), {}),
    ("cont2discrete", (ss.butter(2, 3.0, analog=True, output="zpk"), 0.1), {}),
    ("lsim", (SYSC, U, T), {}),
    ("lsim", (SYSC, U, T), {"interp": False}),
    ("lsim", (SYSC, np.cos(T), T), {"X0": [0.3, -0.2, 0.1]}),
    ("lsim", (MIMO, np.stack([U, np.cos(T)], 1), T), {}),
    ("dlsim", (SYSD, np.sin(np.arange(300) * 0.065)), {}),
    ("dlsim", (SYSD, np.sin(np.arange(50) * 0.2)), {"t": np.arange(50) * 0.07, "x0": [1, 0, 0]}),
    ("dlsim", ((*BA, 0.1), np.cos(np.arange(80) * 0.3)), {}),
    ("impulse", (SYSC,), {}),
    ("step", (SYSC,), {"T": np.linspace(0, 4, 120)}),
    ("impulse", (BA,), {"N": 50}),
    ("dimpulse", (SYSD,), {"n": 40}),
    ("dstep", (SYSD,), {"n": 40}),
    ("dstep", ((*MIMO, 0.1),), {"n": 30}),
    ("freqs", ([1.0], [1.0, 2.0, 1.0]), {"worN": np.logspace(-2, 2, 50)}),
    ("freqs", ([1.0, 0.5], [1.0, 2.0, 1.0]), {"worN": 64}),
    ("freqs_zpk", ss.butter(3, 2.0, analog=True, output="zpk"), {"worN": np.logspace(-1, 1, 40)}),
    ("bode", (SYSC,), {"w": np.logspace(-1, 1, 30)}),
    ("freqresp", (ss.butter(3, 2.0, analog=True),), {"w": np.logspace(-1, 1, 30)}),
    ("dfreqresp", ((*BA, 0.1),), {"n": 64}),
    ("dbode", ((*BA, 0.1),), {"w": np.linspace(0.1, 3.0, 20)}),
    ("residue", ([1.0, 2.0], [1.0, 3.0, 2.0]), {}),
    ("residue", ([1.0, 0.0, 1.0], [1.0, 2.0, 1.0]), {}),
    ("residuez", ([1.0, 2.0], [1.0, -0.5, 0.06]), {}),
    ("residuez", ([1.0], [1.0, -1.0, 0.25]), {}),
    ("invres", ([1.0, -1.0], [-1.0, -2.0], []), {}),
    ("invresz", ([0.5, 0.5], [0.2, 0.3], [1.0]), {}),
    ("unique_roots", ([1.0, 1.0 + 1e-5, 2.0, 3.0, 3.0],), {"rtype": "avg"}),
]


@pytest.mark.parametrize("name,args,kw", CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_lti_matches_godsp_tpu(name, args, kw):
    _hold(getattr(P, name)(*args, **kw), getattr(J, name)(*args, **kw))


def test_lsim_dlsim_match_scipy():
    _hold(P.lsim(SYSC, U, T)[1], ss.lsim(SYSC, U, T)[1])
    _hold(P.dlsim(SYSD, U)[1], ss.dlsim(SYSD, U)[1])


def test_classes_match_godsp_tpu():
    for mk in (lambda M: M.lti(*BA), lambda M: M.TransferFunction(*BA),
               lambda M: M.ZerosPolesGain(*ss.butter(3, 2.0, analog=True, output="zpk")),
               lambda M: M.StateSpace(*SYSC)):
        g, w = mk(P), mk(J)
        _hold(g.to_tf()._tf(), w.to_tf()._tf())
        _hold(g.to_zpk()._zpk(), w.to_zpk()._zpk())
        _hold(g.to_ss()._ss(), w.to_ss()._ss())
        _hold(g.step(T=T), w.step(T=T))
        _hold(g.output(U, T), w.output(U, T))
        _hold(g.bode(w=np.logspace(-1, 1, 20)), w.bode(w=np.logspace(-1, 1, 20)))
        _hold(g.freqresp(w=np.logspace(-1, 1, 20)), w.freqresp(w=np.logspace(-1, 1, 20)))
        gd, wd = g.to_discrete(0.05), w.to_discrete(0.05)
        assert type(gd).__name__ == type(wd).__name__ and gd.dt == wd.dt
        _hold(gd.impulse(N=30), wd.impulse(N=30))
    d = P.dlti(*BA, dt=0.1)
    _hold(d.output(U[:50], None), J.dlti(*BA, dt=0.1).output(U[:50], None))
    assert "dlti" in repr(d)


@pytest.mark.parametrize("B,poles", [(np.array([[0.0], [0.0], [1.0]]), [-1.0, -2.0, -3.0]),
                                     (np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]]),
                                      [-1.0, -2.0 + 1j, -2.0 - 1j])])
def test_place_poles(B, poles):
    A = np.array([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [-1.0, -2.0, -3.0]])
    got, want = P.place_poles(A, B, poles), J.place_poles(A, B, poles)
    _hold(got.gain_matrix, want.gain_matrix)
    _hold(np.sort_complex(got.computed_poles), np.sort_complex(np.asarray(poles, complex)))


def test_lti_validation():
    for bad in (lambda: P.lsim(SYSC, np.zeros(5), np.array([0.0, 0.1, 0.3, 0.4, 0.5])),
                lambda: P.dlsim(SYSD, np.zeros((4, 2))),
                lambda: P.cont2discrete(SYSC, 0.05, method="bogus"),
                lambda: P.cont2discrete(SYSC, 0.05, method="gbt")):
        with pytest.raises(ValueError):
            bad()


def test_float32_scan_meets_the_bar(monkeypatch):
    """The residual-form scan in float32 (the card's working type) against
    scipy in float64: a frequency-scaled analog butter(4, 2 pi 1 kHz)
    over 44,100 steps at dt = 1/44100."""
    monkeypatch.setattr(_lti_impl, "working_float", lambda device: torch.float32)
    w0 = 2 * np.pi * 1000.0
    A, B, C, D = P.tf2ss(*P.butter(4, w0, analog=True))
    Tm = np.diag(w0 ** np.arange(3.0, -1.0, -1.0))
    Ti = np.linalg.inv(Tm)
    sysc = (Ti @ A @ Tm, Ti @ B, C @ Tm, D)
    u = np.random.default_rng(2).normal(size=44100).astype(np.float32).astype(np.float64)
    t = np.arange(u.size) / 44100.0
    assert dsputils.snr_db(P.lsim(sysc, u, t)[1], ss.lsim(sysc, u, t)[1]) >= 125.0
    sysd = P.cont2discrete(sysc, 1 / 44100.0, "zoh")
    assert dsputils.snr_db(P.dlsim(sysd, u)[1], ss.dlsim(sysd, u)[1]) >= 125.0


def test_canonical_form_of_a_fast_analog_filter_is_ill_conditioned():
    """Why chip_smoke.py's lsim step scales its state space: tf2ss of the
    analog butter(4, 2 pi 1 kHz) has entries up to w0^4, and at
    dt = 1/44100 the float64 results of two matrix exponentials (this
    package's Pade-13 and scipy's) part; x = diag(w0^3, w0^2, w0, 1) z is
    the same system, where they agree."""
    w0 = 2 * np.pi * 1000.0
    A, B, C, D = P.tf2ss(*P.butter(4, w0, analog=True))
    Tm = np.diag(w0 ** np.arange(3.0, -1.0, -1.0))
    Ti = np.linalg.inv(Tm)
    u = np.random.default_rng(4).normal(size=4000)
    t = np.arange(u.size) / 44100.0
    canonical = dsputils.snr_db(P.lsim((A, B, C, D), u, t)[1], ss.lsim((A, B, C, D), u, t)[1])
    scaled = (Ti @ A @ Tm, Ti @ B, C @ Tm, D)
    assert canonical < 110.0
    assert dsputils.snr_db(P.lsim(scaled, u, t)[1], ss.lsim(scaled, u, t)[1]) >= 200.0
