"""godsp_tpu_torch's filter design (models/design.py, models/fir_design.py)
against godsp_tpu's.

Both modules are host float64 numpy, the port's a copy, so every public
function runs here with the same arguments in both packages and the
results must agree at go-dsp's 1e-8 abs-or-rel bound
(dsputils.pretty_close), element by element through tuples.  The cases
follow tests/test_design.py and tests/test_fir_design.py: each design
family, output form, band type, order selection, the analysis helpers
and the conversions, one parametrised case each.  A few are also held to
scipy.signal where the JAX tests hold them there.
"""

import warnings

import numpy as np
import pytest
import scipy.signal as ss

from godsp_tpu.models import design as jd
from godsp_tpu.models import fir_design as jf
from godsp_tpu_torch import default_device, dsputils, set_default_device
from godsp_tpu_torch.models import design as pd
from godsp_tpu_torch.models import fir_design as pf


@pytest.fixture(autouse=True)
def _host_data_on_cpu():
    """Host data goes to the CPU here; the port's default device is the card."""
    old = default_device()
    set_default_device("cpu")
    yield
    set_default_device(old)


def _same(got, want):
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    if isinstance(want, (int, float, complex, np.number)) and np.ndim(want) == 0:
        assert dsputils.pretty_close(np.atleast_1d(got), np.atleast_1d(want))
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if want.size:
        close = dsputils.pretty_close_c if np.iscomplexobj(want) else dsputils.pretty_close
        assert close(got, want)


_Z, _P, _K = ss.buttap(4)
_B, _A = ss.butter(4, 0.2)
_SOS = ss.butter(6, [0.1, 0.4], "bandpass", output="sos")

DESIGN = [
    ("buttap", (5,), {}),
    ("cheb1ap", (4, 1.0), {}),
    ("cheb2ap", (5, 40.0), {}),
    ("besselap", (4,), {"norm": "delay"}),
    ("ellipap", (5, 0.5, 60.0), {}),
    ("lp2lp_zpk", (_Z, _P, _K, 2.0), {}),
    ("lp2hp_zpk", (_Z, _P, _K, 2.0), {}),
    ("lp2bp_zpk", (_Z, _P, _K, 3.0, 0.5), {}),
    ("lp2bs_zpk", (_Z, _P, _K, 3.0, 0.5), {}),
    ("lp2lp", (_B, _A, 2.0), {}),
    ("lp2hp", (_B, _A, 2.0), {}),
    ("lp2bp", (_B, _A, 3.0, 0.5), {}),
    ("lp2bs", (_B, _A, 3.0, 0.5), {}),
    ("bilinear_zpk", (_Z, _P, _K, 4.0), {}),
    ("bilinear", ([1.0], [1.0, 2.0, 1.0]), {"fs": 8.0}),
    ("butter", (4, 0.2), {}),
    ("butter", (5, [0.1, 0.3], "bandstop"), {"output": "zpk"}),
    ("butter", (8, 4000), {"fs": 44100, "output": "sos"}),
    ("butter", (4, 2 * np.pi * 1000), {"analog": True}),
    ("cheby1", (8, 0.05, 0.2), {"output": "sos"}),
    ("cheby1", (4, 1.0, 0.3, "highpass"), {}),
    ("cheby2", (6, 40.0, [0.2, 0.5], "bandpass"), {"output": "sos"}),
    ("ellip", (5, 0.5, 50.0, 0.3), {}),
    ("bessel", (4, 0.2), {"norm": "delay"}),
    ("iirfilter", (4, [0.2, 0.4]), {"rp": 1.0, "btype": "band", "ftype": "cheby1"}),
    ("iirdesign", (0.2, 0.3, 1.0, 40.0), {"ftype": "butter"}),
    ("buttord", (0.2, 0.3, 3.0, 40.0), {}),
    ("cheb1ord", ([0.2, 0.5], [0.1, 0.6], 1.0, 40.0), {}),
    ("cheb2ord", (0.3, 0.2, 1.0, 40.0), {}),
    ("ellipord", (1000, 1500, 1.0, 60.0), {"fs": 8000}),
    ("band_stop_obj", (0.25, 0, np.array([0.2, 0.5]), np.array([0.3, 0.4]), 1.0, 40.0,
                       "butter"), {}),
    ("iirnotch", (60.0, 35.0), {"fs": 1000.0}),
    ("iirpeak", (0.3, 30.0), {}),
    ("iircomb", (1000.0, 30.0), {"ftype": "peak", "fs": 8000.0}),
    ("gammatone", (440.0, "fir"), {"fs": 16000.0}),
    ("gammatone", (1000.0, "iir"), {"fs": 16000.0}),
    ("zpk2tf", (_Z, _P, _K), {}),
    ("tf2zpk", (_B, _A), {}),
    ("zpk2sos", ss.butter(6, 0.3, output="zpk"), {}),
    ("sos2tf", (_SOS,), {}),
    ("sos2zpk", (_SOS,), {}),
    ("tf2sos", (_B, _A), {}),
    ("normalize", ([0.0, 2.0, 4.0], [2.0, 1.0]), {}),
    ("freqz", (_B, _A), {"worN": 64}),
    ("freqz", (_B, _A), {"worN": 33, "whole": True, "fs": 1000.0}),
    ("sosfreqz", (_SOS,), {"worN": 64}),
    ("freqz_sos", (_SOS,), {"worN": 16}),
    ("freqz_zpk", ss.butter(4, 0.2, output="zpk"), {"worN": 64}),
    ("group_delay", ((_B, _A),), {"w": 64}),
    ("findfreqs", ([1.0], [1.0, 2.0, 1.0], 16), {}),
]


@pytest.mark.parametrize("name,args,kw", DESIGN, ids=[f"{c[0]}-{i}" for i, c in enumerate(DESIGN)])
def test_design_matches_godsp_tpu(name, args, kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _same(getattr(pd, name)(*args, **kw), getattr(jd, name)(*args, **kw))


def test_design_exports_every_name():
    assert sorted(pd.__all__) == sorted(jd.__all__)
    assert issubclass(pd.BadCoefficients, UserWarning)


@pytest.mark.parametrize("name,args", [("butter", (4, 0.2)), ("cheby1", (4, 1.0, 0.2)),
                                       ("cheby2", (4, 40.0, 0.2)), ("ellip", (4, 1.0, 40.0, 0.2))])
def test_design_matches_scipy(name, args):
    for out in ("ba", "sos"):
        got = getattr(pd, name)(*args, output=out)
        want = getattr(ss, name)(*args, output=out)
        if out == "sos":  # the section pairing is the port's own; compare the cascade
            got, want = ss.sosfreqz(got, 256)[1], ss.sosfreqz(want, 256)[1]
        _same(got, want)


FIR = [
    ("firls", (31, [0, 0.3, 0.4, 1], [1, 1, 0, 0]), {}),
    ("firls", (31, [0, 100, 150, 500], [1, 1, 0, 0]), {"weight": [1, 10], "fs": 1000.0}),
    ("remez", (41, [0, 0.2, 0.3, 0.5], [1, 0]), {}),
    ("remez", (32, [0, 0.1, 0.2, 0.5], [0, 1]), {"type": "hilbert"}),
    ("minimum_phase", (ss.firwin(31, 0.3),), {}),
    ("minimum_phase", (ss.firwin(31, 0.3),), {"half": False, "n_fft": 512}),
    ("firwin_2d", ((11, 9), ("hamming", "hann")), {"fc": 0.3}),
    ("firwin_2d", ((9, 9), "hamming"), {"fc": 0.4, "circular": True}),
]


@pytest.mark.parametrize("name,args,kw", FIR, ids=[f"{c[0]}-{i}" for i, c in enumerate(FIR)])
def test_fir_design_matches_godsp_tpu(name, args, kw):
    _same(getattr(pf, name)(*args, **kw), getattr(jf, name)(*args, **kw))
