"""godsp_tpu_torch's Savitzky-Golay filter (models/savgol.py) against
godsp_tpu.

savgol_coeffs is a host float64 copy and must be equal; savgol_filter
runs on the CPU in float64 and is held to godsp_tpu (JAX on the CPU, x64)
on the same seeded numpy inputs at go-dsp's 1e-8 abs-or-rel bound
(dsputils.pretty_close), in every mode, and to scipy.  The cases follow
the savgol cases of tests/test_design.py.  The route test sends float32
CPU tensors down the CUDA route (kernel_route patched, the wrappers
counting): the float64 taps are cast to the signal's dtype, so the
convolution stays on the kernels (K1 twice, K2 once; the large plan past
16384 points).
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
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert dsputils.pretty_close(got, want)


COEFFS = [(11, 3, {}), (11, 3, {"deriv": 1, "delta": 0.5}), (21, 5, {"deriv": 2, "delta": 0.5}),
          (10, 3, {}), (9, 2, {"pos": 2}), (9, 2, {"use": "dot"}), (7, 2, {"deriv": 3})]


@pytest.mark.parametrize("W,p,kw", COEFFS, ids=[str(i) for i in range(len(COEFFS))])
def test_savgol_coeffs_are_copies(W, p, kw):
    got = P.savgol_coeffs(W, p, **kw)
    assert np.array_equal(got, J.savgol_coeffs(W, p, **kw))
    assert np.allclose(got, ss.savgol_coeffs(W, p, **kw), rtol=1e-9, atol=1e-11)


X = np.cumsum(np.random.default_rng(0).normal(size=300))
XB = np.random.default_rng(1).normal(size=(3, 200))


@pytest.mark.parametrize("mode", ["interp", "mirror", "nearest", "constant", "wrap"])
@pytest.mark.parametrize("W,p", [(11, 3), (41, 4)])
def test_savgol_filter_modes(mode, W, p):
    got = P.savgol_filter(X, W, p, mode=mode, cval=0.7)
    _hold(got, J.savgol_filter(X, W, p, mode=mode, cval=0.7))
    assert np.allclose(_np(got), ss.savgol_filter(X, W, p, mode=mode, cval=0.7),
                       rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("args,kw", [((XB, 15, 4), {"deriv": 2, "delta": 0.1}),
                                     ((XB.T, 9, 2), {"axis": 0}),
                                     ((XB, 8, 2), {"mode": "mirror"}),
                                     ((XB[:, :20], 31, 2), {"mode": "wrap"}),
                                     ((XB[0, :30], 1, 0), {"mode": "wrap"}),
                                     ((np.arange(50), 5, 2), {})],
                         ids=["deriv", "axis0", "even-mirror", "window-past-signal", "w1", "ints"])
def test_savgol_filter_variants(args, kw):
    _hold(P.savgol_filter(*args, **kw), J.savgol_filter(*args, **kw))


def test_savgol_validation():
    for bad in (lambda: P.savgol_coeffs(5, 5), lambda: P.savgol_coeffs(5, 2, pos=7),
                lambda: P.savgol_coeffs(5, 2, use="x"),
                lambda: P.savgol_filter(np.zeros(100), 10, 3),
                lambda: P.savgol_filter(np.zeros(5), 11, 3),
                lambda: P.savgol_filter(np.zeros(50), 11, 3, mode="bogus")):
        with pytest.raises(ValueError):
            bad()


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


@pytest.mark.parametrize("n,mode,want", [
    (5000, "interp", {"fft_pow2": 2, "ifft_pow2": 1}),
    (5000, "mirror", {"fft_pow2": 2, "ifft_pow2": 1}),
    (40000, "interp", {"outer_dft_split": 3, "fft_pow2": 2, "ifft_pow2": 1}),
])
def test_savgol_routes_through_the_kernels(cuda_route, n, mode, want):
    x = np.random.default_rng(n).normal(size=n).astype(np.float32)
    got = P.savgol_filter(torch.from_numpy(x), 101, 3, mode=mode)
    assert {k: v for k, v in launch_counts().items() if v} == want
    assert got.dtype == torch.float32
    ref = ss.savgol_filter(x.astype(np.float64), 101, 3, mode=mode)
    assert dsputils.snr_db(_np(got), ref) >= 100.0
