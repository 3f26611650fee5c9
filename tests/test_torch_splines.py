"""godsp_tpu_torch's B-spline surface (models/splines.py) against godsp_tpu,
and the toolkit's 2-D chain end to end (cspline2d -> spline_filter ->
medfilt2d).

The port runs on the CPU in float64 and is held to godsp_tpu (JAX on the
CPU, x64) on the same seeded numpy inputs at go-dsp's 1e-8 abs-or-rel
bound (dsputils.pretty_close).  The cases follow tests/test_splines.py,
at power-of-2 lengths (the pow-2 FFT) and others (Bluestein).  The route
test sends float32 CPU tensors down the CUDA route (kernel_route patched,
the wrappers counting): a power-of-2 DCT round trip is one K1 and one K2
a pass, a non-power-of-2 one Bluestein over them.
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


RNG = np.random.default_rng(0)
SIG = RNG.normal(size=200)
SIG64 = RNG.normal(size=64)
BATCH = RNG.normal(size=(3, 50))
IMG = RNG.normal(size=(40, 50))
IMG64 = RNG.normal(size=(32, 64))
NEWX = np.linspace(-7, 210, 333)

CASES = [
    ("cspline1d", (SIG,), {}),
    ("cspline1d", (SIG64,), {}),
    ("cspline1d", (SIG,), {"lamb": 2.5}),
    ("cspline1d", (BATCH,), {"lamb": 0.5}),
    ("cspline1d", (SIG[:1],), {}),
    ("qspline1d", (SIG,), {}),
    ("qspline1d", (BATCH,), {}),
    ("cspline2d", (IMG,), {}),
    ("cspline2d", (IMG64,), {"lamb": 1.0}),
    ("cspline2d", (IMG[:1],), {}),
    ("qspline2d", (IMG,), {}),
    ("qspline2d", (IMG64,), {}),
    ("spline_filter", (IMG,), {}),
    ("spline_filter", (IMG64, 0.5), {}),
    ("gauss_spline", (np.linspace(-3, 3, 50), 3), {}),
    ("gauss_spline", (np.arange(-4, 5), 2), {}),
    ("symiirorder1", (SIG, 1.5, 0.4), {}),
    ("symiirorder1", (SIG64, 0.5, -0.3), {}),
    ("symiirorder1", (SIG[:1], 1.5, 0.4), {}),
    ("symiirorder2", (SIG, 0.3, 0.5), {}),
    ("symiirorder2", (BATCH, 0.7, 1.2), {}),
]


@pytest.mark.parametrize("name,args,kw", CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_splines_match_godsp_tpu(name, args, kw):
    _hold(getattr(P, name)(*args, **kw), getattr(J, name)(*args, **kw))


@pytest.mark.parametrize("name", ["cspline1d_eval", "qspline1d_eval"])
@pytest.mark.parametrize("kw", [{}, {"dx": 0.5, "x0": -2.0}])
def test_evaluators_match_godsp_tpu_and_scipy(name, kw):
    cj = (ss.cspline1d if name.startswith("c") else ss.qspline1d)(SIG)
    got = getattr(P, name)(cj, NEWX, **kw)
    _hold(got, getattr(J, name)(cj, NEWX, **kw))
    assert np.allclose(_np(got), getattr(ss, name)(cj, NEWX, **kw), rtol=1e-12, atol=1e-13)


def test_coefficients_against_scipy():
    assert np.allclose(_np(P.cspline1d(SIG)), ss.cspline1d(SIG), rtol=1e-11, atol=1e-12)
    assert np.allclose(_np(P.qspline1d(SIG)), ss.qspline1d(SIG), rtol=1e-11, atol=1e-12)
    # scipy's 2-D C path truncates at ~1e-6 by default; the DCT route is exact
    assert np.allclose(_np(P.cspline2d(IMG)), ss.cspline2d(IMG), rtol=0, atol=1e-5)


def test_validation():
    for bad in (lambda: P.qspline1d(SIG, lamb=1.0), lambda: P.symiirorder1(SIG, 1.0, 1.5),
                lambda: P.symiirorder2(SIG, 1.5, 0.5), lambda: P.cspline2d(SIG),
                lambda: P.cspline1d_eval(IMG, NEWX)):
        with pytest.raises(ValueError):
            bad()


def test_toolkit_2d_chain_end_to_end():
    """cspline2d -> spline_filter -> medfilt2d, the port against godsp_tpu;
    at lamb = 0 the B3 reconstruction of the coefficients is the image."""
    img = np.random.default_rng(5).normal(size=(24, 40))
    ck = P.cspline2d(img)
    _hold(ck, J.cspline2d(img))
    recon = P.sepfir2d(ck, np.array([1.0, 4.0, 1.0]) / 6.0, np.array([1.0, 4.0, 1.0]) / 6.0)
    assert np.allclose(_np(recon), img, rtol=0, atol=1e-11)
    smooth = P.spline_filter(img, 2.0)
    _hold(smooth, J.spline_filter(img, 2.0))
    got = P.medfilt2d(smooth, 3)
    assert np.array_equal(_np(got), np.asarray(J.medfilt2d(_np(smooth), 3)))
    _hold(got, J.medfilt2d(J.spline_filter(img, 2.0), 3))


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


@pytest.mark.parametrize("step,want", [
    ("cspline2d", {"fft_pow2": 2, "ifft_pow2": 2}),
    ("cspline1d_pow2", {"fft_pow2": 1, "ifft_pow2": 1}),
    # Bluestein at 200 points (pad 512, the chirp spectrum built on the
    # host): K1 and K2 once for each of the DCT's forward and inverse FFTs
    ("cspline1d_bluestein", {"fft_pow2": 2, "ifft_pow2": 2}),
    ("symiirorder2", {"fft_pow2": 2, "ifft_pow2": 2}),
])
def test_spline_steps_route_through_the_kernels(cuda_route, step, want):
    img = torch.from_numpy(IMG64.astype(np.float32))
    sig = torch.from_numpy(SIG.astype(np.float32))
    run, ref = {
        "cspline2d": (lambda: P.cspline2d(img), lambda: J.cspline2d(IMG64.astype(np.float32)
                                                                   .astype(np.float64))),
        "cspline1d_pow2": (lambda: P.cspline1d(img[0]),
                           lambda: ss.cspline1d(img[0].double().numpy())),
        "cspline1d_bluestein": (lambda: P.cspline1d(sig),
                                lambda: ss.cspline1d(sig.double().numpy())),
        "symiirorder2": (lambda: P.symiirorder2(sig, 0.3, 0.5),
                         lambda: J.symiirorder2(sig.double().numpy(), 0.3, 0.5)),
    }[step]
    got = run()
    assert {k: v for k, v in launch_counts().items() if v} == want
    assert got.dtype == torch.float32
    assert dsputils.snr_db(_np(got), np.asarray(ref())) >= 100.0
