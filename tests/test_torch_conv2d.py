"""godsp_tpu_torch's 2-D filtering (models/conv2d.py) and the 2-D circular
convolution beneath it (fft/pow2.py pow2_convolve2) against godsp_tpu.

The port runs on the CPU in float64 and is held to godsp_tpu (JAX on the
CPU, x64) on the same seeded numpy inputs at go-dsp's 1e-8 abs-or-rel
bound (dsputils.pretty_close); the rank filters must be equal.  The
cases follow tests/test_conv2d.py, plus boundary pads longer than the
axis (the index-built 'wrap'/'symmetric' extensions against np.pad).  The
route test sends float32 CPU tensors down the CUDA route (kernel_route
patched, the wrappers counting): a 2-D convolution is K1 forward over rows
and columns of both operands and K2 inverse over both axes, nothing else.
"""

import functools

import numpy as np
import pytest
import scipy.signal as ss
import torch

import godsp_tpu.models as J
import godsp_tpu_torch.models as P
from godsp_tpu.fft.pow2 import pow2_convolve2 as j_pow2_convolve2
from godsp_tpu_torch import default_device, dsputils, set_default_device
from godsp_tpu_torch.fft import core, large, pow2
from godsp_tpu_torch.models import conv2d
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
    close = dsputils.pretty_close_c if np.iscomplexobj(want) else dsputils.pretty_close
    assert close(got, want)


RNG = np.random.default_rng(0)
A = RNG.normal(size=(17, 23))
K = RNG.normal(size=(4, 5))
AC = A + 1j * RNG.normal(size=A.shape)
KC = K + 1j * RNG.normal(size=K.shape)
SMALL = RNG.normal(size=(3, 4))  # smaller than the kernels below: pads longer than the axis
BIG_K = RNG.normal(size=(9, 11))

CONV = [(mode, boundary) for mode in ("full", "same", "valid")
        for boundary in ("fill", "wrap", "symm")]


@pytest.mark.parametrize("fn", ["convolve2d", "correlate2d"])
@pytest.mark.parametrize("mode,boundary", CONV)
def test_conv_modes_and_boundaries(fn, mode, boundary):
    _hold(getattr(P, fn)(A, K, mode=mode, boundary=boundary),
          getattr(J, fn)(A, K, mode=mode, boundary=boundary))


@pytest.mark.parametrize("fn", ["convolve2d", "correlate2d"])
@pytest.mark.parametrize("mode,boundary", [(m, b) for m in ("full", "same")
                                           for b in ("fill", "wrap", "symm")])
def test_conv_pads_longer_than_the_axis(fn, mode, boundary):
    got = getattr(P, fn)(SMALL, BIG_K, mode=mode, boundary=boundary, fillvalue=0.5)
    _hold(got, getattr(J, fn)(SMALL, BIG_K, mode=mode, boundary=boundary, fillvalue=0.5))
    want = getattr(ss, fn)(SMALL, BIG_K, mode=mode, boundary=boundary, fillvalue=0.5)
    assert np.allclose(_np(got), want, rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("mode", ["wrap", "symmetric"])
@pytest.mark.parametrize("s,p", [(1, 3), (3, 0), (3, 2), (3, 7), (5, 11)])
def test_pad_by_index_is_np_pad(mode, s, p):
    x = np.arange(2 * s, dtype=np.float64).reshape(2, s) + 1
    got = conv2d._pad2(torch.from_numpy(x.T.copy()), p, p, mode)
    assert np.array_equal(_np(got), np.pad(x.T, p, mode=mode))


@pytest.mark.parametrize("case", ["fillvalue", "complex", "complex_corr", "batched", "np_scalar"])
def test_conv_variants(case):
    a, b, kw, fn = {
        "fillvalue": (A, K, {"mode": "same", "fillvalue": 2.5}, "convolve2d"),
        "complex": (AC, KC, {}, "convolve2d"),
        "complex_corr": (AC, KC, {"boundary": "symm"}, "correlate2d"),
        "batched": (np.stack([A, 2 * A, A - 1.0]), K, {"mode": "valid"}, "convolve2d"),
        "np_scalar": (A, K, {"fillvalue": np.float64(1.5)}, "convolve2d"),
    }[case]
    _hold(getattr(P, fn)(a, b, **kw), getattr(J, fn)(a, b, **kw))


@pytest.mark.parametrize("ks", [(3, 3), (4, 4), (3, 4), (5, 2)])
def test_same_centering_for_odd_and_even_kernels(ks):
    rng = np.random.default_rng(2)
    a, b = rng.normal(size=(12, 13)), rng.normal(size=ks)
    for fn in ("convolve2d", "correlate2d"):
        _hold(getattr(P, fn)(a, b, mode="same"), getattr(J, fn)(a, b, mode="same"))


def test_conv_validation():
    for kw in ({"mode": "bogus"}, {"boundary": "bogus"}):
        with pytest.raises(ValueError):
            P.convolve2d(A, K, **kw)
    with pytest.raises(ValueError):
        P.convolve2d(K, A, mode="valid")
    with pytest.raises(ValueError):
        P.convolve2d(np.zeros(5), K)
    with pytest.raises(ValueError):
        P.convolve2d(A, K, fillvalue=[1.0, 2.0])


@pytest.mark.parametrize("xs,ys", [((8, 16), (8, 16)), ((2, 3, 16, 4), (16, 4)),
                                   ((4, 32), (1, 4, 32)), ((1, 8), (1, 8))])
def test_pow2_convolve2_batched_and_non_square(xs, ys):
    rng = np.random.default_rng(len(xs) + xs[-1])
    x = rng.normal(size=xs) + 1j * rng.normal(size=xs)
    y = rng.normal(size=ys) + 1j * rng.normal(size=ys)
    s = 1.0 / (xs[-1] * xs[-2])
    got = pow2.pow2_convolve2(torch.from_numpy(x), torch.from_numpy(y), scale=s)
    _hold(got, j_pow2_convolve2(x, y, scale=s))
    want = np.fft.ifft2(np.fft.fft2(x) * np.fft.fft2(y)) * (s * xs[-1] * xs[-2])
    assert dsputils.pretty_close_c(_np(got), want)


WIENER = [((A,), {}), ((A,), {"mysize": 5, "noise": 0.1}), ((A,), {"mysize": (3, 5)}),
          ((RNG.normal(size=100),), {"mysize": 7}), ((AC,), {"mysize": 3}),
          ((np.arange(40).reshape(5, 8),), {})]


@pytest.mark.parametrize("args,kw", WIENER, ids=[str(i) for i in range(len(WIENER))])
def test_wiener(args, kw):
    _hold(P.wiener(*args, **kw), J.wiener(*args, **kw))


def test_wiener_validation():
    with pytest.raises(ValueError):
        P.wiener(np.zeros((2, 2, 2)))
    with pytest.raises(ValueError):
        P.wiener(np.zeros((8, 8)), mysize=4)


@pytest.mark.parametrize("shape", [(16, 32), (17, 23), (8, 8), (1, 5)])
def test_hilbert2(shape):
    x = np.random.default_rng(4).normal(size=shape)
    _hold(P.hilbert2(x), J.hilbert2(x))
    with pytest.raises(ValueError):
        P.hilbert2(x + 0j)
    with pytest.raises(ValueError):
        P.hilbert2(np.zeros(8))


@pytest.mark.parametrize("x,hrow,hcol", [(A, RNG.normal(size=5), RNG.normal(size=3)),
                                         (SMALL, RNG.normal(size=11), RNG.normal(size=9)),
                                         (A, np.array([1.0]), np.array([0.25, 0.5, 0.25]))],
                         ids=["5x3", "pads-past-axis", "1x3"])
def test_sepfir2d(x, hrow, hcol):
    _hold(P.sepfir2d(x, hrow, hcol), J.sepfir2d(x, hrow, hcol))


def test_sepfir2d_validation():
    with pytest.raises(ValueError):
        P.sepfir2d(A, np.ones(4), np.ones(3))
    with pytest.raises(ValueError):
        P.sepfir2d(A[0], np.ones(3), np.ones(3))


@pytest.mark.parametrize("k", [3, 5, (3, 5), (1, 7)])
def test_medfilt2d_equal(k):
    x = np.random.default_rng(0).normal(size=(17, 13))
    got = _np(P.medfilt2d(x, k))
    assert np.array_equal(got, np.asarray(J.medfilt2d(x, k)))
    assert np.array_equal(got, ss.medfilt2d(x, k))


@pytest.mark.parametrize("rank", [0, 3, 6])
def test_order_filter_equal(rank):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(12, 11))
    x[3, 4] = np.nan  # NaN sorts last in both
    dom = np.ones((3, 3))
    dom[0, 0] = dom[2, 1] = 0
    got = _np(P.order_filter(x, dom, rank))
    assert np.array_equal(got, np.asarray(J.order_filter(x, dom, rank)), equal_nan=True)
    xi = np.arange(30).reshape(5, 6)
    assert np.array_equal(_np(P.order_filter(xi, dom, rank)),
                          np.asarray(J.order_filter(xi, dom, rank)))


def test_order_filter_validation():
    with pytest.raises(ValueError):
        P.order_filter(np.zeros((4, 4)), np.ones((2, 3)), 1)
    with pytest.raises(ValueError):
        P.order_filter(np.zeros((4, 4)), np.ones((3, 3)), 9)


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


def _counts():
    return {k: v for k, v in launch_counts().items() if v}


@pytest.mark.parametrize("step,want", [
    ("convolve2d", {"fft_pow2": 4, "ifft_pow2": 2}),
    ("convolve2d_symm", {"fft_pow2": 4, "ifft_pow2": 2}),
    ("wiener", {"fft_pow2": 8, "ifft_pow2": 4}),
    ("hilbert2", {"fft_pow2": 2, "ifft_pow2": 2}),
    ("sepfir2d", {"fft_pow2": 4, "ifft_pow2": 2}),
    ("medfilt2d", {}),
])
def test_2d_steps_route_through_the_kernels(cuda_route, step, want):
    rng = np.random.default_rng(9)
    im = torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32))
    k = rng.normal(size=(5, 5)).astype(np.float32)
    h = rng.normal(size=7).astype(np.float32)
    run, ref = {
        "convolve2d": (lambda: P.convolve2d(im, k, mode="same"),
                       lambda x: ss.convolve2d(x, k, mode="same")),
        "convolve2d_symm": (lambda: P.convolve2d(im, k, mode="same", boundary="symm"),
                            lambda x: ss.convolve2d(x, k, mode="same", boundary="symm")),
        "wiener": (lambda: P.wiener(im, 5), lambda x: ss.wiener(x, 5)),
        "hilbert2": (lambda: P.hilbert2(im), ss.hilbert2),
        "sepfir2d": (lambda: P.sepfir2d(im, h, h), None),
        "medfilt2d": (lambda: P.medfilt2d(im, 5), lambda x: ss.medfilt2d(x, 5)),
    }[step]
    got = run()
    assert _counts() == want
    assert got.dtype in (torch.float32, torch.complex64)
    if ref is not None:
        x64 = im.double().numpy()
        assert dsputils.snr_db(_np(got), ref(x64)) >= 100.0
