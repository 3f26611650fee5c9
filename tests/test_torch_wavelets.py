"""godsp_tpu_torch's wavelets (models/wavelets.py) against godsp_tpu.

The wavelets are host numpy copies and must be equal; cwt runs on the CPU
in float64 and is held to godsp_tpu (JAX on the CPU, x64) on the same
seeded numpy inputs at go-dsp's 1e-8 abs-or-rel bound
(dsputils.pretty_close), and to a float64 per-row np.convolve(...,
"same") oracle.  The cases follow tests/test_wavelets.py.  The route test
sends float32 CPU tensors down the CUDA route (kernel_route patched, the
wrappers counting): the bank is one batched convolution, K1 for the
signal and the bank and K2 for the inverse, or the large plan past 16384.
"""

import functools

import numpy as np
import pytest
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
    assert got.shape == want.shape and got.dtype.kind == want.dtype.kind
    close = dsputils.pretty_close_c if np.iscomplexobj(want) else dsputils.pretty_close
    assert close(got, want)


def _oracle(x, wavelet, widths, **kw):
    out = []
    for w in widths:
        k = np.conj(wavelet(int(min(10 * w, len(x))), w, **kw)[::-1])
        out.append(np.convolve(x, k, mode="same"))
    return np.array(out)


@pytest.mark.parametrize("name,args", [("ricker", (101, 10.0)), ("ricker", (2001, 3.5)),
                                       ("morlet", (64,)), ("morlet", (65, 6.0, 0.5, False)),
                                       ("morlet2", (100, 5.0)), ("morlet2", (33, 2.0, 7.0))])
def test_wavelets_are_copies(name, args):
    got, want = getattr(P, name)(*args), getattr(J, name)(*args)
    assert isinstance(got, np.ndarray) and np.array_equal(got, np.asarray(want))


RNG = np.random.default_rng(0)
X = RNG.normal(size=500)
CWT = [
    ("ricker", X, np.arange(1, 31), {}),
    ("morlet2", X[:300], np.geomspace(1, 25, 12), {"w": 6.0}),
    ("ricker", X[:40], [1, 5, 80], {}),  # 10 * 80 far exceeds n = 40
    ("ricker", X[:300] + 1j * RNG.normal(size=300), [2.0, 7.5], {}),
    ("ricker", X[:1], [1.0, 3.0], {}),
]


@pytest.mark.parametrize("wavelet,x,widths,kw", CWT, ids=[str(i) for i in range(len(CWT))])
def test_cwt_matches_godsp_tpu_and_the_oracle(wavelet, x, widths, kw):
    got = P.cwt(x, getattr(P, wavelet), widths, **kw)
    _hold(got, J.cwt(x, getattr(J, wavelet), widths, **kw))
    assert dsputils.pretty_close_c(_np(got), _oracle(x, getattr(P, wavelet), widths, **kw))


def test_cwt_takes_a_tensor_and_validates():
    _hold(P.cwt(torch.from_numpy(X), P.ricker, [3.0, 9.0]), J.cwt(X, J.ricker, [3.0, 9.0]))
    for data, widths in ((np.zeros((2, 3)), [1.0]), (np.zeros(8), [-1.0]), (np.zeros(0), [1.0]),
                         (np.zeros(8), [[1.0]])):
        with pytest.raises(ValueError):
            P.cwt(data, P.ricker, widths)


def test_chirp_ridge():
    """The scalogram ridge follows a rising chirp toward smaller widths."""
    t = np.linspace(0, 1, 800)
    sig = np.cos(2 * np.pi * (30 * t + 40 * t**2))
    C = np.abs(_np(P.cwt(sig, P.morlet2, np.geomspace(2, 40, 24), w=6.0)))
    ridge = np.argmax(C, axis=0)
    assert ridge[100] > ridge[-100]


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


@pytest.mark.parametrize("n,want", [(3000, {"fft_pow2": 2, "ifft_pow2": 1}),
                                    (20000, {"outer_dft_split": 3, "fft_pow2": 2,
                                             "ifft_pow2": 1})])
def test_cwt_routes_through_the_kernels(cuda_route, n, want):
    x = np.random.default_rng(n).normal(size=n).astype(np.float32)
    widths = np.arange(1, 9)
    got = P.cwt(torch.from_numpy(x), P.ricker, widths)
    assert {k: v for k, v in launch_counts().items() if v} == want
    assert got.dtype == torch.float32 and got.shape == (8, n)
    assert dsputils.snr_db(_np(got), _oracle(x.astype(np.float64), P.ricker, widths)) >= 100.0
