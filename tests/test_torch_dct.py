"""Parity of godsp_tpu_torch's DCT/DST family (fft/_dct_impl.py) with godsp_tpu.

The cases of tests/test_fft.py (TestDCT, TestTrigTransformFamily,
TestScipyFftNames.test_dctn_family) as parametrised cases: the port runs
on the CPU in float64 and is held to godsp_tpu (JAX on the CPU, x64) on
the same seeded inputs at go-dsp's 1e-8 abs-or-rel bound
(dsputils.pretty_close), and to scipy.fft at >= 200 dB, the JAX tests'
own bar.  Round trips are held to the input at >= 200 dB.
"""

import numpy as np
import pytest
import scipy.fft as sfft
import torch

from godsp_tpu import fft as jfft
from godsp_tpu_torch import default_device, dsputils, fft, set_default_device

SNR_DB = 200.0  # float64 against scipy: the structure is exact


@pytest.fixture(autouse=True)
def _host_data_on_cpu():
    """Host data goes to the CPU here; the port's default device is the card."""
    old = default_device()
    set_default_device("cpu")
    yield
    set_default_device(old)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _hold(got, jax_out, ref):
    got = _np(got)
    assert got.dtype == np.float64 and got.shape == ref.shape
    assert dsputils.pretty_close(got, np.asarray(jax_out))
    assert dsputils.snr_db(got, ref) >= SNR_DB


NAMES = ("dct", "dst", "idct", "idst")
SIZES = (2, 5, 8, 31, 128)


@pytest.mark.parametrize("norm", [None, "ortho"])
@pytest.mark.parametrize("t", [1, 2, 3, 4])
@pytest.mark.parametrize("name", NAMES)
def test_trig_transforms_match_jax_and_scipy(name, t, norm):
    rng = np.random.default_rng(t)
    for n in SIZES:
        x = rng.normal(size=n)
        _hold(getattr(fft, name)(x, type=t, norm=norm), getattr(jfft, name)(x, type=t, norm=norm),
              getattr(sfft, name)(x, type=t, norm=norm))


@pytest.mark.parametrize("n", [4, 8, 100, 256, 1024])
def test_dct2_batched_matches_jax_and_scipy(n):
    x = np.random.default_rng(n).normal(size=(3, n))
    for norm in (None, "ortho"):
        _hold(fft.dct(x, norm=norm), jfft.dct(x, norm=norm), sfft.dct(x, 2, norm=norm))


@pytest.mark.parametrize("t", [1, 2, 3, 4])
def test_round_trips(t):
    x = np.random.default_rng(10 + t).normal(size=24)
    for norm in (None, "ortho"):
        for fwd, inv in ((fft.dct, fft.idct), (fft.dst, fft.idst)):
            assert dsputils.snr_db(_np(inv(fwd(x, t, norm), t, norm)), x) >= SNR_DB


def test_dst4_batched_and_torch_input():
    xb = np.random.default_rng(20).normal(size=(3, 32))
    got = fft.dst(torch.from_numpy(xb), 4)
    assert got.device.type == "cpu"
    _hold(got, jfft.dst(xb, 4), sfft.dst(xb, 4))


@pytest.mark.parametrize("t", [1, 2, 3, 4])
@pytest.mark.parametrize("name", ["dctn", "idctn", "dstn", "idstn"])
def test_nd_transforms_match_jax_and_scipy(name, t):
    A = np.random.default_rng(3).normal(size=(8, 12, 5))
    for norm in (None, "ortho"):
        for axes in (None, (0, 2), 1):
            _hold(getattr(fft, name)(A, type=t, axes=axes, norm=norm),
                  getattr(jfft, name)(A, type=t, axes=axes, norm=norm),
                  getattr(sfft, name)(A, type=t, axes=axes, norm=norm))


@pytest.mark.parametrize("call", [
    lambda f: f.dct(np.ones(8), norm="x"),
    lambda f: f.dct(np.ones(8, dtype=np.complex128)),
    lambda f: f.dct(np.ones(8), type=5),
    lambda f: f.dst(np.ones(8), norm="bogus"),
    lambda f: f.dct(np.ones(1), type=1),
    lambda f: f.dctn(np.zeros((4, 4)), axes=(0, 0)),
], ids=["norm", "complex", "type", "dst-norm", "dct1-one-point", "dup-axes"])
def test_errors_match_jax(call):
    with pytest.raises(ValueError) as want:
        call(jfft)
    with pytest.raises(ValueError) as got:
        call(fft)
    assert str(got.value) == str(want.value)


def test_empty_and_float32():
    assert fft.dct(np.zeros(0)).shape == (0,)
    x = np.random.default_rng(5).normal(size=(4, 64)).astype(np.float32)
    got = fft.dct(torch.from_numpy(x), norm="ortho")
    assert got.dtype == torch.float32  # the input's precision is kept on the CPU
    assert dsputils.snr_db(_np(got), sfft.dct(x.astype(np.float64), norm="ortho")) >= 120.0
