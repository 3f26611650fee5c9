"""Parity of the rest of godsp_tpu_torch's FFT surface with godsp_tpu.

fft/ifft/fft_real/convolve at 2^15, fftn/ifftn (the go-dsp golden and a
plain array), Matrix, every fft/helpers.py function and stockham_fft:
the same seeded numpy inputs go through the JAX function (CPU, x64) and
its port (CPU, float64), held to go-dsp's 1e-8 abs-or-rel bound.  The
default-device tests show that host data goes to the card unless the
caller asks for the CPU, and raises where there is no card.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godsp_tpu import dsputils as jdsp
from godsp_tpu import fft as jfft
from godsp_tpu_torch import (
    default_device,
    dsputils,
    fft,
    models,
    set_default_device,
    spectral,
    wav,
    window,
)
from godsp_tpu_torch.parallel import StreamingPwelch
from test_fft import FFTN_TEST

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _host_data_on_cpu():
    """Host data goes to the CPU here; the port's default device is the card."""
    old = default_device()
    set_default_device("cpu")
    yield
    set_default_device(old)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    assert dsputils.pretty_close(got, want)


def _complex(rng, *shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


# ---------------------------------------------------------------- 2^15 API


def test_pow2_api_at_2_15_matches_jax():
    n = 1 << 15
    rng = np.random.default_rng(15)
    x, y, r = _complex(rng, 2, n), _complex(rng, 2, n), rng.normal(size=(2, n))
    _close(fft.fft(x), jfft.fft(jnp.asarray(x)))
    _close(fft.ifft(x), jfft.ifft(jnp.asarray(x)))
    _close(fft.fft_real(r), jfft.fft_real(jnp.asarray(r)))
    _close(fft.convolve(x, y), jfft.convolve(jnp.asarray(x), jnp.asarray(y)))


# ---------------------------------------------------------------- fftn, Matrix


def _matrix_pair(flat, dims):
    return jdsp.make_matrix(np.asarray(flat, np.complex128), dims), \
        dsputils.make_matrix(np.asarray(flat, np.complex128), dims)


def test_fftn_golden_matches_jax():
    jm, m = _matrix_pair(FFTN_TEST["in"], FFTN_TEST["dim"])
    jo, o = _matrix_pair(FFTN_TEST["out"], FFTN_TEST["dim"])
    v = fft.fftn(m)
    assert isinstance(v, dsputils.Matrix) and v.pretty_close(o)
    _close(v.array, jfft.fftn(jm).array)
    vi = fft.ifftn(o)
    assert vi.pretty_close(m)
    _close(vi.array, jfft.ifftn(jo).array)


def test_fftn_on_plain_array_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 3, 4)).astype(np.complex128)
    got = fft.fftn(x)
    assert isinstance(got, torch.Tensor)
    _close(got, jfft.fftn(jnp.asarray(x)))
    _close(fft.ifftn(got), x)


def test_matrix_carries_over_from_jax():
    """A port Matrix built from a godsp_tpu Matrix's array and dims holds
    the same numpy array, and both fftn's agree on it."""
    rng = np.random.default_rng(4)
    jm = jdsp.make_matrix(_complex(rng, 24), [2, 3, 4])
    m = dsputils.make_matrix(jm.array, jm.dimensions())
    assert np.array_equal(m.array, jm.array) and m.dimensions() == jm.dimensions()
    _close(fft.fftn(m).array, jfft.fftn(jm).array)


def _golden_matrix(mod):
    # matrix_test.go:12-22, as tests/test_dsputils.py::TestMatrix
    return mod.make_matrix(
        np.array([1, 2, 3, 4, 5, 6, 7, 8, 9, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 0, 4, 3, 2, 1],
                 dtype=np.complex128), [2, 3, 4])


def test_matrix_lanes_and_values_match_jax():
    jm, m = _golden_matrix(jdsp), _golden_matrix(dsputils)
    for lane in ([1, 0, -1], [0, -1, 2], [-1, 1, 3]):
        assert np.array_equal(m.dim(lane), jm.dim(lane))
    s = np.array([10, 11, 12], dtype=np.complex128)
    for mat in (jm, m):
        mat.set_dim(s, [1, -1, 3])
        mat.set_value(14, [1, -1, 3])  # matrix_test.go:40-42's -1 quirk
    assert m.value([1, -1, 3]) == jm.value([1, -1, 3]) == 14 + 0j
    assert np.array_equal(m.array, jm.array) and m.array.shape == (2, 3, 4)
    assert m.copy().pretty_close(m)
    assert dsputils.make_matrix_2([[1 + 0j, 2], [3, 4]]).to_2d() == \
        jdsp.make_matrix_2([[1 + 0j, 2], [3, 4]]).to_2d()
    assert np.array_equal(dsputils.make_empty_matrix([2, 5]).array,
                          jdsp.make_empty_matrix([2, 5]).array)


@pytest.mark.parametrize("call", [
    lambda d: d.make_matrix_2([[1, 2], [3]]),
    lambda d: d.make_matrix(np.zeros(4, np.complex128), [0, 4]),
    lambda d: d.make_matrix(np.zeros(5, np.complex128), [2, 2]),
    lambda d: _golden_matrix(d).dim([0, 0, 0]),
    lambda d: _golden_matrix(d).dim([-1, -1, 0]),
    lambda d: _golden_matrix(d).value([0, 0]),
], ids=["ragged", "zero-dim", "wrong-length", "no-lane", "two-lanes", "wrong-rank"])
def test_matrix_errors_match_jax(call):
    for mod in (jdsp, dsputils):
        with pytest.raises(ValueError):
            call(mod)


# ---------------------------------------------------------------- helpers

_R = np.random.default_rng(8)
_X1 = _R.normal(size=(3, 20))  # real, even length
_X2 = _R.normal(size=(4, 6, 9))  # real, odd last axis
_C1 = _complex(_R, 3, 11)

HELPER_CASES = {
    "fftfreq": lambda f: f.fftfreq(9, 0.25),
    "rfftfreq": lambda f: f.rfftfreq(10, 0.5),
    "fftshift": lambda f: f.fftshift(_X2),
    "fftshift_axes": lambda f: f.fftshift(_C1, axes=(1,)),
    "ifftshift": lambda f: f.ifftshift(_X2, axes=[0, 2]),
    "hilbert_even": lambda f: f.hilbert(_X1),
    "hilbert_odd_axis0": lambda f: f.hilbert(_X2, axis=0),
    "hilbert_N": lambda f: f.hilbert(_X1, N=33),
    "rfft": lambda f: f.rfft(_X2),
    "rfft_n_axis": lambda f: f.rfft(_X2, n=8, axis=1),
    "irfft": lambda f: f.irfft(_C1),
    "irfft_odd_n": lambda f: f.irfft(_C1, n=21),
    "hfft": lambda f: f.hfft(_C1, n=19),
    "ihfft": lambda f: f.ihfft(_X1),
    "rfft2": lambda f: f.rfft2(_X2),
    "irfft2": lambda f: f.irfft2(_complex(np.random.default_rng(9), 2, 6, 5), s=(6, 8)),
    "rfftn": lambda f: f.rfftn(_X2, s=(5, 6, 10)),
    "irfftn": lambda f: f.irfftn(_complex(np.random.default_rng(10), 4, 6, 5)),
    "hfft2": lambda f: f.hfft2(_complex(np.random.default_rng(11), 3, 4, 5)),
    "hfftn": lambda f: f.hfftn(_complex(np.random.default_rng(12), 3, 4, 5), axes=(0, 2)),
    "ihfft2": lambda f: f.ihfft2(_X2),
    "ihfftn": lambda f: f.ihfftn(_X2, s=(4, 7, 9)),
}


@pytest.mark.parametrize("name", sorted(HELPER_CASES))
def test_helper_matches_jax(name):
    got = HELPER_CASES[name](fft)
    want = HELPER_CASES[name](jfft)
    _close(got, want)


@pytest.mark.parametrize("real", [False, True])
def test_fast_len_planners_match_jax(real):
    for t in (1, 2, 7, 97, 1000, 1025, 4097, 10007, 65537):
        assert fft.next_fast_len(t, real) == jfft.next_fast_len(t, real)
        assert fft.prev_fast_len(t, real) == jfft.prev_fast_len(t, real)
    with pytest.raises(ValueError):
        fft.prev_fast_len(0)


def test_helper_errors_match_jax():
    for f in (fft, jfft):
        for call in (lambda: f.rfft(_C1), lambda: f.ihfft(_C1), lambda: f.rfftn(_C1),
                     lambda: f.rfft(_X1, n=0), lambda: f.hilbert(_X1, N=0)):
            with pytest.raises(ValueError):
                call()


# ---------------------------------------------------------------- Stockham


@pytest.mark.parametrize("inverse", [False, True])
def test_stockham_matches_jax(inverse):
    x = _complex(np.random.default_rng(13), 3, 256)
    got = fft.stockham_fft(x, inverse)
    _close(got, jfft.stockham_fft(jnp.asarray(x), inverse))
    _close(got, np.fft.ifft(x) * 256 if inverse else np.fft.fft(x))
    with pytest.raises(ValueError):
        fft.stockham_fft(np.ones(12))
    fft.ensure_radix2_factors(1024)
    _close(fft.twiddles(8, -1, torch.complex128), jfft.twiddles(8, -1, jnp.complex128))


# ---------------------------------------------------------------- default device


def test_default_device_is_the_card():
    """A fresh import puts host data on "cuda": on a machine with a card
    the result lies there; without one the call raises, never computing on
    the CPU."""
    code = (
        "import numpy as np, torch, godsp_tpu_torch as g\n"
        "assert g.default_device() == torch.device('cuda'), g.default_device()\n"
        "try:\n"
        "    y = g.fft.fft(np.ones(8))\n"
        "except RuntimeError as e:\n"
        "    assert not torch.cuda.is_available(), e\n"
        "    print('raised:', e)\n"
        "else:\n"
        "    assert y.is_cuda, y.device\n"
        "    print('on', y.device)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_cpu_default_routes_host_input_to_the_cpu(tmp_path):
    assert default_device() == torch.device("cpu")
    assert fft.fft(np.ones(8)).device.type == "cpu"
    assert window.window_table("hann", 16).device.type == "cpu"
    assert window.hann(16).device.type == "cpu"
    assert models.mel_filterbank(8, 64, 8000.0).device.type == "cpu"
    assert StreamingPwelch(100.0).device.type == "cpu"
    assert fft.fftfreq(8).device.type == "cpu"
    path = str(tmp_path / "x.wav")
    with wav.WavWriter(path, 8000) as w:
        w.write(np.sin(np.arange(4096) * 0.1))
    s, _, _ = models.spectrogram_from_wav(path, nfft=256)
    assert s.device.type == "cpu"
    assert models.wav_psd(path, spectral.PwelchOptions(nfft=256)).pxx.shape == (129,)


def test_cuda_default_without_a_card_raises(tmp_path):
    """With the default at "cuda": tensors keep their own device, and host
    data raises where there is no card (or lands on it where there is)."""
    set_default_device("cuda")
    assert fft.fft(torch.ones(8, dtype=torch.complex128)).device.type == "cpu"
    path = str(tmp_path / "x.wav")
    with wav.WavWriter(path, 8000) as w:
        w.write(np.sin(np.arange(4096) * 0.1))
    calls = (
        lambda: fft.fft(np.ones(8)),
        lambda: fft.fftn(dsputils.make_empty_matrix([2, 2])),
        lambda: window.window_table("hann", 16),
        lambda: window.hann(16),
        lambda: models.mel_filterbank(8, 64, 8000.0),
        lambda: StreamingPwelch(100.0),
        lambda: models.spectrogram_from_wav(path, nfft=256),
        lambda: models.wav_psd(path, spectral.PwelchOptions(nfft=256)),
    )
    if torch.cuda.is_available():
        assert fft.fft(np.ones(8)).is_cuda
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
