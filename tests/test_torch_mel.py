"""Parity of godsp_tpu_torch's mel front end with godsp_tpu.

mel_filterbank is the same float64 numpy code in both packages and must
be bitwise equal; mel_spectrogram (log included), stream_mel and mfcc
are held to the JAX package (CPU, x64) at go-dsp's 1e-8 abs-or-rel bound
on the same seeded inputs (mfcc also to the ortho DCT-II of the log-mel
rows, tests/test_models.py's case).  The fused route (K5's mel mode) is held to it in
tests/test_torch_stft.py's route test and on the card in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import scipy.fft as scipy_fft
import torch

from godsp_tpu import models as jmodels
from godsp_tpu_torch import default_device, dsputils, models, set_default_device
from godsp_tpu_torch.ops import cuda_stft


@pytest.fixture(autouse=True)
def _host_data_on_cpu():
    """Host data goes to the CPU here; the port's default device is the card."""
    old = default_device()
    set_default_device("cpu")
    yield
    set_default_device(old)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _signal(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.sin(2 * np.pi * 0.05 * np.arange(n)) + 0.3 * rng.normal(size=n)


@pytest.mark.parametrize("args,kw", [
    ((80, 1024, 44100.0), {}),
    ((40, 512, 16000.0), dict(fmin=50.0, fmax=7600.0)),
    ((20, 256, 8000.0), dict(norm="slaney")),
    ((128, 2048, 22050.0), dict(fmin=0.0, fmax=8000.0, norm="slaney")),
], ids=["hifigan", "band", "slaney", "wide"])
def test_mel_filterbank_bitwise(args, kw):
    got = models.mel_filterbank(*args, **kw)
    want = np.asarray(jmodels.mel_filterbank(*args, **kw))
    assert got.dtype == torch.float64 and want.dtype == np.float64
    np.testing.assert_array_equal(_np(got), want)
    assert models.mel_filterbank(*args, **kw, dtype=torch.float32).dtype == torch.float32


def test_mel_filterbank_errors_match_jax():
    for args, kw in (((10, 256, 8000.0), dict(fmin=5000.0, fmax=4000.0)),
                     ((0, 256, 8000.0), {}), ((10, 256, 8000.0), dict(norm="htk"))):
        with pytest.raises(ValueError) as want:
            jmodels.mel_filterbank(*args, **kw)
        with pytest.raises(ValueError) as got:
            models.mel_filterbank(*args, **kw)
        assert str(got.value) == str(want.value)


def test_mel_band_covers_every_nonzero_bin():
    fb = models.mel_filterbank(80, 1024, 44100.0)
    band = cuda_stft.mel_band(fb)
    bins = torch.arange(fb.shape[1])
    inside = (bins >= band[:, :1]) & (bins <= band[:, 1:])
    assert bool(((fb != 0) <= inside).all())  # no nonzero weight outside its band
    assert cuda_stft.mel_band(torch.zeros(2, 5)).tolist() == [[0, -1], [0, -1]]


@pytest.mark.parametrize("kw", [
    dict(nfft=512, hop=256, n_mels=40),
    dict(nfft=256, hop=100, n_mels=32, window="hamming", log=True),
    dict(nfft=200, hop=80, n_mels=20, norm="slaney"),
    dict(nfft=512, n_mels=40, fmin=100.0, fmax=6000.0, log=True, eps=1e-6),
], ids=["plain", "odd_hop_log", "bluestein_slaney", "band_log"])
def test_mel_spectrogram_matches_jax(kw):
    x = np.stack([_signal(6000, 1), _signal(6000, 2)])
    got = models.mel_spectrogram(x, 16000.0, **kw)
    want = jmodels.mel_spectrogram(x, 16000.0, **kw)
    assert got.shape == want.shape
    assert dsputils.pretty_close(_np(got), np.asarray(want))


def test_stream_mel_matches_one_shot_and_jax():
    x = _signal(12000, 3)
    blocks = [x[:4096], x[4096:8192], x[8192:]]
    kw = dict(n_mels=40, log=True)
    got = list(models.stream_mel(blocks, 16000.0, 512, 256, **kw))
    want = list(jmodels.stream_mel(blocks, 16000.0, 512, 256, **kw))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert dsputils.pretty_close(_np(g), np.asarray(w))
    one_shot = models.mel_spectrogram(x, 16000.0, 512, 256, **kw)
    assert dsputils.pretty_close(_np(torch.cat(got, dim=-2)), _np(one_shot))
    with pytest.raises(ValueError, match="hop must be positive"):
        list(models.stream_mel(blocks, 16000.0, 512, 0))


@pytest.mark.parametrize("x_shape,kw", [
    ((8000,), dict(n_mfcc=13, nfft=512, hop=256, n_mels=40)),
    ((2, 6000), dict(n_mfcc=20, nfft=400, hop=160, n_mels=40, fmin=20.0, fmax=7600.0)),
], ids=["test_models_case", "bluestein_band_batched"])
def test_mfcc_matches_jax(x_shape, kw):
    x = _signal(int(np.prod(x_shape)), 4).reshape(x_shape)
    got = models.mfcc(x, 16000.0, **kw)
    want = jmodels.mfcc(x, 16000.0, **kw)
    frames = (x_shape[-1] - kw["nfft"]) // kw["hop"] + 1
    assert got.shape == (*x_shape[:-1], frames, kw["n_mfcc"]) == want.shape
    assert dsputils.pretty_close(_np(got), np.asarray(want))
    mel_kw = {k: v for k, v in kw.items() if k != "n_mfcc"}
    logmel = models.mel_spectrogram(x, 16000.0, **mel_kw, norm="slaney", log=True)
    assert dsputils.pretty_close(
        _np(got), scipy_fft.dct(_np(logmel), norm="ortho")[..., : kw["n_mfcc"]])


def test_mfcc_errors_match_jax():
    with pytest.raises(ValueError) as want:
        jmodels.mfcc(np.zeros(4096, np.float32), 8000.0, n_mfcc=90, n_mels=80)
    with pytest.raises(ValueError) as got:
        models.mfcc(np.zeros(4096, np.float32), 8000.0, n_mfcc=90, n_mels=80)
    assert str(got.value) == str(want.value)
