"""The Hopper kernels on the card, against their float64 plain versions.

Every test here is marked `cuda` and skips where torch.cuda.is_available()
is false.  The module imports no jax, so on a GPU machine without jax it
runs on its own, past tests/conftest.py (which imports jax):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Bound: >= 120 dB SNR (the BASELINE parity bar) between a float32 kernel
and its plain version in float64 on the same inputs.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from godsp_tpu_torch import dsputils, fft, spectral, wav, window
from godsp_tpu_torch.fft.bluestein import bluestein_fft
from godsp_tpu_torch.models import wav_psd
from godsp_tpu_torch.ops import cuda_fft, cuda_pwelch, reset_launch_counts

pytestmark = pytest.mark.cuda

SNR_CARD_DB = 120.0


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _golden_pxx():
    """GOLDEN_PXX of tests/test_spectral.py, read without importing jax."""
    src = (pathlib.Path(__file__).parent / "test_spectral.py").read_text()
    for node in ast.parse(src).body:
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "GOLDEN_PXX":
            return np.asarray(ast.literal_eval(node.value))
    raise LookupError("GOLDEN_PXX")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [2, 256, 1024, 16384])
def test_k1_k2_k3_on_card(cuda, n):
    rng = np.random.default_rng(n)
    xr = torch.from_numpy(rng.normal(size=(33, n))).to(cuda)
    xi = torch.from_numpy(rng.normal(size=(33, n))).to(cuda)
    for got, want in (
        (cuda_fft.fft_pow2(xr.float(), xi.float()), cuda_fft.fft_pow2_plain(xr, xi)),
        (cuda_fft.fft_pow2(xr.float(), None), cuda_fft.fft_pow2_plain(xr, None)),
        (cuda_fft.ifft_pow2(xr.float(), xi.float(), 1.0 / n),
         cuda_fft.ifft_pow2_plain(xr, xi, 1.0 / n)),
        (cuda_fft.rfft_pow2(xr.float()), cuda_fft.rfft_pow2_plain(xr)),
    ):
        g = _np(got[0]) + 1j * _np(got[1])
        w = _np(want[0]) + 1j * _np(want[1])
        assert dsputils.snr_db(g, w) >= SNR_CARD_DB


def test_cuda_dispatch_rules(cuda):
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        fft.fft(torch.ones(2, 1 << 15, dtype=torch.complex64, device=cuda))
    with pytest.raises(TypeError):
        cuda_fft.fft_pow2(torch.ones(2, 256, dtype=torch.float64, device=cuda), None)
    y = torch.ones(8, dtype=torch.complex128, device=cuda)
    assert fft.fft(y).dtype == torch.complex64  # cast at the public entry
    for n in (1000, 1331):
        rng = np.random.default_rng(n)
        x = torch.from_numpy(rng.normal(size=(4, n)) + 1j * rng.normal(size=(4, n))).to(cuda)
        got = _np(fft.fft(x))
        fft.set_kernels_enabled(False)
        try:
            assert fft.fft(x).dtype == torch.complex64  # the switch changes the route only
            want = _np(bluestein_fft(x))  # plain route beneath the entry, float64
        finally:
            fft.set_kernels_enabled(True)
        assert dsputils.snr_db(got, want) >= SNR_CARD_DB


def test_plain_fft_keeps_tf32_flags(cuda):
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    x = torch.ones(4, 4096, dtype=torch.complex64, device=cuda)
    fft.four_step_fft(x)
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == before


@pytest.mark.parametrize("nfft,stride,pad", [(1024, 512, 1024), (1024, 160, 1024),
                                             (1024, 512, 2048), (256, 256, 16384)])
def test_k4_on_card(cuda, nfft, stride, pad):
    rng = np.random.default_rng(pad + stride)
    S = 301
    ext = torch.from_numpy(rng.normal(size=(2, (S - 1) * stride + nfft))).to(cuda)
    mask = torch.from_numpy((np.arange(S) < S - 7).astype(np.float64)).to(cuda).expand(2, S)
    w = window.window_table("hann", pad, device=cuda)
    got = cuda_pwelch.pwelch_power_partials(ext.float(), mask.float(), w.float(), nfft, stride,
                                            pad=pad)
    want = cuda_pwelch.pwelch_power_partials_plain(ext, mask, w, nfft, stride, pad,
                                                   cuda_pwelch.segs_per_tile(S, 2))
    assert dsputils.snr_db(_np(got), _np(want)) >= SNR_CARD_DB


def test_pwelch_on_card(cuda):
    pxx, _ = spectral.pwelch(torch.arange(100.0, device=cuda), 2.0)
    assert pxx.dtype == torch.float32
    assert dsputils.snr_db(_np(pxx), _golden_pxx()) >= SNR_CARD_DB
    rng = np.random.default_rng(1)
    x = rng.normal(size=50000)
    o = spectral.PwelchOptions(nfft=1024, noverlap=512)
    got = _np(spectral.pwelch(torch.from_numpy(x).to(cuda), 1.0, o)[0])
    assert dsputils.snr_db(got, _np(spectral.pwelch(x, 1.0, o)[0])) >= SNR_CARD_DB


def test_wav_psd_on_card(tmp_path, cuda):
    path = str(tmp_path / "rec.wav")
    rng = np.random.default_rng(7)
    t = np.arange(1_000_003) / 44100
    x = 0.4 * np.sin(2 * np.pi * 1000.0 * t) + 0.05 * rng.normal(size=t.size)
    with wav.WavWriter(path, 44100, float32=False) as w:
        w.write(x)
    o = spectral.PwelchOptions(nfft=1024, noverlap=512)
    want = wav_psd(path, o)  # CPU float64
    reset_launch_counts()
    got = wav_psd(path, o, device=cuda)
    chunks = int(got.metrics_json.split('"chunks": ')[1].split(",")[0])
    assert cuda_pwelch.launches["pwelch_power_partials"] == chunks
    assert dsputils.snr_db(got.pxx, want.pxx) >= SNR_CARD_DB
