"""The Hopper kernels on the card, against their float64 plain versions.

Every test here is marked `cuda` and skips where torch.cuda.is_available()
is false.  The module imports no jax, so on a GPU machine without jax it
runs on its own, past tests/conftest.py (which imports jax):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Bound: >= 120 dB SNR (the BASELINE parity bar) between a float32 kernel
(K1-K11) and its plain version in float64 on the same inputs, and between
the public entry points on the card and the CPU in float64 (a synthesized
signal over its interior, away from the NOLA-divided ends).
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from godsp_tpu_torch import (
    default_device,
    dsputils,
    fft,
    models,
    parallel,
    set_default_device,
    spectral,
    wav,
    window,
)
from godsp_tpu_torch.fft.bluestein import bluestein_fft
from godsp_tpu_torch.fft.pow2 import pow2_convolve
from godsp_tpu_torch.models import wav_psd
from godsp_tpu_torch.ops import (
    _build,
    cuda_csd,
    cuda_fft,
    cuda_fused_halo,
    cuda_halo,
    cuda_istft,
    cuda_outer,
    cuda_pwelch,
    cuda_stft,
    launch_counts,
    reset_launch_counts,
)

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


@pytest.fixture(autouse=True)
def _host_data_on_the_card():
    """The port's default: host data goes to the card (CPU references here
    ask for the CPU with CPU tensors or device="cpu")."""
    old = default_device()
    set_default_device("cuda")
    yield
    set_default_device(old)


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
    big = torch.ones(1, dtype=torch.complex64, device=cuda).expand(1 << 29)  # no 4 GB buffer
    with pytest.raises(NotImplementedError, match="2\\^28"):
        fft.fft(big)
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


@pytest.mark.parametrize("nfft,stride,pad", [(1024, 512, 1024), (1000, 160, 1024),
                                             (1024, 156, 2048), (256, 256, 16384)])
def test_k7_on_card(cuda, nfft, stride, pad):
    """K7 at phase 7's geometry, the speech hop with pad > nfft, an odd
    stride, and pad 16384 (the shared-memory limit: one buffer, the X_k
    in registers)."""
    rng = np.random.default_rng(pad + stride)
    S = 301
    ext_x = torch.from_numpy(rng.normal(size=(2, (S - 1) * stride + nfft))).to(cuda)
    ext_y = 0.3 * ext_x + torch.from_numpy(rng.normal(size=ext_x.shape)).to(cuda)
    mask = torch.from_numpy((np.arange(S) < S - 7).astype(np.float64)).to(cuda).expand(2, S)
    w = window.window_table("hann", pad, device=cuda)
    before = launch_counts()["csd_power_partials"]
    re, im = cuda_csd.csd_power_partials(ext_x.float(), ext_y.float(), mask.float(), w.float(),
                                         nfft, stride, pad=pad)
    assert launch_counts()["csd_power_partials"] == before + 1
    wre, wim = cuda_csd.csd_power_partials_plain(ext_x, ext_y, mask, w, nfft, stride, pad,
                                                 cuda_pwelch.segs_per_tile(S, 2))
    got = torch.complex(re, im).to(torch.complex128)
    assert dsputils.snr_db(_np(got), _np(torch.complex(wre, wim))) >= SNR_CARD_DB


def test_pwelch_on_card(cuda):
    pxx, _ = spectral.pwelch(torch.arange(100.0, device=cuda), 2.0)
    assert pxx.dtype == torch.float32
    assert dsputils.snr_db(_np(pxx), _golden_pxx()) >= SNR_CARD_DB
    rng = np.random.default_rng(1)
    x = rng.normal(size=50000)
    o = spectral.PwelchOptions(nfft=1024, noverlap=512)
    got = spectral.pwelch(x, 1.0, o)[0]  # host data, no device: the card
    assert got.is_cuda
    want = spectral.pwelch(torch.from_numpy(x), 1.0, o)[0]
    assert dsputils.snr_db(_np(got), _np(want)) >= SNR_CARD_DB


def test_wav_psd_on_card(tmp_path, cuda):
    path = str(tmp_path / "rec.wav")
    rng = np.random.default_rng(7)
    t = np.arange(1_000_003) / 44100
    x = 0.4 * np.sin(2 * np.pi * 1000.0 * t) + 0.05 * rng.normal(size=t.size)
    with wav.WavWriter(path, 44100, float32=False) as w:
        w.write(x)
    o = spectral.PwelchOptions(nfft=1024, noverlap=512)
    want = wav_psd(path, o, device="cpu")  # float64
    reset_launch_counts()
    got = wav_psd(path, o, device=cuda)
    chunks = int(got.metrics_json.split('"chunks": ')[1].split(",")[0])
    assert cuda_pwelch.launches["pwelch_power_partials"] == chunks
    assert dsputils.snr_db(got.pxx, want.pxx) >= SNR_CARD_DB


def _hann(nfft, pad, dev):
    return torch.nn.functional.pad(window.window_table("hann", nfft, device=dev), (0, pad - nfft))


@pytest.mark.parametrize("out,nfft,hop,pad", [
    ("complex", 1024, 256, 1024), ("complex", 1024, 160, 2048), ("complex", 256, 256, 16384),
    ("complex", 2, 1, 2), ("power", 1024, 512, 1024), ("power", 500, 333, 512),
    ("mel", 1024, 256, 1024), ("mel", 400, 160, 512),
])
def test_k5_on_card(cuda, out, nfft, hop, pad):
    rng = np.random.default_rng(nfft + hop + pad)
    x = torch.from_numpy(rng.normal(size=(2, 3, 20000))).to(cuda)
    F = (20000 - nfft) // hop + 1
    w = _hann(nfft, pad, cuda)
    fb = models.mel_filterbank(40, pad, 16000.0, device=cuda) if out == "mel" else None
    extra = (fb.float(),) if out == "mel" else ()
    got = getattr(cuda_stft, f"stft_{out}")(x.float(), w.float(), nfft, hop, F, *extra, pad=pad)
    want = cuda_stft.stft_pallas_plain(x, w, nfft, hop, F, pad, out, fb)
    assert got.shape == want.shape
    assert dsputils.snr_db(_np(got), _np(want)) >= SNR_CARD_DB


@pytest.mark.parametrize("nfft,hop,pad,onesided", [
    (1024, 256, 1024, True), (1024, 160, 2048, True), (384, 128, 512, False), (256, 1, 256, True),
    (16384, 4096, 16384, True),  # the span in shared memory: 224 KB a block
    (16384, 1024, 16384, True),  # the span past shared memory: accumulated in the output row
])
def test_k6_on_card(cuda, nfft, hop, pad, onesided):
    rng = np.random.default_rng(nfft + hop)
    F, bins = 40 if nfft > 1024 else 600, pad // 2 + 1 if onesided else pad
    spec = torch.from_numpy(rng.normal(size=(2, F, bins)) + 1j * rng.normal(size=(2, F, bins)))
    spec = spec.to(cuda)
    w = window.window_table("hamming", nfft, device=cuda)
    got = cuda_istft.istft_overlap_add(spec.to(torch.complex64), w.float(), nfft, hop, onesided)
    want = cuda_istft.istft_overlap_add_plain(spec, w, nfft, hop, onesided)
    assert got.shape == want.shape == (2, (F - 1) * hop + nfft)
    assert dsputils.snr_db(_np(got), _np(want)) >= SNR_CARD_DB


@pytest.mark.parametrize("F,rows,bt", [(50, 1, 3), (2500, 2, 10), (20000, 2, 64)])
def test_k6_tile_stitch_at_the_tail_bound(cuda, F, rows, bt):
    """Tiles of bt frames, from bt*hop just above nfft - hop (3 * 300 >= 724:
    each tail reaches only the next tile) to the 64-frame cap."""
    nfft, hop = 1024, 300
    assert cuda_istft.tile_frames(F, rows, nfft, hop) == bt
    rng = np.random.default_rng(F)
    shape = (rows, F, 513)
    spec = torch.from_numpy(rng.normal(size=shape) + 1j * rng.normal(size=shape)).to(cuda)
    w = window.window_table("hann", nfft, device=cuda)
    want = cuda_istft.istft_overlap_add_plain(spec, w, nfft, hop)
    got = cuda_istft.istft_overlap_add(spec.to(torch.complex64), w.float(), nfft, hop)
    assert dsputils.snr_db(_np(got), _np(want)) >= SNR_CARD_DB


def test_more_rows_than_grid_y(cuda):
    """70,000 short rows, past grid.y's 65535: K4, K5 and K6 each serve them
    in one launch, as do the public entry points."""
    rows, nfft, hop, F = 70_000, 32, 16, 7
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(rows, (F - 1) * hop + nfft))).to(cuda)
    xf = x.float()
    w = window.window_table("hann", nfft, device=cuda)
    fb = models.mel_filterbank(8, nfft, 16000.0, device=cuda)
    reset_launch_counts()
    for out, extra in (("complex", ()), ("power", ()), ("mel", (fb.float(),))):
        got = getattr(cuda_stft, f"stft_{out}")(xf, w.float(), nfft, hop, F, *extra)
        want = cuda_stft.stft_pallas_plain(x, w, nfft, hop, F, nfft, out, fb)
        assert dsputils.snr_db(_np(got), _np(want)) >= SNR_CARD_DB, out
    spec = cuda_stft.stft_pallas_plain(x, w, nfft, hop, F)
    got = cuda_istft.istft_overlap_add(spec.to(torch.complex64), w.float(), nfft, hop)
    want = cuda_istft.istft_overlap_add_plain(spec, w, nfft, hop)
    assert dsputils.snr_db(_np(got), _np(want)) >= SNR_CARD_DB
    mask = torch.ones(rows, F, dtype=torch.float64, device=cuda)
    got = cuda_pwelch.pwelch_power_partials(xf, mask.float(), w.float(), nfft, hop)
    want = cuda_pwelch.pwelch_power_partials_plain(x, mask, w, nfft, hop, nfft,
                                                   cuda_pwelch.segs_per_tile(F, rows))
    assert dsputils.snr_db(_np(got), _np(want)) >= SNR_CARD_DB
    y = torch.flip(x, dims=(0,))
    got = torch.complex(*cuda_csd.csd_power_partials(xf, y.float(), mask.float(), w.float(),
                                                     nfft, hop))
    want = torch.complex(*cuda_csd.csd_power_partials_plain(x, y, mask, w, nfft, hop, nfft,
                                                            cuda_pwelch.segs_per_tile(F, rows)))
    assert dsputils.snr_db(_np(got), _np(want)) >= SNR_CARD_DB
    s = models.stft(xf, nfft, hop=hop)
    assert dsputils.snr_db(_np(s), _np(models.stft(x.cpu(), nfft, hop=hop))) >= SNR_CARD_DB
    y = models.istft(s, nfft, hop=hop)
    ref = models.istft(s.cpu().to(torch.complex128), nfft, hop=hop)
    assert y.shape == ref.shape == x.shape
    assert dsputils.snr_db(_np(y)[:, nfft:-nfft], _np(ref)[:, nfft:-nfft]) >= SNR_CARD_DB
    m = models.mel_spectrogram(xf, 16000.0, nfft=nfft, hop=hop, n_mels=8)
    want = models.mel_spectrogram(x.cpu(), 16000.0, nfft=nfft, hop=hop, n_mels=8)
    assert dsputils.snr_db(_np(m), _np(want)) >= SNR_CARD_DB
    assert launch_counts() == {**{k: 0 for k in launch_counts()}, "stft_complex": 2,
                               "stft_power": 1, "stft_mel": 2, "istft_overlap_add": 2,
                               "pwelch_power_partials": 1, "csd_power_partials": 1}


def test_stft_wrappers_raise_when_the_library_fails(cuda, monkeypatch):
    def broken():
        raise RuntimeError("nvcc failed: simulated")

    monkeypatch.setattr(_build, "library", broken)
    x = torch.rand(8192, device=cuda)
    w = window.window_table("hann", 1024, device=cuda, dtype=torch.float32)
    fb = models.mel_filterbank(80, 1024, 44100.0, device=cuda)
    spec = torch.ones(13, 513, dtype=torch.complex64, device=cuda)
    for call in (
        lambda: cuda_stft.stft_complex(x, w, 1024, 256, 29),
        lambda: cuda_stft.stft_power(x, w, 1024, 256, 29),
        lambda: cuda_stft.stft_mel(x, w, 1024, 256, 29, fb),
        lambda: cuda_istft.istft_overlap_add(spec, w, 1024, 256),
        lambda: models.stft(x, 1024, hop=256),
        lambda: models.spectrogram(x, 1024, hop=256),
        lambda: models.mel_spectrogram(x, 44100.0),
        lambda: models.istft(spec, 1024, hop=256),
    ):
        with pytest.raises(RuntimeError, match="simulated"):
            call()


def test_csd_wrappers_raise_when_the_library_fails(cuda, monkeypatch):
    def broken():
        raise RuntimeError("nvcc failed: simulated")

    monkeypatch.setattr(_build, "library", broken)
    x = torch.rand(8192, device=cuda)
    w = window.window_table("hann", 1024, device=cuda, dtype=torch.float32)
    mask = torch.ones(15, device=cuda)
    for call in (
        lambda: cuda_csd.csd_power_partials(x, x, mask, w, 1024, 512),
        lambda: cuda_csd.csd_power_sum(x, x, w, 1024, 512, 15),
        lambda: spectral.csd(x, x, 1.0, spectral.PwelchOptions(nfft=1024, noverlap=512)),
        lambda: spectral.welch_csd(x, x, nperseg=1024, detrend=False),
    ):
        with pytest.raises(RuntimeError, match="simulated"):
            call()


def test_csd_at_stride_156_launches_k7_and_no_fft(cuda):
    rng = np.random.default_rng(156)
    x, y = (torch.from_numpy(rng.normal(size=40000)).to(cuda) for _ in range(2))
    for o in (spectral.PwelchOptions(nfft=256, noverlap=100),
              spectral.PwelchOptions(nfft=1000, noverlap=840, pad=1024)):
        reset_launch_counts()
        spectral.csd(x, y, 1.0, o)
        assert launch_counts() == {**{k: 0 for k in launch_counts()}, "csd_power_partials": 1}


def test_scipy_spectra_on_card(cuda):
    """welch, welch_csd, welch_coherence, spectrogram_scipy and csd on the
    card against the CPU in float64, each through its kernel."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(size=(2, 60000)))  # the CPU float64 reference's input
    y = 0.7 * torch.roll(x, 37, dims=-1) + torch.from_numpy(rng.normal(size=x.shape))
    xc, yc = x.to(cuda), y.to(cuda)
    kw = dict(fs=44100.0, nperseg=1024, detrend=False)
    steps = (
        (lambda a, b: spectral.welch(a, **kw)[1], {"pwelch_power_partials": 1}),
        (lambda a, b: spectral.welch_csd(a, b, **kw)[1], {"csd_power_partials": 1}),
        (lambda a, b: spectral.welch_coherence(a, b, **kw)[1],
         {"pwelch_power_partials": 2, "csd_power_partials": 1}),
        (lambda a, b: spectral.spectrogram_scipy(a, **kw)[2], {"stft_power": 1}),
        (lambda a, b: spectral.csd(a, b, 2.0, spectral.PwelchOptions(nfft=1024, noverlap=864))[0],
         {"csd_power_partials": 1}),
        (lambda a, b: spectral.coherence(a, b, 2.0, spectral.PwelchOptions(nfft=1024,
                                                                           noverlap=864))[0],
         {"csd_power_partials": 1, "pwelch_power_partials": 2}),
    )
    for fn, launched in steps:
        reset_launch_counts()
        got = fn(xc, yc)
        assert launch_counts() == {**{k: 0 for k in launch_counts()}, **launched}
        assert got.is_cuda and got.dtype in (torch.float32, torch.complex64)
        assert dsputils.snr_db(_np(got), _np(fn(x, y))) >= SNR_CARD_DB
    got = spectral.welch(xc, **{**kw, "detrend": "constant"})[1]
    assert dsputils.snr_db(_np(got), _np(spectral.welch(x, **{**kw, "detrend": "constant"})[1])) \
        >= SNR_CARD_DB


def test_stft_family_on_card(cuda, tmp_path):
    """The public entry points on the card against the CPU in float64, and
    each reaches its kernel."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=50000))  # the CPU float64 reference's input
    xc = x.to(cuda)
    reset_launch_counts()
    s = models.stft(xc, 1024, hop=256)
    assert s.dtype == torch.complex64
    assert dsputils.snr_db(_np(s), _np(models.stft(x, 1024, hop=256))) >= SNR_CARD_DB
    p = models.spectrogram(xc, 1024, hop=160, pad=2048)
    assert dsputils.snr_db(_np(p), _np(models.spectrogram(x, 1024, hop=160, pad=2048))) >= 120
    m = models.mel_spectrogram(xc, 44100.0, nfft=1024, hop=256, n_mels=80)
    want = models.mel_spectrogram(x, 44100.0, nfft=1024, hop=256, n_mels=80)
    assert dsputils.snr_db(_np(m), _np(want)) >= SNR_CARD_DB
    y = models.istft(s, 1024, hop=256)
    ref = models.istft(s.cpu().to(torch.complex128), 1024, hop=256)
    assert dsputils.snr_db(_np(y)[1024:-1024], _np(ref)[1024:-1024]) >= SNR_CARD_DB
    blocks = list(models.stream_istft([s[:40], s[40:100], s[100:]], 1024, hop=256))
    assert dsputils.snr_db(_np(torch.cat(blocks))[1024:-1024], _np(ref)[1024:-1024]) >= 120
    g = models.griffin_lim(s.abs(), 1024, hop=256, n_iter=0)
    gref = models.griffin_lim(s.abs().cpu().double(), 1024, hop=256, n_iter=0)
    assert dsputils.snr_db(_np(g), _np(gref)) >= SNR_CARD_DB
    assert launch_counts() == {**{k: 0 for k in launch_counts()}, "stft_complex": 1,
                               "stft_power": 1, "stft_mel": 1, "istft_overlap_add": 1 + 3 + 1}
    path = str(tmp_path / "synth.wav")
    n = models.spectra_to_wav([s[:100], s[100:]], path, 44100, 1024, hop=256)
    r = wav.read_wav(path)
    assert n == r.samples == y.shape[-1]
    back = r.read_floats(r.samples)
    assert dsputils.snr_db(back[1024:-1024], _np(ref)[1024:-1024]) >= SNR_CARD_DB


def _crandn(dev, *shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.complex(torch.randn(*shape, generator=g, device=dev, dtype=torch.float64),
                         torch.randn(*shape, generator=g, device=dev, dtype=torch.float64))


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("b,d1,d2,n3", [
    (4, 128, 1, 8192),  # fft of 4 x 2^20: one call
    (1, 1024, 1, 16384),  # 2^24
    (1, 2048, 1, 16384),  # 2^25, the largest one-call m
    (1, 64, 1, 1 << 20),  # 2^26, two calls: the first ...
    (64, 64, 1, 16384),  # ... and the second
    (2, 4, 4, 256),  # godsp_tpu's two-level row order
    (3, 8, 2, 1000),  # a ragged last column tile
])
def test_k8_on_card(cuda, b, d1, d2, n3, inverse):
    x = _crandn(cuda, b, d1 * d2, n3, seed=d1 + n3)
    before = launch_counts()["outer_dft_split"]
    got = cuda_outer.outer_dft_split(x.real.float(), x.imag.float(), d1, d2, inverse)
    assert launch_counts()["outer_dft_split"] == before + 1
    want = cuda_outer.outer_dft_split_plain(x.real.contiguous(), x.imag.contiguous(), d1, d2,
                                            inverse)
    g, w = torch.complex(*got).to(torch.complex128), torch.complex(*want)
    assert dsputils.snr_db(_np(g), _np(w)) >= SNR_CARD_DB


def _oracle(fn):
    fft.set_kernels_enabled(False)
    try:
        return fn()
    finally:
        fft.set_kernels_enabled(True)


@pytest.mark.parametrize("shape", [(1 << 15,), (4, 1 << 20), (1 << 24,)],
                         ids=["2^15", "4x2^20", "2^24"])
def test_large_fft_on_card(cuda, shape):
    n = shape[-1]
    x = _crandn(cuda, *shape, seed=n)
    reset_launch_counts()
    y = fft.fft(x.to(torch.complex64))
    assert launch_counts()["outer_dft_split"] >= 1 and launch_counts()["fft_pow2"] == 1
    assert y.dtype == torch.complex64 and y.shape == x.shape
    assert dsputils.snr_db(_np(y), _np(fft.four_step_fft(x))) >= SNR_CARD_DB
    z = fft.ifft(y)
    assert launch_counts()["ifft_pow2"] == 1
    assert dsputils.snr_db(_np(z), _np(x)) >= SNR_CARD_DB


@pytest.mark.parametrize("n", [10000, 100_003])
def test_bluestein_over_the_large_plan_on_card(cuda, n):
    x = _crandn(cuda, 2, n, seed=n)
    reset_launch_counts()
    got = fft.fft(x.to(torch.complex64))
    assert launch_counts()["outer_dft_split"] == 2 and launch_counts()["ifft_pow2"] == 1
    want = _oracle(lambda: bluestein_fft(x))
    assert dsputils.snr_db(_np(got), _np(want)) >= SNR_CARD_DB


def test_convolve_2_17_on_card(cuda):
    n = 1 << 17
    a, b = _crandn(cuda, 2, n, seed=1), _crandn(cuda, 2, n, seed=2)
    reset_launch_counts()
    got = fft.convolve(a.to(torch.complex64), b.to(torch.complex64))
    assert launch_counts()["outer_dft_split"] == 3
    want = _oracle(lambda: pow2_convolve(a, b, scale=1.0 / n))
    assert dsputils.snr_db(_np(got), _np(want)) >= SNR_CARD_DB


def test_fftn_of_a_matrix_on_card(cuda):
    rng = np.random.default_rng(64)
    flat = rng.normal(size=64 ** 3) + 1j * rng.normal(size=64 ** 3)
    m = dsputils.make_matrix(flat, [64, 64, 64])  # host data, no device: the card
    reset_launch_counts()
    got = fft.fftn(m)
    assert launch_counts()["fft_pow2"] == 3
    assert isinstance(got, dsputils.Matrix)
    assert dsputils.snr_db(got.array, np.fft.fftn(m.array)) >= SNR_CARD_DB


def test_pwelch_over_the_large_plan_on_card(cuda):
    rng = np.random.default_rng(32768)
    x = torch.from_numpy(rng.normal(size=400_000))
    o = spectral.PwelchOptions(nfft=32768, noverlap=16384)
    reset_launch_counts()
    got = spectral.pwelch(x.to(cuda), 1000.0, o)[0]
    assert launch_counts()["outer_dft_split"] >= 1
    want = spectral.pwelch(x, 1000.0, o)[0]  # the CPU in float64
    assert dsputils.snr_db(_np(got), _np(want)) >= SNR_CARD_DB


# ---------------------------------------------------------------- the mesh paths (K10, K11)


def _card_mesh(dev, dp=1, sp=8):
    return parallel.make_mesh(parallel.MeshConfig(dp=dp, sp=sp), devices=[dev] * (dp * sp))


@pytest.mark.parametrize("shape,n_sp,halo", [((8 * 512,), 8, 96), ((3, 4 * 256), 4, 128),
                                             ((2, 8 * 130), 8, 7)],
                         ids=["single_row", "batched_rows", "unaligned"])
def test_k10_on_card(cuda, shape, n_sp, halo):
    x = torch.from_numpy(np.random.default_rng(n_sp).normal(size=shape)).float().to(cuda)
    blocks = list(x.chunk(n_sp, dim=-1))  # views with the signal's row stride
    reset_launch_counts()
    got = cuda_halo.ring_halo(blocks, halo)
    assert launch_counts()["ring_halo"] == 1
    for g, w in zip(got, cuda_halo.ring_halo_plain(blocks, halo)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("nfft,stride,pad,last", [(1024, 512, 1024, False),
                                                  (1024, 512, 1024, True),
                                                  (1000, 160, 1024, False)],
                         ids=["neighbour", "tail", "hop160"])
def test_k11_on_card(cuda, nfft, stride, pad, last):
    rng = np.random.default_rng(stride)
    S, rows = 96, 2
    sig = torch.from_numpy(rng.normal(size=(rows, 3 * S * stride))).to(cuda)
    x, nxt = sig[:, S * stride : 2 * S * stride], sig[:, 2 * S * stride :]  # row-strided views
    src = torch.from_numpy(rng.normal(size=(rows, nfft - stride))).to(cuda) if last else nxt
    mask = (torch.arange(S, device=cuda) < S - 3).double()
    w = window.window_table("hann", pad, device=cuda)
    reset_launch_counts()
    got = cuda_fused_halo.pwelch_power_partials_halo(x.float(), src.float(), mask.float(),
                                                     w.float(), nfft, stride, pad=pad)
    assert launch_counts()["pwelch_power_partials_halo"] == 1
    want = cuda_fused_halo.pwelch_power_partials_halo_plain(
        x, src, mask, w, nfft, stride, pad, cuda_pwelch.segs_per_tile(S, rows))
    assert dsputils.snr_db(_np(got), _np(want)) >= SNR_CARD_DB


@pytest.mark.parametrize("route", ["ppermute", "pallas", "fused"])
def test_pwelch_sharded_on_card(cuda, route):
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(2, 8 * 512 * 64)))
    o = spectral.PwelchOptions(nfft=1024, noverlap=512)
    reset_launch_counts()
    got, _ = parallel.pwelch_sharded(x.to(cuda), 2.0, o, _card_mesh(cuda),
                                     halo_impl=(route, False))
    counts = {k: v for k, v in launch_counts().items() if v}
    want = {"ppermute": {"pwelch_power_partials": 8},
            "pallas": {"pwelch_power_partials": 8, "ring_halo": 1},
            "fused": {"pwelch_power_partials_halo": 8}}[route]
    assert counts == want
    ref = spectral.pwelch(x, 2.0, o)[0]  # the CPU in float64
    assert got.device.type == "cuda" and dsputils.snr_db(_np(got), _np(ref)) >= SNR_CARD_DB


def test_sharded_stream_and_stft_on_card(cuda):
    rng = np.random.default_rng(9)
    x = rng.normal(size=300_000)
    o = spectral.PwelchOptions(nfft=1024, noverlap=512)
    blocks = [x[i : i + 65536] for i in range(0, x.size, 65536)]
    ref = _np(spectral.pwelch(torch.from_numpy(x), 2.0, o)[0])
    for route in ("ppermute", "pallas", "fused"):
        got, _ = parallel.stream_pwelch(blocks, 2.0, o, _card_mesh(cuda), segs_per_chunk_shard=16,
                                        halo_impl=(route, False))
        assert dsputils.snr_db(got, ref) >= SNR_CARD_DB
    mesh = _card_mesh(cuda)
    xs = torch.from_numpy(x[: 8 * 256 * 140])
    reset_launch_counts()
    sg = parallel.spectrogram_sharded(xs.to(cuda), mesh, 1024, 256)
    assert launch_counts()["stft_power"] == 8
    assert dsputils.snr_db(_np(sg), _np(models.spectrogram(xs, 1024, 256))) >= SNR_CARD_DB
    s = models.stft(xs, 1024, 256)[: 8 * 130]
    reset_launch_counts()
    y = parallel.istft_sharded(s.to(cuda), mesh, 1024, 256)
    assert launch_counts()["istft_overlap_add"] == 8
    want = models.istft(s, 1024, 256)[: 8 * 130 * 256]
    assert dsputils.snr_db(_np(y)[1024:], _np(want)[1024:]) >= SNR_CARD_DB
    z = torch.from_numpy(rng.normal(size=1 << 18) + 1j * rng.normal(size=1 << 18))
    Z = parallel.fft_sharded(z.to(cuda), mesh)
    assert dsputils.snr_db(_np(Z), np.fft.fft(_np(z))) >= SNR_CARD_DB
