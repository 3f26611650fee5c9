"""Parity of godsp_tpu_torch's STFT family with godsp_tpu.

stft, istft, spectrogram, their streaming forms, check_cola/check_nola,
griffin_lim and the WAV pipelines are held to the JAX package (CPU, x64)
at go-dsp's 1e-8 abs-or-rel bound (dsputils/compare.py) on the same
seeded numpy inputs.  K5's and K6's plain versions are held to the JAX
kernels in interpret mode at >= 100 dB (tests/test_pallas.py's bound)
and to the XLA bodies at 1e-8.  The route tests turn the kernel route on
for CPU tensors, so the wrappers run their plain versions, and show
that each public entry point reaches the intended wrapper.  The kernels
themselves run in tests/test_torch_cuda.py.
"""

import os
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godsp_tpu import models as jmodels
from godsp_tpu import window as jwin
from godsp_tpu_torch import default_device, dsputils, models, set_default_device, wav
from godsp_tpu_torch.models import _stft_impl, griffin, mel
from godsp_tpu_torch.ops import cuda_istft, cuda_probes, cuda_pwelch, cuda_stft

SNR_KERNEL_DB = 100.0


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
    assert dsputils.pretty_close(_np(got), _np(want))


def _signal(shape, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1])
    return np.sin(2 * np.pi * 0.03 * t) + 0.3 * rng.normal(size=shape)


@pytest.fixture
def kernel_route_on_cpu(monkeypatch):
    """Send CPU tensors down the fused route (the wrappers then run their
    plain versions), and count the calls of each wrapper."""
    calls = Counter()

    def spy(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)

        monkeypatch.setattr(mod, name, wrapped)

    for name in ("stft_complex", "stft_power", "stft_mel"):
        spy(cuda_stft, name)
    spy(cuda_istft, "istft_overlap_add")
    for mod in (_stft_impl, mel, griffin):
        monkeypatch.setattr(mod, "fused_path_eligible",
                            lambda x, nfft, pad, hop: cuda_pwelch.fused_supported(nfft, pad, hop))
    for mod in (_stft_impl, griffin):
        monkeypatch.setattr(mod, "_istft_fused_eligible",
                            lambda s, nfft, pad, hop: cuda_istft.istft_supported(nfft, pad, hop))
    return calls


# (shape of x, nfft, hop, pad, window, onesided): the geometry cases.
GEOMETRIES = {
    "n256_h128": ((3000,), 256, 128, None, None, True),
    "hop100": ((3000,), 256, 100, None, "hamming", True),
    "pad512": ((3000,), 256, 128, 512, None, True),
    "bluestein200": ((2000,), 200, 80, None, None, True),
    "twosided": ((1500,), 128, 64, None, None, False),
    "odd_pad": ((1024,), 128, 64, 135, "hamming", True),
    "batched": ((2, 1500), 128, 64, None, None, True),
}


@pytest.mark.parametrize("case", sorted(GEOMETRIES))
def test_stft_istft_spectrogram_match_jax(case):
    shape, nfft, hop, pad, window, onesided = GEOMETRIES[case]
    x = _signal(shape, seed=nfft + hop)
    kw = dict(window=window, pad=pad)
    s = models.stft(x, nfft, hop, onesided=onesided, **kw)
    js = jmodels.stft(x, nfft, hop, onesided=onesided, **kw)
    assert s.shape == js.shape and s.dtype == torch.complex128
    _close(s, js)
    spec = np.array(js)  # the same spectra into both inverses
    _close(models.istft(spec, nfft, hop, onesided=onesided, **kw),
           jmodels.istft(spec, nfft, hop, onesided=onesided, **kw))
    for scale in ("power", "magnitude", "db"):
        _close(models.spectrogram(x, nfft, hop, scale=scale, **kw),
               jmodels.spectrogram(x, nfft, hop, scale=scale, **kw))


@pytest.mark.parametrize("length", [2200, 1700], ids=["longer", "shorter"])
def test_istft_length_matches_jax(length):
    x = _signal((2000,), 3)
    spec = np.array(jmodels.stft(x, 256, 128))  # 14 frames: a 1920-sample span
    got = models.istft(spec, 256, 128, length=length)
    assert got.shape == (length,)
    _close(got, jmodels.istft(spec, 256, 128, length=length))


def test_istft_roundtrip_and_errors():
    x = _signal((2048,), 4)
    y = models.istft(models.stft(x, 256, 64), 256, 64)
    # Hann is zero at its ends: the first and last covered samples are 0/tiny = 0.
    assert float(y[0]) == 0.0
    assert dsputils.snr_db(_np(y[1:-1]), x[1 : y.shape[-1] - 1]) >= 200.0
    with pytest.raises(ValueError, match="inconsistent"):
        models.istft(np.ones((4, 65), np.complex128), 128, pad=131)
    with pytest.raises(ValueError, match="two-sided"):
        models.istft(np.ones((4, 128), np.complex128), 128, onesided=False, pad=64)
    with pytest.raises(ValueError, match="hop must be positive"):
        models.istft(np.ones((4, 65), np.complex128), 128, hop=0)
    with pytest.raises(ValueError, match="pad must be >= nfft"):
        models.stft(np.zeros(100), 64, pad=32)
    with pytest.raises(ValueError, match="unknown scale"):
        models.spectrogram(np.zeros(512), 128, scale="weird")
    with pytest.raises(ValueError, match="signal length"):
        models.stft_frames(np.zeros(10), 16, 8)


def test_stft_frames_matches_jax():
    x = _signal((2, 500), 5)
    _close(models.stft_frames(x, 64, 24), jmodels.stft_frames(jnp.asarray(x), 64, 24))


@pytest.mark.parametrize("window,nperseg,noverlap", [
    ("hann", 256, 128), ("hann", 255, 128), ("hamming", 128, 96), ("rectangular", 64, 0),
    ("bartlett", 100, 50), ("blackman", 128, 0),
])
def test_check_cola_nola_match_jax(window, nperseg, noverlap):
    assert models.check_cola(window, nperseg, noverlap) == jmodels.check_cola(
        window, nperseg, noverlap)
    assert models.check_nola(window, nperseg, noverlap) == jmodels.check_nola(
        window, nperseg, noverlap)
    assert models.check_COLA is models.check_cola and models.check_NOLA is models.check_nola


# ---------------------------------------------------------------- streaming


def _splits(a, cuts, axis=-1):
    edges = [0, *cuts, a.shape[axis]]
    return [np.take(a, range(lo, hi), axis=axis) for lo, hi in zip(edges, edges[1:])]


@pytest.mark.parametrize("nfft,hop,cuts,kw", [
    (256, 128, [100, 777, 5000], {}),
    (256, 100, [2048, 5000], dict(pad=512)),
    (128, 64, [1500], dict(onesided=False)),
], ids=["ragged", "hop100_pad512", "twosided"])
def test_stream_stft_matches_one_shot_and_jax(nfft, hop, cuts, kw):
    x = _signal((2, 9000), 6)
    chunks = _splits(x, cuts)
    got = list(models.stream_stft(chunks, nfft, hop, **kw))
    want = list(jmodels.stream_stft(chunks, nfft, hop, **kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)
    _close(torch.cat(got, dim=-2), models.stft(x, nfft, hop, **kw))
    st = models.StreamingSTFT(256, 128)
    assert st.update(np.zeros(100)) is None and st.leftover == 100


@pytest.mark.parametrize("nfft,hop,cuts,window", [
    (256, 128, [10, 20, 30], None),
    (256, 64, [7, 20, 44], "hamming"),
    (128, 128, [10], None),
], ids=["equal", "ragged_75pct", "hop_eq_nfft"])
def test_stream_istft_matches_one_shot_and_jax(nfft, hop, cuts, window):
    x = _signal((2, 64 * 60 + 256), 7)
    spec = np.array(jmodels.stft(x, nfft, hop, window=window))
    chunks = _splits(spec, cuts, axis=-2)
    got = list(models.stream_istft(chunks, nfft, hop, window=window))
    want = list(jmodels.stream_istft(chunks, nfft, hop, window=window))
    assert len(got) == len(want) == len(chunks) + 1  # the blocks, then the coda
    for g, w in zip(got, want):
        _close(g, w)
    _close(torch.cat(got, dim=-1), models.istft(spec, nfft, hop, window=window))


def test_streaming_istft_api_errors():
    st = models.StreamingISTFT(256, 128)
    with pytest.raises(ValueError, match="chunk must be"):
        st.push(np.ones((4, 100), np.complex128))
    with pytest.raises(ValueError, match="too short"):
        st.push(np.ones((0, 129), np.complex128))
    st.push(np.ones((4, 129), np.complex128))
    st.flush()
    with pytest.raises(RuntimeError, match="after flush"):
        st.push(np.ones((4, 129), np.complex128))
    with pytest.raises(RuntimeError, match="twice"):
        st.flush()
    with pytest.raises(ValueError, match="hop <= nfft"):
        models.StreamingISTFT(256, 512)
    assert models.StreamingISTFT(256).flush().shape == (0,)


# ---------------------------------------------------------------- Griffin-Lim


def _gl_signal(n=2048):
    t = np.arange(n) / n
    return np.sin(2 * np.pi * 200.3 * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))


@pytest.mark.parametrize("momentum", [0.0, 0.99])
def test_griffin_lim_matches_jax(momentum):
    mag = np.abs(np.array(jmodels.stft(_gl_signal(), 128, hop=32)))
    got = models.griffin_lim(mag, 128, hop=32, n_iter=4, momentum=momentum)
    _close(got, jmodels.griffin_lim(mag, 128, hop=32, n_iter=4, momentum=momentum))
    _close(models.griffin_lim(mag, 128, hop=32, n_iter=0, length=1200),
           jmodels.griffin_lim(mag, 128, hop=32, n_iter=0, length=1200))


@pytest.mark.parametrize("args,kw", [
    ((np.ones((4, 65)), 128), dict(hop=0)),
    ((np.ones((4, 60)), 128), {}),
    ((np.ones((4, 65)), 128), dict(momentum=1.0)),
    ((np.ones((4, 65)), 128), dict(n_iter=-1)),
    ((np.ones((0, 65)), 128), {}),
    ((np.ones((4, 65)), 128), dict(pad=64)),
    ((np.ones(65), 128), {}),
], ids=["hop", "bins", "momentum", "n_iter", "no_frames", "pad", "1d"])
def test_griffin_lim_errors_match_jax(args, kw):
    with pytest.raises(ValueError) as want:
        jmodels.griffin_lim(*args, **kw)
    with pytest.raises(ValueError) as got:
        models.griffin_lim(*args, **kw)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- WAV pipelines


def _wav_file(tmp_path, n=8192, fs=8000, pcm16=False):
    x = (_signal((n,), 9) * 0.2).astype(np.float32)
    path = str(tmp_path / "in.wav")
    wav.write_wav(path, (x * 32767).astype(np.int16) if pcm16 else x, fs)
    return path


@pytest.mark.parametrize("pcm16", [False, True], ids=["float32", "pcm16"])
def test_spectrogram_from_wav_matches_jax(tmp_path, pcm16):
    path = _wav_file(tmp_path, pcm16=pcm16)
    s, freqs, times = models.spectrogram_from_wav(path, nfft=512, hop=256, max_samples=6000)
    js, jfreqs, jtimes = jmodels.spectrogram_from_wav(path, nfft=512, hop=256, max_samples=6000)
    assert s.shape == ((6000 - 512) // 256 + 1, 257) and s.dtype == torch.float32
    # read_floats gives float32 samples, so both packages compute in float32.
    assert dsputils.snr_db(_np(s), np.asarray(js, np.float64)) >= 120.0
    np.testing.assert_array_equal(freqs, jfreqs)
    np.testing.assert_array_equal(times, jtimes)


def _read(path):
    r = wav.read_wav(path)
    try:
        return r.num_channels, r.read_floats(r.samples)
    finally:
        r.close()


@pytest.mark.parametrize("lead", [(), (2,)], ids=["mono", "stereo"])
def test_spectra_to_wav_matches_jax(tmp_path, lead):
    nfft, hop = 256, 128
    spec = np.array(jmodels.stft(_signal(lead + (128 * 40 + 256,), 10) * 0.3, nfft, hop))
    chunks = _splits(spec, [15, 30], axis=-2)
    p, jp = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    n = models.spectra_to_wav(chunks, p, 8000, nfft, hop=hop)
    jn = jmodels.spectra_to_wav(chunks, jp, 8000, nfft, hop=hop)
    assert n == jn == 40 * hop + nfft
    (ch, got), (jch, want) = _read(p), _read(jp)
    assert ch == jch == (lead[0] if lead else 1)
    # float64 results within 1e-8 of each other, each rounded once to float32
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    one_shot = _np(models.istft(spec, nfft, hop)).astype(np.float32)
    np.testing.assert_array_max_ulp(got, one_shot.T.reshape(-1) if lead else one_shot, maxulp=1)


def test_spectra_to_wav_empty_and_failures(tmp_path):
    p = str(tmp_path / "empty.wav")
    assert models.spectra_to_wav([], p, 8000, 256) == 0
    assert wav.read_wav(p).samples == 0  # a valid zero-sample file

    bad = str(tmp_path / "bad.wav")
    with pytest.raises(ValueError, match="chunk must be"):
        models.spectra_to_wav([np.zeros((4, 3))], bad, 8000, nfft=64)
    assert not os.path.exists(bad) or os.path.getsize(bad) <= 44

    spec = np.array(jmodels.stft(_signal((128 * 20 + 256,), 11), 256, 128))

    def failing():
        yield spec[:10]
        raise RuntimeError("upstream failed")

    mid = str(tmp_path / "mid.wav")
    with pytest.raises(RuntimeError, match="upstream failed"):
        models.spectra_to_wav(failing(), mid, 8000, 256, hop=128)
    assert wav.read_wav(mid).samples == 10 * 128  # closed: what was written is readable


# ---------------------------------------------------------------- K5 / K6 plain versions


def test_k5_plain_vs_jax_kernel():
    from godsp_tpu.ops.pallas_stft import stft_pallas

    nfft, hop = 256, 128
    L = hop * 20 + nfft
    x = np.random.default_rng(12).normal(size=L).astype(np.float32)
    w = jwin.window_table_np("hann", nfft).astype(np.float32)
    fb = np.asarray(jmodels.mel_filterbank(32, nfft, 8000.0), np.float32)
    n = (L - nfft) // hop + 1
    for out in ("complex", "power", "mel"):
        want = stft_pallas(jnp.asarray(x), jnp.asarray(w), nfft, hop, n, out=out,
                           fb=jnp.asarray(fb), interpret=True)
        got = cuda_stft.stft_pallas_plain(torch.from_numpy(x).double(), torch.from_numpy(w).double(),
                                          nfft, hop, n, out=out, fb=torch.from_numpy(fb).double())
        assert got.shape == want.shape
        assert dsputils.snr_db(_np(got), np.asarray(want)) >= SNR_KERNEL_DB, out


def test_k6_plain_vs_jax_kernel_and_xla_body():
    from godsp_tpu.models._stft_impl import _ola_unnorm_xla
    from godsp_tpu.ops.pallas_istft import istft_overlap_add

    nfft = pad = 256
    hop, F = 128, 12
    rng = np.random.default_rng(13)
    half = rng.normal(size=(F, pad // 2 + 1)) + 1j * rng.normal(size=(F, pad // 2 + 1))
    full = np.concatenate([half, np.conj(half[:, -2:0:-1])], axis=-1)
    w = jwin.window_table_np("hann", nfft)
    got = cuda_istft.istft_overlap_add_plain(torch.from_numpy(half), torch.from_numpy(w), nfft,
                                             hop)
    assert got.shape == ((F - 1) * hop + nfft,)
    _close(got, _ola_unnorm_xla(jnp.asarray(half), jnp.asarray(w), nfft, hop, pad, True))
    want = istft_overlap_add(jnp.asarray(full.real, jnp.float32), jnp.asarray(full.imag, jnp.float32),
                             jnp.asarray(w, jnp.float32), nfft, hop, interpret=True,
                             natural_in=True)
    assert dsputils.snr_db(_np(got), np.asarray(want)) >= SNR_KERNEL_DB
    two = cuda_istft.istft_overlap_add_plain(torch.from_numpy(full), torch.from_numpy(w), nfft,
                                             hop, onesided=False)
    _close(two, got)


@pytest.mark.parametrize("n,hop", [(40, 100), (7, 64), (30, 256)])
def test_overlap_add_vs_numpy(n, hop):
    frames = np.random.default_rng(n).normal(size=(2, n, 256))
    want = np.zeros((2, (n - 1) * hop + 256))
    for f in range(n):
        want[:, f * hop : f * hop + 256] += frames[:, f]
    _close(cuda_istft.overlap_add(torch.from_numpy(frames), hop), want)


def test_kernel_geometry_and_tiles():
    assert cuda_pwelch.fused_supported(1024, 1024, 160)
    assert not cuda_pwelch.fused_supported(1000, 1000, 500)
    assert cuda_istft.istft_supported(1024, 1024, 1)
    assert cuda_istft.istft_supported(16384, 16384, 4096)
    assert not cuda_istft.istft_supported(1024, 1024, 2048)  # hop > nfft
    assert not cuda_istft.istft_supported(1024, 1 << 15, 256)
    for F, nfft, hop in ((4096, 1024, 256), (10333, 1024, 256), (3, 1024, 1), (5, 256, 256)):
        bt = cuda_probes.istft_radix2_tiles(F, 1, nfft, hop)
        assert bt * hop >= nfft - hop and 1 <= bt
    with pytest.raises(ValueError, match="unsupported"):
        cuda_istft.istft_overlap_add(torch.ones(4, 65, dtype=torch.complex128), torch.ones(128),
                                     128, 256)
    with pytest.raises(ValueError, match="unsupported"):
        cuda_stft.stft_complex(torch.zeros(2048), torch.zeros(100), 100, 50, 4)
    with pytest.raises(ValueError, match="requires fb"):
        cuda_stft.stft_mel(torch.zeros(2048), torch.zeros(256), 256, 128, 4, torch.ones(3, 5))


@pytest.mark.parametrize("F,rows,bt", [(50, 1, 3), (2500, 2, 10), (20000, 2, 64)])
def test_tile_frames_covers_the_tail(F, rows, bt):
    """The tiles of tests/test_torch_cuda.py's stitch test (K6's first
    design, istft_radix2): the tail bound (nfft - hop = 724 needs 3 frames
    of hop 300), a middle tile, the cap."""
    assert cuda_probes.istft_radix2_tiles(F, rows, 1024, 300) == bt
    assert bt * 300 >= 1024 - 300


# ---------------------------------------------------------------- routes


def test_routes_reach_the_wrappers(kernel_route_on_cpu, tmp_path):
    calls = kernel_route_on_cpu
    x = _signal((2, 3000), 14)
    kw = dict(hop=100, pad=512)  # an odd stride and pad > nfft: one fused route on CUDA
    _close(models.stft(x, 256, **kw), jmodels.stft(x, 256, **kw))
    assert calls == {"stft_complex": 1}
    _close(models.spectrogram(x, 256, scale="db", **kw),
           jmodels.spectrogram(x, 256, scale="db", **kw))
    assert calls["stft_power"] == 1
    _close(models.mel_spectrogram(x, 8000.0, nfft=256, hop=100, n_mels=24, log=True),
           jmodels.mel_spectrogram(x, 8000.0, nfft=256, hop=100, n_mels=24, log=True))
    assert calls["stft_mel"] == 1
    spec = np.array(jmodels.stft(x, 256, hop=64))
    _close(models.istft(spec, 256, hop=64, length=2900),
           jmodels.istft(spec, 256, hop=64, length=2900))
    assert calls["istft_overlap_add"] == 1
    chunks = _splits(spec, [9, 20], axis=-2)
    for g, w in zip(models.stream_istft(chunks, 256, hop=64),
                    jmodels.stream_istft(chunks, 256, hop=64)):
        _close(g, w)
    assert calls["istft_overlap_add"] == 4  # one per chunk
    mag = np.abs(spec[0])
    _close(models.griffin_lim(mag, 256, hop=64, n_iter=2),
           jmodels.griffin_lim(mag, 256, hop=64, n_iter=2))
    assert calls["istft_overlap_add"] == 4 + 3 and calls["stft_complex"] == 1 + 2
    blocks = _splits(x, [1000, 2000])
    _close(torch.cat(list(models.stream_stft(blocks, 256, 100)), dim=-2),
           jmodels.stft(x, 256, 100))
    _close(torch.cat(list(models.stream_mel(blocks, 8000.0, 256, 100, n_mels=24)), dim=-2),
           jmodels.mel_spectrogram(x, 8000.0, 256, 100, n_mels=24))
    assert calls["stft_complex"] == 3 + 3 and calls["stft_mel"] == 1 + 3
    path = _wav_file(tmp_path)
    s, _, _ = models.spectrogram_from_wav(path, nfft=512, hop=256)
    want = np.asarray(jmodels.spectrogram_from_wav(path, nfft=512, hop=256)[0], np.float64)
    assert dsputils.snr_db(_np(s), want) >= 120.0  # float32 samples in both
    assert calls["stft_power"] == 2
    models.spectra_to_wav([chunks[0]], str(tmp_path / "o.wav"), 8000, 256, hop=64)
    assert calls["istft_overlap_add"] == 7 + 1
    assert sum(calls.values()) == 6 + 2 + 4 + 8  # no other wrapper was reached


def test_unfused_geometries_skip_the_wrappers(kernel_route_on_cpu):
    calls = kernel_route_on_cpu
    x = _signal((1500,), 15)
    models.stft(x, 200, hop=80)  # Bluestein length
    models.stft(x, 128, hop=64, onesided=False)
    models.istft(np.array(jmodels.stft(x, 128, 64, pad=135)), 128, 64, pad=135)  # odd pad
    models.mel_spectrogram(x, 8000.0, nfft=200, hop=80, n_mels=16)
    assert not calls
