"""K5's register-radix design (csrc/stft_kernel.cu) on the CPU.

The kernel cannot run here, so its host side is held instead:
ops/cuda_stft.py's float64 model of it (stft_regs_model: the pair load
with the window, nfft and L edges, K3's packed half-length passes and
split from ops/cuda_fft.py, and each mode's epilogue, the mel mode's sums
over each filter's band) against the float64 plain version at <= 1e-12
relative, at every pad 2..16384 in each mode, at odd hops, hop 160 with
pad 2048, nfft < pad and nfft odd, and with frames running past L; the
model rounded to float32 against godsp_tpu's stft_pallas in interpret
mode at >= 100 dB (tests/test_pallas.py's bound); the model in place of
the kernel under the port's public stft, spectrogram and mel_spectrogram
against godsp_tpu's in float64 at go-dsp's 1e-8 (pretty_close); the banks
of the mel epilogue's shared-memory accesses (one word a bank); and the
radix-2 yardstick stft_radix2 on CPU tensors being the plain version.
The kernel itself runs in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godsp_tpu import models as jmodels
from godsp_tpu import window as jwin
from godsp_tpu_torch import default_device, dsputils, models, set_default_device
from godsp_tpu_torch.models import _stft_impl, mel
from godsp_tpu_torch.ops import cuda_fft, cuda_probes, cuda_pwelch, cuda_stft, launch_counts

PADS = [1 << k for k in range(1, 15)]
MODES = ["complex", "power", "mel"]
REL = 1e-12  # model vs plain version, both float64
SNR_KERNEL_DB = 100.0  # float32-rounded model vs the interpret-mode JAX kernel
FRAMES = 5  # frames a row in the sweep


@pytest.fixture(autouse=True)
def _host_data_on_cpu():
    """Host data goes to the CPU here; the port's default device is the card."""
    old = default_device()
    set_default_device("cpu")
    yield
    set_default_device(old)


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _filterbank(pad, n_mels, seed):
    """A (n_mels, pad/2 + 1) bank with zeros outside each filter's band,
    one all-zero filter, and a band that reaches bin pad/2."""
    rng = np.random.default_rng(seed)
    lp = pad // 2 + 1
    fb = np.zeros((n_mels, lp))
    for j in range(n_mels):
        lo = int(rng.integers(0, lp))
        hi = int(rng.integers(lo, lp))
        fb[j, lo:hi + 1] = rng.random(hi - lo + 1)
    fb[0] = 0.0
    fb[-1, lp // 2:] = rng.random(lp - lp // 2)
    return fb


def _geometries(pad):
    """(nfft, hop) cases at pad: the full frame at a quarter hop, odd hops
    (1, 3, 255) with nfft odd and below pad."""
    odd = max(1, pad - 1 if pad > 2 else 1)
    return sorted({(pad, max(1, pad // 4)), (odd, 3), (max(1, pad // 2 + 1), 255), (odd, 1)})


def _case(pad, nfft, hop, rows, frames, seed, extra=0):
    rng = np.random.default_rng(seed)
    L = (frames - 1) * hop + nfft + extra
    x = rng.normal(size=(rows, L))
    w = np.zeros(pad)
    w[:nfft] = rng.normal(size=nfft)
    return x, w


def _plain(x, w, nfft, hop, S, pad, out, fb=None):
    return _np(cuda_stft.stft_pallas_plain(torch.from_numpy(x), torch.from_numpy(w), nfft, hop, S,
                                           pad, out, None if fb is None else torch.from_numpy(fb)))


# ---------------------------------------------------------------- the model


@pytest.mark.parametrize("out", MODES)
@pytest.mark.parametrize("pad", PADS)
def test_stft_model_is_the_plain_version(pad, out):
    fb = _filterbank(pad, 9, pad) if out == "mel" else None
    for nfft, hop in _geometries(pad):
        x, w = _case(pad, nfft, hop, 2, FRAMES, pad + hop, extra=hop // 2)
        S = (x.shape[-1] - nfft) // hop + 1
        got = cuda_stft.stft_regs_model(x, w, nfft, hop, S, pad, out, fb)
        want = _plain(x, w, nfft, hop, S, pad, out, fb)
        assert got.shape == want.shape
        assert _rel(got, want) <= REL, (nfft, hop)


@pytest.mark.parametrize("out", MODES)
@pytest.mark.parametrize("nfft", [1000, 2048])
def test_stft_model_at_hop_160_pad_2048(nfft, out):
    """The speech hop: 160 = 32 x 5, so a frame starts at every phase mod 32."""
    pad, hop = 2048, 160
    fb = _filterbank(pad, 40, nfft) if out == "mel" else None
    x, w = _case(pad, nfft, hop, 3, 33, nfft)
    got = cuda_stft.stft_regs_model(x, w, nfft, hop, 33, pad, out, fb)
    assert _rel(got, _plain(x, w, nfft, hop, 33, pad, out, fb)) <= REL


@pytest.mark.parametrize("pad,nfft,hop", [(2, 2, 1), (64, 63, 3), (1024, 1024, 256),
                                          (4096, 3001, 255)])
def test_stft_model_zeroes_frames_past_l(pad, nfft, hop):
    """Frames that run past L read zeros there (the kernel's L edge; the
    wrappers never ask for such frames): the plain version of x
    zero-extended."""
    x, w = _case(pad, nfft, hop, 2, 6, pad)
    S = 6 + nfft // hop + 2  # the last frames lie partly or wholly past L
    ext = np.concatenate([x, np.zeros((2, (S - 1) * hop + nfft - x.shape[-1]))], axis=-1)
    for out in ("complex", "power"):
        got = cuda_stft.stft_regs_model(x, w, nfft, hop, S, pad, out)
        assert _rel(got, _plain(ext, w, nfft, hop, S, pad, out)) <= REL


def test_stft_model_keeps_leading_axes_and_takes_a_band():
    pad, nfft, hop = 256, 200, 77
    x, w = _case(pad, nfft, hop, 6, 4, 3)
    fb = _filterbank(pad, 5, 4)
    S = (x.shape[-1] - nfft) // hop + 1
    got = cuda_stft.stft_regs_model(x.reshape(2, 3, -1), w, nfft, hop, S, pad, "mel", fb)
    assert got.shape == (2, 3, S, 5)
    np.testing.assert_array_equal(got.reshape(6, S, 5),
                                  cuda_stft.stft_regs_model(x, w, nfft, hop, S, pad, "mel", fb))
    band = cuda_stft.mel_band(torch.from_numpy(fb)).numpy()
    same = cuda_stft.stft_regs_model(x, w, nfft, hop, S, pad, "mel", fb, band)
    np.testing.assert_array_equal(same, cuda_stft.stft_regs_model(x, w, nfft, hop, S, pad, "mel", fb))
    narrow = band.copy()
    j = int(np.argmax(band[:, 1] - band[:, 0]))
    narrow[j, 1] = narrow[j, 0]  # a band that drops nonzero bins changes the sum
    assert not np.allclose(cuda_stft.stft_regs_model(x, w, nfft, hop, S, pad, "mel", fb, narrow),
                           same)


@pytest.mark.parametrize("pad", [2, 4])
def test_stft_model_edge_pads(pad):
    """pad = 2 (a half-length frame of one pair: no pass, the split alone)
    and pad = 4 (one radix-2 pass) against numpy's rfft of the frames."""
    x = np.arange(1.0, 2 * 11 + 1).reshape(2, 11)
    w = np.linspace(0.5, 1.5, pad)
    S = 11 - pad + 1
    got = cuda_stft.stft_regs_model(x, w, pad, 1, S, pad)
    frames = np.stack([x[:, s:s + pad] * w for s in range(S)], axis=1)
    np.testing.assert_allclose(got, np.fft.rfft(frames), rtol=0, atol=1e-13)


# ---------------------------------------------------------------- against godsp_tpu


@pytest.mark.parametrize("nfft,hop", [(256, 128), (512, 160)])
def test_stft_model_vs_jax_kernel(nfft, hop):
    """The model rounded to float32 against stft_pallas in interpret mode,
    every mode."""
    from godsp_tpu.ops.pallas_stft import stft_pallas

    L = hop * 20 + nfft
    x = np.random.default_rng(nfft + hop).normal(size=L).astype(np.float32)
    w = jwin.window_table_np("hann", nfft).astype(np.float32)
    fb = np.asarray(jmodels.mel_filterbank(32, nfft, 8000.0), np.float32)
    n = (L - nfft) // hop + 1
    for out in MODES:
        want = stft_pallas(jnp.asarray(x), jnp.asarray(w), nfft, hop, n, out=out,
                           fb=jnp.asarray(fb), interpret=True)
        got = cuda_stft.stft_regs_model(x, w, nfft, hop, n, nfft, out, fb)
        got = got.astype(np.complex64 if out == "complex" else np.float32)
        assert got.shape == want.shape
        assert dsputils.snr_db(got, np.asarray(want)) >= SNR_KERNEL_DB, out


@pytest.fixture
def model_route(monkeypatch):
    """The fused route on CPU tensors, with K5's float64 model in place of
    each wrapper (so the public entry points run the kernel's arithmetic);
    counts the calls."""
    calls = {}

    def as_model(name, out):
        def run(x, w, nfft, stride, total_segs, *fb, pad=None, band=None, into=None):
            calls[name] = calls.get(name, 0) + 1
            res = cuda_stft.stft_regs_model(_np(x), _np(w), nfft, stride, total_segs, pad, out,
                                            _np(fb[0]) if fb else None,
                                            None if band is None else _np(band))
            res = torch.from_numpy(res)
            return res if into is None else into.copy_(res)

        monkeypatch.setattr(cuda_stft, name, run)

    for out in MODES:
        as_model(f"stft_{out}", out)
    for mod in (_stft_impl, mel):
        monkeypatch.setattr(mod, "fused_path_eligible",
                            lambda x, nfft, pad, hop: cuda_pwelch.fused_supported(nfft, pad, hop))
    return calls


def _signal(shape, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1])
    return np.sin(2 * np.pi * 0.03 * t) + 0.3 * rng.normal(size=shape)


@pytest.mark.parametrize("nfft,hop,pad", [(256, 100, 512), (1024, 256, None), (400, 160, 512)])
def test_stft_model_under_the_public_entries_vs_godsp_tpu(model_route, nfft, hop, pad):
    calls = model_route
    x = _signal((2, 6000), nfft + hop)
    kw = dict(hop=hop) if pad is None else dict(hop=hop, pad=pad)
    assert dsputils.pretty_close(_np(models.stft(x, nfft, **kw)), np.asarray(jmodels.stft(x, nfft, **kw)))
    assert dsputils.pretty_close(_np(models.spectrogram(x, nfft, scale="db", **kw)),
                                 np.asarray(jmodels.spectrogram(x, nfft, scale="db", **kw)))
    mkw = dict(nfft=nfft, hop=hop, n_mels=24, log=True)
    assert dsputils.pretty_close(_np(models.mel_spectrogram(x, 8000.0, **mkw)),
                                 np.asarray(jmodels.mel_spectrogram(x, 8000.0, **mkw)))
    fused_mel = nfft & (nfft - 1) == 0  # mel_spectrogram pads to nfft: a power of 2 fuses
    assert calls == {"stft_complex": 1, "stft_power": 1, **({"stft_mel": 1} if fused_mel else {})}


# ---------------------------------------------------------------- shared memory


def _mel_epilogue_accesses(pad, frames, band):
    """Every warp access of K5's mel epilogue in a CTA of `frames` frames,
    as the 32 lanes' words (-1: the lane is idle): the |X|^2 writes, bin
    t + c T of register c and bin m by t = 0, then the band sums.  Where a
    frame fills a warp (m = 512, 1024), warp w sums filter j = w + 8 i of
    all eight frames, lane l frame l / 4 at bin 4 (band[j].x // 4) + l % 4
    + 4 s at step s; elsewhere the frame's G = min(T, 32) lanes take bin
    band[j].x + lane + G s, W = T / G filters of a frame side by side."""
    m = pad // 2
    g = cuda_fft.geometry(m)
    T = g.threads
    threads, _ = cuda_fft.cta_shape(m, frames)
    tid = np.arange(threads)
    slot, t = tid // T, tid % T

    def word(sl, k):
        return cuda_stft.stft_mel_slot_words(pad, frames, sl, k)

    accesses = [word(slot, t + c * T) for c in cuda_fft.out_index(m)]
    accesses.append(np.where(t == 0, word(slot, np.full_like(t, m)), -1))
    if g.warp and g.q == 1:
        fs, kl, warp = (tid % 32) // 4, tid % 4, tid // 32
        for j0 in range(0, len(band), 8):
            j = j0 + warp
            jj = np.minimum(j, len(band) - 1)
            lo, hi = band[jj, 0], band[jj, 1]
            starts = band[j0:j0 + 8, 0] // 4 * 4
            steps = int(max(0, (band[j0:j0 + 8, 1] - starts).max())) // 4 + 1
            for st in range(steps):
                k = lo // 4 * 4 + kl + 4 * st
                live = (j < len(band)) & (k >= lo) & (k <= hi)
                accesses.append(np.where(live, word(fs, np.clip(k, 0, m)), -1))
    else:
        G = min(T, 32)
        W = T // G
        lane, grp = t % G, t // G
        for j0 in range(0, len(band), W):
            j = j0 + grp
            jj = np.minimum(j, len(band) - 1)
            widths = band[j0:j0 + W, 1] - band[j0:j0 + W, 0] + 1
            for i in range(-(-int(max(0, widths.max())) // G)):
                k = band[jj, 0] + lane + i * G
                live = (j < len(band)) & (k <= band[jj, 1])
                accesses.append(np.where(live, word(slot, np.clip(k, 0, m)), -1))
    return [a[32 * w:32 * (w + 1)] for a in accesses for w in range(threads // 32)]


def _warp_degree(lanes):
    """Most distinct 32-bit words sharing a bank in one warp access."""
    lanes = lanes[lanes >= 0]
    if len(lanes) == 0:
        return 0
    return int(np.bincount(np.unique(lanes) % 32, minlength=32).max())


@pytest.mark.parametrize("pad", PADS)
def test_mel_slot_reuse_is_free_of_bank_conflicts(pad):
    """K5's mel epilogue reuses the frame's slot for |X|^2 (bins k < m in
    the re plane, k = m at im's first word); every warp access of the
    writes and of the band sums (80 filters of the port's own bank, and a
    band ending at bin m) touches each bank at most once."""
    m = pad // 2
    g = cuda_fft.geometry(m)
    fb = np.asarray(models.mel_filterbank(80, pad, 44100.0, dtype=torch.float64, device="cpu"))
    band = cuda_stft.mel_band(torch.from_numpy(fb)).numpy().astype(np.int64)
    band = np.concatenate([band, [[0, m], [max(0, m - 40), m]]])
    frames = g.default_rows
    assert max(_warp_degree(a) for a in _mel_epilogue_accesses(pad, frames, band)) <= 1


@pytest.mark.parametrize("pad", [2, 64, 1024, 2048, 4096])
def test_mel_slot_words_lay_out_the_planes(pad):
    """Each frame's m + 1 bins take distinct words of its own slot (re
    plane, then bin m in the im plane), and bin m lands on the bank a
    longer re plane would give it."""
    m = pad // 2
    g = cuda_fft.geometry(m)
    frames = g.default_rows
    f, k = np.meshgrid(np.arange(frames), np.arange(m + 1), indexing="ij")
    words = cuda_stft.stft_mel_slot_words(pad, frames, f, k)
    assert len(np.unique(words)) == frames * (m + 1)
    slot_words = cuda_fft.cta_shape(m, frames)[1] * m
    assert np.all((words[:, :m] >= 0) & (words[:, :m] < slot_words))  # re plane
    assert np.all(words[:, m] >= slot_words)  # im plane
    assert np.array_equal(words[:, m] % 32, (words[:, 0] + m * g.q) % 32)
    if g.q == 1:  # a slot of its own: m consecutive words
        assert np.array_equal(words[:, :m] // m, f[:, :m])


# ---------------------------------------------------------------- the yardstick on the CPU


def test_radix2_stft_yardstick_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.normal(size=(2, 5000)).astype(np.float32))
    w = torch.from_numpy(np.hanning(512).astype(np.float32))
    fb = torch.from_numpy(_filterbank(512, 8, 3).astype(np.float32))
    before = launch_counts()["stft_radix2"]
    for out in MODES:
        kw = dict(fb=fb) if out == "mel" else {}
        got = cuda_probes.stft_radix2(x, w, 400, 160, 20, 512, out, **kw)
        want = cuda_stft.stft_pallas_plain(x, w, 400, 160, 20, 512, out, fb)
        assert torch.equal(got, want)
    assert launch_counts()["stft_radix2"] == before  # CPU tensors never launch
    with pytest.raises(ValueError):
        cuda_probes.stft_radix2(x, w, 400, 160, 20, 256)  # pad < nfft
    with pytest.raises(ValueError):
        cuda_probes.stft_radix2(x, w, 400, 160, 20, 512, "mel")  # no fb
