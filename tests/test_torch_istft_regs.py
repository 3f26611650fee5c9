"""K6's register-radix design (csrc/istft_kernel.cu) on the CPU.

The kernel cannot run here, so its host side is held instead:
ops/cuda_istft.py's float64 model of it (istft_regs_model: a one-sided
frame's backward split with bins 0 and m taken real, the m = pad/2-point
inverse passes of ops/cuda_fft.py's row model, the pairs as samples, a full
frame's pad-point inverse passes and real part, scale and window, then the
overlap-add as the CTAs make it, each sample the sum in frame order of the
frames that cover it, a tile's earlier frames recomputed, the row's edge
samples where the window is small (edge_runs) summed directly) against the
float64 plain version at <= 1e-12 relative at every pad 2..16384,
one-sided and full, pad > nfft, odd nfft, odd hops (1, 3), hop = nfft, a
ragged last tile and rows > 1; the model rounded to float32 against
godsp_tpu's istft_overlap_add in interpret mode at >= 100 dB
(tests/test_pallas.py's bound); the model in place of the kernel under the
port's public istft against godsp_tpu's in float64 at go-dsp's 1e-8
(pretty_close); the CTA (istft_cta), the frame runs' stride (run_stride),
the window of partial sums and the tiles (tile_frames: whole rounds); the
banks of every warp access of the frame runs' stores and of the
overlap-add's sums; and the radix-2 yardstick istft_radix2 on CPU tensors
being the plain version.  The kernel itself runs in
tests/test_torch_cuda.py.
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godsp_tpu import models as jmodels
from godsp_tpu import window as jwin
from godsp_tpu.ops.pallas_istft import istft_overlap_add as jistft
from godsp_tpu_torch import default_device, dsputils, models, set_default_device
from godsp_tpu_torch.models import _stft_impl
from godsp_tpu_torch.ops import cuda_fft, cuda_istft, cuda_probes, launch_counts

PADS = [1 << k for k in range(1, 15)]
REL = 1e-12  # model vs plain version, both float64
SNR_KERNEL_DB = 100.0  # float32-rounded model vs the interpret-mode JAX kernel
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _host_data_on_cpu():
    """Host data goes to the CPU here; the port's default device is the card."""
    old = default_device()
    set_default_device("cpu")
    yield
    set_default_device(old)


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _spec(rows, F, bins, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(rows, F, bins)) + 1j * rng.normal(size=(rows, F, bins))


def _geometries(pad):
    """(nfft, hop) at pad: the full frame at a quarter hop, an odd nfft
    below pad at hops 1 and 3, just over half the frame at hop = nfft."""
    odd = max(1, pad - 1)
    half = max(1, pad // 2 + 1)
    return sorted({(pad, max(1, pad // 4)), (odd, min(3, odd)), (odd, 1), (half, half)})


def _plain(spec, w, nfft, hop, onesided):
    return cuda_istft.istft_overlap_add_plain(torch.from_numpy(spec), torch.from_numpy(w), nfft,
                                              hop, onesided).numpy()


# ---------------------------------------------------------------- the model


@pytest.mark.parametrize("onesided", [True, False], ids=["one-sided", "full"])
@pytest.mark.parametrize("pad", PADS)
def test_istft_model_is_the_plain_version(pad, onesided):
    bins = pad // 2 + 1 if onesided else pad
    for nfft, hop in _geometries(pad):
        F = 23 if pad <= 1024 else 5
        spec = _spec(2, F, bins, pad + nfft + hop)
        w = np.random.default_rng(nfft).random(nfft)
        want = _plain(spec, w, nfft, hop, onesided)
        for bt in (None, 2, 7):  # the kernel's tiles; many tiles, a ragged last one
            got = cuda_istft.istft_regs_model(spec, w, nfft, hop, onesided, bt)
            assert got.shape == want.shape
            assert _rel(got, want) <= REL, (nfft, hop, bt)


def test_istft_model_takes_bins_0_and_m_real_and_keeps_leading_axes():
    """The real part of an inverse DFT ignores the imaginary parts of bins 0
    and pad/2: the split takes them real, as the plain version's full
    spectrum does."""
    spec = _spec(6, 9, 33, 1)
    w = np.hanning(64)
    got = cuda_istft.istft_regs_model(spec.reshape(2, 3, 9, 33), w, 64, 16)
    assert got.shape == (2, 3, 8 * 16 + 64)
    np.testing.assert_array_equal(got.reshape(6, -1), cuda_istft.istft_regs_model(spec, w, 64, 16))
    real = spec.copy()
    real[..., 0], real[..., -1] = real[..., 0].real, real[..., -1].real
    assert _rel(cuda_istft.istft_regs_model(real, w, 64, 16),
                cuda_istft.istft_regs_model(spec, w, 64, 16)) <= REL


def _leading_below(w, nfft):
    """Leading samples of w below EDGE_TAU of its largest magnitude, in
    float32, at most nfft // 2: counted one by one."""
    a = np.abs(np.asarray(w, np.float32))
    thr = np.float32(cuda_istft.EDGE_TAU) * a.max()
    n = 0
    while n < nfft // 2 and a[n] < thr:
        n += 1
    return n


@pytest.mark.parametrize("name,nfft", [("hann", 1024), ("hann", 2048), ("hann", 4096),
                                       ("hann", 7), ("blackman", 1000), ("hamming", 1024),
                                       ("rectangular", 512), ("hann", 2), ("hann", 1)])
def test_edge_runs_follow_the_window(name, nfft):
    """K6 sums again in float64 the samples at a row's ends where the
    window is below EDGE_TAU of its peak: a run that grows with nfft for
    Hann (the 1/w scaling of float32 error stays over 500 that long), none
    for windows that stay away from 0; scale-free."""
    w = jwin.window_table_np(name, nfft)
    head, tail = cuda_istft.edge_runs(w, nfft)
    assert (head, tail) == (_leading_below(w, nfft), _leading_below(w[::-1], nfft))
    assert cuda_istft.edge_runs(1e4 * w, nfft) == (head, tail)
    if name == "hann" and nfft >= 1024:
        want = nfft * np.sqrt(cuda_istft.EDGE_TAU) / np.pi  # sin^2(pi n / nfft) < tau
        assert abs(head - want) <= 2 and abs(tail - want) <= 2
    if name in ("hamming", "rectangular"):
        assert (head, tail) == (0, 0)
    assert cuda_istft.edge_runs(np.zeros(nfft), nfft) == (0, 0)


@pytest.mark.parametrize("onesided", [True, False], ids=["one-sided", "full"])
@pytest.mark.parametrize("nfft,hop,F", [(4096, 1024, 5), (2048, 512, 1), (1000, 333, 4)])
def test_istft_model_edge_samples_are_the_plain_version(nfft, hop, F, onesided):
    """Hann's long edge runs (59 samples a side at 4096; one frame holding
    both runs), summed directly from the bins, against the plain version."""
    pad = 1 << (nfft - 1).bit_length()
    spec = _spec(2, F, pad // 2 + 1 if onesided else pad, nfft + hop)
    w = jwin.window_table_np("hann", nfft)
    assert min(cuda_istft.edge_runs(w, nfft)) >= 10
    want = _plain(spec, w, nfft, hop, onesided)
    assert _rel(cuda_istft.istft_regs_model(spec, w, nfft, hop, onesided), want) <= REL


# ---------------------------------------------------------------- against godsp_tpu


@pytest.mark.parametrize("pad,nfft,hop,F", [(256, 256, 128, 12), (512, 384, 128, 9),
                                            (1024, 1024, 256, 11)])
def test_istft_model_vs_jax_kernel(pad, nfft, hop, F):
    """The model rounded to float32 against pallas_istft.istft_overlap_add in
    interpret mode (natural-order full spectra; its lane rules: nfft and hop
    multiples of 128, nfft a multiple of hop)."""
    half = _spec(1, F, pad // 2 + 1, pad + hop)[0]
    full = np.concatenate([half, np.conj(half[:, -2:0:-1])], axis=-1)
    w = jwin.window_table_np("hann", nfft)
    want = np.asarray(jistft(jnp.asarray(full.real, jnp.float32), jnp.asarray(full.imag, jnp.float32),
                             jnp.asarray(w, jnp.float32), nfft, hop, interpret=True,
                             natural_in=True))
    for spec, onesided in ((half, True), (full, False)):
        got = cuda_istft.istft_regs_model(spec, w, nfft, hop, onesided).astype(np.float32)
        assert dsputils.snr_db(got, want) >= SNR_KERNEL_DB, onesided


@pytest.mark.parametrize("nfft,hop,pad,onesided", [(256, 64, None, True), (256, 100, 512, True),
                                                   (200, 80, 256, True), (128, 64, None, False)])
def test_istft_model_under_public_istft_vs_jax(nfft, hop, pad, onesided, monkeypatch):
    """The port's public istft with the model in place of K6 (CPU tensors
    sent down the fused route) against godsp_tpu's istft at 1e-8."""
    calls = Counter()

    def model(spec, w, nfft, hop, onesided=True):
        calls["istft_overlap_add"] += 1
        return torch.from_numpy(cuda_istft.istft_regs_model(spec.numpy(), w.numpy(), nfft, hop,
                                                            onesided))

    monkeypatch.setattr(cuda_istft, "istft_overlap_add", model)
    monkeypatch.setattr(_stft_impl, "_istft_fused_eligible",
                        lambda s, nfft, pad, hop: cuda_istft.istft_supported(nfft, pad, hop))
    x = np.random.default_rng(nfft + hop).normal(size=3000)
    spec = jmodels.stft(x, nfft, hop, pad=pad, onesided=onesided)
    want = np.asarray(jmodels.istft(spec, nfft, hop, pad=pad, onesided=onesided))
    got = models.istft(torch.from_numpy(np.asarray(spec)), nfft, hop, pad=pad, onesided=onesided)
    assert calls == {"istft_overlap_add": 1}
    assert dsputils.pretty_close(got.numpy(), want)


# ---------------------------------------------------------------- the CTA and the tiles


@pytest.mark.parametrize("onesided", [True, False], ids=["one-sided", "full"])
@pytest.mark.parametrize("pad", PADS)
def test_istft_cta(pad, onesided):
    c = cuda_istft.istft_cta(pad, onesided)
    g = cuda_fft.geometry(pad // 2 if onesided else pad)
    assert c.points == (pad // 2 if onesided else pad)
    assert c.frames == g.default_rows and c.threads <= g.max_threads
    assert c.exchange == (c.frames * c.points * 2 if len(g.radices) >= 2 else 0)
    for hop in (1, 3, 31, max(1, pad // 4), pad):
        s = cuda_istft.run_stride(pad, onesided, hop)
        assert s >= pad and c.frames * s <= c.region  # every frame's run in the region
        assert s % 2 == 0 or not onesided  # the pairs' 8-byte stores stay aligned
        w = cuda_istft.window_words(pad, onesided, pad, hop)
        assert w & (w - 1) == 0 and w >= (c.frames - 1) * hop + pad
        assert cuda_istft.smem_bytes(pad, onesided, pad, hop) <= cuda_istft.MAX_SMEM


@pytest.mark.parametrize("F,rows,nfft,hop,pad", [(4096, 1, 1024, 256, 1024),
                                                 (10332, 1, 1024, 256, 1024),
                                                 (4096, 1, 1024, 160, 2048), (50, 3, 64, 7, 64),
                                                 (9, 1, 4096, 1024, 4096)])
def test_tiles_make_whole_rounds(F, rows, nfft, hop, pad):
    bt = cuda_istft.tile_frames(F, rows, nfft, hop, pad)
    e = cuda_istft.recomputed_frames(nfft, hop)
    fr = cuda_istft.istft_cta(pad).frames
    aim = max(1, min(64, -(-F * rows // 528)))  # frames a CTA to fill the card
    assert e == -(-nfft // hop) - 1
    assert (bt + e) % fr == 0  # whole rounds
    assert aim <= bt < aim + fr  # no more rounds than the aim needs


def test_irfft_table_is_the_conjugate_rfft_table_rounded_once():
    for pad in (2, 64, 2048):
        tab = cuda_istft.irfft_table(pad, CPU).numpy()
        want = np.conj(cuda_fft.rfft_table64(pad))
        np.testing.assert_array_equal(tab[:, 0], want.real.astype(np.float32))
        np.testing.assert_array_equal(tab[:, 1], want.imag.astype(np.float32))


# ---------------------------------------------------------------- shared memory


def _store_ways(pad, onesided, hop):
    """Most accesses of one bank in one warp store of the frame runs: the
    one-sided pairs are 8-byte stores, served a half-warp at a time."""
    words = cuda_istft.run_words(pad, onesided, hop)  # (P, lanes, 1 or 2)
    worst = 1
    for reg in words:
        for h in range(0, len(reg), 16 if onesided else 32):
            part = reg[h:h + (16 if onesided else 32)].reshape(-1)
            worst = max(worst, int(np.bincount(np.unique(part) % 32).max()))
    return worst


def _sum_ways(pad, onesided, nfft, hop, rounds=2):
    """Most accesses of one bank in one warp step of the overlap-add's
    frame reads: lanes take consecutive samples of the round's span, each
    summing the frames that cover it in frame order (the kernel's loop,
    lanes that have run out of frames idle)."""
    c = cuda_istft.istft_cta(pad, onesided)
    stride = cuda_istft.run_stride(pad, onesided, hop)
    worst = 1
    for fa in range(0, c.frames * rounds, c.frames):
        fb = fa + c.frames
        smps = np.arange(fa * hop, (fb - 1) * hop + nfft)
        for w0 in range(0, len(smps), 32):
            smp = smps[w0:w0 + 32]
            top = smp // hop
            fl = np.maximum(top - (nfft - 1 - (smp - top * hop)) // hop, fa)
            fh = np.minimum(top, fb - 1)
            for it in range(int((fh - fl).max()) + 1):
                g = (fl + it)[fl + it <= fh]
                word = (g - fa) * stride + smp[fl + it <= fh] - g * hop
                worst = max(worst, int(np.bincount(np.unique(word) % 32).max()))
    return worst


@pytest.mark.parametrize("onesided", [True, False], ids=["one-sided", "full"])
@pytest.mark.parametrize("pad", PADS)
def test_frame_run_stores_are_free_of_bank_conflicts(pad, onesided):
    for hop in (1, 3, 32, max(1, pad // 4), pad):
        assert _store_ways(pad, onesided, hop) == 1, hop


def test_frame_run_stores_would_conflict_unpadded():
    """At pad 256 a half-warp stores two frames' pairs: runs of exactly pad
    words would put both on the same 16 banks."""
    words = cuda_istft.run_words(256, True, 64)
    c = cuda_istft.istft_cta(256)
    assert c.stride == 256 + 2 * 8
    slot = np.arange(16) // 8
    unpadded = words[0, :16] - (slot * (c.stride - 256))[:, None]
    assert int(np.bincount(np.unique(unpadded) % 32).max()) == 2


@pytest.mark.parametrize("pad,onesided,nfft,hop,ways", [
    (1024, True, 1024, 256, 1), (2048, True, 1024, 160, 1), (1024, True, 1024, 100, 1),
    (512, True, 512, 200, 1), (4096, True, 4096, 1000, 1), (1024, False, 1000, 3, 1),
    (1024, False, 1000, 1, 1), (1024, True, 1023, 3, 2), (1024, True, 1000, 1, 8),
    (256, True, 256, 64, 1), (256, True, 200, 100, 2), (64, True, 64, 3, 2),
])
def test_overlap_add_banks(pad, onesided, nfft, hop, ways):
    """The overlap-add's frame reads: one word a bank wherever a (half-)warp's
    store holds one frame (one-sided pad >= 512, full pad >= 1024), the runs
    then pad + (hop mod 32) words apart, so that lanes on both sides of a
    frame's start read on distinct banks; conflicts left: at odd hops
    one-sided, whose 8-byte pairs keep the stride even (two ways at hop 3,
    eight at hop 1, where each lane reads another frame), and at the small
    pads, whose stride serves the stores (several frames a warp) rather
    than the sums."""
    assert _sum_ways(pad, onesided, nfft, hop) == ways


# ---------------------------------------------------------------- the yardstick on the CPU


def test_radix2_istft_yardstick_on_cpu_is_the_plain_version():
    spec = torch.from_numpy(_spec(2, 20, 129, 3)).to(torch.complex64)
    w = torch.from_numpy(np.hanning(256)).float()
    before = launch_counts()["istft_radix2"]
    got = cuda_probes.istft_radix2(spec, w, 256, 64)
    assert torch.equal(got, cuda_istft.istft_overlap_add_plain(spec, w, 256, 64))
    full = torch.cat([spec, torch.conj(torch.flip(spec[..., 1:-1], dims=(-1,)))], dim=-1)
    got = cuda_probes.istft_radix2(full, w, 256, 64, onesided=False)
    assert torch.equal(got, cuda_istft.istft_overlap_add_plain(full, w, 256, 64, False))
    assert launch_counts()["istft_radix2"] == before  # CPU tensors never launch
    with pytest.raises(ValueError):
        cuda_probes.istft_radix2(spec, w, 256, 300)
