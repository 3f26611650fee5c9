"""Parity of godsp_tpu_torch's cross-spectra (csd, coherence) and of K7's
plain version with godsp_tpu.

csd and coherence are held to the JAX package at go-dsp's 1e-8
abs-or-rel bound on the CPU in float64, on their unfused route and, via
the `fused_on_cpu` fixture, on the fused one (K7's plain version on the
CPU).  K7's plain version is held to the JAX fused kernel in interpret
mode at >= 100 dB (tests/test_pallas.py's bound), summed over tiles,
since only that sum is contractual.  The kernel itself runs in
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godsp_tpu import spectral as jspec
from godsp_tpu import window as jwin
from godsp_tpu_torch import default_device, dsputils, set_default_device, spectral, window
from godsp_tpu_torch.ops import cuda_csd, cuda_pwelch, launch_counts
from godsp_tpu_torch.spectral import _pwelch_impl

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


def _close(got, want) -> bool:
    """go-dsp's 1e-8 abs-or-rel bound, componentwise for complex values."""
    return dsputils.pretty_close(_np(got), np.asarray(want))


@pytest.fixture
def fused_on_cpu(monkeypatch):
    """Route CPU tensors through the fused branch (K4's and K7's plain
    versions) and count the K7 wrapper's calls."""
    calls = []
    csd_sum = cuda_csd.csd_power_sum

    def spy(*a, **k):
        calls.append(a[4])  # the stride
        return csd_sum(*a, **k)

    monkeypatch.setattr(cuda_csd, "csd_power_sum", spy)
    monkeypatch.setattr(_pwelch_impl, "fused_path_eligible",
                        lambda x, nfft, pad, stride: cuda_pwelch.fused_supported(nfft, pad, stride))
    return calls


def _pair(n, seed=0, shape=()):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape + (n,))
    return x, 0.7 * np.roll(x, 3, axis=-1) + 0.4 * rng.normal(size=shape + (n,))


# (port options, JAX options) by name: pwelch.go's geometry and quirk cases.
OPTION_CASES = {
    "default": {},
    "50pct": dict(nfft=128, noverlap=64),
    "hop160": dict(nfft=256, noverlap=96),
    "hop156": dict(nfft=256, noverlap=100),
    "pad_gt_nfft": dict(nfft=128, pad=256),
    "pad_lt_nfft": dict(nfft=256, pad=128),
    "pad_not_pow2": dict(nfft=100, pad=150, noverlap=30),
    "hamming_scale_off": dict(nfft=64, window="hamming", scale_off=True),
}


def _opts(case):
    kw = OPTION_CASES[case]
    return spectral.PwelchOptions(**kw), jspec.PwelchOptions(**kw)


@pytest.mark.parametrize("case", sorted(OPTION_CASES))
def test_csd_and_coherence_match_jax(case):
    x, y = _pair(2000, seed=len(case))
    o, jo = _opts(case)
    pxy, freqs = spectral.csd(x, y, 8000.0, o)
    jpxy, jfreqs = jspec.csd(x, y, 8000.0, jo)
    assert pxy.dtype == torch.complex128
    assert _close(pxy, jpxy) and _close(freqs, jfreqs)
    cxy, _ = spectral.coherence(x, y, 8000.0, o)
    assert _close(cxy, jspec.coherence(x, y, 8000.0, jo)[0])


@pytest.mark.parametrize("case", ["default", "50pct", "hop156", "pad_gt_nfft", "pad_lt_nfft"])
def test_fused_branch_matches_jax(fused_on_cpu, case):
    x, y = _pair(3000, seed=9, shape=(2,))
    o, jo = _opts(case)
    assert _close(spectral.csd(x, y, 2.0, o)[0], jspec.csd(x, y, 2.0, jo)[0])
    assert _close(spectral.coherence(x, y, 2.0, o)[0], jspec.coherence(x, y, 2.0, jo)[0])
    nfft = o.nfft or 256
    assert fused_on_cpu == [nfft - o.noverlap] * 2  # csd, and coherence's csd


def test_every_stride_goes_fused(fused_on_cpu):
    """K7 takes any stride: hop 156 and the speech hop 160 with pad > nfft
    (godsp_tpu's semi-fused frames route has no counterpart)."""
    x, y = _pair(5000, seed=4)
    for nfft, noverlap, pad in ((256, 100, 0), (1000, 840, 1024), (256, 0, 0)):
        spectral.csd(x, y, 1.0, spectral.PwelchOptions(nfft=nfft, noverlap=noverlap, pad=pad))
    assert fused_on_cpu == [156, 160, 256]


def test_csd_of_self_is_pwelch():
    x, _ = _pair(3000, seed=5)
    for case in ("default", "hop160", "pad_lt_nfft", "pad_not_pow2"):
        o, _ = _opts(case)
        pxy, _ = spectral.csd(x, x, 3.0, o)
        pxx, _ = spectral.pwelch(x, 3.0, o)
        assert _close(pxy.real, pxx)
        assert float(pxy.imag.abs().max()) <= 1e-12 * float(pxx.max())


def test_short_and_empty_input():
    x, y = _pair(100, seed=6)
    o, jo = _opts("default")  # 100 < nfft 256: zero-padded to one segment
    assert _close(spectral.csd(x, y, 1.0, o)[0], jspec.csd(x, y, 1.0, jo)[0])
    cxy, _ = spectral.coherence(x, y, 1.0, o)
    assert _close(cxy, np.ones(129))  # one segment: identically 1
    pxy, freqs = spectral.csd(np.zeros(0), np.zeros(0), 1.0)
    assert pxy.shape == freqs.shape == (0,) and pxy.dtype.is_complex
    with pytest.raises(ValueError, match="identical shapes"):
        spectral.csd(np.zeros(10), np.zeros(11), 1.0)
    with pytest.raises(ValueError, match="noverlap"):
        spectral.csd(x, y, 1.0, spectral.PwelchOptions(nfft=64, noverlap=64))


# ---------------------------------------------------------------- K7 plain version


@pytest.mark.parametrize(
    "nfft,stride,pad,keep",
    [(256, 128, 256, 12), (256, 160, 256, 9), (128, 64, 512, 11)],
    ids=["hop128", "hop160", "pad512"],
)
def test_k7_plain_vs_jax_kernel(nfft, stride, pad, keep):
    """godsp_tpu's kernel frames strides of <= 8 lane phase classes (160,
    not 156); test_k7_plain_ragged_tiles_vs_numpy holds stride 156."""
    from godsp_tpu.ops.pallas_csd import csd_power_partials
    from godsp_tpu.ops.pallas_pwelch import digit_to_natural_bins

    S = 12  # 8-segment tiles in godsp_tpu: its last tile is ragged
    rng = np.random.default_rng(nfft + stride + pad)
    x = rng.normal(size=(S - 1) * stride + nfft).astype(np.float32)
    y = (0.5 * np.roll(x, 7) + 0.5 * rng.normal(size=x.size)).astype(np.float32)
    mask = (np.arange(S) < keep).astype(np.float32)
    mask[2] = 0.0  # a zero entry inside the run
    w = jwin.window_table_np("hann", pad).astype(np.float32)
    jre, jim = csd_power_partials(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask),
                                  jnp.asarray(w), nfft, stride, pad=pad, interpret=True)
    lp = pad // 2 + 1
    want = (np.asarray(digit_to_natural_bins(jre.sum(axis=-2), pad), np.float64)[..., :lp]
            + 1j * np.asarray(digit_to_natural_bins(jim.sum(axis=-2), pad), np.float64)[..., :lp])
    before = launch_counts()
    re, im = cuda_csd.csd_power_partials(torch.from_numpy(x), torch.from_numpy(y),
                                         torch.from_numpy(mask), torch.from_numpy(w), nfft,
                                         stride, pad=pad)
    assert re.shape == im.shape == (S, lp)  # one segment a tile at this size, natural bins
    got = _np(re.sum(dim=-2)).astype(np.float64) + 1j * _np(im.sum(dim=-2))
    assert dsputils.snr_db(got, want) >= SNR_KERNEL_DB
    assert launch_counts() == before  # the CPU runs the plain version, no launch


@pytest.mark.parametrize("nfft,stride,pad", [(64, 40, 128), (256, 156, 256)],
                         ids=["hop40_pad128", "hop156"])
def test_k7_plain_ragged_tiles_vs_numpy(nfft, stride, pad):
    """Tiles of segs_per_tile segments, the last one partial, a masked
    scatter, and segments that run off the end of ext, against the
    per-segment loop of conj(X) * Y."""
    S = 1102
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, (S - 1) * stride + nfft - 30))
    y = rng.normal(size=x.shape)
    mask = (rng.random((2, S)) < 0.9).astype(np.float64)
    mask[:, -3:] = 0.0
    w = window.window_table_np("hamming", pad)
    bt = cuda_pwelch.segs_per_tile(S, 2)
    assert S % bt  # a ragged last tile
    re, im = cuda_csd.csd_power_partials(torch.from_numpy(x), torch.from_numpy(y),
                                         torch.from_numpy(mask), torch.from_numpy(w), nfft,
                                         stride, pad=pad)
    assert re.shape == (2, -(-S // bt), pad // 2 + 1)
    got = _np(re.sum(dim=-2)) + 1j * _np(im.sum(dim=-2))
    want = np.zeros((2, pad // 2 + 1), np.complex128)
    for r in range(2):
        px = np.concatenate([x[r], np.zeros(nfft)])
        py = np.concatenate([y[r], np.zeros(nfft)])
        for s in np.nonzero(mask[r])[0]:
            fx, fy = np.zeros(pad), np.zeros(pad)
            fx[:nfft] = px[s * stride : s * stride + nfft]
            fy[:nfft] = py[s * stride : s * stride + nfft]
            want[r] += np.conj(np.fft.rfft(fx * w)) * np.fft.rfft(fy * w)
    assert _close(got, want)
    sre, sim = cuda_csd.csd_power_sum(torch.from_numpy(x[:, : 900 * stride]),
                                      torch.from_numpy(y[:, : 900 * stride]),
                                      torch.from_numpy(w), nfft, stride, 800, pad=pad)
    assert sre.shape == sim.shape == (2, pad // 2 + 1)


def test_k7_geometry_checks():
    x = torch.zeros(1000)
    m, w = torch.ones(3), torch.ones(256)
    with pytest.raises(ValueError, match="unsupported"):
        cuda_csd.csd_power_partials(x, x, m, torch.ones(300), 256, 128, pad=300)
    with pytest.raises(ValueError, match="unsupported"):
        cuda_csd.csd_power_partials(x, x, m, torch.ones(128), 256, 128, pad=128)
    with pytest.raises(ValueError, match="identical shapes"):
        cuda_csd.csd_power_partials(x, torch.zeros(999), m, w, 256, 128)
    with pytest.raises(ValueError, match="leading"):
        cuda_csd.csd_power_partials(x, x, torch.ones(2, 3), w, 256, 128)
    with pytest.raises(ValueError, match="window"):
        cuda_csd.csd_power_partials(x, x, m, torch.ones(128), 256, 128, pad=256)
    assert "csd_power_partials" in launch_counts()
