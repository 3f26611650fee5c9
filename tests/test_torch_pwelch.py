"""Parity of godsp_tpu_torch's Welch slice with godsp_tpu.

Public functions (segment, pwelch, pwelch_from_frames, periodogram, the
one-device partial step) are held to the JAX package at go-dsp's 1e-8
abs-or-rel bound on the CPU in float64.  K4's plain version is held to
the JAX fused kernel in interpret mode at >= 100 dB (tests/test_pallas.py's
bound), summed over tiles, since only that sum is contractual.  The
kernel itself runs in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godsp_tpu import spectral as jspec
from godsp_tpu import window as jwin
from godsp_tpu.parallel import _pwelch_sharded_impl as jsharded
from godsp_tpu.parallel.mesh import MeshConfig, make_mesh
from godsp_tpu_torch import default_device, dsputils, set_default_device, spectral, window
from godsp_tpu_torch.ops import cuda_pwelch
from godsp_tpu_torch.parallel import _pwelch_sharded_impl as sharded
from godsp_tpu_torch.parallel.mesh import Mesh
from godsp_tpu_torch.spectral import _pwelch_impl
from test_spectral import GOLDEN_PXX

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


@pytest.fixture
def fused_on_cpu(monkeypatch):
    """Route the CPU through the fused branch (K4's plain version), to hold
    that branch's arithmetic to the JAX package without a card."""
    monkeypatch.setattr(
        _pwelch_impl, "fused_path_eligible",
        lambda x, nfft, pad, stride: cuda_pwelch.fused_supported(nfft, pad, stride),
    )
    monkeypatch.setattr(
        sharded, "fused_path_eligible",
        lambda x, nfft, pad, stride: cuda_pwelch.fused_supported(nfft, pad, stride),
    )


def _kaiser8(L):
    return window.kaiser(8.0)(L)


def _jkaiser8(L):
    return jwin.kaiser(8.0)(L)


# (port options, JAX options): the geometry and quirk cases of pwelch.go.
OPTION_CASES = {
    "default": ({}, {}),
    "50pct": (dict(nfft=128, noverlap=64), dict(nfft=128, noverlap=64)),
    "hop160": (dict(nfft=256, noverlap=96), dict(nfft=256, noverlap=96)),
    "pad_gt_nfft": (dict(nfft=128, pad=256), dict(nfft=128, pad=256)),
    "pad_lt_nfft": (dict(nfft=256, pad=128), dict(nfft=256, pad=128)),
    "pad_not_pow2": (dict(nfft=100, pad=150, noverlap=30), dict(nfft=100, pad=150, noverlap=30)),
    "hamming_scale_off": (dict(nfft=64, window="hamming", scale_off=True),
                          dict(nfft=64, window="hamming", scale_off=True)),
    "blackman": (dict(nfft=64, window="blackman", noverlap=16),
                 dict(nfft=64, window="blackman", noverlap=16)),
    "kaiser_callable": (dict(nfft=128, window=_kaiser8, noverlap=64),
                        dict(nfft=128, window=_jkaiser8, noverlap=64)),
}


def _opts(case):
    p, j = OPTION_CASES[case]
    return spectral.PwelchOptions(**p), jspec.PwelchOptions(**j)


def test_segment_goldens_and_parity():
    x = np.arange(1.0, 11.0)
    assert _np(spectral.segment(x, 4, 1)).tolist() == [[1, 2, 3, 4], [4, 5, 6, 7], [7, 8, 9, 10]]
    assert spectral.segment(np.arange(3.0), 4, 0).shape == (0, 4)
    rng = np.random.default_rng(0)
    y = rng.normal(size=(2, 101))
    for size, nov in ((4, 0), (16, 5), (101, 0), (50, 49)):
        assert dsputils.pretty_close(_np(spectral.segment(y, size, nov)),
                                     np.asarray(jspec.segment(y, size, nov)))
        assert spectral.num_segments(101, size, nov) == jspec.num_segments(101, size, nov)


def test_golden_ramp():
    pxx, freqs = spectral.pwelch(np.arange(100, dtype=np.float64), 2.0, spectral.PwelchOptions())
    assert pxx.shape == (129,) and pxx.dtype == torch.float64
    assert dsputils.pretty_close(_np(pxx), GOLDEN_PXX)
    assert dsputils.pretty_close(_np(freqs), np.arange(129) * (2.0 / 256.0))


def test_golden_ramp_fused_branch(fused_on_cpu):
    pxx, _ = spectral.pwelch(np.arange(100, dtype=np.float64), 2.0)
    assert dsputils.pretty_close(_np(pxx), GOLDEN_PXX)


def test_empty_input():
    pxx, freqs = spectral.pwelch(np.zeros(0), 0.0)
    assert pxx.shape == (0,) and freqs.shape == (0,)
    assert spectral.periodogram(np.zeros(0), 1.0)[0].shape == (0,)


@pytest.mark.parametrize("case", sorted(OPTION_CASES))
@pytest.mark.parametrize("length", [50, 1000])
def test_pwelch_matches_jax(case, length):
    rng = np.random.default_rng(length)
    x = rng.normal(size=length)
    o, jo = _opts(case)
    pxx, freqs = spectral.pwelch(x, 8000.0, o)
    jpxx, jfreqs = jspec.pwelch(x, 8000.0, jo)
    assert dsputils.pretty_close(_np(pxx), np.asarray(jpxx))
    assert dsputils.pretty_close(_np(freqs), np.asarray(jfreqs))


@pytest.mark.parametrize("case", ["default", "50pct", "hop160", "pad_gt_nfft", "pad_lt_nfft"])
def test_fused_branch_matches_jax(fused_on_cpu, case):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 3000))
    o, jo = _opts(case)
    pxx, _ = spectral.pwelch(x, 2.0, o)
    assert dsputils.pretty_close(_np(pxx), np.asarray(jspec.pwelch(x, 2.0, jo)[0]))


def test_from_frames_and_periodogram_match_jax():
    rng = np.random.default_rng(4)
    frames = rng.normal(size=(7, 128))
    for case in ("50pct", "pad_gt_nfft"):
        o, jo = _opts(case)
        got = _np(spectral.pwelch_from_frames(frames, 3.0, o)[0])
        assert dsputils.pretty_close(got, np.asarray(jspec.pwelch_from_frames(frames, 3.0, jo)[0]))
    x = rng.normal(size=300)
    for kw in ({}, dict(window="hann", pad=512), dict(scale_off=True)):
        got = _np(spectral.periodogram(x, 5.0, **kw)[0])
        assert dsputils.pretty_close(got, np.asarray(jspec.periodogram(x, 5.0, **kw)[0]))


# ---------------------------------------------------------------- K4 plain version


@pytest.mark.parametrize(
    "nfft,stride,pad,keep",
    [(256, 128, 256, 12), (256, 160, 256, 9), (256, 128, 512, 7)],
    ids=["hop128", "hop160", "pad512"],
)
def test_k4_plain_vs_jax_kernel(nfft, stride, pad, keep):
    from godsp_tpu.ops.pallas_pwelch import digit_to_natural_bins, pwelch_power_partials

    S = 12
    rng = np.random.default_rng(nfft + stride + pad)
    ext = rng.normal(size=(S - 1) * stride + nfft).astype(np.float32)
    mask = (np.arange(S) < keep).astype(np.float32)  # ragged: a partial mask
    w = jwin.window_table_np("hann", pad).astype(np.float32)
    want = digit_to_natural_bins(
        pwelch_power_partials(jnp.asarray(ext), jnp.asarray(mask), jnp.asarray(w), nfft, stride,
                              pad=pad, interpret=True).sum(axis=-2), pad)[..., : pad // 2 + 1]
    before = dict(cuda_pwelch.launches)
    got = cuda_pwelch.pwelch_power_partials(
        torch.from_numpy(ext), torch.from_numpy(mask), torch.from_numpy(w), nfft, stride, pad=pad,
    )
    assert got.shape == (S, pad // 2 + 1)  # one segment a tile at this size, natural bins
    assert dsputils.snr_db(_np(got.sum(dim=-2)), np.asarray(want, np.float64)) >= SNR_KERNEL_DB
    assert cuda_pwelch.launches == before


def test_k4_sum_vs_jax_power_sum():
    from godsp_tpu.ops.pallas_pwelch import pwelch_power_sum

    rng = np.random.default_rng(21)
    x = rng.normal(size=(2, 4096)).astype(np.float32)
    w = jwin.window_table_np("hamming", 512).astype(np.float32)
    total = (4096 - 512) // 256 + 1
    want = pwelch_power_sum(jnp.asarray(x), jnp.asarray(w), 512, 256, total, interpret=True)
    got = cuda_pwelch.pwelch_power_sum(torch.from_numpy(x), torch.from_numpy(w), 512, 256, total)
    assert dsputils.snr_db(_np(got), np.asarray(want, np.float64)) >= SNR_KERNEL_DB


def test_k4_plain_ragged_tiles_vs_numpy():
    """Tiles of segs_per_tile segments, the last one partial, sum to the
    masked per-segment loop of pwelch.go:107-122."""
    S, nfft, stride, pad = 1101, 64, 40, 128
    rng = np.random.default_rng(2)
    ext = rng.normal(size=(S - 1) * stride + nfft - 30)  # last segments run off the end
    mask = (rng.random(S) < 0.9).astype(np.float64)
    mask[-3:] = 0.0  # masked segments need not be covered by ext
    w = window.window_table_np("hann", pad)
    bt = cuda_pwelch.segs_per_tile(S, 1)
    assert S % bt  # a ragged last tile
    got = cuda_pwelch.pwelch_power_partials(torch.from_numpy(ext), torch.from_numpy(mask),
                                            torch.from_numpy(w), nfft, stride, pad=pad)
    assert got.shape == (-(-S // bt), pad // 2 + 1)
    padded = np.concatenate([ext, np.zeros(nfft)])
    want = np.zeros(pad // 2 + 1)
    for s in range(S):
        if mask[s]:
            frame = np.zeros(pad)
            frame[:nfft] = padded[s * stride : s * stride + nfft]
            want += np.abs(np.fft.rfft(frame * w)) ** 2
    assert dsputils.pretty_close(_np(got.sum(dim=0)), want)


def test_k4_geometry_checks():
    x = torch.zeros(1000)
    with pytest.raises(ValueError):
        cuda_pwelch.pwelch_power_partials(x, torch.ones(3), torch.ones(300), 256, 128, pad=300)
    with pytest.raises(ValueError):
        cuda_pwelch.pwelch_power_partials(x, torch.ones(3), torch.ones(128), 256, 128, pad=128)
    assert cuda_pwelch.fused_supported(256, 256, 160)
    assert not cuda_pwelch.fused_supported(256, 1 << 15, 128)
    assert cuda_pwelch.segs_per_tile(256, 1) == 1
    assert cuda_pwelch.segs_per_tile(1 << 20, 1) == 64


# ---------------------------------------------------------------- one-device step


def test_resolve_geometry_matches_jax():
    for case in OPTION_CASES:
        o, jo = _opts(case)
        got, want = sharded.resolve_geometry(o), jsharded.resolve_geometry(jo)
        assert got[0] == want[0] and got[2:] == want[2:]
    with pytest.raises(ValueError):
        sharded.resolve_geometry(spectral.PwelchOptions(nfft=64, noverlap=64))


@pytest.mark.parametrize("fused", [False, True], ids=["frames", "fused"])
@pytest.mark.parametrize("case", ["50pct", "hop160", "pad_lt_nfft"])
def test_partial_step_matches_jax_sharded_step(request, fused, case):
    if fused:
        request.getfixturevalue("fused_on_cpu")
    o, jo = _opts(case)
    nfft, wf, pad, fft_len, _, _, stride, lp = sharded.resolve_geometry(o)
    segs, total = 8, 6
    rng = np.random.default_rng(stride)
    x = rng.normal(size=(1, segs * stride))
    tail = rng.normal(size=(1, nfft - stride))
    w = window.window_table_np(wf, fft_len)
    p, count = sharded.sharded_partial_step(
        torch.from_numpy(x), torch.from_numpy(tail), torch.from_numpy(w), Mesh([["cpu"]]), nfft,
        fft_len, stride, segs, lp, total,
    )
    mesh = make_mesh(MeshConfig(dp=1, sp=1))
    jp, jcount = jsharded.sharded_partial_step(
        jnp.asarray(x), jnp.asarray(tail), jnp.asarray(w), mesh, nfft, fft_len, stride, segs,
        lp, total,
    )
    assert dsputils.pretty_close(_np(p), np.asarray(jp))
    assert float(count[0]) == float(jcount[0]) == total
