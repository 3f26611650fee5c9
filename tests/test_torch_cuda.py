"""The Hopper kernels on the card, against their float64 plain versions.

Every test here is marked `cuda` and skips where torch.cuda.is_available()
is false.  The module imports no jax, so on a GPU machine without jax it
runs on its own, past tests/conftest.py (which imports jax):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Bound: >= 120 dB SNR (the BASELINE parity bar) between a float32 kernel
(K1-K14) and its plain version in float64 on the same inputs (the K14c
copies, and gmm_concat against K13, equal; K14d's half3 and adds equal
to their float32 plain versions, bd_tf32 against its plain version with
TF32-rounded operands; K14h vdif also against the float64 FFT in its digit
order, K14i sdif_peel against K8 with the rows bit-reversed; K14e lane_flip
exact; K14f gmm_tf32 against its TF32-rounded plain version, every ls_full
setting and every fft_pow2_rows setting equal to its default; K1/K2/K3
at every power of two 2..16384, and K1's radix-2 first design
(fft_pow2_radix2); K5 and K8's register-radix redesign at every pad and
m with ragged shapes, past grid.y, never falling back, beside their
radix-2 first designs (stft_radix2, outer_dft_radix2); K6 and K9's
redesign (a frame a warp after K3's split run backwards; a thread-block
cluster over distributed shared memory) at their edge geometries, two
calls bit-equal, their plans equal to the host's, beside istft_radix2 and
peel_rows_radix2; K14g i8_dot
equal to the exact int32 product and to its first design i8_dot_bytes on
both load paths, i8mm, i8dec, i8full and i8_concat equal
to their plain versions, which do the same integer and float32 arithmetic,
and i8full > 100 dB against the float64 product; K13 equal to its first
design gmm_floor_sync and to gmm_concat at ragged shapes, its plan and
i8_dot's equal to the host's), and between
the public entry points on the card and the CPU in float64 (a synthesized
signal over its interior, away from the NOLA-divided ends); the fused
peel + rows route (K9) also against the unfused plan.
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
    cuda_metrics,
    cuda_outer,
    cuda_probes,
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


_K1_SIZES = [1 << k for k in range(1, 15)]


@pytest.mark.parametrize("n,rows", [(n, r) for n in _K1_SIZES for r in (1, 33)]
                         + [(n, 65537) for n in _K1_SIZES if n <= 256])
def test_k1_k2_k3_on_card(cuda, n, rows):
    """The register-radix K1/K2/K3 at every power of two 2..16384, at 1 and
    33 rows, and at 65,537 rows (past grid.y's 65535) where n <= 256."""
    rng = np.random.default_rng(n + rows)
    xr = torch.from_numpy(rng.normal(size=(rows, n))).to(cuda)
    xi = torch.from_numpy(rng.normal(size=(rows, n))).to(cuda)
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


def test_k3_reads_an_unaligned_view(cuda):
    """K3 reads pairs as 8-byte float2: a row view starting at an odd
    float goes through a copy and gives the contiguous row's result."""
    x = torch.randn(4 * 1024 + 1, device=cuda)
    v = x[1:].view(4, 1024)
    assert v.data_ptr() % 8
    got = cuda_fft.rfft_pow2(v)
    want = cuda_fft.rfft_pow2(v.clone())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_k1_geometry_matches_the_host_plan(cuda):
    """gdsp_fft_pow2_geometry (the kernels' own plan) equals ops/cuda_fft.py's."""
    import ctypes

    lib = _build.library()
    out = (ctypes.c_int * 11)()
    for lg in range(15):
        assert lib.gdsp_fft_pow2_geometry(lg, out) == 0
        g = cuda_fft.geometry(1 << lg)
        assert list(out) == [g.points, g.threads, int(g.warp), g.q, g.max_threads,
                             g.default_rows, len(g.radices), *(list(g.radices) + [0] * 4)[:4]]


@pytest.mark.parametrize("n", _K1_SIZES)
def test_fft_pow2_rows_every_setting_on_card(cuda, n):
    """Every rows-a-CTA setting that fits gives fft_pow2's result bit for bit."""
    xr, xi = (torch.randn(301, n, device=cuda) for _ in range(2))
    k1 = cuda_fft.fft_pow2(xr, xi)
    fits = [r for r in range(1, 1025) if cuda_probes.fft_rows_fit(n, r)]
    assert fits == list(range(1, len(fits) + 1))
    for r in fits:
        got = cuda_probes.fft_pow2_rows(xr, xi, r)
        assert torch.equal(got[0], k1[0]) and torch.equal(got[1], k1[1]), r


@pytest.mark.parametrize("n", [2, 256, 1024, 16384])
def test_fft_pow2_radix2_on_card(cuda, n):
    """K1's first design, the redesign's yardstick, against float64."""
    rng = np.random.default_rng(n)
    xr = torch.from_numpy(rng.normal(size=(33, n))).to(cuda)
    xi = torch.from_numpy(rng.normal(size=(33, n))).to(cuda)
    before = launch_counts()["fft_pow2_radix2"]
    for got, want in (
        (cuda_probes.fft_pow2_radix2(xr.float(), xi.float()), cuda_fft.fft_pow2_plain(xr, xi)),
        (cuda_probes.fft_pow2_radix2(xr.float(), None), cuda_fft.fft_pow2_plain(xr, None)),
        (cuda_probes.fft_pow2_radix2(xr.float(), xi.float(), True, 1.0 / n),
         cuda_fft.ifft_pow2_plain(xr, xi, 1.0 / n)),
        (cuda_probes.fft_pow2_radix2(xr.float(), None, bins=n // 2 + 1),
         cuda_fft.rfft_pow2_plain(xr)),
    ):
        assert dsputils.snr_db(_np(got[0]) + 1j * _np(got[1]),
                               _np(want[0]) + 1j * _np(want[1])) >= SNR_CARD_DB
    assert launch_counts()["fft_pow2_radix2"] == before + 4


@pytest.mark.parametrize("flag", [True, False])
def test_k1_k2_k3_leave_tf32_flags(cuda, flag):
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = flag
        x = torch.randn(8, 1024, device=cuda)
        cuda_fft.fft_pow2(x, x)
        cuda_fft.ifft_pow2(x, x, 1.0 / 1024)
        cuda_fft.rfft_pow2(x)
        cuda_probes.fft_pow2_radix2(x, x)
        torch.cuda.synchronize()
        assert torch.backends.cuda.matmul.allow_tf32 is flag
        assert torch.backends.cudnn.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


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
    (16384, 4096, 16384, True),  # a frame a CTA, the half-length inverse of 8192 points
    (16384, 1024, 16384, True),  # the same at a short hop: a window of four frames' partials
    (16384, 1024, 16384, False),  # a frame a CTA of 1024 threads, 16384 points
    (1023, 3, 1024, True), (1001, 7, 1024, False),  # odd nfft, odd hops
    (512, 512, 512, True), (2, 1, 2, True), (2, 2, 2, False),  # hop = nfft; the smallest pad
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
    again = cuda_istft.istft_overlap_add(spec.to(torch.complex64), w.float(), nfft, hop, onesided)
    assert torch.equal(got, again)  # no atomics: the same sums in the same order


@pytest.mark.parametrize("F,rows,bt", [(50, 1, 3), (2500, 2, 10), (20000, 2, 64)])
def test_k6_tile_stitch_at_the_tail_bound(cuda, F, rows, bt):
    """K6's first design's tiles (istft_radix2: bt frames a tile, its tails
    stitched by the wrapper), from bt*hop just above nfft - hop (3 * 300 >=
    724: each tail reaches only the next tile) to the 64-frame cap; and K6,
    whose CTAs recompute the frames before their tiles, at the same shapes."""
    nfft, hop = 1024, 300
    assert cuda_probes.istft_radix2_tiles(F, rows, nfft, hop) == bt
    rng = np.random.default_rng(F)
    shape = (rows, F, 513)
    spec = torch.from_numpy(rng.normal(size=shape) + 1j * rng.normal(size=shape)).to(cuda)
    w = window.window_table("hann", nfft, device=cuda)
    want = cuda_istft.istft_overlap_add_plain(spec, w, nfft, hop)
    for run in (cuda_istft.istft_overlap_add, cuda_probes.istft_radix2):
        got = run(spec.to(torch.complex64), w.float(), nfft, hop)
        assert dsputils.snr_db(_np(got), _np(want)) >= SNR_CARD_DB, run


@pytest.mark.parametrize("nfft", [1024, 2048, 4096])
def test_k6_whole_signal_after_the_window_energy_division(cuda, nfft):
    """The public istft (K6) over a whole signal, Hann at hop nfft/4,
    against the float64 route on the same complex64 spectra (on the card
    the public stft returns complex64 even for float64 input, so both are
    made on the CPU): the division scales the float32 error of
    the row's end samples by 1/w, and K6 sums the samples where Hann is
    below EDGE_TAU of its peak (more as nfft grows) in float64."""
    hop = nfft // 4
    x = torch.from_numpy(np.random.default_rng(nfft).normal(size=300_000))
    spec = models.stft(x, nfft, hop=hop).to(torch.complex64)  # on the CPU, rounded once
    reset_launch_counts()
    got = models.istft(spec.to(cuda), nfft, hop=hop)
    assert launch_counts()["istft_overlap_add"] == 1
    want = models.istft(spec.to(torch.complex128), nfft, hop=hop)  # float64, on the CPU
    assert dsputils.snr_db(_np(got), _np(want)) >= SNR_CARD_DB


def test_k6_geometry_matches_the_host_plan(cuda):
    """gdsp_istft_geometry (the kernel's own CTA) equals ops/cuda_istft.py's."""
    import ctypes

    lib = _build.library()
    out = (ctypes.c_int * 6)()
    for lg in range(1, 15):
        for onesided in (True, False):
            assert lib.gdsp_istft_geometry(lg, int(onesided), out) == 0
            assert tuple(out) == tuple(cuda_istft.istft_cta(1 << lg, onesided)), (lg, onesided)


@pytest.mark.parametrize("pad,onesided", [(1024, True), (2048, False)])
def test_istft_radix2_on_card(cuda, pad, onesided):
    """K6's first design, the redesign's yardstick, against float64."""
    rng = np.random.default_rng(pad)
    bins = pad // 2 + 1 if onesided else pad
    spec = torch.from_numpy(rng.normal(size=(3, 30, bins)) + 1j * rng.normal(size=(3, 30, bins)))
    w = window.window_table("hann", pad, device=cuda)
    spec = spec.to(cuda)
    before = launch_counts()["istft_radix2"]
    got = cuda_probes.istft_radix2(spec.to(torch.complex64), w.float(), pad, pad // 4, onesided)
    want = cuda_istft.istft_overlap_add_plain(spec, w, pad, pad // 4, onesided)
    assert dsputils.snr_db(_np(got), _np(want)) >= SNR_CARD_DB
    assert launch_counts()["istft_radix2"] == before + 1


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


# ---------------------------------------------------------------- K5 / K8 redesign (PR 15)

_K5_PADS = [1 << k for k in range(1, 15)]


def _k5_case(cuda, pad, nfft, hop, rows, frames, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(rows, (frames - 1) * hop + nfft + hop // 2))).to(cuda)
    w = torch.zeros(pad, dtype=torch.float64, device=cuda)
    w[:nfft] = torch.from_numpy(rng.normal(size=nfft)).to(cuda)
    fb = models.mel_filterbank(24, pad, 16000.0, device=cuda) if pad >= 64 else \
        torch.from_numpy(rng.random((3, pad // 2 + 1))).to(cuda)
    return x, w, fb, (x.shape[-1] - nfft) // hop + 1


@pytest.mark.parametrize("pad", _K5_PADS)
def test_k5_redesign_every_pad_on_card(cuda, pad):
    """K5 (register-radix, csrc/stft_kernel.cu) in each mode at every pad
    2..16384: the full frame at a quarter hop, nfft odd below pad at hop 3,
    and hop 255, against the float64 plain version; one launch a call."""
    odd = max(1, pad - 1)
    for nfft, hop in sorted({(pad, max(1, pad // 4)), (odd, 3), (max(1, pad // 2 + 1), 255)}):
        x, w, fb, F = _k5_case(cuda, pad, nfft, hop, 3, 9, pad + hop)
        for out in ("complex", "power", "mel"):
            extra = (fb.float(),) if out == "mel" else ()
            name = f"stft_{out}"
            before = launch_counts()[name]
            got = getattr(cuda_stft, name)(x.float(), w.float(), nfft, hop, F, *extra, pad=pad)
            assert launch_counts()[name] == before + 1
            want = cuda_stft.stft_pallas_plain(x, w, nfft, hop, F, pad, out, fb)
            assert got.shape == want.shape
            assert dsputils.snr_db(_np(got), _np(want)) >= SNR_CARD_DB, (nfft, hop, out)


@pytest.mark.parametrize("nfft", [1000, 2048])
def test_k5_redesign_at_hop_160_pad_2048_on_card(cuda, nfft):
    x, w, fb, F = _k5_case(cuda, 2048, nfft, 160, 2, 400, nfft)
    for out in ("complex", "power", "mel"):
        extra = (fb.float(),) if out == "mel" else ()
        got = getattr(cuda_stft, f"stft_{out}")(x.float(), w.float(), nfft, 160, F, *extra, pad=2048)
        want = cuda_stft.stft_pallas_plain(x, w, nfft, 160, F, 2048, out, fb)
        assert dsputils.snr_db(_np(got), _np(want)) >= SNR_CARD_DB, out


@pytest.mark.parametrize("pad", [64, 1024])
def test_k5_redesign_more_frames_than_grid_y_on_card(cuda, pad):
    """66,000 rows of one frame each: the flat frame index serves them in
    one launch."""
    x, w, fb, _ = _k5_case(cuda, pad, pad, pad, 66_000, 1, pad)
    x = x[:, :pad].contiguous()
    for out in ("complex", "power", "mel"):
        extra = (fb.float(),) if out == "mel" else ()
        got = getattr(cuda_stft, f"stft_{out}")(x.float(), w.float(), pad, pad, 1, *extra, pad=pad)
        want = cuda_stft.stft_pallas_plain(x, w, pad, pad, 1, pad, out, fb)
        assert got.shape == (66_000, 1, want.shape[-1])
        assert dsputils.snr_db(_np(got), _np(want)) >= SNR_CARD_DB, out


def test_k5_reads_an_unaligned_window_on_card(cuda):
    """K5 reads the window as float2 pairs: a window view starting at an
    odd float goes through a copy and gives the contiguous window's result."""
    x = torch.rand(2, 6000, device=cuda)
    wide = torch.rand(1024 + 1, device=cuda)
    w = wide[1:]
    assert w.data_ptr() % 8
    for out in ("complex", "power"):
        got = getattr(cuda_stft, f"stft_{out}")(x, w, 1000, 160, 30, pad=1024)
        want = getattr(cuda_stft, f"stft_{out}")(x, w.clone(), 1000, 160, 30, pad=1024)
        assert torch.equal(got, want), out


def test_k5_mel_band_sums_match_a_dense_bank_on_card(cuda):
    """The mel mode sums each filter's band only: a bank whose filters
    overlap, one all zero, one ending at bin pad/2, at pad 1024 and 2048
    (eight frames a warp) and 4096 (a CTA a frame)."""
    rng = np.random.default_rng(4)
    for pad in (1024, 2048, 4096):
        lp = pad // 2 + 1
        fb = np.zeros((37, lp))
        for j in range(37):
            lo = int(rng.integers(0, lp))
            hi = int(rng.integers(lo, min(lp, lo + 300)))
            fb[j, lo:hi + 1] = rng.random(hi - lo + 1)
        fb[3] = 0.0
        fb[-1, lp - 50:] = rng.random(50)
        fbt = torch.from_numpy(fb).to(cuda)
        x, w, _, F = _k5_case(cuda, pad, pad, 300, 2, 40, pad)
        got = cuda_stft.stft_mel(x.float(), w.float(), pad, 300, F, fbt.float())
        want = cuda_stft.stft_pallas_plain(x, w, pad, 300, F, pad, "mel", fbt)
        assert dsputils.snr_db(_np(got), _np(want)) >= SNR_CARD_DB, pad


@pytest.mark.parametrize("m", [1 << k for k in range(1, 12)])
def test_k8_redesign_every_m_on_card(cuda, m):
    """K8 (register-radix passes down a tile of columns) at every m, ragged
    n3, d2 > 1, both directions, against the float64 plain version."""
    for b, n3, d2 in ((2, 1, 1), (1, 7, 2 if m >= 4 else 1), (3, 1001, 1), (1, 4099, m // 2 if m >= 4 else 1)):
        x = _crandn(cuda, b, m, n3, seed=m + n3)
        for inverse in (False, True):
            before = launch_counts()["outer_dft_split"]
            got = cuda_outer.outer_dft_split(x.real.float(), x.imag.float(), m // d2, d2, inverse)
            assert launch_counts()["outer_dft_split"] == before + 1
            want = cuda_outer.outer_dft_split_plain(x.real.contiguous(), x.imag.contiguous(),
                                                    m // d2, d2, inverse)
            g, w = torch.complex(*got).to(torch.complex128), torch.complex(*want)
            assert dsputils.snr_db(_np(g), _np(w)) >= SNR_CARD_DB, (b, n3, d2, inverse)


def test_k8_redesign_batch_past_grid_y_on_card(cuda):
    x = _crandn(cuda, 70_000, 8, 3, seed=8)
    got = cuda_outer.outer_dft_split(x.real.float(), x.imag.float(), 8, 1)
    want = cuda_outer.outer_dft_split_plain(x.real.contiguous(), x.imag.contiguous(), 8, 1)
    g, w = torch.complex(*got).to(torch.complex128), torch.complex(*want)
    assert dsputils.snr_db(_np(g), _np(w)) >= SNR_CARD_DB


def test_k8_tile_matches_the_host_on_card(cuda):
    """gdsp_outer_dft_geometry (the kernel's own tile) equals cuda_outer.tile."""
    import ctypes

    lib = _build.library()
    out = (ctypes.c_int * 3)()
    for lg in range(1, 12):
        assert lib.gdsp_outer_dft_geometry(lg, out) == 0
        assert tuple(out) == tuple(cuda_outer.tile(1 << lg))


def test_k5_k8_never_fall_back_on_card(cuda, monkeypatch):
    """A CUDA tensor goes through the kernel: with the plain versions made
    to raise, every wrapper still answers, one launch a call."""
    def broken(*a, **k):
        raise AssertionError("plain version reached with a CUDA tensor")

    monkeypatch.setattr(cuda_stft, "stft_pallas_plain", broken)
    monkeypatch.setattr(cuda_outer, "outer_dft_split_plain", broken)
    x = torch.rand(2, 9000, device=cuda)
    w = window.window_table("hann", 1024, device=cuda, dtype=torch.float32)
    fb = models.mel_filterbank(40, 1024, 16000.0, device=cuda, dtype=torch.float32)
    xr, xi = torch.randn(2, 128, 300, device=cuda), torch.randn(2, 128, 300, device=cuda)
    reset_launch_counts()
    cuda_stft.stft_complex(x, w, 1024, 256, 20)
    cuda_stft.stft_power(x, w, 1024, 256, 20)
    cuda_stft.stft_mel(x, w, 1024, 256, 20, fb)
    cuda_outer.outer_dft_split(xr, xi, 128, 1)
    cuda_probes.stft_radix2(x, w, 1024, 256, 20)
    cuda_probes.outer_dft_radix2(xr, xi, 128, 1)
    torch.cuda.synchronize()
    assert launch_counts() == {**{k: 0 for k in launch_counts()}, "stft_complex": 1,
                               "stft_power": 1, "stft_mel": 1, "outer_dft_split": 1,
                               "stft_radix2": 1, "outer_dft_radix2": 1}


def test_radix2_yardsticks_give_the_same_bins_on_card(cuda):
    """stft_radix2 and outer_dft_radix2 (the first designs) against float64
    and against the redesigned kernels, >= 120 dB."""
    x, w, fb, F = _k5_case(cuda, 1024, 1000, 160, 2, 60, 3)
    for out in ("complex", "power", "mel"):
        extra = dict(fb=fb.float()) if out == "mel" else {}
        old = cuda_probes.stft_radix2(x.float(), w.float(), 1000, 160, F, 1024, out, **extra)
        new = getattr(cuda_stft, f"stft_{out}")(x.float(), w.float(), 1000, 160, F,
                                                *extra.values(), pad=1024)
        want = cuda_stft.stft_pallas_plain(x, w, 1000, 160, F, 1024, out, fb)
        assert dsputils.snr_db(_np(old), _np(want)) >= SNR_CARD_DB, out
        assert dsputils.snr_db(_np(old), _np(new)) >= SNR_CARD_DB, out
    z = _crandn(cuda, 3, 128, 1000, seed=2)
    for d1, d2, inverse in ((128, 1, False), (16, 8, True)):
        old = cuda_probes.outer_dft_radix2(z.real.float(), z.imag.float(), d1, d2, inverse)
        new = cuda_outer.outer_dft_split(z.real.float(), z.imag.float(), d1, d2, inverse)
        want = torch.complex(*cuda_outer.outer_dft_split_plain(z.real.contiguous(),
                                                               z.imag.contiguous(), d1, d2,
                                                               inverse))
        old, new = (torch.complex(*p).to(torch.complex128) for p in (old, new))
        assert dsputils.snr_db(_np(old), _np(want)) >= SNR_CARD_DB
        assert dsputils.snr_db(_np(old), _np(new)) >= SNR_CARD_DB


# ---------------------------------------------------------------- K4 / K11 / K7 redesign


def _welch_case(cuda, pad, nfft, hop, rows, S, seed):
    """rows x (S segments + a halo of nfft - hop samples) float64 on the
    card, an arbitrary window zero past nfft, and a partial mask with a
    masked run at the end (its samples need not be read)."""
    rng = np.random.default_rng(seed)
    sig = torch.from_numpy(rng.normal(size=(rows, S * hop + nfft))).to(cuda)
    w = torch.zeros(pad, dtype=torch.float64, device=cuda)
    w[:nfft] = torch.from_numpy(rng.normal(size=nfft)).to(cuda)
    keep = (rng.random((rows, S)) < 0.8) & (np.arange(S) < S - 2)
    mask = torch.from_numpy(keep.astype(np.float64)).to(cuda)
    return sig, w, mask


def _welch_geometries(pad):
    """(nfft, hop): the full frame at a quarter hop, nfft odd below pad at
    hops 3 and 1, half the frame at hop 255, and hop 160."""
    odd = max(1, pad - 1)
    return sorted({(pad, max(1, pad // 4)), (odd, 3), (odd, 1), (max(1, pad // 2 + 1), 255),
                   (min(pad, 1000), 160)})


def _snr_c(got, want):
    g = torch.complex(*got).to(torch.complex128)
    return dsputils.snr_db(_np(g), _np(torch.complex(*want)))


@pytest.mark.parametrize("pad", [1 << k for k in range(1, 15)])
def test_k4_k11_k7_redesign_every_pad_on_card(cuda, pad):
    """K4, K11 and K7 (csrc/frame_regs.cuh's body) at every pad 2..16384
    against their float64 plain versions, >= 120 dB, at odd hops and hop
    160, two rows, a partial mask and a ragged last tile (701 segments a
    row), K11 reading a neighbour whose first pair straddles the block's
    end at an odd hop; one launch a call, and two calls bit-equal."""
    S, rows = 701, 2
    for nfft, hop in _welch_geometries(pad):
        sig, w, mask = _welch_case(cuda, pad, nfft, hop, rows, S, pad + hop)
        bt = cuda_pwelch.segs_per_tile(S, rows)
        assert S % bt
        ext, ext32, w32, m32 = sig, sig.float(), w.float(), mask.float()
        reset_launch_counts()
        got = cuda_pwelch.pwelch_power_partials(ext32, m32, w32, nfft, hop, pad=pad)
        again = cuda_pwelch.pwelch_power_partials(ext32, m32, w32, nfft, hop, pad=pad)
        want = cuda_pwelch.pwelch_power_partials_plain(ext, mask, w, nfft, hop, pad, bt)
        assert got.shape == want.shape and torch.equal(got, again)
        assert dsputils.snr_db(_np(got), _np(want)) >= SNR_CARD_DB, ("K4", nfft, hop)
        L = S * hop - (hop % 2 == 0)  # odd hop: the block ends inside a pair
        x, h = sig[:, :L], sig[:, L:]
        got = cuda_fused_halo.pwelch_power_partials_halo(x.float(), h.float(), m32, w32, nfft,
                                                         hop, pad=pad)
        want = cuda_fused_halo.pwelch_power_partials_halo_plain(x, h, mask, w, nfft, hop, pad, bt)
        assert dsputils.snr_db(_np(got), _np(want)) >= SNR_CARD_DB, ("K11", nfft, hop)
        y = 0.3 * torch.roll(sig, 5, -1) + torch.flip(sig, (-1,))
        got = cuda_csd.csd_power_partials(ext32, y.float(), m32, w32, nfft, hop, pad=pad)
        again = cuda_csd.csd_power_partials(ext32, y.float(), m32, w32, nfft, hop, pad=pad)
        want = cuda_csd.csd_power_partials_plain(ext, y, mask, w, nfft, hop, pad, bt)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        assert _snr_c(got, want) >= SNR_CARD_DB, ("K7", nfft, hop)
        assert launch_counts() == {**{k: 0 for k in launch_counts()},
                                   "pwelch_power_partials": 2, "pwelch_power_partials_halo": 1,
                                   "csd_power_partials": 2}


@pytest.mark.parametrize("pad,nfft,hop,S", [(1024, 1024, 512, 51_678), (1024, 1000, 160, 6000),
                                            (2048, 1000, 160, 3001), (32, 32, 16, 70_001)])
def test_k4_k7_redesign_at_main_path_shapes_on_card(cuda, pad, nfft, hop, S):
    """The tiles of the main path (64 segments, eight frames a CTA), hop 160
    at pad 1024 and 2048, and many tiles of a small pad, one row."""
    sig, w, mask = _welch_case(cuda, pad, nfft, hop, 1, S, S)
    bt = cuda_pwelch.segs_per_tile(S, 1)
    got = cuda_pwelch.pwelch_power_partials(sig.float(), mask.float(), w.float(), nfft, hop, pad)
    want = cuda_pwelch.pwelch_power_partials_plain(sig, mask, w, nfft, hop, pad, bt)
    assert dsputils.snr_db(_np(got), _np(want)) >= SNR_CARD_DB
    y = torch.roll(sig, 37, -1) * 0.7
    got = cuda_csd.csd_power_partials(sig.float(), y.float(), mask.float(), w.float(), nfft, hop,
                                      pad)
    assert _snr_c(got, cuda_csd.csd_power_partials_plain(sig, y, mask, w, nfft, hop, pad, bt)) \
        >= SNR_CARD_DB


def test_k4_k7_geometry_matches_the_host_plan(cuda):
    """gdsp_pwelch_geometry and gdsp_csd_geometry (the CTAs the kernels
    launch) equal partials_cta's and sums_in_smem's, which the CPU tests'
    bank counts and summation order read, at every pad and tile."""
    import ctypes

    lib = _build.library()
    out = (ctypes.c_int * 4)()
    for lg in range(1, 15):
        pad = 1 << lg
        for tile in (1, 2, 3, 5, 7, 8, 9, 16, 17, 31, 33, 64):
            assert lib.gdsp_pwelch_geometry(lg, tile, out) == 0
            assert list(out)[:3] == list(cuda_pwelch.partials_cta(pad, tile, tile, 1)), (pad, tile)
            assert lib.gdsp_csd_geometry(lg, tile, out) == 0
            assert list(out) == [*cuda_pwelch.partials_cta(pad, tile, tile, 2),
                                 int(cuda_csd.sums_in_smem(pad))], (pad, tile)
    assert lib.gdsp_pwelch_geometry(15, 1, out) != 0
    assert lib.gdsp_csd_geometry(0, 1, out) != 0


def test_k4_k11_k7_never_fall_back_on_card(cuda, monkeypatch):
    """A CUDA tensor goes through the kernels: with the plain versions made
    to raise, every wrapper still answers, one launch a call; an unaligned
    window goes through a copy and gives the aligned window's result."""
    def broken(*a, **k):
        raise AssertionError("plain version reached with a CUDA tensor")

    x = torch.rand(2, 20000, device=cuda)
    wide = torch.rand(1024 + 1, device=cuda)
    w = wide[1:]
    assert w.data_ptr() % 8
    mask = torch.ones(2, 30, device=cuda)
    aligned = (cuda_pwelch.pwelch_power_partials(x, mask, w.clone(), 1000, 160, 1024),
               cuda_csd.csd_power_partials(x, x, mask, w.clone(), 1000, 160, 1024))
    for mod, name in ((cuda_pwelch, "pwelch_power_partials_plain"),
                      (cuda_csd, "csd_power_partials_plain"),
                      (cuda_fused_halo, "pwelch_power_partials_halo_plain")):
        monkeypatch.setattr(mod, name, broken)
    reset_launch_counts()
    got = cuda_pwelch.pwelch_power_partials(x, mask, w, 1000, 160, 1024)
    assert torch.equal(got, aligned[0])
    got = cuda_csd.csd_power_partials(x, x, mask, w, 1000, 160, 1024)
    assert all(torch.equal(a, b) for a, b in zip(got, aligned[1]))
    cuda_fused_halo.pwelch_power_partials_halo(x[:, :4800], x[:, 4800:], mask[0], w, 1000, 160,
                                               1024)
    cuda_probes.pwelch_radix2(x, mask, w, 1000, 160, 1024)
    cuda_probes.csd_radix2(x, x, mask, w, 1000, 160, 1024)
    torch.cuda.synchronize()
    assert launch_counts() == {**{k: 0 for k in launch_counts()}, "pwelch_power_partials": 1,
                               "csd_power_partials": 1, "pwelch_power_partials_halo": 1,
                               "pwelch_radix2": 1, "csd_radix2": 1}


@pytest.mark.parametrize("pad", [2, 256, 1024, 16384])
def test_pwelch_csd_radix2_yardsticks_on_card(cuda, pad):
    """pwelch_radix2 and csd_radix2 (K4's and K7's first designs) against
    float64 and against the redesigned kernels, >= 120 dB, one launch a
    call."""
    nfft, hop, S = max(1, pad - 1), 3, 301
    sig, w, mask = _welch_case(cuda, pad, nfft, hop, 2, S, pad)
    bt = cuda_pwelch.segs_per_tile(S, 2)
    y = torch.flip(sig, (-1,))
    reset_launch_counts()
    old = cuda_probes.pwelch_radix2(sig.float(), mask.float(), w.float(), nfft, hop, pad)
    new = cuda_pwelch.pwelch_power_partials(sig.float(), mask.float(), w.float(), nfft, hop, pad)
    want = cuda_pwelch.pwelch_power_partials_plain(sig, mask, w, nfft, hop, pad, bt)
    assert dsputils.snr_db(_np(old), _np(want)) >= SNR_CARD_DB
    assert dsputils.snr_db(_np(old), _np(new)) >= SNR_CARD_DB
    old = cuda_probes.csd_radix2(sig.float(), y.float(), mask.float(), w.float(), nfft, hop, pad)
    new = cuda_csd.csd_power_partials(sig.float(), y.float(), mask.float(), w.float(), nfft, hop,
                                      pad)
    assert _snr_c(old, cuda_csd.csd_power_partials_plain(sig, y, mask, w, nfft, hop, pad, bt)) \
        >= SNR_CARD_DB
    assert _snr_c(old, [t.double() for t in new]) >= SNR_CARD_DB
    assert launch_counts() == {**{k: 0 for k in launch_counts()}, "pwelch_radix2": 1,
                               "pwelch_power_partials": 1, "csd_radix2": 1,
                               "csd_power_partials": 1}


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


@pytest.mark.parametrize("shape,n_sp,halo", [((8 * 512,), 8, 96), ((3, 4 * 256), 4, 128),
                                             ((2, 8 * 130), 8, 7), ((3, 8 * 130), 8, 38),
                                             ((2, 300), 1, 100), ((64 * 64,), 64, 33),
                                             ((2, 64 * 40), 64, 40)],
                         ids=["single_row", "batched_rows", "unaligned", "halo_38", "one_shard",
                              "64_shards", "64_shards_rows"])
def test_k10_routes_on_card(cuda, shape, n_sp, halo):
    """K10's view route (the views of one signal, also in reverse order),
    its table route (separate copies of them) and the yardstick
    ring_halo_table on the views, each torch.equal to ring_halo_plain with
    one launch of its wrapper and nothing else; a float64 CUDA ring raises
    rather than taking the plain version."""
    x = torch.from_numpy(np.random.default_rng(n_sp + halo).normal(size=shape)).float().to(cuda)
    views = list(x.chunk(n_sp, dim=-1))
    apart = [v.clone() for v in views]
    assert cuda_halo.ring_plan(views, halo).route == "view"
    assert cuda_halo.ring_plan(views[::-1], halo).route == "view"
    if n_sp > 1:
        assert cuda_halo.ring_plan(apart, halo).route == "table"
    for blocks, fn, name in ((views, cuda_halo.ring_halo, "ring_halo"),
                             (views[::-1], cuda_halo.ring_halo, "ring_halo"),
                             (apart, cuda_halo.ring_halo, "ring_halo"),
                             (views, cuda_halo.ring_halo_table, "ring_halo_table")):
        reset_launch_counts()
        got = fn(blocks, halo)
        counts = launch_counts()
        assert counts[name] == 1 and sum(counts.values()) == 1
        want = cuda_halo.ring_halo_plain(blocks, halo)
        assert len(got) == n_sp and all(torch.equal(g, w) for g, w in zip(got, want))
    for fn in (cuda_halo.ring_halo, cuda_halo.ring_halo_table):
        with pytest.raises(TypeError):
            fn([v.double() for v in views], halo)


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


@pytest.mark.parametrize("b, n", [(1024, 1024), (7, 4099), (3, 5), (1, 1)])
def test_k12_on_card(cuda, b, n):
    """K12 equals its plain version, the float4 body and the scalar tail;
    one launch a call."""
    g = torch.Generator(device=cuda).manual_seed(b * n)
    xr = torch.randn(b, n, generator=g, device=cuda)
    xi = torch.randn(b, n, generator=g, device=cuda)
    before = launch_counts()["copy_split"]
    yr, yi = cuda_metrics.copy_split(xr, xi)
    assert launch_counts()["copy_split"] == before + 1
    wr, wi = cuda_metrics.copy_split_plain(xr, xi)
    assert torch.equal(yr, wr) and torch.equal(yi, wi)
    # A view at an odd offset is copied to an aligned buffer first.
    yr, yi = cuda_metrics.copy_split(xr.reshape(-1)[1:].reshape(1, -1),
                                     xi.reshape(-1)[1:].reshape(1, -1))
    assert torch.equal(yr.reshape(-1), xr.reshape(-1)[1:])


@pytest.mark.parametrize("b, n", [(1 << 17, 128), (37, 256), (16384, 1024), (1024, 16384)])
def test_k13_on_card(cuda, b, n):
    """K13 against its float64 plain version, >= 120 dB, n1 = 1 .. 128 and
    a ragged row tile; one launch a call."""
    g = torch.Generator(device=cuda).manual_seed(n)
    xr = torch.randn(b, n, generator=g, device=cuda)
    xi = torch.randn(b, n, generator=g, device=cuda)
    before = launch_counts()["gmm_floor"]
    yr, yi = cuda_metrics.gmm_floor(xr, xi)
    assert launch_counts()["gmm_floor"] == before + 1
    wr, wi = cuda_metrics.gmm_floor_plain(xr.double(), xi.double())
    got = _np(torch.complex(yr.double(), yi.double()))
    assert dsputils.snr_db(got, _np(torch.complex(wr, wi))) >= SNR_CARD_DB


def test_metrics_wrappers_raise_when_the_library_fails(cuda, monkeypatch):
    def broken():
        raise RuntimeError("nvcc failed: simulated")

    monkeypatch.setattr(_build, "library", broken)
    x = torch.rand(256, 1024, device=cuda)
    for call in (lambda: cuda_metrics.copy_split(x, x), lambda: cuda_metrics.gmm_floor(x, x)):
        with pytest.raises(RuntimeError, match="simulated"):
            call()
    with pytest.raises(TypeError):
        cuda_metrics.gmm_floor(x.double(), x.double())



# ---------------------------------------------------------------- K9, the rest of the FFT surface


@pytest.mark.parametrize("b,n3,inverse,scale", [(16, 8192, False, 1.0),
                                                (128, 1024, True, 2.0 ** -24),
                                                (3, 256, False, 1.0), (5, 512, True, 0.5),
                                                (3, 2048, False, 1.0), (2, 4096, True, 1.0)],
                         ids=["16x2^20", "2^24-last-peel", "smallest-row", "512", "2048", "4096"])
def test_k9_on_card(cuda, b, n3, inverse, scale):
    x = _crandn(cuda, b, 128, n3, seed=n3)
    before = launch_counts()["peel_rows_fused_split"]
    got = cuda_outer.peel_rows_fused_split(x.real.float(), x.imag.float(), inverse, scale)
    assert launch_counts()["peel_rows_fused_split"] == before + 1
    want = cuda_outer.peel_rows_fused_split_plain(x.real.contiguous(), x.imag.contiguous(),
                                                  inverse, scale)
    g, w = torch.complex(*got).to(torch.complex128), torch.complex(*want)
    assert dsputils.snr_db(_np(g), _np(w)) >= SNR_CARD_DB
    again = cuda_outer.peel_rows_fused_split(x.real.float(), x.imag.float(), inverse, scale)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])  # no atomics


def test_k9_batches_past_grid_y(cuda):
    """65,537 batch elements: more clusters than grid.y's 65535 (the grid is
    one flat index of clusters)."""
    b = 65537
    xr = torch.randn(b, 128, 256, device=cuda)
    xi = torch.randn(b, 128, 256, device=cuda)
    yr, yi = cuda_outer.peel_rows_fused_split(xr, xi)
    for rows in (slice(0, 2), slice(65534, 65537)):
        want = cuda_outer.peel_rows_fused_split_plain(xr[rows].double(), xi[rows].double())
        got = torch.complex(yr[rows], yi[rows]).to(torch.complex128)
        assert dsputils.snr_db(_np(got), _np(torch.complex(*want))) >= SNR_CARD_DB


def test_k9_plan_matches_the_host_plan(cuda):
    """gdsp_peel_rows_geometry (the kernel's own cluster plan) equals
    ops/cuda_outer.py's peel_plan."""
    import ctypes

    lib = _build.library()
    out = (ctypes.c_int * 8)()
    for lg in range(8, 14):
        assert lib.gdsp_peel_rows_geometry(lg, out) == 0
        assert tuple(out) == tuple(cuda_outer.peel_plan(1 << lg)), lg


def test_peel_rows_radix2_on_card(cuda):
    """K9's first design, the redesign's yardstick, against float64."""
    x = _crandn(cuda, 3, 128, 1024, seed=3)
    before = launch_counts()["peel_rows_radix2"]
    got = cuda_probes.peel_rows_radix2(x.real.float(), x.imag.float(), True, 0.5)
    want = cuda_outer.peel_rows_fused_split_plain(x.real.contiguous(), x.imag.contiguous(),
                                                  True, 0.5)
    g, w = torch.complex(*got).to(torch.complex128), torch.complex(*want)
    assert dsputils.snr_db(_np(g), _np(w)) >= SNR_CARD_DB
    assert launch_counts()["peel_rows_radix2"] == before + 1


def test_k9_wrapper_raises(cuda, monkeypatch):
    x = torch.rand(2, 128, 1024, device=cuda)
    with pytest.raises(TypeError):
        cuda_outer.peel_rows_fused_split(x.double(), x.double())
    with pytest.raises(ValueError):
        cuda_outer.peel_rows_fused_split(x[:, :64], x[:, :64])

    def broken():
        raise RuntimeError("nvcc failed: simulated")

    monkeypatch.setattr(_build, "library", broken)
    with pytest.raises(RuntimeError, match="simulated"):
        cuda_outer.peel_rows_fused_split(x, x)


@pytest.mark.parametrize("shape,inverse", [((4, 1 << 20), False), ((1 << 24,), True)],
                         ids=["4x2^20", "2^24-inverse"])
def test_fused_route_on_card(cuda, shape, inverse):
    from godsp_tpu_torch.fft import large

    x = _crandn(cuda, *shape, seed=shape[-1]).to(torch.complex64)
    op = fft.ifft if inverse else fft.fft
    unfused = op(x)
    reset_launch_counts()
    try:
        large.set_fuse_rows_enabled(True)
        got = op(x)
    finally:
        large.set_fuse_rows_enabled(False)
    heads = 0 if shape[-1] == 1 << 20 else 1
    assert launch_counts()["peel_rows_fused_split"] == 1
    assert launch_counts()["outer_dft_split"] == heads
    assert launch_counts()["fft_pow2"] == launch_counts()["ifft_pow2"] == 0
    want = fft.four_step_fft(x.to(torch.complex128), inverse)
    if inverse:
        want = want / shape[-1]
    assert dsputils.snr_db(_np(got), _np(want)) >= SNR_CARD_DB
    assert dsputils.snr_db(_np(got), _np(unfused)) >= SNR_CARD_DB


def test_dct_family_on_card(cuda):
    rng = np.random.default_rng(11)
    frames = torch.from_numpy(rng.normal(size=(64, 1024)))  # CPU tensors: the float64 references
    img = torch.from_numpy(rng.normal(size=(128, 96)))
    reset_launch_counts()
    y = fft.dct(frames.to(cuda), norm="ortho")
    assert y.dtype == torch.float32 and launch_counts()["fft_pow2"] == 1
    for got, want in ((y, fft.dct(frames, norm="ortho")),
                      (fft.idct(y, norm="ortho"), fft.idct(y.double().cpu(), norm="ortho")),
                      (fft.dst(frames.to(cuda), 4), fft.dst(frames, 4)),
                      (fft.dctn(img.to(cuda), 1), fft.dctn(img, 1))):
        assert dsputils.snr_db(_np(got), _np(want)) >= SNR_CARD_DB


def test_zoom_fft_and_czt_on_card(cuda):
    x = torch.from_numpy(np.random.default_rng(12).normal(size=(2, 40000)))
    reset_launch_counts()
    got = fft.zoom_fft(x.to(cuda), (50.0, 4000.0), 2048, fs=44100.0)
    assert launch_counts()["outer_dft_split"] == 2  # the chirp filter at pad 2^16
    assert got.dtype == torch.complex64
    want = fft.zoom_fft(x, (50.0, 4000.0), 2048, fs=44100.0)
    assert dsputils.snr_db(_np(got), _np(want)) >= SNR_CARD_DB
    w, a = np.exp(-2j * np.pi * 0.2 / 300), np.exp(0.1j)
    gc = fft.czt(x[:, :1000].to(cuda), 300, w, a)
    assert dsputils.snr_db(_np(gc), _np(fft.czt(x[:, :1000], 300, w, a))) >= SNR_CARD_DB


def test_shorttime_fft_and_mfcc_on_card(cuda):
    from godsp_tpu_torch.window.extended import get_window

    rng = np.random.default_rng(13)
    x = torch.from_numpy(np.sin(2 * np.pi * 0.01 * np.arange(200_000))
                         + 0.1 * rng.normal(size=200_000))
    stf = models.ShortTimeFFT(get_window("hann", 1024), 256, 44100.0)
    reset_launch_counts()
    S = stf.stft(x.to(cuda))
    y = stf.istft(S, k1=x.numel())
    assert launch_counts()["fft_pow2"] == 1 and launch_counts()["ifft_pow2"] == 1
    assert launch_counts()["stft_complex"] == 0  # the FFT core, not the STFT kernel
    m = models.mfcc(x.to(cuda), 44100.0, n_mfcc=13, nfft=1024, hop=256)
    assert launch_counts()["stft_mel"] == 1
    assert dsputils.snr_db(_np(S), _np(stf.stft(x))) >= SNR_CARD_DB
    assert dsputils.snr_db(_np(y), _np(x)) >= SNR_CARD_DB
    assert dsputils.snr_db(_np(m), _np(models.mfcc(x, 44100.0, n_mfcc=13, nfft=1024,
                                                    hop=256))) >= SNR_CARD_DB


# ---------------------------------------------------------------- K14a twins


@pytest.mark.parametrize("nfft,hop,pad,S,keep", [(1024, 512, 1024, 2048, 2048),
                                                 (1000, 160, 1024, 3001, 2990)])
def test_pwfloor_twins_on_card(cuda, nfft, hop, pad, S, keep):
    rng = np.random.default_rng(S)
    ext = torch.from_numpy(rng.uniform(-1, 1, size=(2, (S - 1) * hop + nfft))).to(cuda)
    mask = torch.from_numpy((np.arange(S) < keep) * np.ones((2, 1))).to(cuda)
    w = window.window_table("hann", pad, device=cuda)
    frames = torch.from_numpy(rng.uniform(-1, 1, size=(2, S, pad))).to(cuda)
    bt = cuda_pwelch.segs_per_tile(S, 2)
    f32 = [t.float() for t in (ext, mask, w, frames)]
    reset_launch_counts()
    cases = (
        (cuda_probes.pwfloor_loadonly(*f32[:3], nfft, hop, pad),
         cuda_probes.pwfloor_loadonly_plain(ext, mask, w, nfft, hop, pad, bt)),
        (cuda_probes.pwfloor_frameonly(*f32[:3], nfft, hop, pad),
         cuda_probes.pwfloor_frameonly_plain(ext, mask, w, nfft, hop, pad, bt)),
        (cuda_probes.pwfloor_noframe(f32[3], f32[1], f32[2]),
         cuda_probes.pwfloor_noframe_plain(frames, mask, w, bt)),
        (cuda_probes.pwfloor_staged(*f32[:3], nfft, hop, pad),
         cuda_probes.pwfloor_staged_plain(ext, mask, w, nfft, hop, pad, bt)),
    )
    for got, want in cases:
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert dsputils.snr_db(_np(got), _np(want)) >= SNR_CARD_DB
    assert all(launch_counts()[f"pwfloor_{v}"] == 1
               for v in ("loadonly", "frameonly", "noframe", "staged"))
    # K4's frames, transform and sums at K4's tiles: K4's result bit for bit;
    # the first design's are K4's first design's.
    k4 = cuda_pwelch.pwelch_power_partials(*f32[:3], nfft, hop, pad=pad)
    assert torch.equal(cases[3][0], k4)
    assert torch.equal(cuda_probes.pwfloor_staged_radix2(*f32[:3], nfft, hop, pad),
                       cuda_probes.pwelch_radix2(*f32[:3], nfft, hop, pad=pad))


def test_pwfloor_staged_tile_fits_shared_memory(cuda):
    """Both designs refuse a tile whose span does not fit; the redesign
    launches at its cap (staged_max_bt) and equals K4 at that tile."""
    x = torch.randn(1, 200 * 512 + 1024, device=cuda)
    mask = torch.ones(1, 201, device=cuda)
    w = window.window_table("hann", 1024, device=cuda, dtype=torch.float32)
    assert cuda_probes._staged_max_bt(1024, 512, 1024) < 201
    assert cuda_probes.staged_max_bt(1024, 512, 1024) < 201
    with pytest.raises(ValueError):
        cuda_probes.pwfloor_staged(x, mask, w, 1024, 512, bt=201)
    with pytest.raises(ValueError):
        cuda_probes.pwfloor_staged_radix2(x, mask, w, 1024, 512, bt=201)
    cap = cuda_probes.staged_max_bt(1024, 512, 1024)
    want = cuda_probes.pwfloor_staged_plain(x.double(), mask.double(), w.double(), 1024, 512,
                                            1024, cap)
    assert dsputils.snr_db(_np(cuda_probes.pwfloor_staged(x, mask, w, 1024, 512, bt=cap)),
                           _np(want)) >= SNR_CARD_DB


# ---------------------------------------------------- filtering and LTI


def _recording(n, seed=2024):
    """Sines and noise at 44.1 kHz, quantized like PCM16, float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 44100.0
    x = (0.4 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 3150 * t)
         + 0.1 * rng.normal(size=n))
    return (np.round(x * 32767) / 32767).astype(np.float32)


def test_iir_on_card_vs_scipy(cuda):
    import scipy.signal as ss

    x = _recording(1 << 20)
    x64 = x.astype(np.float64)
    sos = models.butter(8, 4000, fs=44100, output="sos")
    b, a = models.butter(4, 1000, fs=44100)
    xt = torch.from_numpy(x).to(cuda)
    for got, want in ((models.sosfilt(sos, xt), ss.sosfilt(sos, x64)),
                      (models.sosfiltfilt(sos, xt), ss.sosfiltfilt(sos, x64)),
                      (models.lfilter(b, a, xt), ss.lfilter(b, a, x64)),
                      (models.decimate(xt, 4), ss.decimate(x64, 4))):
        assert got.is_cuda and got.dtype == torch.float32
        assert dsputils.snr_db(_np(got), want) >= SNR_CARD_DB


def _scaled_butter_ss():
    w0 = 2 * np.pi * 1000.0
    A, B, C, D = models.tf2ss(*models.butter(4, w0, analog=True))
    T = np.diag(w0 ** np.arange(3.0, -1.0, -1.0))
    Ti = np.linalg.inv(T)
    return Ti @ A @ T, Ti @ B, C @ T, D


def test_lsim_dlsim_on_card_vs_scipy(cuda):
    import scipy.signal as ss

    sysc = _scaled_butter_ss()
    u = _recording(44100).astype(np.float64)
    t = np.arange(u.size) / 44100.0
    got = models.lsim(sysc, u, t)[1]
    assert dsputils.snr_db(got, ss.lsim(sysc, u, t)[1]) >= SNR_CARD_DB
    sysd = models.cont2discrete(sysc, 1 / 44100.0, "zoh")
    got = models.dlsim(sysd, u)[1]
    assert dsputils.snr_db(got, ss.dlsim(sysd, u)[1]) >= SNR_CARD_DB


def test_scans_keep_tf32_off(cuda):
    """TF32 on globally must not reach the IIR or LTI matmuls; the flags
    come back as the caller set them."""
    import scipy.signal as ss

    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        x = _recording(1 << 18)
        b, a = models.butter(4, 1000, fs=44100)
        got = models.lfilter(b, a, torch.from_numpy(x).to(cuda))
        assert dsputils.snr_db(_np(got), ss.lfilter(b, a, x.astype(np.float64))) >= SNR_CARD_DB
        sysc = _scaled_butter_ss()
        u = x[:20000].astype(np.float64)
        t = np.arange(u.size) / 44100.0
        assert dsputils.snr_db(models.lsim(sysc, u, t)[1], ss.lsim(sysc, u, t)[1]) >= SNR_CARD_DB
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def test_fir_and_resampling_on_card_vs_scipy(cuda):
    import scipy.signal as ss

    x = _recording(300_000)
    x64 = x.astype(np.float64)
    xt = torch.from_numpy(x).to(cuda)
    taps = models.firwin(255, 4000 / 22050)
    reset_launch_counts()
    y = models.fir_filter(xt, taps)  # pad 2^19: the large plan
    assert launch_counts()["outer_dft_split"] == 3
    full = ss.oaconvolve(x64, taps)
    for got, want in ((y, full[: x.size]),
                      (models.fftconvolve(xt, taps, mode="same"), full[127 : 127 + x.size]),
                      (models.overlap_save(xt, taps), full[: x.size]),
                      (models.resample_poly(xt[:44100], 160, 441),
                       ss.resample_poly(x64[:44100], 160, 441)),
                      (models.upfirdn(taps, xt[:5000], 3, 2), ss.upfirdn(taps, x64[:5000], 3, 2))):
        assert got.is_cuda and got.dtype == torch.float32
        assert dsputils.snr_db(_np(got), want) >= SNR_CARD_DB


def _lane_planes(cuda, b, n, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn(b, n, generator=g, device=cuda), torch.randn(b, n, generator=g, device=cuda)


def _c(planes):
    return _np(planes[0]).astype(np.float64) + 1j * _np(planes[1])


@pytest.mark.parametrize("b,n", [(16384, 1024), (1001, 2048)])
def test_k14b_k14c_on_card(cuda, b, n):
    """fac_dft and gmm_concat against the float64 plain version (>= 120 dB;
    gmm_concat equal to K13), the store twins equal to their input."""
    xr, xi = _lane_planes(cuda, b, n, b + n)
    want = _c(cuda_metrics.gmm_floor_plain(xr.double(), xi.double()))
    reset_launch_counts()
    fac = cuda_probes.fac_dft(xr, xi)
    gc = cuda_probes.gmm_concat(xr, xi)
    assert dsputils.snr_db(_c(fac), want) >= SNR_CARD_DB
    assert dsputils.snr_db(_c(fac), _c(cuda_probes.fac_dft_plain(xr.double(), xi.double()))) \
        >= SNR_CARD_DB
    assert dsputils.snr_db(_c(gc), want) >= SNR_CARD_DB
    k13 = cuda_metrics.gmm_floor(xr, xi)
    assert torch.equal(gc[0], k13[0]) and torch.equal(gc[1], k13[1])
    for name in ("slicestore", "concatstore"):
        got = getattr(cuda_probes, name)(xr, xi)
        assert torch.equal(got[0], xr) and torch.equal(got[1], xi)
    counts = launch_counts()
    assert all(counts[k] == 1 for k in ("fac_dft", "gmm_concat", "slicestore", "concatstore"))


def test_lane_wrappers_raise_on_card(cuda):
    for name in ("fac_dft", "slicestore", "concatstore", "gmm_concat"):
        fn = getattr(cuda_probes, name)
        with pytest.raises(TypeError):
            fn(torch.zeros(4, 256, dtype=torch.float64, device=cuda),
               torch.zeros(4, 256, dtype=torch.float64, device=cuda))
        with pytest.raises(ValueError):
            fn(torch.zeros(4, 200, device=cuda), torch.zeros(4, 200, device=cuda))
        with pytest.raises(ValueError):
            fn(torch.zeros(4, 256, device=cuda), torch.zeros(4, 256))


_K14D = ("half3", "slice8_add", "reshape_add", "bd_tf32", "bd_hi", "anat_full")


def _tf32_flags():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("b,n", [(16384, 1024), (1001, 2048)])
def test_k14d_on_card(cuda, b, n):
    """half3, slice8_add and reshape_add equal to their float32 plain
    versions; bd_hi and anat_full >= 120 dB against float64; bd_tf32 >= 120
    dB against its plain version with TF32-rounded operands summed in
    float64 (and far below that against the exact product); one launch a
    call; the TF32 flags untouched."""
    xr, xi = _lane_planes(cuda, b, n, b + n)
    tw = torch.randn(n, generator=torch.Generator(device=cuda).manual_seed(n), device=cuda)
    x64 = (xr.double(), xi.double())
    flags = _tf32_flags()
    reset_launch_counts()
    for name, plain in (("half3", cuda_probes.half3_plain), ("slice8_add", cuda_probes.add_one_plain),
                        ("reshape_add", cuda_probes.add_one_plain)):
        got, want = getattr(cuda_probes, name)(xr, xi), plain(xr, xi)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), name
    bd1 = cuda_probes.bd_tf32(xr, xi)
    assert dsputils.snr_db(_c(bd1), _c(cuda_probes.bd_tf32_plain(*x64, tf32=True))) \
        >= SNR_CARD_DB
    assert dsputils.snr_db(_c(bd1), _c(cuda_probes.bd_tf32_plain(*x64))) < 100.0
    assert dsputils.snr_db(_c(cuda_probes.bd_hi(xr, xi)), _c(cuda_probes.bd_hi_plain(*x64))) \
        >= SNR_CARD_DB
    assert dsputils.snr_db(_c(cuda_probes.anat_full(xr, xi, tw)),
                           _c(cuda_probes.anat_full_plain(*x64, tw))) >= SNR_CARD_DB
    counts = launch_counts()
    assert all(counts[k] == 1 for k in _K14D)
    assert _tf32_flags() == flags


@pytest.mark.parametrize("b,n", [(16384, 1024), (1001, 384), (1001, 1152), (13, 1024),
                                 (1, 128), (524289, 128)])
def test_slice8_add_redesign_on_card(cuda, b, n):
    """slice8_add (every slice's loads first) and its first design
    slice8_add_sync torch.equal to add_one_plain, one launch each: at the
    probe's shape, at fewer slices than a chunk (384), a ragged chunk
    (1152), rows that are not a multiple of a block's eight and more row
    tiles than grid.y's 65535 blocks."""
    xr, xi = _lane_planes(cuda, b, n, b + n)
    want = cuda_probes.add_one_plain(xr, xi)
    for name in ("slice8_add", "slice8_add_sync"):
        reset_launch_counts()
        got = getattr(cuda_probes, name)(xr, xi)
        assert launch_counts()[name] == 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), name
    with pytest.raises(TypeError):
        cuda_probes.slice8_add(xr.double(), xi.double())


@pytest.mark.parametrize("b", [1001, 16])
def test_bd_tf32_fragment_maps_on_card(cuda, b):
    """The identity table returns round_tf32(x) exactly (the A and C maps);
    a cyclic shift, P[j, j + 1 mod 128] = 1, returns each slice rolled by
    one (the B map: Re F128 is symmetric and would not show a transposed B)."""
    xr, xi = _lane_planes(cuda, b, 1024, b)
    eye = torch.eye(128, device=cuda)
    got = cuda_probes.bd_tf32(xr, xi, eye)
    for g, x in zip(got, (xr, xi)):
        assert torch.equal(g, cuda_probes.round_tf32(x))
    got = cuda_probes.bd_tf32(xr, xi, torch.roll(eye, 1, dims=1))
    for g, x in zip(got, (xr, xi)):
        want = torch.roll(cuda_probes.round_tf32(x).view(b, 8, 128), 1, dims=2).reshape(b, 1024)
        assert torch.equal(g, want)


@pytest.mark.parametrize("flags", [(False, False), (True, True)])
def test_k14d_and_its_yardstick_leave_tf32_flags(cuda, flags):
    from godsp_tpu_torch.probes import anatomy2

    old = _tf32_flags()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    try:
        xr, xi = _lane_planes(cuda, 64, 1024, 3)
        tw = anatomy2.tw_row(cuda)
        for name in _K14D:
            getattr(cuda_probes, name)(xr, xi, *((tw,) if name == "anat_full" else ()))
            assert _tf32_flags() == flags, name
        ops = anatomy2.ops(xr, xi, tw)
        for name, (op, lib) in ops.items():
            op()
            if lib is not None:
                lib()
            assert _tf32_flags() == flags, name
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def test_k14d_wrappers_raise_on_card(cuda):
    for name in _K14D:
        fn = getattr(cuda_probes, name)
        extra = lambda n, dt=torch.float32: (  # noqa: E731
            (torch.zeros(n, dtype=dt, device=cuda),) if name == "anat_full" else ())
        with pytest.raises(TypeError):
            fn(torch.zeros(4, 256, dtype=torch.float64, device=cuda),
               torch.zeros(4, 256, dtype=torch.float64, device=cuda), *extra(256))
        with pytest.raises(ValueError):
            fn(torch.zeros(4, 200, device=cuda), torch.zeros(4, 200, device=cuda), *extra(200))
        with pytest.raises(ValueError):
            fn(torch.zeros(4, 256, device=cuda), torch.zeros(4, 256), *extra(256))
    with pytest.raises(TypeError):
        cuda_probes.anat_full(torch.zeros(4, 256, device=cuda), torch.zeros(4, 256, device=cuda),
                              torch.zeros(256, dtype=torch.float64, device=cuda))
    with pytest.raises(TypeError):
        cuda_probes.bd_tf32(torch.zeros(4, 256, device=cuda), torch.zeros(4, 256, device=cuda),
                            torch.eye(128, dtype=torch.float64, device=cuda))


def _chip_smoke():
    """chip_smoke.py, loaded by path (for wiener_bound_db)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_tests", pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _toolkit_image(n1=256, n2=192):
    rng = np.random.default_rng(13)
    yy, xx = np.meshgrid(np.arange(n1), np.arange(n2), indexing="ij")
    return (np.sin(2 * np.pi * xx / 37.0) * np.cos(2 * np.pi * yy / 23.0)
            + 0.1 * rng.normal(size=(n1, n2))).astype(np.float32)


def test_toolkit_on_card_vs_scipy(cuda):
    """convolve2d, wiener, cwt, savgol_filter and cspline2d on the card
    against scipy (or the port's float64 CPU route, for cspline2d) in
    float64, >= 120 dB; wiener at its derived float32 bound."""
    import scipy.signal as ss

    im = _toolkit_image()
    im64 = im.astype(np.float64)
    imt = torch.from_numpy(im).to(cuda)
    k = np.outer(np.hanning(11), np.hanning(9))
    reset_launch_counts()
    for mode, boundary in (("same", "fill"), ("valid", "fill"), ("full", "symm"),
                           ("same", "wrap")):
        got = models.convolve2d(imt, k, mode=mode, boundary=boundary)
        assert got.is_cuda and got.dtype == torch.float32
        want = ss.convolve2d(im64, k, mode=mode, boundary=boundary)
        assert dsputils.snr_db(_np(got), want) >= SNR_CARD_DB
        got = models.correlate2d(imt, k, mode=mode, boundary=boundary)
        want = ss.correlate2d(im64, k, mode=mode, boundary=boundary)
        assert dsputils.snr_db(_np(got), want) >= SNR_CARD_DB
    assert launch_counts()["fft_pow2"] == 32 and launch_counts()["ifft_pow2"] == 16
    bound = _chip_smoke().wiener_bound_db(im64, 5, 512 * 256)
    assert dsputils.snr_db(_np(models.wiener(imt, 5)), ss.wiener(im64, 5)) >= bound
    x = _recording(50_000)
    x64 = x.astype(np.float64)
    xt = torch.from_numpy(x).to(cuda)
    for mode in ("interp", "mirror", "nearest", "wrap"):
        got = models.savgol_filter(xt, 101, 3, mode=mode)
        assert dsputils.snr_db(_np(got), ss.savgol_filter(x64, 101, 3, mode=mode)) >= SNR_CARD_DB
    widths = np.arange(1, 17)
    got = models.cwt(xt[:8192], models.ricker, widths)
    want = np.stack([np.convolve(x64[:8192], models.ricker(10 * w, w)[::-1], "same")
                     for w in widths])
    assert dsputils.snr_db(_np(got), want) >= SNR_CARD_DB
    want = models.cspline2d(torch.from_numpy(im64))  # the float64 route on the CPU
    assert dsputils.snr_db(_np(models.cspline2d(imt)), _np(want)) >= SNR_CARD_DB
    assert np.array_equal(_np(models.medfilt2d(imt, 5)), ss.medfilt2d(im, 5))


def test_toolkit_keeps_tf32_off(cuda):
    """TF32 on globally must not reach savgol_filter's edge einsums nor the
    2-D convolution; the flags come back as the caller set them."""
    import scipy.signal as ss

    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        x = _recording(1 << 16)
        got = models.savgol_filter(torch.from_numpy(x).to(cuda), 51, 4)
        want = ss.savgol_filter(x.astype(np.float64), 51, 4)
        assert dsputils.snr_db(_np(got), want) >= SNR_CARD_DB
        im = _toolkit_image()
        k = np.outer(np.hanning(7), np.hanning(7))
        got = models.convolve2d(torch.from_numpy(im).to(cuda), k, "same", boundary="symm")
        want = ss.convolve2d(im.astype(np.float64), k, "same", boundary="symm")
        assert dsputils.snr_db(_np(got), want) >= SNR_CARD_DB
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


@pytest.mark.parametrize("b,n", [(16384, 1024), (1001, 512), (9, 256), (5, 128)])
def test_k14h_vdif_on_card(cuda, b, n):
    """vdif >= 120 dB against its float64 plain version and against the
    float64 FFT in vdif digit order, one launch a call; its digit order
    exact (a single exponential at bin k peaks at (k mod n1) 128 +
    brev7(k // n1))."""
    from godsp_tpu_torch.probes import vdif

    xr, xi = _lane_planes(cuda, b, n, b + n)
    s = n ** -0.5
    reset_launch_counts()
    got = _c(cuda_probes.vdif(xr, xi, s))
    assert launch_counts()["vdif"] == 1
    assert dsputils.snr_db(got, _c(cuda_probes.vdif_plain(xr.double(), xi.double(), s))) \
        >= SNR_CARD_DB
    fft = torch.fft.fft(torch.complex(xr.double(), xi.double())) * s
    assert dsputils.snr_db(got, _np(cuda_probes.vdif_digit_order(fft, n // 128))) >= SNR_CARD_DB
    assert vdif.digit_order_exact(cuda, n, s)
    assert launch_counts()["vdif"] == 2


@pytest.mark.parametrize("shape", [(1, 128, 131072), (3, 128, 1000), (128, 1), (2, 2, 128, 33)])
def test_k14i_sdif_peel_on_card(cuda, shape):
    """sdif_peel >= 120 dB against its float64 plain version and against
    K8's peel with the rows mapped by brev7, one launch a call."""
    g = torch.Generator(device=cuda).manual_seed(shape[-1])
    xr, xi = (torch.randn(shape, generator=g, device=cuda) for _ in range(2))
    reset_launch_counts()
    got = cuda_probes.sdif_peel(xr, xi)
    assert launch_counts()["sdif_peel"] == 1 and got[0].shape == shape
    assert dsputils.snr_db(_c(got), _c(cuda_probes.sdif_peel_plain(xr.double(), xi.double()))) \
        >= SNR_CARD_DB
    d = cuda_outer.outer_dft_split(xr, xi, 128, 1)
    perm = cuda_probes.brev7_perm().to(cuda)
    assert dsputils.snr_db(_c(got), _c((d[0][..., perm, :], d[1][..., perm, :]))) >= SNR_CARD_DB


def test_k14h_k14i_batches_past_grid_y(cuda):
    """More rows than grid.y's 65535 blocks (eight rows a vdif block; one
    sdif batch element a grid row) reach the kernels."""
    xr, xi = _lane_planes(cuda, 8 * 65535 + 9, 128, 7)
    got = cuda_probes.vdif(xr, xi)
    assert dsputils.snr_db(_c(got), _c(cuda_probes.vdif_plain(xr.double(), xi.double()))) \
        >= SNR_CARD_DB
    xr, xi = (p.view(65537, 128, 1) for p in _lane_planes(cuda, 65537 * 128, 1, 8))
    got = cuda_probes.sdif_peel(xr, xi)
    assert dsputils.snr_db(_c(got), _c(cuda_probes.sdif_peel_plain(xr.double(), xi.double()))) \
        >= SNR_CARD_DB


def test_k14h_k14i_wrappers_raise_on_card(cuda):
    f64 = dict(dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        cuda_probes.vdif(torch.zeros(4, 256, **f64), torch.zeros(4, 256, **f64))
    with pytest.raises(TypeError):
        cuda_probes.sdif_peel(torch.zeros(128, 8, **f64), torch.zeros(128, 8, **f64))
    for n in (200, 640, 2048):
        with pytest.raises(ValueError):
            cuda_probes.vdif(torch.zeros(4, n, device=cuda), torch.zeros(4, n, device=cuda))
    with pytest.raises(ValueError):
        cuda_probes.sdif_peel(torch.zeros(64, 8, device=cuda), torch.zeros(64, 8, device=cuda))
    with pytest.raises(ValueError):
        cuda_probes.vdif(torch.zeros(4, 256, device=cuda), torch.zeros(4, 256))
    with pytest.raises(ValueError):
        cuda_probes.sdif_peel(torch.zeros(128, 8, device=cuda), torch.zeros(128, 8))


_K14F = ("ls_network", "gmm_tf32", "ls_full")
_LS_SETTINGS = ({"store": "rows"}, {"chunks": 2}, {"chunks": 4}, {"chunks": 8},
                {"rows_per_block": 32}, {"rows_per_block": 64},
                {"store": "rows", "chunks": 8, "rows_per_block": 64})


@pytest.mark.parametrize("b,n", [(16384, 1024), (1001, 1024), (1001, 512), (33, 256), (5, 128)])
def test_k14f_on_card(cuda, b, n):
    """ls_network and ls_full >= 120 dB against float64 (ls_full also
    against the float64 FFT in the lane-slice digit order); every ls_full
    setting torch.equal to the default, and the default equal to 128 x
    gmm_concat of ls_network's output (one fmaf chain); gmm_tf32 >= 120 dB
    against its TF32-rounded float64 plain version (its dB against the exact
    product printed, ~68: one TF32 pass); one launch a call; the TF32 flags
    untouched."""
    xr, xi = _lane_planes(cuda, b, n, b + n)
    x64 = (xr.double(), xi.double())
    flags = _tf32_flags()
    reset_launch_counts()
    net = cuda_probes.ls_network(xr, xi)
    assert dsputils.snr_db(_c(net), _c(cuda_probes.ls_network_plain(*x64))) >= SNR_CARD_DB
    g = cuda_probes.gmm_tf32(xr, xi)
    assert dsputils.snr_db(_c(g), _c(cuda_probes.gmm_tf32_plain(*x64, tf32=True))) >= SNR_CARD_DB
    exact = dsputils.snr_db(_c(g), _c(cuda_probes.gmm_tf32_plain(*x64)))
    print(f"gmm_tf32 {b} x {n}: {exact:.2f} dB against the exact product")
    assert 50.0 < exact < 100.0
    full = cuda_probes.ls_full(xr, xi)
    assert dsputils.snr_db(_c(full), _c(cuda_probes.ls_full_plain(*x64))) >= SNR_CARD_DB
    fft = cuda_probes.ls_digit_order(torch.fft.fft(torch.complex(*x64)), n // 128)
    assert dsputils.snr_db(_c(full), _np(fft)) >= SNR_CARD_DB
    assert launch_counts()["ls_full"] == 1
    for kw in _LS_SETTINGS:
        got = cuda_probes.ls_full(xr, xi, **kw)
        assert torch.equal(got[0], full[0]) and torch.equal(got[1], full[1]), kw
    gc = cuda_probes.gmm_concat(*net)
    assert torch.equal(full[0], gc[0] * 128) and torch.equal(full[1], gc[1] * 128)
    counts = launch_counts()
    assert counts["ls_network"] == 1 and counts["gmm_tf32"] == 1
    assert counts["ls_full"] == 1 + len(_LS_SETTINGS)
    assert _tf32_flags() == flags


@pytest.mark.parametrize("b", [1001, 16])
def test_gmm_tf32_fragment_maps_on_card(cuda, b):
    """With every table plane the identity, gmm_tf32 returns round_tf32(a)
    - round_tf32(b) and round_tf32(a + b) - round_tf32(a) - round_tf32(b)
    exactly (the A and C maps); with a cyclic shift P[j, j + 1 mod 128] = 1
    the same of the slices rolled by one (the B map)."""
    xr, xi = _lane_planes(cuda, b, 1024, b)
    eye = torch.eye(128, device=cuda)
    rt = cuda_probes.round_tf32
    for roll in (0, 1):
        table = torch.roll(eye, roll, dims=1).expand(8, 3, 128, 128).contiguous()
        yr, yi = cuda_probes.gmm_tf32(xr, xi, table)
        a, c, s = (torch.roll(rt(v).view(b, 8, 128), roll, dims=2).reshape(b, 1024)
                   for v in (xr, xi, xr + xi))
        assert torch.equal(yr, a - c) and torch.equal(yi, s - a - c), roll


def test_k14e_lane_flip_on_card(cuda):
    """Exact: the TPU probe's (8, 128) input (rows 0..127) gives 2 x its
    reversal; random planes viewed as (rows, 128) equal the plain version,
    at the probe's 16384 x 1024 and at ragged row counts."""
    from godsp_tpu_torch.probes import r4

    reset_launch_counts()
    got = cuda_probes.lane_flip(r4.flip_input(cuda))
    assert torch.equal(got, 2 * torch.arange(127, -1, -1, dtype=torch.float32,
                                              device=cuda).repeat(8, 1))
    for b, n in ((16384, 1024), (1001, 128), (7, 384)):
        x = _lane_planes(cuda, b, n, b)[0].view(-1, 128)
        assert torch.equal(cuda_probes.lane_flip(x), cuda_probes.lane_flip_plain(x))
    assert launch_counts()["lane_flip"] == 4


@pytest.mark.parametrize("b,n", [(16384, 1024), (4096, 4096), (2048, 8192), (1024, 16384),
                                 (1001, 1024), (3, 256)])
def test_fft_pow2_rows_on_card(cuda, b, n):
    """Every rows-a-block setting that fits gives K1's result bit for bit,
    >= 120 dB against K1's float64 plain version; one that does not raises
    before the launch."""
    xr, xi = _lane_planes(cuda, b, n, n)
    k1 = cuda_fft.fft_pow2(xr, xi)
    want = _c(cuda_fft.fft_pow2_plain(xr.double(), xi.double()))
    reset_launch_counts()
    fits = [r for r in (1, 2, 4, 8, 16, 28) if cuda_probes.fft_rows_fit(n, r)]
    for r in fits:
        got = cuda_probes.fft_pow2_rows(xr, xi, r)
        assert torch.equal(got[0], k1[0]) and torch.equal(got[1], k1[1]), r
        assert dsputils.snr_db(_c(got), want) >= SNR_CARD_DB, r
    assert launch_counts()["fft_pow2_rows"] == len(fits)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_probes.fft_pow2_rows(xr, xi, 232448 // (8 * n) + 1)
    assert launch_counts()["fft_pow2_rows"] == len(fits)


def test_k14e_k14f_batches_past_grid_y(cuda):
    """More blocks than grid.y's 65535 (eight rows an ls_network block,
    sixteen an ls_full block at n = 128) reach the kernels."""
    xr, xi = _lane_planes(cuda, 8 * 65535 + 9, 128, 9)
    got = cuda_probes.ls_network(xr, xi)
    assert dsputils.snr_db(_c(got), _c(cuda_probes.ls_network_plain(xr.double(), xi.double()))) \
        >= SNR_CARD_DB
    xr, xi = _lane_planes(cuda, 16 * 65535 + 17, 128, 10)
    got = cuda_probes.ls_full(xr, xi)
    assert dsputils.snr_db(_c(got), _c(cuda_probes.ls_full_plain(xr.double(), xi.double()))) \
        >= SNR_CARD_DB
    other = cuda_probes.ls_full(xr, xi, store="rows", chunks=2)
    assert torch.equal(other[0], got[0]) and torch.equal(other[1], got[1])


@pytest.mark.parametrize("flags", [(False, False), (True, True)])
def test_k14e_k14f_and_their_yardsticks_leave_tf32_flags(cuda, flags):
    from godsp_tpu_torch.probes import r3, r4

    old = _tf32_flags()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    try:
        xr, xi = _lane_planes(cuda, 64, 1024, 3)
        for name in _K14F:
            getattr(cuda_probes, name)(xr, xi)
            assert _tf32_flags() == flags, name
        cuda_probes.lane_flip(xr.view(-1, 128))
        for ops in (r3.ops(xr, xi), r4.ops(xr, xi)):
            for name, (op, lib) in ops.items():
                op()
                if lib is not None:
                    lib()
                assert _tf32_flags() == flags, name
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def test_k14e_k14f_wrappers_raise_on_card(cuda):
    f64 = dict(dtype=torch.float64, device=cuda)
    for name in _K14F:
        fn = getattr(cuda_probes, name)
        with pytest.raises(TypeError):
            fn(torch.zeros(4, 256, **f64), torch.zeros(4, 256, **f64))
        with pytest.raises(ValueError):
            fn(torch.zeros(4, 200, device=cuda), torch.zeros(4, 200, device=cuda))
        with pytest.raises(ValueError):
            fn(torch.zeros(4, 256, device=cuda), torch.zeros(4, 256))
    for n in (384, 2048):
        with pytest.raises(ValueError):
            cuda_probes.ls_full(torch.zeros(4, n, device=cuda), torch.zeros(4, n, device=cuda))
    with pytest.raises(TypeError):
        cuda_probes.gmm_tf32(torch.zeros(4, 256, device=cuda), torch.zeros(4, 256, device=cuda),
                             torch.zeros(2, 3, 128, 128, **f64))
    with pytest.raises(TypeError):
        cuda_probes.lane_flip(torch.zeros(4, 128, **f64))
    with pytest.raises(TypeError):
        cuda_probes.fft_pow2_rows(torch.zeros(4, 256, **f64), torch.zeros(4, 256, **f64), 1)


# ---------------------------------------------------------------------------
# K14g: the int8-limb contraction twins
# ---------------------------------------------------------------------------

_K14G = ("i8mm", "i8dec", "i8full", "i8_concat")


@pytest.mark.parametrize("m,k,n", [(256, 128, 128), (1001, 128, 384), (33, 100, 70), (5, 7, 3)])
def test_k14g_i8_dot_on_card(cuda, m, k, n):
    """i8_dot torch.equal to the exact int32 product, ragged m, k and n
    included; one launch a call."""
    rng = np.random.default_rng(m + k + n)
    a = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
    b = rng.integers(-128, 128, size=(k, n)).astype(np.int8)
    reset_launch_counts()
    got = cuda_probes.i8_dot(torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda))
    want = a.astype(np.int64) @ b.astype(np.int64)
    assert got.dtype == torch.int32 and np.array_equal(_np(got), want)
    assert launch_counts()["i8_dot"] == 1


@pytest.mark.parametrize("b,n", [(16384, 1024), (1001, 1024), (1001, 512), (33, 256), (5, 128)])
def test_k14g_on_card(cuda, b, n):
    """i8mm, i8dec, i8full and i8_concat torch.equal to their plain versions
    on the card (the same integer and float32 arithmetic in the same order),
    i8full equal to i8_concat; i8full's dB against the float64 exact product
    printed and > 100 (the scheme keeps ~120); one launch a call."""
    xr, xi = (v * 0.01 for v in _lane_planes(cuda, b, n, b + n))
    reset_launch_counts()
    got = {name: getattr(cuda_probes, name)(xr, xi) for name in _K14G}
    for name, plain in (("i8mm", cuda_probes.i8mm_plain), ("i8dec", cuda_probes.i8dec_plain),
                        ("i8full", cuda_probes.i8full_plain),
                        ("i8_concat", cuda_probes.i8full_plain)):
        want = plain(xr, xi)
        assert torch.equal(got[name][0], want[0]) and torch.equal(got[name][1], want[1]), name
    assert torch.equal(got["i8full"][0], got["i8_concat"][0])
    assert torch.equal(got["i8full"][1], got["i8_concat"][1])
    db = dsputils.snr_db(_c(got["i8full"]),
                         _c(cuda_probes.gmm_tf32_plain(xr.double(), xi.double())))
    print(f"i8full {b} x {n}: {db:.2f} dB against the float64 product")
    assert db > 100.0
    assert all(launch_counts()[name] == 1 for name in _K14G)


@pytest.mark.parametrize("b", [1001, 16])
def test_k14g_fragment_maps_on_card(cuda, b):
    """On identity and cyclic-shift digit tables i8mm gives 3 x the rolled
    sum of its quantized planes times 1e-5 and i8dec its plain version,
    exactly (the int8 mma's A, B and C maps)."""
    from godsp_tpu_torch.probes import int8

    xr, xi = (v * 0.01 for v in _lane_planes(cuda, b, 1024, b))
    assert int8.fragment_maps(xr, xi) == {"identity": True, "cyclic_shift": True}


def test_k14g_batches_past_grid_y(cuda):
    """i8_concat's one block a 16-row tile passes grid.y's 65535 blocks; its
    result equals i8full's, and the last rows their plain version's."""
    xr, xi = (v * 0.01 for v in _lane_planes(cuda, 16 * 65535 + 17, 128, 11))
    full = cuda_probes.i8full(xr, xi)
    rows = cuda_probes.i8_concat(xr, xi)
    assert torch.equal(full[0], rows[0]) and torch.equal(full[1], rows[1])
    tail = cuda_probes.i8full_plain(xr[-40:].contiguous(), xi[-40:].contiguous())
    assert torch.equal(full[0][-40:], tail[0]) and torch.equal(full[1][-40:], tail[1])


@pytest.mark.parametrize("flags", [(False, False), (True, True)])
def test_k14g_and_its_yardsticks_leave_tf32_flags(cuda, flags):
    from godsp_tpu_torch.probes import int8

    old = _tf32_flags()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    try:
        xr, xi = (v * 0.01 for v in _lane_planes(cuda, 64, 1024, 4))
        a, b = int8.dot_inputs(cuda, 256, 128, 128)
        cuda_probes.i8_dot(a, b)
        torch._int_mm(a, b)
        assert _tf32_flags() == flags
        for name, (op, lib) in int8.ops(xr, xi).items():
            op()
            if lib is not None:
                lib()
            assert _tf32_flags() == flags, name
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def test_k14g_wrappers_raise_on_card(cuda):
    f64 = dict(dtype=torch.float64, device=cuda)
    for name in _K14G:
        fn = getattr(cuda_probes, name)
        with pytest.raises(TypeError):
            fn(torch.zeros(4, 256, **f64), torch.zeros(4, 256, **f64))
        for n in (200, 2048):
            with pytest.raises(ValueError):
                fn(torch.zeros(4, n, device=cuda), torch.zeros(4, n, device=cuda))
        with pytest.raises(ValueError):
            fn(torch.zeros(4, 256, device=cuda), torch.zeros(4, 256))
    floats = [torch.zeros(2, 128, c, device=cuda) for c in (384, 256, 128)]
    for name in ("i8mm", "i8dec"):
        with pytest.raises(TypeError):
            getattr(cuda_probes, name)(torch.zeros(4, 256, device=cuda),
                                       torch.zeros(4, 256, device=cuda), floats)
    i8 = dict(dtype=torch.int8, device=cuda)
    with pytest.raises(TypeError):
        cuda_probes.i8_dot(torch.zeros(4, 8, device=cuda), torch.zeros(8, 4, **i8))
    with pytest.raises(ValueError):
        cuda_probes.i8_dot(torch.zeros(4, 8, **i8), torch.zeros(7, 4, **i8))
    with pytest.raises(ValueError):
        cuda_probes.i8_dot(torch.zeros(4, 8, **i8), torch.zeros(8, 4, dtype=torch.int8))


# ------------------------------------------------- K14c/K14f on thread-block clusters

_LANE_SETTINGS = (("gmm_concat", 16, 16, 0), ("ls_full", 16, 16, 0), ("ls_full", 16, 16, 1),
                  ("ls_full", 64, 2, 1), ("ls_full", 32, 4, 0))


def test_lane_cluster_geometry_matches_the_host_plan(cuda):
    """gdsp_lane_cluster_geometry (the cluster kernels' own plan, from the
    resident clusters the card reports) equals ops/cuda_probes.py's
    lane_cluster_plan at every n the kernels take and every ls_full setting
    kind."""
    import ctypes

    lib, out = _build.library(), (ctypes.c_int * 10)()
    for kind, rows_per_block, chunk_rows, store_rows in _LANE_SETTINGS:
        ns = (128, 256, 384, 1024, 1152, 2048) if kind == "gmm_concat" else (128, 256, 512, 1024)
        for n in ns:
            resident = cuda_probes._cluster_resident(kind, n, cuda)
            print(f"{kind} n {n}: {resident} clusters resident")
            assert resident >= 1
            for b in (1, 15, 17, 1001, 16384):
                rc = lib.gdsp_lane_cluster_geometry(cuda_probes.LANE_KINDS.index(kind), b, n,
                                                    rows_per_block, chunk_rows, store_rows,
                                                    resident, out)
                plan = cuda_probes.lane_cluster_plan(kind, b, n, rows_per_block, chunk_rows,
                                                     store_rows, resident)
                assert rc == 0 and tuple(out) == tuple(plan), (kind, b, n)


@pytest.mark.parametrize("n1", [1, 2, 4, 8])
@pytest.mark.parametrize("b", [1, 15, 17, 1001])
def test_lane_clusters_on_ragged_tiles(cuda, b, n1):
    """Ragged row tiles: gmm_concat equal to K13, every ls_full setting
    equal to the default, and the default equal to 128 x gmm_concat of
    ls_network's output, >= 120 dB against float64."""
    from godsp_tpu_torch.probes import r3

    n = 128 * n1
    xr, xi = _lane_planes(cuda, b, n, 7 * b + n1)
    gc = cuda_probes.gmm_concat(xr, xi)
    k13 = cuda_metrics.gmm_floor(xr, xi)
    assert torch.equal(gc[0], k13[0]) and torch.equal(gc[1], k13[1])
    full = cuda_probes.ls_full(xr, xi)
    assert dsputils.snr_db(_c(full), _c(cuda_probes.ls_full_plain(xr.double(), xi.double()))) \
        >= SNR_CARD_DB
    for name, kw in r3.FULL_SETTINGS.items():
        got = cuda_probes.ls_full(xr, xi, **kw)
        assert torch.equal(got[0], full[0]) and torch.equal(got[1], full[1]), name
    net = cuda_probes.gmm_concat(*cuda_probes.ls_network(xr, xi))
    assert torch.equal(full[0], net[0] * 128) and torch.equal(full[1], net[1] * 128)


@pytest.mark.parametrize("b,n", [(1001, 2048), (33, 1152), (17, 384)])
def test_gmm_concat_clusters_over_column_chunks(cuda, b, n):
    """Rows of more than one 1024-column chunk (two clusters' chunks at
    2048, a ragged one-slice chunk at 1152) and a cluster of three at 384:
    equal to K13."""
    xr, xi = _lane_planes(cuda, b, n, n)
    gc = cuda_probes.gmm_concat(xr, xi)
    k13 = cuda_metrics.gmm_floor(xr, xi)
    assert torch.equal(gc[0], k13[0]) and torch.equal(gc[1], k13[1])


@pytest.mark.parametrize("b,n", [(16384, 1024), (1001, 512)])
def test_lane_yardsticks_on_card(cuda, b, n):
    """The first designs, gmm_concat_stream and ls_full_stream (G streamed
    a tile), >= 120 dB against float64 and equal to the cluster kernels at
    every ls_full setting; one launch a call."""
    from godsp_tpu_torch.probes import r3

    xr, xi = _lane_planes(cuda, b, n, b)
    x64 = (xr.double(), xi.double())
    reset_launch_counts()
    gs = cuda_probes.gmm_concat_stream(xr, xi)
    assert dsputils.snr_db(_c(gs), _c(cuda_metrics.gmm_floor_plain(*x64))) >= SNR_CARD_DB
    gc = cuda_probes.gmm_concat(xr, xi)
    assert torch.equal(gs[0], gc[0]) and torch.equal(gs[1], gc[1])
    for name, kw in r3.FULL_SETTINGS.items():
        st = cuda_probes.ls_full_stream(xr, xi, **kw)
        assert dsputils.snr_db(_c(st), _c(cuda_probes.ls_full_plain(*x64))) >= SNR_CARD_DB
        got = cuda_probes.ls_full(xr, xi, **kw)
        assert torch.equal(st[0], got[0]) and torch.equal(st[1], got[1]), name
    counts = launch_counts()
    assert counts["gmm_concat_stream"] == 1 and counts["gmm_concat"] == 1
    assert counts["ls_full_stream"] == counts["ls_full"] == len(r3.FULL_SETTINGS)


def test_lane_cluster_occupancy_of_zero_raises(cuda, monkeypatch):
    """A plan no cluster of which fits (more shared memory than a CTA may
    hold) gives 0 resident clusters; a launch told 0 refuses in the C entry
    and the wrapper raises without counting a launch."""
    lib = _build.library()
    assert lib.gdsp_gmm_concat_resident(1024, 4096) <= 0
    assert lib.gdsp_ls_full_resident(1024, 4096) <= 0
    xr, xi = _lane_planes(cuda, 32, 1024, 1)
    monkeypatch.setattr(cuda_probes, "_cluster_resident", lambda kind, n, device: 0)
    before = launch_counts()
    for fn in (cuda_probes.gmm_concat, cuda_probes.ls_full):
        with pytest.raises(RuntimeError, match="CUDA error"):
            fn(xr, xi)
    after = launch_counts()
    assert after["gmm_concat"] == before["gmm_concat"] and after["ls_full"] == before["ls_full"]
    torch.cuda.synchronize()


def test_lane_cluster_kernels_do_not_spill(cuda, tmp_path):
    """ptxas -v on the two sources: the cluster kernels (gmm_concat_kernel,
    ls_full_kernel<1, 2, 4, 8>) spill nothing (their registers and stack
    frames are printed: ls_full_kernel<8> keeps its network's eight complex
    values in a 64-byte frame)."""
    import subprocess

    seen = 0
    for src in ("lane_probe_kernels.cu", "lane_slice_probe_kernels.cu"):
        r = subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                            "-std=c++17", "-O3", "-Xptxas", "-v", "-I", str(_build.CSRC), "-c",
                            str(_build.CSRC / src), "-o", str(tmp_path / "k.o")],
                           capture_output=True, text=True, check=True)
        lines = (r.stdout + r.stderr).splitlines()
        for i, line in enumerate(lines):
            if "Function properties for" in line and (
                    "17gmm_concat_kernel" in line or "14ls_full_kernel" in line):
                seen += 1
                print(line.split("for ")[-1], lines[i + 1].strip(), lines[i + 2].strip())
                assert "0 bytes spill stores, 0 bytes spill loads" in lines[i + 1], line
    assert seen == 5


# ---------------------------------- K14c i8_concat and K14f gmm_tf32 redesigned

_RAGGED_B = (1, 15, 17, 63, 65, 1001)


def test_i8_concat_and_gmm_tf32_geometry_match_the_host_plans(cuda):
    """gdsp_lane_cluster_geometry for i8_concat (kind 2) and
    gdsp_gmm_tf32_geometry, from the resident clusters (pairs of CTAs for
    gmm_tf32) the card reports, equal ops/cuda_probes.py's
    lane_cluster_plan("i8_concat") and gmm_tf32_plan at every n1 and ragged
    b; the kernel's chain is the mirror's GMM_TF32_CHAIN."""
    import ctypes

    lib, out = _build.library(), (ctypes.c_int * 10)()
    tf32 = cuda_probes._tf32_resident(cuda)
    print(f"gmm_tf32: {tf32} pairs of CTAs resident")
    assert tf32 >= 1
    for n1 in (1, 2, 4, 8, 16):
        n = 128 * n1
        if n1 <= 8:
            resident = cuda_probes._cluster_resident("i8_concat", n, cuda)
            print(f"i8_concat n {n}: {resident} clusters of {n1} resident")
            assert resident >= 1
        for b in _RAGGED_B + (16384,):
            if n1 <= 8:
                rc = lib.gdsp_lane_cluster_geometry(2, b, n, 0, 0, 0, resident, out)
                plan = cuda_probes.lane_cluster_plan("i8_concat", b, n, resident=resident)
                assert rc == 0 and tuple(out) == tuple(plan), (b, n)
            rc = lib.gdsp_gmm_tf32_geometry(b, n, tf32, out)
            plan = cuda_probes.gmm_tf32_plan(b, n, tf32)
            assert rc == 0 and tuple(out) == tuple(plan), (b, n)
            assert plan.chain == cuda_probes.GMM_TF32_CHAIN


@pytest.mark.parametrize("n1", [1, 2, 4, 8])
@pytest.mark.parametrize("b", _RAGGED_B)
def test_i8_concat_and_gmm_tf32_on_ragged_shapes(cuda, b, n1):
    """Ragged row tiles: i8_concat torch.equal to i8full, to its plain
    version and to its first design i8_concat_stream; gmm_tf32 >= 120 dB
    against its TF32-rounded float64 plain version and against its first
    design gmm_tf32_sync."""
    n = 128 * n1
    xr, xi = (v * 0.01 for v in _lane_planes(cuda, b, n, 5 * b + n1))
    got = cuda_probes.i8_concat(xr, xi)
    for want in (cuda_probes.i8full(xr, xi), cuda_probes.i8full_plain(xr, xi),
                 cuda_probes.i8_concat_stream(xr, xi)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    x64 = (xr.double(), xi.double())
    g = cuda_probes.gmm_tf32(xr, xi)
    assert dsputils.snr_db(_c(g), _c(cuda_probes.gmm_tf32_plain(*x64, tf32=True))) \
        >= SNR_CARD_DB
    assert dsputils.snr_db(_c(g), _c(cuda_probes.gmm_tf32_sync(xr, xi))) >= SNR_CARD_DB


@pytest.mark.parametrize("b,n", [(16384, 1024), (1001, 1024), (17, 16384)])
def test_i8_concat_and_gmm_tf32_yardsticks_on_card(cuda, b, n):
    """The first designs beside the redesigns: i8_concat_stream equal to
    i8_concat (n1 <= 8); gmm_tf32_sync and gmm_tf32 >= 120 dB against the
    TF32-rounded float64 plain version, gmm_tf32 within 3 dB of the first
    design (both dB printed); one launch a call."""
    xr, xi = _lane_planes(cuda, b, n, b + 3)
    reset_launch_counts()
    if n <= 1024:
        s8 = (xr * 0.01, xi * 0.01)
        st, got = cuda_probes.i8_concat_stream(*s8), cuda_probes.i8_concat(*s8)
        assert torch.equal(st[0], got[0]) and torch.equal(st[1], got[1])
    want = _c(cuda_probes.gmm_tf32_plain(xr.double(), xi.double(), tf32=True))
    sync = cuda_probes.gmm_tf32_sync(xr, xi)
    dbs = {"sync": dsputils.snr_db(_c(sync), want),
           "gmm_tf32": dsputils.snr_db(_c(cuda_probes.gmm_tf32(xr, xi)), want)}
    print(f"gmm_tf32 {b} x {n} dB against the TF32-rounded plain version: {dbs}")
    assert all(db >= SNR_CARD_DB for db in dbs.values())
    assert dbs["gmm_tf32"] >= dbs["sync"] - 3.0
    counts = launch_counts()
    assert counts["gmm_tf32_sync"] == counts["gmm_tf32"] == 1
    if n <= 1024:
        assert counts["i8_concat_stream"] == counts["i8_concat"] == 1


def test_i8_concat_and_gmm_tf32_occupancy_of_zero_raises(cuda, monkeypatch):
    """No cluster (no pair of CTAs, for gmm_tf32) fits a CTA asking for more
    shared memory than the card allows (0 or an error); a launch told 0
    refuses in the C entry and the wrapper raises without counting a
    launch."""
    lib = _build.library()
    assert lib.gdsp_i8_concat_resident(1024, 32768) <= 0
    assert lib.gdsp_gmm_tf32_resident(32768) <= 0
    xr, xi = _lane_planes(cuda, 64, 1024, 2)
    monkeypatch.setattr(cuda_probes, "_cluster_resident", lambda kind, n, device: 0)
    monkeypatch.setattr(cuda_probes, "_tf32_resident", lambda device: 0)
    before = launch_counts()
    for fn in (cuda_probes.i8_concat, cuda_probes.gmm_tf32):
        with pytest.raises(RuntimeError, match="CUDA error"):
            fn(xr, xi)
    after = launch_counts()
    assert after["i8_concat"] == before["i8_concat"] and after["gmm_tf32"] == before["gmm_tf32"]
    torch.cuda.synchronize()


def test_i8_concat_and_gmm_tf32_kernels_do_not_spill(cuda, tmp_path):
    """ptxas -v on the two sources: i8_concat_kernel and gmm_tf32_kernel
    spill nothing (registers printed)."""
    import subprocess

    seen = 0
    for src, names in (("int8_probe_kernels.cu", ("16i8_concat_kernel",)),
                       ("lane_slice_probe_kernels.cu", ("15gmm_tf32_kernel",))):
        r = subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                            "-std=c++17", "-O3", "-Xptxas", "-v", "-I", str(_build.CSRC), "-c",
                            str(_build.CSRC / src), "-o", str(tmp_path / "k.o")],
                           capture_output=True, text=True, check=True)
        lines = (r.stdout + r.stderr).splitlines()
        for i, line in enumerate(lines):
            if "Function properties for" in line and any(k in line for k in names):
                seen += 1
                print(line.split("for ")[-1], lines[i + 1].strip(), lines[i + 2].strip())
                assert "0 bytes spill stores, 0 bytes spill loads" in lines[i + 1], line
    assert seen == 2


# ------------------------------------------------- K14g i8_dot and K13 redesigned

_DOT_SHAPES = [(1, 1, 1), (17, 33, 5), (1001, 128, 384), (300, 256, 72), (256, 128, 128),
               (64, 1024, 48), (40, 640, 32), (33, 100, 70)]


def _dot_operands(cuda, m, k, n, seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.integers(-128, 128, size=(m, k)).astype(np.int8)).to(cuda)
    b = torch.from_numpy(rng.integers(-128, 128, size=(k, n)).astype(np.int8)).to(cuda)
    return a, b


@pytest.mark.parametrize("m,k,n", _DOT_SHAPES)
def test_i8_dot_redesign_on_card(cuda, m, k, n):
    """i8_dot torch.equal to the exact int32 product and to its first design
    i8_dot_bytes at ragged shapes (the byte path where k or n is not a
    multiple of 16, the ring where k > 512); one launch a call each."""
    a, b = _dot_operands(cuda, m, k, n, m * k + n)
    want = cuda_probes.i8_dot_plain(a, b)
    reset_launch_counts()
    got = cuda_probes.i8_dot(a, b)
    first = cuda_probes.i8_dot_bytes(a, b)
    assert got.dtype == torch.int32 and torch.equal(got, want) and torch.equal(first, want)
    counts = launch_counts()
    assert counts["i8_dot"] == 1 and counts["i8_dot_bytes"] == 1


@pytest.mark.parametrize("offset", [1, 4, 8])
def test_i8_dot_on_views_with_a_storage_offset(cuda, offset):
    """A view whose pointer is not 16-byte aligned takes the byte path (the
    plan says so) and gives the same integers."""
    m, k, n = 256, 128, 128
    a0, b0 = _dot_operands(cuda, m, k, n, offset)
    a = torch.empty(m * k + offset, dtype=torch.int8, device=cuda)[offset:].view(m, k)
    b = torch.empty(k * n + offset, dtype=torch.int8, device=cuda)[offset:].view(k, n)
    a.copy_(a0)
    b.copy_(b0)
    assert a.data_ptr() % 16 and b.data_ptr() % 16
    assert cuda_probes.i8_dot_plan(m, k, n, aligned=False).vec == 0
    assert torch.equal(cuda_probes.i8_dot(a, b), cuda_probes.i8_dot_plain(a0, b0))
    assert torch.equal(cuda_probes.i8_dot(a0, b), cuda_probes.i8_dot(a0, b0))


def test_i8_dot_past_grid_y(cuda):
    """Rows past grid.y's 65535 tiles go through the row grid's z slices."""
    m, k, n = 32 * 65535 + 40, 16, 16
    a, b = _dot_operands(cuda, m, k, n, 5)
    assert cuda_probes.i8_dot_plan(m, k, n).gz == 2
    got = cuda_probes.i8_dot(a, b)
    assert torch.equal(got, cuda_probes.i8_dot_plain(a, b))


def test_i8_dot_geometry_matches_the_host_plan(cuda):
    """gdsp_i8_dot_geometry equals cuda_probes.i8_dot_plan on both paths."""
    import ctypes

    lib, out = _build.library(), (ctypes.c_int * 10)()
    for m, k, n in _DOT_SHAPES + [(0, 4, 4), (32 * 65535 + 40, 16, 16), (5, 0, 3)]:
        for aligned in (0, 1):
            assert lib.gdsp_i8_dot_geometry(m, k, n, aligned, out) == 0
            assert tuple(out) == tuple(cuda_probes.i8_dot_plan(m, k, n, bool(aligned)))


_K13_B = [1, 15, 17, 63, 65, 129, 1001]
_K13_N1 = [1, 2, 3, 8, 9, 128]


@pytest.mark.parametrize("n1", _K13_N1)
def test_k13_redesign_on_card(cuda, n1):
    """K13 torch.equal to its first design gmm_floor_sync and >= 120 dB
    against float64 at ragged b, n1 = 1 .. 128; torch.equal to gmm_concat
    where n <= 2048; one launch a call each."""
    n = 128 * n1
    for b in _K13_B:
        xr, xi = _lane_planes(cuda, b, n, b + n)
        reset_launch_counts()
        got = cuda_metrics.gmm_floor(xr, xi)
        first = cuda_probes.gmm_floor_sync(xr, xi)
        counts = launch_counts()
        assert counts["gmm_floor"] == 1 and counts["gmm_floor_sync"] == 1
        assert torch.equal(got[0], first[0]) and torch.equal(got[1], first[1]), b
        if n <= 2048:
            gc = cuda_probes.gmm_concat(xr, xi)
            assert torch.equal(got[0], gc[0]) and torch.equal(got[1], gc[1]), b
        want = _c(cuda_metrics.gmm_floor_plain(xr.double(), xi.double()))
        assert dsputils.snr_db(_c(got), want) >= SNR_CARD_DB, b


def test_gmm_floor_geometry_matches_the_host_plan(cuda):
    """gdsp_gmm_floor_geometry (from the resident CTAs the card reports)
    equals cuda_metrics.gmm_floor_plan; one CTA an SM fits."""
    import ctypes

    lib, out = _build.library(), (ctypes.c_int * 7)()
    resident = cuda_metrics._floor_resident(cuda)
    assert resident == torch.cuda.get_device_properties(cuda).multi_processor_count
    for b in (0, 1, 127, 128, 129, 1001, 16384, 1 << 17):
        for n1 in (1, 2, 3, 8, 128):
            assert lib.gdsp_gmm_floor_geometry(b, 128 * n1, resident, out) == 0
            assert tuple(out) == tuple(cuda_metrics.gmm_floor_plan(b, 128 * n1, resident))


def test_k13_refuses_without_a_resident_cta(cuda, monkeypatch):
    """A resident count of 0: the launch refuses and nothing is counted."""
    monkeypatch.setattr(cuda_metrics, "_floor_resident", lambda device: 0)
    xr, xi = _lane_planes(cuda, 64, 256, 3)
    before = launch_counts()["gmm_floor"]
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_metrics.gmm_floor(xr, xi)
    assert launch_counts()["gmm_floor"] == before
    torch.cuda.synchronize()


def test_i8_dot_and_k13_kernels_do_not_spill(cuda, tmp_path):
    """ptxas -v on the two sources: i8_dot_kernel (both paths) and
    gmm_floor_kernel spill nothing (registers printed)."""
    import subprocess

    seen = 0
    for src, names in (("int8_probe_kernels.cu", ("13i8_dot_kernel",)),
                       ("metrics_kernels.cu", ("16gmm_floor_kernel",))):
        r = subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                            "-std=c++17", "-O3", "-Xptxas", "-v", "-I", str(_build.CSRC), "-c",
                            str(_build.CSRC / src), "-o", str(tmp_path / "k.o")],
                           capture_output=True, text=True, check=True)
        lines = (r.stdout + r.stderr).splitlines()
        for i, line in enumerate(lines):
            if "Function properties for" in line and any(k in line for k in names):
                seen += 1
                print(line.split("for ")[-1], lines[i + 1].strip(), lines[i + 2].strip())
                assert "0 bytes spill stores, 0 bytes spill loads" in lines[i + 1], line
    assert seen == 3


# ----------------------------------------- K14d bd_hi and K14c slicestore redesigned

_HI_SHAPES = [(16384, 1024), (1001, 2048), (1, 128), (65, 384), (100, 1024), (64, 2048)]


@pytest.mark.parametrize("b,n", _HI_SHAPES)
def test_bd_hi_redesign_on_card(cuda, b, n):
    """bd_hi (wgmma, A from registers, fed by TMA) and its first design
    bd_hi_sync each >= 120 dB against bd_hi_plain in float64 and against
    each other, one launch a call, the TF32 flags untouched: at the probe's
    shape, ragged rows (1001, 1, 65, 100: not a multiple of a 64-row tile)
    and n1 = 1, 3, 8 and 16."""
    xr, xi = _lane_planes(cuda, b, n, b + 7 * n)
    want = _c(cuda_probes.bd_hi_plain(xr.double(), xi.double()))
    flags = _tf32_flags()
    reset_launch_counts()
    new, first = cuda_probes.bd_hi(xr, xi), cuda_probes.bd_hi_sync(xr, xi)
    dbs = {"bd_hi": dsputils.snr_db(_c(new), want),
           "bd_hi_sync": dsputils.snr_db(_c(first), want),
           "against each other": dsputils.snr_db(_c(new), _c(first))}
    print(f"bd_hi {b} x {n}: {dbs}")
    assert all(db >= SNR_CARD_DB for db in dbs.values()), dbs
    counts = launch_counts()
    assert counts["bd_hi"] == counts["bd_hi_sync"] == 1
    assert _tf32_flags() == flags
    with pytest.raises(TypeError):
        cuda_probes.bd_hi(xr.double(), xi.double())


def test_bd_hi_geometry_matches_the_host_plan(cuda):
    """gdsp_bd_hi_geometry, from the resident pairs of CTAs the card
    reports and at chosen counts, equals ops/cuda_probes.py's bd_hi_plan at
    ragged b and n1 = 1, 3, 8, 16; the kernel's chain is BD_HI_CHAIN."""
    import ctypes

    lib, out = _build.library(), (ctypes.c_int * 10)()
    resident = cuda_probes._hi_resident(cuda)
    print(f"bd_hi: {resident} pairs of CTAs resident")
    assert resident >= 1
    for r in (resident, 1, 7):
        for n1 in (1, 3, 8, 16):
            for b in (0, 1, 64, 65, 1001, 16384):
                rc = lib.gdsp_bd_hi_geometry(b, 128 * n1, r, out)
                plan = cuda_probes.bd_hi_plan(b, 128 * n1, r)
                assert rc == 0 and tuple(out) == tuple(plan), (b, n1, r)
                assert plan.chain == cuda_probes.BD_HI_CHAIN


def test_bd_hi_refuses_without_a_resident_pair(cuda, monkeypatch):
    """No pair fits a CTA asking for more shared memory than the card
    allows; a launch told 0 refuses in the C entry and the wrapper raises
    without counting a launch."""
    assert _build.library().gdsp_bd_hi_resident(32768) <= 0
    monkeypatch.setattr(cuda_probes, "_hi_resident", lambda device: 0)
    xr, xi = _lane_planes(cuda, 64, 256, 4)
    before = launch_counts()["bd_hi"]
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_probes.bd_hi(xr, xi)
    assert launch_counts()["bd_hi"] == before
    torch.cuda.synchronize()


@pytest.mark.parametrize("b,n", [(16384, 1024), (1001, 384), (1001, 1152), (13, 1024),
                                 (1, 128)])
def test_slicestore_redesign_on_card(cuda, b, n):
    """slicestore (every slice's loads first, csrc/slice_walk.cuh) and its
    first design slicestore_sync torch.equal to their input, one launch
    each: at the probe's shape, fewer slices than a chunk (384), a ragged
    chunk (1152), rows that are not a multiple of a block's eight, one
    slice of one row."""
    xr, xi = _lane_planes(cuda, b, n, 3 * b + n)
    for name in ("slicestore", "slicestore_sync"):
        reset_launch_counts()
        got = getattr(cuda_probes, name)(xr, xi)
        assert launch_counts()[name] == 1
        assert torch.equal(got[0], xr) and torch.equal(got[1], xi), name
    with pytest.raises(TypeError):
        cuda_probes.slicestore_sync(xr.double(), xi.double())


def test_bd_hi_and_slice_walk_kernels_do_not_spill(cuda, tmp_path):
    """ptxas -v on the two sources: bd_hi_kernel, slice8_kernel and
    slicestore_kernel spill nothing (registers printed)."""
    import subprocess

    seen = 0
    for src, names in (("anatomy_probe_kernels.cu", ("12bd_hi_kernel", "13slice8_kernel")),
                       ("lane_probe_kernels.cu", ("17slicestore_kernel",))):
        r = subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                            "-std=c++17", "-O3", "-Xptxas", "-v", "-I", str(_build.CSRC), "-c",
                            str(_build.CSRC / src), "-o", str(tmp_path / "k.o")],
                           capture_output=True, text=True, check=True)
        lines = (r.stdout + r.stderr).splitlines()
        for i, line in enumerate(lines):
            if "Function properties for" in line and any(k in line for k in names):
                seen += 1
                print(line.split("for ")[-1], lines[i + 1].strip(), lines[i + 2].strip())
                assert "0 bytes spill stores, 0 bytes spill loads" in lines[i + 1], line
    assert seen == 3


# ----------------------------------------- K14d bd_tf32 and K14h vdif redesigned

_B1_SHAPES = [(16384, 1024), (1001, 2048), (1, 128), (65, 384), (100, 1024), (64, 2048)]


@pytest.mark.parametrize("b,n", _B1_SHAPES)
def test_bd_tf32_redesign_on_card(cuda, b, n):
    """bd_tf32 (wgmma m64n128k8, A from registers, fed by TMA) and its first
    design bd_tf32_sync each >= 120 dB against bd_tf32_plain with
    TF32-rounded operands summed in float64, equal to each other, one
    launch a call, the TF32
    flags untouched; the identity table returns round_tf32(x) and a cyclic
    shift the rolled slices, exactly (a transposed B would not): at the
    probe's shape, ragged rows (1001, 1, 65, 100) and n1 = 1, 3, 8, 16."""
    xr, xi = _lane_planes(cuda, b, n, b + 5 * n)
    want = _c(cuda_probes.bd_tf32_plain(xr.double(), xi.double(), tf32=True))
    flags = _tf32_flags()
    reset_launch_counts()
    new, first = cuda_probes.bd_tf32(xr, xi), cuda_probes.bd_tf32_sync(xr, xi)
    assert torch.equal(new[0], first[0]) and torch.equal(new[1], first[1])
    dbs = {"bd_tf32": dsputils.snr_db(_c(new), want),
           "bd_tf32_sync": dsputils.snr_db(_c(first), want)}
    print(f"bd_tf32 {b} x {n}: {dbs}")
    assert all(db >= SNR_CARD_DB for db in dbs.values()), dbs
    counts = launch_counts()
    assert counts["bd_tf32"] == counts["bd_tf32_sync"] == 1
    eye = torch.eye(128, device=cuda)
    rolled = [torch.roll(cuda_probes.round_tf32(x).view(b, -1, 128), 1, dims=2).reshape(b, n)
              for x in (xr, xi)]
    for table, want_planes in ((eye, [cuda_probes.round_tf32(x) for x in (xr, xi)]),
                               (torch.roll(eye, 1, dims=1), rolled)):
        for fn in (cuda_probes.bd_tf32, cuda_probes.bd_tf32_sync):
            got = fn(xr, xi, table)
            assert torch.equal(got[0], want_planes[0]) and torch.equal(got[1], want_planes[1])
    assert _tf32_flags() == flags
    with pytest.raises(TypeError):
        cuda_probes.bd_tf32(xr.double(), xi.double())


def test_bd_tf32_geometry_matches_the_host_plan(cuda):
    """gdsp_bd_tf32_geometry, from the resident CTAs the card reports and at
    chosen counts, equals ops/cuda_probes.py's bd_tf32_plan at ragged b and
    n1 = 1, 3, 8, 16."""
    import ctypes

    lib, out = _build.library(), (ctypes.c_int * 8)()
    resident = cuda_probes._b1_resident(cuda)
    print(f"bd_tf32: {resident} CTAs resident")
    assert resident >= 1
    for r in (resident, 1, 7):
        for n1 in (1, 3, 8, 16):
            for b in (0, 1, 64, 65, 1001, 16384):
                rc = lib.gdsp_bd_tf32_geometry(b, 128 * n1, r, out)
                assert rc == 0 and tuple(out) == tuple(cuda_probes.bd_tf32_plan(b, 128 * n1, r))


def test_bd_tf32_refuses_without_a_resident_cta(cuda, monkeypatch):
    """No CTA fits one asking for more shared memory than the card allows; a
    launch told 0 refuses in the C entry and the wrapper raises without
    counting a launch."""
    assert _build.library().gdsp_bd_tf32_resident(32768) <= 0
    monkeypatch.setattr(cuda_probes, "_b1_resident", lambda device: 0)
    xr, xi = _lane_planes(cuda, 64, 256, 4)
    before = launch_counts()["bd_tf32"]
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_probes.bd_tf32(xr, xi)
    assert launch_counts()["bd_tf32"] == before
    torch.cuda.synchronize()


@pytest.mark.parametrize("b,n", [(16384, 1024), (1001, 512), (9, 256), (5, 128),
                                 (8 * 65535 + 9, 128), (3, 1024)])
def test_vdif_redesign_on_card(cuda, b, n):
    """vdif (a warp a row, the row by 16-byte cp.async into a shared buffer)
    and its first design vdif_sync each >= 120 dB against the float64 plain
    version, equal to each other, one launch a call; the redesign's digit
    order exact: at the probe's shape, ragged rows, the four n1, more rows
    than the first design's grid.y holds, fewer rows than a block's
    warps."""
    from godsp_tpu_torch.probes import vdif

    xr, xi = _lane_planes(cuda, b, n, b + n)
    s = n ** -0.5
    want = _c(cuda_probes.vdif_plain(xr.double(), xi.double(), s))
    reset_launch_counts()
    got, first = cuda_probes.vdif(xr, xi, s), cuda_probes.vdif_sync(xr, xi, s)
    assert torch.equal(got[0], first[0]) and torch.equal(got[1], first[1])
    dbs = {"vdif": dsputils.snr_db(_c(got), want), "vdif_sync": dsputils.snr_db(_c(first), want)}
    print(f"vdif {b} x {n}: {dbs}")
    assert all(db >= SNR_CARD_DB for db in dbs.values()), dbs
    counts = launch_counts()
    assert counts["vdif"] == counts["vdif_sync"] == 1
    assert vdif.digit_order_exact(cuda, n, s)
    with pytest.raises(TypeError):
        cuda_probes.vdif_sync(xr.double(), xi.double())


def test_vdif_geometry_matches_the_host_plan(cuda):
    """gdsp_vdif_geometry equals ops/cuda_probes.py's vdif_plan at each width
    and ragged b, and refuses a width vdif does not take."""
    import ctypes

    lib, out = _build.library(), (ctypes.c_int64 * 3)()
    for n in (128, 256, 512, 1024):
        for b in (0, 1, 5, 1001, 16384, 524289):
            rc = lib.gdsp_vdif_geometry(b, n, out)
            assert rc == 0 and tuple(out) == tuple(cuda_probes.vdif_plan(b, n))
    assert lib.gdsp_vdif_geometry(16, 384, out) != 0


def test_bd_tf32_and_vdif_kernels_do_not_spill(cuda, tmp_path):
    """ptxas -v on the two sources: bd_tf32_kernel and vdif_kernel at each
    n1 spill nothing and keep no stack frame (registers printed)."""
    import subprocess

    seen = 0
    for src, names in (("anatomy_probe_kernels.cu", ("14bd_tf32_kernel",)),
                       ("dif_probe_kernels.cu", ("11vdif_kernel",))):
        r = subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                            "-std=c++17", "-O3", "-Xptxas", "-v", "-I", str(_build.CSRC), "-c",
                            str(_build.CSRC / src), "-o", str(tmp_path / "k.o")],
                           capture_output=True, text=True, check=True)
        lines = (r.stdout + r.stderr).splitlines()
        for i, line in enumerate(lines):
            if "Function properties for" in line and any(k in line for k in names):
                seen += 1
                print(line.split("for ")[-1], lines[i + 1].strip(), lines[i + 2].strip())
                assert "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads" in \
                    lines[i + 1], line
    assert seen == 5


# ---------------------------------- K14d anat_full and K14a pwfloor_staged redesigned

_ANAT_SHAPES = [(16384, 1024), (1001, 2048), (1, 128), (65, 384), (100, 1024), (3, 16384)]


@pytest.mark.parametrize("b,n", _ANAT_SHAPES)
def test_anat_full_redesign_on_card(cuda, b, n):
    """anat_full (bd_hi's walk, each 16-column k-box with its partner n / 2
    columns away, the rounds, the row and the split in registers) and its
    first design anat_full_sync each >= 120 dB against anat_full_plain in
    float64 and against each other, one launch a call, the TF32 flags
    untouched: at the probe's shape, ragged rows, n1 = 1 (the partner in
    the same slice), 3 (h = 192: half a slice off), 8, 16 and 128."""
    xr, xi = _lane_planes(cuda, b, n, b + 5 * n)
    tw = torch.randn(n, generator=torch.Generator(device=cuda).manual_seed(n), device=cuda)
    want = _c(cuda_probes.anat_full_plain(xr.double(), xi.double(), tw))
    flags = _tf32_flags()
    reset_launch_counts()
    new, first = cuda_probes.anat_full(xr, xi, tw), cuda_probes.anat_full_sync(xr, xi, tw)
    dbs = {"anat_full": dsputils.snr_db(_c(new), want),
           "anat_full_sync": dsputils.snr_db(_c(first), want),
           "against each other": dsputils.snr_db(_c(new), _c(first))}
    print(f"anat_full {b} x {n}: {dbs}")
    assert all(db >= SNR_CARD_DB for db in dbs.values()), dbs
    counts = launch_counts()
    assert counts["anat_full"] == counts["anat_full_sync"] == 1
    assert _tf32_flags() == flags
    with pytest.raises(TypeError):
        cuda_probes.anat_full_sync(xr.double(), xi.double(), tw)


def test_anat_full_feeds_the_products_what_bd_hi_is_fed(cuda):
    """anat_full equals bd_hi of the float32 rounds and row (the same A
    values, products and chain): bit for bit."""
    xr, xi = _lane_planes(cuda, 1001, 1024, 11)
    tw = torch.randn(1024, generator=torch.Generator(device=cuda).manual_seed(5), device=cuda)
    a, c = cuda_probes.half3_plain(xr, xi)
    at, ct = a * tw, c * tw
    want = cuda_probes.bd_hi(at - ct, at + ct)
    got = cuda_probes.anat_full(xr, xi, tw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_anat_full_geometry_matches_the_host_plan(cuda):
    """gdsp_anat_full_geometry, from the resident pairs the card reports and
    at chosen counts, equals ops/cuda_probes.py's anat_full_plan at ragged b
    and n1 = 1, 3, 8, 16, 128."""
    import ctypes

    lib, out = _build.library(), (ctypes.c_int * 12)()
    resident = cuda_probes._anat_resident(cuda)
    print(f"anat_full: {resident} pairs of CTAs resident")
    assert resident >= 1
    for r in (resident, 1, 7):
        for n1 in (1, 3, 8, 16, 128):
            for b in (0, 1, 64, 65, 1001, 16384):
                rc = lib.gdsp_anat_full_geometry(b, 128 * n1, r, out)
                assert rc == 0 and tuple(out) == tuple(cuda_probes.anat_full_plan(b, 128 * n1, r))


def test_anat_full_refuses_without_a_resident_pair(cuda, monkeypatch):
    assert _build.library().gdsp_anat_full_resident(32768) <= 0
    monkeypatch.setattr(cuda_probes, "_anat_resident", lambda device: 0)
    xr, xi = _lane_planes(cuda, 64, 256, 4)
    before = launch_counts()["anat_full"]
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_probes.anat_full(xr, xi, torch.ones(256, device=cuda))
    assert launch_counts()["anat_full"] == before
    torch.cuda.synchronize()


# (nfft, hop, pad, segments, kept, rows, offset of the row in its tensor)
_STAGED_GEOMETRIES = [(1024, 512, 1024, 16384, 16384, 1, 0), (1024, 160, 1024, 52428, 52428, 1, 0),
                      (1000, 160, 1024, 5001, 4990, 1, 0), (1024, 161, 1024, 3001, 3001, 2, 1),
                      (1024, 512, 1024, 2048, 2000, 3, 3), (4096, 1024, 4096, 5000, 5000, 1, 0),
                      (1500, 333, 2048, 777, 700, 2, 2), (50, 7, 64, 1000, 999, 3, 1),
                      (16384, 8192, 16384, 9, 9, 1, 0), (2, 1, 2, 100, 100, 1, 3)]


@pytest.mark.parametrize("nfft,hop,pad,S,keep,rows,offset", _STAGED_GEOMETRIES)
def test_pwfloor_staged_redesign_on_card(cuda, nfft, hop, pad, S, keep, rows, offset):
    """pwfloor_staged (K4's body, each frame cut from the tile's span staged
    by the TMA) torch.equal to K4 at K4's tiles, one launch; >= 120 dB
    against float64: at the probe's geometry, hop 160, a ragged last tile
    with a partial mask, odd hops, rows that start off a 16-byte boundary
    (a view offset floats into its tensor, odd L), the block route (pad
    4096, 16384), and pads 64 and 2 (Q frames a warp)."""
    rng = np.random.default_rng(S + hop)
    L = (S - 1) * hop + nfft - 3  # the last frame runs past the samples: zeros
    base = torch.from_numpy(rng.uniform(-1, 1, size=rows * L + offset)).float().to(cuda)
    ext = base[offset:].view(rows, L)
    mask = torch.from_numpy((np.arange(S) < keep) * np.ones((rows, 1))).float().to(cuda)
    w = window.window_table("hann", pad, device=cuda, dtype=torch.float32)
    bt = cuda_probes.staged_segs_per_tile(S, rows, nfft, hop, pad)
    assert bt == min(cuda_pwelch.segs_per_tile(S, rows), cuda_probes.staged_max_bt(nfft, hop, pad))
    reset_launch_counts()
    got = cuda_probes.pwfloor_staged(ext, mask, w, nfft, hop, pad)
    assert launch_counts()["pwfloor_staged"] == 1
    assert torch.equal(got, cuda_pwelch.pwelch_power_partials(ext, mask, w, nfft, hop, pad))
    want = cuda_probes.pwfloor_staged_plain(ext.double(), mask.double(), w.double(), nfft, hop,
                                            pad, bt)
    assert dsputils.snr_db(_np(got), _np(want)) >= SNR_CARD_DB
    if bt <= cuda_probes._staged_max_bt(nfft, hop, pad):
        first = cuda_probes.pwfloor_staged_radix2(ext, mask, w, nfft, hop, pad, bt=bt)
        assert launch_counts()["pwfloor_staged_radix2"] == 1
        assert dsputils.snr_db(_np(first), _np(want)) >= SNR_CARD_DB


def test_pwfloor_staged_geometry_matches_the_host(cuda):
    """gdsp_pwfloor_staged_geometry (segments at once, threads, slots,
    shared bytes) equals cuda_probes.staged_cta at every pad and chosen
    tiles and hops."""
    import ctypes

    lib, out = _build.library(), (ctypes.c_int64 * 4)()
    for lg in range(1, 15):
        pad = 1 << lg
        for tile in (1, 3, 16, 50, 64):
            for nfft, hop in ((pad, max(1, pad // 2)), (max(1, pad - 5), 7)):
                assert lib.gdsp_pwfloor_staged_geometry(lg, tile, nfft, hop, out) == 0
                assert tuple(out) == cuda_probes.staged_cta(pad, tile, nfft, hop), (pad, tile)


def test_anat_full_and_staged_kernels_do_not_spill(cuda, tmp_path):
    """ptxas -v: anat_full_kernel and staged_partials_kernel at every pad
    spill nothing (registers printed)."""
    import subprocess

    seen = 0
    for src, names in (("anatomy_probe_kernels.cu", ("16anat_full_kernel",)),
                       ("pwelch_probe_kernels.cu", ("22staged_partials_kernel",))):
        r = subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                            "-std=c++17", "-O3", "-Xptxas", "-v", "-I", str(_build.CSRC), "-c",
                            str(_build.CSRC / src), "-o", str(tmp_path / "k.o")],
                           capture_output=True, text=True, check=True)
        lines = (r.stdout + r.stderr).splitlines()
        for i, line in enumerate(lines):
            if "Function properties for" in line and any(k in line for k in names):
                seen += 1
                print(line.split("for ")[-1], lines[i + 1].strip(), lines[i + 2].strip())
                assert "0 bytes spill stores, 0 bytes spill loads" in lines[i + 1], line
    assert seen == 15


# ------------------------------- K14a pwfloor_noframe and K14i sdif_peel redesigned

# (pad, frames, kept, rows, offset of the frames in their tensor, floats)
_NOFRAME_GEOMETRIES = [(1024, 16384, 16384, 1, 0), (2048, 5001, 4990, 1, 0), (4096, 300, 290, 2, 0),
                       (16384, 9, 9, 1, 0), (1024, 3001, 3000, 2, 1), (64, 1000, 999, 3, 2),
                       (32, 129, 128, 2, 3), (4, 77, 70, 2, 0), (2, 100, 99, 3, 1)]


@pytest.mark.parametrize("pad,S,keep,rows,offset", _NOFRAME_GEOMETRIES)
def test_pwfloor_noframe_redesign_on_card(cuda, pad, S, keep, rows, offset):
    """pwfloor_noframe (K4's body, each frame read from its row 16 bytes a
    lane) torch.equal to K4 on the frames flattened at nfft = hop = pad,
    one launch; it and its first design pwfloor_noframe_radix2 >= 120 dB
    against float64: the probe geometry, the pad-2048 ragged tile, the
    block route (pad 4096, 16384), frames off a 16-byte boundary (cloned),
    Q frames a warp (pads 64, 32, 4) and pad 2's 8-byte pair."""
    rng = np.random.default_rng(pad + S)
    base = torch.from_numpy(rng.uniform(-1, 1, size=rows * S * pad + offset)).float().to(cuda)
    frames = base[offset:].view(rows, S, pad)
    mask = torch.from_numpy((np.arange(S) < keep) * np.ones((rows, 1))).float().to(cuda)
    w = window.window_table("hann", pad, device=cuda, dtype=torch.float32)
    bt = cuda_pwelch.segs_per_tile(S, rows)
    reset_launch_counts()
    got = cuda_probes.pwfloor_noframe(frames, mask, w)
    first = cuda_probes.pwfloor_noframe_radix2(frames, mask, w)
    counts = launch_counts()
    assert counts["pwfloor_noframe"] == counts["pwfloor_noframe_radix2"] == 1
    assert torch.equal(got, cuda_pwelch.pwelch_power_partials(frames.reshape(rows, S * pad), mask,
                                                              w, pad, pad, pad))
    want = _np(cuda_probes.pwfloor_noframe_plain(frames.double(), mask.double(), w.double(), bt))
    assert dsputils.snr_db(_np(got), want) >= SNR_CARD_DB
    assert dsputils.snr_db(_np(first), want) >= SNR_CARD_DB


@pytest.mark.parametrize("shape", [(1, 128, 131072), (3, 128, 1000), (2, 128, 1), (1, 128, 33),
                                   (16, 128, 8192), (2, 2, 128, 31)])
def test_sdif_peel_redesign_on_card(cuda, shape):
    """sdif_peel (the stages in registers on K8's column tile, Tb from K8's
    tile table) and its first design sdif_peel_sync each >= 120 dB against
    float64 and against each other, one launch a call; its rows are K8's
    brev7(r): at 2^24, the ragged (3, 128, 1000), m = 1 and 33, and 16 x
    (128, 8192)."""
    g = torch.Generator(device=cuda).manual_seed(shape[-1] + 7)
    xr, xi = (torch.randn(shape, generator=g, device=cuda) for _ in range(2))
    reset_launch_counts()
    new, first = cuda_probes.sdif_peel(xr, xi), cuda_probes.sdif_peel_sync(xr, xi)
    counts = launch_counts()
    assert counts["sdif_peel"] == counts["sdif_peel_sync"] == 1
    want = _c(cuda_probes.sdif_peel_plain(xr.double(), xi.double()))
    dbs = {"sdif_peel": dsputils.snr_db(_c(new), want),
           "sdif_peel_sync": dsputils.snr_db(_c(first), want),
           "against each other": dsputils.snr_db(_c(new), _c(first))}
    print(f"sdif_peel {shape}: {dbs}")
    assert all(db >= SNR_CARD_DB for db in dbs.values()), dbs
    d = cuda_outer.outer_dft_split(xr, xi, 128, 1)
    perm = cuda_probes.brev7_perm().to(cuda)
    assert dsputils.snr_db(_c(new), _c((d[0][..., perm, :], d[1][..., perm, :]))) >= SNR_CARD_DB


def test_sdif_geometry_matches_the_host_plan(cuda):
    """gdsp_sdif_geometry (threads, columns, tiles, shared bytes) equals
    ops/cuda_probes.py's sdif_plan at ragged m and batches past grid.y, and
    refuses m < 1."""
    import ctypes

    lib, out = _build.library(), (ctypes.c_int64 * 4)()
    for m in (1, 31, 32, 33, 1000, 8192, 131072):
        for b in (0, 1, 3, 65537):
            assert lib.gdsp_sdif_geometry(m, b, out) == 0
            assert tuple(out) == tuple(cuda_probes.sdif_plan(m, b)), (m, b)
    assert lib.gdsp_sdif_geometry(0, 1, out) != 0


def test_noframe_and_sdif_kernels_do_not_spill(cuda, tmp_path):
    """ptxas -v: noframe_partials_kernel at every pad and sdif_peel_kernel
    spill nothing and keep no stack frame (registers printed)."""
    import subprocess

    seen = 0
    for src, names in (("pwelch_probe_kernels.cu", ("23noframe_partials_kernel",)),
                       ("dif_probe_kernels.cu", ("16sdif_peel_kernel",))):
        r = subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                            "-std=c++17", "-O3", "-Xptxas", "-v", "-I", str(_build.CSRC), "-c",
                            str(_build.CSRC / src), "-o", str(tmp_path / "k.o")],
                           capture_output=True, text=True, check=True)
        lines = (r.stdout + r.stderr).splitlines()
        for i, line in enumerate(lines):
            if "Function properties for" in line and any(k in line for k in names):
                seen += 1
                print(line.split("for ")[-1], lines[i + 1].strip(), lines[i + 2].strip())
                assert "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads" in \
                    lines[i + 1], line
    assert seen == 15


# ------------------------------ K14g i8full and K14a pwfloor_frameonly redesigned


@pytest.mark.parametrize("b,n", [(16384, 1024), (1001, 512), (33, 384), (1, 128), (17, 1024),
                                 (257, 256), (16 * 65535 + 17, 128)])
def test_i8full_redesign_on_card(cuda, b, n):
    """i8full (digit warps and product warps on named barriers, one CTA an
    SM) torch.equal to its plain version, to i8_concat and to its first
    design i8full_sync, one launch each: ragged b, n1 = 1 to 8, b past
    grid.y's 65535 16-row tiles."""
    xr, xi = (v * 0.01 for v in _lane_planes(cuda, b, n, b + n))
    reset_launch_counts()
    got, first = cuda_probes.i8full(xr, xi), cuda_probes.i8full_sync(xr, xi)
    counts = launch_counts()
    assert counts["i8full"] == counts["i8full_sync"] == 1
    for want in (cuda_probes.i8full_plain(xr, xi), cuda_probes.i8_concat(xr, xi), first):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_i8full_geometry_matches_the_host_plan(cuda):
    """gdsp_i8full_geometry (CTAs, threads, warps a role, stages, shared
    bytes) equals ops/cuda_probes.py's i8full_plan at the card's resident
    CTAs and fewer, and refuses a shape the kernel does not take."""
    import ctypes

    lib, out = _build.library(), (ctypes.c_int * 6)()
    resident = cuda_probes._i8full_resident(cuda)
    assert resident >= 1
    for b in (0, 1, 17, 1001, 16384, 16 * 65535 + 17):
        for n in (128, 384, 1024):
            for res in (1, 7, resident):
                assert lib.gdsp_i8full_geometry(b, n, res, out) == 0
                assert tuple(out) == tuple(cuda_probes.i8full_plan(b, n, res)), (b, n, res)
    for b, n, res in ((-1, 128, 1), (4, 200, 1), (4, 2048, 1), (4, 128, 0)):
        assert lib.gdsp_i8full_geometry(b, n, res, out) != 0


def test_i8full_occupancy_of_zero_raises(cuda, monkeypatch):
    """A launch told no CTA fits refuses in the C entry; the wrapper raises
    without counting a launch."""
    xr, xi = _lane_planes(cuda, 64, 1024, 2)
    monkeypatch.setattr(cuda_probes, "_i8full_resident", lambda device: 0)
    before = launch_counts()["i8full"]
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_probes.i8full(xr, xi)
    assert launch_counts()["i8full"] == before
    torch.cuda.synchronize()


# (nfft, hop, pad, segments, kept, rows, offset of the window in its tensor)
_FRAMEONLY_GEOMETRIES = [(1024, 512, 1024, 16384, 16384, 1, 0), (1000, 160, 1024, 5001, 4990, 1, 0),
                         (4096, 1024, 4096, 300, 290, 2, 0), (16384, 4096, 16384, 9, 9, 1, 0),
                         (1000, 333, 2048, 777, 770, 2, 1), (31, 7, 32, 1000, 999, 3, 0),
                         (200, 17, 256, 555, 500, 1, 0), (3, 3, 4, 64, 63, 1, 0),
                         (2, 1, 2, 100, 99, 2, 1)]


@pytest.mark.parametrize("nfft,hop,pad,S,keep,rows,offset", _FRAMEONLY_GEOMETRIES)
def test_pwfloor_frameonly_redesign_on_card(cuda, nfft, hop, pad, S, keep, rows, offset):
    """pwfloor_frameonly (K4's body without the transform) and its first
    design pwfloor_frameonly_shared >= 120 dB against the float64 plain
    version, one launch each: the probe geometry, hop 160 with pad > nfft,
    the block route (pad 4096, 16384), odd hops, Q frames a warp (pads 32,
    4, 2), masked segments, a window off an 8-byte boundary (cloned)."""
    g = torch.Generator(device=cuda).manual_seed(S + pad)
    ext = torch.rand(rows, (S - 1) * hop + nfft - 3, generator=g, device=cuda) * 2 - 1
    mask = (torch.arange(S, device=cuda) < keep).float().expand(rows, S).contiguous()
    base = torch.zeros(pad + offset, device=cuda)
    base[offset:] = window.window_table("hann", pad, device=cuda, dtype=torch.float32)
    w = base[offset:]
    reset_launch_counts()
    got = cuda_probes.pwfloor_frameonly(ext, mask, w, nfft, hop, pad)
    first = cuda_probes.pwfloor_frameonly_shared(ext, mask, w, nfft, hop, pad)
    counts = launch_counts()
    assert counts["pwfloor_frameonly"] == counts["pwfloor_frameonly_shared"] == 1
    bt = cuda_pwelch.segs_per_tile(S, rows)
    want = _np(cuda_probes.pwfloor_frameonly_plain(ext.double(), mask.double(), w.double(), nfft,
                                                   hop, pad, bt))
    assert got.shape == first.shape == want.shape
    assert dsputils.snr_db(_np(got), want) >= SNR_CARD_DB
    assert dsputils.snr_db(_np(first), want) >= SNR_CARD_DB


def test_i8full_and_frameonly_kernels_do_not_spill(cuda, tmp_path):
    """ptxas -v: i8full_kernel and frameonly_partials_kernel at every pad
    spill nothing and keep no stack frame (registers printed)."""
    import subprocess

    seen = 0
    for src, names in (("int8_probe_kernels.cu", ("13i8full_kernel",)),
                       ("pwelch_probe_kernels.cu", ("25frameonly_partials_kernel",))):
        r = subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                            "-std=c++17", "-O3", "-Xptxas", "-v", "-I", str(_build.CSRC), "-c",
                            str(_build.CSRC / src), "-o", str(tmp_path / "k.o")],
                           capture_output=True, text=True, check=True)
        lines = (r.stdout + r.stderr).splitlines()
        for i, line in enumerate(lines):
            if "Function properties for" in line and any(k in line for k in names):
                seen += 1
                print(line.split("for ")[-1], lines[i + 1].strip(), lines[i + 2].strip())
                assert "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads" in \
                    lines[i + 1], line
    assert seen == 15
