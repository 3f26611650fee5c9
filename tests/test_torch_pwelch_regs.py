"""K4/K11's and K7's register-radix design (csrc/pwelch_kernel.cu,
csrc/csd_kernel.cu on csrc/frame_regs.cuh) on the CPU.

The kernels cannot run here, so their host side is held instead:
ops/cuda_pwelch.py's float64 model (pwelch_regs_model: the frames as the
kernel loads them, K11's halo source chosen per sample, K3's packed
half-length passes and split from ops/cuda_fft.py, the masked power sums
in the kernel's frame-to-slot-to-warp order) and ops/cuda_csd.py's
(csd_regs_model: the same for two signals and conj(X) Y) against the
float64 plain versions at <= 1e-12 relative, at every pad 2..16384, odd
hops (1, 3, 255), hop 160 with pad 2048, nfft < pad and odd, a ragged
last tile, a partial mask, rows > 1 and a halo whose pair straddles the
block's end; the models rounded to float32 against godsp_tpu's
pwelch_power_partials, csd_power_partials and pwelch_power_partials_rdma
in interpret mode at >= 100 dB (tests/test_pallas.py's bound); the models
in place of the kernels under the port's public pwelch, csd, coherence,
welch, welch_csd, welch_coherence and pwelch_sharded (the fused-halo
route) against godsp_tpu in float64 at go-dsp's 1e-8 (pretty_close); the
CTA shape (partials_cta); the banks of every warp access of the
fixed-order sum of a CTA's segments (store_partials) and of K7's
hand-over of half its bins between a segment's two frames (one word a
bank); and the radix-2 yardsticks
pwelch_radix2 and csd_radix2 on CPU tensors being the plain versions.
The kernels themselves run in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godsp_tpu import spectral as jspec
from godsp_tpu import window as jwin
from godsp_tpu_torch import default_device, dsputils, parallel, set_default_device, spectral
from godsp_tpu_torch.ops import (
    cuda_csd,
    cuda_fft,
    cuda_fused_halo,
    cuda_probes,
    cuda_pwelch,
    launch_counts,
)
from godsp_tpu_torch.parallel import _pwelch_sharded_impl as sharded
from godsp_tpu_torch.spectral import _pwelch_impl

PADS = [1 << k for k in range(1, 15)]
REL = 1e-12  # model vs plain version, both float64
SNR_KERNEL_DB = 100.0  # float32-rounded model vs the interpret-mode JAX kernel
SEGS = 41  # segments a row in the sweep


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


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _geometries(pad):
    """(nfft, hop) cases at pad: the full frame at a quarter hop, nfft odd
    below pad at hops 1 and 3, just over half the frame at hop 255."""
    odd = max(1, pad - 1)
    return sorted({(pad, max(1, pad // 4)), (odd, 3), (odd, 1), (max(1, pad // 2 + 1), 255)})


def _case(pad, nfft, hop, rows, S, seed):
    """rows x (S segments and nfft - hop more samples), a window zero past
    nfft, and a partial mask (a masked run at the end, others at random)."""
    rng = np.random.default_rng(seed)
    sig = rng.normal(size=(rows, S * hop + nfft))
    w = np.zeros(pad)
    w[:nfft] = rng.normal(size=nfft)
    mask = ((rng.random((rows, S)) < 0.8) & (np.arange(S) < S - 2)).astype(np.float64)
    return sig, w, mask


def _plain_k4(ext, mask, w, nfft, hop, pad):
    bt = cuda_pwelch.segs_per_tile(mask.shape[-1], int(np.prod(mask.shape[:-1])))
    return _np(cuda_pwelch.pwelch_power_partials_plain(_t(ext), _t(mask), _t(w), nfft, hop, pad,
                                                       bt))


def _plain_k7(x, y, mask, w, nfft, hop, pad):
    bt = cuda_pwelch.segs_per_tile(mask.shape[-1], int(np.prod(mask.shape[:-1])))
    re, im = cuda_csd.csd_power_partials_plain(_t(x), _t(y), _t(mask), _t(w), nfft, hop, pad, bt)
    return _np(re) + 1j * _np(im)


# ---------------------------------------------------------------- the models


@pytest.mark.parametrize("pad", PADS)
def test_pwelch_model_is_the_plain_version(pad):
    for nfft, hop in _geometries(pad):
        sig, w, mask = _case(pad, nfft, hop, 3, SEGS, pad + hop)
        got = cuda_pwelch.pwelch_regs_model(sig, mask, w, nfft, hop, pad)
        want = _plain_k4(sig, mask, w, nfft, hop, pad)
        assert got.shape == want.shape
        assert _rel(got, want) <= REL, (nfft, hop)


@pytest.mark.parametrize("pad", PADS)
def test_halo_model_is_the_plain_version(pad):
    """K11: the block ends inside a pair (odd L - a) for some frames, and
    the last frames read past the halo source (zeros)."""
    for nfft, hop in _geometries(pad):
        sig, w, mask = _case(pad, nfft, hop, 2, SEGS, 2 * pad + hop)
        L = SEGS * hop - (hop % 2 == 0)  # odd hop: L - s * hop odd at odd SEGS - s
        x, h = sig[:, :L], sig[:, L:L + max(0, nfft - hop - 1)]
        got = cuda_pwelch.pwelch_regs_model(x, mask, w, nfft, hop, pad, halo=h)
        want = _np(cuda_fused_halo.pwelch_power_partials_halo_plain(
            _t(x), _t(h), _t(mask), _t(w), nfft, hop, pad,
            cuda_pwelch.segs_per_tile(SEGS, 2)))
        assert got.shape == want.shape
        assert _rel(got, want) <= REL, (nfft, hop)
        shared = cuda_pwelch.pwelch_regs_model(x, mask[0], w, nfft, hop, pad, halo=h)
        assert _rel(shared, cuda_pwelch.pwelch_regs_model(x, np.stack([mask[0]] * 2), w, nfft,
                                                          hop, pad, halo=h)) == 0.0


@pytest.mark.parametrize("pad", PADS)
def test_csd_model_is_the_plain_version(pad):
    for nfft, hop in _geometries(pad):
        sig, w, mask = _case(pad, nfft, hop, 2, SEGS, 3 * pad + hop)
        y = 0.3 * np.roll(sig, 5, axis=-1) + sig[:, ::-1]
        re, im = cuda_csd.csd_regs_model(sig, y, mask, w, nfft, hop, pad)
        want = _plain_k7(sig, y, mask, w, nfft, hop, pad)
        assert re.shape == im.shape == want.shape
        assert _rel(re + 1j * im, want) <= REL, (nfft, hop)


@pytest.mark.parametrize("nfft", [1000, 2048])
def test_models_at_hop_160_pad_2048(nfft):
    """The speech hop: 160 = 32 x 5, so a frame starts at every phase mod 32;
    701 segments on two rows make two segments a tile, the last ragged."""
    pad, hop, S = 2048, 160, 701
    sig, w, mask = _case(pad, nfft, hop, 2, S, nfft)
    assert S % cuda_pwelch.segs_per_tile(S, 2)
    got = cuda_pwelch.pwelch_regs_model(sig, mask, w, nfft, hop, pad)
    assert _rel(got, _plain_k4(sig, mask, w, nfft, hop, pad)) <= REL
    y = np.roll(sig, 37, axis=-1)
    re, im = cuda_csd.csd_regs_model(sig, y, mask, w, nfft, hop, pad)
    assert _rel(re + 1j * im, _plain_k7(sig, y, mask, w, nfft, hop, pad)) <= REL


@pytest.mark.parametrize("pad,S,rows", [(1024, 2113, 1), (256, 3001, 1), (64, 5001, 2),
                                        (4096, 2113, 1), (128, 70_001, 1)])
def test_models_over_many_tiles(pad, S, rows):
    """Tiles of several segments, up to 64: eight warps' frames a CTA taking
    them in turn (Q frames a warp at pad 64, 128 and 256, one frame a CTA
    at 4096), a ragged last tile, leading axes kept."""
    nfft, hop = pad - 3, max(1, pad // 3)
    sig, w, mask = _case(pad, nfft, hop, rows, S, S)
    bt = cuda_pwelch.segs_per_tile(S, rows)
    assert bt > 1 and S % bt
    got = cuda_pwelch.pwelch_regs_model(sig.reshape(rows, 1, -1), mask.reshape(rows, 1, S), w,
                                        nfft, hop, pad)
    want = _plain_k4(sig, mask, w, nfft, hop, pad)
    assert got.shape == (rows, 1) + want.shape[1:]
    assert _rel(got.reshape(want.shape), want) <= REL
    re, im = cuda_csd.csd_regs_model(sig, sig[:, ::-1], mask, w, nfft, hop, pad)
    assert _rel(re + 1j * im, _plain_k7(sig, sig[:, ::-1], mask, w, nfft, hop, pad)) <= REL


@pytest.mark.parametrize("pad", [2, 4])
def test_models_at_edge_pads(pad):
    """pad = 2 (one pair a frame: no pass, the split alone) and pad = 4 (one
    radix-2 pass) against numpy's rfft of the frames."""
    x = np.arange(1.0, 2 * 15 + 1).reshape(2, 15)
    w = np.linspace(0.5, 1.5, pad)
    S = 15 - pad + 1
    frames = np.stack([x[:, s:s + pad] * w for s in range(S)], axis=1)
    X = np.fft.rfft(frames)
    mask = np.ones((2, S))
    got = cuda_pwelch.pwelch_regs_model(x, mask, w, pad, 1, pad).sum(axis=-2)
    np.testing.assert_allclose(got, (np.abs(X) ** 2).sum(axis=1), rtol=1e-13)
    re, im = cuda_csd.csd_regs_model(x, x[::-1], mask, w, pad, 1, pad)
    np.testing.assert_allclose(re.sum(axis=-2) + 1j * im.sum(axis=-2),
                               (np.conj(X) * X[::-1]).sum(axis=1), rtol=1e-13, atol=1e-11)


def test_partials_model_sums_in_the_kernels_order():
    """partials_model is a sum over each tile whatever its order; at pad
    256 (Q = 4 frames a warp, 32 slots) its butterfly and warp order give
    each tile's sum, and a frame with mask 0 adds nothing."""
    rng = np.random.default_rng(3)
    S, bt = 200, 64
    p = rng.random((2, S, 5))
    mask = (rng.random((2, S)) < 0.7).astype(np.float64)
    got = cuda_pwelch.partials_model(p, mask, 256, bt)
    pad_to = -(-S // bt) * bt
    mp = np.concatenate([mask[..., None] * p, np.zeros((2, pad_to - S, 5))], axis=1)
    want = mp.reshape(2, -1, bt, 5).sum(axis=2)
    np.testing.assert_allclose(got, want, rtol=1e-14)


def test_partials_cta():
    """Frames a CTA: eight warps' (8 Q) at most, whole warps enough for a
    tile of fewer segments, one at pad >= 4096; threads and slots as
    cuda_fft.cta_shape gives them."""
    assert cuda_pwelch.partials_cta(1024, 16384, 32) == (8, 256, 8)
    assert cuda_pwelch.partials_cta(1024, 256, 1) == (1, 32, 1)
    assert cuda_pwelch.partials_cta(1024, 7, 64) == (7, 224, 7)
    assert cuda_pwelch.partials_cta(256, 256, 1) == (4, 32, 4)  # Q = 4 frames a warp
    assert cuda_pwelch.partials_cta(256, 5000, 10) == (12, 96, 12)
    assert cuda_pwelch.partials_cta(256, 50_000, 64) == (32, 256, 32)
    assert cuda_pwelch.partials_cta(32, 7, 64) == (32, 32, 32)  # a thread a frame
    for pad in (4096, 16384):
        assert cuda_pwelch.partials_cta(pad, 9000, 64) == (1, pad // 32, 1)
    # K7: two frames a segment, four warp pairs a CTA at most.
    assert cuda_pwelch.partials_cta(1024, 51_678, 64, 2) == (4, 256, 8)
    assert cuda_pwelch.partials_cta(1024, 256, 1, 2) == (1, 64, 2)
    assert cuda_pwelch.partials_cta(256, 50_000, 64, 2) == (16, 256, 32)
    assert cuda_pwelch.partials_cta(16384, 9000, 64, 2) == (1, 1024, 2)
    for pad in PADS:
        g = cuda_fft.geometry(pad // 2)
        for frames in (1, 2):
            fpc, threads, slots = cuda_pwelch.partials_cta(pad, 100_000, 64, frames)
            assert threads <= 1024 and slots >= frames * fpc
            assert slots * (pad // 2) * 8 + 4 * slots + 8 * (pad // 2 + 1) <= cuda_fft.MAX_SMEM


# ---------------------------------------------------------------- against godsp_tpu


@pytest.mark.parametrize("nfft,stride,pad", [(256, 128, 256), (256, 160, 256), (128, 64, 512)],
                         ids=["hop128", "hop160", "pad512"])
def test_models_vs_jax_kernels(nfft, stride, pad):
    """pwelch_regs_model and csd_regs_model rounded to float32 against
    pallas_pwelch.pwelch_power_partials and pallas_csd.csd_power_partials
    in interpret mode, summed over tiles (only that sum is contractual)."""
    from godsp_tpu.ops.pallas_csd import csd_power_partials
    from godsp_tpu.ops.pallas_pwelch import digit_to_natural_bins, pwelch_power_partials

    S = 12
    rng = np.random.default_rng(nfft + stride + pad)
    x = rng.normal(size=(S - 1) * stride + nfft).astype(np.float32)
    y = (0.5 * np.roll(x, 7) + 0.5 * rng.normal(size=x.size)).astype(np.float32)
    mask = (np.arange(S) < 10).astype(np.float32)
    mask[2] = 0.0
    w = jwin.window_table_np("hann", pad).astype(np.float32)
    lp = pad // 2 + 1

    def natural(t):
        return np.asarray(digit_to_natural_bins(t.sum(axis=-2), pad), np.float64)[..., :lp]

    want = natural(pwelch_power_partials(jnp.asarray(x), jnp.asarray(mask), jnp.asarray(w), nfft,
                                         stride, pad=pad, interpret=True))
    got = cuda_pwelch.pwelch_regs_model(x, mask, w, nfft, stride, pad).astype(np.float32)
    assert dsputils.snr_db(got.sum(axis=-2).astype(np.float64), want) >= SNR_KERNEL_DB
    jre, jim = csd_power_partials(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask),
                                  jnp.asarray(w), nfft, stride, pad=pad, interpret=True)
    re, im = cuda_csd.csd_regs_model(x, y, mask, w, nfft, stride, pad)
    got = (re.astype(np.float32).sum(axis=-2).astype(np.float64)
           + 1j * im.astype(np.float32).sum(axis=-2))
    assert dsputils.snr_db(got, natural(jre) + 1j * natural(jim)) >= SNR_KERNEL_DB


def test_halo_model_vs_jax_rdma_kernel(monkeypatch):
    """pwelch_regs_model with halo, rounded to float32, against
    fused_halo.pwelch_power_partials_rdma in interpret mode on eight shards
    of godsp_tpu's virtual CPU mesh (a one-named-axis mesh, lane-slice FFT
    off, as tests/test_parallel.py runs it): each shard's halo is its right
    neighbour's block, the last shard's the injected tail."""
    from jax.sharding import Mesh as JMesh
    from jax.sharding import PartitionSpec as P

    from godsp_tpu.ops import pallas_fft
    from godsp_tpu.ops.pallas_pwelch import digit_to_natural_bins
    from godsp_tpu.parallel.fused_halo import pwelch_power_partials_rdma

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    monkeypatch.setattr(pallas_fft, "_ls_enabled", False)
    n_sp, nfft, stride, pad, S = 8, 256, 128, 256, 16
    L = S * stride
    rng = np.random.default_rng(16)
    x = rng.normal(size=n_sp * L).astype(np.float32)
    tail = rng.normal(size=nfft - stride).astype(np.float32)
    mask = np.ones((n_sp, S), np.float32)
    mask[3, 5] = 0.0
    w = jwin.window_table_np("hann", pad).astype(np.float32)
    mesh = JMesh(np.array(jax.devices()[:n_sp]), ("sp",))
    fn = jax.jit(jax.shard_map(
        lambda xl, ml, tl: pwelch_power_partials_rdma(xl, ml, jnp.asarray(w), nfft, stride, n_sp,
                                                      pad=pad, tail=tl, interpret=True),
        mesh=mesh, in_specs=(P("sp"), P("sp"), P()), out_specs=P("sp"), check_vma=False))
    parts = np.asarray(fn(jnp.asarray(x), jnp.asarray(mask.reshape(-1)), jnp.asarray(tail)))
    parts = parts.reshape(n_sp, -1, pad)
    lp = pad // 2 + 1
    blocks = x.reshape(n_sp, L)
    for k in range(n_sp):
        want = np.asarray(digit_to_natural_bins(parts[k].sum(axis=0), pad), np.float64)[:lp]
        halo = tail if k == n_sp - 1 else blocks[k + 1, :nfft - stride]
        got = cuda_pwelch.pwelch_regs_model(blocks[k], mask[k], w, nfft, stride, pad, halo=halo)
        got = got.astype(np.float32).sum(axis=-2).astype(np.float64)
        assert dsputils.snr_db(got, want) >= SNR_KERNEL_DB, k


@pytest.fixture
def model_route(monkeypatch):
    """The fused routes on CPU tensors, with the float64 models in place of
    K4, K7 and K11 (so the public entry points run the kernels'
    arithmetic); counts the calls."""
    calls = {}

    def count(name):
        calls[name] = calls.get(name, 0) + 1

    def k4(ext, mask, w, nfft, stride, pad=None):
        count("pwelch_power_partials")
        return _t(cuda_pwelch.pwelch_regs_model(_np(ext), _np(mask), _np(w), nfft, stride, pad))

    def k7(ext_x, ext_y, mask, w, nfft, stride, pad=None):
        count("csd_power_partials")
        re, im = cuda_csd.csd_regs_model(_np(ext_x), _np(ext_y), _np(mask), _np(w), nfft, stride,
                                         pad)
        return _t(re), _t(im)

    def k11(x, halo_src, mask, w, nfft, stride, pad=None):
        count("pwelch_power_partials_halo")
        return _t(cuda_pwelch.pwelch_regs_model(_np(x), _np(mask), _np(w), nfft, stride, pad,
                                                halo=_np(halo_src)))

    monkeypatch.setattr(cuda_pwelch, "pwelch_power_partials", k4)
    monkeypatch.setattr(cuda_csd, "csd_power_partials", k7)
    monkeypatch.setattr(cuda_fused_halo, "pwelch_power_partials_halo", k11)
    eligible = lambda x, nfft, pad, stride: cuda_pwelch.fused_supported(nfft, pad, stride)
    for mod in (_pwelch_impl, sharded):
        monkeypatch.setattr(mod, "fused_path_eligible", eligible)
    return calls


def _pair(n, seed, shape=()):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = np.sin(2 * np.pi * 0.03 * t) + 0.5 * rng.normal(size=shape + (n,))
    return x, 0.7 * np.roll(x, 3, axis=-1) + 0.4 * rng.normal(size=shape + (n,))


def _close(got, want):
    return dsputils.pretty_close(_np(got), np.asarray(want))


@pytest.mark.parametrize("kw", [dict(nfft=256, noverlap=128), dict(nfft=256, noverlap=96),
                                dict(nfft=128, pad=512, noverlap=64),
                                dict(nfft=1000, noverlap=840, pad=1024)],
                         ids=["hop128", "hop160", "pad512", "nfft1000_hop160"])
def test_models_under_pwelch_csd_coherence_vs_godsp_tpu(model_route, kw):
    x, y = _pair(6000, seed=len(kw), shape=(2,))
    o, jo = spectral.PwelchOptions(**kw), jspec.PwelchOptions(**kw)
    assert _close(spectral.pwelch(x, 8000.0, o)[0], jspec.pwelch(x, 8000.0, jo)[0])
    assert _close(spectral.csd(x, y, 8000.0, o)[0], jspec.csd(x, y, 8000.0, jo)[0])
    assert _close(spectral.coherence(x, y, 8000.0, o)[0], jspec.coherence(x, y, 8000.0, jo)[0])
    assert model_route == {"pwelch_power_partials": 3, "csd_power_partials": 2}


@pytest.mark.parametrize("kw", [dict(nperseg=256), dict(nperseg=256, noverlap=100),
                                dict(nperseg=200, nfft=256, noverlap=40)],
                         ids=["hop128", "hop156", "nperseg200_nfft256"])
def test_models_under_scipy_welch_vs_godsp_tpu(model_route, kw):
    kw = dict(kw, detrend=False)
    x, y = _pair(5000, seed=3)
    xb, yb = np.stack([x, y]), np.stack([y, x])
    assert _close(spectral.welch(xb, fs=3.0, **kw)[1], jspec.welch(xb, fs=3.0, **kw)[1])
    assert _close(spectral.welch_csd(xb, yb, fs=3.0, **kw)[1],
                  jspec.welch_csd(xb, yb, fs=3.0, **kw)[1])
    assert _close(spectral.welch_coherence(xb, yb, fs=3.0, **kw)[1],
                  jspec.welch_coherence(xb, yb, fs=3.0, **kw)[1])
    assert model_route == {"pwelch_power_partials": 3, "csd_power_partials": 2}


@pytest.mark.parametrize("kw,dp,sp", [(dict(nfft=256, noverlap=128), 1, 8),
                                      (dict(nfft=256, noverlap=96), 1, 8),
                                      (dict(nfft=128, noverlap=64), 2, 4)],
                         ids=["hop128", "hop160", "dp2_sp4"])
def test_halo_model_under_pwelch_sharded_vs_godsp_tpu(model_route, kw, dp, sp):
    """pwelch_sharded's fused-halo route (K11 once a shard of the dp x sp
    mesh) with the model
    in place of K11, against godsp_tpu's one-device pwelch."""
    stride = kw["nfft"] - kw["noverlap"]
    x, _ = _pair(sp * stride * 24, seed=dp + sp, shape=(dp,) if dp > 1 else ())
    o, jo = spectral.PwelchOptions(**kw), jspec.PwelchOptions(**kw)
    mesh = parallel.make_mesh(parallel.MeshConfig(dp=dp, sp=sp), devices=["cpu"] * (dp * sp))
    got, _ = parallel.pwelch_sharded(_t(x), 2.0, o, mesh, halo_impl=("fused", False))
    assert _close(got, jspec.pwelch(x, 2.0, jo)[0])
    assert model_route == {"pwelch_power_partials_halo": dp * sp}


# ---------------------------------------------------------------- shared memory


def _warp_degree(lanes):
    """Most distinct 32-bit words sharing a bank in one warp access."""
    lanes = lanes[lanes >= 0]
    if len(lanes) == 0:
        return 0
    return int(np.bincount(np.unique(lanes) % 32, minlength=32).max())


def _reduce_accesses(pad, fpc, frames):
    """Every warp access of store_partials in a warp-route CTA of fpc
    segments of `frames` frames (K4: 1, K7: 2), as the 32 lanes' words
    (-1: idle): the writes of each group's partials (K4: a warp's, every
    bin; K7: a warp pair's, the x warp the bins of registers i < H and bin
    m, the y warp the rest) by each warp's first slot's T lanes (bin t + c
    T of register c), then the reads, bin k by thread k + j (threads),
    each group's run in turn; none in a CTA of one group."""
    m = pad // 2
    g = cuda_fft.geometry(m)
    threads, _ = cuda_fft.cta_shape(m, frames * fpc)
    if threads // 32 // frames == 1:
        return []  # one group: its lanes store straight to device memory
    tid = np.arange(threads)
    warp, lane, t = tid // 32, tid % 32, tid % g.threads
    group, is_y = warp // frames, (warp % frames) == 1
    first = lane < g.threads
    half = (g.points + 1) // 2
    acc = []
    for i, c in enumerate(cuda_fft.out_index(m)):
        mine = ~is_y if frames == 1 else ((i < half) != is_y)
        acc.append(np.where(first & mine, cuda_pwelch.reduce_word(pad, group, t + c * g.threads),
                            -1))
    acc.append(np.where(first & ~is_y & (t == 0), cuda_pwelch.reduce_word(pad, group, m), -1))
    for j in range(-(-(m + 1) // threads)):
        k = tid + j * threads
        for gp in range(threads // 32 // frames):
            acc.append(np.where(k <= m, cuda_pwelch.reduce_word(pad, gp, k), -1))
    return [a[32 * w:32 * (w + 1)] for a in acc for w in range(threads // 32)]


def _partner_accesses(pad, fpc):
    """Every warp access of K7's hand-over: the x frame's lanes put their
    registers i >= H, the y frame's their registers i < H, each at bin t +
    c T of its own slot (partner_word), and the partner reads the same
    words."""
    m = pad // 2
    g = cuda_fft.geometry(m)
    threads, _ = cuda_fft.cta_shape(m, 2 * fpc)
    tid = np.arange(threads)
    slot, t = tid // g.threads, tid % g.threads
    is_y = (slot // g.q) % 2 == 1
    half = (g.points + 1) // 2
    acc = []
    for i, c in enumerate(cuda_fft.out_index(m)):
        k = t + c * g.threads
        put = (i < half) == is_y  # this frame's value the partner sums
        acc.append(np.where(put, cuda_csd.partner_word(pad, slot, k), -1))
        acc.append(np.where(~put, cuda_csd.partner_word(pad, slot ^ g.q, k), -1))  # the read
    return [a[32 * w:32 * (w + 1)] for a in acc for w in range(threads // 32)]


def _sum_accesses(pad, fpc):
    """Every warp access of K7's sums where they live in shared memory:
    lane t of the x (y) frame of segment slot seg reads and writes bin t +
    c T of its registers c < H (>= H) at sum_word(seg, k)."""
    m = pad // 2
    g = cuda_fft.geometry(m)
    threads, _ = cuda_fft.cta_shape(m, 2 * fpc)
    tid = np.arange(threads)
    slot, t = tid // g.threads, tid % g.threads
    side = g.q if g.warp else 1
    is_y = (slot // side) % 2 == 1
    seg = (slot // (2 * side)) * side + slot % side
    half = (g.points + 1) // 2
    return [np.where((i < half) != is_y, cuda_csd.sum_word(pad, seg, t + c * g.threads), -1)
            [32 * w:32 * (w + 1)]
            for i, c in enumerate(cuda_fft.out_index(m)) for w in range(threads // 32)]


@pytest.mark.parametrize("pad", PADS)
def test_store_partials_and_k7_hand_over_are_free_of_bank_conflicts(pad):
    """Each warp access of the fixed-order sum of a CTA's segments (K4 and
    K7), of K7's hand-over of half its bins and of its sums where they
    live in shared memory touches each bank at most once, at the default
    CTA and at smaller ones."""
    g = cuda_fft.geometry(pad // 2)
    for frames in (1, 2):
        most = g.default_rows // frames if g.warp else 1
        for fpc in sorted({most, g.q if g.warp else 1, min(most, 3 * g.q)}):
            accesses = _reduce_accesses(pad, fpc, frames) if g.warp else []
            if frames == 2:
                accesses += _partner_accesses(pad, fpc)
                if cuda_csd.sums_in_smem(pad):
                    accesses += _sum_accesses(pad, fpc)
            assert max([_warp_degree(a) for a in accesses] + [0]) <= 1, (frames, fpc)


def test_k7_sum_words_lay_out_the_segment_slots():
    """Where K7's sums live in shared memory, every segment slot's m + 1
    sums take distinct words inside the slots x (m + 1) a plane that the
    launch sizes (the CTA's slots count both frames)."""
    for pad in PADS:
        if not cuda_csd.sums_in_smem(pad):
            continue
        m = pad // 2
        fpc, _, slots = cuda_pwelch.partials_cta(pad, 100_000, 64, 2)
        seg, k = np.meshgrid(np.arange(slots // 2), np.arange(m + 1), indexing="ij")
        words = cuda_csd.sum_word(pad, seg, k)
        assert len(np.unique(words)) == (slots // 2) * (m + 1)
        assert words.max() < (slots // 2) * (m + 1)


@pytest.mark.parametrize("pad", PADS)
def test_k7_hand_over_words_lay_out_the_slots(pad):
    """Each frame's hand-over takes distinct words of its own slot, inside
    the exchange the launch sizes, and each group's partials in
    store_partials fit the exchange words they reuse."""
    m = pad // 2
    for frames in (1, 2):
        fpc, threads, slots = cuda_pwelch.partials_cta(pad, 100_000, 64, frames)
        assert slots == frames * (fpc if not cuda_fft.geometry(m).warp
                                  else -(-fpc // cuda_fft.geometry(m).q) * cuda_fft.geometry(m).q)
        sl, k = np.meshgrid(np.arange(slots), np.arange(m), indexing="ij")
        words = cuda_csd.partner_word(pad, sl, k)
        assert len(np.unique(words)) == slots * m and words.max() < slots * m
        if cuda_fft.geometry(m).warp:
            groups = threads // 32 // frames
            assert cuda_pwelch.reduce_word(pad, groups - 1, m) < 2 * slots * m


# ---------------------------------------------------------------- the yardsticks on the CPU


def test_radix2_pwelch_csd_yardsticks_on_cpu_are_the_plain_versions():
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.normal(size=(2, 9000)).astype(np.float32))
    y = torch.flip(x, (-1,))
    w = torch.from_numpy(np.hanning(512).astype(np.float32))
    mask = torch.ones(2, 40)
    before = dict(launch_counts())
    got = cuda_probes.pwelch_radix2(x, mask, w, 400, 160, 512)
    bt = cuda_pwelch.segs_per_tile(40, 2)
    assert torch.equal(got, cuda_pwelch.pwelch_power_partials_plain(x, mask, w, 400, 160, 512,
                                                                    bt))
    got = cuda_probes.csd_radix2(x, y, mask, w, 400, 160, 512)
    want = cuda_csd.csd_power_partials_plain(x, y, mask, w, 400, 160, 512, bt)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert launch_counts() == before  # CPU tensors never launch
    with pytest.raises(ValueError):
        cuda_probes.pwelch_radix2(x, mask, w, 400, 160, 256)  # pad < nfft
    with pytest.raises(ValueError):
        cuda_probes.csd_radix2(x, y[:, :100], mask, w, 400, 160, 512)  # shapes differ
