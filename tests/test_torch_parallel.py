"""The port's mesh-sharded paths, held to godsp_tpu on its 8-device mesh.

godsp_tpu runs on the virtual 8-device CPU mesh of tests/conftest.py; the
port on a mesh of eight "cpu" entries (one controller, one device
repeated).  CPU float64 at go-dsp's 1e-8 abs-or-rel bound
(dsputils/compare.py), and exact equality for the halo copies.  The
`kernels_on_cpu` fixture routes CPU tensors through the fused branches,
where the K4/K5/K6/K10/K11 wrappers run their plain versions, and counts
each wrapper's calls.  The path on the card is in tests/test_torch_cuda.py.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from godsp_tpu import models as jmodels
from godsp_tpu import spectral as jspec
from godsp_tpu import parallel as jpar
from godsp_tpu.models.pipeline import wav_psd as jwav_psd
from godsp_tpu_torch import default_device, dsputils, models, set_default_device, spectral, wav
from godsp_tpu_torch import parallel
from godsp_tpu_torch.ops import cuda_fused_halo, cuda_halo, cuda_istft, cuda_pwelch, cuda_stft
from godsp_tpu_torch.parallel import _pwelch_sharded_impl as sharded
from godsp_tpu_torch.parallel import stft_sharded
from godsp_tpu_torch.spectral import _pwelch_impl

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

ROUTES = ("ppermute", "pallas", "fused")


@pytest.fixture(autouse=True)
def _host_data_on_cpu():
    """Host data goes to the CPU here; the port's default device is the card."""
    old = default_device()
    set_default_device("cpu")
    yield
    set_default_device(old)


@pytest.fixture
def kernels_on_cpu(monkeypatch):
    """Route CPU tensors through the fused branches (the wrappers then run
    their plain versions) and count each wrapper's calls."""
    calls = {}

    def spy(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)

        monkeypatch.setattr(mod, name, wrapped)

    spy(cuda_pwelch, "pwelch_power_partials")
    spy(cuda_halo, "ring_halo")
    spy(cuda_fused_halo, "pwelch_power_partials_halo")
    spy(cuda_stft, "stft_power")
    spy(cuda_istft, "istft_overlap_add")
    eligible = lambda x, nfft, pad, stride: cuda_pwelch.fused_supported(nfft, pad, stride)
    for mod in (_pwelch_impl, sharded, stft_sharded):
        monkeypatch.setattr(mod, "fused_path_eligible", eligible)
    monkeypatch.setattr(stft_sharded, "_istft_fused_eligible",
                        lambda s, nfft, pad, hop: cuda_istft.istft_supported(nfft, pad, hop))
    return calls


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want) -> bool:
    return dsputils.pretty_close(_np(got), np.asarray(want))


def _signal(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return np.sin(2 * np.pi * 0.01 * t) + 0.5 * np.sin(2 * np.pi * 0.1 * t) + rng.normal(size=n)


def _mesh(dp=1, sp=8):
    return parallel.make_mesh(parallel.MeshConfig(dp=dp, sp=sp), devices=["cpu"] * (dp * sp))


def _jmesh(dp=1, sp=8):
    return jpar.make_mesh(jpar.MeshConfig(dp=dp, sp=sp))


def _expected_calls(route, rings, sp, calls):
    """Whether the wrappers called match the route over `rings` rings of
    `sp` shards (one ring a dp row and step): K4 once a shard, K10 once a
    ring, or K11 alone once a shard."""
    want = {"ppermute": {"pwelch_power_partials": rings * sp},
            "pallas": {"pwelch_power_partials": rings * sp, "ring_halo": rings},
            "fused": {"pwelch_power_partials_halo": rings * sp}}[route]
    return {k: v for k, v in calls.items() if v} == want


# ---------------------------------------------------------------- pwelch_sharded

# name: (options, dp, sp, batch, signal length)
SHARDED_CASES = {
    "noverlap0": (dict(nfft=256, noverlap=0), 1, 8, 0, 8 * 256 * 16),
    "noverlap64": (dict(nfft=256, noverlap=64), 1, 8, 0, 8 * 192 * 16),
    "noverlap128": (dict(nfft=256, noverlap=128), 1, 8, 0, 8 * 128 * 16),
    "noverlap255": (dict(nfft=256, noverlap=255), 1, 8, 0, 8 * 1 * 256),
    "dp2_sp4_batch": (dict(nfft=128, noverlap=64), 2, 4, 2, 4 * 64 * 32),
    "pad_gt_nfft": (dict(nfft=128, pad=256, noverlap=0), 1, 8, 0, 8 * 128 * 4),
    "pad_lt_nfft": (dict(nfft=256, pad=128, noverlap=128), 1, 8, 0, 8 * 128 * 16),
    "tail_mask": (dict(nfft=512, noverlap=384), 1, 8, 0, 8 * 128 * 8),
    "multichannel": (dict(nfft=256, noverlap=128), 1, 8, 3, 8 * 128 * 16),
}


def _sharded_input(case):
    _, _, _, batch, L = SHARDED_CASES[case]
    if batch:
        return np.stack([_signal(L, seed=20 + c) for c in range(batch)])
    return _signal(L)


@lru_cache(maxsize=None)
def _jax_sharded(case):
    opts, dp, sp, _, _ = SHARDED_CASES[case]
    p, f = jpar.pwelch_sharded(jnp.asarray(_sharded_input(case)), 2.0,
                               jspec.PwelchOptions(**opts), _jmesh(dp, sp))
    return np.asarray(p), np.asarray(f)


@pytest.mark.parametrize("route", ("frames",) + ROUTES)
@pytest.mark.parametrize("case", sorted(SHARDED_CASES))
def test_pwelch_sharded_matches_jax(request, case, route):
    opts, dp, sp, _, _ = SHARDED_CASES[case]
    calls = request.getfixturevalue("kernels_on_cpu") if route != "frames" else None
    x = torch.from_numpy(_sharded_input(case))
    p, f = parallel.pwelch_sharded(x, 2.0, spectral.PwelchOptions(**opts), _mesh(dp, sp),
                                   halo_impl=("ppermute" if route == "frames" else route, False))
    jp, jf = _jax_sharded(case)
    assert p.shape == jp.shape
    assert _close(p, jp) and _close(f, jf)
    if calls is not None and opts.get("noverlap", 0) > 0:
        assert _expected_calls(route, dp, sp, calls), calls


def test_pwelch_sharded_errors():
    mesh = _mesh()
    with pytest.raises(ValueError, match="divisible"):
        parallel.pwelch_sharded(np.ones(1000), 1.0, spectral.PwelchOptions(nfft=256), mesh)
    with pytest.raises(ValueError, match="halo"):
        # 8 shard blocks of 160 samples cannot hold a 240-sample halo
        parallel.pwelch_sharded(np.ones(8 * 16 * 10), 1.0,
                                spectral.PwelchOptions(nfft=256, noverlap=240), mesh)
    with pytest.raises(ValueError, match="halo_impl"):
        parallel.pwelch_sharded(np.ones(8 * 256), 1.0, spectral.PwelchOptions(nfft=256), mesh,
                                halo_impl=("rdma", False))


# ---------------------------------------------------------------- K10 ring halo


def _jax_ring(x, n_sp, H):
    mesh = JMesh(np.array(jax.devices()[:n_sp]), ("sp",))
    fn = jax.jit(jax.shard_map(
        lambda xl: jpar.ring_halo_pallas(xl, H, n_sp, has_dp=False, interpret=True),
        mesh=mesh, in_specs=P(*([None] * (x.ndim - 1)), "sp"),
        out_specs=P(*([None] * (x.ndim - 1)), "sp"), check_vma=False,
    ))
    return np.asarray(fn(jnp.asarray(x)))


@pytest.mark.parametrize("shape, n_sp, H", [((8 * 512,), 8, 96), ((3, 4 * 256), 4, 128)],
                         ids=["single_row", "batched_rows"])
def test_ring_halo_matches_jax(shape, n_sp, H):
    x = np.random.default_rng(n_sp).normal(size=shape).astype(np.float32)
    blocks = torch.from_numpy(x).chunk(n_sp, dim=-1)  # views with the signal's row stride
    got = torch.cat(cuda_halo.ring_halo(list(blocks), H), dim=-1)
    np.testing.assert_array_equal(_np(got), _jax_ring(x, n_sp, H))


def test_ring_halo_zero_halo_and_errors():
    blocks = list(torch.ones(2, 4 * 64).chunk(4, dim=-1))
    assert [tuple(b.shape) for b in cuda_halo.ring_halo(blocks, 0)] == [(2, 0)] * 4
    assert jpar.ring_halo_pallas(jnp.ones((2, 64)), 0, 4).shape == (2, 0)
    with pytest.raises(ValueError, match="halo"):
        cuda_halo.ring_halo(blocks, 65)
    with pytest.raises(ValueError, match="leading"):
        cuda_halo.ring_halo([torch.ones(2, 64), torch.ones(3, 64)], 8)
    with pytest.raises(ValueError, match="row stride"):
        cuda_halo.row_layout(torch.ones(4, 6, 8)[:, :3, :], "t")


def test_fused_halo_plain_reads_past_the_block():
    """K11's plain version equals K4's over the concatenated block + halo,
    with a 1-D mask for every row and a short tail zero-extended."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 3 * 160)))
    h = torch.from_numpy(rng.normal(size=(2, 300)))
    w = torch.from_numpy(np.hanning(1024))
    mask = (torch.arange(3) < 2).double()
    got = cuda_fused_halo.pwelch_power_partials_halo(x, h, mask, w, 1000, 160, pad=1024)
    ext = torch.cat([x, h, torch.zeros(2, 1000 - 160 - 300)], dim=-1)
    want = cuda_pwelch.pwelch_power_partials(ext, mask.expand(2, 3), w, 1000, 160, pad=1024)
    assert got.shape == want.shape and _close(got, want)


# ---------------------------------------------------------------- streaming


@lru_cache(maxsize=None)
def _jax_stream(L, seed, block, opts_items, segs):
    x = _signal(L, seed)
    pxx, freqs = jpar.stream_pwelch([x[i : i + block] for i in range(0, L, block)], 2.0,
                                    jspec.PwelchOptions(**dict(opts_items)), _jmesh(),
                                    segs_per_chunk_shard=segs)
    return pxx, freqs


@pytest.mark.parametrize("route", ROUTES)
def test_stream_pwelch_mesh_matches_oneshot_and_jax(kernels_on_cpu, route):
    opts = dict(nfft=256, noverlap=128)
    L, block = 100_000, 7777  # chunks end mid-segment; a ragged remainder
    x = _signal(L)
    blocks = [x[i : i + block] for i in range(0, L, block)]
    pxx, freqs = parallel.stream_pwelch(blocks, 2.0, spectral.PwelchOptions(**opts), _mesh(),
                                        segs_per_chunk_shard=8, halo_impl=(route, False))
    chunks = -(-(L - 128) // (8 * 8 * 128))  # full chunks and the remainder
    assert _expected_calls(route, chunks, 8, kernels_on_cpu), kernels_on_cpu
    jp, jf = _jax_stream(L, 0, block, tuple(opts.items()), 8)
    one, _ = spectral.pwelch(x, 2.0, spectral.PwelchOptions(**opts))
    assert _close(pxx, jp) and _close(freqs, jf) and _close(pxx, one)


def test_stream_pwelch_mesh_short_input():
    x = _signal(100)
    opts = dict(nfft=256)
    pxx, _ = parallel.stream_pwelch([x], 2.0, spectral.PwelchOptions(**opts), _mesh(),
                                    segs_per_chunk_shard=4)
    jp, _ = jpar.stream_pwelch([x], 2.0, jspec.PwelchOptions(**opts), _jmesh(),
                               segs_per_chunk_shard=4)
    assert pxx.shape == (129,) and _close(pxx, jp)


def _mc_signal(C, L, seed):
    return np.stack([_signal(L, seed=seed + c) for c in range(C)])


@pytest.mark.parametrize("layout", ["sp8_mono", "dp2_sp4_stereo"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_sharded_checkpoint_carries_across_packages(tmp_path, kernels_on_cpu, direction, layout):
    C, dp, sp = (1, 1, 8) if layout == "sp8_mono" else (2, 2, 4)
    opts = dict(nfft=128, noverlap=64)
    x = _mc_signal(C, 40_000, 10)
    ckpt = str(tmp_path / "state.npz")
    kw = dict(segs_per_chunk_shard=8, channels=C, checkpoint_path=ckpt,
              checkpoint_every_chunks=1)

    def make(which):
        if which == "jax":
            return jpar.StreamingPwelch(2.0, jspec.PwelchOptions(**opts), _jmesh(dp, sp), **kw)
        return parallel.StreamingPwelch(2.0, spectral.PwelchOptions(**opts), _mesh(dp, sp),
                                        halo_impl=("fused", False), **kw)

    first, second = ("jax", "port") if direction == "jax_to_port" else ("port", "jax")
    a = make(first)
    a.update(x[:, :20_000] if C > 1 else x[0, :20_000])
    assert a.metrics.chunks_done > 0
    b = make(second)  # restores from the other package's snapshot
    assert b.metrics.chunks_done == a.metrics.chunks_done
    already = b.metrics.chunks_done * b.chunk_len + len(b._bufs[0])
    b.update(x[:, already:] if C > 1 else x[0, already:])
    pxx, _ = b.finalize()
    pxx = np.asarray(pxx).reshape(C, -1)
    for c in range(C):
        want, _ = jspec.pwelch(jnp.asarray(x[c]), 2.0, jspec.PwelchOptions(**opts))
        assert _close(pxx[c], want)


def test_channels_over_dp_match_jax():
    opts = dict(nfft=256, noverlap=128)
    C, L = 4, 50_000
    x = _mc_signal(C, L, 0)
    got = parallel.StreamingPwelch(2.0, spectral.PwelchOptions(**opts), _mesh(2, 4),
                                   segs_per_chunk_shard=8, channels=C)
    want = jpar.StreamingPwelch(2.0, jspec.PwelchOptions(**opts), _jmesh(2, 4),
                                segs_per_chunk_shard=8, channels=C)
    for i in range(0, L, 9999):
        got.update(x[:, i : i + 9999])
        want.update(x[:, i : i + 9999])
    pxx, _ = got.finalize()
    assert pxx.shape == (C, 129) and _close(pxx, want.finalize()[0])


def test_channel_shape_errors_and_metrics():
    sp = parallel.StreamingPwelch(1.0, spectral.PwelchOptions(nfft=128), _mesh(),
                                  segs_per_chunk_shard=4, channels=3)
    with pytest.raises(ValueError, match="expected"):
        sp.update(np.zeros(100))
    with pytest.raises(ValueError, match="channels"):
        parallel.StreamingPwelch(1.0, spectral.PwelchOptions(nfft=128), _mesh(2, 4),
                                 segs_per_chunk_shard=4, channels=3)
    with pytest.raises(ValueError, match="first device"):
        parallel.StreamingPwelch(1.0, mesh=_mesh(), device="meta")
    sp = parallel.StreamingPwelch(1.0, spectral.PwelchOptions(nfft=128), _mesh(),
                                  segs_per_chunk_shard=4)
    sp.update(_signal(20_000))
    sp.finalize()
    assert sp.metrics.samples_in == 20_000
    assert sp.metrics.chunks_done == 20_000 // (8 * 4 * 128) + 1
    assert sp.metrics.wall_s > 0 and "msamples_per_s" in sp.metrics.json_line()


def test_stream_welch_mesh_matches_jax():
    x = np.random.default_rng(0).normal(size=1 << 15)
    blocks = [x[i : i + 7000] for i in range(0, len(x), 7000)]
    kw = dict(fs=4.0, nperseg=256, noverlap=64, nfft=512)
    f1, p1 = parallel.stream_welch(iter(blocks), mesh=_mesh(), segs_per_chunk_shard=4, **kw)
    f2, p2 = jpar.stream_welch(iter(blocks), mesh=_jmesh(), segs_per_chunk_shard=4, **kw)
    assert _close(f1, f2) and _close(p1, p2)


def test_wav_psd_mesh_matches_jax(tmp_path):
    path = str(tmp_path / "rec.wav")
    n, fs = 150_001, 44100
    rng = np.random.default_rng(7)
    t = np.arange(n) / fs
    sig = 0.4 * np.sin(2 * np.pi * 1000.0 * t) + 0.05 * rng.normal(size=n)
    with wav.WavWriter(path, fs, float32=False) as w:
        w.write(sig)
    o = dict(nfft=1024, noverlap=512)
    got = models.wav_psd(path, spectral.PwelchOptions(**o), _mesh(), block_size=40000,
                         segs_per_chunk_shard=4)
    want = jwav_psd(path, jspec.PwelchOptions(**o), _jmesh(), block_size=40000,
                    segs_per_chunk_shard=4)
    assert got.pxx.shape == (513,) and _close(got.pxx, want.pxx)
    assert '"chunks": 10' in got.metrics_json and '"chunks": 10' in want.metrics_json


# ---------------------------------------------------------------- STFT / ISTFT


@pytest.mark.parametrize("kernels", [False, True], ids=["frames", "kernels"])
@pytest.mark.parametrize("nfft, hop, pad, window, L", [
    (256, 128, None, None, 8 * 128 * 16),
    (128, 64, 256, "hamming", 8 * 64 * 8),
    (256, 32, None, None, 8 * 32 * 8),
], ids=["n256_h128", "pad_window", "hop32_last_shard_short"])
def test_spectrogram_sharded_matches_jax(request, kernels, nfft, hop, pad, window, L):
    calls = request.getfixturevalue("kernels_on_cpu") if kernels else None
    x = _signal(L, seed=3)
    got = parallel.spectrogram_sharded(x, _mesh(), nfft, hop, window=window, pad=pad)
    want = np.asarray(jpar.spectrogram_sharded(jnp.asarray(x), _jmesh(), nfft, hop,
                                               window=window, pad=pad))
    assert got.shape == want.shape and _close(got, want)
    assert _close(got, jmodels.spectrogram(jnp.asarray(x), nfft, hop, window=window, pad=pad))
    if calls is not None:
        assert calls == {"stft_power": 8}


@pytest.mark.parametrize("kernels", [False, True], ids=["frames", "kernels"])
@pytest.mark.parametrize("nfft, hop, F, window, batch", [
    (256, 128, 8 * 16, None, 0),
    (128, 128, 8 * 4, "hamming", 2),
    (256, 64, 8 * 8, None, 0),
], ids=["n256_h128", "hop_eq_nfft_batched", "overlap75"])
def test_istft_sharded_matches_jax(request, kernels, nfft, hop, F, window, batch):
    calls = request.getfixturevalue("kernels_on_cpu") if kernels else None
    L = (F - 1) * hop + nfft
    x = np.random.default_rng(7).normal(size=(batch, L) if batch else L)
    s = np.array(jmodels.stft(jnp.asarray(x), nfft, hop=hop, window=window))[..., :F, :]
    got = parallel.istft_sharded(s, _mesh(), nfft, hop, window=window)
    want = np.asarray(jpar.istft_sharded(jnp.asarray(s), _jmesh(), nfft, hop, window=window))
    assert got.shape == want.shape == s.shape[:-2] + (F * hop,)
    assert _close(got, want)
    ref = models.istft(torch.from_numpy(s), nfft, hop, window=window)[..., : F * hop]
    assert _close(got, ref)
    if calls is not None:
        assert calls == {"istft_overlap_add": 8}


def test_stft_sharded_errors():
    mesh = _mesh()
    with pytest.raises(ValueError, match="divide"):
        parallel.spectrogram_sharded(np.ones(1000), mesh, 256)
    s = np.ones((20, 129), np.complex128)
    with pytest.raises(ValueError, match="multiple of n_sp"):
        parallel.istft_sharded(s, mesh, 256, 128)
    with pytest.raises(ValueError, match="hop <= nfft"):
        parallel.istft_sharded(np.ones((8, 129), np.complex128), mesh, 256, 512)
    with pytest.raises(ValueError, match="spill"):
        parallel.istft_sharded(np.ones((8, 129), np.complex128), mesh, 256, 16)
    with pytest.raises(ValueError, match="inconsistent"):
        parallel.istft_sharded(np.ones((8, 100), np.complex128), mesh, 256, 128, pad=256)


# ---------------------------------------------------------------- fft_sharded


@pytest.mark.parametrize("shape, order, inverse", [
    ((1 << 12,), "natural", False),
    ((1 << 12,), "digit", False),
    ((1 << 12,), "natural", True),
    ((3, 1 << 12), "natural", False),
    ((32,), "natural", False),
    ((32,), "digit", True),
], ids=["natural", "digit", "inverse", "batched", "uneven", "uneven_digit_inverse"])
def test_fft_sharded_matches_jax(shape, order, inverse):
    rng = np.random.default_rng(len(shape) + shape[-1])
    x = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    got = parallel.fft_sharded(x, _mesh(), inverse=inverse, order=order)
    want = np.asarray(jpar.fft_sharded(jnp.asarray(x), _jmesh(), inverse=inverse, order=order))
    assert got.shape == want.shape and _close(got, want)


def test_fft_sharded_round_trip_and_errors():
    x = np.random.default_rng(2).normal(size=1 << 12) + 0j
    X = parallel.fft_sharded(x, _mesh())
    assert _close(parallel.fft_sharded(X, _mesh(), inverse=True) / (1 << 12), x)
    mesh = _mesh()
    with pytest.raises(ValueError, match="divisible"):
        parallel.fft_sharded(np.ones(1001, np.complex128), mesh)
    with pytest.raises(ValueError, match="power of 2"):
        parallel.fft_sharded(np.ones(1000, np.complex128), mesh)
    with pytest.raises(ValueError, match="unknown order"):
        parallel.fft_sharded(np.ones(4096, np.complex128), mesh, order="x")


# ---------------------------------------------------------------- make_mesh


def test_make_mesh():
    m = parallel.make_mesh(parallel.MeshConfig(dp=2, sp=4), devices=["cpu"] * 8)
    assert m.shape == {"dp": 2, "sp": 4} and m.one_device and m.first == torch.device("cpu")
    assert m == parallel.make_mesh(parallel.MeshConfig(2, 4), devices=[torch.device("cpu")] * 9)
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        parallel.make_mesh(parallel.MeshConfig(dp=2, sp=4), devices=["cpu"] * 4)
    default = parallel.make_mesh()  # default_device() is the CPU here
    assert default.shape == {"dp": 1, "sp": 1} and default.first == torch.device("cpu")
    set_default_device("cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.make_mesh()
