"""The Hopper probes on the CPU: K14a, the fused-Welch floor twins
(ops/cuda_probes.py) and their probe script (probes/pwfloor.py); K14b
(fac_dft) and K14c (slicestore, concatstore, gmm_concat, and K14g's
i8_concat) and theirs (probes/facdft.py, probes/store.py).

Each twin's plain version is held against its Pallas counterpart in
tools/probe_pwfloor.py (build_variant(v, "parallel", interpret=True)),
which is loaded by path with PWFLOOR_SEGS=512 set before the load (the
file is only read): the same float32 samples, 512 segments, nfft = pad
= 1024, hop 512, 256 segments a tile.  The TPU twins write packed-half
rows (pad/2 + 128 lanes); rfft_packed_to_natural maps them to the
natural bins 0..pad/2.  Bound: >= 100 dB between the float64 plain
version and the float32 interpret-mode kernel, as for the other kernels.
The wrappers take their plain versions for CPU tensors; the probe runs
its six rows through them at a cut size.

K14b/K14c: the plain versions against the TPU code, whose files are only
read: fac_dft's against tools/probe_facdft.py's fac_pallas in interpret
mode at 256 rows (its layout A mapped to natural bins with
to_layout_a/_a_to_dense), >= 100 dB, and the port's tables against
_fac_tables(); the store twins' against a pl.pallas_call(interpret=True)
built here around tools/probe_store.py's kernel bodies at 256 rows (the
module hard-codes 16384 rows and no interpret flag): equal for the
copies, >= 100 dB for gmm_concat and for i8_concat (with the tool's own
make_i8full_tables; tests/test_torch_int8.py says why not equal).  Both
probe scripts run at a cut size.
"""

import importlib.util
import os
import pathlib

import numpy as np
import pytest
import torch

from godsp_tpu.ops.pallas_fft import rfft_packed_to_natural
from godsp_tpu_torch import default_device, dsputils, set_default_device, window
from godsp_tpu_torch.ops import cuda_metrics, cuda_probes, cuda_pwelch
from godsp_tpu_torch.probes import facdft, pwfloor, store

REPO = pathlib.Path(__file__).resolve().parent.parent
SNR_DB = 100.0


@pytest.fixture(autouse=True)
def _host_data_on_cpu():
    """Host data goes to the CPU here; the port's default device is the card."""
    old = default_device()
    set_default_device("cpu")
    yield
    set_default_device(old)


@pytest.fixture(scope="module")
def tpu_probe():
    """tools/probe_pwfloor.py at 512 segments, loaded by path."""
    old = os.environ.get("PWFLOOR_SEGS")
    os.environ["PWFLOOR_SEGS"] = "512"
    try:
        spec = importlib.util.spec_from_file_location("probe_pwfloor_512",
                                                      REPO / "tools" / "probe_pwfloor.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        if old is None:
            os.environ.pop("PWFLOOR_SEGS")
        else:
            os.environ["PWFLOOR_SEGS"] = old
    assert mod.SEGS == 512 and mod.NFFT == 1024 and mod.STRIDE == 512
    rng = np.random.default_rng(0)
    ext = (rng.normal(size=mod.L) * 0.1).astype(np.float32)
    frames = (rng.normal(size=(mod.SEGS, mod.NFFT)) * 0.1).astype(np.float32)
    return mod, ext, frames


def _natural(rows, pad):
    """Packed-half rows (..., pad/2 + 128) -> natural bins (..., pad/2 + 1)."""
    p = np.asarray(rows, np.float64)
    nh = pad // 2
    return np.asarray(rfft_packed_to_natural(p[..., :nh], np.zeros_like(p[..., :nh]),
                                             p[..., nh:])[0])


@pytest.mark.parametrize("variant", ["loadonly", "frameonly", "noframe", "staged"])
def test_twin_plain_matches_the_tpu_twin(tpu_probe, variant):
    mod, ext, frames = tpu_probe
    nfft, hop, bt = mod.NFFT, mod.STRIDE, mod.BT
    e = torch.from_numpy(ext.astype(np.float64))
    f = torch.from_numpy(frames.astype(np.float64))
    mask = torch.ones(mod.SEGS, dtype=torch.float64)
    w = torch.from_numpy(window.window_table_np("hann", nfft))
    tpu_variant = "full2d" if variant == "staged" else variant
    out = np.asarray(mod.build_variant(tpu_variant, "parallel", interpret=True)(
        frames if variant == "noframe" else ext))
    if variant == "loadonly":
        got = cuda_probes.pwfloor_loadonly(e, mask, w, nfft, hop, bt=bt)
        want = out[:, 0, 0]
    elif variant == "frameonly":
        got = cuda_probes.pwfloor_frameonly(e, mask, w, nfft, hop, bt=bt)
        want = out[:, 0, :]
    elif variant == "noframe":
        got = cuda_probes.pwfloor_noframe(f, mask, w, bt=bt)
        want = _natural(out[:, 0, :], nfft)
    else:
        got = cuda_probes.pwfloor_staged_plain(e, mask, w, nfft, hop, nfft, bt)
        want = _natural(out[:, 0, :], nfft)
        full = _natural(np.asarray(mod.build_variant("full", "parallel", interpret=True)(ext)),
                        nfft)
        assert dsputils.snr_db(got.numpy(), full) >= SNR_DB
    assert got.shape == want.shape
    assert dsputils.snr_db(got.numpy(), want) >= SNR_DB


@pytest.mark.parametrize("nfft,hop,pad,S,keep", [(1024, 512, 1024, 100, 100),
                                                 (100, 30, 128, 77, 70)])
def test_twins_agree_with_k4_and_each_other(nfft, hop, pad, S, keep):
    """On any geometry: staged is K4's function; frameonly's time-domain
    sums transform to K4's power only through the FFT, so its total is the
    masked sum of windowed samples; loadonly sums what a tile reads."""
    rng = np.random.default_rng(S)
    ext = torch.from_numpy(rng.normal(size=(2, (S - 1) * hop + nfft + 5)))
    mask = torch.from_numpy((np.arange(S) < keep) * np.ones((2, 1)))
    w = torch.from_numpy(window.window_table_np("hann", pad))
    bt = cuda_pwelch.segs_per_tile(S, 2)
    staged = cuda_probes.pwfloor_staged(ext, mask, w, nfft, hop, pad)
    assert torch.equal(staged, cuda_pwelch.pwelch_power_partials(ext, mask, w, nfft, hop, pad))
    frames = ext[..., : (S - 1) * hop + nfft].unfold(-1, nfft, hop) * w[:nfft]
    fo = cuda_probes.pwfloor_frameonly(ext, mask, w, nfft, hop, pad)
    assert fo.shape == (2, -(-S // bt), pad)
    assert torch.allclose(fo.sum(dim=(-2, -1)), (frames * mask[..., None]).sum(dim=(-2, -1)))
    lo = cuda_probes.pwfloor_loadonly(ext, mask, w, nfft, hop, pad)
    starts = torch.arange(0, S, bt)
    ends = torch.clamp(starts + bt - 1, max=S - 1) * hop + nfft
    for t, (s0, s1) in enumerate(zip(starts.tolist(), ends.tolist())):
        want = ext[:, s0 * hop : s1].sum(-1) + mask[:, s0 : s0 + bt].sum(-1) + w.sum()
        assert torch.allclose(lo[:, t], want)
    nf = cuda_probes.pwfloor_noframe(torch.nn.functional.pad(frames, (0, pad - nfft)), mask,
                                     torch.ones(pad, dtype=torch.float64))
    assert torch.allclose(nf, staged)


def test_staged_caps_its_tile_to_shared_memory():
    assert cuda_probes.staged_segs_per_tile(16384, 1, 1024, 512, 1024) == \
        cuda_pwelch.segs_per_tile(16384, 1)
    big = cuda_probes._staged_max_bt(1024, 512, 1024)
    assert (big - 1) * 512 + 1024 <= (232448 - 8 * 1024 - 4 * 513) // 4
    assert cuda_probes.staged_segs_per_tile(10**7, 1, 1024, 512, 1024) == 64  # K4's cap
    # At pad 16384 the redesign's slot and span hold four segments of hop
    # 8192; the first design's pad-point buffer, sums and span one.
    assert cuda_probes.staged_segs_per_tile(10**7, 1, 16384, 8192, 16384) == 4
    assert cuda_probes._staged_max_bt(16384, 8192, 16384) == 1
    for twin in (cuda_probes.pwfloor_staged, cuda_probes.pwfloor_staged_radix2):
        with pytest.raises(ValueError):
            twin(torch.zeros(1, 10**6), torch.ones(1, 1000), torch.ones(1024), 1024, 512,
                 bt=big + 1)


def test_probe_rows_on_the_cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        rows = pwfloor.run("cpu", segs=32, emit=lambda s: None)
    finally:
        torch.set_num_threads(threads)
    assert sorted(rows) == sorted(pwfloor.ROWS)
    L = 31 * pwfloor.STRIDE + pwfloor.NFFT
    assert rows["loadonly"]["bytes_read"] == 4.0 * L
    assert rows["noframe"]["bytes_read"] == 4.0 * 32 * pwfloor.NFFT
    for r in rows.values():
        assert r["ms"] > 0 and r["ceiling_ms"] > 0 and r["bound_by"] in ("bytes", "operations")


def test_probe_main_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert pwfloor.main() == 1


# ---------------------------------------------------------------------------
# K14b (fac_dft) and K14c (slicestore, concatstore, gmm_concat)
# ---------------------------------------------------------------------------


def _load_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"{name}_for_torch_tests",
                                                  REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def lane_inputs():
    """256 rows of n = 1024, float32, as the TPU probes' numerics check."""
    rng = np.random.default_rng(0)
    return ((rng.normal(size=(256, 1024)) * 0.1).astype(np.float32),
            (rng.normal(size=(256, 1024)) * 0.1).astype(np.float32))


def _planes64(xr, xi):
    return torch.from_numpy(xr.astype(np.float64)), torch.from_numpy(xi.astype(np.float64))


def _c(planes):
    return np.asarray(planes[0], np.float64) + 1j * np.asarray(planes[1], np.float64)


def test_fac_dft_plain_matches_the_tpu_kernel(lane_inputs):
    """fac_dft's plain version (float64) against tools/probe_facdft.py's
    fac_pallas in interpret mode, mapped from layout A to natural bins."""
    import jax.numpy as jnp

    mod = _load_tool("probe_facdft")
    xr, xi = lane_inputs
    fr, fi = mod.fac_pallas(jnp.asarray(mod.to_layout_a(xr)), jnp.asarray(mod.to_layout_a(xi)),
                            interpret=True)
    want = mod._a_to_dense(np.asarray(fr)) + 1j * mod._a_to_dense(np.asarray(fi))
    got = _c(cuda_probes.fac_dft(*_planes64(xr, xi)))
    assert dsputils.snr_db(got, want) >= SNR_DB
    dense = _c(cuda_metrics.gmm_floor_plain(*_planes64(xr, xi)))
    assert np.abs(got - dense).max() < 1e-12  # the same function as K13


def test_fac_tables_match_the_tpu_tables():
    """The port's natural-layout tables against _fac_tables()'s layout A
    (tw: (16, n1 * 8) with [j1, s * 8 + j2]; tm tiled over the slices)."""
    mod = _load_tool("probe_facdft")
    tpu = mod._fac_tables()
    ours = cuda_probes.fac_tables(mod.N)
    n1 = mod.N1
    for k in ("w16r", "w16i", "w8r", "w8i"):
        assert np.array_equal(ours[k], tpu[k]), k
    for k in ("tmr", "tmi"):
        assert np.array_equal(np.tile(ours[k], (n1, 1)), tpu[k]), k
    for k in ("twr", "twi"):
        a = ours[k].reshape(n1, 16, 8).transpose(1, 0, 2).reshape(16, n1 * 8)
        assert np.array_equal(a, tpu[k]), k
    assert all(v.dtype == np.float32 for v in ours.values())


def _store_call(mod, kern, tables, xr, xi):
    """tools/probe_store.py's _call around one of its kernel bodies, in
    interpret mode at B = xr.shape[0] rows."""
    import jax
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    b = xr.shape[0]
    spec = pl.BlockSpec((mod.BT, mod.N), lambda i: (i, 0), memory_space=pltpu.VMEM)
    const = [pl.BlockSpec(t.shape, lambda i, nd=t.ndim: (0,) * nd, memory_space=pltpu.VMEM)
             for t in tables]
    return pl.pallas_call(
        kern, grid=(b // mod.BT,), in_specs=[spec, spec] + const, out_specs=(spec, spec),
        out_shape=(jax.ShapeDtypeStruct((b, mod.N), xr.dtype),
                   jax.ShapeDtypeStruct((b, mod.N), xi.dtype)),
        interpret=True)(xr, xi, *tables)


@pytest.mark.parametrize("twin", ["slicestore", "concatstore", "gmm_concat", "i8_concat"])
def test_store_twin_plain_matches_the_tpu_kernel(lane_inputs, twin):
    import jax.numpy as jnp

    from godsp_tpu.ops.pallas_fft import _LS_ORDER, _ls_tables

    mod = _load_tool("probe_store")
    assert (mod.N, mod.BT) == (1024, 256)
    xr, xi = lane_inputs
    tables = []
    if twin == "gmm_concat":
        tabs = _ls_tables(mod.N, False, False, 1.0 / 128)
        tables = [jnp.asarray(tabs[k]) for k in _LS_ORDER]
    if twin == "i8_concat":  # the tool's own nine digit tables (probe_int8's)
        tables = mod.make_i8full_tables()
    out = _store_call(mod, getattr(mod, f"_{twin}_kernel"), tables, jnp.asarray(xr),
                      jnp.asarray(xi))
    want = _c(out)
    if twin == "i8_concat":
        # float32 planes only (the quantization is float32's); the row
        # scales' exp2 differ by ulps (tests/test_torch_int8.py), not equal.
        got = _c(cuda_probes.i8_concat(torch.from_numpy(xr), torch.from_numpy(xi)))
        assert dsputils.snr_db(got, want) >= SNR_DB
    elif twin == "gmm_concat":
        got = _c(cuda_probes.gmm_concat(*_planes64(xr, xi)))
        assert dsputils.snr_db(got, want) >= SNR_DB
        got32 = _c(cuda_probes.gmm_concat(torch.from_numpy(xr), torch.from_numpy(xi)))
        assert dsputils.snr_db(got32, want) >= SNR_DB
    else:
        got = getattr(cuda_probes, twin)(torch.from_numpy(xr), torch.from_numpy(xi))
        assert np.array_equal(_c(got), want) and np.array_equal(want, xr + 1j * xi.astype(
            np.float64))


@pytest.mark.parametrize("name", ["fac_dft", "slicestore", "concatstore", "gmm_concat"])
def test_lane_wrappers_check_shapes(name):
    fn = getattr(cuda_probes, name)
    for a, b in ((torch.zeros(2, 1000), torch.zeros(2, 1000)),
                 (torch.zeros(2, 256), torch.zeros(3, 256)), (torch.zeros(256), torch.zeros(256))):
        with pytest.raises(ValueError):
            fn(a, b)
    out = fn(torch.zeros(0, 384), torch.zeros(0, 384))
    assert out[0].shape == (0, 384)


@pytest.mark.parametrize("probe,rows", [(facdft, facdft.ROWS), (store, store.ROWS)])
def test_lane_probe_rows_on_the_cpu(probe, rows):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = probe.run("cpu", b=48, emit=lambda s: None)
    finally:
        torch.set_num_threads(threads)
    assert sorted(k for k in out if k != "check") == sorted(rows)
    for name in rows:
        r = out[name]
        assert r["ms"] > 0 and r["library_ms"] > 0 and r["bound_by"] in ("bytes", "operations")
    assert out["copy"]["of_copy"] == 1.0
    if probe is facdft:
        assert min(out["check"].values()) >= SNR_DB
        assert out["fac"]["bound_by"] == "bytes" and out["gmm"]["bound_by"] == "operations"
    else:
        assert out["check"]["slicestore_equal"] and out["check"]["concatstore_equal"]
        assert out["check"]["gmm_concat_equal_k13"]
        assert out["check"]["i8_concat_equal_plain"]
        assert out["check"]["i8_concat_vs_float64_db"] >= 120.0
        assert out["i8_concat"]["int8_ms"] > 0


@pytest.mark.parametrize("probe", [facdft, store])
def test_lane_probe_main_needs_a_card(probe):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert probe.main() == 1
