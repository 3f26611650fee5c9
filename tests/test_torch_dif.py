"""K14h and K14i, the butterfly twins (ops/cuda_probes.py: vdif, sdif_peel),
and their probe scripts (probes/vdif.py, probes/sdif.py) on the CPU.

Each plain version is held against the TPU body it replaces, the tools
files loaded by path with importlib (only read, never edited):
tools/probe_vdif.py's _vdif_kernel in a pl.pallas_call(interpret=True) of
one (64, 1024) block with the tool's own vdif_tables (scale 1/32), and
tools/probe_sdif.py's sdif_peel(interpret=True) with the module's N, REST
and T set by monkeypatch to 2^17, 1024 and 256; both at >= 100 dB, as for
the other probes.  The float64 plain versions are held to float64 oracles
at go-dsp's 1e-8 abs-or-rel bound (pretty_close_c): numpy's FFT in vdif
digit order (the tool's digit_vdif_np) and K8's plain version
outer_dft_split_plain(x, 128, 1) with the rows mapped by brev7.  The
tables are held to the tools' within float32 rounding of the float64
values.
"""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from godsp_tpu_torch import default_device, dsputils, set_default_device
from godsp_tpu_torch.ops import cuda_outer, launch_counts
from godsp_tpu_torch.ops import cuda_probes as cp
from godsp_tpu_torch.probes import sdif, vdif

TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"
ROWS, N = 64, 1024
SCALE = 1.0 / 32.0
SNR_DB = 100.0


@pytest.fixture(autouse=True)
def _host_data_on_cpu():
    """Host data goes to the CPU here; the port's default device is the card."""
    old = default_device()
    set_default_device("cpu")
    yield
    set_default_device(old)


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_{name}_for_tests", TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tool_vdif():
    return _load("probe_vdif")


@pytest.fixture(scope="module")
def tool_sdif():
    return _load("probe_sdif")


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _c(planes):
    return np.asarray(planes[0], np.float64) + 1j * np.asarray(planes[1], np.float64)


def _planes(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=shape) * 0.1).astype(dtype),
            (rng.normal(size=shape) * 0.1).astype(dtype))


def _within_rounding(got, want64):
    """|got - want64| within half a float32 ulp of the float64 value (one
    rounding), with an absolute floor of 2^-25 for values near zero."""
    got, want64 = np.asarray(got, np.float64), np.asarray(want64, np.float64)
    return np.all(np.abs(got - want64) <= np.maximum(2.0 ** -24 * np.abs(want64), 2.0 ** -25))


# ---------------------------------------------------------------------------
# Against the TPU bodies
# ---------------------------------------------------------------------------


def _vdif_tpu(tool, xr, xi):
    """tools/probe_vdif.py's _vdif_kernel over one (ROWS, N) block, as
    vdif_op (:105) lays it out, in interpret mode."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    tables = tool.vdif_tables(tool.N1, False, SCALE)
    spec = pl.BlockSpec((ROWS, N), lambda i: (i, 0), memory_space=pltpu.VMEM)
    const = [pl.BlockSpec(t.shape, lambda i, nd=t.ndim: (0,) * nd, memory_space=pltpu.VMEM)
             for t in tables]
    out = pl.pallas_call(
        functools.partial(tool._vdif_kernel, n1=tool.N1, inverse=False),
        grid=(1,), in_specs=[spec, spec] + const, out_specs=(spec, spec),
        out_shape=(jax.ShapeDtypeStruct((ROWS, N), jnp.float32),
                   jax.ShapeDtypeStruct((ROWS, N), jnp.float32)),
        interpret=True)(jnp.asarray(xr), jnp.asarray(xi), *tables)
    return np.asarray(out[0]), np.asarray(out[1])


def test_vdif_plain_matches_the_tpu_body(tool_vdif):
    xr, xi = _planes((ROWS, N), 0)
    want = _c(_vdif_tpu(tool_vdif, xr, xi))
    got = cp.vdif_plain(*_t(xr, xi), SCALE)
    assert got[0].dtype == torch.float32
    assert dsputils.snr_db(_c(got), want) >= SNR_DB
    # and both against numpy's float64 FFT in digit order
    x64 = xr.astype(np.float64) + 1j * xi.astype(np.float64)
    ref = tool_vdif.digit_vdif_np(np.fft.fft(x64) * SCALE, tool_vdif.N1)
    assert dsputils.snr_db(want, ref) >= SNR_DB
    assert dsputils.snr_db(_c(got), ref) >= SNR_DB


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sdif_plain_matches_the_tpu_body(tool_sdif, monkeypatch, dtype):
    monkeypatch.setattr(tool_sdif, "N", 1 << 17)
    monkeypatch.setattr(tool_sdif, "REST", 1024)
    monkeypatch.setattr(tool_sdif, "T", 256)
    import jax.numpy as jnp

    xr, xi = _planes((1 << 17,), 1)
    yr, yi = tool_sdif.sdif_peel(jnp.asarray(xr), jnp.asarray(xi), interpret=True)
    want = _c((np.asarray(yr).reshape(128, 1024), np.asarray(yi).reshape(128, 1024)))
    got = cp.sdif_peel_plain(*_t(xr.astype(dtype).reshape(1, 128, 1024),
                                 xi.astype(dtype).reshape(1, 128, 1024)))
    assert got[0].dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
    assert dsputils.snr_db(_c(got)[0], want) >= SNR_DB


# ---------------------------------------------------------------------------
# Against float64 oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n1", cp.VDIF_N1)
def test_vdif_plain_float64_is_the_fft_in_digit_order(tool_vdif, n1):
    n = 128 * n1
    xr, xi = _planes((5, n), n1, np.float64)
    got = cp.vdif_plain(*_t(xr, xi), 0.5)
    want = tool_vdif.digit_vdif_np(np.fft.fft(xr + 1j * xi) * 0.5, n1)
    assert dsputils.pretty_close_c(_c(got), want)
    assert dsputils.pretty_close_c(cp.vdif_digit_order(torch.from_numpy(np.fft.fft(xr + 1j * xi)),
                                                       n1).numpy(),
                                   tool_vdif.digit_vdif_np(np.fft.fft(xr + 1j * xi), n1))


@pytest.mark.parametrize("shape", [(1, 128, 1024), (2, 3, 128, 7), (128, 1)])
def test_sdif_plain_float64_is_the_dense_peel_bit_reversed(shape):
    xr, xi = _t(*_planes(shape, len(shape), np.float64))
    got = cp.sdif_peel_plain(xr, xi)
    dr, di = cuda_outer.outer_dft_split_plain(xr, xi, 128, 1)
    perm = cp.brev7_perm()
    want = _c((dr[..., perm, :], di[..., perm, :]))
    assert got[0].shape == shape
    assert dsputils.pretty_close_c(_c(got), want)


def test_brev7_perm_is_the_lane_dif_order():
    from godsp_tpu.ops import _lane_dft

    perm = cp.brev7_perm()
    assert perm.dtype == torch.int64
    assert torch.equal(perm, torch.from_numpy(_lane_dft.brev_perm_np(7)))


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------


def test_vdif_tables_match_the_tool(tool_vdif):
    from godsp_tpu.ops import _lane_dft

    tab = {k: v.numpy() for k, v in cp.vdif_tables(8, SCALE).items()}
    tool = [np.asarray(t) for t in tool_vdif.vdif_tables(8, False, SCALE)]
    t64 = cp.twiddle_2d(8, 128) * SCALE
    for got, ref, exact in ((tab["tr"], tool[0], t64.real), (tab["ti"], tool[1], t64.imag)):
        assert got.dtype == np.float32 and got.shape == (8, 128)
        assert _within_rounding(got, exact) and _within_rounding(ref, exact)
    lane = _lane_dft.lane_stage_tables(False)
    stages = {w: (twr[0], twi[0]) for w, twr, twi in lane["slice"]}
    j = np.arange(128)
    for w, twr, twi in lane["roll"]:  # the roll tables hold W_{2w}^{j mod w} on high lanes
        high = (j % (2 * w)) >= w
        stages[w] = (twr[0][high][:w], twi[0][high][:w])
    assert sorted(stages) == sorted(cp._STAGE_WS)
    for k, w in enumerate((64, 32, 16, 8)):  # the tool's own copies of the slice tables
        assert np.array_equal(tool[2 + 2 * k][0], stages[w][0])
    for w in cp._STAGE_WS:
        exact = np.exp(-1j * np.pi * np.arange(w) / w)
        off = 128 - 2 * w
        for got, ref, part in ((tab["sr"], stages[w][0], exact.real),
                               (tab["si"], stages[w][1], exact.imag)):
            assert _within_rounding(got[off:off + w], part) and _within_rounding(ref, part), w


def test_sdif_tables_match_the_tool(tool_sdif, monkeypatch):
    m, t_tile = 1024, 256
    monkeypatch.setattr(tool_sdif, "REST", m)
    monkeypatch.setattr(tool_sdif, "T", t_tile)
    tw_r, tw_i, tbhr, tbhi, tblr, tbli = tool_sdif._sdif_tables()
    tab = cp.sdif_tables(m)
    assert tab["cr"].shape == (7, 128) and tab["cr"].dtype == torch.float32
    for s in range(7):
        h = 64 >> s
        i = np.arange(128)
        exact = np.where((i // h) % 2 == 1, np.exp(-1j * np.pi * (i % h) / h), 1.0)
        assert _within_rounding(tab["cr"][s].numpy(), exact.real)
        assert _within_rounding(tab["ci"][s].numpy(), exact.imag)
        assert np.array_equal(tab["cr"][s].numpy(), tw_r[s][:, 0])
        assert np.array_equal(tab["ci"][s].numpy(), tw_i[s][:, 0])
    # Tb: the port's factored exact-exponent table against the tool's hi x lo
    # lane grid, both within two float32 roundings of the float64 value.
    n = 128 * m
    k1 = cp.brev7_perm().numpy()
    t = np.arange(m)
    p = (k1[:, None] * t[None, :]) % n
    exact = np.exp(-2j * np.pi * p / n)
    hi = (tab["hi"][:, 0] + 1j * tab["hi"][:, 1]).numpy().astype(np.complex64)
    lo = (tab["lo"][:, 0] + 1j * tab["lo"][:, 1]).numpy().astype(np.complex64)
    port = hi[p >> tab["lo_bits"]] * lo[p & ((1 << tab["lo_bits"]) - 1)]
    th = (tbhr + 1j * tbhi).astype(np.complex64)
    tl = (tblr + 1j * tbli).astype(np.complex64)
    tool = th[:, t // t_tile] * tl[:, t % t_tile]
    assert np.abs(port - exact).max() <= 2.0 ** -22
    assert np.abs(tool - exact).max() <= 2.0 ** -22


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [100, 200, 640, 1280, 2048])
def test_vdif_wrapper_checks_widths(n):
    with pytest.raises(ValueError, match="n1"):
        cp.vdif(torch.zeros(2, n), torch.zeros(2, n))


def test_vdif_wrapper_checks_planes():
    for a, b in ((torch.zeros(2, 256), torch.zeros(3, 256)), (torch.zeros(256), torch.zeros(256)),
                 (torch.zeros(1, 2, 256), torch.zeros(1, 2, 256))):
        with pytest.raises(ValueError):
            cp.vdif(a, b)
    out = cp.vdif(torch.zeros(0, 512), torch.zeros(0, 512))
    assert out[0].shape == (0, 512)
    xr, xi = _t(*_planes((256, 6), 9))
    got, want = cp.vdif(xr.T, xi.T, 0.25), cp.vdif(xr.T.contiguous(), xi.T.contiguous(), 0.25)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert launch_counts()["vdif"] == 0  # CPU tensors take the plain version


def test_sdif_wrapper_checks_planes():
    for a, b in ((torch.zeros(64, 8), torch.zeros(64, 8)), (torch.zeros(128, 0), torch.zeros(128, 0)),
                 (torch.zeros(128, 8), torch.zeros(2, 128, 8)), (torch.zeros(128), torch.zeros(128))):
        with pytest.raises(ValueError):
            cp.sdif_peel(a, b)
    out = cp.sdif_peel(torch.zeros(0, 128, 5), torch.zeros(0, 128, 5))
    assert out[0].shape == (0, 128, 5)
    xr, xi = _t(*_planes((2, 9, 128), 10))
    vr, vi = xr.transpose(1, 2), xi.transpose(1, 2)
    got, want = cp.sdif_peel(vr, vi), cp.sdif_peel(vr.contiguous(), vi.contiguous())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert launch_counts()["sdif_peel"] == 0


def test_digit_order_check_on_the_cpu():
    for n in (128, 512, 1024):
        assert vdif.digit_order_exact("cpu", n, n ** -0.5)


# ---------------------------------------------------------------------------
# The probe scripts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("probe, kw, points", [(vdif, {"b": 64}, 64 * 1024),
                                              (sdif, {"m": 1024}, 128 * 1024)],
                         ids=["vdif", "sdif"])
def test_probe_rows_on_the_cpu(probe, kw, points):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = probe.run("cpu", emit=lambda s: None, **kw)
    finally:
        torch.set_num_threads(threads)
    assert sorted(k for k in out if k != "check") == sorted(probe.ROWS)
    chk = out["check"]
    dbs = [v for k, v in chk.items() if k.endswith("_db")]
    assert len(dbs) == 2 and min(dbs) >= 120.0
    assert max(chk["max_abs_err"].values()) < 1e-6
    if probe is vdif:
        assert chk["digit_order_exact"]
    for name in probe.ROWS:
        r = out[name]
        assert r["ms"] > 0 and r["bound_by"] == "bytes"
        assert r["bound_ms"] == pytest.approx(16.0 * points / 3.35e12 * 1e3, rel=1e-12)
        assert (r["library_ms"] is None) == (probe is sdif and name != "copy")
    assert out["copy"]["of_copy"] == 1.0


@pytest.mark.parametrize("probe", [vdif, sdif], ids=["vdif", "sdif"])
def test_probe_main_needs_a_card(probe):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert probe.main() == 1
