"""K14f, the lane-slice K1 taken apart (ops/cuda_probes.py: ls_network,
gmm_tf32, ls_full), and its probe script (probes/r3.py) on the CPU.

Each twin's plain version is held against the TPU body it replaces.
tools/probe_r3.py keeps its bodies as closures in main(), under `if
"anatomy1024" in sections:`, so the file is parsed with ast (it is only
read, never run): the FunctionDefs k_step1_only, k_gmm_only,
k_gmm_default, k_full, k_full_concat and make_subtiled are taken out of
that block and executed in a namespace holding pf
(godsp_tpu.ops.pallas_fft), jnp_, jax, n1 = 8 and LANES = 128.  Each runs
in a pl.pallas_call(interpret=True) shaped as run_variant's (:156-171) at
64 rows x 1024, bt = 64 (bt = 32 for the rows-a-block twin), with TAB
built as at :202-204 (pf._ls_tables(1024, False, False): G unscaled, so
K13's plain version, whose G carries 1/128, is held at 128 x its value).
Bound: >= 100 dB between the float64 plain version and the float32
interpret-mode body, as for the other probes (k_gmm_default's DEFAULT
precision is full float32 on the CPU, so gmm_tf32_plain without TF32
rounding stands beside it).  ls_full_plain in float64 is held to numpy's
FFT in the lane-slice digit order at go-dsp's 1e-8 bound (pretty_close_c).
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from godsp_tpu_torch import default_device, dsputils, set_default_device
from godsp_tpu_torch.ops import cuda_metrics, launch_counts
from godsp_tpu_torch.ops import cuda_probes as cp
from godsp_tpu_torch.probes import r3

TOOL = pathlib.Path(__file__).resolve().parent.parent / "tools" / "probe_r3.py"
BODIES = ("k_step1_only", "k_gmm_only", "k_gmm_default", "k_full", "k_full_concat",
          "make_subtiled")
ROWS, N, BT = 64, 1024, 64
SNR_DB = 100.0
# (case, TPU body, bt, the float64 plain version times the scale it is held at)
CASES = {
    "k_step1_only": ("k_step1_only", BT, lambda x: cp.ls_network_plain(*x)),
    "k_gmm_only": ("k_gmm_only", BT, lambda x: _scaled(cuda_metrics.gmm_floor_plain(*x))),
    "k_gmm_default": ("k_gmm_default", BT, lambda x: _scaled(cp.gmm_tf32_plain(*x))),
    "k_full": ("k_full", BT, lambda x: cp.ls_full_plain(*x)),
    "k_full_concat": ("k_full_concat", BT, lambda x: cp.ls_full_plain(*x)),
    "subtiled_2": (2, BT, lambda x: cp.ls_full_plain(*x)),
    "subtiled_4": (4, BT, lambda x: cp.ls_full_plain(*x)),
    "subtiled_8": (8, BT, lambda x: cp.ls_full_plain(*x)),
    "k_full_bt32": ("k_full", 32, lambda x: cp.ls_full_plain(*x)),
}
TWINS = ("ls_network", "gmm_tf32", "ls_full")


@pytest.fixture(autouse=True)
def _host_data_on_cpu():
    """Host data goes to the CPU here; the port's default device is the card."""
    old = default_device()
    set_default_device("cpu")
    yield
    set_default_device(old)


def _scaled(planes):
    return planes[0] * 128.0, planes[1] * 128.0


@pytest.fixture(scope="module")
def tpu():
    """The bodies, TAB and the inputs (numpy float32)."""
    import jax
    import jax.numpy as jnp

    from godsp_tpu.ops import pallas_fft as pf

    main = next(node for node in ast.parse(TOOL.read_text()).body
                if isinstance(node, ast.FunctionDef) and node.name == "main")
    block = next(node for node in main.body
                 if isinstance(node, ast.If) and "anatomy1024" in ast.unparse(node.test))
    defs = [node for node in block.body
            if isinstance(node, ast.FunctionDef) and node.name in BODIES]
    assert sorted(d.name for d in defs) == sorted(BODIES)
    ns = {"pf": pf, "jnp_": jnp, "jax": jax, "n1": N // 128, "LANES": pf.LANES}
    exec(compile(ast.Module(body=defs, type_ignores=[]), str(TOOL), "exec"), ns)
    tabs = pf._ls_tables(N, False, False)
    tab = [jnp.asarray(tabs[k]) for k in pf._LS_ORDER]
    rng = np.random.default_rng(0)
    xr = (rng.normal(size=(ROWS, N)) * 0.1).astype(np.float32)
    xi = (rng.normal(size=(ROWS, N)) * 0.1).astype(np.float32)
    return ns, tab, tabs, xr, xi


def _pallas(body, bt, tables, xr, xi):
    """run_variant's call (:156-171) in interpret mode."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    spec = pl.BlockSpec((bt, N), lambda i: (i, 0), memory_space=pltpu.VMEM)
    const = [pl.BlockSpec(t.shape, lambda i, nd=t.ndim: (0,) * nd, memory_space=pltpu.VMEM)
             for t in tables]
    out = pl.pallas_call(
        body, grid=(ROWS // bt,), in_specs=[spec, spec] + const, out_specs=(spec, spec),
        out_shape=(jax.ShapeDtypeStruct((ROWS, N), jnp.float32),
                   jax.ShapeDtypeStruct((ROWS, N), jnp.float32)),
        interpret=True)(jnp.asarray(xr), jnp.asarray(xi), *tables)
    return np.asarray(out[0]), np.asarray(out[1])


def _c(planes):
    return np.asarray(planes[0], np.float64) + 1j * np.asarray(planes[1], np.float64)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_the_tpu_body(tpu, case):
    ns, tab, _, xr, xi = tpu
    body, bt, plain = CASES[case]
    fn = ns["make_subtiled"](body) if isinstance(body, int) else ns[body]
    want = _pallas(fn, bt, [] if body == "k_step1_only" else tab, xr, xi)
    got = plain(_t(xr.astype(np.float64), xi.astype(np.float64)))
    assert got[0].dtype == torch.float64
    assert dsputils.snr_db(_c(got), _c(want)) >= SNR_DB


def test_ls_tables_are_the_tpu_tables(tpu):
    """ls_full's G (K13's tables times 128) equals pf._ls_tables' gr, gi,
    gs bit for bit: the same float64 build, a power-of-2 scale apart."""
    _, _, tabs, _, _ = tpu
    got = cp.ls_tables(N, torch.device("cpu")).numpy()
    for p, key in enumerate(("gr", "gi", "gs")):
        assert np.array_equal(got[:, p], tabs[key]), key


@pytest.mark.parametrize("n1", cp.LS_N1)
def test_ls_full_plain_is_the_fft_in_digit_order(n1):
    rng = np.random.default_rng(n1)
    xr, xi = rng.normal(size=(2, 5, 128 * n1))
    got = cp.ls_full_plain(*_t(xr, xi))
    want = cp.ls_digit_order(torch.from_numpy(np.fft.fft(xr + 1j * xi)), n1).numpy()
    assert dsputils.pretty_close_c(_c(got), want)
    # position 128 k1 + k2 holds bin k1 + n1 k2
    k1, k2 = n1 - 1, 5
    assert want[0, 128 * k1 + k2] == np.fft.fft(xr + 1j * xi)[0, k1 + n1 * k2]


@pytest.mark.parametrize("n1", cp.LS_N1)
def test_ls_network_plain_is_the_dft_across_slices(n1):
    """Each slice k1 out is sum_j slice_j W_n1^{j k1}, on random data (a DC
    input would not show a slice order gone wrong)."""
    rng = np.random.default_rng(10 + n1)
    xr, xi = rng.normal(size=(2, 3, 128 * n1))
    got = _c(cp.ls_network_plain(*_t(xr, xi))).reshape(3, n1, 128)
    want = np.fft.fft((xr + 1j * xi).reshape(3, n1, 128), axis=1)
    assert dsputils.pretty_close_c(got, want)


def test_gmm_tf32_rounds_where_the_kernel_rounds():
    """The CPU wrapper is the TF32-rounded plain version; permutation tables
    return the rounded operands exactly (the fragment maps' check on the
    card); the rounded product lies ~11 bits an operand from the exact one."""
    rng = np.random.default_rng(7)
    xr, xi = _t(*(rng.normal(size=(2, 9, 256)).astype(np.float32)))
    got = cp.gmm_tf32(xr, xi)
    want = cp.gmm_tf32_plain(xr, xi, tf32=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    exact = cp.gmm_tf32_plain(xr.double(), xi.double())
    assert 50.0 < dsputils.snr_db(_c(got), _c(exact)) < 90.0
    eye = torch.eye(128)
    for table, roll in ((eye, 0), (torch.roll(eye, 1, dims=1), 1)):
        g = table.expand(2, 3, 128, 128).contiguous()
        yr, yi = cp.gmm_tf32(xr, xi, g)
        a, b = (torch.roll(cp.round_tf32(v).view(9, 2, 128), roll, dims=2).reshape(9, 256)
                for v in (xr, xi))
        s = torch.roll(cp.round_tf32(xr + xi).view(9, 2, 128), roll, dims=2).reshape(9, 256)
        assert torch.equal(yr, a - b) and torch.equal(yi, s - a - b)


@pytest.mark.parametrize("b", [1, 15, 17, 63, 65, 1001])
@pytest.mark.parametrize("n1", [1, 2, 4, 8])
def test_gmm_tf32_and_yardstick_on_cpu_are_the_rounded_plain_version(n1, b):
    """On CPU tensors gmm_tf32 and its first design gmm_tf32_sync take the
    TF32-rounded plain version, with K13's tables and with any others,
    ragged b included; no launch is counted."""
    rng = np.random.default_rng(13 * b + n1)
    xr, xi = _t(*(rng.normal(size=(2, b, 128 * n1)).astype(np.float32)))
    want = cp.gmm_tf32_plain(xr, xi, tf32=True)
    before = dict(cp.launches)
    g = torch.from_numpy(rng.normal(size=(n1, 3, 128, 128)).astype(np.float32))
    want_g = cp.gmm_tf32_plain(xr, xi, tf32=True, g=g)
    for got, ref in ((cp.gmm_tf32_sync(xr, xi), want), (cp.gmm_tf32(xr, xi), want),
                     (cp.gmm_tf32_sync(xr, xi, g), want_g), (cp.gmm_tf32(xr, xi, g), want_g)):
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert cp.launches == before


def test_gmm_tf32_yardstick_checks_shapes():
    x = torch.zeros(2, 256)
    with pytest.raises(ValueError, match="g must be"):
        cp.gmm_tf32_sync(x, x, torch.zeros(1, 3, 128, 128))
    for a, b in ((torch.zeros(2, 1000), torch.zeros(2, 1000)),
                 (torch.zeros(2, 256), torch.zeros(3, 256))):
        with pytest.raises(ValueError):
            cp.gmm_tf32_sync(a, b)


@pytest.mark.parametrize("name", TWINS)
def test_lane_slice_wrappers_check_shapes(name):
    fn = getattr(cp, name)
    bad = [(torch.zeros(2, 1000), torch.zeros(2, 1000)), (torch.zeros(2, 256), torch.zeros(3, 256)),
           (torch.zeros(256), torch.zeros(256))]
    if name != "gmm_tf32":  # gmm_tf32 takes any n1, as K13
        bad += [(torch.zeros(2, 384), torch.zeros(2, 384)), (torch.zeros(2, 2048),
                                                             torch.zeros(2, 2048))]
    for a, b in bad:
        with pytest.raises(ValueError):
            fn(a, b)
    x = torch.zeros(2, 256)
    if name == "gmm_tf32":
        with pytest.raises(ValueError, match="g must be"):
            fn(x, x, torch.zeros(1, 3, 128, 128))
    if name == "ls_full":
        for kw, what in (({"store": "whole"}, "store"), ({"chunks": 3}, "chunks"),
                         ({"rows_per_block": 24}, "rows_per_block"),
                         ({"rows_per_block": 0}, "rows_per_block")):
            with pytest.raises(ValueError, match=what):
                fn(x, x, **kw)
    out = fn(torch.zeros(0, 512), torch.zeros(0, 512))
    assert out[0].shape == (0, 512) and out[1].shape == (0, 512)
    # A strided view gives what its contiguous copy gives.
    rng = np.random.default_rng(11)
    xr, xi = _t(*(rng.normal(size=(2, 256, 6)).astype(np.float32)))
    vr, vi = xr.T, xi.T
    assert not vr.is_contiguous()
    got, want = fn(vr, vi), fn(vr.contiguous(), vi.contiguous())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert launch_counts()[name] == 0  # CPU tensors take the plain version


def test_ls_full_settings_share_one_function():
    """On the CPU every setting is the plain version: the kernel's settings
    change the schedule, not the arithmetic."""
    rng = np.random.default_rng(12)
    xr, xi = _t(*(rng.normal(size=(2, 33, 512)).astype(np.float32)))
    want = cp.ls_full(xr, xi)
    for kw in r3.FULL_SETTINGS.values():
        got = cp.ls_full(xr, xi, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_r3_rows_on_the_cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    shapes = {(64, 1024): (2, 4), (4, 4096): (1, 2)}
    try:
        out = r3.run("cpu", b=64, shapes=shapes, emit=lambda s: None)
    finally:
        torch.set_num_threads(threads)
    assert sorted(k for k in out if k != "check") == sorted(r3.LANE_ROWS + r3.row_names(shapes))
    chk = out["check"]
    assert min(chk["network_vs_float64_db"], chk["gmm_default_vs_tf32_plain_db"],
               chk["full_vs_float64_db"], chk["full_vs_fft_db"]) >= 120.0
    assert 50.0 < chk["gmm_default_vs_exact_db"] < 90.0
    assert all(chk["full_settings_equal"].values())
    assert sorted(chk["full_settings_equal"]) == sorted(k for k in r3.FULL_SETTINGS if k != "full")
    assert chk["k1_rows_equal"] == {"64x1024": True, "4x4096": True}
    assert sorted(chk["max_abs_err"]) == sorted(TWINS)
    for name, r in out.items():
        if name == "check":
            continue
        assert r["ms"] > 0 and r["bound_by"] in ("bytes", "operations"), name
        assert r["library_ms"] > 0, name
    assert out["copy"]["of_copy"] == 1.0 and out["copy_4x4096"]["of_copy"] == 1.0
    # The lane-slice K1 computes the row's DFT, 5 log2 n operations a point
    # (its method does 768 + 15): bytes bound it, as K1; K13's contraction is
    # bound by its 768; gmm_tf32's 768 TF32 operations stay under the bytes.
    pts = 64 * r3.N
    for name in (*r3.FULL_SETTINGS, "fft1024"):
        assert out[name]["bound_by"] == "bytes", name
        assert out[name]["bound_ms"] == pytest.approx(16 * pts / 3.35e12 * 1e3, rel=1e-12), name
    assert out["gmm_hi"]["bound_by"] == "operations"
    g = out["gmm_default"]
    assert g["bound_by"] == "bytes" and g["tf32_ms"] == pytest.approx(768 * pts / 495e12 * 1e3)
    assert r3.ROWS == r3.LANE_ROWS + r3.row_names(r3.SWEEP)
    assert r3.row_names({(4, 8192): (1, 2)}) == ("copy_4x8192", "k1_4x8192_rows1",
                                                "k1_4x8192_rows2", "k1_4x8192_radix2")
    # Every sweep setting fits one CTA; 16384 points take a row's 1024
    # threads and 128 KB, so only one row a CTA fits there.
    assert all(cp.fft_rows_fit(n, r) for (_, n), rs in r3.SWEEP.items() for r in rs)
    assert not cp.fft_rows_fit(16384, 2)


def test_r3_main_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert r3.main() == 1
