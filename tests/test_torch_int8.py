"""K14g, the int8-limb contraction twins (ops/cuda_probes.py: i8_dot, i8mm,
i8dec, i8full, i8_concat), and their probe script (probes/int8.py) on the
CPU.

Each twin's plain version is held against the TPU body it replaces:
tools/probe_int8.py's _i8mm_kernel, _i8dec_kernel and _i8full_kernel and
tools/probe_store.py's _i8_concat_kernel (both tools loaded by path with
importlib, only read), each in a pl.pallas_call(interpret=True) shaped as
probe_int8.py's _call (:68-90) at 64 rows x 1024, bt = 64, with the tool's
own tables (make_i8mm_tables, make_i8full_tables); and the body `tiny`
(:204, a closure in main, taken out with ast) in the probe's own call at
(256, 128) @ (128, 128).  Bounds: i8_dot and i8mm equal (integers and one
float32 multiply); i8dec, i8full and i8_concat >= 100 dB, as the other
probe tests: godsp_tpu builds a row's scale with float32 exp2 (and log2),
which on the CPU lands up to 8 ulp off an exact power of two, where the
port reads and builds the powers of two from the exponent bits (the
kernels too), so the two differ by ~127 dB.  The port's copies of
godsp_tpu/ops/_int8_contract.py's arithmetic (digits3, table_digits_np,
stack_tables_np, row_quant_scales) are held to the module's on seeded
inputs, and the tables to the tool's.
"""

import ast
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from godsp_tpu_torch import default_device, dsputils, set_default_device
from godsp_tpu_torch.ops import cuda_probes as cp
from godsp_tpu_torch.ops import launch_counts
from godsp_tpu_torch.probes import int8

REPO = pathlib.Path(__file__).resolve().parent.parent
ROWS, N, BT = 64, 1024, 64
SNR_DB = 100.0
TWINS = ("i8mm", "i8dec", "i8full", "i8_concat")
# twin -> (tool, its TPU body, the tool's tables' maker)
BODIES = {"i8mm": ("probe_int8", "_i8mm_kernel", "make_i8mm_tables"),
          "i8dec": ("probe_int8", "_i8dec_kernel", "make_i8mm_tables"),
          "i8full": ("probe_int8", "_i8full_kernel", "make_i8full_tables"),
          "i8_concat": ("probe_store", "_i8_concat_kernel", "make_i8full_tables")}


@pytest.fixture(autouse=True)
def _host_data_on_cpu():
    """Host data goes to the CPU here; the port's default device is the card."""
    old = default_device()
    set_default_device("cpu")
    yield
    set_default_device(old)


def _load_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"{name}_for_int8_tests",
                                                  REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools():
    return {name: _load_tool(name) for name in ("probe_int8", "probe_store")}


@pytest.fixture(scope="module")
def planes():
    """64 rows of n = 1024, N(0, 0.1^2), float32, as the TPU probe's snr stage."""
    rng = np.random.default_rng(0)
    return ((rng.normal(size=(ROWS, N)) * 0.1).astype(np.float32),
            (rng.normal(size=(ROWS, N)) * 0.1).astype(np.float32))


def _pallas(body, tables, xr, xi):
    """probe_int8.py's _call (:68-90) in interpret mode at ROWS rows, bt BT."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    spec = pl.BlockSpec((BT, N), lambda i: (i, 0), memory_space=pltpu.VMEM)
    const = [pl.BlockSpec(t.shape, lambda i, nd=t.ndim: (0,) * nd, memory_space=pltpu.VMEM)
             for t in tables]
    out = pl.pallas_call(
        body, grid=(ROWS // BT,), in_specs=[spec, spec] + const, out_specs=(spec, spec),
        out_shape=(jax.ShapeDtypeStruct((ROWS, N), jnp.float32),
                   jax.ShapeDtypeStruct((ROWS, N), jnp.float32)),
        interpret=True)(jnp.asarray(xr), jnp.asarray(xi), *tables)
    return np.asarray(out[0]), np.asarray(out[1])


def _c(planes):
    return np.asarray(planes[0], np.float64) + 1j * np.asarray(planes[1], np.float64)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("twin", TWINS)
def test_plain_matches_the_tpu_body(tools, planes, twin):
    tool, body, maker = BODIES[twin]
    mod = tools[tool]
    assert mod.N == N
    want = _pallas(getattr(mod, body), getattr(mod, maker)(), *planes)
    got = getattr(cp, twin)(*_t(*planes))  # CPU tensors: the plain version
    assert got[0].dtype == torch.float32
    if twin == "i8mm":
        assert np.array_equal(got[0].numpy(), want[0]) and np.array_equal(got[1].numpy(), want[1])
    else:
        assert dsputils.snr_db(_c(got), _c(want)) >= SNR_DB


def test_i8_dot_plain_matches_tiny(tools):
    """i8_dot's plain version equals the body `tiny` (:204) on the probe's
    int8 operands (default_rng(0)), in the probe's own call (:213)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    tool = REPO / "tools" / "probe_int8.py"
    main = next(node for node in ast.parse(tool.read_text()).body
                if isinstance(node, ast.FunctionDef) and node.name == "main")
    block = next(node for node in main.body
                 if isinstance(node, ast.If) and "compile" in ast.unparse(node.test))
    tiny = next(node for node in block.body
                if isinstance(node, ast.FunctionDef) and node.name == "tiny")
    ns = {"jax": jax, "jnp": jnp}
    exec(compile(ast.Module(body=[tiny], type_ignores=[]), str(tool), "exec"), ns)
    a, b = int8.dot_inputs("cpu", 256, 128, 128)
    want = pl.pallas_call(ns["tiny"], out_shape=jax.ShapeDtypeStruct((256, 128), jnp.int32),
                          interpret=True)(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
    got = cp.i8_dot(a, b)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(want))
    m, k, n = int8.DOT_SHAPES[1]
    a, b = int8.dot_inputs("cpu", m, k, n)
    assert np.array_equal(cp.i8_dot(a, b).numpy(),
                          a.numpy().astype(np.int64) @ b.numpy().astype(np.int64))


def test_digits3_matches_the_jax_ladder():
    """The float32 ladder, operation for operation, over [-K, K] with its
    ends, zero, halves and small values."""
    import jax.numpy as jnp

    from godsp_tpu.ops import _int8_contract as i8

    rng = np.random.default_rng(1)
    v = rng.uniform(-cp.K_I8, cp.K_I8, size=(64, 128)).astype(np.float32)
    v[0, :6] = [cp.K_I8, -cp.K_I8, 0.0, 0.5, -0.5, 127.5]
    v[1] = (rng.normal(size=128) * 300).astype(np.float32)
    v[2] = np.round(v[2] / 65536.0) * 65536.0 + 32767.5
    want = [np.asarray(d) for d in i8.digits3(jnp.asarray(v))]
    got = [d.numpy() for d in cp.digits3(torch.from_numpy(v))]
    for g, w in zip(got, want):
        assert g.dtype == np.int8 and np.array_equal(g, w)
    recon = sum(d.astype(np.float64) * s for d, s in zip(got, (65536.0, 256.0, 1.0)))
    assert np.abs(recon - v).max() <= 0.5
    with pytest.raises(TypeError):
        cp.digits3(torch.from_numpy(v.astype(np.float64)))


def test_table_digits_and_stacks_match_the_jax_module():
    from godsp_tpu.ops import _int8_contract as i8

    rng = np.random.default_rng(2)
    t = rng.uniform(-1.0, 1.0, size=(128, 128))
    t[0, :3] = [1.0, -1.0, 0.0]
    for got, want in ((cp.table_digits_np(t), i8.table_digits_np(t)),
                      (cp.stack_tables_np(t), i8.stack_tables_np(t))):
        for g, w in zip(got, want):
            assert g.dtype == np.int8 and np.array_equal(g, w)
    w0, w1, w2 = cp.stack_tables_np(t)
    assert w0.shape == (128, 384) and w1.shape == (128, 256) and w2.shape == (128, 128)
    assert np.array_equal(w1, w0[:, :256]) and np.array_equal(w2, w0[:, :128])
    with pytest.raises(ValueError):
        cp.table_digits_np(t * 1.01)


def test_row_quant_scales_are_exact_powers():
    """ck = K / S and s_out = S 2^32 / K^2 with S = 2^(floor(log2 m) + 1)
    exactly, also just under and at powers of two; ck equals godsp_tpu's,
    whose float32 exp2 on the CPU leaves s_out up to 8 ulp (2^-20) off an
    exact power of two: ~120 dB, the gap the body tests see."""
    import jax.numpy as jnp

    from godsp_tpu.ops import _int8_contract as i8

    rng = np.random.default_rng(3)
    m = (np.abs(rng.normal(size=(500, 1))) * 0.3 + 1e-3).astype(np.float32)
    m[:4, 0] = [1.0, np.nextafter(np.float32(1.0), np.float32(0.0)), 0.0, 2.0**-20]
    ck, s_out = (v.numpy() for v in cp.row_quant_scales(torch.from_numpy(m)))
    e = np.floor(np.log2(np.maximum(m.astype(np.float64), np.float64(np.float32(1e-30)))))
    e[1] = -1.0  # log2 of 1 - 2^-24 rounds to 0 in float64 too
    assert np.array_equal(ck, (2.0 ** (-e - 1) * cp.K_I8).astype(np.float32))
    c = np.float64(np.float32(1.0 / (cp.K_I8 * cp.K_I8)))
    assert np.array_equal(s_out, (2.0 ** (e + 33) * c).astype(np.float32))
    ck_j, s_j = (np.asarray(v) for v in i8.row_quant_scales(jnp.asarray(m[4:])))
    assert np.array_equal(ck_j, ck[4:])
    assert np.abs(s_j.astype(np.float64) / s_out[4:] - 1.0).max() <= 2.0**-20


def test_tables_match_the_tpu_tables(tools):
    mod = tools["probe_int8"]
    for got, want in ((cp.i8mm_tables(), mod.make_i8mm_tables()),
                      (cp.i8full_tables(), mod.make_i8full_tables())):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == np.int8 and np.array_equal(g, np.asarray(w))
    assert [w.shape for w in cp.i8mm_tables(4)] == [(4, 128, 384), (4, 128, 256), (4, 128, 128)]


def test_i8full_is_k13s_function_to_the_schemes_accuracy(planes):
    """i8full's plain version against the float64 exact product (K13's
    function): the TPU probe's one-shot SNR, ~127 dB here (a row's block
    scale costs ~20 dB against float32's ~138)."""
    xr, xi = _t(*planes)
    got = cp.i8full(xr, xi)
    want = cp.gmm_tf32_plain(xr.double(), xi.double())
    db = dsputils.snr_db(_c(got), _c(want))
    assert 120.0 <= db < 135.0
    concat = cp.i8_concat(xr, xi)
    assert torch.equal(concat[0], got[0]) and torch.equal(concat[1], got[1])


def test_fragment_order_is_the_mma_b_map():
    """_frag_planes puts T[32 ks + 16 h + 4 t + q][8 nt + g] at byte
    ((nt * 4 + ks) * 32 + 4 g + t) * 8 + 4 h + q: mma_s8.cuh's B fragment
    (b0 then b1, the lowest k in the lowest byte) of lane 4 g + t."""
    rng = np.random.default_rng(4)
    t = rng.integers(-128, 128, size=(128, 128)).astype(np.int8)
    packed = cp._frag_planes(torch.from_numpy(t)).numpy()
    for nt, ks, g, tt, h, q in ((0, 0, 0, 0, 0, 0), (15, 3, 7, 3, 1, 3), (5, 2, 3, 1, 0, 2),
                                (9, 1, 6, 2, 1, 1)):
        assert packed[((nt * 4 + ks) * 32 + 4 * g + tt) * 8 + 4 * h + q] == \
            t[32 * ks + 16 * h + 4 * tt + q, 8 * nt + g]
    assert sorted(packed.tolist()) == sorted(t.ravel().tolist())


def test_fragment_map_check_holds_on_the_plain_versions():
    """probes.int8.fragment_maps' expected values (3 x the rolled sum of the
    quantized planes times 1e-5) are what the plain versions give."""
    rng = np.random.default_rng(5)
    xr, xi = _t(*(rng.normal(size=(2, 19, 512)) * 0.3).astype(np.float32))
    assert int8.fragment_maps(xr, xi) == {"identity": True, "cyclic_shift": True}
    assert launch_counts()["i8mm"] == 0  # CPU tensors take the plain version


def test_i8mm_saturates_out_of_range():
    """Quantized values past int8's range saturate (cvt.rzi.sat's rule) in
    the plain version, as in the kernel."""
    xr = torch.full((1, 128), 3.0)
    xi = torch.full((1, 128), -3.0)
    eye = torch.eye(128, dtype=torch.int8)
    tables = (torch.cat([eye, torch.zeros(128, 256, dtype=torch.int8)], 1)[None],
              torch.zeros(1, 128, 256, dtype=torch.int8), torch.zeros(1, 128, 128, dtype=torch.int8))
    yr, yi = cp.i8mm(xr, xi, tables)
    # a = 127, b = -128, s = trunc(0 x 50) = 0: yr = (127 - 128) 1e-5
    assert torch.equal(yr, torch.full((1, 128), -1.0) * 1e-5) and torch.equal(yi, torch.zeros(1, 128))


@pytest.mark.parametrize("name", TWINS)
def test_wrappers_check_dtype_shape_and_device(name):
    fn = getattr(cp, name)
    for a, b in ((torch.zeros(2, 1000), torch.zeros(2, 1000)),
                 (torch.zeros(2, 2048), torch.zeros(2, 2048)),
                 (torch.zeros(2, 256), torch.zeros(3, 256)), (torch.zeros(256), torch.zeros(256)),
                 (torch.zeros(2, 256), torch.zeros(2, 256, device="meta"))):
        with pytest.raises(ValueError):
            fn(a, b)
    with pytest.raises(TypeError):
        fn(torch.zeros(2, 256, dtype=torch.float64), torch.zeros(2, 256, dtype=torch.float64))
    if name in ("i8mm", "i8dec"):
        x = torch.zeros(2, 256)
        with pytest.raises(TypeError):
            fn(x, x, [torch.zeros(2, 128, c) for c in (384, 256, 128)])
        with pytest.raises(ValueError):
            fn(x, x, [torch.zeros(1, 128, c, dtype=torch.int8) for c in (384, 256, 128)])
        with pytest.raises(ValueError):
            fn(x, x, [torch.zeros(2, 128, c, dtype=torch.int8, device="meta")
                      for c in (384, 256, 128)])
    out = fn(torch.zeros(0, 512), torch.zeros(0, 512))
    assert out[0].shape == (0, 512) and out[1].shape == (0, 512)
    assert launch_counts()[name] == 0  # CPU tensors take the plain version


def test_i8_dot_checks_dtype_shape_and_device():
    i8 = dict(dtype=torch.int8)
    with pytest.raises(TypeError):
        cp.i8_dot(torch.zeros(4, 8), torch.zeros(8, 4, **i8))
    for a, b in ((torch.zeros(4, 8, **i8), torch.zeros(7, 4, **i8)),
                 (torch.zeros(8, **i8), torch.zeros(8, 4, **i8)),
                 (torch.zeros(4, 8, **i8), torch.zeros(8, 4, device="meta", **i8))):
        with pytest.raises(ValueError):
            cp.i8_dot(a, b)
    assert cp.i8_dot(torch.zeros(3, 0, **i8), torch.zeros(0, 5, **i8)).eq(0).all()


def test_int8_probe_rows_on_the_cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = int8.run("cpu", b=64, emit=lambda s: None)
    finally:
        torch.set_num_threads(threads)
    assert sorted(k for k in out if k != "check") == sorted(int8.ROWS)
    chk = out["check"]
    assert all(chk["dot_exact"].values()) and len(chk["dot_exact"]) == 2
    assert all(chk[f"{name}_equal"] for name in TWINS) and chk["i8full_equal_i8_concat"]
    assert 120.0 <= chk["i8full_vs_float64_db"] and 120.0 <= chk["i8full_vs_float64_db_snr_rows"]
    assert sorted(chk["max_abs_err"]) == sorted(("i8_dot",) + TWINS)
    pts = 64 * int8.N
    for name in int8.ROWS:
        r = out[name]
        assert r["ms"] > 0 and r["bound_by"] in ("bytes", "operations"), name
        assert (r["library_ms"] is None) == (name in ("i8mm", "i8dec")), name
    for name, ops in int8.INT8_PER_POINT.items():
        assert out[name]["bound_by"] == "bytes", name
        assert out[name]["int8_ms"] == pytest.approx(ops * pts / 1979e12 * 1e3), name
    assert out["gmm"]["bound_by"] == "operations" and out["copy"]["of_copy"] == 1.0


def test_int8_probe_main_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert int8.main() == 1


@pytest.mark.parametrize("b", [1, 15, 17, 63, 65, 1001])
@pytest.mark.parametrize("n1", [1, 2, 4, 8])
def test_i8_concat_and_its_yardstick_on_cpu_tensors_are_i8full_plain(n1, b):
    """On CPU tensors i8_concat (the cluster redesign) and i8_concat_stream
    (its first design) take i8full's plain version, ragged b included; no
    launch is counted."""
    rng = np.random.default_rng(17 * b + n1)
    xr, xi = (torch.from_numpy(v) for v in rng.normal(size=(2, b, 128 * n1)).astype(np.float32))
    want = cp.i8full_plain(xr, xi)
    before = launch_counts()
    for fn in (cp.i8_concat, cp.i8_concat_stream):
        got = fn(xr, xi)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    after = launch_counts()
    assert after["i8_concat"] == before["i8_concat"]
    assert after["i8_concat_stream"] == before["i8_concat_stream"]


def test_i8_concat_yardstick_checks_dtype_shape_and_device():
    fn = cp.i8_concat_stream
    for a, b in ((torch.zeros(2, 1000), torch.zeros(2, 1000)),
                 (torch.zeros(2, 2048), torch.zeros(2, 2048)),
                 (torch.zeros(2, 256), torch.zeros(3, 256)), (torch.zeros(256), torch.zeros(256)),
                 (torch.zeros(2, 256), torch.zeros(2, 256, device="meta"))):
        with pytest.raises(ValueError):
            fn(a, b)
    with pytest.raises(TypeError):
        fn(torch.zeros(2, 256, dtype=torch.float64), torch.zeros(2, 256, dtype=torch.float64))


_DOT_PLAN_SHAPES = [(256, 128, 128), (1, 1, 1), (17, 33, 5), (1001, 128, 384), (300, 256, 72),
                    (64, 1024, 48), (40, 640, 32), (0, 8, 8), (32 * 65535 + 40, 16, 16)]


@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("m,k,n", _DOT_PLAN_SHAPES)
def test_i8_dot_plan_covers_c_once(m, k, n, aligned):
    """i8_dot's plan: 32 x 32 tiles on a row grid (grid.y <= 65535, the z
    slices past the last row tile idle), every element of c in exactly one
    CTA's tile; the 16-byte path exactly where both operands are aligned
    and k % 16 == n % 16 == 0; the whole depth in one round where k <= 512
    (at most four 128-deep chunks), within 48 KB of shared memory."""
    plan = cp.i8_dot_plan(m, k, n, aligned)
    assert plan.vec == int(aligned and k % 16 == 0 and n % 16 == 0)
    assert plan.stages == min(-(-k // 128), 4) and plan.smem <= 48 * 1024
    assert plan.gy <= 65535 and plan.threads == 128 and plan.tile == 32
    tiles = cp.i8_dot_tiles(plan, m)
    assert len(tiles) == plan.ctas == plan.gx * plan.gy * plan.gz
    owned = [t for t in tiles if t is not None]
    assert len(owned) == len(set(owned))
    assert set(owned) == {(32 * r, 32 * c) for r in range(-(-m // 32)) for c in range(-(-n // 32))}
    assert all(t is None for t in tiles[len(owned):])  # the idle CTAs come last


def test_i8_dot_plan_fills_the_card_at_the_probes_shape():
    """At the TPU probe's (256, 128) @ (128, 128): at least 32 CTAs, the
    16-byte path, one chunk."""
    plan = cp.i8_dot_plan(256, 128, 128)
    assert plan.ctas >= 32 and plan.vec == 1 and plan.stages == 1


def test_i8_dot_plan_refuses_a_negative_extent():
    with pytest.raises(ValueError):
        cp.i8_dot_plan(-1, 4, 4)


@pytest.mark.parametrize("m,k,n", [(5, 7, 3), (33, 100, 70), (64, 128, 32)])
def test_i8_dot_bytes_on_cpu_tensors_is_the_plain_version(m, k, n):
    """i8_dot's first design (the yardstick) takes the plain version for CPU
    tensors and checks its operands as i8_dot does."""
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.integers(-128, 128, size=(m, k)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-128, 128, size=(k, n)).astype(np.int8))
    assert torch.equal(cp.i8_dot_bytes(a, b), cp.i8_dot(a, b))
    with pytest.raises(TypeError):
        cp.i8_dot_bytes(a.float(), b)
    with pytest.raises(ValueError):
        cp.i8_dot_bytes(a, b[1:])
