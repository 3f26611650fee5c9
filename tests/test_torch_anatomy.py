"""K14d, the anatomy twins (ops/cuda_probes.py), and their probe script
(probes/anatomy2.py) on the CPU.

Each twin's plain version is held against the TPU body it replaces.
tools/probe_anatomy2.py keeps its bodies as closures in main(), so the
file is parsed with ast (it is only read, never run): the FunctionDefs
half3, slice8, resh, bd1, bd_hi and full are taken out of main's body
and executed in a namespace holding jnp, pf (godsp_tpu.ops.pallas_fft),
n, n1, bt and mm as at :52-53 and :169-173, with bt = 64 rows a block.
Each runs in a pl.pallas_call(interpret=True) shaped as
run_kernel_variant's (:67-100) at 64 rows x 1024, with the tables built
as at :156-164 and :184-188 and a seeded row tw.  Bounds: half3, slice8
and resh bit-equal to the float32 plain versions (the same IEEE adds);
bd1 (the plain version without TF32 rounding), bd_hi and full >= 100 dB
between the float64 plain version and the float32 interpret-mode body,
as for the other probes.
"""

import ast
import functools
import pathlib
import re

import numpy as np
import pytest
import torch

from godsp_tpu_torch import default_device, dsputils, set_default_device
from godsp_tpu_torch.fft.four_step import dft_matrix
from godsp_tpu_torch.ops import cuda_probes as cp
from godsp_tpu_torch.ops import launch_counts
from godsp_tpu_torch.probes import anatomy2, slice8

TOOL = pathlib.Path(__file__).resolve().parent.parent / "tools" / "probe_anatomy2.py"
BODIES = ("half3", "slice8", "resh", "bd1", "bd_hi", "full")
ROWS, N, BT = 64, 1024, 64
SNR_DB = 100.0
TWINS = ("half3", "slice8_add", "reshape_add", "bd_tf32", "bd_hi", "anat_full")


@pytest.fixture(autouse=True)
def _host_data_on_cpu():
    """Host data goes to the CPU here; the port's default device is the card."""
    old = default_device()
    set_default_device("cpu")
    yield
    set_default_device(old)


@pytest.fixture(scope="module")
def tpu():
    """The six bodies, their tables and the inputs (numpy float32)."""
    import jax
    import jax.numpy as jnp

    from godsp_tpu.fft.four_step import dft_matrix as jax_dft_matrix
    from godsp_tpu.ops import pallas_fft as pf

    main = next(node for node in ast.parse(TOOL.read_text()).body
                if isinstance(node, ast.FunctionDef) and node.name == "main")
    defs = [node for node in main.body
            if isinstance(node, ast.FunctionDef) and node.name in BODIES]
    assert sorted(d.name for d in defs) == sorted(BODIES)
    n1 = N // 128
    ns = {"jnp": jnp, "pf": pf, "n": N, "n1": n1, "bt": BT,
          "mm": functools.partial(jax.lax.dot_general, dimension_numbers=(((1,), (0,)), ((), ())),
                                  preferred_element_type=jnp.float32)}
    exec(compile(ast.Module(body=defs, type_ignores=[]), str(TOOL), "exec"), ns)

    f2 = jax_dft_matrix(128)
    bd_r = np.zeros((N, N), np.float32)
    bd_i = np.zeros((N, N), np.float32)
    for k in range(n1):
        bd_r[k * 128:(k + 1) * 128, k * 128:(k + 1) * 128] = f2.real
        bd_i[k * 128:(k + 1) * 128, k * 128:(k + 1) * 128] = f2.imag
    limbs = [jnp.asarray(v) for m in (bd_r, bd_i, bd_r + bd_i) for v in pf._limb3_np(m)]
    rng = np.random.default_rng(0)
    xr = (rng.normal(size=(ROWS, N)) * 0.1).astype(np.float32)
    xi = (rng.normal(size=(ROWS, N)) * 0.1).astype(np.float32)
    tw = rng.normal(size=(1, N)).astype(np.float32)
    tables = {"half3": [], "slice8": [], "resh": [], "bd1": [jnp.asarray(bd_r), jnp.asarray(bd_i)],
              "bd_hi": limbs, "full": [jnp.asarray(tw)] + limbs}
    return ns, tables, xr, xi, tw


def _pallas(body, tables, xr, xi):
    """run_kernel_variant's kernel and call (:67-100) in interpret mode."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    def kern(*refs):
        xr_ref, xi_ref, *rest = refs
        *tab_refs, yr_ref, yi_ref = rest
        yr, yi = body(xr_ref[:], xi_ref[:], *[t[:] for t in tab_refs])
        yr_ref[:] = yr
        yi_ref[:] = yi

    spec = pl.BlockSpec((BT, N), lambda i: (i, 0), memory_space=pltpu.VMEM)
    const = [pl.BlockSpec(t.shape, lambda i, nd=t.ndim: (0,) * nd, memory_space=pltpu.VMEM)
             for t in tables]
    out = pl.pallas_call(
        kern, grid=(ROWS // BT,), in_specs=[spec, spec] + const, out_specs=(spec, spec),
        out_shape=(jax.ShapeDtypeStruct((ROWS, N), jnp.float32),
                   jax.ShapeDtypeStruct((ROWS, N), jnp.float32)),
        interpret=True)(jnp.asarray(xr), jnp.asarray(xi), *tables)
    return np.asarray(out[0]), np.asarray(out[1])


def _c(planes):
    return np.asarray(planes[0], np.float64) + 1j * np.asarray(planes[1], np.float64)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("body", BODIES)
def test_plain_matches_the_tpu_body(tpu, body):
    ns, tables, xr, xi, tw = tpu
    want = _pallas(ns[body], tables[body], xr, xi)
    x32, x64 = _t(xr, xi), _t(xr.astype(np.float64), xi.astype(np.float64))
    if body in ("half3", "slice8", "resh"):
        plain = cp.half3_plain if body == "half3" else cp.add_one_plain
        got = plain(*x32)
        assert got[0].dtype == torch.float32
        assert np.array_equal(got[0].numpy(), want[0]) and np.array_equal(got[1].numpy(), want[1])
        return
    if body == "bd1":
        got = cp.bd_tf32_plain(*x64)
    elif body == "bd_hi":
        got = cp.bd_hi_plain(*x64)
    else:
        got = cp.anat_full_plain(*x64, torch.from_numpy(tw[0].astype(np.float64)))
    assert dsputils.snr_db(_c(got), _c(want)) >= SNR_DB


def test_half3_is_twice_the_butterfly():
    """In exact arithmetic three rounds give 2 [u + v, u - v]."""
    rng = np.random.default_rng(3)
    xr, xi = _t(*(rng.normal(size=(2, 4, 256)).astype(np.float64)))
    got = cp.half3(xr, xi)
    for g, x in zip(got, (xr, xi)):
        u, v = x[:, :128], x[:, 128:]
        assert torch.allclose(g, 2 * torch.cat([u + v, u - v], dim=1), rtol=0, atol=1e-14)


def test_round_tf32_chosen_values():
    one = 1.0
    cases = {one + 2.0 ** -11: one + 2.0 ** -10,   # a tie: away from zero
             one + 2.0 ** -12: one,                # below half an ulp
             one + 3 * 2.0 ** -11: one + 2.0 ** -9,  # a tie between 1 + 2^-10 and 1 + 2^-9
             one + 2.0 ** -10: one + 2.0 ** -10,   # exact in TF32
             0.0: 0.0}
    x = torch.tensor(list(cases), dtype=torch.float32)
    want = torch.tensor(list(cases.values()), dtype=torch.float32)
    assert torch.equal(cp.round_tf32(x), want)
    assert torch.equal(cp.round_tf32(-x), -want)  # negatives mirror
    assert cp.round_tf32(x.double()).dtype == torch.float64


def test_round_tf32_error_bound():
    """Half an ulp of a 10-bit mantissa: |round(x) - x| <= 2^-11 |x|, and the
    low 13 bits of the result are zero."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.normal(size=100_000) * 10.0 ** rng.integers(-20, 20, 100_000))
                         .astype(np.float32))
    r = cp.round_tf32(x)
    assert ((r.view(torch.int32) & 0x1FFF) == 0).all()
    err = (r.double() - x.double()).abs()
    assert (err <= 2.0 ** -11 * x.double().abs()).all()
    assert err.max() > 0


def test_hi_tables_reconstruct_f128():
    """big + small of Re F, Im F and Re F + Im F, added in float32, within
    2^-22 of the float64 value, relative; every half TF32-exact; and
    F[j, k] = F[1, j k mod 128] over the whole matrix."""
    tab = cp.hi_tables()
    assert tab.shape == (6, 128) and tab.dtype == np.float32
    assert (tab.view(np.uint32) & 0x1FFF == 0).all()
    f = dft_matrix(128)
    jk = np.outer(np.arange(128), np.arange(128)) % 128
    assert np.abs(f[1][jk] - f).max() < 1e-12
    for p, v in enumerate((f[1].real, f[1].imag, f[1].real + f[1].imag)):
        rec = (tab[2 * p] + tab[2 * p + 1]).astype(np.float64)
        assert (np.abs(rec - v) <= 2.0 ** -22 * np.abs(v)).all(), p
        assert np.abs(tab[2 * p + 1]).max() <= 2.0 ** -11 * np.abs(v).max()


def test_bd_tf32_wrapper_is_the_rounded_product():
    rng = np.random.default_rng(7)
    xr, xi = _t(*(rng.normal(size=(2, 9, 256)).astype(np.float32)))
    got = cp.bd_tf32(xr, xi)
    want = cp.bd_tf32_plain(xr, xi, tf32=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    eye = cp.bd_tf32(xr, xi, torch.eye(128))
    assert torch.equal(eye[0], cp.round_tf32(xr)) and torch.equal(eye[1], cp.round_tf32(xi))
    exact = cp.bd_tf32_plain(xr.double(), xi.double())
    assert 50.0 < dsputils.snr_db(_c(got), _c(exact)) < 90.0  # 11 bits an operand


@pytest.mark.parametrize("name", TWINS)
def test_anatomy_wrappers_check_shapes(name):
    fn = getattr(cp, name)
    args = (lambda n: (torch.zeros(n),)) if name == "anat_full" else (lambda n: ())
    for a, b in ((torch.zeros(2, 1000), torch.zeros(2, 1000)),
                 (torch.zeros(2, 256), torch.zeros(3, 256)), (torch.zeros(256), torch.zeros(256))):
        with pytest.raises(ValueError):
            fn(a, b, *args(a.shape[-1]))
    if name in ("half3", "anat_full"):
        big = torch.zeros(1, 2 * cp.MAX_STAGED_N)
        with pytest.raises(ValueError, match="at most"):
            fn(big, big, *args(big.shape[1]))
    if name == "anat_full":
        with pytest.raises(ValueError, match="tw"):
            fn(torch.zeros(2, 256), torch.zeros(2, 256), torch.zeros(128))
    if name == "bd_tf32":
        with pytest.raises(ValueError, match="table"):
            fn(torch.zeros(2, 256), torch.zeros(2, 256), torch.zeros(64, 64))
    out = fn(torch.zeros(0, 384), torch.zeros(0, 384), *args(384))
    assert out[0].shape == (0, 384) and out[1].shape == (0, 384)
    # A strided view gives what its contiguous copy gives.
    rng = np.random.default_rng(11)
    xr, xi = _t(*(rng.normal(size=(2, 256, 6)).astype(np.float32)))
    vr, vi = xr.T, xi.T
    assert not vr.is_contiguous()
    got, want = fn(vr, vi, *args(256)), fn(vr.contiguous(), vi.contiguous(), *args(256))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert launch_counts()[name] == 0  # CPU tensors take the plain version


def test_anatomy2_rows_on_the_cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = anatomy2.run("cpu", b=64, emit=lambda s: None)
    finally:
        torch.set_num_threads(threads)
    assert sorted(k for k in out if k != "check") == sorted(anatomy2.ROWS)
    chk = out["check"]
    assert chk["half3_equal"] and chk["slice8_equal"] and chk["reshape_equal"]
    assert min(chk["bd1_vs_tf32_plain_db"], chk["bd_hi_vs_float64_db"],
               chk["full_vs_float64_db"]) >= SNR_DB
    assert 50.0 < chk["bd1_vs_exact_db"] < 90.0
    for name in anatomy2.ROWS:
        r = out[name]
        assert r["ms"] > 0 and r["bound_by"] in ("bytes", "operations")
        assert (r["library_ms"] is None) == (name in ("half3", "full"))
    assert out["copy"]["of_copy"] == 1.0
    # bd1, bd_hi and full make their products on the tensor cores: their
    # TF32 operations (512, 2304, 2304 a point at 495 TFLOP/s) stay under
    # the bytes (16 B a point at 3.35 TB/s), which bound all three.
    for name in ("bd1", "bd_hi", "full"):
        r = out[name]
        assert r["bound_by"] == "bytes" and r["tf32_ms"] < r["bound_ms"], name
        assert r["bound_ms"] == pytest.approx(16.0 * 64 * anatomy2.N / 3.35e12 * 1e3, rel=1e-12)
    assert out["bd_hi"]["tf32_ms"] == out["full"]["tf32_ms"] > 4 * out["bd1"]["tf32_ms"]
    errs = chk["max_abs_err"]
    assert sorted(errs) == sorted(TWINS)
    assert errs["half3"] == errs["slice8_add"] == errs["reshape_add"] == 0.0
    assert max(errs["bd_tf32"], errs["bd_hi"], errs["anat_full"]) < 1e-2


def test_anatomy2_main_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert anatomy2.main() == 1


# ---------------------------------------------------------------- slice8_add redesigned

@pytest.mark.parametrize("b,n", [(64, 1024), (13, 384), (9, 1152), (1, 128)])
def test_slice8_add_and_its_first_design_on_the_cpu(b, n):
    """Both designs give add_one_plain on CPU tensors, at fewer slices than
    a chunk (384), a ragged chunk (1152) and rows that are not a multiple
    of a stage's SLICE8_ROWS."""
    rng = np.random.default_rng(b + n)
    xr, xi = _t(*(rng.normal(size=(2, b, n)).astype(np.float32)))
    want = cp.add_one_plain(xr, xi)
    before = launch_counts()
    for fn in (cp.slice8_add, cp.slice8_add_sync):
        got = fn(xr, xi)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert launch_counts() == before
    with pytest.raises(ValueError):
        cp.slice8_add_sync(torch.zeros(2, 1000), torch.zeros(2, 1000))


def test_slice8_probe_reads_its_kernel():
    """probes.slice8's variant copies find the first design's slice loop
    once and leave the redesign; sass_order reads a loop's loads and
    stores in issue order; in_flight counts blocks and bytes a SM."""
    for _, edits in slice8.VARIANTS:
        s = slice8.variant_source(edits)
        assert all(s.count(repl) == 1 for _, repl in edits) and "slice8_kernel(" in s
    with pytest.raises(LookupError):
        slice8.variant_source((("no such line", ""),))
    assert slice8.in_flight(40, 2) == (6, 6 * 8 * 2 * 512)
    assert slice8.in_flight(80, 16) == (3, 3 * 8 * 16 * 512)
    assert slice8.in_flight(26, 2) == (8, 8 * 8 * 2 * 512)
    assert slice8.in_flight(26, 2, 36 * 1024) == (6, 6 * 8 * 2 * 512)
    listing = "\n".join(f"        /*{a:04x}*/  {t} ;" for a, t in (
        (0x100, "LDG.E.128.CONSTANT R4, desc[UR4][R2.64]"),
        (0x110, "LDG.E.128.CONSTANT R8, desc[UR4][R2.64+0x200]"),
        (0x120, "FADD R4, R4, 1"), (0x130, "STG.E.128 desc[UR4][R6.64], R4"),
        (0x140, "STG.E desc[UR4][R6.64+0x4], R5"), (0x150, "@P0 BRA 0x100")))
    assert slice8.sass_order(listing) == ("LDG16 LDG16 STG16 STG4 BRA", 2)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            slice8.main([])
