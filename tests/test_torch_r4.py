"""K14e, the lane flip (ops/cuda_probes.py: lane_flip), K1's rows-a-block
probe wrapper (fft_pow2_rows) and the probe script probes/r4.py on the
CPU.

lane_flip's plain version is held against the TPU body it replaces:
tools/probe_r4.py keeps kf as a closure in main(), under `if stage in
("flip", "all"):`, so the file is parsed with ast (it is only read, never
run; it imports jax at its top) and kf is executed in a namespace holding
jnp, then run in a pl.pallas_call(interpret=True) of one (8, 128) block as
at :66-69, on the probe's own input (each row 0..127) and on seeded
random values: exactly equal (a reversal and a doubling round nothing).
fft_pow2_rows's limits are checked without touching a device, and on the
CPU every setting gives fft_pow2's plain result.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from godsp_tpu_torch import default_device, set_default_device
from godsp_tpu_torch.ops import cuda_fft, launch_counts
from godsp_tpu_torch.ops import cuda_probes as cp
from godsp_tpu_torch.probes import r3, r4

TOOL = pathlib.Path(__file__).resolve().parent.parent / "tools" / "probe_r4.py"


@pytest.fixture(autouse=True)
def _host_data_on_cpu():
    """Host data goes to the CPU here; the port's default device is the card."""
    old = default_device()
    set_default_device("cpu")
    yield
    set_default_device(old)


@pytest.fixture(scope="module")
def kf():
    import jax.numpy as jnp

    main = next(node for node in ast.parse(TOOL.read_text()).body
                if isinstance(node, ast.FunctionDef) and node.name == "main")
    block = next(node for node in main.body
                 if isinstance(node, ast.If) and "flip" in ast.unparse(node.test))
    defs = [node for node in block.body if isinstance(node, ast.FunctionDef) and node.name == "kf"]
    assert len(defs) == 1
    ns = {"jnp": jnp}
    exec(compile(ast.Module(body=defs, type_ignores=[]), str(TOOL), "exec"), ns)
    return ns["kf"]


@pytest.mark.parametrize("data", ["probe input", "random"])
def test_lane_flip_plain_equals_the_tpu_body(kf, data):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    if data == "probe input":
        x = np.tile(np.arange(128, dtype=np.float32)[None], (8, 1))
        assert np.array_equal(x, r4.flip_input("cpu").numpy())
    else:
        x = np.random.default_rng(4).normal(size=(8, 128)).astype(np.float32)
    want = np.asarray(pl.pallas_call(
        kf, out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32), interpret=True)(
            jnp.asarray(x)))
    got = cp.lane_flip_plain(torch.from_numpy(x))
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    assert torch.equal(cp.lane_flip(torch.from_numpy(x)), got)


def test_lane_flip_wrapper_checks():
    for bad in (torch.zeros(4, 64), torch.zeros(2, 256), torch.zeros(())):
        with pytest.raises(ValueError, match="128"):
            cp.lane_flip(bad)
    assert cp.lane_flip(torch.zeros(0, 128)).shape == (0, 128)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(3, 2, 128)).astype(np.float32))
    got = cp.lane_flip(x)
    assert got.shape == (3, 2, 128)
    assert torch.equal(got[1, 0, 127 - torch.arange(128)], 2 * x[1, 0])
    v = x.transpose(0, 1)  # a strided view gives what its contiguous copy gives
    assert not v.is_contiguous() and torch.equal(cp.lane_flip(v), cp.lane_flip(v.contiguous()))
    assert launch_counts()["lane_flip"] == 0  # CPU tensors take the plain version


@pytest.mark.parametrize("n,rows_per_block,fits", [
    (1024, 1, True), (1024, 16, True), (1024, 17, False), (8192, 2, True), (8192, 4, False),
    (16384, 1, True), (16384, 2, False), (256, 0, False), (256, -1, False)])
def test_fft_pow2_rows_limits(n, rows_per_block, fits):
    """A CTA of rows_per_block rows must stay within the kernel's launch
    bound (512 threads up to n = 1024, a warp a row; 1024 above, n / 16 a
    row) and its slots' 8 B a point within the 227 KB (232,448 B) a block
    may use, and the rows must be positive; checked before any device
    work."""
    assert cp.fft_rows_fit(n, rows_per_block) is fits
    x = torch.zeros(2, n)
    if fits:
        got = cp.fft_pow2_rows(x, x, rows_per_block)
        assert got[0].shape == (2, n)
    else:
        with pytest.raises(ValueError, match="shared memory"):
            cp.fft_pow2_rows(x, x, rows_per_block)
        meta = torch.zeros(2, n, device="meta")
        with pytest.raises(ValueError, match="shared memory"):
            cp.fft_pow2_rows(meta, meta, rows_per_block)


def test_fft_pow2_rows_is_k1():
    rng = np.random.default_rng(6)
    xr, xi = (torch.from_numpy(v) for v in rng.normal(size=(2, 3, 5, 4096)).astype(np.float32))
    want = cuda_fft.fft_pow2(xr, xi)
    for r in (1, 2, 4):
        got = cp.fft_pow2_rows(xr, xi, r)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for bad in ((torch.zeros(2, 1000), torch.zeros(2, 1000)), (torch.zeros(2, 256),
                                                               torch.zeros(3, 256))):
        with pytest.raises(ValueError):
            cp.fft_pow2_rows(*bad, 1)
    assert launch_counts()["fft_pow2_rows"] == 0


def test_r4_rows_on_the_cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    shapes = {(4, 8192): (1, 2), (2, 16384): (1,)}
    try:
        out = r4.run("cpu", b=64, shapes=shapes, emit=lambda s: None)
    finally:
        torch.set_num_threads(threads)
    assert sorted(k for k in out if k != "check") == sorted(r4.LANE_ROWS + r3.row_names(shapes))
    chk = out["check"]
    assert chk["flip_tpu_input_exact"] and chk["flip_exact"]
    assert chk["rfft_vs_float64_db"] >= 120.0
    assert chk["k1_rows_equal"] == {"4x8192": True, "2x16384": True}
    assert chk["max_abs_err"]["lane_flip"] == 0.0
    for name, r in out.items():
        if name != "check":
            assert r["ms"] > 0 and r["library_ms"] > 0, name
    # The flip moves one plane (8 B a point), K3 one plane in and 513 bins
    # a row out, the copy two planes each way: bytes bound all three.
    pts = 64 * r4.N
    for name, nbytes in (("copy", 16 * pts), ("flip", 8 * pts), ("rfft", 64 * (4096 + 8 * 513))):
        assert out[name]["bound_by"] == "bytes"
        assert out[name]["bound_ms"] == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12), name
    assert r4.ROWS == r4.LANE_ROWS + r3.row_names(r4.SWEEP)
    assert set(r3.row_names(r4.SWEEP)) <= set(r3.ROWS)


def test_r4_main_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert r4.main() == 1
