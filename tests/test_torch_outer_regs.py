"""K8's register-radix design (csrc/outer_kernel.cu) on the CPU.

The kernel cannot run here, so its host side is held instead:
ops/cuda_outer.py's float64 model of it (outer_dft_regs_model: each
column's transform by the passes of ops/cuda_fft.py's row model, the
twiddle factored as the kernel forms it for a tile of columns, and the
row permutation) against the float64 plain version at <= 1e-12 relative
at every m = 2..2048, ragged n3 (1, 7, 1001) and d2 > 1; the model
rounded to float32 against godsp_tpu's outer_dft_split in interpret mode
at >= 100 dB (tests/test_pallas.py's bound); the model under the
four-step identity against godsp_tpu's public fft/ifft in float64 at
go-dsp's 1e-8 (pretty_close); the column tile (tile) and its tables; the
banks of every warp access of every exchange plan (one word a bank); and
the radix-2 yardstick outer_dft_radix2 on CPU tensors being the plain
version.  The kernel itself runs in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godsp_tpu import fft as jfft
from godsp_tpu.ops.pallas_outer import outer_dft_split as jouter
from godsp_tpu_torch import default_device, dsputils, set_default_device
from godsp_tpu_torch.ops import cuda_fft, cuda_outer, cuda_probes, launch_counts

MS = [1 << k for k in range(1, 12)]
REL = 1e-12  # model vs plain version, both float64
SNR_KERNEL_DB = 100.0  # float32-rounded model vs the interpret-mode JAX kernel
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _host_data_on_cpu():
    """Host data goes to the CPU here; the port's default device is the card."""
    old = default_device()
    set_default_device("cpu")
    yield
    set_default_device(old)


def _planes(b, m, n3, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, m, n3)), rng.normal(size=(b, m, n3))


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _c(planes):
    return np.asarray(planes[0], np.float64) + 1j * np.asarray(planes[1], np.float64)


def _splits(m):
    """(d1, d2) row factorings of m: the single level, two levels, all d2."""
    return sorted({(m, 1), (m // 2, 2) if m >= 4 else (m, 1), (2, m // 2) if m >= 4 else (m, 1)})


# ---------------------------------------------------------------- the model


@pytest.mark.parametrize("n3", [1, 7, 1001])
@pytest.mark.parametrize("m", MS)
def test_outer_model_is_the_plain_version(m, n3):
    xr, xi = _planes(2 if n3 < 1001 else 1, m, n3, m + n3)
    tr, ti = torch.from_numpy(xr), torch.from_numpy(xi)
    for d1, d2 in _splits(m):
        for inverse in (False, True):
            got = _c(cuda_outer.outer_dft_regs_model(xr, xi, d1, d2, inverse))
            want = _c(cuda_outer.outer_dft_split_plain(tr, ti, d1, d2, inverse))
            assert _rel(got, want) <= REL, (d1, d2, inverse)


def test_outer_model_keeps_leading_axes():
    xr, xi = _planes(6, 16, 40, 1)
    got = cuda_outer.outer_dft_regs_model(xr.reshape(2, 3, 16, 40), xi.reshape(2, 3, 16, 40), 4, 4)
    assert got[0].shape == (2, 3, 16, 40)
    np.testing.assert_array_equal(got[0].reshape(6, 16, 40),
                                  cuda_outer.outer_dft_regs_model(xr, xi, 4, 4)[0])
    with pytest.raises(ValueError):
        cuda_outer.outer_dft_regs_model(xr, xi, 4, 2)


# ---------------------------------------------------------------- against godsp_tpu


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("b,d1,d2,n3", [(2, 4, 4, 256), (1, 128, 1, 256), (1, 8, 8, 384)])
def test_outer_model_vs_jax_kernel(b, d1, d2, n3, inverse):
    """The model rounded to float32 against pallas_outer.outer_dft_split in
    interpret mode (its lane rule: n3 a multiple of 128, d1, d2 <= 128)."""
    xr, xi = (p.astype(np.float32) for p in _planes(b, d1 * d2, n3, d1 + n3))
    jr, ji = jouter(jnp.asarray(xr), jnp.asarray(xi), d1, d2, inverse=inverse, interpret=True)
    got = cuda_outer.outer_dft_regs_model(xr, xi, d1, d2, inverse)
    got = got[0].astype(np.float32) + 1j * got[1].astype(np.float32)
    assert dsputils.snr_db(got, np.asarray(jr) + 1j * np.asarray(ji)) >= SNR_KERNEL_DB


@pytest.mark.parametrize("m,n3,d2", [(128, 64, 1), (64, 256, 1), (1024, 16, 1), (16, 32, 4)])
def test_outer_model_under_the_four_step_vs_jax_public_fft(m, n3, d2):
    """The model, then the n3-point FFT of every row, is the N-point DFT:
    bin k + m k3 at row (k % d1) d2 + k / d1, column k3 (fft/large.py's
    plan), against godsp_tpu's public fft and ifft in float64."""
    d1 = m // d2
    rng = np.random.default_rng(m + n3)
    x = rng.normal(size=m * n3) + 1j * rng.normal(size=m * n3)
    k = np.arange(m)
    rows = (k % d1) * d2 + k // d1
    for inverse, ref in ((False, jfft.fft(x)), (True, jfft.ifft(x))):
        yr, yi = cuda_outer.outer_dft_regs_model(x.real.reshape(m, n3), x.imag.reshape(m, n3),
                                                 d1, d2, inverse)
        y = yr + 1j * yi
        rowfft = np.conj(np.fft.fft(np.conj(y), axis=-1)) if inverse else np.fft.fft(y, axis=-1)
        full = rowfft[rows].T.reshape(-1)  # bin k + m k3
        if inverse:
            full = full / (m * n3)
        assert dsputils.pretty_close(full, np.asarray(ref))


# ---------------------------------------------------------------- the tile and its tables


@pytest.mark.parametrize("m", MS)
def test_tile(m):
    t = cuda_outer.tile(m)
    g = cuda_fft.geometry(m)
    assert t.columns * 4 >= 32  # a warp access of a row: at least one 32-byte sector
    assert t.threads == g.threads * t.columns <= 1024
    assert t.smem <= cuda_fft.MAX_SMEM
    assert t.smem == (t.columns * m * 8 if len(g.radices) >= 2 else 0)
    want = {64: (64, 256), 128: (32, 256), 256: (32, 512), 1024: (8, 256), 2048: (8, 1024)}
    if m in want:
        assert (t.columns, t.threads) == want[m]


@pytest.mark.parametrize("bad", [1, 3, 4096])
def test_tile_rejects_other_sizes(bad):
    with pytest.raises(ValueError):
        cuda_outer.tile(bad)


@pytest.mark.parametrize("inverse", [False, True])
def test_tile_table_is_float64_rounded_once(inverse):
    n, m, c = 1 << 20, 128, 32
    tab = cuda_outer._tile_table(n, m, c, inverse, CPU).numpy()
    assert tab.shape == (m * c, 2)
    p = (np.arange(m)[:, None] * np.arange(c)[None, :]).reshape(-1)
    want = np.exp((2j if inverse else -2j) * np.pi * p / n)
    np.testing.assert_array_equal(tab[:, 0], want.real.astype(np.float32))
    np.testing.assert_array_equal(tab[:, 1], want.imag.astype(np.float32))


# ---------------------------------------------------------------- shared memory


def _exchange_accesses(m):
    """Every warp access of every exchange of the m-point column passes in
    one tile: thread (t, c) = t C + c, logical index i of column c at word
    L(i) C + c of each plane (fft_regs.cuh's Slot with Q = C)."""
    g = cuda_fft.geometry(m)
    C = cuda_outer.tile(m).columns
    tid = np.arange(g.threads * C)
    t, c = tid // C, tid % C
    P, T = g.points, g.threads
    accesses, ns = [], 1
    for p, r in enumerate(g.radices[:-1]):
        for b in range(P // r):  # the writes of pass p
            j = t + b * T
            out = (j // ns) * ns * r + (j & (ns - 1))
            for rr in range(r):
                accesses.append(cuda_fft.exchange_swizzle(out + rr * ns, ns, r) * C + c)
        r2 = g.radices[p + 1]
        for b in range(P // r2):  # the reads of pass p + 1
            j = t + b * T
            for rr in range(r2):
                accesses.append(cuda_fft.exchange_swizzle(j + rr * (m // r2), ns, r) * C + c)
        ns *= r
    return [a[32 * w:32 * (w + 1)] for a in accesses for w in range(len(tid) // 32)]


@pytest.mark.parametrize("m", MS)
def test_column_exchanges_are_free_of_bank_conflicts(m):
    """Each warp of the tile spans 32 / C logical indices of C interleaved
    columns; every access of every exchange touches each bank once."""
    accesses = _exchange_accesses(m)
    if len(cuda_fft.radix_plan(m)) < 2:
        assert not accesses  # one pass: no exchange
        return
    for a in accesses:
        assert int(np.bincount(np.unique(a) % 32, minlength=32).max()) == 1


def test_column_exchanges_would_conflict_unswizzled():
    """Without the swizzle, m = 1024's eight columns would put the four
    logical indices of a warp's write on one bank octet: the count sees it."""
    g = cuda_fft.geometry(1024)
    C = cuda_outer.tile(1024).columns
    t = np.arange(32) // C
    i = t * g.radices[0]  # pass 0's first write: out(j) = j R at r = 0
    words = i * C + np.arange(32) % C
    assert int(np.bincount(np.unique(words) % 32, minlength=32).max()) == 32 // C


# ---------------------------------------------------------------- the yardstick on the CPU


def test_radix2_outer_yardstick_on_cpu_is_the_plain_version():
    xr, xi = (torch.from_numpy(p.astype(np.float32)) for p in _planes(2, 64, 40, 7))
    before = launch_counts()["outer_dft_radix2"]
    for d1, d2, inverse in ((64, 1, False), (8, 8, True)):
        got = cuda_probes.outer_dft_radix2(xr, xi, d1, d2, inverse)
        want = cuda_outer.outer_dft_split_plain(xr, xi, d1, d2, inverse)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert launch_counts()["outer_dft_radix2"] == before  # CPU tensors never launch
    with pytest.raises(ValueError):
        cuda_probes.outer_dft_radix2(xr, xi, 32, 1)
    with pytest.raises(ValueError):
        cuda_probes.outer_dft_radix2(torch.zeros(4096, 2), torch.zeros(4096, 2), 4096, 1)
