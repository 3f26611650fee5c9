"""The register-radix design of K1/K2/K3 (csrc/fft_regs.cuh) on the CPU.

The kernels cannot run here, so their host side is held instead:
ops/cuda_fft.py's float64 model of the kernels' passes
(fft_pow2_stockham_model, rfft_packed_model: the same plan, table
indices, exchanges and split formula) against the float64 plain versions
at <= 1e-12 relative, every power of two 2..16384 at odd row counts; the
model rounded to float32 against the interpret-mode JAX kernels at
>= 100 dB (the bound tests/test_pallas.py uses) and against godsp_tpu's
public fft/rfft in float64 at go-dsp's 1e-8 (pretty_close); the plan
(radix_plan, geometry, cta_fits); every table float64-built and rounded
once, and fft_regs.cuh's float32 constants too; and every warp access of
every exchange free of shared-memory bank conflicts.  The kernels
themselves run in tests/test_torch_cuda.py.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godsp_tpu import fft as jfft
from godsp_tpu_torch import default_device, dsputils, set_default_device
from godsp_tpu_torch.ops import cuda_fft, cuda_probes, launch_counts

SIZES = [1 << k for k in range(1, 15)]
ROWS = [1, 3, 33]
REL = 1e-12  # model vs plain version, both float64
SNR_KERNEL_DB = 100.0  # float32-rounded model vs the interpret-mode JAX kernel
CPU = torch.device("cpu")
HEADER = pathlib.Path(cuda_fft.__file__).resolve().parent.parent / "csrc" / "fft_regs.cuh"


@pytest.fixture(autouse=True)
def _host_data_on_cpu():
    """Host data goes to the CPU here; the port's default device is the card."""
    old = default_device()
    set_default_device("cpu")
    yield
    set_default_device(old)


def _planes(n, rows, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(rows, n)), rng.normal(size=(rows, n))


def _c(planes):
    return np.asarray(planes[0], np.float64) + 1j * np.asarray(planes[1], np.float64)


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# ---------------------------------------------------------------- the model


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("n", SIZES)
def test_stockham_model_is_the_plain_version(n, rows):
    xr, xi = _planes(n, rows, n + rows)
    tr, ti = torch.from_numpy(xr), torch.from_numpy(xi)
    cases = [
        (cuda_fft.fft_pow2_stockham_model(xr, xi), cuda_fft.fft_pow2_plain(tr, ti)),
        (cuda_fft.fft_pow2_stockham_model(xr, xi, inverse=True, scale=1.0 / n),
         cuda_fft.ifft_pow2_plain(tr, ti, 1.0 / n)),
        (cuda_fft.fft_pow2_stockham_model(xr), cuda_fft.fft_pow2_plain(tr, None)),
    ]
    for got, want in cases:
        assert _rel(_c(got), _c(want)) <= REL


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("n", SIZES)
def test_rfft_packed_model_is_the_plain_version(n, rows):
    xr, _ = _planes(n, rows, 3 * n + rows)
    got = cuda_fft.rfft_packed_model(xr)
    assert got[0].shape == (rows, n // 2 + 1)
    want = cuda_fft.rfft_pow2_plain(torch.from_numpy(xr))
    assert _rel(_c(got), _c(want)) <= REL


def test_models_keep_leading_axes():
    xr, xi = _planes(64, 6, 5)
    got = cuda_fft.fft_pow2_stockham_model(xr.reshape(2, 3, 64), xi.reshape(2, 3, 64))
    flat = cuda_fft.fft_pow2_stockham_model(xr, xi)
    assert got[0].shape == (2, 3, 64)
    np.testing.assert_array_equal(got[0].reshape(6, 64), flat[0])
    half = cuda_fft.rfft_packed_model(xr.reshape(2, 3, 64))
    assert half[0].shape == (2, 3, 33)


@pytest.mark.parametrize("n", [2, 4])
def test_rfft_model_edge_sizes(n):
    """n = 2 (m = 1: no pass, the split alone) and n = 4 (one radix-2 pass)."""
    x = np.arange(1.0, 3 * n + 1).reshape(3, n)
    got = _c(cuda_fft.rfft_packed_model(x))
    np.testing.assert_allclose(got, np.fft.rfft(x), rtol=0, atol=1e-14)


# ---------------------------------------------------------------- against godsp_tpu


def _f32(planes):
    return tuple(np.asarray(p, np.float32) for p in planes)


@pytest.mark.parametrize("n", [256, 512])
def test_stockham_model_vs_jax_kernel(n):
    """The n of tests/test_torch_fft.py's K1 case: forward, real input and
    inverse with 1/n, the model rounded to float32, against
    pallas_fft.fft_pow2_split in interpret mode."""
    from godsp_tpu.ops.pallas_fft import fft_pow2_split

    rng = np.random.default_rng(n)
    xr, xi = (rng.normal(size=(3, n)).astype(np.float32) for _ in range(2))
    cases = [
        (cuda_fft.fft_pow2_stockham_model(xr, xi),
         fft_pow2_split(jnp.asarray(xr), jnp.asarray(xi), interpret=True)),
        (cuda_fft.fft_pow2_stockham_model(xr),
         fft_pow2_split(jnp.asarray(xr), None, interpret=True)),
        (cuda_fft.fft_pow2_stockham_model(xr, xi, inverse=True, scale=1.0 / n),
         fft_pow2_split(jnp.asarray(xr), jnp.asarray(xi), inverse=True, scale=1.0 / n,
                        interpret=True)),
    ]
    for got, want in cases:
        assert dsputils.snr_db(_c(_f32(got)), _c(want)) >= SNR_KERNEL_DB


@pytest.mark.parametrize("n", [256, 1024])
def test_rfft_model_vs_jax_kernel(n):
    """The n of tests/test_torch_fft.py's K3 case, against
    pallas_fft.rfft_pow2_split in interpret mode."""
    from godsp_tpu.ops.pallas_fft import rfft_pow2_split

    rng = np.random.default_rng(n + 5)
    xr = rng.normal(size=(3, n)).astype(np.float32)
    want = rfft_pow2_split(jnp.asarray(xr), interpret=True)
    got = _f32(cuda_fft.rfft_packed_model(xr))
    assert got[0].shape == (3, n // 2 + 1)
    assert dsputils.snr_db(_c(got), _c(want)) >= SNR_KERNEL_DB


@pytest.mark.parametrize("n", [256, 512, 1024])
def test_models_vs_jax_public_fft(n):
    """float64 model against godsp_tpu's public fft / ifft / fft_real / rfft
    at go-dsp's 1e-8."""
    rng = np.random.default_rng(2 * n)
    xr, xi = rng.normal(size=(3, n)), rng.normal(size=(3, n))
    x = xr + 1j * xi
    pairs = [
        (_c(cuda_fft.fft_pow2_stockham_model(xr, xi)), jfft.fft(x)),
        (_c(cuda_fft.fft_pow2_stockham_model(xr, xi, inverse=True, scale=1.0 / n)),
         jfft.ifft(x)),
        (_c(cuda_fft.fft_pow2_stockham_model(xr)), jfft.fft_real(xr)),
        (_c(cuda_fft.rfft_packed_model(xr)), jfft.rfft(xr)),
    ]
    for got, want in pairs:
        assert dsputils.pretty_close(got, np.asarray(want))


# ---------------------------------------------------------------- the plan


@pytest.mark.parametrize("n", SIZES)
def test_radix_plan(n):
    g = cuda_fft.geometry(n)
    plan = cuda_fft.radix_plan(n)
    assert int(np.prod(plan)) == n
    assert all(r in (2, 4, 8, 16, 32) for r in plan)
    assert all(r == g.points for r in plan[:-1]) and plan[-1] <= g.points
    assert g.points * g.threads == n
    assert g.warp is (n <= 1024)  # a row inside one warp up to 1024 points
    assert len(plan) <= (3 if n <= 1024 else 4)  # 1024: 2-3 passes; 16384: at most 4
    if n == 1024:
        assert plan == (32, 32)
    if n == 16384:
        assert plan == (16, 16, 16, 4) and g.threads == 1024  # 16 points a thread
    assert cuda_fft.cta_fits(n, g.default_rows)
    assert cuda_fft.cta_fits(n, g.default_rows, split=True)


def test_cta_shape_and_fit():
    assert cuda_fft.cta_shape(1024, 8) == (256, 8)
    assert cuda_fft.cta_shape(256, 3) == (64, 4)  # two rows a warp, rounded up
    assert cuda_fft.cta_shape(16, 1) == (32, 32)
    assert cuda_fft.cta_shape(4096, 3) == (768, 3)
    assert cuda_fft.cta_fits(1024, 16) and not cuda_fft.cta_fits(1024, 17)  # 512 threads
    assert cuda_fft.cta_fits(16384, 1) and not cuda_fft.cta_fits(16384, 2)
    assert cuda_fft.cta_fits(2048, 8) and not cuda_fft.cta_fits(2048, 9)  # 1024 threads
    assert not cuda_fft.cta_fits(256, 0)
    assert cuda_fft.cta_fits(16, 512)  # one pass: no shared memory
    assert not cuda_fft.cta_fits(16, 513)
    for n in SIZES:
        assert cuda_probes.fft_rows_fit(n, 1) is cuda_fft.cta_fits(n, 1)


def test_out_index_is_a_permutation():
    for n in [1] + SIZES:
        c = cuda_fft.out_index(n)
        assert sorted(c.tolist()) == list(range(cuda_fft.geometry(n).points))


# ---------------------------------------------------------------- tables and constants


@pytest.mark.parametrize("n", [2, 32, 1024, 2048, 16384])
def test_stockham_table_is_float64_rounded_once(n):
    want = np.ones(n, np.complex128)
    ns = 1
    for r in cuda_fft.radix_plan(n):
        for rr in range(1, r):
            k = np.arange(ns)
            want[rr * ns + k] = np.exp(-2j * np.pi * rr * k / (ns * r))
        ns *= r
    fwd = cuda_fft.stockham_table(n, False, CPU).numpy()
    np.testing.assert_array_equal(fwd[:, 0], want.real.astype(np.float32))
    np.testing.assert_array_equal(fwd[:, 1], want.imag.astype(np.float32))
    np.testing.assert_allclose(cuda_fft.stockham_table64(n), want, rtol=0, atol=1e-14)
    inv = cuda_fft.stockham_table(n, True, CPU).numpy()
    np.testing.assert_array_equal(inv[:, 0], fwd[:, 0])
    np.testing.assert_array_equal(inv[:, 1], -fwd[:, 1])


@pytest.mark.parametrize("n", [2, 4, 1024, 16384])
def test_rfft_table_is_float64_rounded_once(n):
    m = n // 2
    tab = cuda_fft.rfft_table(n, CPU).numpy()
    assert tab.shape == (n, 2)
    np.testing.assert_array_equal(tab[:m], cuda_fft.stockham_table(m, False, CPU).numpy())
    w = np.exp(-2j * np.pi * np.arange(m) / n)
    np.testing.assert_array_equal(tab[m:, 0], w.real.astype(np.float32))
    np.testing.assert_array_equal(tab[m:, 1], w.imag.astype(np.float32))


def test_header_constants_are_float64_rounded_once():
    """fft_regs.cuh's oct32 literals are cos(2 pi e / 32) rounded once to
    float32 (e = 8, cos = 0, is taken exactly as -i); every constant the
    R-point DFTs use, W_32^e for e < 16, follows from them."""
    src = HEADER.read_text()
    body = src[src.index("constexpr float oct32"):]
    body = body[:body.index("}")]
    lits = [np.float32(v) for v in re.findall(r"\?\s*([-0-9.e]+)f", body)]
    lits.append(np.float32(re.findall(r":\s*([-0-9.e]+)f;", body)[0]))
    assert len(lits) == 9
    np.testing.assert_array_equal(np.array(lits, np.float32), cuda_fft.oct32())
    e = np.arange(16)
    want_c = np.cos(2 * np.pi * e / 32).astype(np.float32)
    want_s = np.sin(2 * np.pi * e / 32).astype(np.float32)
    o = cuda_fft.oct32()
    got_c = np.where(e <= 8, o[np.minimum(e, 8)], -o[np.clip(16 - e, 0, 8)])
    got_s = np.where(e <= 8, o[np.clip(8 - e, 0, 8)], o[np.clip(e - 8, 0, 8)])
    keep = e != 8
    np.testing.assert_array_equal(got_c[keep], want_c[keep])
    np.testing.assert_array_equal(got_s, want_s)


# ---------------------------------------------------------------- shared memory


def _word(n, slot, i):
    g = cuda_fft.geometry(n)
    return (slot // g.q) * g.q * n + i * g.q + slot % g.q


def _warp_degrees(words, threads):
    """Most distinct 32-bit words sharing a bank, each warp of one access."""
    out = []
    for w in range(threads // 32):
        lane = np.unique(words[32 * w:32 * (w + 1)])
        out.append(int(np.bincount(lane % 32, minlength=32).max()))
    return out


def _exchange_degrees(n, rows):
    g = cuda_fft.geometry(n)
    threads, _ = cuda_fft.cta_shape(n, rows)
    tid = np.arange(threads)
    slot, t = tid // g.threads, tid % g.threads
    P, T = g.points, g.threads
    degrees, ns = [], 1
    for p, r in enumerate(g.radices[:-1]):
        for b in range(P // r):  # the writes of pass p
            j = t + b * T
            out = (j // ns) * ns * r + (j & (ns - 1))
            for rr in range(r):
                i = cuda_fft.exchange_swizzle(out + rr * ns, ns, r)
                degrees += _warp_degrees(_word(n, slot, i), threads)
        r2 = g.radices[p + 1]
        for b in range(P // r2):  # the reads of pass p + 1
            j = t + b * T
            for rr in range(r2):
                i = cuda_fft.exchange_swizzle(j + rr * (n // r2), ns, r)
                degrees += _warp_degrees(_word(n, slot, i), threads)
        ns *= r
    for c in cuda_fft.out_index(n):  # K3's split at m = n: Z[k] in, Z[m - k] out
        k = t + c * T
        degrees += _warp_degrees(_word(n, slot, k), threads)
        degrees += _warp_degrees(_word(n, slot, (n - k) & (n - 1)), threads)
    return degrees


@pytest.mark.parametrize("n", [1] + SIZES)
def test_exchanges_are_free_of_bank_conflicts(n):
    g = cuda_fft.geometry(n)
    top = max(r for r in range(1, 1025) if cuda_fft.cta_fits(n, r, split=True))
    for rows in sorted({1, 3, g.default_rows, top}):
        assert max(_exchange_degrees(n, rows)) == 1, rows


@pytest.mark.parametrize("n", SIZES)
def test_exchange_layout_is_a_bijection(n):
    """Each swizzle maps a row's n positions onto n distinct words."""
    ns = 1
    i = np.arange(n)
    for r in cuda_fft.radix_plan(n)[:-1]:
        assert np.array_equal(np.sort(cuda_fft.exchange_swizzle(i, ns, r)), i)
        ns *= r


# ---------------------------------------------------------------- wrappers on the CPU


def test_radix2_yardstick_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(9)
    xr, xi = (torch.from_numpy(rng.normal(size=(3, 256)).astype(np.float32)) for _ in range(2))
    before = launch_counts()["fft_pow2_radix2"]
    for args in ((xr, xi), (xr, None), (xr, xi, True, 1.0 / 256)):
        got = cuda_probes.fft_pow2_radix2(*args)
        want = cuda_fft.fft_pow2_plain(*args)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    half = cuda_probes.fft_pow2_radix2(xr, None, bins=129)
    assert torch.equal(half[0], cuda_fft.rfft_pow2_plain(xr)[0])
    assert launch_counts()["fft_pow2_radix2"] == before  # CPU tensors never launch
    with pytest.raises(ValueError):
        cuda_probes.fft_pow2_radix2(xr, None, inverse=True)
    with pytest.raises(ValueError):
        cuda_probes.fft_pow2_radix2(torch.zeros(2, 1000), None)
    with pytest.raises(ValueError):
        cuda_probes.fft_pow2_radix2(xr, None, bins=257)


@pytest.mark.parametrize("bad", [0, 3, 1 << 15])
def test_geometry_rejects_other_sizes(bad):
    with pytest.raises(ValueError):
        cuda_fft.geometry(bad)
