"""K9's cluster design (csrc/peel_rows_kernel.cu) on the CPU.

The kernel cannot run here, so its host side is held instead:
ops/cuda_outer.py's float64 model of it (peel_rows_regs_model: each
cluster's radix-G decimation, the M-point column passes of ops/cuda_fft.py's
row model, the twiddle as the kernel forms it, the phase-A stores at
peel_scatter's words of each CTA's planes, the rows read back and their
n3-point passes) against the float64 plain version at <= 1e-12 relative at
every n3 = 256..8192, forward and inverse, with a scale; the model rounded
to float32 against godsp_tpu's peel_rows_fused_split in interpret mode
(its digit-order rows put in natural order) at >= 110 dB
(tests/test_torch_large.py's bound); the model in place of the kernel
under the fused route of fft/large.py against godsp_tpu's x64 large plan
at go-dsp's 1e-8 (pretty_close); the cluster plan (peel_plan); the
scatter map writing every (row, column) slot of a cluster exactly once;
the banks of every warp access of the distributed shared-memory scatter
in its target CTA; and the radix-2 yardstick peel_rows_radix2 on CPU
tensors being the plain version.  The kernel itself runs in
tests/test_torch_cuda.py.
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godsp_tpu.fft import large as jlarge
from godsp_tpu.fft.four_step import four_step_fft as jfour_step
from godsp_tpu.ops import digit_to_natural_bins
from godsp_tpu.ops.pallas_outer import peel_rows_fused_split as jpeel
from godsp_tpu_torch import default_device, dsputils, set_default_device
from godsp_tpu_torch.fft import large
from godsp_tpu_torch.ops import cuda_fft, cuda_outer, cuda_probes, launch_counts

N3S = [1 << k for k in range(8, 14)]
REL = 1e-12  # model vs plain version, both float64
SNR_KERNEL_DB = 110.0  # float32-rounded model vs the interpret-mode JAX kernel


@pytest.fixture(autouse=True)
def _host_data_on_cpu():
    """Host data goes to the CPU here; the port's default device is the card."""
    old = default_device()
    set_default_device("cpu")
    yield
    set_default_device(old)


def _planes(b, n3, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, 128, n3)), rng.normal(size=(b, 128, n3))


def _c(planes):
    return np.asarray(planes[0], np.float64) + 1j * np.asarray(planes[1], np.float64)


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# ---------------------------------------------------------------- the model


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("n3", N3S)
def test_peel_model_is_the_plain_version(n3, inverse):
    b = 2 if n3 <= 1024 else 1
    xr, xi = _planes(b, n3, n3 + inverse)
    scale = 1.0 / (128 * n3) if inverse else 0.5
    got = _c(cuda_outer.peel_rows_regs_model(xr, xi, inverse, scale))
    want = _c(cuda_outer.peel_rows_fused_split_plain(torch.from_numpy(xr), torch.from_numpy(xi),
                                                     inverse, scale))
    assert got.shape == want.shape
    assert _rel(got, want) <= REL


def test_peel_model_keeps_leading_axes_and_checks_its_shape():
    xr, xi = _planes(6, 256, 1)
    got = cuda_outer.peel_rows_regs_model(xr.reshape(2, 3, 128, 256), xi.reshape(2, 3, 128, 256))
    assert got[0].shape == (2, 3, 128, 256)
    np.testing.assert_array_equal(got[0].reshape(6, 128, 256),
                                  cuda_outer.peel_rows_regs_model(xr, xi)[0])
    for shape in ((1, 64, 256), (1, 128, 128), (1, 128, 16384)):
        with pytest.raises(ValueError):
            cuda_outer.peel_rows_regs_model(np.zeros(shape), np.zeros(shape))


# ---------------------------------------------------------------- against godsp_tpu


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("b,n3", [(2, 256), (1, 512), (1, 1024)])
def test_peel_model_vs_jax_kernel(b, n3, inverse):
    """The model rounded to float32 against pallas_outer.peel_rows_fused_split
    in interpret mode, its digit-order rows put in natural order."""
    xr, xi = (p.astype(np.float32) for p in _planes(b, n3, 7 * n3 + inverse))
    jr, ji = jpeel(jnp.asarray(xr), jnp.asarray(xi), inverse=inverse, interpret=True)
    want = (np.asarray(digit_to_natural_bins(jr, n3))
            + 1j * np.asarray(digit_to_natural_bins(ji, n3)))
    got = cuda_outer.peel_rows_regs_model(xr, xi, inverse)
    got = got[0].astype(np.float32) + 1j * got[1].astype(np.float32)
    assert dsputils.snr_db(got, want) >= SNR_KERNEL_DB


def _jax_oracle_row(xr, xi, inverse):
    y = jfour_step(jnp.asarray(xr) + 1j * jnp.asarray(xi), inverse)
    return jnp.real(y), jnp.imag(y)


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("n", [1 << 17, 1 << 20], ids=["2^17", "2^20"])
def test_peel_model_under_the_fused_route_vs_jax(n, inverse, monkeypatch):
    """The fused route of fft/large.py (set_fuse_rows_enabled) with the model
    in place of K9 (n3 = 1024 at 2^17, 8192 at 2^20) against godsp_tpu's x64
    large plan at 1e-8."""
    calls = Counter()

    def model(xr, xi, inverse=False, scale=1.0):
        calls["peel_rows_fused_split"] += 1
        yr, yi = cuda_outer.peel_rows_regs_model(xr.numpy(), xi.numpy(), inverse, scale)
        return torch.from_numpy(yr), torch.from_numpy(yi)

    monkeypatch.setattr(cuda_outer, "peel_rows_fused_split", model)
    rng = np.random.default_rng(n + inverse)
    src = rng.normal(size=(1, n)) + 1j * rng.normal(size=(1, n))
    jr, ji = jlarge.fft_large_split(jnp.asarray(src.real), jnp.asarray(src.imag),
                                    inverse=inverse, row_fft=_jax_oracle_row)
    want = np.asarray(jr) + 1j * np.asarray(ji)
    try:
        large.set_fuse_rows_enabled(True)
        yr, yi = large.fft_large_split(torch.from_numpy(src.real.copy()),
                                       torch.from_numpy(src.imag.copy()), inverse)
    finally:
        large.set_fuse_rows_enabled(False)
    assert calls == {"peel_rows_fused_split": 1}
    got = yr.numpy() + 1j * yi.numpy()
    assert dsputils.pretty_close(got / n, want / n)


# ---------------------------------------------------------------- the plan


@pytest.mark.parametrize("n3", N3S)
def test_peel_plan(n3):
    p = cuda_outer.peel_plan(n3)
    assert p.cluster == 8  # the portable size
    assert p.rows * n3 <= 16384  # two float planes of 128 KB at most
    assert p.points == p.cluster * p.rows and p.clusters * p.points == 128
    assert p.clusters == {256: 1, 512: 1, 1024: 1, 2048: 2, 4096: 4, 8192: 8}[n3]
    t = cuda_outer.tile(p.points)  # phase A's tile: K8's, whose exchanges are counted there
    assert (p.tile_columns, p.tiles * t.threads) == (t.columns, p.threads)
    assert (n3 // p.cluster) % p.tile_columns == 0  # a CTA's columns: whole tiles
    assert p.threads <= 1024 and p.smem <= cuda_fft.MAX_SMEM
    assert p.smem == 4 * (p.rows * n3 * 2 + p.tiles * t.smem // 4)
    g = cuda_fft.geometry(n3)  # phase B: whole warps of rows, or whole rounds of rows
    at_once = p.threads // 32 * g.q if g.warp else p.threads // g.threads
    assert (p.rows % g.q == 0) if g.warp else (p.rows % at_once == 0)


def test_peel_plan_rejects_other_rows():
    for n3 in (128, 384, 16384):
        with pytest.raises(ValueError):
            cuda_outer.peel_plan(n3)


# ---------------------------------------------------------------- the scatter


@pytest.mark.parametrize("n3", N3S)
def test_scatter_writes_every_slot_of_the_cluster_once(n3):
    p = cuda_outer.peel_plan(n3)
    mp = cuda_outer.peel_scatter(n3)
    live = mp["live"]
    slot = mp["j"][live] * n3 + mp["c"][live]
    assert np.array_equal(np.bincount(slot, minlength=p.points * n3), np.ones(p.points * n3))
    # and every word of each CTA's planes once: row slot j / C at column c
    word = mp["dst"][live] * p.rows * n3 + mp["word"][live]
    assert np.array_equal(np.sort(word), np.arange(p.cluster * p.rows * n3))
    assert np.array_equal(mp["dst"][live], mp["j"][live] % p.cluster)


def _scatter_bank_ways(n3):
    """The most accesses of one bank in one target CTA over every warp store
    of the phase-A scatter (a warp of 32 threads, one output register)."""
    mp = cuda_outer.peel_scatter(n3)
    src, steps, threads, regs = mp["j"].shape
    worst = 0
    for name in ("dst", "word", "live"):
        mp[name] = mp[name].reshape(src, steps, threads // 32, 32, regs)
    for s in range(src):
        for it in range(steps):
            for w in range(threads // 32):
                for i in range(regs):
                    live = mp["live"][s, it, w, :, i]
                    if not live.any():
                        continue
                    dst, word = mp["dst"][s, it, w, live, i], mp["word"][s, it, w, live, i]
                    for t in np.unique(dst):
                        worst = max(worst, int(np.bincount(word[dst == t] % 32).max()))
    return worst


@pytest.mark.parametrize("n3", N3S)
def test_scatter_banks(n3):
    """A warp stores one row's 32 consecutive columns into one target CTA:
    one word a bank, but at n3 = 256, where the row passes interleave two
    rows word by word (fft_regs.cuh: Q = 2), the columns land two words
    apart: two ways, the one conflict of the design."""
    assert _scatter_bank_ways(n3) == (2 if n3 == 256 else 1)


def test_scatter_warp_targets_one_cta():
    for n3 in N3S:
        mp = cuda_outer.peel_scatter(n3)
        dst = mp["dst"].reshape(*mp["dst"].shape[:2], -1, 32, mp["dst"].shape[-1])
        assert (dst == dst[..., :1, :]).all()


# ---------------------------------------------------------------- tables and the yardstick


@pytest.mark.parametrize("inverse", [False, True])
def test_peel_tables_are_float64_rounded_once(inverse):
    n3 = 1024
    hi, lo, bits = cuda_outer._factor_tables(128 * n3, inverse, torch.device("cpu"))
    assert bits == cuda_outer.lo_bits_of(128 * n3) == 9
    sign = 2j if inverse else -2j
    for tab, p in ((hi, np.arange(hi.shape[0]) << bits), (lo, np.arange(1 << bits))):
        want = np.exp(sign * np.pi * p / (128 * n3))
        np.testing.assert_array_equal(tab.numpy()[:, 0], want.real.astype(np.float32))
        np.testing.assert_array_equal(tab.numpy()[:, 1], want.imag.astype(np.float32))
    w = cuda_outer._dft_table(128, inverse, torch.device("cpu")).numpy()
    want = np.exp(sign * np.pi * np.arange(128) / 128)
    np.testing.assert_array_equal(w[:, 0], want.real.astype(np.float32))


def test_radix2_peel_yardstick_on_cpu_is_the_plain_version():
    xr, xi = (torch.from_numpy(p.astype(np.float32)) for p in _planes(2, 256, 3))
    before = launch_counts()["peel_rows_radix2"]
    for inverse, scale in ((False, 1.0), (True, 0.25)):
        got = cuda_probes.peel_rows_radix2(xr, xi, inverse, scale)
        want = cuda_outer.peel_rows_fused_split_plain(xr, xi, inverse, scale)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert launch_counts()["peel_rows_radix2"] == before  # CPU tensors never launch
    with pytest.raises(ValueError):
        cuda_probes.peel_rows_radix2(xr[:, :64], xi[:, :64])
