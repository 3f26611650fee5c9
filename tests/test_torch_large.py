"""Parity of godsp_tpu_torch's giant-N FFT (fft/large.py, K8, K9) with godsp_tpu.

K8's plain version (ops/cuda_outer.py) is held to godsp_tpu's
outer_dft_split in interpret mode at >= 100 dB in float32, the bound of
tests/test_pallas.py; K9's plain version to godsp_tpu's
peel_rows_fused_split in interpret mode, its digit-order rows put in
natural order, at >= 110 dB in float32 (tests/test_fft.py's bound for
the peel path).  The fused route (set_fuse_rows_enabled) and the unfused
plan are held to godsp_tpu's x64 fft_large_split at 1e-8 abs-or-rel: at
2^17 on random data, at 2^24 on a multi-tone input whose spectrum,
O(N) at its tones, is compared divided by N (the float64 rounding of a
2^24-point transform, about N eps log2 N absolute, is above go-dsp's
1e-8 absolute in the empty bins).  The port's large plan runs on the CPU in float64
through the wrappers' plain versions and is held to godsp_tpu's
fft_large_split (x64, with the four-step oracle as its row transform) at
go-dsp's 1e-8 abs-or-rel bound, and both to numpy at >= 200 dB.  The
route tests send CPU tensors down the CUDA route, so the wrappers run
their plain versions, and show which wrappers a transform reaches.  The
kernel itself runs in tests/test_torch_cuda.py.
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godsp_tpu import fft as jfft
from godsp_tpu.fft import large as jlarge
from godsp_tpu.fft.four_step import four_step_fft as jfour_step
from godsp_tpu.ops import digit_to_natural_bins
from godsp_tpu.ops.pallas_outer import outer_dft_split as jouter
from godsp_tpu.ops.pallas_outer import peel_rows_fused_split as jpeel
from godsp_tpu.ops.pallas_outer import peel_rows_supported as jpeel_supported
from godsp_tpu_torch import default_device, dsputils, fft, set_default_device
from godsp_tpu_torch.dsputils import next_power_of_2
from godsp_tpu_torch.fft import core, large, pow2, split
from godsp_tpu_torch.ops import cuda_fft, cuda_outer

SNR_KERNEL_DB = 100.0  # plain version vs the interpret-mode JAX kernel (f32)
SNR_F64_DB = 200.0  # float64 plan vs numpy: the structure is exact


@pytest.fixture(autouse=True)
def _host_data_on_cpu():
    """Host data goes to the CPU here; the port's default device is the card."""
    old = default_device()
    set_default_device("cpu")
    yield
    set_default_device(old)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _complex(rng, *shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def _jax_oracle_row(xr, xi, inverse):
    y = jfour_step(jnp.asarray(xr) + 1j * jnp.asarray(xi), inverse)
    return jnp.real(y), jnp.imag(y)


# ---------------------------------------------------------------- K8


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("b,d1,d2,n3", [(2, 4, 4, 256), (1, 8, 1, 128)])
def test_k8_plain_vs_jax_kernel(b, d1, d2, n3, inverse):
    rng = np.random.default_rng(d1 * d2 + n3)
    x = _complex(rng, b, d1 * d2, n3).astype(np.complex64)
    jr, ji = jouter(jnp.asarray(x.real), jnp.asarray(x.imag), d1, d2, inverse=inverse,
                    interpret=True)
    before = dict(cuda_outer.launches)
    yr, yi = cuda_outer.outer_dft_split(torch.from_numpy(x.real.copy()),
                                        torch.from_numpy(x.imag.copy()), d1, d2, inverse)
    assert cuda_outer.launches == before  # CPU tensors never launch
    assert yr.dtype == torch.float32 and yr.shape == x.shape
    got = _np(yr) + 1j * _np(yi)
    assert dsputils.snr_db(got, np.asarray(jr) + 1j * np.asarray(ji)) >= SNR_KERNEL_DB


def test_k8_plain_is_the_column_dft_and_twiddle():
    """Row k1*d2 + k2 holds W_N^{k t} * DFT_m(column t)[k], k = k1 + d1*k2."""
    d1, d2, n3 = 4, 2, 24  # any n3: the port's K8 has no lane rule
    m = d1 * d2
    x = _complex(np.random.default_rng(3), 3, m, n3)
    yr, yi = cuda_outer.outer_dft_split_plain(torch.from_numpy(x.real), torch.from_numpy(x.imag),
                                              d1, d2)
    r = np.arange(m)
    k = (r // d2 + d1 * (r % d2))[:, None]
    want = (np.fft.fft(x, axis=1) * np.exp(-2j * np.pi * np.arange(m)[:, None]
                                           * np.arange(n3) / (m * n3)))[:, k[:, 0], :]
    assert dsputils.pretty_close(_np(yr) + 1j * _np(yi), want)


@pytest.mark.parametrize("args", [(4, 3, 16), (4096, 1, 16), (1, 1, 16), (2, 2, 0)])
def test_k8_rejects_unsupported_plans(args):
    d1, d2, n3 = args
    x = torch.zeros(d1 * d2, n3)
    with pytest.raises(ValueError):
        cuda_outer.outer_dft_split(x, x, d1, d2)


# ---------------------------------------------------------------- K9


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("b,n3", [(2, 256), (1, 1024)])
def test_k9_plain_vs_jax_kernel(b, n3, inverse):
    rng = np.random.default_rng(n3 + inverse)
    x = _complex(rng, b, 128, n3).astype(np.complex64)
    jr, ji = jpeel(jnp.asarray(x.real), jnp.asarray(x.imag), inverse=inverse, interpret=True)
    want = (np.asarray(digit_to_natural_bins(jr, n3))
            + 1j * np.asarray(digit_to_natural_bins(ji, n3)))
    before = dict(cuda_outer.launches)
    yr, yi = cuda_outer.peel_rows_fused_split(torch.from_numpy(x.real.copy()),
                                              torch.from_numpy(x.imag.copy()), inverse)
    assert cuda_outer.launches == before  # CPU tensors never launch
    assert yr.dtype == torch.float32 and yr.shape == x.shape
    assert dsputils.snr_db(_np(yr) + 1j * _np(yi), want) >= 110.0


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_k9_plain_is_the_sub_transform(inverse):
    """Row k1 of each (128, n3) element holds scale x bins k1 + 128 k3 of the
    length-128 n3 DFT of the element read in row order."""
    n3, scale = 512, 0.25
    x = _complex(np.random.default_rng(5), 3, 128, n3)
    yr, yi = cuda_outer.peel_rows_fused_split_plain(torch.from_numpy(x.real),
                                                    torch.from_numpy(x.imag), inverse, scale)
    sub = x.reshape(3, -1)
    spec = np.fft.ifft(sub) * sub.shape[-1] if inverse else np.fft.fft(sub)
    want = scale * spec.reshape(3, n3, 128).transpose(0, 2, 1)
    assert yr.dtype == torch.float64
    assert dsputils.pretty_close(_np(yr) + 1j * _np(yi), want)


@pytest.mark.parametrize("shape", [(128, 128), (2, 128, 128), (2, 64, 1024), (128, 16384)])
def test_k9_rejects_unsupported_shapes(shape):
    x = torch.zeros(shape)
    with pytest.raises(ValueError):
        cuda_outer.peel_rows_fused_split(x, x)


def test_k9_sizes_match_jax():
    for n3 in (128, 256, 384, 512, 1024, 8192, 16384, 8192 + 128):
        if n3 & (n3 - 1) == 0:  # the port's kernel is radix-2: its plan gives pow-2 rows
            assert cuda_outer.peel_rows_supported(n3) == jpeel_supported(n3), n3


def test_the_sizes_that_fuse_match_jax():
    """The fused route takes exactly the sizes where godsp_tpu fuses: its
    _peel_plan ends in a row peel_rows_supported takes (arithmetic only)."""
    fused = []
    for k in range(15, 29):
        n = 1 << k
        pp = jlarge._peel_plan(n)
        want = None if pp is None or not jpeel_supported(pp[1]) else (len(pp[0]), pp[1])
        assert large._fused_plan(n) == want, n
        if want:
            fused.append(k)
    assert fused == [17, 18, 19, 20, 24, 25, 26, 27]


def _multitone(n, seed):
    rng = np.random.default_rng(seed)
    bins = rng.choice(n, size=5, replace=False)
    amps = rng.normal(size=5) + 1j * rng.normal(size=5)
    t = np.arange(n, dtype=np.int64)
    x = np.zeros(n, np.complex128)
    spec = np.zeros(n, np.complex128)
    for bq, a in zip(bins, amps):  # each phase reduced exactly, rounded once
        x += a * np.exp(2j * np.pi * ((int(bq) * t) % n) / n)
        spec[bq] = a * n
    return x, spec


@pytest.fixture(scope="module")
def jax_2_24():
    """godsp_tpu's x64 large plan at 2^24 on a multi-tone input, forward
    and (of the exact spectrum) inverse, once for the module."""
    n = 1 << 24
    x, spec = _multitone(n, 42)
    out = {}
    for inverse, src in ((False, x), (True, spec)):
        jr, ji = jlarge.fft_large_split(jnp.asarray(src.real), jnp.asarray(src.imag),
                                        inverse=inverse, row_fft=_jax_oracle_row)
        out[inverse] = np.asarray(jr) + 1j * np.asarray(ji)
    return x, spec, out


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("n", [1 << 17, 1 << 24], ids=["2^17", "2^24"])
def test_fused_route_vs_jax(n, fuse, inverse, request, monkeypatch):
    calls = Counter()
    for mod, name in ((cuda_outer, "outer_dft_split"), (cuda_outer, "peel_rows_fused_split"),
                      (cuda_fft, "fft_pow2"), (cuda_fft, "ifft_pow2")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name,
                            lambda *a, _f=fn, _n=name, **k: calls.update([_n]) or _f(*a, **k))
    if n == 1 << 24:
        x, spec, jax_out = request.getfixturevalue("jax_2_24")
        src, ref = (spec, x * n) if inverse else (x, spec)
        want = jax_out[inverse]
    else:
        src = _complex(np.random.default_rng(n + inverse), 2, n)
        ref = np.fft.ifft(src) * n if inverse else np.fft.fft(src)
        jr, ji = jlarge.fft_large_split(jnp.asarray(src.real), jnp.asarray(src.imag),
                                        inverse=inverse, row_fft=_jax_oracle_row)
        want = np.asarray(jr) + 1j * np.asarray(ji)
    try:
        large.set_fuse_rows_enabled(fuse)
        yr, yi = large.fft_large_split(torch.from_numpy(src.real.copy()),
                                       torch.from_numpy(src.imag.copy()), inverse)
    finally:
        large.set_fuse_rows_enabled(False)
    got = _np(yr) + 1j * _np(yi)
    peels = 1 if n == 1 << 17 else 2
    rows = "ifft_pow2" if inverse else "fft_pow2"
    if fuse:
        assert calls == +Counter({"outer_dft_split": peels - 1, "peel_rows_fused_split": 1})
    else:
        assert calls == {"outer_dft_split": 1, rows: 1}
    assert dsputils.pretty_close(got / n, want / n)
    assert dsputils.snr_db(got, ref) >= SNR_F64_DB


def test_fused_route_keeps_the_other_sizes(monkeypatch):
    """2^15, 2^16, 2^21 (n3 = 16384: past K9's rows) take the unfused plan
    whatever the switch says, as in godsp_tpu."""
    calls = []
    fn = cuda_outer.peel_rows_fused_split
    monkeypatch.setattr(cuda_outer, "peel_rows_fused_split",
                        lambda *a, **k: calls.append(1) or fn(*a, **k))
    try:
        large.set_fuse_rows_enabled(True)
        for k in (15, 16):
            x = _complex(np.random.default_rng(k), 1, 1 << k)
            z = large.fft_large(torch.from_numpy(x))
            assert dsputils.snr_db(_np(z), np.fft.fft(x)) >= SNR_F64_DB
        assert large._fused_plan(1 << 21) is None and large._fused_plan(1 << 28) is None
    finally:
        large.set_fuse_rows_enabled(False)
    assert calls == []


# ---------------------------------------------------------------- the plan


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("n,max_rows", [(1 << 15, None), (1 << 16, None), (1 << 17, 8)],
                         ids=["2^15", "2^16", "2^17-two-calls"])
def test_fft_large_split_vs_jax_and_numpy(n, max_rows, inverse, monkeypatch):
    if max_rows is not None:
        monkeypatch.setattr(large, "_MAX_ROWS", max_rows)  # m = 16 > 8: two K8 calls
    calls = Counter()
    outer = cuda_outer.outer_dft_split

    def spy(*a, **k):
        calls["outer_dft_split"] += 1
        return outer(*a, **k)

    monkeypatch.setattr(cuda_outer, "outer_dft_split", spy)
    x = _complex(np.random.default_rng(n), 2, n)
    yr, yi = large.fft_large_split(torch.from_numpy(x.real), torch.from_numpy(x.imag), inverse)
    assert calls["outer_dft_split"] == (1 if max_rows is None else 2)
    jr, ji = jlarge.fft_large_split(jnp.asarray(x.real), jnp.asarray(x.imag), inverse=inverse,
                                    row_fft=_jax_oracle_row)
    got, want = _np(yr) + 1j * _np(yi), np.asarray(jr) + 1j * np.asarray(ji)
    ref = np.fft.ifft(x) * n if inverse else np.fft.fft(x)
    assert dsputils.snr_db(got, ref) >= SNR_F64_DB
    assert dsputils.snr_db(want, ref) >= SNR_F64_DB
    assert dsputils.pretty_close(got, want)
    z = large.fft_large(torch.from_numpy(ref), inverse=not inverse, scale=1.0 / n)
    assert dsputils.snr_db(_np(z), x) >= SNR_F64_DB


@pytest.mark.parametrize("min_n", [None, 16384], ids=["default", "large_min_16384"])
def test_large_supported_matches_jax(min_n):
    try:
        if min_n is not None:
            large.set_large_min(min_n)
            jlarge.set_large_min(min_n)
        for n in (8192, 16384, 3 * (1 << 15), 1 << 15, 1 << 20, 1 << 28, 1 << 29, 0):
            assert large.large_supported(n) == jlarge.large_supported(n), n
    finally:
        large.set_large_min(32768)
        jlarge.set_large_min(32768)


def test_every_size_through_2_28_has_a_kernel_route():
    """On CUDA no pow-2 N <= 2^28, and no Bluestein pad up to 2^28, is left
    without a kernel: kernel_route raises only past 2^28."""
    for k in range(1, 29):
        n = 1 << k
        assert cuda_fft.supported_size(n) or large.large_supported(n), n
    assert not large.large_supported(1 << 29)
    for n in (10000, 100_003, 26_460_000, 1 << 27):  # the largest Bluestein N: pad 2^28
        assert large.large_supported(next_power_of_2(2 * n - 1)), n


# ---------------------------------------------------------------- routes


@pytest.fixture
def cuda_route_on_cpu(monkeypatch):
    """Send CPU tensors down the CUDA route (the wrappers then run their
    plain versions), and record the wrappers' calls in order."""
    calls = []

    def spy(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)

        monkeypatch.setattr(mod, name, wrapped)

    spy(cuda_outer, "outer_dft_split")
    for name in ("fft_pow2", "ifft_pow2", "rfft_pow2"):
        spy(cuda_fft, name)
    for mod in (pow2, core, split):
        monkeypatch.setattr(mod, "kernel_route", lambda x: True)
    return calls


def test_large_routes_reach_outer_then_rows(cuda_route_on_cpu):
    calls = cuda_route_on_cpu
    n = 1 << 15
    x = _complex(np.random.default_rng(0), 2, n)
    y = fft.fft(x)
    assert calls == ["outer_dft_split", "fft_pow2"]
    calls.clear()
    z = fft.ifft(y)
    assert calls == ["outer_dft_split", "ifft_pow2"]
    assert dsputils.snr_db(_np(y), np.fft.fft(x)) >= SNR_F64_DB
    assert dsputils.snr_db(_np(z), x) >= SNR_F64_DB
    assert dsputils.pretty_close(_np(y), np.asarray(jfft.fft(jnp.asarray(x))))
    assert dsputils.pretty_close(_np(z), np.asarray(jfft.ifft(jnp.asarray(_np(y)))))
    calls.clear()
    r = fft.fft_real(x.real)  # above 16384 the real input takes the complex plan
    assert calls == ["outer_dft_split", "fft_pow2"]
    assert dsputils.snr_db(_np(r), np.fft.fft(x.real)) >= SNR_F64_DB
    calls.clear()
    c = fft.convolve(x, x[::-1].copy())
    assert calls == ["outer_dft_split", "fft_pow2"] * 2 + ["outer_dft_split", "ifft_pow2"]
    want = np.fft.ifft(np.fft.fft(x) * np.fft.fft(x[::-1]))
    assert dsputils.snr_db(_np(c), want) >= SNR_F64_DB


def test_bluestein_reaches_the_large_route(cuda_route_on_cpu):
    calls = cuda_route_on_cpu
    n = 10000  # pad 2^15
    x = _complex(np.random.default_rng(1), n)
    y = fft.fft(x)
    assert calls == ["outer_dft_split", "fft_pow2", "outer_dft_split", "ifft_pow2"]
    assert dsputils.snr_db(_np(y), np.fft.fft(x)) >= SNR_F64_DB
    calls.clear()
    yr, yi = fft.rfft_split(x.real)  # split entries reach it through the complex dispatch
    assert Counter(calls) == {"outer_dft_split": 2, "fft_pow2": 1, "ifft_pow2": 1}
    assert dsputils.snr_db(_np(yr) + 1j * _np(yi), np.fft.rfft(x.real)) >= SNR_F64_DB


def test_small_sizes_keep_the_row_kernels(cuda_route_on_cpu):
    calls = cuda_route_on_cpu
    x = _complex(np.random.default_rng(2), 4, 16384)
    fft.fft(x)
    fft.rfft_split(x.real)
    assert calls == ["fft_pow2", "rfft_pow2"]
    calls.clear()
    try:
        fft.set_large_min(16384)  # godsp_tpu's A/B: 16384 through the plan (m = 2)
        y = fft.fft(x)
    finally:
        fft.set_large_min(32768)
    assert calls == ["outer_dft_split", "fft_pow2"]
    assert dsputils.snr_db(_np(y), np.fft.fft(x)) >= SNR_F64_DB
