"""Parity of godsp_tpu_torch's FFT slice with godsp_tpu.

The same seeded numpy inputs go through the JAX function (CPU, x64, as
conftest.py sets up) and its port (CPU, float64).  Public functions are
held to go-dsp's 1e-8 abs-or-rel bound (pretty_close); each kernel's
plain version is held to the JAX kernel in interpret mode at >= 100 dB,
the bound tests/test_pallas.py uses.  The kernels themselves run in
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godsp_tpu import dsputils as jdsp
from godsp_tpu import fft as jfft
from godsp_tpu import window as jwin
from godsp_tpu_torch import _dtypes, default_device, dsputils, fft, set_default_device, window
from godsp_tpu_torch.ops import _build, cuda_fft
from test_fft import FFT2_TESTS, FFT_TESTS

SNR_KERNEL_DB = 100.0  # plain version vs the interpret-mode JAX kernel (f32)


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


# ---------------------------------------------------------------- policy


def test_dtype_policy_cpu():
    assert _dtypes.as_real_array([1, 2, 3]).dtype == torch.float64
    assert _dtypes.as_real_array(np.ones(3, np.float32)).dtype == torch.float32
    assert _dtypes.as_complex_array([1.0, 2.0]).dtype == torch.complex128
    assert _dtypes.working_float("cpu") == torch.float64
    assert _dtypes.working_float("cuda") == torch.float32
    with pytest.raises(ValueError):
        _dtypes.as_real_array(np.ones(3, np.complex128))


def test_dsputils_parity():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 37))
    for length in (16, 37, 64):
        got = _np(dsputils.zero_pad(x, length))
        assert dsputils.pretty_close(got, np.asarray(jdsp.zero_pad(x, length)))
    for v in (0, 1, 3, 64, 1000):
        assert dsputils.is_power_of_2(v) == jdsp.is_power_of_2(v)
        if v:
            assert dsputils.next_power_of_2(v) == jdsp.next_power_of_2(v)


@pytest.mark.parametrize("name", sorted(window.WINDOWS))
def test_window_tables_match(name):
    for L in (0, 1, 2, 5, 16, 257):
        got = _np(window.window_table(name, L))
        assert dsputils.pretty_close(got, np.asarray(jwin.window_table(name, L)))
    k = _np(window.kaiser(6.0)(33))
    assert dsputils.pretty_close(k, np.asarray(jwin.kaiser(6.0)(33)))


# ---------------------------------------------------------------- public API


@pytest.mark.parametrize("x,expected", FFT_TESTS, ids=lambda v: str(v)[:24])
def test_fft_golden(x, expected):
    got = _np(fft.fft_real(np.asarray(x, np.float64)))
    assert dsputils.pretty_close(got, np.asarray(expected, np.complex128))
    assert dsputils.pretty_close(_np(fft.ifft(got)), np.asarray(x, np.complex128))


@pytest.mark.parametrize("x,expected", FFT2_TESTS, ids=["2x3", "3x5"])
def test_fft2_golden(x, expected):
    got = _np(fft.fft2(x))
    assert dsputils.pretty_close(got, np.asarray(expected, np.complex128))
    assert dsputils.pretty_close(_np(fft.ifft2(got)), np.asarray(x, np.complex128))
    assert dsputils.pretty_close(_np(fft.fft2_real(x)), np.asarray(jfft.fft2_real(x)))
    assert dsputils.pretty_close(_np(fft.ifft2_real(x)), np.asarray(jfft.ifft2_real(x)))


def test_errors_where_go_dsp_panics():
    with pytest.raises(ValueError, match="ragged"):
        fft.fft2([[1, 2], [3]])
    with pytest.raises(ValueError, match="empty"):
        fft.fft2([])
    with pytest.raises(ValueError, match="2-D"):
        fft.fft2(np.ones(4))
    with pytest.raises(ValueError, match="equal size"):
        fft.convolve(np.ones(4), np.ones(5))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 16, 100, 128, 256, 1000, 1024])
def test_complex_api_matches_jax(n):
    rng = np.random.default_rng(n)
    x = _complex(rng, 3, n)
    y = _complex(rng, 3, n)
    r = rng.normal(size=(3, n))
    pairs = [
        (fft.fft(x), jfft.fft(x)),
        (fft.ifft(x), jfft.ifft(x)),
        (fft.fft_real(r), jfft.fft_real(r)),
        (fft.ifft_real(r), jfft.ifft_real(r)),
        (fft.convolve(x, y), jfft.convolve(x, y)),
    ]
    for got, want in pairs:
        assert dsputils.pretty_close(_np(got), np.asarray(want))


def test_axis_argument_matches_jax():
    rng = np.random.default_rng(7)
    x = _complex(rng, 16, 5, 3)
    for axis in (0, 1, -1):
        assert dsputils.pretty_close(_np(fft.fft(x, axis=axis)), np.asarray(jfft.fft(x, axis=axis)))
        assert dsputils.pretty_close(
            _np(fft.ifft(x, axis=axis)), np.asarray(jfft.ifft(x, axis=axis))
        )
    r = rng.normal(size=(8, 6))
    assert dsputils.pretty_close(_np(fft.fft_real(r, axis=0)), np.asarray(jfft.fft_real(r, axis=0)))


@pytest.mark.parametrize("n", [1, 8, 100, 256])
def test_split_api_matches_jax(n):
    rng = np.random.default_rng(n + 1)
    xr, xi = rng.normal(size=(2, n)), rng.normal(size=(2, n))
    for got, want in (
        (fft.fft_split(xr, xi), jfft.fft_split(xr, xi)),
        (fft.fft_split(xr), jfft.fft_split(xr)),
        (fft.ifft_split(xr, xi), jfft.ifft_split(xr, xi)),
        (fft.rfft_split(xr), jfft.rfft_split(xr)),
    ):
        assert dsputils.pretty_close(_np(got[0]), np.asarray(want[0]))
        assert dsputils.pretty_close(_np(got[1]), np.asarray(want[1]))
    with pytest.raises(ValueError):
        fft.fft_split(xr, xi[:, :-1] if n > 1 else np.ones((3, n)))


@pytest.mark.parametrize("n", [1000, 1331, 4099])
def test_bluestein_matches_numpy_and_jax(n):
    rng = np.random.default_rng(n)
    x = _complex(rng, 2, n)
    got = _np(fft.bluestein_fft(torch.from_numpy(x)))
    assert dsputils.snr_db(got, np.fft.fft(x)) > 250.0
    assert dsputils.pretty_close(got, np.asarray(jfft.bluestein_fft(x)))


@pytest.mark.parametrize("n", [2, 64, 4096, 1 << 15, 1 << 17])
def test_four_step_plain_vs_numpy(n):
    rng = np.random.default_rng(n)
    x = _complex(rng, 2, n)
    got = _np(fft.four_step_fft(torch.from_numpy(x)))
    assert dsputils.snr_db(got, np.fft.fft(x)) > 250.0
    inv = _np(fft.four_step_fft(torch.from_numpy(x), inverse=True)) / n
    assert dsputils.snr_db(inv, np.fft.ifft(x)) > 250.0


def test_kernel_switch_keeps_cpu_results():
    rng = np.random.default_rng(3)
    x = _complex(rng, 4, 512)
    on = _np(fft.fft(x))
    fft.set_kernels_enabled(False)
    try:
        assert not fft.kernels_enabled()
        off = _np(fft.fft(x))
    finally:
        fft.set_kernels_enabled(True)
    np.testing.assert_array_equal(on, off)


@pytest.mark.parametrize("flag", [True, False])
def test_tf32_off_restores_flags(flag):
    from godsp_tpu_torch.fft.four_step import _tf32_off

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = flag
        torch.backends.cudnn.allow_tf32 = flag
        with _tf32_off():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32 is flag
        assert torch.backends.cudnn.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---------------------------------------------------------------- kernel plain versions


def _split32(rng, *shape):
    return (rng.normal(size=shape).astype(np.float32), rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("n", [256, 512])
def test_k1_plain_vs_jax_kernel(n):
    from godsp_tpu.ops.pallas_fft import fft_pow2_split

    rng = np.random.default_rng(n)
    xr, xi = _split32(rng, 3, n)
    before = dict(cuda_fft.launches)
    cases = [
        (cuda_fft.fft_pow2(torch.from_numpy(xr), torch.from_numpy(xi)),
         fft_pow2_split(jnp.asarray(xr), jnp.asarray(xi), interpret=True)),
        (cuda_fft.fft_pow2(torch.from_numpy(xr), None),
         fft_pow2_split(jnp.asarray(xr), None, interpret=True)),
        (cuda_fft.fft_pow2(torch.from_numpy(xr), torch.from_numpy(xi), inverse=True, scale=1.0 / n),
         fft_pow2_split(jnp.asarray(xr), jnp.asarray(xi), inverse=True, scale=1.0 / n,
                        interpret=True)),
    ]
    for (gr, gi), (wr, wi) in cases:
        got = _np(gr) + 1j * _np(gi)
        want = np.asarray(wr, np.float64) + 1j * np.asarray(wi, np.float64)
        assert dsputils.snr_db(got, want) >= SNR_KERNEL_DB
    assert cuda_fft.launches == before  # CPU tensors never launch


def test_k2_plain_vs_jax_kernel():
    from godsp_tpu.ops.pallas_fft import ifft_pow2_digit_split, natural_to_digit

    n = 256
    rng = np.random.default_rng(11)
    yr, yi = _split32(rng, 3, n)
    d = natural_to_digit(jnp.asarray(yr + 1j * yi), n)
    wr, wi = ifft_pow2_digit_split(jnp.real(d), jnp.imag(d), scale=1.0 / n, interpret=True)
    gr, gi = cuda_fft.ifft_pow2(torch.from_numpy(yr), torch.from_numpy(yi), scale=1.0 / n)
    want = np.asarray(wr, np.float64) + 1j * np.asarray(wi, np.float64)
    assert dsputils.snr_db(_np(gr) + 1j * _np(gi), want) >= SNR_KERNEL_DB


@pytest.mark.parametrize("n", [256, 1024])
def test_k3_plain_vs_jax_kernel(n):
    from godsp_tpu.ops.pallas_fft import rfft_pow2_split

    rng = np.random.default_rng(n + 5)
    xr = rng.normal(size=(3, n)).astype(np.float32)
    wr, wi = rfft_pow2_split(jnp.asarray(xr), interpret=True)
    gr, gi = cuda_fft.rfft_pow2(torch.from_numpy(xr))
    assert gr.shape == (3, n // 2 + 1)
    want = np.asarray(wr, np.float64) + 1j * np.asarray(wi, np.float64)
    assert dsputils.snr_db(_np(gr) + 1j * _np(gi), want) >= SNR_KERNEL_DB


def test_twiddle_table_is_float64_rounded_once():
    tab = _np(cuda_fft.twiddle_table(16384, False, torch.device("cpu")))
    j = np.arange(8192)
    want = np.exp(-2j * np.pi * j / 16384)
    np.testing.assert_array_equal(tab[:, 0], want.real.astype(np.float32))
    np.testing.assert_array_equal(tab[:, 1], want.imag.astype(np.float32))
    inv = _np(cuda_fft.twiddle_table(16384, True, torch.device("cpu")))
    np.testing.assert_array_equal(inv[:, 1], -tab[:, 1])


# A stand-in for nvcc: touches the file after -o, or fails.
_FAKE_NVCC = {
    "ok": '#!/bin/sh\nwhile [ $# -gt 0 ]; do [ "$1" = -o ] && : > "$2"; shift; done\n',
    "fails": "#!/bin/sh\necho simulated >&2\nexit 1\n",
}


@pytest.mark.parametrize("nvcc", sorted(_FAKE_NVCC))
def test_build_leaves_only_the_library(tmp_path, monkeypatch, nvcc):
    """One compile per source, one link; the objects go whether the build
    succeeds or fails."""
    fake = tmp_path / "nvcc"
    fake.write_text(_FAKE_NVCC[nvcc])
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    out = tmp_path / "build"
    out.mkdir()
    so = out / "libtest.so"
    srcs = [tmp_path / "a.cu", tmp_path / "b.cu", tmp_path / "c.cuh"]
    if nvcc == "ok":
        _build._compile(srcs, so)
        assert [f.name for f in out.iterdir()] == ["libtest.so"]
    else:
        with pytest.raises(RuntimeError, match="simulated"):
            _build._compile(srcs, so)
        assert not list(out.iterdir())
