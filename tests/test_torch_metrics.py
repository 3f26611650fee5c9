"""The port's measurement path held to godsp_tpu's (CPU).

utils.metrics (the arithmetic, the chain-differential rule), K12 and K13's
plain versions against godsp_tpu's Pallas kernels in interpret mode
(K12 exactly; K13 at >= 120 dB in float32, and its float64 plain version
against the float64 contraction of godsp_tpu's tables at go-dsp's 1e-8),
utils.profiling, and the port's bench at a cut size through the plain
versions.  The kernels on the card are in tests/test_torch_cuda.py.
"""

import json
import os
import time as _time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godsp_tpu.fft.four_step import dft_matrix as jdft_matrix
from godsp_tpu.fft.four_step import twiddle_2d as jtwiddle_2d
from godsp_tpu.ops.pallas_fft import _LS_ORDER, _ls_tables
from godsp_tpu.utils import metrics as jmetrics
from godsp_tpu_torch import bench, default_device, set_default_device
from godsp_tpu_torch.dsputils import pretty_close, snr_db
from godsp_tpu_torch.ops import cuda_metrics, launch_counts
from godsp_tpu_torch.utils import BenchResult, annotate, metrics, profiling, roofline, trace_to


@pytest.fixture(autouse=True)
def _host_data_on_cpu():
    """Host data goes to the CPU here; the port's default device is the card."""
    old = default_device()
    set_default_device("cpu")
    yield
    set_default_device(old)


def _planes(b, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, n)).astype(np.float32), rng.normal(size=(b, n)).astype(np.float32))


# ---------------------------------------------------------------- arithmetic


@pytest.mark.parametrize("n, batch", [(1024, 1), (1024, 16384), (4096, 3), (1 << 20, 1)])
def test_fft_models_match_jax(n, batch):
    assert metrics.fft_flops(n, batch) == jmetrics.fft_flops(n, batch)
    assert metrics.fft_bytes(n, batch) == jmetrics.fft_bytes(n, batch)
    assert metrics.fft_bytes(n, batch, 4) == jmetrics.fft_bytes(n, batch, 4)
    assert metrics.rfft_flops(n, batch) == 0.5 * jmetrics.fft_flops(n, batch)


@pytest.mark.parametrize("peak", [819.0, 3350.0])
def test_roofline_matches_jax(monkeypatch, peak):
    monkeypatch.setattr(metrics, "hbm_bandwidth_gbs", lambda device=None: peak)
    monkeypatch.setattr(jmetrics, "hbm_bandwidth_gbs", lambda device=None: peak)
    assert roofline(1024, 16384, 3.3e-4) == jmetrics.roofline(1024, 16384, 3.3e-4)


@pytest.mark.parametrize("peak", [None, 2000.0])
def test_bench_result_matches_jax(monkeypatch, peak):
    monkeypatch.setattr(metrics, "hbm_bandwidth_gbs", lambda device=None: 3350.0)
    monkeypatch.setattr(jmetrics, "hbm_bandwidth_gbs", lambda device=None: 3350.0)
    kw = dict(name="x", wall_s=0.5, flops=1e9, bytes_moved=2e9)
    got, want = BenchResult(**kw), jmetrics.BenchResult(**kw)
    assert got.gflops == want.gflops == pytest.approx(2.0)
    assert got.gbs == want.gbs == pytest.approx(4.0)
    assert got.roofline_fraction(peak) == want.roofline_fraction(peak)
    assert json.loads(got.json_line(cell="c")) == json.loads(want.json_line(cell="c"))


@pytest.mark.parametrize("name, gbs", [
    ("NVIDIA H100 80GB HBM3", 3350.0),
    ("NVIDIA H100 PCIe", 2000.0),
    ("NVIDIA H100 NVL", 3900.0),
    ("mystery9000", None),
])
def test_hbm_table(monkeypatch, name, gbs):
    """Keyed on torch.cuda.get_device_name; an unknown card gives None,
    never a made-up peak."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
    assert metrics.hbm_bandwidth_gbs(torch.device("cuda", 0)) == gbs


def test_hbm_of_the_cpu_is_none():
    assert metrics.hbm_bandwidth_gbs(torch.device("cpu")) is None


@pytest.mark.parametrize("nbytes, flops, want", [
    (16.0 * (1 << 24), 0.0, "bytes"),
    (16.0 * (1 << 24), 768.0 * (1 << 24), "operations"),
])
def test_bound_ms(nbytes, flops, want):
    ms, by = metrics.bound_ms(nbytes, flops)
    assert by == want
    assert ms == pytest.approx(max(nbytes / 3.35e12, flops / 67e12) * 1e3)


# ---------------------------------------------------------------- timing


def test_chain_diff_rejects_implausible_reps(monkeypatch):
    """A zero differential is remeasured and, if it persists, raised —
    never clamped (as godsp_tpu's tests/test_utils.py holds its own)."""
    t = [0.0]

    def fake_counter():
        t[0] += 1.0
        return t[0]

    monkeypatch.setattr(_time, "perf_counter", fake_counter)

    def make(k):
        return lambda x: torch.ones(())

    with pytest.raises(RuntimeError, match="plausibility floor"):
        metrics.time_chain_diff(make, torch.zeros(4), retries=1, iters=1)


def test_chain_diff_accepts_consistent_sub_floor_reps(monkeypatch):
    """Sub-floor differentials that agree are a real, light op: every
    timed region of the short chain lasts 1 s, of the long one 1 s + 50 us."""
    t, calls, which = [0.0], [0], ["lo"]

    def fake_counter():
        calls[0] += 1
        if calls[0] % 2 == 0:  # a region's end: its length is the chain's
            t[0] += 1.0 + (5e-5 if which[0] == "hi" else 0.0)
        return t[0]

    monkeypatch.setattr(_time, "perf_counter", fake_counter)

    def make(k):
        def run(x):
            which[0] = "lo" if k == 4 else "hi"
            return x

        return run

    per = metrics.time_chain_diff(make, torch.zeros(4), k_lo=4, k_hi=36, retries=2, iters=1)
    assert per == pytest.approx(5e-5 / 32)


def test_time_chained_and_time_fn_on_cpu():
    x = torch.ones(256, 1024)
    r = metrics.time_chained(lambda z: torch.fft.fft(z), x, name="fft", flops=1.0)
    assert r.name == "fft" and r.wall_s > 0
    assert metrics.time_fn(torch.fft.fft, x, iters=3).wall_s > 0
    assert metrics.time_ms(lambda: torch.fft.fft(x), reps=3) > 0
    assert metrics.measure_rtt(iters=3) > 0


# ---------------------------------------------------------------- K12, K13


def test_copy_split_equals_the_jax_kernel():
    xr, xi = _planes(512, 256, 12)
    wr, wi = jmetrics.copy_split_pallas(jnp.asarray(xr), jnp.asarray(xi), batch_tile=256,
                                        interpret=True)
    before = launch_counts()["copy_split"]
    gr, gi = metrics.copy_split(torch.from_numpy(xr), torch.from_numpy(xi), batch_tile=256)
    assert launch_counts()["copy_split"] == before  # the plain version on the CPU
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


@pytest.mark.parametrize("wrapper", [metrics.copy_split, metrics.gmm_floor])
def test_batch_tile_precondition(wrapper):
    x = torch.zeros(10, 128)
    with pytest.raises(ValueError, match="batch_tile=8"):
        wrapper(x, x, batch_tile=8)


@pytest.mark.parametrize("n", [128, 256, 1024])
def test_gmm_tables_equal_jax(n):
    """K13's float32 tables are godsp_tpu's _ls_tables(n, ..., 1/128), bit for bit."""
    tabs = _ls_tables(n, False, False, 1.0 / 128)
    want = np.stack([tabs[k] for k in _LS_ORDER], axis=1)
    np.testing.assert_array_equal(cuda_metrics._g_host(n), want)


@pytest.mark.parametrize("n", [128, 256, 1024])
def test_gmm_floor_plain_float64_matches_jax_tables(n):
    """The float64 plain version against the float64 contraction of
    godsp_tpu's table ingredients (_ls_tables before its float32 cast)."""
    b = 16
    xr, xi = (a.astype(np.float64) for a in _planes(b, n, n))
    n1 = n // 128
    g = np.asarray(jtwiddle_2d(n1, 128))[:, :, None] * (np.asarray(jdft_matrix(128)) / 128)[None]
    x = (xr + 1j * xi).reshape(b, n1, 128)
    want = np.einsum("bki,kij->bkj", x, g).reshape(b, n)
    yr, yi = cuda_metrics.gmm_floor_plain(torch.from_numpy(xr), torch.from_numpy(xi))
    assert yr.dtype == torch.float64
    assert pretty_close(yr.numpy() + 1j * yi.numpy(), want)


@pytest.mark.parametrize("n", [128, 256, 1024])
def test_gmm_floor_matches_the_jax_kernel(n):
    xr, xi = _planes(16, n, n + 1)
    wr, wi = jmetrics.gmm_floor_pallas(jnp.asarray(xr), jnp.asarray(xi), batch_tile=8,
                                       interpret=True)
    before = launch_counts()["gmm_floor"]
    gr, gi = metrics.gmm_floor(torch.from_numpy(xr), torch.from_numpy(xi), batch_tile=8)
    assert launch_counts()["gmm_floor"] == before  # the plain version on the CPU
    assert gr.dtype == torch.float32
    got = gr.double().numpy() + 1j * gi.double().numpy()
    assert snr_db(got, np.asarray(wr, np.float64) + 1j * np.asarray(wi, np.float64)) >= 120.0


@pytest.mark.parametrize("shape", [(4, 100), (4, 0), (3, 256, 2)])
def test_gmm_floor_rejects_bad_shapes(shape):
    x = torch.zeros(shape)
    with pytest.raises(ValueError):
        cuda_metrics.gmm_floor(x, x)


@pytest.mark.parametrize("b, n, groups", [(16384, 1024, 33), (1024, 16384, 3), (7, 128, 1),
                                          (131072, 128, 264)])
def test_gmm_groups(b, n, groups):
    """About two blocks an SM over the grid, never more groups than tiles."""
    assert cuda_metrics.gmm_groups(b, n) == groups


@pytest.mark.parametrize("n1", [1, 2, 3, 8, 128])
@pytest.mark.parametrize("b", [0, 1, 127, 128, 129, 1001, 1 << 17])
def test_gmm_floor_plan_walks_every_tile_and_half_once(b, n1):
    """K13's plan: min(132, items) CTAs, each a contiguous run of
    (slice, half, row tile) items in slice-major order; every (row tile,
    slice, half) visited once, by one CTA; the rows of each (slice, half)
    cover [0, b) once, the last tile ragged where b % 128; a CTA loads G at
    most once a (slice, half) of its run; shared bytes within 227 KB."""
    n = 128 * n1
    plan = cuda_metrics.gmm_floor_plan(b, n)
    tiles = -(-b // 128)
    assert plan.items == 2 * n1 * tiles and plan.ctas == min(132, plan.items)
    assert plan.smem <= 232448 and plan.threads == 256 and plan.rows_tile == 128
    walk = cuda_metrics.gmm_floor_walk(plan, b)
    assert len(walk) == plan.ctas and all(walk)
    seen = [(k1, h, rows.start // 128) for cta in walk for k1, h, rows in cta]
    assert len(seen) == len(set(seen)) == plan.items
    assert set(seen) == {(k1, h, t) for k1 in range(n1) for h in (0, 1) for t in range(tiles)}
    assert seen == sorted(seen)  # slice-major: (k1, h) major, row tile minor, CTA after CTA
    for k1, h in {(k1, h) for k1, h, _ in seen}:
        rows = sorted((r for c in walk for kk, hh, r in c if (kk, hh) == (k1, h)),
                      key=lambda r: r.start)
        assert [r.start for r in rows] == list(range(0, b, 128))
        assert rows[-1].stop == b and all(len(r) == 128 for r in rows[:-1])
        assert len(rows[-1]) == (b % 128 or 128)
    for cta in walk:
        pairs = [(k1, h) for k1, h, _ in cta]
        assert len(set(pairs)) <= -(-len(cta) // tiles) + 1


def test_gmm_floor_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        cuda_metrics.gmm_floor_plan(4, 100)
    with pytest.raises(RuntimeError):
        cuda_metrics.gmm_floor_plan(4, 128, resident=0)


@pytest.mark.parametrize("b, n", [(1, 128), (17, 384), (129, 256)])
def test_gmm_floor_sync_on_cpu_tensors_is_the_plain_version(b, n):
    """K13's first design (the yardstick) takes the plain version for CPU
    tensors, as gmm_floor does."""
    from godsp_tpu_torch.ops import cuda_probes

    rng = np.random.default_rng(b + n)
    xr, xi = (torch.from_numpy(rng.standard_normal((b, n)).astype(np.float32)) for _ in "ri")
    got = cuda_probes.gmm_floor_sync(xr, xi)
    want = cuda_metrics.gmm_floor(xr, xi)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError):
        cuda_probes.gmm_floor_sync(xr[:, :100], xi[:, :100])


def test_floor_dot_probe_finds_its_lines_in_the_sources():
    """probes.floor_dot's instrumented and variant copies find the lines
    they change in csrc/int8_probe_kernels.cu and csrc/metrics_kernels.cu
    (once each), so the probe does not silently measure an unchanged
    kernel."""
    from godsp_tpu_torch.probes import floor_dot

    split = floor_dot.split_source()
    assert split.count("gdsp_dot_stamps[cta * 8 +") == 7
    for _, edits, _ in floor_dot.VARIANTS:
        src = floor_dot.variant_source(edits)
        assert all(repl in src for _, repl in edits)


# ---------------------------------------------------------------- profiling


def test_trace_to_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    with trace_to(d) as prof:
        with annotate("test-span"):
            torch.ones(64, 64).sum()
    files = [os.path.join(r, f) for r, _, fs in os.walk(d) for f in fs]
    assert files and files[0].endswith(".json")
    json.load(open(files[0]))
    assert any(e.key == "test-span" for e in prof.key_averages())


def test_annotate_context():
    with annotate("span"):
        pass  # must be a usable context manager


def test_start_server_has_no_torch_counterpart():
    assert profiling.start_server(9999) is None


# ---------------------------------------------------------------- the bench


def test_bench_on_cpu_ends_in_a_short_summary(capsys):
    # One intra-op thread: the cells are tiny, and beside other busy test
    # workers a team of threads spins on descheduled ones, which turns
    # seconds into many minutes.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = bench.main(device="cpu", scale=2.0 ** -12)
    finally:
        torch.set_num_threads(threads)
    lines = capsys.readouterr().out.strip().splitlines()
    last = lines[-1]
    assert len(last) <= bench.SUMMARY_MAX_CHARS
    s = json.loads(last)
    assert s["metric"] == "fft1024_precise_roofline_fraction" and not s["partial"]
    assert s["device"] == "cpu"
    assert set(s["cells"]) >= {"fft1024_precise", "fft_2pow20", "pwelch1024_s512"}
    assert json.loads(lines[-2])["detail"].keys() == res.keys()
    assert not res.get("failed_sections")
    fl = res["fft1024_precise"]
    assert fl["copy_equal"] and fl["gmm_floor_snr_db"] >= 120.0 and fl["snr_db"] >= 120.0


def test_summary_line_sheds_extras_past_the_limit():
    cells = {f"cell{i:03d}": {"wall_s": 1e-3, "snr_db": 130.0, "library_wall_s": 2e-3}
             for i in range(40)}
    line = bench.summary_line(cells, "card")
    assert len(line) <= bench.SUMMARY_MAX_CHARS
    assert json.loads(line)["cells"]["cell000"] == {"ms": 1.0, "db": 130.0}
