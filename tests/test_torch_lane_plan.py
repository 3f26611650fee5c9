"""The cluster plans of K14c gmm_concat and i8_concat and K14f ls_full and
gmm_tf32, checked on the CPU.

The two kernels (csrc/lane_probe_kernels.cu, csrc/lane_slice_probe_kernels.cu
over csrc/lane_contract.cuh) run K13's contraction on thread-block
clusters, a CTA a 128-column slice with its G[k1] resident.  Their launch
plan and the maps of their distributed-shared-memory traffic are mirrored
in ops/cuda_probes.py (lane_cluster_plan, lane_cluster_walk,
lane_gather_map, lane_network_scatter); the GPU tests hold the kernels'
own plan (gdsp_lane_cluster_geometry) to lane_cluster_plan.  Here, with no
card: every (row, column) of the output is stored once, the network reads
every input once and lands output slice k1 in CTA k1's buffer, the whole-row
gather covers each row once, the plan fits a CTA's shared memory and a
portable cluster, and the wrappers refuse what the kernels do not take.
i8_concat (csrc/int8_probe_kernels.cu) takes the same plan, its rows pushed
to their owners (i8_push_map) and stored whole; gmm_tf32 (csrc/lane_slice_probe_kernels.cu)
its own (gmm_tf32_plan, gmm_tf32_walk, gmm_tf32_bins, gmm_tf32_offset;
the GPU tests compare gdsp_gmm_tf32_geometry): every 64-row tile of every
slice is contracted once, each CTA of a pair takes half the bins, and the
operands' 128-byte swizzle places every element once.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from godsp_tpu_torch import default_device, set_default_device
from godsp_tpu_torch.ops import cuda_metrics
from godsp_tpu_torch.ops import cuda_probes as cp
from godsp_tpu_torch.probes import r3

MAX_SMEM = 232448  # bytes of shared memory a CTA may use on the H100
HEADER = pathlib.Path(cp.__file__).resolve().parent.parent / "csrc" / "lane_contract.cuh"
TF32_SOURCE = HEADER.parent / "lane_slice_probe_kernels.cu"
GMM_N1 = (1, 2, 4, 8, 16)
SHAPES_B = (1, 15, 16, 17, 1001, 4099)
RESIDENT = (1, 7, 15, 132)
RAGGED_B = (1, 15, 17, 63, 65, 1001)  # the redesigns' ragged row counts
I8_N1 = (1, 2, 4, 8)


@pytest.fixture(autouse=True)
def _host_data_on_cpu():
    old = default_device()
    set_default_device("cpu")
    yield
    set_default_device(old)


def _header_int(name: str, path: pathlib.Path = HEADER) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", path.read_text())
    assert m, name
    return int(m.group(1))


def test_host_constants_match_the_header():
    assert cp.LANE_PITCH == _header_int("kPitch")
    assert cp.LS_TILE == _header_int("kTileRows")
    assert cp.LANE_MAX_CLUSTER == _header_int("kMaxCluster")
    # kSmem = (3 kPlane + 4 kTileWords) x 4 bytes
    assert cp.LANE_SMEM == (3 * 128 * 128 + 4 * _header_int("kTileRows") * cp.LANE_PITCH) * 4
    assert _header_int("kI8Threads") == 256
    # i8_smem: nine 16 KB table planes, nine 2 KB digit planes, 16 row
    # scales, the input tile, two rows buffers of ceil(16 / n1) rows, four
    # mbarriers
    for n1 in range(1, 9):
        assert cp.lane_i8_smem(n1) == 9 * 16384 + 9 * 2048 + 16 * 4 + 2 * 16 * 128 * 4 + \
            2 * 2 * -(-16 // n1) * n1 * 128 * 4 + 32 <= MAX_SMEM


def test_tf32_constants_match_the_source():
    src = TF32_SOURCE
    assert cp.TF32_ROWS == _header_int("kWgRows", src)
    assert cp.TF32_BINS == _header_int("kWgBins", src) == 2 * _header_int("kWgN", src)
    assert cp.TF32_K_STAGE == _header_int("kWgK", src) == 2 * _header_int("kWgBoxK", src)
    assert cp.TF32_STAGES == _header_int("kWgStages", src)
    assert _header_int("kWgBoxK", src) * 4 == 128  # one row of the 128-byte swizzle a box row
    # G's three half planes, three stages of a and b, two stages' a + b, six
    # 8-byte mbarriers and 1 KB to align the 128-byte swizzle's atoms
    assert cp.TF32_SMEM == 3 * 64 * 128 * 4 + 3 * 2 * 64 * 64 * 4 + 2 * 64 * 64 * 4 + 6 * 8 \
        + 1024 <= MAX_SMEM


def _gathered(cols: int, cluster: int) -> np.ndarray:
    """(16, cols) count of the whole-row stores of one tile (lane_gather_map),
    each source word checked against the row and column it holds."""
    seen = np.zeros((16, cols), np.int64)
    for stores in cp.lane_gather_map(cols, cluster):
        for r, c, src, word in stores:
            assert src == c // 128 < min(cluster, cols // 128)
            assert word == r * cp.LANE_PITCH + c % 128
            seen[r, c:c + 4] += 1
    return seen


def _stores(kind, plan, b, n):
    """Count of stores of each (row, column) the plan makes: the walk's
    tiles, and in each tile the gather map (whole rows) or each CTA's
    512-byte runs (ls_full's slices, CTA k1 at columns 128 k1 ..)."""
    count = np.zeros((b, n), np.int64)
    for chunk, tiles in cp.lane_cluster_walk(kind, plan, b):
        c0 = chunk * cp.LANE_CHUNK if kind == "gmm_concat" else 0
        cols = min(cp.LANE_CHUNK, n - c0) if kind == "gmm_concat" else n
        tile = _gathered(cols, plan.cluster) if plan.store_rows else np.ones((16, cols), np.int64)
        for t in tiles:
            rows = min(16, b - 16 * t)
            count[16 * t:16 * t + rows, c0:c0 + cols] += tile[:rows]
    return count


@pytest.mark.parametrize("n1", GMM_N1)
@pytest.mark.parametrize("resident", RESIDENT)
def test_gmm_concat_plan_stores_every_point_once(n1, resident):
    n = 128 * n1
    for b in SHAPES_B:
        plan = cp.lane_cluster_plan("gmm_concat", b, n, resident=resident)
        assert plan.cluster == min(n1, 8) <= cp.LANE_MAX_CLUSTER
        assert plan.chunks == -(-n // 1024) and plan.clusters % plan.chunks == 0
        assert plan.ctas == plan.clusters * plan.cluster
        assert plan.store_rows == 1 and plan.buffers == 2 and plan.rows_tile == 16
        assert plan.smem == cp.LANE_SMEM <= MAX_SMEM
        assert 1 <= plan.clusters // plan.chunks <= -(-b // 16)
        assert (_stores("gmm_concat", plan, b, n) == 1).all(), (b, resident)


@pytest.mark.parametrize("setting", list(r3.FULL_SETTINGS), ids=list(r3.FULL_SETTINGS))
@pytest.mark.parametrize("n1", cp.LS_N1)
def test_ls_full_plan_stores_every_point_once(setting, n1):
    kw = r3.FULL_SETTINGS[setting]
    rows_per_block = kw.get("rows_per_block", 16)
    chunk_rows = 16 // kw.get("chunks", 1)
    store_rows = int(kw.get("store", "slices") == "rows")
    n = 128 * n1
    for b in SHAPES_B:
        for resident in RESIDENT:
            plan = cp.lane_cluster_plan("ls_full", b, n, rows_per_block, chunk_rows, store_rows,
                                        resident)
            assert plan.cluster == n1 and plan.chunks == 1 and plan.ctas == n1 * plan.clusters
            assert plan.tiles_unit == rows_per_block // 16 and plan.chunk_rows == chunk_rows
            assert plan.store_rows == store_rows and plan.smem <= MAX_SMEM
            units = -(-(-(-b // 16)) // plan.tiles_unit)
            assert plan.clusters == min(resident, units)
            tiles = [t for _, ts in cp.lane_cluster_walk("ls_full", plan, b) for t in ts]
            assert sorted(tiles) == list(range(-(-b // 16)))
            assert (_stores("ls_full", plan, b, n) == 1).all(), (b, resident)


@pytest.mark.parametrize("n1", GMM_N1[:4])
def test_gather_map_covers_each_row_once(n1):
    cols = 128 * n1
    seen = np.zeros((16, cols), np.int64)
    for rank, stores in enumerate(cp.lane_gather_map(cols, n1)):
        rows = {r for r, *_ in stores}
        assert rows == set(range(rank, 16, n1))  # rank r stores rows r, r + cluster, ...
        for r, c, src, word in stores:
            seen[r, c:c + 4] += 1
            assert src == c // 128
    assert (seen == 1).all()
    # A ragged chunk (n = 1152: 8 CTAs, one slice of 128 columns)
    seen = np.zeros((16, 128), np.int64)
    for stores in cp.lane_gather_map(128, 8):
        for r, c, src, _ in stores:
            assert src == 0
            seen[r, c:c + 4] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("n1", cp.LS_N1)
def test_network_scatter_reads_each_input_once_and_lands_in_its_owner(n1):
    m = cp.lane_network_scatter(n1)
    P = 128 // n1
    loaded = np.zeros((16, 128 * n1), np.int64)
    for c in range(n1):
        words = {}
        for r, word, col in m["loads"][c]:
            loaded[r, col:col + 4] += 1
            assert word % 4 == 0 and col % 4 == 0
            words.update({word + i: col + i for i in range(4)})
        # each (row, point) pair reads its point p of slices 0 .. n1 - 1
        for (r, p), reads in zip([(e // P, e % P) for e in range(16 * P)], m["reads"][c]):
            assert [words[w] for w in reads] == [128 * j1 + c * P + p for j1 in range(n1)]
    assert (loaded == 1).all()
    written = np.zeros((n1, 16 * cp.LANE_PITCH), np.int64)
    for c in range(n1):
        for e, writes in enumerate(m["writes"][c]):
            r, p = e // P, e % P
            assert [k1 for k1, _ in writes] == list(range(n1))  # output slice k1 to CTA k1
            for k1, word in writes:
                assert word == r * cp.LANE_PITCH + c * P + p
                written[k1, word] += 1
    for k1 in range(n1):
        grid = written[k1].reshape(16, cp.LANE_PITCH)
        assert (grid[:, :128] == 1).all() and (grid[:, 128:] == 0).all()


@pytest.mark.parametrize("b", RAGGED_B)
@pytest.mark.parametrize("n1", I8_N1)
def test_i8_concat_plan_stores_every_point_once(n1, b):
    """i8_concat: a cluster of n1 CTAs (<= 8), two rows buffers, every tile
    walked once; every output of a tile pushed once, to the owner of its row
    (CTA r % n1) at a word of its rows buffer no other push takes, and every
    (row, column) stored once by its owner's whole-row store."""
    n = 128 * n1
    pushed = np.zeros((16, n), np.int64)
    for k1, stores in enumerate(cp.i8_push_map(n1)):
        words = set()
        for r, c, owner, word in stores:
            assert owner == r % n1 and word == (r // n1) * n + c and c // 128 == k1
            assert (owner, word) not in words
            words.add((owner, word))
            pushed[r, c:c + 2] += 1
    assert (pushed == 1).all()
    for resident in RESIDENT:
        plan = cp.lane_cluster_plan("i8_concat", b, n, resident=resident)
        assert plan.cluster == n1 <= cp.LANE_MAX_CLUSTER and plan.chunks == 1
        assert plan.ctas == n1 * plan.clusters and plan.clusters == min(resident, -(-b // 16))
        assert plan.buffers == 2 and plan.store_rows == 1 and plan.tiles_unit == 1
        assert plan.smem == cp.lane_i8_smem(n1) <= MAX_SMEM
        tiles = [t for _, ts in cp.lane_cluster_walk("i8_concat", plan, b) for t in ts]
        assert sorted(tiles) == list(range(-(-b // 16)))
        count = np.zeros((b, n), np.int64)
        for t in tiles:
            for owner in range(n1):  # the owner stores its rows owner, owner + n1, ... whole
                for r in range(owner, 16, n1):
                    if 16 * t + r < b:
                        count[16 * t + r] += 1
        assert (count == 1).all(), (b, resident)


@pytest.mark.parametrize("b", RAGGED_B)
@pytest.mark.parametrize("n1", I8_N1)
def test_gmm_tf32_plan_contracts_every_tile_and_bin_once(n1, b):
    """gmm_tf32: pairs of CTAs, the resident pairs split evenly among the n1
    slices, every 64-row tile of every slice walked once, the two CTAs'
    bins the slice's 128 once; 230,448 bytes a CTA."""
    n = 128 * n1
    for resident in RESIDENT + (66,):
        plan = cp.gmm_tf32_plan(b, n, resident)
        assert plan.pair == 2 and plan.ctas == 2 * plan.pairs
        assert plan.pairs == plan.per_slice * n1
        assert plan.per_slice == min(max(resident // n1, 1), -(-b // 64))
        assert plan.rows_tile == 64 and plan.stages == 3 and plan.k_stage == 64
        assert plan.smem == cp.TF32_SMEM <= MAX_SMEM and plan.chain == cp.GMM_TF32_CHAIN
        count = np.zeros((b, n), np.int64)
        bins = cp.gmm_tf32_bins(plan)
        assert sorted(k for r in bins for k in r) == list(range(128))
        for k1, tiles in cp.gmm_tf32_walk(plan, b, n):
            for t in tiles:
                for r in bins:
                    count[64 * t:64 * t + 64, 128 * k1 + r.start:128 * k1 + r.stop] += 1
        assert (count == 1).all(), (b, resident)


def test_gmm_tf32_operand_layout_is_the_128_byte_swizzle():
    """gmm_tf32_offset places every element of a 64-row stage plane and of a
    resident G plane once, four bytes apart, each 8-row atom in its own 1024
    bytes; the k8 steps start 32 bytes apart in a chunk's rows (the
    descriptor's start), and a row's eight 16-byte units are a permutation
    (the XOR with the row mod 8)."""
    for rows, cols in ((64, 64), (64, 128)):
        offs = sorted(cp.gmm_tf32_offset(r, k, rows) for r in range(rows) for k in range(cols))
        assert offs == list(range(0, 4 * rows * cols, 4))
        for r in range(rows):
            units = {(cp.gmm_tf32_offset(r, k, rows) % 128) // 16 for k in range(32)}
            assert units == set(range(8))
            assert {cp.gmm_tf32_offset(r, k, rows) // 1024 for k in range(32)} == {r // 8}
    for j in range(16):  # k-step j: columns 8 j .. 8 j + 7, at row 0 32 bytes from the chunk's
        assert cp.gmm_tf32_offset(0, 8 * j, 64) == (j >> 2) * 64 * 128 + (j & 3) * 32


def test_gmm_tf32_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(RuntimeError, match="no pair"):
        cp.gmm_tf32_plan(64, 1024, resident=0)
    for b, n in ((16, 200), (-1, 128), (16, 64)):
        with pytest.raises(ValueError):
            cp.gmm_tf32_plan(b, n)


def test_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(RuntimeError, match="no cluster"):
        cp.lane_cluster_plan("gmm_concat", 16, 1024, resident=0)
    with pytest.raises(RuntimeError, match="no cluster"):
        cp.lane_cluster_plan("ls_full", 16, 1024, resident=0)
    with pytest.raises(RuntimeError, match="no cluster"):
        cp.lane_cluster_plan("i8_concat", 16, 1024, resident=0)
    for kind, n, kw in (("gmm_concat", 200, {}), ("ls_full", 384, {}), ("i8_concat", 1152, {}),
                        ("i8_concat", 200, {}),
                        ("ls_full", 2048, {}), ("ls_full", 1024, {"rows_per_block": 24}),
                        ("ls_full", 1024, {"chunk_rows": 3}), ("ls_full", 1024, {"store_rows": 2}),
                        ("gmm", 1024, {})):
        with pytest.raises(ValueError):
            cp.lane_cluster_plan(kind, 16, n, **kw)
    with pytest.raises(ValueError, match="n1"):
        cp.lane_network_scatter(3)


@pytest.mark.parametrize("name", ["ls_full", "ls_full_stream"])
def test_ls_full_wrappers_raise_on_bad_settings(name):
    fn = getattr(cp, name)
    x = torch.zeros(4, 1024)
    for kw in ({"store": "cols"}, {"chunks": 3}, {"rows_per_block": 8}, {"rows_per_block": 40}):
        with pytest.raises(ValueError):
            fn(x, x, **kw)
    with pytest.raises(ValueError):
        fn(torch.zeros(4, 384), torch.zeros(4, 384))


@pytest.mark.parametrize("name", ["gmm_concat", "gmm_concat_stream"])
def test_gmm_concat_wrappers_raise_on_bad_shapes(name):
    fn = getattr(cp, name)
    with pytest.raises(ValueError):
        fn(torch.zeros(4, 200), torch.zeros(4, 200))
    with pytest.raises(ValueError):
        fn(torch.zeros(4, 256), torch.zeros(4, 128))


@pytest.mark.parametrize("n", [128, 384, 1024, 2048])
def test_gmm_concat_and_its_yardstick_on_cpu_tensors_are_k13(n):
    g = np.random.default_rng(n)
    xr, xi = (torch.from_numpy(g.standard_normal((17, n))) for _ in range(2))
    want = cuda_metrics.gmm_floor_plain(xr, xi)
    for fn in (cp.gmm_concat, cp.gmm_concat_stream):
        got = fn(xr, xi)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("setting", list(r3.FULL_SETTINGS), ids=list(r3.FULL_SETTINGS))
def test_ls_full_and_its_yardstick_on_cpu_tensors_are_the_plain_version(setting):
    g = np.random.default_rng(5)
    xr, xi = (torch.from_numpy(g.standard_normal((17, 512))) for _ in range(2))
    want = cp.ls_full_plain(xr, xi)
    for fn in (cp.ls_full, cp.ls_full_stream):
        got = fn(xr, xi, **r3.FULL_SETTINGS[setting])
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_contract_probe_source_runs_every_variant():
    """probes.contract's CUDA source (built only on the card) runs each
    variant once, each a whole tile of 128 bins: (128 / bins) x (rows /
    rows a thread) threads; gmm_concat's own tile among them."""
    from godsp_tpu_torch.probes import contract

    src = contract.source()
    for t, r, c, rows in contract.VARIANTS:
        assert (128 // c) * (rows // r) == t
        assert src.count(f"run<{t}, {r}, {c}, {rows}>(g, out);") == 1
    assert (128, _header_int("kR"), _header_int("kC"), 16) in contract.VARIANTS
    assert "@RUNS@" not in src


def test_contract_probe_breakdown_takes_out_lines_of_the_kernel():
    """probes.contract --breakdown takes each of its lines out of the
    current gmm_concat kernel source exactly once."""
    from godsp_tpu_torch.probes import contract

    src = (HEADER.parent / "lane_probe_kernels.cu").read_text()
    for variant, lines in contract.BREAKDOWN.items():
        out = contract.breakdown_source(src, variant)
        assert len(out) == len(src) - sum(len(line) for line in lines), variant
    with pytest.raises(ValueError, match="not in the source"):
        contract.breakdown_source("", "no gather")
