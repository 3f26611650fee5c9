"""K14d bd_tf32 and K14h vdif as redesigned for Hopper, on the CPU.

bd_tf32 runs on wgmma m64n128k8 with A from registers, on a persistent
grid of one CTA an SM that walks the (plane, 64-row tile, slice) items
through a TMA ring (csrc/anatomy_probe_kernels.cu: make_bd1_plan,
bd_tf32_kernel); vdif on blocks of four warps, a warp a row, each row
brought by 16-byte cp.async into the warp's shared buffer
(csrc/dif_probe_kernels.cu: make_vdif_plan, vdif_kernel).  Their plans'
mirrors in ops/cuda_probes.py must hand every item or row to exactly one
CTA or warp; the kernels' constants are read from the sources and held to
the mirrors'; the A fragments bd_tf32 reads from a landed TMA box and the
T values a vdif lane reads from shared memory must hit 32 banks.  The
yardsticks bd_tf32_sync and vdif_sync take their plain versions on CPU
tensors and raise as the redesigns do; probes.bd1_vdif's variant copies
find their lines once and its SASS and ptxas readers count on recorded
text.  The kernels themselves run only on the card
(tests/test_torch_cuda.py).
"""

import re

import numpy as np
import pytest
import torch

from godsp_tpu_torch import default_device, set_default_device
from godsp_tpu_torch.ops import _build, launch_counts
from godsp_tpu_torch.ops import cuda_probes as cp
from godsp_tpu_torch.probes import bd1_vdif

SMEM_LIMIT = 232_448  # shared memory a block can use on the H100


@pytest.fixture(autouse=True)
def _host_data_on_cpu():
    """Host data goes to the CPU here; the port's default device is the card."""
    old = default_device()
    set_default_device("cpu")
    yield
    set_default_device(old)


def _constants(src: str) -> dict[str, int]:
    """The constexpr ints of a csrc source that are sums and products of
    numbers and the ones before them."""
    text = (_build.CSRC / src).read_text()
    env: dict[str, int] = {}
    for name, expr in re.findall(r"constexpr int (k\w+) =\s*([^;]+);", text):
        names = set(re.findall(r"[A-Za-z_]\w*", expr))
        if re.fullmatch(r"[\w\s*+/()-]+", expr) and names <= set(env):
            env[name] = int(eval(expr, {"__builtins__": {}}, dict(env)))  # noqa: S307
    return env


@pytest.mark.parametrize("resident", [1, 7, 132])
@pytest.mark.parametrize("n1", [1, 3, 8, 16])
@pytest.mark.parametrize("b", [1, 64, 1001, 16384])
def test_bd_tf32_walk_covers_every_item_once(b, n1, resident):
    """Every (plane, 64-row tile, slice) goes to one CTA once; the CTAs are
    the resident ones but no more than the items, the busiest walks
    per_cta items, and a CTA's items follow the planes row by row, the
    slice fastest."""
    n = 128 * n1
    plan = cp.bd_tf32_plan(b, n, resident)
    walk = cp.bd_tf32_walk(plan, b, n)
    tiles = -(-b // plan.rows_tile)
    assert plan.ctas == min(resident, 2 * tiles * n1) and len(walk) == plan.ctas
    assert max(len(w) for w in walk) == plan.per_cta
    assert max(len(w) for w in walk) - min(len(w) for w in walk) <= 1
    seen = [item for w in walk for item in w]
    assert len(seen) == len(set(seen)) == 2 * tiles * n1
    assert set(seen) == {(p, t, s) for p in (0, 1) for t in range(tiles) for s in range(n1)}
    assert all(w == sorted(w) for w in walk)


@pytest.mark.parametrize("n1", [1, 2, 4, 8])
@pytest.mark.parametrize("b", [0, 1, 5, 9, 1001, 16384, 8 * 65535 + 9])
def test_vdif_walk_covers_every_row_once(b, n1):
    """Every row goes to one warp once, a warp at most one row; the blocks
    are what the rows fill (one where there is none), and a block's shared
    memory (T and a row buffer a warp) fits."""
    plan = cp.vdif_plan(b, 128 * n1)
    assert plan.smem == cp.vdif_smem(n1) == 8 * 128 * n1 * (1 + cp.VD_WARPS)
    assert plan.smem <= SMEM_LIMIT and plan.threads == 32 * cp.VD_WARPS
    assert plan.blocks == max(1, -(-b // cp.VD_WARPS))
    walk = cp.vdif_walk(plan, b)
    assert len(walk) == cp.VD_WARPS * plan.blocks and max(len(w) for w in walk) <= 1
    assert sorted(r for w in walk for r in w) == list(range(b))


def test_plans_match_the_kernel_constants():
    """The mirrors' constants are the kernels': bd_tf32's rows a tile, box
    columns, stages, threads, store rows and shared bytes (the 64 KB table,
    five 32 KB stages, two mbarriers a stage, 1 KB of alignment) within the
    card's limit; vdif's warps a block and blocks an SM; the
    plans at the probes' shapes and at no rows; bad shapes raise, and
    bd_tf32's where no CTA is resident."""
    k = _constants("anatomy_probe_kernels.cu")
    assert (k["kB1Rows"], k["kB1K"], k["kB1Stages"], k["kB1Threads"], k["kB1StoreRows"]) == (
        cp.B1_ROWS, cp.B1_K, cp.B1_STAGES, cp.B1_THREADS, cp.B1_STORE_ROWS)
    assert k["kB1Smem"] == cp.B1_SMEM == 230_480 <= SMEM_LIMIT
    assert k["kB1Consumers"] == 256 and k["kB1Stage"] == cp.B1_ROWS * 128 * 4
    d = _constants("dif_probe_kernels.cu")
    assert (d["kVdWarps"], d["kVdThreads"], d["kVdMinBlocks"]) == (
        cp.VD_WARPS, 32 * cp.VD_WARPS, cp.VD_MIN_BLOCKS)
    assert cp.bd_tf32_plan(16384, 1024) == cp.Bd1Plan(132, 32, 64, 128, 5, 288, cp.B1_SMEM, 16)
    assert cp.bd_tf32_plan(0, 128, 5) == cp.Bd1Plan(1, 0, 64, 128, 5, 288, cp.B1_SMEM, 16)
    assert cp.vdif_plan(16384, 1024) == cp.VdifPlan(128, 4096, 40_960)
    assert cp.vdif_plan(0, 128) == cp.VdifPlan(128, 1, 5120)
    for bad in ((-1, 128), (4, 100), (4, 0), (2**31, 128)):
        with pytest.raises(ValueError):
            cp.bd_tf32_plan(*bad)
    for bad in ((-1, 128), (4, 384), (4, 2048), (4, 100)):
        with pytest.raises(ValueError):
            cp.vdif_plan(*bad)
    with pytest.raises(RuntimeError):
        cp.bd_tf32_plan(64, 128, 0)


@pytest.mark.parametrize("kk", range(4))
def test_bd_tf32_fragments_hit_32_banks(kk):
    """bd_tf32 reads its A values from a landed box as bd_hi does: each of
    the four values a lane reads at k-step kk is the element the wgmma A
    layout wants, and a warp's 32 lanes read 32 banks."""
    offs = cp.bd_hi_fragment_offsets(kk)
    for lane, words in enumerate(offs):
        g, t = divmod(lane, 4)
        for off, (r, c) in zip(words, ((g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4))):
            row, unit = divmod(off, 128)
            assert row == r and ((unit >> 4) ^ (row & 7)) * 4 + (unit & 15) // 4 == 8 * kk + c
    for q in range(4):
        assert len({offs[lane][q] // 4 % 32 for lane in range(32)}) == 32


@pytest.mark.parametrize("j", range(16))
def test_bd_tf32_outputs_land_as_the_store_box_reads_them(j):
    """The float2 each lane writes for the accumulators' 8-column block j sits
    at its (row, column) of a 64-row x 32-column box in the 128-byte
    swizzle, the warp's 32 lanes covering the block's 16 rows x 8 columns
    once, and a half-warp's writes take two wavefronts (a two-way
    conflict)."""
    offs = cp.bd_tf32_store_offsets(j)
    cells = set()
    for lane, pair in enumerate(offs):
        g, t = divmod(lane, 4)
        for hh, off in enumerate(pair):
            row, unit = divmod(off, 128)
            col = ((unit >> 4) ^ (row & 7)) * 4 + (unit & 15) // 4
            assert (row, col) == (g + 8 * hh, 8 * (j % 4) + 2 * t) and off % 8 == 0
            cells |= {(row, col), (row, col + 1)}
    assert cells == {(r, 8 * (j % 4) + c) for r in range(16) for c in range(8)}
    for hh in (0, 1):
        for half in (range(16), range(16, 32)):
            banks = [(offs[lane][hh] // 4 + w) % 32 for lane in half for w in (0, 1)]
            assert max(banks.count(x) for x in set(banks)) == 2


def test_vdif_shared_reads_hit_32_banks():
    """A lane reads T[k1, lane + 32 q] from shared memory as a float2 (each
    half-warp's 16 reads cover 32 banks) and its row values buf[j1 128 +
    lane + 32 q] (and n on) as floats (a warp's 32 reads, 32 banks); the
    16-byte copies that fill the buffer write a quarter-warp's 128 bytes in
    32 banks."""
    for k1 in range(8):
        for q in range(4):
            words = [2 * (k1 * 128 + lane + 32 * q) for lane in range(32)]
            for half in (words[:16], words[16:]):
                assert sorted((w + e) % 32 for w in half for e in (0, 1)) == list(range(32))
            row = [k1 * 128 + lane + 32 * q for lane in range(32)]
            assert sorted(w % 32 for w in row) == list(range(32))
    for e0 in range(0, 1024, 128):
        for quarter in range(4):
            words = [e0 + 4 * lane + c for lane in range(8 * quarter, 8 * quarter + 8)
                     for c in range(4)]
            assert sorted(w % 32 for w in words) == list(range(32))


@pytest.mark.parametrize("b,n", [(64, 1024), (13, 384), (1, 128)])
def test_yardsticks_on_the_cpu(b, n):
    """bd_tf32_sync and vdif_sync give their plain versions on CPU tensors
    (no launch counted) and raise where bd_tf32 and vdif do; their launch
    counters exist."""
    rng = np.random.default_rng(b + n)
    xr, xi = (torch.from_numpy(v) for v in rng.normal(size=(2, b, n)).astype(np.float32))
    before = launch_counts()
    assert before["bd_tf32_sync"] >= 0 and before["vdif_sync"] >= 0
    table = torch.from_numpy(rng.normal(size=(128, 128)).astype(np.float32))
    for tab in (None, table):
        want = cp.bd_tf32_plain(xr, xi, tf32=True, table=tab)
        for fn in (cp.bd_tf32, cp.bd_tf32_sync):
            got = fn(xr, xi, tab)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if n // 128 in cp.VDIF_N1:
        want = cp.vdif_plain(xr, xi, 0.5)
        for fn in (cp.vdif, cp.vdif_sync):
            got = fn(xr, xi, 0.5)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert launch_counts() == before
    for fn in (cp.bd_tf32, cp.bd_tf32_sync, cp.vdif, cp.vdif_sync):
        with pytest.raises(ValueError):
            fn(torch.zeros(2, 1000), torch.zeros(2, 1000))
        with pytest.raises(ValueError):
            fn(torch.zeros(2, 256), torch.zeros(3, 256))
    for fn in (cp.vdif, cp.vdif_sync):
        with pytest.raises(ValueError):
            fn(torch.zeros(2, 384), torch.zeros(2, 384))
    for fn in (cp.bd_tf32, cp.bd_tf32_sync):
        with pytest.raises(ValueError):
            fn(torch.zeros(2, 256), torch.zeros(2, 256), torch.zeros(64, 128))


_PTXAS = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114bd_tf32_kernelEPKfS1_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114bd_tf32_kernelEPKfS1_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 154 registers, used 1 barriers, 1200 bytes cmem[0]
"""


def test_bd1_vdif_probe_reads_its_kernels():
    """probes.bd1_vdif's variant and tuning copies find their lines once; its SASS
    reader counts a unit of the loop that holds the marking opcode;
    blocks_per_sm takes registers, threads and shared memory; main needs a
    card."""
    for _, src, _, entry, edits in bd1_vdif.VARIANTS + bd1_vdif.TUNE:
        s = bd1_vdif.variant_source(src, edits)
        assert all(s.count(repl) >= 1 for _, repl in edits) and entry in s
    body = [(0x100, "LDG.E.CONSTANT R4, desc[UR4][R2.64]")]
    body += [(0x110 + 16 * i, "HMMA.1688.F32.TF32 R8, R12, R16, R8") for i in range(32)]
    body += [(0x400 + 16 * i, "LDS R20, [R21]") for i in range(64)]
    body += [(0x800 + 16 * i, "SHFL.BFLY PT, R3, R4, 0x10, 0x1f") for i in range(3)]
    body += [(0x900, "@P0 BRA 0x100"), (0x910, "STG.E [R2.64], R4"), (0x920, "EXIT")]
    listing = "\n".join(f"        /*{a:04x}*/  {t} ;" for a, t in body)
    units, per = bd1_vdif.sass_counts(listing, "HMMA", 16)
    assert units == 2 and per["HMMA"] == 16 and per["LDS"] == 32 and per["LDG"] == 0.5
    assert per["total"] == (1 + 32 + 64 + 3 + 1) / 2 and "STG" not in per
    units, per = bd1_vdif.sass_counts(listing, "STG", 1)  # no loop holds it: the whole listing
    assert units == 1 and per["STG"] == 1 and per["total"] == len(body)
    assert len(bd1_vdif.loop_of(listing, "SHFL")) == len(body) - 2
    info = bd1_vdif.ptxas_info(_PTXAS, ("14bd_tf32_kernel", "11vdif_kernelILi8E"))
    assert info == {"14bd_tf32_kernel": (154, "0 bytes stack frame, 0 bytes spill stores, 0 "
                                              "bytes spill loads")}
    assert bd1_vdif.blocks_per_sm(info["14bd_tf32_kernel"][0], 288, cp.B1_SMEM) == 1
    assert bd1_vdif.blocks_per_sm(168, 128, 8192) == 3
    assert bd1_vdif.blocks_per_sm(40, 256, 0) == 6
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            bd1_vdif.main([])
