"""K14d bd_hi and K14c slicestore as redesigned for Hopper, on the CPU.

bd_hi runs on wgmma on pairs of CTAs that keep half a slice's bins of six
TF32 planes resident and walk the (64-row tile, slice) items in turn
(csrc/anatomy_probe_kernels.cu: make_hi_plan, bd_hi_kernel).  Its plan's
mirror, ops/cuda_probes.py's bd_hi_plan and bd_hi_walk, must hand every
(slice, tile, bin half) to exactly one CTA, and the A fragments the
consumer warps read from a landed TMA box must hit 32 banks.  The
kernel's constants are read from the source and held to the mirror's.
The yardsticks bd_hi_sync and slicestore_sync take their plain versions
on CPU tensors and raise as the redesigns do; probes.bd_hi's variant
copies find their lines once and its SASS reader counts a k-step.  The
kernels themselves run only on the card (tests/test_torch_cuda.py).
"""

import re

import numpy as np
import pytest
import torch

from godsp_tpu_torch import default_device, set_default_device
from godsp_tpu_torch.ops import _build, launch_counts
from godsp_tpu_torch.ops import cuda_probes as cp
from godsp_tpu_torch.probes import bd_hi

SMEM_LIMIT = 232_448  # shared memory a block can use on the H100


@pytest.fixture(autouse=True)
def _host_data_on_cpu():
    """Host data goes to the CPU here; the port's default device is the card."""
    old = default_device()
    set_default_device("cpu")
    yield
    set_default_device(old)


def _kernel_constants() -> dict[str, int]:
    """The constexpr ints of csrc/anatomy_probe_kernels.cu that are sums and
    products of numbers and the ones before them (bd_hi's among them)."""
    src = (_build.CSRC / "anatomy_probe_kernels.cu").read_text()
    env: dict[str, int] = {}
    for name, expr in re.findall(r"constexpr int (k\w+) =\s*([^;]+);", src):
        if re.fullmatch(r"[\w\s*+/()-]+", expr) and "sizeof" not in expr:
            env[name] = int(eval(expr, {"__builtins__": {}}, dict(env)))  # noqa: S307
    return env


@pytest.mark.parametrize("resident", [1, 7, 66])
@pytest.mark.parametrize("n1", [1, 3, 8, 16])
@pytest.mark.parametrize("b", [1, 64, 1001, 16384])
def test_bd_hi_walk_covers_every_item_once(b, n1, resident):
    """Every (slice, 64-row tile, bin half) goes to one CTA once; the pairs
    are the resident ones but no more than the items, and the busiest
    walks per_pair items."""
    n = 128 * n1
    plan = cp.bd_hi_plan(b, n, resident)
    walk = cp.bd_hi_walk(plan, b, n)
    tiles = -(-b // plan.rows_tile)
    assert plan.pairs == min(resident, tiles * n1) and plan.ctas == 2 * plan.pairs
    assert len(walk) == plan.pairs and max(len(w) for w in walk) == plan.per_pair
    assert max(len(w) for w in walk) - min(len(w) for w in walk) <= 1
    seen = [(s, t, h) for w in walk for s, t in w for h in range(plan.pair)]
    assert len(seen) == len(set(seen)) == 2 * tiles * n1
    assert set(seen) == {(s, t, h) for s in range(n1) for t in range(tiles) for h in (0, 1)}
    # A pair's items follow the plane row by row: the slice fastest.
    assert all(w == sorted(w, key=lambda st: (st[1], st[0])) for w in walk)


def test_bd_hi_plan_matches_the_kernel_constants():
    """The mirror's constants are the kernel's: rows a tile, bins a CTA,
    stages, columns a stage, chain, and the shared bytes (six 32 KB planes,
    two 16 KB stages, an mbarrier and a count a stage, 1 KB of alignment),
    within the card's limit."""
    k = _kernel_constants()
    assert (k["kHiRows"], k["kHiBins"], k["kHiStages"], k["kHiK"], k["kHiChain"]) == (
        cp.HI_ROWS, cp.HI_BINS, cp.HI_STAGES, cp.HI_K_STAGE, cp.BD_HI_CHAIN)
    assert k["kHiSmem"] == cp.HI_SMEM == 230_424 <= SMEM_LIMIT
    assert k["kHiThreads"] == 256 and k["kHiN"] * 2 == cp.HI_BINS
    plan = cp.bd_hi_plan(16384, 1024)
    assert plan == cp.HiPlan(2, 66, 132, 64, 64, 2, 32, cp.HI_SMEM, 32, cp.BD_HI_CHAIN)
    assert cp.bd_hi_plan(0, 128, 5) == cp.HiPlan(2, 1, 2, 64, 64, 2, 32, cp.HI_SMEM, 0,
                                                 cp.BD_HI_CHAIN)
    for bad in ((-1, 128), (4, 100), (4, 0), (2**31, 128)):
        with pytest.raises(ValueError):
            cp.bd_hi_plan(*bad)
    with pytest.raises(RuntimeError):
        cp.bd_hi_plan(64, 128, 0)


@pytest.mark.parametrize("kk", range(4))
def test_bd_hi_fragments_hit_32_banks(kk):
    """Each of the four A values a lane reads at k-step kk of a landed box
    is the element the wgmma A layout wants (rows g, g + 8; columns
    8 kk + t, 8 kk + t + 4; the swizzle undone), and a warp's 32 lanes read
    32 banks."""
    offs = cp.bd_hi_fragment_offsets(kk)
    for lane, words in enumerate(offs):
        g, t = divmod(lane, 4)
        for off, (r, c) in zip(words, ((g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4))):
            row, unit = divmod(off % (64 * 128), 128)
            assert off // (64 * 128) == 0 and row == r
            assert ((unit >> 4) ^ (row & 7)) * 4 + (unit & 15) // 4 == 8 * kk + c
    for q in range(4):
        assert len({offs[lane][q] // 4 % 32 for lane in range(32)}) == 32


@pytest.mark.parametrize("b,n", [(64, 1024), (13, 384), (1, 128)])
def test_yardsticks_on_the_cpu(b, n):
    """bd_hi_sync and slicestore_sync give their plain versions on CPU
    tensors (no launch counted) and raise where bd_hi and slicestore do;
    their launch counters exist."""
    rng = np.random.default_rng(b + n)
    xr, xi = (torch.from_numpy(v) for v in rng.normal(size=(2, b, n)).astype(np.float32))
    before = launch_counts()
    assert before["bd_hi_sync"] >= 0 and before["slicestore_sync"] >= 0
    want = cp.bd_hi_plain(xr, xi)
    for fn in (cp.bd_hi, cp.bd_hi_sync):
        got = fn(xr, xi)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for fn in (cp.slicestore, cp.slicestore_sync):
        got = fn(xr, xi)
        assert torch.equal(got[0], xr) and torch.equal(got[1], xi)
    assert launch_counts() == before
    for fn in (cp.bd_hi, cp.bd_hi_sync, cp.slicestore, cp.slicestore_sync):
        with pytest.raises(ValueError):
            fn(torch.zeros(2, 1000), torch.zeros(2, 1000))
        with pytest.raises(ValueError):
            fn(torch.zeros(2, 256), torch.zeros(3, 256))


def test_bd_hi_probe_reads_its_kernels():
    """probes.bd_hi's variant and chain copies find their lines once;
    kstep_counts reads a loop's instructions a k-step."""
    for _, src, _, _, edits, _ in bd_hi.VARIANTS:
        s = bd_hi.variant_source(src, edits)
        assert all(s.count(repl) >= 1 for _, repl in edits)
    for c in bd_hi.CHAINS:
        s = bd_hi.variant_source("anatomy_probe_kernels.cu",
                                 ((bd_hi._CHAIN, f"constexpr int kHiChain = {c};"),))
        assert f"constexpr int kHiChain = {c};" in s
    with pytest.raises(LookupError):
        bd_hi.variant_source("lane_probe_kernels.cu", (("no such line", ""),))
    body = [(0x100, "LDG.E.CONSTANT R4, desc[UR4][R2.64]")]
    body += [(0x110 + 16 * i, "HMMA.1688.F32.TF32 R8, R12, R16, RZ") for i in range(144)]
    body += [(0x1000 + 16 * i, "LDS R20, [R21]") for i in range(192)]
    body += [(0x2000, "IMAD R1, R2, R3, RZ"), (0x2010, "@P0 BRA 0x100")]
    listing = "\n".join(f"        /*{a:04x}*/  {t} ;" for a, t in body)
    steps, per = bd_hi.kstep_counts(listing)
    assert steps == 2 and per["HMMA"] == 72 and per["LDS"] == 96 and per["IMAD"] == 0.5
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            bd_hi.main([])
