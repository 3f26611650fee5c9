"""K14g's i8full and K14a's pwfloor_frameonly as redesigned for Hopper, on
the CPU: the redesigned i8full's step order (its plan and walk, the digit
warps' copies and A fragments, the digit buffers handed to the product
warps, the 16-byte stores) modelled in torch and numpy against its plain
version, its digit ladder by round-down adds against digits3, the shared
memory wavefronts it counts, frameonly's register sums against the float64
plain version, the sources' constants, the first designs kept as
yardsticks and the probe's readers.  The kernels themselves run in
tests/test_torch_cuda.py, on the card."""

import re
from fractions import Fraction

import numpy as np
import pytest
import torch

from godsp_tpu_torch.ops import _build, cuda_fft, cuda_probes, cuda_pwelch
from godsp_tpu_torch.probes import anat_staged, i8full_frameonly
from godsp_tpu_torch.probes.bd_hi import ptxas_info, variant_source

MAX_SMEM = 232448  # bytes of shared memory one block may use (227 KB)
EPS32 = 2.0 ** -24  # float32's unit roundoff


def _source(name: str) -> str:
    return (_build.CSRC / name).read_text()


def _constexpr(src: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", src)
    assert m, name
    return int(m.group(1))


def _planes(b: int, n: int, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy((rng.normal(size=(b, n)) * 0.01).astype(np.float32))
                 for _ in range(2))


# ------------------------------------------------------------------ i8full


@pytest.mark.parametrize("b,n,resident", [(1001, 512, 132), (33, 384, 132), (33, 384, 5),
                                          (70, 256, 3), (16, 128, 1)])
def test_i8full_step_model_is_the_plain_version(b, n, resident):
    """The redesign's CTAs, steps, copies, row max over a row's lanes,
    digit buffers one step ahead of the products and 16-byte stores give
    i8full_plain bit for bit."""
    xr, xi = _planes(b, n, b + n)
    got = cuda_probes.i8full_steps_model(xr, xi, resident)
    want = cuda_probes.i8full_plain(xr, xi)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("b", [1, 15, 16, 17, 1001, 16384])
@pytest.mark.parametrize("n1", [1, 3, 8])
@pytest.mark.parametrize("resident", [1, 7, 132])
def test_i8full_plan_covers_every_step_once(b, n1, resident):
    """Every (slice, 16-row step) goes to one CTA once; a slice's CTAs hold
    contiguous runs within one step of each other; one CTA a slice at
    least."""
    n = 128 * n1
    plan = cuda_probes.i8full_plan(b, n, resident)
    steps = -(-b // 16)
    assert plan.ctas == min(max(resident, n1), steps * n1)
    assert plan.threads == 384 and plan.smem == cuda_probes.I8FULL_SMEM
    walk = cuda_probes.i8full_walk(plan, b, n)
    seen = sorted((k1, s) for k1, run in walk for s in run)
    assert seen == [(k1, s) for k1 in range(n1) for s in range(steps)]
    for k1 in range(n1):
        sizes = [len(run) for k, run in walk if k == k1]
        assert sizes and max(sizes) - min(sizes) <= 1 and min(sizes) >= 1


def test_i8full_plan_refuses_bad_shapes():
    for b, n, resident in ((-1, 128, 1), (4, 100, 1), (4, 9 * 128, 1), (4, 128, 0)):
        with pytest.raises(ValueError):
            cuda_probes.i8full_plan(b, n, resident)
    assert cuda_probes.i8full_plan(0, 256).ctas == 0


def test_i8full_digit_map_covers_a_step_once():
    """The digit threads' copies bring every (plane, row, 4 columns) of a
    16 x 128 step once, and each thread's copies are the rows and columns
    of the A fragment it writes (mma_s8.cuh: lane 4 g + t at k-step ks
    holds rows g, g + 8, columns 32 ks + 4 t .. and 32 ks + 16 + 4 t ..)."""
    loads, units = cuda_probes.i8full_digit_map()
    assert loads.shape == (128, 8, 2) and sorted(units) == list(range(128))
    for plane in range(2):
        got = sorted((int(r), int(c)) for r, c in loads[:, 4 * plane:4 * plane + 4].reshape(-1, 2))
        assert got == [(r, c) for r in range(16) for c in range(0, 128, 4)]
    for d, unit in enumerate(units):
        ks, g, t = unit >> 5, (unit & 31) >> 2, unit & 3
        want = {(g + 8 * hi, 32 * ks + 16 * h + 4 * t) for hi in range(2) for h in range(2)}
        assert {tuple(x) for x in loads[d, :4]} == want == {tuple(x) for x in loads[d, 4:]}
    # A row's 16 threads (its max by shuffles over lane bits 0, 1, 3, 4) are
    # one warp's lanes with one value of lane bit 2.
    for g in range(8):
        ds = [d for d in range(128) if loads[d, 0, 0] == g]
        assert len(ds) == 16 and len({d // 32 for d in ds}) == 1
        assert len({(d % 32) & 4 for d in ds}) == 1


def test_i8full_store_map_writes_each_column_once():
    """A product warp's 16-byte stores put each of its 16 x 16 outputs once,
    each float taken from the lane and C register that made that column
    (lane 4 g + t holds columns 8 j + 2 t, + 1 of n-tile j)."""
    seen = []
    for lane, h, row, col, src in cuda_probes.i8full_store_map():
        g, t = lane >> 2, lane & 3
        assert row == g + 8 * h and col % 4 == 0
        for e, (from_lane, c) in enumerate(src):
            assert c == col + e and from_lane in (lane, lane ^ 1)
            ft = from_lane & 3
            assert c % 8 in (2 * ft, 2 * ft + 1)  # that lane's columns of its n-tile
            seen.append((row, c))
    assert sorted(seen) == [(r, c) for r in range(16) for c in range(16)]


def _fadd_rd32(a: np.float32, b: np.float32) -> np.float32:
    """a + b rounded down to float32 (IEEE roundTowardNegative), exactly."""
    exact = Fraction(float(a)) + Fraction(float(b))
    c = np.float32(float(exact))
    while Fraction(float(c)) > exact:
        c = np.nextafter(c, np.float32(-np.inf))
    while Fraction(float(np.nextafter(c, np.float32(np.inf)))) <= exact:
        c = np.nextafter(c, np.float32(np.inf))
    return c


def _ladder_rd(v: np.float32) -> tuple[int, int, int]:
    """i8full_kernel's digits3_rd, IEEE operation for operation."""
    f32 = np.float32
    m39, m31, m23 = f32(1.5 * 2.0 ** 39), f32(1.5 * 2.0 ** 31), f32(1.5 * 2.0 ** 23)
    t0 = _fadd_rd32(f32(v + f32(2 ** 15 + 2 ** 7 + 0.5)), m39)
    r0 = f32(v - f32(t0 - m39))
    t1 = _fadd_rd32(f32(r0 + f32(2 ** 7 + 0.5)), m31)
    r1 = f32(r0 - f32(t1 - m31))
    t2 = _fadd_rd32(f32(r1 + f32(0.5)), m23)
    bits = [int(np.array(x, np.float32).view(np.int32)) for x in (t0, t1, t2, m39, m31, m23)]
    return bits[0] - bits[3], bits[1] - bits[4], bits[2] - bits[5]


def test_digit_ladder_by_round_down_adds_is_digits3():
    """x + 1.5 2^(23 + s) rounded down holds floor(x / 2^s) in its low bits:
    the redesign's ladder gives digits3's digits at the ends of its range,
    at halves, near the digit boundaries and at seeded values."""
    K = cuda_probes.K_I8
    rng = np.random.default_rng(26)
    edge = [0.0, -0.0, 1e-30, -1e-30, 0.5, -0.5, 127.5, -128.5, 32767.5, -32896.5, K, -K,
            65536.0 * 127 - 32896.5, 65536.0 * -128 + 32895.5]
    edge += [x + d for x in (65536.0 * k - 32896.5 for k in range(-127, 128, 17))
             for d in (-0.25, 0.0, 0.25)]
    values = np.array(edge + list(rng.uniform(-K, K, 1500)) + list(rng.normal(0, 300, 300)),
                      dtype=np.float32)
    d0, d1, d2 = cuda_probes.digits3(torch.from_numpy(values))
    for v, a, b, c in zip(values, d0.tolist(), d1.tolist(), d2.tolist()):
        assert _ladder_rd(v) == (a, b, c), v


def test_i8full_wavefronts():
    """The products' fragment loads take 2304 wavefronts a step in both
    designs (a uint4 of 512 contiguous bytes a warp: 4; a uint2: 2); the
    redesign's digit stores and copies take a quarter of the first design's
    four-byte digit stores less."""
    first = cuda_probes.i8full_wavefronts("first")
    new = cuda_probes.i8full_wavefronts("redesign")
    assert first["A"] == new["A"] == 8 * 36 * 4 and first["B"] == new["B"] == 8 * 72 * 2
    assert new["digits"] == 9 * 4 * 4  # one uint4 a plane a thread, conflict-free
    assert first["digits"] == 576 and new["ring"] == 256
    assert cuda_probes.smem_wavefronts([0] * 32, 4) == 1  # one word: a broadcast
    assert cuda_probes.smem_wavefronts([128 * i for i in range(32)], 4) == 32
    with pytest.raises(ValueError):
        cuda_probes.i8full_wavefronts("other")


def test_i8full_constants_match_the_source():
    src = _source("int8_probe_kernels.cu")
    assert _constexpr(src, "kFuDigitWarps") == cuda_probes.I8FULL_DIGIT_WARPS == 4
    assert _constexpr(src, "kFuMmaWarps") == cuda_probes.I8FULL_MMA_WARPS == 8
    assert _constexpr(src, "kFuStages") == cuda_probes.I8FULL_STAGES == 2
    assert _constexpr(src, "kFuBufs") == cuda_probes.I8FULL_BUFS == 2
    assert _constexpr(src, "kFuLoads") == cuda_probes.I8FULL_LOADS == 8
    assert _constexpr(src, "kFuPlanFields") == len(cuda_probes.I8FullPlan._fields)
    assert "__launch_bounds__(kFuThreads, 1)" in src
    assert cuda_probes.I8FULL_SMEM == 9 * 16384 + 2 * 9 * 2048 + 2 * 16384 + 2 * 16 * 4
    assert cuda_probes.I8FULL_SMEM <= MAX_SMEM
    # The ladder's magic sums and the named barriers' ids.
    for lit in ("0x1.8p39f", "0x1.8p31f", "0x1.8p23f"):
        assert src.count(lit) == 2 if lit != "0x1.8p23f" else src.count(lit) == 1
    assert _constexpr(src, "kBarFull") + 2 <= _constexpr(src, "kBarEmpty") \
        < _constexpr(src, "kBarEmpty") + 2 <= _constexpr(src, "kBarTables") <= 15


# -------------------------------------------------------------- frameonly


@pytest.mark.parametrize("pad", [256, 1024, 2048, 4096])
@pytest.mark.parametrize("nfft_of,hop,S,keep,rows,bt", [
    (1.0, "half", 137, 137, 1, 64), (0.75, 161, 301, 290, 2, 50), (1.0, 7, 70, 69, 1, 16),
    (0.5, 333, 29, 20, 3, 7)])
def test_frameonly_register_sums_match_the_plain_version(pad, nfft_of, hop, S, keep, rows, bt):
    """K4's frame order, each warp's slots by the butterfly, the warps in
    order: within n 2^-24 of the sum of |terms| of the float64 plain
    version (n: the tile's frames, the butterfly's and the groups' adds),
    at odd hops, pad > nfft, ragged tiles and masked segments."""
    nfft = int(pad * nfft_of)
    hop = nfft // 2 if hop == "half" else hop
    rng = np.random.default_rng(pad + S)
    L = (S - 1) * hop + nfft - 3
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    ext = f32(rng.uniform(-1, 1, size=(rows, L)))
    mask = f32((np.arange(S) < keep) * np.ones((rows, 1)))
    w = f32(rng.uniform(size=pad))
    got = cuda_probes.frameonly_regs_model(ext, mask, w, nfft, hop, pad, bt)
    want = cuda_probes.pwfloor_frameonly_plain(ext.double(), mask.double(), w.double(), nfft,
                                               hop, pad, bt)
    mag = cuda_probes.pwfloor_frameonly_plain(ext.double().abs(), mask.double(),
                                              w.double().abs(), nfft, hop, pad, bt)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert ((got.double() - want).abs() <= (bt + 16) * EPS32 * mag).all()


@pytest.mark.parametrize("pad", [2 ** k for k in range(1, 15)])
def test_frameonly_shared_memory_holds_every_group(pad):
    """K4's slots (the launch's shared memory) hold every group's pad floats
    of the sums: a warp each in the warp route, the one CTA in the block
    route; within one block's limit."""
    g = cuda_fft.geometry(pad // 2)
    for S, bt in ((1, 1), (16384, 16), (5001, 64), (3, 64), (52428, 50)):
        fpc, threads, slots = cuda_pwelch.partials_cta(pad, S, bt)
        groups = threads // 32 if g.warp else 1
        assert slots * pad >= groups * pad and slots * pad * 4 <= MAX_SMEM


def test_frameonly_constants_match_the_source():
    src = _source("pwelch_probe_kernels.cu")
    assert "frameonly_partials_kernel(Samples src, const float* __restrict__ mask" in src
    assert "__launch_bounds__(K4Plan<LOG2M>::kThreads, K4Plan<LOG2M>::kMinBlocks)\n" \
        "frameonly_partials_kernel(" in src  # K4's CTA and register cap
    assert "load_frame<LOG2M, false>(v, tl, x, nullptr, (s0 + j) * stride, src, nfft, w, live, " \
        "s);" in src
    assert "reinterpret_cast<float4*>(o)[u] = sum;" in src  # 16 bytes a thread
    assert "for (int g = 1; g < groups; ++g) {" in src  # the groups in order


# ------------------------------------------------------------- yardsticks


def test_i8full_yardstick_takes_its_plain_version_on_the_cpu():
    xr, xi = _planes(33, 256, 4)
    for name in ("i8full", "i8full_sync"):
        before = cuda_probes.launches[name]
        got = getattr(cuda_probes, name)(xr, xi)
        want = cuda_probes.i8full_plain(xr, xi)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert cuda_probes.launches[name] == before
        with pytest.raises(ValueError):
            getattr(cuda_probes, name)(xr[:, :200], xi[:, :200])
        with pytest.raises(TypeError):
            getattr(cuda_probes, name)(xr.double(), xi.double())


@pytest.mark.parametrize("name", ["pwfloor_frameonly", "pwfloor_frameonly_shared"])
def test_frameonly_wrappers_take_their_plain_version_on_the_cpu(name):
    rng = np.random.default_rng(7)
    ext = torch.from_numpy(rng.normal(size=(2, 29 * 160 + 1000)))
    mask = torch.from_numpy((np.arange(30) < 27) * np.ones((2, 1)))
    w = torch.from_numpy(rng.uniform(size=1024))
    before = cuda_probes.launches[name]
    got = getattr(cuda_probes, name)(ext, mask, w, 1000, 160, 1024, bt=4)
    assert torch.equal(got, cuda_probes.pwfloor_frameonly_plain(ext, mask, w, 1000, 160, 1024, 4))
    assert cuda_probes.launches[name] == before
    with pytest.raises(ValueError):
        getattr(cuda_probes, name)(ext, mask, w[:512], 1000, 160, 1024)
    with pytest.raises(ValueError):
        getattr(cuda_probes, name)(ext, mask[:1], w, 1000, 160, 1024)
    with pytest.raises(ValueError):
        getattr(cuda_probes, name)(ext, mask, w, 1000, 160, 1000)


# ------------------------------------------------------------ the probe

_I8_LISTING = """
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDS.128 R4, [R2] ;
        /*0020*/                   LDS.64 R8, [R3] ;
        /*0030*/                   IMMA.16832.S8.S8 R12, R4.ROW, R8.COL, R12 ;
        /*0040*/                   IMMA.16832.S8.S8 R16, R4.ROW, R8.COL, R16 ;
        /*0050*/                   FADD.RM R20, R21, R22 ;
        /*0060*/                   BAR.SYNC.DEFER_BLOCKING R0, R1 ;
        /*0070*/              @!P0 BRA 0x10 ;
        /*0080*/                   EXIT ;
"""


def test_probe_counts_a_recorded_listing():
    """The step loop a unit of 144 IMMA, as the probe's --sass reads it."""
    units, counts = anat_staged.loop_counts(_I8_LISTING, "IMMA", 2)
    assert units == 1 and counts["IMMA"] == 2 and counts["LDS"] == 2 and counts["FADD"] == 1
    assert counts["BAR"] == 1 and counts["total"] == 7
    assert [u for u, _, _ in i8full_frameonly._UNITS["13i8full_kernel"]] == ["IMMA", "LDGSTS"]


def test_probe_reads_ptxas():
    text = ("ptxas info    : Function properties for _ZN12_GLOBAL__N_113i8full_kernelEPKfS1_Pf\n"
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
            "ptxas info    : Used 160 registers, used 1 barriers\n"
            "ptxas info    : Function properties for _ZN12_GLOBAL__N_116frameonly_kernelEPKf\n"
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
            "ptxas info    : Used 24 registers, used 1 barriers\n")
    keys = [k for _, _, k, _, _ in i8full_frameonly._KERNELS]
    info = ptxas_info(text, keys)
    assert info == {"13i8full_kernel": (160, "0 bytes stack frame, 0 bytes spill stores, "
                                             "0 bytes spill loads"),
                    "16frameonly_kernel": (24, "0 bytes stack frame, 0 bytes spill stores, "
                                               "0 bytes spill loads")}


def test_probe_copies_find_their_lines():
    for _, src, _, _, edits, _ in i8full_frameonly.VARIANTS:
        variant_source(src, edits)


def test_probe_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        i8full_frameonly.main([])
