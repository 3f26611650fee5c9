"""K14d's anat_full and K14a's pwfloor_staged as redesigned for Hopper, on
the CPU: the host's mirrors of the two kernels' plans, their data flow
modelled in numpy, the constants of the CUDA sources, their shared memory,
the first designs kept as yardsticks and the probe's readers.  The kernels
themselves run in tests/test_torch_cuda.py, on the card."""

import itertools
import re

import numpy as np
import pytest
import torch

from godsp_tpu_torch.ops import _build, cuda_probes, cuda_pwelch
from godsp_tpu_torch.probes import anat_staged
from godsp_tpu_torch.probes.bd_hi import ptxas_info

MAX_SMEM = 232448  # bytes of shared memory one block may use (227 KB)


def _source(name: str) -> str:
    return (_build.CSRC / name).read_text()


def _constexpr(src: str, name: str) -> int:
    m = re.search(rf"constexpr (?:int|long long) {name} = (\d+);", src)
    assert m, name
    return int(m.group(1))


# ------------------------------------------------------------ anat_full


@pytest.mark.parametrize("b,n1,resident", itertools.product((1, 64, 1001, 16384),
                                                            (1, 3, 8, 16), (1, 7, 66)))
def test_anat_plan_hands_every_item_and_bin_half_to_one_cta(b, n1, resident):
    n = 128 * n1
    plan = cuda_probes.anat_full_plan(b, n, resident)
    assert plan.ctas == 2 * plan.pairs and plan.pairs == max(1, min(resident, -(-b // 64) * n1))
    assert (plan.k_stage, plan.boxes, plan.partner) == (32, 4, n // 2)
    assert (plan.stages, plan.smem) == (1, cuda_probes.ANAT_SMEM)
    seen = {}
    for p, items in enumerate(cuda_probes.bd_hi_walk(plan, b, n)):
        assert len(items) <= plan.per_pair
        for sl, tile in items:
            for h in (0, 1):  # CTA 2 p + h: bins 64 h .. 64 h + 63
                assert (tile, sl, h) not in seen
                seen[(tile, sl, h)] = 2 * p + h
    assert set(seen) == {(t, s, h) for t in range(-(-b // 64)) for s in range(n1) for h in (0, 1)}


@pytest.mark.parametrize("n1", [1, 2, 3, 8, 16, 128])
def test_anat_stages_pair_each_k_box_with_its_partner(n1):
    """Each stage's partner k-box is n / 2 columns on or back in the same
    row, wholly in the other half; an item's stages are its slice's k-boxes
    in turn."""
    n, b = 128 * n1, 130
    plan = cuda_probes.anat_full_plan(b, n, 3)
    k, per = plan.k_stage, 128 // plan.k_stage
    stages = cuda_probes.anat_full_stages(plan, b, n)
    for pair, items in zip(stages, cuda_probes.bd_hi_walk(plan, b, n)):
        assert len(pair) == per * len(items)
        for i, (sl, tile) in enumerate(items):
            for kb, (row, col, partner) in enumerate(pair[per * i: per * i + per]):
                assert (row, col) == (64 * tile, 128 * sl + k * kb)
                assert abs(partner - col) == n // 2 and 0 <= partner < n
                assert (partner < n // 2) != (col < n // 2)
                assert (partner + k - 1 < n // 2) == (partner < n // 2)  # one half
                assert partner % k == 0


@pytest.mark.parametrize("n1", [1, 3, 8, 16])
@pytest.mark.parametrize("k_box", [8, 16, 32])
def test_anat_box_model_equals_half3_and_the_row(n1, k_box):
    """A k-box and its partner n / 2 columns away, three rounds of u + v,
    u - v on each pair, the owned half, then a w - b w and a w + b w: the
    float32 plain version's values bit for bit (the A values anat_full
    feeds its products)."""
    n = 128 * n1
    rng = np.random.default_rng(n + k_box)
    xr, xi = (rng.normal(size=(9, n)).astype(np.float32) for _ in range(2))
    tw = rng.normal(size=n).astype(np.float32)
    ar, ai = cuda_probes.anat_a_model(xr, xi, tw, k_box)
    a, c = cuda_probes.half3_plain(torch.from_numpy(xr), torch.from_numpy(xi))
    t = torch.from_numpy(tw)
    assert np.array_equal(ar, (a * t - c * t).numpy())
    assert np.array_equal(ai, (a * t + c * t).numpy())


@pytest.mark.parametrize("k_box", [8, 16, 32])
def test_anat_box_offsets_are_the_tma_swizzle(k_box):
    """Every element of a 64-row box has its own word, each 16-byte unit
    stays whole, and at 32 columns the layout is the 128-byte swizzle
    bd_hi and gmm_tf32 read."""
    offs = [cuda_probes.anat_box_offset(r, k, k_box) for r in range(64) for k in range(k_box)]
    assert sorted(offs) == list(range(0, 64 * k_box * 4, 4))
    for r in range(64):
        for k in range(0, k_box, 4):
            base = cuda_probes.anat_box_offset(r, k, k_box)
            assert base % 16 == 0
            assert [cuda_probes.anat_box_offset(r, k + i, k_box) for i in range(4)] == \
                [base + 4 * i for i in range(4)]
    if k_box == 32:
        assert all(cuda_probes.anat_box_offset(r, k, 32) == cuda_probes.gmm_tf32_offset(r, k, 64)
                   for r in range(64) for k in range(32))


@pytest.mark.parametrize("kk", [0, 1, 2, 3])
def test_anat_fragment_reads_hit_32_banks(kk):
    """The four A values a lane reads at k-step kk of a 32-column box are
    wgmma's fragment (rows g, g + 8; columns 8 kk + t, + 4) and each of
    the four reads of a warp hits 32 distinct banks."""
    offs = cuda_probes.anat_fragment_offsets(kk)
    for j in range(4):
        assert len({o[j] // 4 % 32 for o in offs}) == 32
    for lane, o in enumerate(offs):
        g, t = divmod(lane, 4)
        want = [(g, 8 * kk + t), (g + 8, 8 * kk + t), (g, 8 * kk + t + 4), (g + 8, 8 * kk + t + 4)]
        assert o == [cuda_probes.anat_box_offset(r, c) for r, c in want]


@pytest.mark.parametrize("k_box", [8, 16, 32])
def test_anat_prepass_makes_every_element_once(k_box):
    """The CTA's 256 threads make each element of a 64-row box once, and at
    32 columns each warp's access at a step hits 32 distinct banks."""
    offs = cuda_probes.anat_prepass_offsets(k_box)
    flat = sorted(o for row in offs for o in row)
    assert flat == list(range(0, 64 * k_box * 4, 4))
    if k_box == 32:
        for w in range(8):
            for i in range(len(offs[0])):
                assert len({offs[32 * w + lane][i] // 4 % 32 for lane in range(32)}) == 32


def test_anat_constants_match_the_source():
    src = _source("anatomy_probe_kernels.cu")
    assert _constexpr(src, "kAnK") == cuda_probes.ANAT_K_STAGE
    assert _constexpr(src, "kHiRows") == cuda_probes.HI_ROWS
    assert _constexpr(src, "kHiBins") == cuda_probes.HI_BINS
    assert _constexpr(src, "kHiStages") == cuda_probes.HI_STAGES
    assert _constexpr(src, "kHiK") == cuda_probes.HI_K_STAGE
    assert _constexpr(src, "kHiChain") == cuda_probes.BD_HI_CHAIN
    assert "kBoxes = kFull ? 4 : 2" in src and cuda_probes.ANAT_BOXES == 4
    assert "threadIdx.x) / kAnK + kRowsAtOnce * i, k);" in src  # anat_prepass_offsets' map
    ring = cuda_probes.HI_STAGES * 2 * cuda_probes.HI_ROWS * cuda_probes.HI_K_STAGE * 4
    assert cuda_probes.ANAT_STAGES * 4 * 64 * cuda_probes.ANAT_K_STAGE * 4 == ring
    assert cuda_probes.ANAT_SMEM == 6 * 64 * 128 * 4 + ring + 12 * cuda_probes.ANAT_STAGES + 1024
    assert "kAnK == 32 ? CU_TENSOR_MAP_SWIZZLE_128B" in src


def test_anat_shared_memory_fits_a_block():
    assert cuda_probes.ANAT_SMEM <= MAX_SMEM
    assert cuda_probes.anat_full_plan(16384, 1024).smem == cuda_probes.ANAT_SMEM
    assert cuda_probes.ANAT_SMEM == cuda_probes.HI_SMEM - 12  # one mbarrier and count fewer


def test_anat_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        cuda_probes.anat_full_plan(4, 200)
    with pytest.raises(ValueError):
        cuda_probes.anat_full_plan(4, 2 * cuda_probes.MAX_STAGED_N)
    with pytest.raises(RuntimeError):
        cuda_probes.anat_full_plan(4, 256, 0)


@pytest.mark.parametrize("name", ["anat_full", "anat_full_sync"])
def test_anat_wrappers_take_their_plain_version_on_the_cpu(name):
    rng = np.random.default_rng(3)
    xr, xi = (torch.from_numpy(rng.normal(size=(5, 384)).astype(np.float32)) for _ in range(2))
    tw = torch.from_numpy(rng.normal(size=384).astype(np.float32))
    before = cuda_probes.launches[name]
    got = getattr(cuda_probes, name)(xr, xi, tw)
    want = cuda_probes.anat_full_plain(xr, xi, tw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert cuda_probes.launches[name] == before
    with pytest.raises(ValueError):
        getattr(cuda_probes, name)(xr[:, :200], xi[:, :200], tw[:200])
    with pytest.raises(ValueError):
        getattr(cuda_probes, name)(xr, xi, tw[:128])
    big = torch.zeros(1, 2 * cuda_probes.MAX_STAGED_N)
    with pytest.raises(ValueError):
        getattr(cuda_probes, name)(big, big, torch.zeros(big.shape[1]))


# ------------------------------------------------------- pwfloor_staged


def _stage_and_read(ext_row, offset, S, bt, nfft, stride, pad, w):
    """The staged CTAs' frames, (S, pad) windowed, as the kernel forms them:
    each tile's span built word by word from staged_span's plan (the
    16-byte units and the head and tail words; the rest left NaN), then
    each frame's pairs read from the span, zeros at or past min(nfft, L -
    a)."""
    L = ext_row.shape[0]
    cap = cuda_probes.staged_cta(pad, min(S, bt), nfft, stride)[3] // 4
    frames = np.zeros((S, pad))
    for t, (a0, a1, o, u0, u1) in enumerate(cuda_probes.staged_span(S, bt, nfft, stride, L,
                                                                    offset)):
        span = np.full(cap, np.nan)
        assert (offset + a0 + u0) % 4 == 0 and (u1 - u0) % 4 == 0
        assert o == (offset + a0) % 4 and u0 <= 3 and a1 - a0 - u1 <= 3 or u1 == u0
        span[o + u0: o + u1] = ext_row[a0 + u0: a0 + u1]  # the TMA copy
        for j in list(range(u0)) + list(range(u1, a1 - a0)):  # the threads' words
            span[o + j] = ext_row[a0 + j]
        for j in range(t * bt, min(S, (t + 1) * bt)):
            a = (j - t * bt) * stride
            lx = max(0, min(nfft, L - (a0 + a)))
            assert o + a + lx <= cap
            frames[j, :lx] = span[o + a: o + a + lx] * w[:lx]
    return frames


@pytest.mark.parametrize("nfft,stride,pad,S,L_short", [
    (1024, 512, 1024, 40, 0), (1024, 160, 1024, 61, 0), (1024, 161, 1024, 50, 7),
    (1000, 160, 1024, 33, 501), (50, 7, 64, 100, 3), (2, 1, 2, 17, 1)])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_staged_span_covers_every_frame(nfft, stride, pad, S, L_short, offset):
    """Every frame of every tile, at hops 512, 160 and 161, rows off a
    16-byte boundary, an odd L and a last frame past the samples, read
    from its tile's span equals the frame read from the row, zeros past
    L; the ragged last tile too."""
    rng = np.random.default_rng(S + stride)
    L = (S - 1) * stride + nfft - L_short
    ext = rng.normal(size=L)
    w = rng.uniform(size=pad)
    bt = 7  # a ragged last tile at every S here
    got = _stage_and_read(ext, offset, S, bt, nfft, stride, pad, w)
    want = np.zeros((S, pad))
    for s in range(S):
        seg = ext[s * stride: min(L, s * stride + nfft)]
        want[s, :seg.shape[0]] = seg * w[:seg.shape[0]]
    assert not np.isnan(got).any()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("pad", [2 ** k for k in range(1, 15)])
def test_staged_tiles_are_k4s_wherever_the_span_fits(pad):
    for nfft, stride in ((pad, max(1, pad // 2)), (max(1, pad - 3), max(1, pad // 7)), (pad, 1)):
        cap = cuda_probes.staged_max_bt(nfft, stride, pad)
        assert cap >= 1
        assert cuda_probes.staged_cta(pad, cap, nfft, stride)[3] <= MAX_SMEM
        slots = cuda_pwelch.partials_cta(pad, 1 << 30, 1 << 30)[2]
        if cuda_probes.staged_cta(pad, cap + 1, nfft, stride)[2] == slots:
            assert cuda_probes.staged_cta(pad, cap + 1, nfft, stride)[3] > MAX_SMEM
        for S, rows in ((1, 1), (100, 3), (16384, 1), (52428, 1), (10 ** 7, 1)):
            k4 = cuda_pwelch.segs_per_tile(S, rows)
            bt = cuda_probes.staged_segs_per_tile(S, rows, nfft, stride, pad)
            assert bt == min(k4, cap)
            if k4 <= cap:
                assert bt == k4


def test_staged_cta_is_k4s_cta_and_the_span():
    for pad, tile, nfft, stride in ((1024, 16, 1024, 512), (1024, 50, 1024, 160),
                                    (4096, 5, 4096, 1024), (64, 3, 50, 7)):
        fpc, threads, slots, smem = cuda_probes.staged_cta(pad, tile, nfft, stride)
        assert (fpc, threads, slots) == cuda_pwelch.partials_cta(pad, tile, tile)
        span = ((tile - 1) * stride + nfft + 3 + 3) // 4 * 4
        assert smem == 4 * (-(-2 * slots * (pad // 2) // 4) * 4 + span) + 16
    # The probe geometry's tile: eight 512-point slots and 8,704 samples.
    assert cuda_probes.staged_cta(1024, 16, 1024, 512) == (8, 256, 8, 67616)


def test_staged_constants_match_the_source():
    src = _source("pwelch_probe_kernels.cu")
    assert _constexpr(src, "kStagedMaxSmem") == MAX_SMEM == cuda_probes.MAX_SMEM
    # K4's register cap: the same launch bounds as pwelch_kernel.cu's Plan<LOG2M, false>.
    k4 = _source("pwelch_kernel.cu")
    cap = "LOG2M == 10 || LOG2M == 13 ? 1"
    assert cap in src and cap in k4
    assert "(LOG2M >= 4 && LOG2M <= 8) || LOG2M == 12 ? 2" in src
    assert "return (2LL * slots * m + 3) / 4 * 4;" in src
    assert "return ((bt - 1) * stride + nfft + 3 + 3) / 4 * 4;" in src


def test_staged_caps_both_designs():
    """The redesign's cap (slots, span, mbarrier) and the first design's
    (a pad-point buffer, its sums, the span) each fit a block."""
    for nfft, stride, pad in ((1024, 512, 1024), (1024, 160, 1024), (16384, 8192, 16384)):
        first = cuda_probes._staged_max_bt(nfft, stride, pad)
        assert 8 * pad + 4 * (pad // 2 + 1) + 4 * ((first - 1) * stride + nfft) <= MAX_SMEM
        new = cuda_probes.staged_max_bt(nfft, stride, pad)
        assert cuda_probes.staged_cta(pad, new, nfft, stride)[3] <= MAX_SMEM
    assert cuda_probes.staged_max_bt(1024, 512, 1024) == 96
    assert cuda_probes.staged_max_bt(16384, 8192, 16384) == 4


@pytest.mark.parametrize("name", ["pwfloor_staged", "pwfloor_staged_radix2"])
def test_staged_wrappers_take_their_plain_version_on_the_cpu(name):
    rng = np.random.default_rng(9)
    S, nfft, hop = 60, 128, 33
    ext = torch.from_numpy(rng.normal(size=(2, (S - 1) * hop + nfft)))
    mask = torch.from_numpy((np.arange(S) < 55) * np.ones((2, 1)))
    w = torch.from_numpy(rng.uniform(size=nfft))
    before = cuda_probes.launches[name]
    got = getattr(cuda_probes, name)(ext, mask, w, nfft, hop)
    assert torch.equal(got, cuda_pwelch.pwelch_power_partials(ext, mask, w, nfft, hop))
    assert cuda_probes.launches[name] == before
    with pytest.raises(ValueError):
        getattr(cuda_probes, name)(ext, mask, w, nfft, hop, pad=100)
    with pytest.raises(ValueError):
        getattr(cuda_probes, name)(ext, mask, w[:64], nfft, hop)
    with pytest.raises(ValueError):
        getattr(cuda_probes, name)(ext, mask, w, nfft, hop, bt=10 ** 6)


# ------------------------------------------------------------ the probe


_LISTING = """
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDS R2, [R3] ;
        /*0020*/                   HGMMA.64x32x8.F32.TF32 gdesc[UR4], RZ ;
        /*0030*/                   FADD R4, R4, R5 ;
        /*0040*/                   FADD R4, R4, R6 ;
        /*0050*/                   HGMMA.64x32x8.F32.TF32 gdesc[UR4], RZ ;
        /*0060*/              @!P0 BRA 0x10 ;
        /*0070*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0080*/                   BRA 0x0 ;
"""


def test_probe_loop_counts_read_a_listing():
    units, per = anat_staged.loop_counts(_LISTING, "HGMMA", 1)
    assert units == 2 and per["FADD"] == 1 and per["LDS"] == 0.5 and per["total"] == 3
    units, per = anat_staged.loop_counts(_LISTING, "HGMMA", 0, outer=True)
    assert units == 1 and per["BAR"] == 1 and per["total"] == 9
    units, per = anat_staged.loop_counts(_LISTING, "SHFL", 4)
    assert per["total"] == 9 / units


def test_probe_reads_ptxas():
    text = ("ptxas info    : Function properties for _ZN12_GLOBAL__N_116anat_full_kernelE\n"
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
            "ptxas info    : Used 210 registers, used 1 barriers\n")
    assert ptxas_info(text, ["16anat_full_kernel"]) == {
        "16anat_full_kernel": (210, "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
                                     "loads")}


def test_probe_copies_find_their_lines():
    from godsp_tpu_torch.probes.bd_hi import variant_source

    for _, src, _, _, edits in anat_staged.VARIANTS:
        variant_source(src, edits)
    for _, src, _, _, edits, _ in anat_staged.TUNE:
        variant_source(src, edits)


def test_probe_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        anat_staged.main([])


def test_unfused_route_is_anat_fulls_function_on_the_cpu():
    rng = np.random.default_rng(4)
    xr, xi = (torch.from_numpy(rng.normal(size=(3, 256))) for _ in range(2))
    tw = torch.from_numpy(rng.normal(size=256))
    got = anat_staged.unfused_route(xr, xi, tw)
    want = cuda_probes.anat_full_plain(xr, xi, tw)
    assert all(torch.allclose(g, w_, rtol=1e-12, atol=1e-12) for g, w_ in zip(got, want))
