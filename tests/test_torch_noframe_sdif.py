"""K14a's pwfloor_noframe and K14i's sdif_peel as redesigned for Hopper, on
the CPU: the plain versions the kernels are held to, the register data flow
and the twiddle of sdif_peel modelled in torch and numpy, the frame load of
pwfloor_noframe lane by lane, the sdif plan, the constants and shared
memory of the CUDA sources, the first designs kept as yardsticks and the
probe's readers.  The kernels themselves run in tests/test_torch_cuda.py,
on the card."""

import re

import numpy as np
import pytest
import torch

from godsp_tpu_torch.ops import _build, cuda_fft, cuda_probes, cuda_pwelch
from godsp_tpu_torch.probes import anat_staged, noframe_sdif
from godsp_tpu_torch.probes.bd_hi import ptxas_info, variant_source

MAX_SMEM = 232448  # bytes of shared memory one block may use (227 KB)
TB_BOUND = 4e-7  # |Tb - W_N^{k t}|: three float32 table entries and two rounded products


def _source(name: str) -> str:
    return (_build.CSRC / name).read_text()


def _constexpr(src: str, name: str):
    m = re.search(rf"constexpr (?:int|bool) {name} = (\w+);", src)
    assert m, name
    return int(m.group(1)) if m.group(1).isdigit() else m.group(1) == "true"


# ------------------------------------------------------- pwfloor_noframe


@pytest.mark.parametrize("pad", [256, 1024, 2048, 4096])
@pytest.mark.parametrize("S,keep,rows", [(37, 37, 1), (101, 95, 2)])
def test_noframe_plain_is_k4s_on_the_flattened_frames(pad, S, keep, rows):
    """Frames (..., S, pad) are a signal of S pad samples framed at nfft =
    stride = pad: the two plain versions agree bit for bit, at a ragged
    last tile and with masked segments."""
    rng = np.random.default_rng(pad + S)
    frames = torch.from_numpy(rng.normal(size=(rows, S, pad)))
    mask = torch.from_numpy((np.arange(S) < keep) * np.ones((rows, 1)))
    w = torch.from_numpy(rng.uniform(size=pad))
    for bt in (7, cuda_pwelch.segs_per_tile(S, rows)):
        got = cuda_probes.pwfloor_noframe_plain(frames, mask, w, bt)
        want = cuda_pwelch.pwelch_power_partials_plain(frames.reshape(rows, S * pad), mask, w,
                                                       pad, pad, pad, bt)
        assert torch.equal(got, want)


@pytest.mark.parametrize("pad", [2 ** k for k in range(1, 15)])
def test_noframe_load_hands_each_lane_its_pairs(pad):
    """The 16-byte loads and their even/odd exchange leave pair t + r T in
    lane t's register r (the transform's first-pass layout); each load of
    a frame's T lanes reads 16 T contiguous bytes, each unit once."""
    g = cuda_fft.geometry(pad // 2)
    units, pairs = cuda_probes.noframe_load_map(pad)
    want = np.arange(g.threads)[:, None] + g.threads * np.arange(g.points)[None, :]
    assert np.array_equal(pairs, want)
    if g.points > 1:
        for u in range(g.points // 2):
            lo = u * g.threads if g.threads > 1 else u
            assert sorted(units[:, u]) == list(range(lo, lo + g.threads))
        assert sorted(units.reshape(-1)) == list(range(pad // 4))


def test_noframe_constants_match_the_source():
    src = _source("pwelch_probe_kernels.cu")
    assert _constexpr(src, "kNoframeVec") == cuda_probes.NOFRAME_VEC == 16
    assert "const int unit = (t >> 1) + (odd ? R::kT / 2 : 0);" in src  # noframe_load_map's
    assert "q[u] = live ? __ldg(&x4[u * R::kT + unit])" in src
    # K4's CTA and register cap: the bounds of pwelch_kernel.cu's Plan<LOG2M, false>.
    assert "noframe_partials_kernel(const float* __restrict__ frames" in src
    for kernel in ("staged_partials_kernel(", "noframe_partials_kernel("):
        assert f"__launch_bounds__(K4Plan<LOG2M>::kThreads, K4Plan<LOG2M>::kMinBlocks)\n{kernel}" \
            in src, kernel


@pytest.mark.parametrize("pad", [2 ** k for k in range(1, 15)])
def test_noframe_shared_memory_is_k4s(pad):
    """K4's slots at K4's CTA for every tile: within one block's limit."""
    for S, bt in ((1, 1), (16384, 16), (5001, 64), (3, 64)):
        fpc, threads, slots = cuda_pwelch.partials_cta(pad, S, bt)
        assert slots * (pad // 2) * 8 <= MAX_SMEM
        assert threads <= 1024


@pytest.mark.parametrize("name", ["pwfloor_noframe", "pwfloor_noframe_radix2"])
def test_noframe_wrappers_take_their_plain_version_on_the_cpu(name):
    rng = np.random.default_rng(5)
    frames = torch.from_numpy(rng.normal(size=(2, 30, 64)))
    mask = torch.from_numpy((np.arange(30) < 27) * np.ones((2, 1)))
    w = torch.from_numpy(rng.uniform(size=64))
    before = cuda_probes.launches[name]
    got = getattr(cuda_probes, name)(frames, mask, w, bt=4)
    assert torch.equal(got, cuda_probes.pwfloor_noframe_plain(frames, mask, w, 4))
    assert cuda_probes.launches[name] == before
    with pytest.raises(ValueError):
        getattr(cuda_probes, name)(frames[..., :48], mask, w[:48])
    with pytest.raises(ValueError):
        getattr(cuda_probes, name)(frames, mask[:, :20], w)
    with pytest.raises(ValueError):
        getattr(cuda_probes, name)(frames, mask, w[:32])


# ------------------------------------------------------------- sdif_peel


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(1, 128, 33), (3, 128, 1000), (2, 2, 128, 5), (128, 1)])
def test_sdif_register_model_is_the_plain_stages(dtype, shape):
    """Rows j + 8 q for the stages at h = 64..8, one exchange, rows 16 j +
    e for h = 4..1: the plain version's stages bit for bit."""
    rng = np.random.default_rng(shape[-1])
    xr, xi = (torch.from_numpy(rng.normal(size=shape).astype(dtype)) for _ in range(2))
    got = cuda_probes.sdif_regs_model(xr, xi)
    want = cuda_probes.sdif_stages_plain(xr, xi)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_sdif_plain_is_its_stages_then_tb():
    rng = np.random.default_rng(8)
    xr, xi = (torch.from_numpy(rng.normal(size=(2, 128, 40))) for _ in range(2))
    sr, si = cuda_probes.sdif_stages_plain(xr, xi)
    k = cuda_probes.brev7_perm().numpy()[:, None]
    tb = np.exp(-2j * np.pi * (k * np.arange(40)[None, :]) / (128 * 40))
    got = cuda_probes.sdif_peel_plain(xr, xi)
    want = (sr.numpy() + 1j * si.numpy()) * tb
    assert np.allclose(got[0].numpy() + 1j * got[1].numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("m", [1, 33, 1000, 131072])
def test_sdif_tile_tb_is_float64s_within_its_bound(m):
    """W_N^{k c0} from K8's hi and lo times the tile table's W_N^{k cc},
    each product rounded to float32: within TB_BOUND of W_N^{k t} (every
    column up to m = 1000; at 2^17 the first and last tiles and 256
    seeded columns)."""
    cols = None if m <= 1000 else np.r_[0:64, m - 64:m,
                                        np.random.default_rng(m).integers(0, m, 256)]
    tb = cuda_probes.sdif_tb_model(m, cols)
    t = np.arange(m) if cols is None else cols
    k = cuda_probes.brev7_perm().numpy()[:, None]
    want = np.exp(-2j * np.pi * ((k * t[None, :]) % (128 * m)) / (128 * m))
    assert tb.dtype == np.complex64 and tb.shape == (128, len(t))
    assert np.abs(tb - want).max() <= TB_BOUND


@pytest.mark.parametrize("m", [1, 31, 32, 33, 1000, 131072])
@pytest.mark.parametrize("batch", [0, 1, 3])
def test_sdif_plan_covers_every_column_once(m, batch):
    plan = cuda_probes.sdif_plan(m, batch)
    assert plan == (256, 32, -(-m // 32), 32768)
    walk = cuda_probes.sdif_walk(plan, m, batch)
    seen = [(b, c) for (b, _), cols in walk.items() for c in cols]
    assert sorted(seen) == [(b, c) for b in range(batch) for c in range(m)]
    for (b, t), cols in walk.items():
        assert cols == list(range(32 * t, min(m, 32 * t + 32)))  # the last tile ragged


def test_sdif_plan_refuses_bad_shapes():
    with pytest.raises(ValueError):
        cuda_probes.sdif_plan(0, 1)
    with pytest.raises(ValueError):
        cuda_probes.sdif_plan(5, -1)


def test_sdif_constants_match_the_source():
    src = _source("dif_probe_kernels.cu")
    assert _constexpr(src, "kPeel") == cuda_probes.PEEL_ROWS == 128
    assert _constexpr(src, "kCols") == cuda_probes.SDIF_COLS == 32
    assert _constexpr(src, "kSdRows") == cuda_probes.SDIF_ROWS == 16
    assert "constexpr int kSdGroups = kPeel / kSdRows;" in src
    assert "constexpr int kSdThreads = kCols * kSdGroups;" in src
    assert _constexpr(src, "kSdifTileTable") is True
    assert "__shared__ float er[kPeel][kCols];" in src
    assert "__shared__ float ei[kPeel][kCols];" in src
    plan = cuda_probes.sdif_plan(131072, 1)
    assert plan.threads == 32 * 128 // 16 and plan.smem == 2 * 128 * 32 * 4 <= MAX_SMEM
    # Tb from K8's tile table (k C + cc) and its factored hi and lo.
    assert "__ldg(&tt[k * kCols + c])" in src
    assert "rev_bits(e, 4) << 3) + kj;  // brev7(16 j + e)" in src


@pytest.mark.parametrize("name", ["sdif_peel", "sdif_peel_sync"])
def test_sdif_wrappers_take_their_plain_version_on_the_cpu(name):
    rng = np.random.default_rng(6)
    xr, xi = (torch.from_numpy(rng.normal(size=(2, 128, 9)).astype(np.float32)) for _ in range(2))
    before = cuda_probes.launches[name]
    got = getattr(cuda_probes, name)(xr, xi)
    want = cuda_probes.sdif_peel_plain(xr, xi)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert cuda_probes.launches[name] == before
    with pytest.raises(ValueError):
        getattr(cuda_probes, name)(xr[:, :64], xi[:, :64])
    with pytest.raises(ValueError):
        getattr(cuda_probes, name)(xr, xi[..., :5])


# ------------------------------------------------------------ the probe

_NOFRAME_LISTING = """
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;
        /*0020*/                   SHFL.BFLY PT, R8, R6, 0x1, 0x1f ;
        /*0030*/                   FFMA R9, R4, R5, R8 ;
        /*0040*/                   FFMA R9, R4, R5, R9 ;
        /*0050*/                   STS [R3], R9 ;
        /*0060*/                   LDS R9, [R3] ;
        /*0070*/              @!P0 BRA 0x10 ;
        /*0080*/                   EXIT ;
"""


def test_probe_counts_a_recorded_listing():
    """noframe's frame loop (one pass a segment a warp) and a whole listing,
    as the probe's --sass reads them."""
    opcode, per, _, _, _ = noframe_sdif._UNITS["23noframe_partials_kernelILi9E"]
    units, counts = anat_staged.loop_counts(_NOFRAME_LISTING, opcode, per)
    assert units == 1 and counts["LDG"] == 1 and counts["SHFL"] == 1 and counts["FFMA"] == 2
    assert counts["total"] == 7
    units, whole = anat_staged.loop_counts(_NOFRAME_LISTING, "NO_SUCH_OPCODE", 1)
    assert units == 1 and whole["total"] == 9


def test_probe_reads_ptxas():
    text = ("ptxas info    : Function properties for _ZN12_GLOBAL__N_116sdif_peel_kernelEPKfS1_\n"
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
            "ptxas info    : Used 72 registers, used 1 barriers\n"
            "ptxas info    : Function properties for _ZN12_GLOBAL__N_121sdif_peel_sync_kernelE\n"
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
            "ptxas info    : Used 40 registers, used 1 barriers\n")
    keys = [k for _, _, k, _, _ in noframe_sdif._KERNELS]
    info = ptxas_info(text, keys)
    assert info["16sdif_peel_kernel"][0] == 72 and info["21sdif_peel_sync_kernel"][0] == 40
    assert set(info) == {"16sdif_peel_kernel", "21sdif_peel_sync_kernel"}


def test_probe_copies_find_their_lines():
    for _, src, _, _, edits, _ in noframe_sdif.VARIANTS:
        variant_source(src, edits)


def test_probe_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        noframe_sdif.main([])
