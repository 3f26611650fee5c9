"""Hand-written CUDA kernels for Hopper, each beside its plain torch version.

  cuda_fft     — K1 fft_pow2, K2 ifft_pow2, K3 rfft_pow2 (batched pow-2 FFT:
                 register-radix Stockham rows, K3 a packed half-length FFT)
  cuda_pwelch  — K4 pwelch_power_partials (fused frame->window->FFT->|.|^2->sum:
                 K3's packed half-length transform behind a framing load)
  cuda_csd     — K7 csd_power_partials (the same for two signals, conj(X)Y->sum)
  cuda_stft    — K5 stft_complex, stft_power, stft_mel (fused per-frame STFT:
                 K3's packed half-length transform behind a framing load)
  cuda_istft   — K6 istft_overlap_add (fused inverse FFT->window->overlap-add)
  cuda_outer   — K8 outer_dft_split (the giant-N FFT's outer levels + twiddles:
                 register-radix passes down a tile of columns)
                 and K9 peel_rows_fused_split (its last 128-point peel fused
                 with the row FFT, the route of fft.large.set_fuse_rows_enabled)
  cuda_halo    — K10 ring_halo (the sharded Welch's overlap halo, one launch a ring:
                 the blocks found from one pointer where they are views of one
                 signal, else through a pointer table), and ring_halo_table,
                 the table route alone, its yardstick
  cuda_fused_halo — K11 pwelch_power_partials_halo (K4 reading the right
                 neighbour shard's head past its block's end)
  cuda_metrics — K12 copy_split (the copy ceiling) and K13 gmm_floor (the
                 dense G-matmul step of a four-step FFT: 8 x 4 register
                 tiles on a persistent grid fed by a TMA ring), the bench's
                 yardsticks
  cuda_probes  — K14a pwfloor_loadonly / _frameonly / _noframe / _staged, the
                 fused-Welch floor twins (K4's body with one part changed),
                 driven by godsp_tpu_torch.probes.pwfloor; K14b fac_dft (K13's
                 function factored as 16 x 8) and K14c slicestore,
                 concatstore, gmm_concat (K12/K13 with other store
                 patterns), driven by probes.facdft and probes.store;
                 K14d half3, slice8_add, reshape_add, bd_tf32, bd_hi,
                 anat_full (shared-memory butterfly rounds, sliced and
                 reshaped adds, a TF32 and a 3xTF32 128-point DFT on the
                 tensor cores, the fused candidate), driven by
                 probes.anatomy2; K14h vdif (the slice network, the
                 twiddle and a warp-shuffle 128-point DIF) and K14i
                 sdif_peel (seven shared-memory radix-2 row stages of the
                 128-point peel), driven by probes.vdif and probes.sdif;
                 K14e lane_flip (a warp-shuffle lane reversal) and K14f
                 ls_network, gmm_tf32, ls_full (the TPU's lane-slice K1
                 taken apart: the slice network, K13's contraction in one
                 TF32 pass, and network + contraction in one kernel with
                 its store, chunk and rows-a-block settings) with
                 fft_pow2_rows (K1 at a given rows a block), driven by
                 probes.r4 and probes.r3; K14g i8_dot, i8mm, i8dec, i8full
                 and K14c's i8_concat (K13's function by exact int8 limbs
                 on the int8 tensor cores, with its raw MAC stream and its
                 digit ladder taken apart), driven by probes.int8 and
                 probes.store; fft_pow2_radix2, pwelch_radix2,
                 stft_radix2, istft_radix2, csd_radix2, outer_dft_radix2
                 and peel_rows_radix2, the first (radix-2) designs of K1,
                 K4, K5, K6, K7, K8 and K9, the yardsticks of their
                 redesigns, beside gmm_concat_stream, ls_full_stream,
                 i8_concat_stream, gmm_tf32_sync, i8_dot_bytes,
                 gmm_floor_sync, slice8_add_sync, slicestore_sync,
                 bd_hi_sync, bd_tf32_sync, anat_full_sync, vdif_sync,
                 pwfloor_staged_radix2, pwfloor_noframe_radix2,
                 sdif_peel_sync, i8full_sync and pwfloor_frameonly_shared,
                 the first designs of K14c, K14f, K14g's i8_dot and i8full,
                 K13, K14d, K14h, K14i and K14a's staged, noframe and
                 frameonly twins

Sources live in godsp_tpu_torch/csrc and build with nvcc at first use
(ops/_build.py).  launch_counts() reads every wrapper's count and
reset_launch_counts() zeroes them.
"""

from godsp_tpu_torch.ops import (
    cuda_csd,
    cuda_fft,
    cuda_fused_halo,
    cuda_halo,
    cuda_istft,
    cuda_metrics,
    cuda_outer,
    cuda_probes,
    cuda_pwelch,
    cuda_stft,
)
from godsp_tpu_torch.ops.cuda_csd import csd_power_partials, csd_power_sum
from godsp_tpu_torch.ops.cuda_fft import fft_pow2, ifft_pow2, rfft_pow2, supported_size
from godsp_tpu_torch.ops.cuda_fused_halo import pwelch_power_partials_halo
from godsp_tpu_torch.ops.cuda_halo import ring_halo
from godsp_tpu_torch.ops.cuda_istft import istft_overlap_add, istft_supported
from godsp_tpu_torch.ops.cuda_metrics import copy_split, gmm_floor
from godsp_tpu_torch.ops.cuda_outer import (
    outer_dft_split,
    outer_supported,
    peel_rows_fused_split,
    peel_rows_supported,
)
from godsp_tpu_torch.ops.cuda_probes import (
    anat_full,
    bd_hi,
    bd_tf32,
    concatstore,
    csd_radix2,
    fac_dft,
    fft_pow2_radix2,
    fft_pow2_rows,
    gmm_concat,
    gmm_tf32,
    half3,
    i8_concat,
    i8_dot,
    i8dec,
    i8full,
    i8mm,
    istft_radix2,
    lane_flip,
    ls_full,
    ls_network,
    outer_dft_radix2,
    peel_rows_radix2,
    pwelch_radix2,
    pwfloor_frameonly,
    pwfloor_loadonly,
    pwfloor_noframe,
    pwfloor_staged,
    reshape_add,
    sdif_peel,
    slice8_add,
    slicestore,
    stft_radix2,
    vdif,
)
from godsp_tpu_torch.ops.cuda_pwelch import (
    fused_supported,
    pwelch_power_partials,
    pwelch_power_sum,
)
from godsp_tpu_torch.ops.cuda_stft import stft_complex, stft_mel, stft_power

__all__ = [
    "anat_full",
    "bd_hi",
    "bd_tf32",
    "concatstore",
    "copy_split",
    "csd_power_partials",
    "csd_power_sum",
    "csd_radix2",
    "cuda_csd",
    "cuda_fft",
    "cuda_fused_halo",
    "cuda_halo",
    "cuda_istft",
    "cuda_metrics",
    "cuda_outer",
    "cuda_probes",
    "cuda_pwelch",
    "cuda_stft",
    "fac_dft",
    "fft_pow2",
    "fft_pow2_radix2",
    "fft_pow2_rows",
    "fused_supported",
    "gmm_concat",
    "gmm_floor",
    "gmm_tf32",
    "half3",
    "i8_concat",
    "i8_dot",
    "i8dec",
    "i8full",
    "i8mm",
    "istft_radix2",
    "ifft_pow2",
    "istft_overlap_add",
    "istft_supported",
    "lane_flip",
    "launch_counts",
    "ls_full",
    "ls_network",
    "outer_dft_radix2",
    "peel_rows_radix2",
    "outer_dft_split",
    "outer_supported",
    "peel_rows_fused_split",
    "peel_rows_supported",
    "pwelch_power_partials",
    "pwelch_power_partials_halo",
    "pwelch_power_sum",
    "pwelch_radix2",
    "pwfloor_frameonly",
    "pwfloor_loadonly",
    "pwfloor_noframe",
    "pwfloor_staged",
    "reset_launch_counts",
    "reshape_add",
    "rfft_pow2",
    "ring_halo",
    "sdif_peel",
    "slice8_add",
    "slicestore",
    "stft_complex",
    "stft_mel",
    "stft_power",
    "stft_radix2",
    "supported_size",
    "vdif",
]

_COUNTS = (
    cuda_fft.launches,
    cuda_pwelch.launches,
    cuda_csd.launches,
    cuda_stft.launches,
    cuda_istft.launches,
    cuda_outer.launches,
    cuda_halo.launches,
    cuda_fused_halo.launches,
    cuda_metrics.launches,
    cuda_probes.launches,
)


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {k: v for d in _COUNTS for k, v in d.items()}


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0."""
    for d in _COUNTS:
        for k in d:
            d[k] = 0
