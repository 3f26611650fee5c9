"""Hopper probes: scripts that take the port's kernels apart on the card.

  pwfloor — the fused-Welch floor twins of K4 (K14a, ops/cuda_probes.py):
            python3 -m godsp_tpu_torch.probes.pwfloor
  facdft  — K13's lane DFT factored as 16 x 8 (K14b) beside K13 and K12:
            python3 -m godsp_tpu_torch.probes.facdft
  store   — the store-pattern twins of K12 and K13 (K14c):
            python3 -m godsp_tpu_torch.probes.store
  anatomy2 — the data-movement and matrix-unit twins (K14d) beside K12
            and K1:
            python3 -m godsp_tpu_torch.probes.anatomy2
  vdif    — the 1024-point DFT as a slice network and a 128-point DIF by
            warp shuffles (K14h) beside K12, K14b and K1:
            python3 -m godsp_tpu_torch.probes.vdif
  sdif    — the 128-point peel of 2^24 as seven radix-2 row stages
            (K14i) beside K12 and K8:
            python3 -m godsp_tpu_torch.probes.sdif
  r3      — the TPU's lane-slice K1 taken apart (K14f: the slice network,
            K13's contraction in one TF32 pass, network + contraction in
            one kernel with its store, chunk and rows-a-block settings)
            beside K12, K14c, K13 and K1, then K1's rows-a-block sweep:
            python3 -m godsp_tpu_torch.probes.r3
  r4      — the lane flip by warp shuffles (K14e) and K3 beside K12, then
            K1 at 2048 x 8192 and 1024 x 16384:
            python3 -m godsp_tpu_torch.probes.r4
  contract — K13's contraction chain from shared memory alone at several
            register tiles (gmm_concat's and ls_full's among them), no
            device-memory traffic in the loop:
            python3 -m godsp_tpu_torch.probes.contract
  int8    — K13's function by the exact int8-limb contraction on the int8
            tensor cores (K14g: i8mm, i8dec, i8full, i8_concat, after
            i8_dot's exactness and i8full's dB against float64) beside K12
            and K13:
            python3 -m godsp_tpu_torch.probes.int8
  slice8  — K14d's slice8_add and its first design taken apart: the SASS,
            store width, blocks a SM and loads in flight of each and of
            variants of the first design, beside reshape_add, K12 and
            torch.add:
            python3 -m godsp_tpu_torch.probes.slice8
  bd_hi   — K14d's bd_hi and K14c's slicestore beside their first designs:
            ptxas, the first designs' SASS and variants, times beside
            torch.matmul, K12 and copy_, and bd_hi's chain of k-steps:
            python3 -m godsp_tpu_torch.probes.bd_hi
  bd1_vdif — K14d's bd_tf32 and K14h's vdif beside their first designs:
            ptxas, SASS counts a k-step, item or row, times beside the TF32
            torch.matmul, torch.fft.fft and K12, the first designs'
            variants and the redesigns' tuning copies:
            python3 -m godsp_tpu_torch.probes.bd1_vdif
  anat_staged — K14d's anat_full and K14a's pwfloor_staged beside their
            first designs: ptxas, SASS counts, times beside the unfused
            half3 + row + bd_hi route, K4 (at hop 512 and 160) and K12,
            the first designs' variants and anat_full's tuning copies:
            python3 -m godsp_tpu_torch.probes.anat_staged
  noframe_sdif — K14a's pwfloor_noframe and K14i's sdif_peel beside their
            first designs: ptxas, SASS counts a segment or tile, times
            beside K4 (on the samples and on the flattened frames, at hop
            512 and 160), the TMA route, K8 and K12, the first designs'
            variants and the redesigns' pricing copies:
            python3 -m godsp_tpu_torch.probes.noframe_sdif
  i8full_frameonly — K14g's i8full and K14a's pwfloor_frameonly beside
            their first designs: ptxas, SASS counts a step or segment, the
            fragment loads' wavefronts, times beside i8mm, i8_concat,
            torch.matmul, pwfloor_loadonly and K4 (at hop 512 and 160) and
            the first designs' variants:
            python3 -m godsp_tpu_torch.probes.i8full_frameonly
"""
