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
"""
