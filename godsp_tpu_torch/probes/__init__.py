"""Hopper probes: scripts that take the port's kernels apart on the card.

  pwfloor — the fused-Welch floor twins of K4 (K14a, ops/cuda_probes.py):
            python3 -m godsp_tpu_torch.probes.pwfloor
"""
