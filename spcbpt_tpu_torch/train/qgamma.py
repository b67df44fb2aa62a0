"""Gamma -> CMF publication (Gamma2CMFGamma device_thrust.cu:3406-3433).

Port of `gamma_to_cmf` of spcbpt_tpu/train/qgamma.py, the one function of
that module the render path needs; Q estimation, sample reweighting and
Gamma initialisation belong to training, which is not ported yet.
"""
from __future__ import annotations

import torch

from ..config import CONSERVATIVE_RATE, NUM_SUBSPACE


def gamma_to_cmf(gamma: torch.Tensor) -> torch.Tensor:
    """Conservative 20% uniform mix, then row CMFs pinned to 1."""
    t = CONSERVATIVE_RATE
    g = gamma * (1.0 - t) + t / NUM_SUBSPACE
    cmf = torch.cumsum(g, dim=1)
    cmf[:, -1] = 1.0
    return cmf
