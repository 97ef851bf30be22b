"""Sweep record and step-size heuristic (port of the parts of
``dwavehmc_tpu/sampler/hmc.py`` that the real-pair path uses)."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class SweepInfo(NamedTuple):
    accepted: torch.Tensor   # (B,) bool
    dH: torch.Tensor         # (B,) energy change of the proposed trajectory
    H_old: torch.Tensor
    H_new: torch.Tensor


def calc_optimal_dt(beta: float, J: float, mass: float, Nt: int) -> float:
    """Harmonic-oscillator step-size heuristic: dt = 2π√(mJ/β)/(2Nt).
    Host-side, python floats."""
    period = 2.0 * math.pi * math.sqrt(mass * J / beta)
    return period / (2 * Nt)
