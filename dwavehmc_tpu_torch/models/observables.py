"""The per-sweep light observables' record (port of ``ObservablesResult``
from ``dwavehmc_tpu/models/observables.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class ObservablesResult(NamedTuple):
    """Field-for-field match of the reference struct; each field (B,)."""

    total_energy: torch.Tensor   # (E_fermion + E_boson)/N
    delta_amp: torch.Tensor      # ⟨(|Δx|+|Δy|)/2⟩
    delta_local: torch.Tensor    # ⟨|Δx−Δy|/2⟩
    delta_global: torch.Tensor   # |⟨(Δx−Δy)/2⟩|
    S_delta: torch.Tensor        # |⟨(Δx−Δy)/2⟩|²  (structure factor)
    hole_conc: torch.Tensor      # (1/N)Σ_{E>0}[Σ_i(|u|²−|v|²)]·tanh(βE/2)
    delta_diff: torch.Tensor     # ⟨|Δ − J·P|⟩  (self-consistency residual)
    delta_pair: torch.Tensor     # |⟨J(Px−Py)/2⟩|
    delta_localpair: torch.Tensor  # ⟨|J(Px−Py)/2|⟩
