"""Per-sweep light observables (port of
``dwavehmc_tpu/models/observables.py``): the nine scalars written to
observables.csv every sweep, as masked reductions over a leading chain
dimension.  ``measure_observables`` is the complex path's;
``observables_real.measure_observables_real`` is its real-pair
counterpart."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.forces import pairing_correlations
from ..ops.spectral import boson_energy, fermion_energy
from .lattice import LatticeSpec
from .params import HMCState, ModelParams, chain_view


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


def measure_observables(lat: LatticeSpec, params: ModelParams,
                        state: HMCState) -> ObservablesResult:
    N = lat.n_sites
    beta, J = params.beta, params.J
    delta = state.delta
    dx, dy = delta[..., 0], delta[..., 1]                      # (B, N)

    amp = torch.mean(0.5 * (torch.abs(dx) + torch.abs(dy)), dim=-1)
    local = torch.mean(0.5 * torch.abs(dx - dy), dim=-1)
    global_mean = torch.mean(0.5 * (dx - dy), dim=-1)
    glob = torch.abs(global_mean)
    S = torch.abs(global_mean) ** 2

    U, E = state.evecs, state.evals
    w = (torch.sum(torch.abs(U[:, :N]) ** 2, dim=-2)
         - torch.sum(torch.abs(U[:, N:]) ** 2, dim=-2))
    val = w * torch.tanh(0.5 * chain_view(beta, 2) * E)
    hole = torch.sum(torch.where(E > 0, val, torch.zeros_like(val)),
                     dim=-1) / N

    energy = (fermion_energy(E, beta) + boson_energy(delta, beta, J)) / N

    P = pairing_correlations(lat, E, U, beta)
    Jv = chain_view(J, 2)
    diff = torch.mean(0.5 * (torch.abs(dx - Jv * P[..., 0])
                             + torch.abs(dy - Jv * P[..., 1])), dim=-1)
    pair_terms = Jv * 0.5 * (P[..., 0] - P[..., 1])
    pair = torch.abs(torch.mean(pair_terms, dim=-1))
    localpair = torch.mean(torch.abs(pair_terms), dim=-1)

    return ObservablesResult(
        total_energy=energy, delta_amp=amp, delta_local=local,
        delta_global=glob, S_delta=S, hole_conc=hole,
        delta_diff=diff, delta_pair=pair, delta_localpair=localpair)
