"""Light observables on the real-pair path (port of
``dwavehmc_tpu/models/observables_real.py``) for B chains at once."""

from __future__ import annotations

import torch

from ..ops.forces_real import pairing_correlations_real
from ..ops.spectral import softplus
from .lattice import LatticeSpec
from .observables import ObservablesResult
from .params import ModelParams, chain_view


def measure_observables_real(lat: LatticeSpec, params: ModelParams,
                             state) -> ObservablesResult:
    N = lat.n_sites
    beta, J = params.beta, params.J
    dre, dim = state.delta_re, state.delta_im

    abs_dx = torch.sqrt(dre[..., 0]**2 + dim[..., 0]**2)
    abs_dy = torch.sqrt(dre[..., 1]**2 + dim[..., 1]**2)
    amp = torch.mean(0.5 * (abs_dx + abs_dy), dim=-1)
    gre = dre[..., 0] - dre[..., 1]
    gim = dim[..., 0] - dim[..., 1]
    local = torch.mean(0.5 * torch.sqrt(gre**2 + gim**2), dim=-1)
    mre = torch.mean(0.5 * gre, dim=-1)
    mim = torch.mean(0.5 * gim, dim=-1)
    S = mre**2 + mim**2
    glob = torch.sqrt(S)

    E, X, Y = state.evals, state.X, state.Y
    # PH-even all-levels/2 forms: valid for an unsorted tracked spectrum
    w = (torch.sum(X[:, :N]**2 + Y[:, :N]**2, dim=-2)
         - torch.sum(X[:, N:]**2 + Y[:, N:]**2, dim=-2))
    hole = 0.5 * torch.sum(w * torch.tanh(0.5 * chain_view(beta, 2) * E),
                           dim=-1) / N

    x = chain_view(beta, 2) * torch.abs(E)
    fer = -0.5 * torch.sum(x + 2.0 * softplus(-x), dim=-1)
    bos = (beta / (2.0 * J)) * torch.sum(dre**2 + dim**2, dim=(-2, -1))
    energy = (fer + bos) / N

    P_re, P_im = pairing_correlations_real(lat, E, X, Y, beta)
    Jc = chain_view(J, 3)
    diff_re = dre - Jc * P_re
    diff_im = dim - Jc * P_im
    diff = torch.mean(0.5 * (torch.sqrt(diff_re[..., 0]**2
                                        + diff_im[..., 0]**2)
                             + torch.sqrt(diff_re[..., 1]**2
                                          + diff_im[..., 1]**2)), dim=-1)
    Jv = chain_view(J, 2)
    tre = Jv * 0.5 * (P_re[..., 0] - P_re[..., 1])
    tim = Jv * 0.5 * (P_im[..., 0] - P_im[..., 1])
    pair = torch.sqrt(torch.mean(tre, dim=-1)**2 + torch.mean(tim, dim=-1)**2)
    localpair = torch.mean(torch.sqrt(tre**2 + tim**2), dim=-1)

    return ObservablesResult(
        total_energy=energy, delta_amp=amp, delta_local=local,
        delta_global=glob, S_delta=S, hole_conc=hole,
        delta_diff=diff, delta_pair=pair, delta_localpair=localpair)
