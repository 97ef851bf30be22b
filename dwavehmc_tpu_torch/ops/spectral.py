"""Spectral primitives and the HMC energy (port of
``dwavehmc_tpu/ops/spectral.py``), per chain over a leading chain dimension.

Particle–hole symmetry (eigenvalues in ±E pairs) lets the fermion term be
summed over the positive levels only:

    E_fermion = − Σ_{E>0} [ βE + 2·log1pexp(−βE) ]
"""

from __future__ import annotations

import torch

from ..models.params import chain_view


def fermi_factors(evals: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """f(E) = 1/(1+e^{βE}) = logistic(−βE) for ``evals`` (B, n)."""
    return torch.sigmoid(-chain_view(beta, evals.ndim) * evals)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + eˣ) as ``jax.nn.softplus`` defines it (``logaddexp(x, 0)``),
    with no threshold switch."""
    return torch.logaddexp(x, torch.zeros_like(x))


def fermion_energy(evals, beta):
    """−Σ_{E>0}(βE + 2·softplus(−βE)) per chain; ``evals`` (B, 2N)."""
    x = chain_view(beta, 2) * evals
    contrib = x + 2.0 * softplus(-x)
    return -torch.sum(torch.where(evals > 0, contrib,
                                  torch.zeros_like(contrib)), dim=-1)


def boson_energy(delta, beta, J):
    """β/(2J) · Σ_bonds |Δ|² per chain; ``delta`` (B, N, 2) complex."""
    return (beta / (2.0 * J)) * torch.sum(torch.abs(delta) ** 2, dim=(-2, -1))


def kinetic_energy(pi, mass):
    """Σ |π|² / (2m) per chain."""
    return torch.sum(torch.abs(pi) ** 2, dim=(-2, -1)) / (2.0 * mass)


def total_energy(delta, pi, evals, beta, J, mass):
    """H_HMC = kinetic + boson + fermion, per chain."""
    return (kinetic_energy(pi, mass) + boson_energy(delta, beta, J)
            + fermion_energy(evals, beta))


def energy_difference(delta_n, pi_n, evals_n, delta_o, pi_o, evals_o,
                      beta, J, mass):
    """ΔH = H(new) − H(old) per chain, evaluated term by term as
    differences.

    The fermionic totals are O(β·N·|E|) while the per-level differences
    β(E_new − E_old) stay O(β·δE), so subtracting two totals would cancel
    catastrophically in float32 at large β.  g(βE) = βE + 2·softplus(−βE)
    is even in E, so the Σ_{E>0} restriction is the upper half of each
    sorted spectrum (both come from ``eigh``, ascending)."""
    d_kin = torch.sum(torch.abs(pi_n) ** 2 - torch.abs(pi_o) ** 2,
                      dim=(-2, -1)) / (2.0 * mass)
    d_bos = (beta / (2.0 * J)) * torch.sum(
        torch.abs(delta_n) ** 2 - torch.abs(delta_o) ** 2, dim=(-2, -1))
    half = evals_n.shape[-1] // 2
    En = torch.abs(evals_n[..., half:])
    Eo = torch.abs(evals_o[..., half:])
    b2 = chain_view(beta, 2)
    lin = beta * torch.sum(En - Eo, dim=-1)
    soft = 2.0 * torch.sum(softplus(-b2 * En) - softplus(-b2 * Eo), dim=-1)
    return d_kin + d_bos - (lin + soft)
