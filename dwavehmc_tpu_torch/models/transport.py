"""Transport math shared by the measurement paths (port of the parts of
``dwavehmc_tpu/models/transport.py`` that the real-pair path uses).

The σ(ω)/DC double sum over eigenpairs, ~1.9e9 Lorentzians per chain at
24×24, goes through kernel K2 (``ops/kernels.weighted_lorentzian_sum``): on
CUDA tensors the hand-written kernel, in float32 as the TPU kernel runs; on
CPU tensors its ω-chunked plain version, in the working dtype.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.kernels import lorentzian, weighted_lorentzian_sum
from .lattice import LatticeSpec, neighbor_tables
from .params import chain_view

__all__ = ["DEGENERATE_EPS", "SpectrumResult", "current_patterns",
           "dc_conductivity", "lorentzian", "optical_conductivity",
           "paramagnetic_term"]

#: pairs with |E_m − E_n| below this use the degenerate limit β·f·(1−f)
DEGENERATE_EPS = 1e-8


class SpectrumResult(NamedTuple):
    """Heavy-measurement outputs, each with a leading chain dimension."""

    superfluid_stiffness: torch.Tensor   # ρ_s = ⟨−Kx⟩ − Λ_xx
    dc_conductivity: torch.Tensor
    optical_conductivity: torch.Tensor   # Re σ(ω) on spec.omega_grid()
    dos: torch.Tensor                    # N(ω) on spec.dos_grid()
    dos_AN: torch.Tensor                 # antinodal-projected DOS
    A_k0: torch.Tensor                   # (Lx, Ly) Fermi-surface map


@functools.lru_cache(maxsize=None)
def current_patterns(lat: LatticeSpec) -> tuple[np.ndarray, np.ndarray]:
    """Antisymmetric ±1 bond patterns for the x-current operator:
    Jx_particle = i·t·B_nn + i·t'·(B_+x+y + B_+x−y), B[i, j] = +1,
    B[j, i] = −1 per directed bond.  Dense (N, N) numpy constants."""
    nn, nnn = neighbor_tables(lat)
    N = lat.n_sites
    i = np.arange(N)

    def anti(jmap):
        B = np.zeros((N, N), dtype=np.float64)
        np.add.at(B, (i, jmap), 1.0)
        np.add.at(B, (jmap, i), -1.0)
        return B

    return anti(nn[:, 0]), anti(nnn[:, 0]) + anti(nnn[:, 3])


def _pair_differences(evals):
    """dE[b, n, m] = E_m − E_n."""
    return evals[:, None, :] - evals[:, :, None]


def paramagnetic_term(evals, f, J2, beta, n_sites):
    """Λ_xx = (1/N) Σ_nm ratio(n,m)·|J_nm|², ratio = (f_n−f_m)/(E_m−E_n)
    with the degenerate limit β·f·(1−f)."""
    dE = _pair_differences(evals)
    df = f[:, :, None] - f[:, None, :]              # f_n − f_m
    small = torch.abs(dE) < DEGENERATE_EPS
    degenerate = (chain_view(beta, 2) * f * (1.0 - f))[:, :, None].expand_as(dE)
    ratio = torch.where(small, degenerate,
                        df / torch.where(small, torch.ones_like(dE), dE))
    return torch.sum(ratio * J2, dim=(-2, -1)) / n_sites


def dc_conductivity(evals, f, J2, beta, eta: float, n_sites):
    """σ_DC = (π/N) Σ_nm β f_n(1−f_n)·|J_nm|²·L(E_m−E_n; η), via K2 at the
    single frequency ω = 0."""
    B = evals.shape[0]
    dE = _pair_differences(evals).reshape(B, -1)
    w = (chain_view(beta, 2) * f * (1.0 - f))[:, :, None]
    w2 = (w * J2).reshape(B, -1)
    omega = torch.zeros((B, 1), dtype=evals.dtype, device=evals.device)
    s = weighted_lorentzian_sum(omega, -dE, w2, eta)
    return (math.pi / n_sites) * s[:, 0].to(evals.dtype)


def optical_conductivity(omega_grid, evals, f, J2, eta: float, n_sites):
    """Re σ(ω) = (π/N) Σ_nm (f_n−f_m)/ω·|J_nm|²·L(ω−ΔE; η) on the positive
    grid ``omega_grid`` (n_ω,), via K2."""
    B = evals.shape[0]
    dE = _pair_differences(evals).reshape(B, -1)
    W2 = ((f[:, :, None] - f[:, None, :]) * J2).reshape(B, -1)
    s = weighted_lorentzian_sum(omega_grid.expand(B, -1), dE, W2, eta)
    return (math.pi / n_sites) * (s.to(evals.dtype) / omega_grid)
