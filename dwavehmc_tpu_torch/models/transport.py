"""Transport and spectral measurements (port of
``dwavehmc_tpu/models/transport.py``): the math both paths share, and the
complex path's heavy measurement ``measure_transport_and_spectra``, over a
leading chain dimension.

The σ(ω)/DC double sum over eigenpairs, ~1.9e9 Lorentzians per chain at
24×24, goes through kernel K2 (``ops/kernels.weighted_lorentzian_sum``): on
CUDA tensors the hand-written kernel, in float32 as the TPU kernel runs; on
CPU tensors its ω-chunked plain version, in the working dtype.  The current
matrix elements J_mn = U†(Jx U) are complex matmuls, as in the JAX package,
where they run outside any Pallas kernel.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.kernels import lorentzian, weighted_lorentzian_sum
from ..ops.spectral import fermi_factors
from .lattice import LatticeSpec, antinodal_phases, neighbor_tables
from .params import HMCState, ModelParams, SpectralSpec, chain_view

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


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def current_operator_particle(lat: LatticeSpec, t, tp) -> torch.Tensor:
    """Particle block of Jx, i·(t·B_nn + t′·B_nnn): (N, N) complex, or
    (B, N, N) for per-chain t/t′ (the Nambu operator is two copies on the
    block diagonal)."""
    B_nn, B_nnn = (_const(a, t) for a in current_patterns(lat))
    K = chain_view(t, 3) * B_nn + chain_view(tp, 3) * B_nnn
    return torch.complex(torch.zeros_like(K), K)


def current_matrix_elements(lat: LatticeSpec, evecs, t, tp) -> torch.Tensor:
    """J_mn = U†(Jx U), (B, 2N, 2N): two (N, N)@(N, 2N) products for the
    block-diagonal Jx, then one (2N, 2N)@(2N, 2N)."""
    N = lat.n_sites
    Jp = current_operator_particle(lat, t, tp).to(evecs.dtype)
    JU = torch.cat([Jp @ evecs[:, :N], Jp @ evecs[:, N:]], dim=-2)
    return evecs.conj().mT @ JU


def diamagnetic_term(lat: LatticeSpec, evals, evecs, t, tp, beta):
    """⟨−Kx⟩ = Σ_{E>0} w_n tanh(βE/2)/N with eigenvector-weighted NN and NNN
    x-bond sums."""
    N = lat.n_sites
    nn, nnn = (torch.as_tensor(a, dtype=torch.long, device=evecs.device)
               for a in neighbor_tables(lat))
    Ut, Ub = evecs[:, :N], evecs[:, N:]

    def bond_weight(jmap):
        a = (Ub * Ub[:, jmap].conj()).sum(-2)
        b = (Ut.conj() * Ut[:, jmap]).sum(-2)
        return 2.0 * (a - b).real

    t2, tp2 = chain_view(t, 2), chain_view(tp, 2)
    w = (t2 * bond_weight(nn[:, 0]) + tp2 * bond_weight(nnn[:, 0])
         + tp2 * bond_weight(nnn[:, 3]))
    val = w * torch.tanh(0.5 * chain_view(beta, 2) * evals)
    return torch.sum(torch.where(evals > 0, val, torch.zeros_like(val)),
                     dim=-1) / N


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


def f_sum_check(omega_grid, sigma, evals, f, J2, n_sites):
    """Regular-part f-sum rule: ∫ Re σ_reg(ω) dω = π·Λ_xx^offdiag.

    σ is even in ω under PH symmetry, so the trapezoid over the positive
    grid is doubled; the prediction contracts the same |J_nm|² with
    (f_n−f_m)/ΔE over the non-degenerate pairs.  Exact only as η → 0,
    ω_max → ∞ and Δω → 0.  Returns per chain ``(s_grid, s_pred,
    rel_err)``."""
    s_grid = 2.0 * torch.trapezoid(sigma, omega_grid, dim=-1)
    dE = _pair_differences(evals)
    df = f[:, :, None] - f[:, None, :]
    small = torch.abs(dE) < DEGENERATE_EPS
    ratio = torch.where(small, torch.zeros_like(dE),
                        df / torch.where(small, torch.ones_like(dE), dE))
    s_pred = math.pi * torch.sum(ratio * J2, dim=(-2, -1)) / n_sites
    rel = torch.abs(s_grid - s_pred) / torch.clamp(torch.abs(s_pred),
                                                   min=1e-30)
    return s_grid, s_pred, rel


def density_of_states(lat: LatticeSpec, dos_grid, evals, evecs, eta):
    """N(ω) = (1/N) Σ_n w_n·L(ω−E_n), w_n = Σ_i |u_{i,n}|²."""
    N = lat.n_sites
    w = torch.sum(torch.abs(evecs[:, :N]) ** 2, dim=-2)            # (B, 2N)
    L = lorentzian(dos_grid[None, :, None] - evals[:, None, :], eta)
    return (L @ w[..., None])[..., 0] / N


def antinodal_dos(lat: LatticeSpec, dos_grid, evals, evecs, eta):
    """DOS projected on k = (π,0), (0,π): weight ½(|Σ_i(−1)^x u|² +
    |Σ_i(−1)^y u|²)/N per eigenstate."""
    N = lat.n_sites
    Ut = evecs[:, :N]
    s1, s2 = (_const(a, evecs) @ Ut for a in antinodal_phases(lat))
    w = 0.5 * (torch.abs(s1) ** 2 + torch.abs(s2) ** 2) / N
    L = lorentzian(dos_grid[None, :, None] - evals[:, None, :], eta)
    return (L @ w[..., None])[..., 0]


def fermi_surface_map(lat: LatticeSpec, evals, evecs, eta,
                      weight_cutoff=1e-6):
    """A(k, ω=0) = Σ_n |FFT₂(u_n)|²·L(−E_n)/N over the states whose weight
    passes ``weight_cutoff``; (B, Lx, Ly) indexed [kx, ky]."""
    N = lat.n_sites
    B = evals.shape[0]
    wz = lorentzian(-evals, eta)
    w = torch.where(wz > weight_cutoff, wz, torch.zeros_like(wz))
    # site i = y*Lx + x ⇒ [b, n, y, x]; fft2 gives [ky, kx]
    u = evecs[:, :N].mT.reshape(B, -1, lat.Ly, lat.Lx)
    F2 = torch.abs(torch.fft.fft2(u, dim=(-2, -1))) ** 2
    ak_yx = torch.einsum("bn,bnyx->byx", w, F2) / N
    return ak_yx.mT


def measure_transport_and_spectra(lat: LatticeSpec, spec: SpectralSpec,
                                  params: ModelParams,
                                  state: HMCState) -> SpectrumResult:
    """Full heavy measurement from an HMCState of B chains: two K2 launches
    on the card (σ_DC, then σ(ω))."""
    N = lat.n_sites
    beta, t, tp = params.beta, params.t, params.tp
    evals, evecs = state.evals, state.evecs

    f = fermi_factors(evals, beta)
    J2 = torch.abs(current_matrix_elements(lat, evecs, t, tp)) ** 2

    dia = diamagnetic_term(lat, evals, evecs, t, tp, beta)
    lam = paramagnetic_term(evals, f, J2, beta, N)

    eta = float(spec.eta)
    omega = _const(spec.omega_grid(), evals)
    dosgrid = _const(spec.dos_grid(), evals)

    return SpectrumResult(
        superfluid_stiffness=dia - lam,
        dc_conductivity=dc_conductivity(evals, f, J2, beta, eta, N),
        optical_conductivity=optical_conductivity(omega, evals, f, J2, eta,
                                                  N),
        dos=density_of_states(lat, dosgrid, evals, evecs, eta),
        dos_AN=antinodal_dos(lat, dosgrid, evals, evecs, eta),
        A_k0=fermi_surface_map(lat, evals, evecs, eta))
