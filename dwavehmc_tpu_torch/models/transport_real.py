"""Complex-free transport & spectra (port of
``dwavehmc_tpu/models/transport_real.py``) for B chains at once.

 * current operator Jx = i·K with K real antisymmetric ⇒
   |J_mn|² = R² + I²,  R = XᵀKX + YᵀKY,  I = XᵀKY − YᵀKX
 * stiffness/DC/σ(ω)/DOS on |J|², f, E
 * A(k, 0) via DFT-by-matmul: F = (Cx − iSx) u (Cy − iSy)ᵀ in real products
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.spectral import fermi_factors
from .lattice import LatticeSpec, antinodal_phases, neighbor_tables
from .params import ModelParams, SpectralSpec, chain_view
from .transport import (
    SpectrumResult,
    _const,
    current_patterns,
    dc_conductivity,
    lorentzian,
    optical_conductivity,
    paramagnetic_term,
)


@functools.lru_cache(maxsize=None)
def dft_matrices(L: int) -> tuple[np.ndarray, np.ndarray]:
    """(C, S) with F_{k,x} = exp(−2πi·kx/L) = C − iS  (numpy constants)."""
    k = np.arange(L)[:, None]
    x = np.arange(L)[None, :]
    ang = 2.0 * np.pi * k * x / L
    return np.cos(ang), np.sin(ang)


def current_pattern_matrix(lat: LatticeSpec, t, tp):
    """K (N×N real antisymmetric, or (B, N, N) for per-chain t/t'):
    Jx_particle = i·K."""
    B_nn, B_nnn = (_const(a, t) for a in current_patterns(lat))
    return chain_view(t, 3) * B_nn + chain_view(tp, 3) * B_nnn


def current_J2_real(lat: LatticeSpec, X, Y, t, tp):
    """|J_mn|² (B, 2N, 2N) from eigenvector parts."""
    N = lat.n_sites
    K = current_pattern_matrix(lat, t, tp).to(X.dtype)
    # blockdiag(K, K) action on the 2N-dim space
    KX = torch.cat([K @ X[:, :N], K @ X[:, N:]], dim=-2)
    KY = torch.cat([K @ Y[:, :N], K @ Y[:, N:]], dim=-2)
    R = X.mT @ KX + Y.mT @ KY
    I = X.mT @ KY - Y.mT @ KX
    return R * R + I * I


def diamagnetic_term_real(lat: LatticeSpec, evals, X, Y, t, tp, beta):
    """⟨−Kx⟩ with 2Re(u_i ū_j) = X_iX_j + Y_iY_j row contractions."""
    N = lat.n_sites
    nn, nnn = (torch.as_tensor(a, dtype=torch.long, device=X.device)
               for a in neighbor_tables(lat))
    Xt, Xb = X[:, :N], X[:, N:]
    Yt, Yb = Y[:, :N], Y[:, N:]

    def bond_weight(jmap):
        a = (Xb * Xb[:, jmap]).sum(-2) + (Yb * Yb[:, jmap]).sum(-2)
        b = (Xt * Xt[:, jmap]).sum(-2) + (Yt * Yt[:, jmap]).sum(-2)
        return 2.0 * (a - b)

    t2, tp2 = chain_view(t, 2), chain_view(tp, 2)
    w = (t2 * bond_weight(nn[:, 0])
         + tp2 * bond_weight(nnn[:, 0])
         + tp2 * bond_weight(nnn[:, 3]))
    val = w * torch.tanh(0.5 * chain_view(beta, 2) * evals)
    return torch.sum(torch.where(evals > 0, val, torch.zeros_like(val)),
                     dim=-1) / N


def density_of_states_real(lat: LatticeSpec, dos_grid, evals, X, Y, eta):
    N = lat.n_sites
    w = torch.sum(X[:, :N] ** 2 + Y[:, :N] ** 2, dim=-2)          # (B, 2N)
    L = lorentzian(dos_grid[None, :, None] - evals[:, None, :], eta)
    return (L @ w[..., None])[..., 0] / N


def antinodal_dos_real(lat: LatticeSpec, dos_grid, evals, X, Y, eta):
    N = lat.n_sites
    p1, p2 = (_const(a, X) for a in antinodal_phases(lat))
    w = 0.5 * (((p1 @ X[:, :N]) ** 2 + (p1 @ Y[:, :N]) ** 2)
               + ((p2 @ X[:, :N]) ** 2 + (p2 @ Y[:, :N]) ** 2)) / N
    L = lorentzian(dos_grid[None, :, None] - evals[:, None, :], eta)
    return (L @ w[..., None])[..., 0]


def fermi_surface_map_real(lat: LatticeSpec, evals, X, Y, eta,
                           weight_cutoff=1e-6):
    """A(k, 0) via DFT matmuls; (B, Lx, Ly) indexed [kx, ky]."""
    N = lat.n_sites
    B = evals.shape[0]
    wz = lorentzian(-evals, eta)
    w = torch.where(wz > weight_cutoff, wz, torch.zeros_like(wz))

    # site i = y*Lx + x ⇒ (B, 2N, Ly, Lx) with [b, n, y, x]
    ux = X[:, :N].mT.reshape(B, -1, lat.Ly, lat.Lx)
    uy = Y[:, :N].mT.reshape(B, -1, lat.Ly, lat.Lx)
    Cy, Sy = (_const(a, X) for a in dft_matrices(lat.Ly))
    Cx, Sx = (_const(a, X) for a in dft_matrices(lat.Lx))

    es = torch.einsum
    # P = (Cy − iSy) · u over the y axis: P[k_y, x]
    pr = es("ky,bnyx->bnkx", Cy, ux) + es("ky,bnyx->bnkx", Sy, uy)
    pi = es("ky,bnyx->bnkx", Cy, uy) - es("ky,bnyx->bnkx", Sy, ux)
    # Q = P · (Cx − iSx)ᵀ over the x axis: Q[k_y, k_x]
    qr = es("bnkx,jx->bnkj", pr, Cx) + es("bnkx,jx->bnkj", pi, Sx)
    qi = es("bnkx,jx->bnkj", pi, Cx) - es("bnkx,jx->bnkj", pr, Sx)

    ak_yx = es("bn,bnkj->bkj", w, qr * qr + qi * qi) / N         # [ky, kx]
    return ak_yx.mT                                               # (Lx, Ly)


def measure_transport_and_spectra_real(lat: LatticeSpec, spec: SpectralSpec,
                                       params: ModelParams, state
                                       ) -> SpectrumResult:
    """Full heavy measurement from an HMCStateReal of B chains."""
    N = lat.n_sites
    beta, t, tp = params.beta, params.t, params.tp
    evals, X, Y = state.evals, state.X, state.Y

    f = fermi_factors(evals, beta)
    J2 = current_J2_real(lat, X, Y, t, tp)

    dia = diamagnetic_term_real(lat, evals, X, Y, t, tp, beta)
    lam = paramagnetic_term(evals, f, J2, beta, N)
    stiffness = dia - lam

    eta = float(spec.eta)
    omega = _const(spec.omega_grid(), evals)
    dosgrid = _const(spec.dos_grid(), evals)

    dc = dc_conductivity(evals, f, J2, beta, eta, N)
    sigma = optical_conductivity(omega, evals, f, J2, eta, N)
    dos = density_of_states_real(lat, dosgrid, evals, X, Y, eta)
    dosan = antinodal_dos_real(lat, dosgrid, evals, X, Y, eta)
    ak0 = fermi_surface_map_real(lat, evals, X, Y, eta)

    return SpectrumResult(
        superfluid_stiffness=stiffness, dc_conductivity=dc,
        optical_conductivity=sigma, dos=dos, dos_AN=dosan, A_k0=ak0)
