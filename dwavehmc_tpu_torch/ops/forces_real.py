"""Complex-free force kernel (port of ``dwavehmc_tpu/ops/forces_real.py``):
pairing correlations from (X, Y) eigenvector pairs,

    Re ρ_{uv} = Σ_n f (X_u X_v + Y_u Y_v)
    Im ρ_{uv} = Σ_n f (Y_u X_v − X_u Y_v)

as row gathers and row contractions over a leading chain dimension.
"""

from __future__ import annotations

import torch

from ..models.lattice import LatticeSpec, neighbor_tables
from ..models.params import chain_view
from .spectral import fermi_factors


def pairing_correlations_real(lat: LatticeSpec, evals, X, Y, beta):
    """(P_re, P_im), each (B, N, 2): P = −ρ_{i,j+N} − ρ_{j,i+N}."""
    N = lat.n_sites
    nn, _ = neighbor_tables(lat)
    nn = torch.as_tensor(nn, dtype=torch.long, device=X.device)

    f = fermi_factors(evals, beta)          # (B, 2N)
    WX = X * f[:, None, :]
    WY = Y * f[:, None, :]

    def rho(rows_u, rows_v):
        """ρ rows: u-rows against v-rows (both index the 2N-dim space)."""
        xu, yu = WX[:, rows_u], WY[:, rows_u]
        xv, yv = X[:, rows_v], Y[:, rows_v]
        re = (xu * xv).sum(-1) + (yu * yv).sum(-1)
        im = (yu * xv).sum(-1) - (xu * yv).sum(-1)
        return re, im

    i = torch.arange(N, device=X.device)
    out_re, out_im = [], []
    for d in range(2):
        j = nn[:, d]
        r1re, r1im = rho(i, j + N)          # ρ_{i, j+N}
        r2re, r2im = rho(j, i + N)          # ρ_{j, i+N}
        out_re.append(-(r1re + r2re))
        out_im.append(-(r1im + r2im))
    return torch.stack(out_re, -1), torch.stack(out_im, -1)


def hmc_forces_real(lat: LatticeSpec, delta_re, delta_im, evals, X, Y,
                    beta, J):
    """F = −β/(2J)(Δ − J·P) in real parts; returns (F_re, F_im, P_re, P_im)."""
    P_re, P_im = pairing_correlations_real(lat, evals, X, Y, beta)
    c = chain_view(beta / (2.0 * J), 3)
    Jc = chain_view(J, 3)
    return (-c * (delta_re - Jc * P_re), -c * (delta_im - Jc * P_im),
            P_re, P_im)
