"""HMC force kernel of the complex path (port of
``dwavehmc_tpu/ops/forces.py``): pairing correlations from eigenpairs as
four row gathers and row dot products over a leading chain dimension,

    ρ_{u,v} = Σ_n U[u,n] f(E_n) conj(U[v,n])
    P_ij    = −ρ_{i, j+N} − ρ_{j, i+N}          (j = i+x̂ or i+ŷ)
    F_ij    = −β/(2J) · (Δ_ij − J·P_ij)

with the Wirtinger convention F = −∂H_HMC/∂Δ*.
"""

from __future__ import annotations

import torch

from ..models.lattice import LatticeSpec, neighbor_tables
from ..models.params import chain_view
from .spectral import fermi_factors


def pairing_correlations(lat: LatticeSpec, evals, evecs, beta):
    """P (B, N, 2) complex: ⟨c_{i↑}c_{j↓} − c_{i↓}c_{j↑}⟩ on +x (column 0)
    and +y (column 1)."""
    N = lat.n_sites
    nn, _ = neighbor_tables(lat)
    nn = torch.as_tensor(nn, dtype=torch.long, device=evecs.device)
    jx, jy = nn[:, 0], nn[:, 1]

    f = fermi_factors(evals, beta)            # (B, 2N)
    W = evecs * f[:, None, :]                 # U · diag(f)
    Ub_c = evecs[:, N:].conj()                # conj hole rows
    Wt = W[:, :N]

    # ρ1 = ρ_{i, j+N}: rows i of W against conj rows j+N of U;
    # ρ2 = ρ_{j, i+N}: rows j of W against conj rows i+N of U
    Px = -((Wt * Ub_c[:, jx]).sum(-1) + (W[:, jx] * Ub_c).sum(-1))
    Py = -((Wt * Ub_c[:, jy]).sum(-1) + (W[:, jy] * Ub_c).sum(-1))
    return torch.stack([Px, Py], dim=-1)


def hmc_forces(lat: LatticeSpec, delta, evals, evecs, beta, J):
    """(F, P) with F = −β/(2J)·(Δ − J·P), each (B, N, 2) complex."""
    P = pairing_correlations(lat, evals, evecs, beta)
    return (-chain_view(beta / (2.0 * J), 3)
            * (delta - chain_view(J, 3) * P)), P
