"""Momentum-space BCS mean-field gap equation, the clean-limit oracle (port
of ``dwavehmc_tpu/models/bcs.py``, numpy only).

For the clean system the HMC average gap must satisfy

    Δ = (J/N) Σ_k g_k² · Δ / (2E_k) · tanh(βE_k/2),   g_k = cos kx − cos ky,
    E_k = √(ε_k² + Δ² g_k²)

to < 0.02 absolute (the S3 pass bar, ``drivers/benchmark_clean.py``).
"""

from __future__ import annotations

import numpy as np

from .lattice import LatticeSpec, dispersion, k_grid


def bcs_gap_rhs(delta_in: float, lat: LatticeSpec, t, tp, mu, beta, J) -> float:
    """RHS of the self-consistent d-wave gap equation on the finite k-grid."""
    kx, ky = k_grid(lat)
    KX, KY = np.meshgrid(kx, ky, indexing="ij")
    eps = dispersion(KX, KY, t, tp, mu)
    g = np.cos(KX) - np.cos(KY)
    Ek = np.sqrt(eps**2 + (delta_in * g) ** 2)
    # guard: g=0 lines make Ek=|eps|; if eps=0 too the ratio limit is β/4
    with np.errstate(divide="ignore", invalid="ignore"):
        val = np.where(Ek > 1e-14,
                       g**2 / (2.0 * Ek) * np.tanh(0.5 * beta * Ek),
                       0.25 * beta * g**2)
    return float((J / lat.n_sites) * np.sum(val) * delta_in)


def bcs_selfconsistent_gap(lat: LatticeSpec, t, tp, mu, beta, J,
                           delta0=0.2, iters=500, tol=1e-12) -> float:
    """Solve Δ = RHS(Δ) by fixed-point iteration (for test oracles)."""
    d = float(delta0)
    for _ in range(iters):
        nd = bcs_gap_rhs(d, lat, t, tp, mu, beta, J)
        if abs(nd - d) < tol:
            return nd
        d = nd
    return d
