"""Term-by-term superfluid-stiffness inspection (port of
``scripts/debug_transport.py``):

    python -m dwavehmc_tpu_torch.drivers.debug_transport [--device cuda|cpu]
        [--L 8] [--beta 7.0] [--delta 0.3] [--W 0.0] [--n_imp 0.0]
        [--dtype float64]

Prints the diamagnetic term, the paramagnetic Λ_xx and their difference
ρ_s for one chain started from a uniform d-wave Δ, and for the clean
normal state (``--W 0 --delta 0``) the analytic plane-wave Drude weight
beside it, with the difference.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..models.lattice import LatticeSpec, dispersion, k_grid
from ..models.params import make_params, uniform_dwave_delta
from ..models.transport import (
    current_matrix_elements,
    diamagnetic_term,
    paramagnetic_term,
)
from ..ops.spectral import fermi_factors
from ..sampler.hmc import init_chain_state
from ..utils.device import resolve_device

T, TP, MU = 1.0, -0.35, -1.08
#: the seed of the chain's generator (the JAX script's PRNGKey(0))
SEED = 0


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--L", type=int, default=8)
    p.add_argument("--beta", type=float, default=7.0)
    p.add_argument("--delta", type=float, default=0.3)
    p.add_argument("--W", type=float, default=0.0)
    p.add_argument("--n_imp", type=float, default=0.0)
    p.add_argument("--dtype", default="float64")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def drude_weight(lat: LatticeSpec, beta: float) -> float:
    """The clean normal state's plane-wave Drude weight."""
    kx, ky = k_grid(lat)
    KX, KY = np.meshgrid(kx, ky, indexing="ij")
    eps = dispersion(KX, KY, T, TP, MU)
    fk = 1.0 / (1.0 + np.exp(beta * eps))
    d2e = 2 * T * np.cos(KX) + 4 * TP * np.cos(KX) * np.cos(KY)
    v = 2 * T * np.sin(KX) + 4 * TP * np.sin(KX) * np.cos(KY)
    return float((2.0 / lat.n_sites) * np.sum(
        d2e * fk - beta * fk * (1 - fk) * v**2))


def inspect(ns: argparse.Namespace, out=print) -> dict:
    """Prints the lines; returns the terms (and the Drude weight and its
    difference from ρ_s where they are printed)."""
    device = resolve_device(ns.device)
    dtype = torch.float64 if ns.dtype == "float64" else torch.float32
    lat = LatticeSpec(ns.L, ns.L)
    params = make_params(t=T, tp=TP, mu=MU, W=ns.W, n_imp=ns.n_imp,
                         beta=ns.beta, J=1.6, dtype=dtype, device=device)
    delta0 = uniform_dwave_delta(lat, ns.delta, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    st = init_chain_state(lat, params, 1, generator=gen, dtype=dtype,
                          n_imp=ns.n_imp, delta0=delta0, device=device)

    f = fermi_factors(st.evals, params.beta)
    J2 = torch.abs(current_matrix_elements(lat, st.evecs, params.t,
                                           params.tp)) ** 2
    dia = float(diamagnetic_term(lat, st.evals, st.evecs, params.t,
                                 params.tp, params.beta)[0])
    lam = float(paramagnetic_term(st.evals, f, J2, params.beta,
                                  lat.n_sites)[0])
    out(f"{ns.L}x{ns.L}, beta={ns.beta}, |Δ|={ns.delta}, W={ns.W}")
    out(f"diamagnetic <-Kx> : {dia:+.6f}")
    out(f"paramagnetic Λ_xx : {lam:+.6f}")
    out(f"stiffness ρ_s     : {dia-lam:+.6f}")
    terms = {"dia": dia, "lambda_xx": lam, "rho_s": dia - lam}

    if ns.W == 0.0 and ns.delta == 0.0:
        drude = drude_weight(lat, ns.beta)
        out(f"analytic Drude    : {drude:+.6f} "
            f"(diff {abs(dia-lam-drude):.2e})")
        terms.update(drude=drude, drude_diff=abs(dia - lam - drude))
    return terms


def main(argv=None) -> dict:
    return inspect(parser().parse_args(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
