"""Force-kernel microbenchmark and equivalence check (port of
``scripts/bench_forces.py``):

    python -m dwavehmc_tpu_torch.drivers.bench_forces [--device cuda|cpu]
        [--L 16] [--batch 8] [--reps 20] [--dtype float32]

Compares the production row-contraction ``ops/forces.pairing_correlations``
against the matmul-diagonal formulation (the full ρ = W U†, then the
needed elements) on an ``init_ensemble`` (complex path) ensemble: both
must agree to 1e-10 in float64 and 1e-4 in float32 (``OK``/``FAIL``), then
each is timed (``utils/profiling.call_ms``: CUDA events on the card).
A ``FAIL`` exits nonzero after the timings.
"""

from __future__ import annotations

import argparse
import statistics
import sys

import torch

from ..models.lattice import LatticeSpec, neighbor_tables
from ..models.params import make_params
from ..ops.forces import pairing_correlations
from ..ops.spectral import fermi_factors
from ..parallel.ensemble import init_ensemble
from ..utils.device import resolve_device
from ..utils.profiling import call_ms

#: the seed of the ensemble's generator (the JAX script's PRNGKey(0))
SEED = 0
BETA = 10.0
#: the kernel-equivalence bars by dtype
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--L", type=int, default=16)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def matmul_diagonal(lat: LatticeSpec, evals, evecs, beta):
    """P (B, N, 2) from the full ρ = W U† with W = U·diag(f), then the
    elements the row contraction needs: O((2N)³) against O(8N²)."""
    N = lat.n_sites
    nn, _ = neighbor_tables(lat)
    nn = torch.as_tensor(nn, dtype=torch.long, device=evecs.device)
    jx, jy = nn[:, 0], nn[:, 1]
    i = torch.arange(N, device=evecs.device)
    f = fermi_factors(evals, beta)
    rho = (evecs * f[:, None, :]) @ evecs.conj().mT
    Px = -(rho[:, i, jx + N] + rho[:, jx, i + N])
    Py = -(rho[:, i, jy + N] + rho[:, jy, i + N])
    return torch.stack([Px, Py], dim=-1)


def variants(lat: LatticeSpec, beta):
    """(name, fn(evals, evecs)) of the two formulations, as timed."""
    return (("row-contract O(N²)",
             lambda e, U: pairing_correlations(lat, e, U, beta)),
            ("matmul-diag O(N³)",
             lambda e, U: matmul_diagonal(lat, e, U, beta)))


def equivalence(lat: LatticeSpec, evals, evecs, beta) -> tuple[float, float]:
    """(max |ΔP| between the formulations, the bar for the dtype)."""
    P1, P2 = (fn(evals, evecs) for _, fn in variants(lat, beta))
    return float((P1 - P2).abs().max()), TOL[evals.dtype]


def bench(ns: argparse.Namespace, out=print) -> bool:
    """Prints the equivalence line and the timings; True when it holds."""
    device = resolve_device(ns.device)
    dtype = torch.float64 if ns.dtype == "float64" else torch.float32
    lat = LatticeSpec(ns.L, ns.L)
    params = make_params(W=1.0, n_imp=0.05, beta=BETA, J=0.8, dtype=dtype,
                         device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    states = init_ensemble(lat, params, gen, ns.batch, dtype=dtype,
                           n_imp=0.05, device=device)
    diff, tol = equivalence(lat, states.evals, states.evecs, params.beta)
    ok = diff < tol
    out(f"kernel equivalence: max|ΔP| = {diff:.2e} (tol {tol:.0e}) "
        f"{'OK' if ok else 'FAIL'}")
    for name, fn in variants(lat, params.beta):
        dt = statistics.fmean(call_ms(lambda: fn(states.evals, states.evecs),
                                      ns.reps, device)[0]) / 1e3
        out(f"{name:22s}: {dt * 1e3:8.3f} ms/call "
            f"(batch {ns.batch}, {ns.L}x{ns.L})")
    return ok


def main(argv=None) -> bool:
    if not bench(parser().parse_args(argv)):
        raise SystemExit("bench_forces: the two formulations disagree")
    return True


if __name__ == "__main__":
    main(sys.argv[1:])
