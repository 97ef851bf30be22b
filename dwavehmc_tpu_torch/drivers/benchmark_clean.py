"""Correctness benchmark against BCS mean-field theory, S3 (port of
``scripts/benchmark_clean.py``):

    python -m dwavehmc_tpu_torch.drivers.benchmark_clean [--device cuda|cpu]
        [--fast] [--path complex|real] [--eigh_mode exact|tracked] ...

Clean 10×10 lattice, β = 180, J = 1.6, uniform d-wave start Δx = −Δy = 0.2,
one chain: 50 thermalization sweeps at Nt = 20, then 100 measurement sweeps
at Nt = 5.  The HMC average ⟨|Δ_global|⟩ must satisfy the momentum-space gap
equation (``models/bcs.bcs_gap_rhs``) to < 0.02; the exit code is 0 on pass
and 1 on fail.  ``--fast`` is the cheaper 8×8, β = 100, 40 + 60 sweeps
variant.  ``--path real`` runs ``hmc_sweep_real`` from (Δ_re, 0) with
``--eigh_mode``; with ``tracked`` every leapfrog step makes 6 tracked
rotations (kernel K1 on the card).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from ..models.bcs import bcs_gap_rhs
from ..models.lattice import LatticeSpec
from ..models.observables import measure_observables
from ..models.observables_real import measure_observables_real
from ..models.params import make_params, uniform_dwave_delta
from ..sampler.hmc import calc_optimal_dt, hmc_sweep, init_chain_state
from ..sampler.hmc_real import hmc_sweep_real, init_chain_state_real
from ..utils.device import resolve_device

#: the clean system's band: t, t′, μ (no disorder)
T, TP, MU = 1.0, -0.35, -1.08
#: the uniform d-wave start's amplitude
START_AMP = 0.2
DTYPES = {"float64": torch.float64, "float32": torch.float32}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--L", type=int, default=10)
    p.add_argument("--beta", type=float, default=180.0)
    p.add_argument("--J", type=float, default=1.6)
    p.add_argument("--n_therm", type=int, default=50)
    p.add_argument("--n_measure", type=int, default=100)
    p.add_argument("--Nt_therm", type=int, default=20)
    p.add_argument("--Nt_measure", type=int, default=5)
    p.add_argument("--dtype", choices=tuple(DTYPES), default="float64")
    p.add_argument("--fast", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--path", choices=("complex", "real"), default="complex")
    p.add_argument("--eigh_mode", choices=("exact", "tracked"),
                   default="exact")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


class Chain(NamedTuple):
    """One clean chain: its state and the path's sweep and observables.
    ``sweep(params, state, Nt, dt, normals, uniforms, generator)`` returns
    (state, SweepInfo)."""

    state: object
    sweep: object
    measure: object


def clean_chain(lat: LatticeSpec, params, path: str, eigh_mode: str, *,
                generator: torch.Generator, dtype, device) -> Chain:
    """One chain on the clean lattice at the uniform d-wave start, on the
    complex path or on the real-pair path from (Δ_re, 0)."""
    delta0 = uniform_dwave_delta(lat, START_AMP, dtype=dtype, device=device)
    if path == "real":
        state = init_chain_state_real(
            lat, params, 1, generator=generator, dtype=dtype, n_imp=0.0,
            delta0_re=delta0.real, delta0_im=torch.zeros_like(delta0.real),
            device=device)

        def sweep(p, s, Nt, dt, normals, uniforms, gen):
            return hmc_sweep_real(lat, p, s, Nt, dt, eigh_mode,
                                  normals=normals, uniforms=uniforms,
                                  generator=gen)
        return Chain(state, sweep, measure_observables_real)
    state = init_chain_state(lat, params, 1, generator=generator, dtype=dtype,
                             n_imp=0.0, delta0=delta0, device=device)

    def sweep(p, s, Nt, dt, normals, uniforms, gen):
        return hmc_sweep(lat, p, s, Nt, dt, normals=normals,
                         uniforms=uniforms, generator=gen)
    return Chain(state, sweep, measure_observables)


class ChainRun(NamedTuple):
    """A chain's state after a run and its measurement sweeps' records,
    each (n_measure,)."""

    state: object
    delta_global: np.ndarray
    delta_pair: np.ndarray
    delta_diff: np.ndarray
    accepted: np.ndarray


def run_chain(lat: LatticeSpec, params, chain: Chain, beta: float, J: float,
              *, n_therm: int, n_measure: int, Nt_therm: int,
              Nt_measure: int, generator: torch.Generator | None = None,
              normals=None, uniforms=None, report_every: int = 0,
              log=print) -> ChainRun:
    """``n_therm`` sweeps at ``Nt_therm``, then ``n_measure`` at
    ``Nt_measure``, each at the harmonic step of ``calc_optimal_dt`` (m = 1),
    with the light observables after every measurement sweep.  Sweep ``i``
    takes ``normals[i]`` (1, 2, N, 2) and ``uniforms[i]`` (1,) when given,
    else its draws from ``generator``.  Every ``report_every``-th
    measurement sweep is logged."""
    state, sweep, measure = chain

    def draw(i):
        if normals is None:
            return None, None
        return normals[i], uniforms[i]

    dt_th = calc_optimal_dt(beta, J, 1.0, Nt_therm)
    if report_every:
        log("Thermalizing...")
    for i in range(n_therm):
        state, _ = sweep(params, state, Nt_therm, dt_th, *draw(i), generator)
    if report_every:
        log("Measuring...")
    dt_me = calc_optimal_dt(beta, J, 1.0, Nt_measure)
    glob, pair, diff, acc = [], [], [], []
    for i in range(n_measure):
        state, info = sweep(params, state, Nt_measure, dt_me,
                            *draw(n_therm + i), generator)
        acc.append(bool(info.accepted[0]))
        obs = measure(lat, params, state)
        glob.append(float(obs.delta_global[0]))
        pair.append(float(obs.delta_pair[0]))
        diff.append(float(obs.delta_diff[0]))
        if report_every and (i + 1) % report_every == 0:
            log(f"  sweep {i+1}: |Δ_global|={glob[-1]:.6f} "
                f"diff={diff[-1]:.6f}")
    return ChainRun(state, np.array(glob), np.array(pair), np.array(diff),
                    np.array(acc))


def resolve_args(ns: argparse.Namespace) -> argparse.Namespace:
    """``ns`` with ``--fast`` applied."""
    if ns.fast:
        ns.L, ns.beta, ns.n_therm, ns.n_measure = 8, 100.0, 40, 60
    return ns


def benchmark(ns: argparse.Namespace, *, normals=None, uniforms=None,
              log=print) -> dict:
    """The S3 run of ``resolve_args(ns)``: its printed block through
    ``log`` and its numbers (gap, std, rhs, diff, acceptance, seconds,
    passed, and the per-sweep ``ChainRun`` as ``run``)."""
    ns = resolve_args(ns)
    device = resolve_device(ns.device)
    dtype = DTYPES[ns.dtype]
    lat = LatticeSpec(ns.L, ns.L)
    params = make_params(t=T, tp=TP, mu=MU, W=0.0, n_imp=0.0, beta=ns.beta,
                         J=ns.J, mass=1.0, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(ns.seed)
    chain = clean_chain(lat, params, ns.path, ns.eigh_mode, generator=gen,
                        dtype=dtype, device=device)

    log("=== Benchmark: Clean Limit (Momentum Space Check) ===")
    log(f"{ns.L}x{ns.L}, beta={ns.beta}, J={ns.J}, dtype={ns.dtype}, "
        f"path={ns.path}, device={device}")
    t0 = time.time()
    run = run_chain(lat, params, chain, ns.beta, ns.J, n_therm=ns.n_therm,
                    n_measure=ns.n_measure, Nt_therm=ns.Nt_therm,
                    Nt_measure=ns.Nt_measure, generator=gen, normals=normals,
                    uniforms=uniforms, report_every=20, log=log)
    seconds = time.time() - t0

    gap = float(np.mean(run.delta_global))
    std = float(np.std(run.delta_global))
    rhs = bcs_gap_rhs(gap, lat, T, TP, MU, ns.beta, ns.J)
    diff = abs(gap - rhs)
    acceptance = float(np.sum(run.accepted)) / ns.n_measure
    log("\n--- Results ---")
    log(f"HMC <|Δ_global|>: {gap:.6f} +/- {std:.6f}")
    log(f"BCS RHS(Δ_hmc)  : {rhs:.6f}")
    log(f"Difference      : {diff:.6f} ({diff/max(gap,1e-12)*100:.2f}%)")
    log(f"Acceptance      : {acceptance:.2f}")
    log(f"Wall time       : {seconds:.1f}s")
    passed = diff < 0.02
    if passed:
        log(">>> Benchmark 1 Passed! HMC result matches Mean Field theory.")
    else:
        log(">>> Benchmark 1 FAILED: deviation too large.")
    return dict(gap=gap, std=std, rhs=rhs, diff=diff, acceptance=acceptance,
                seconds=seconds, passed=passed, run=run)


def main(argv=None) -> int:
    """0 if the gap equation holds to < 0.02, else 1."""
    return 0 if benchmark(parser().parse_args(argv))["passed"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
