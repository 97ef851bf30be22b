"""Complex-path Hybrid Monte Carlo sweep, the sweep record and the
step-size heuristic (port of ``dwavehmc_tpu/sampler/hmc.py``), over a
leading chain dimension.

Leapfrog conventions match the JAX package exactly:
    π refresh:   Re π, Im π ~ N(0, m)
    Δ update:    Δ += dt·π/(2m)
    kicks:       half, (Nt−1) full, half
    accept:      ΔH < 0 or u < exp(−ΔH); NaN ⇒ reject

Draws come from an explicit ``torch.Generator``, or as arguments
(``normals``, ``uniforms``) so that tests can hand in the JAX package's.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..models.bdg import assemble_bdg, diagonalize, static_hamiltonian
from ..models.lattice import LatticeSpec
from ..models.params import HMCState, ModelParams, chain_view
from ..ops.forces import hmc_forces
from ..ops.spectral import energy_difference, total_energy


class SweepInfo(NamedTuple):
    accepted: torch.Tensor   # (B,) bool
    dH: torch.Tensor         # (B,) energy change of the proposed trajectory
    H_old: torch.Tensor
    H_new: torch.Tensor


def calc_optimal_dt(beta: float, J: float, mass: float, Nt: int) -> float:
    """Harmonic-oscillator step-size heuristic: dt = 2π√(mJ/β)/(2Nt).
    Host-side, python floats."""
    period = 2.0 * math.pi * math.sqrt(mass * J / beta)
    return period / (2 * Nt)


def _finite_or_zero(x):
    """NaN/Inf guard ahead of eigh: a diverged trajectory is zeroed here and
    rejected by the accept step."""
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def draw_momenta(generator: torch.Generator, shape, dtype,
                 device) -> tuple[torch.Tensor, torch.Tensor]:
    """Standard normals (B, 2, N, 2) and float32 accept uniforms (B,) for
    one sweep, drawn in that order."""
    gdev = generator.device
    normals = torch.randn(shape, generator=generator, dtype=dtype,
                          device=gdev).to(device)
    uniforms = torch.rand((shape[0],), generator=generator,
                          dtype=torch.float32, device=gdev).to(device)
    return normals, uniforms


def sweep_draws(normals, uniforms, generator: torch.Generator | None, shape,
                dtype, device, caller: str):
    """(standard normals ``shape`` = (B, 2, N, 2), float32 uniforms (B,)) of
    one sweep: the given ones, each drawn from ``generator`` when missing."""
    if normals is None or uniforms is None:
        if generator is None:
            raise ValueError(f"{caller} needs generator= or the draws")
        n_draw, u_draw = draw_momenta(generator, shape, dtype, device)
        normals = n_draw if normals is None else normals
        uniforms = u_draw if uniforms is None else uniforms
    return (torch.as_tensor(normals, device=device).to(dtype),
            torch.as_tensor(uniforms, device=device).to(torch.float32))


def refresh_momentum(normals: torch.Tensor, mass) -> torch.Tensor:
    """Complex momenta (B, N, 2) with Re/Im variance m from standard normals
    (B, 2, N, 2)."""
    scale = chain_view(torch.sqrt(mass).to(normals.dtype), 3)
    return torch.complex(normals[:, 0], normals[:, 1]) * scale


def init_chain_state(lat: LatticeSpec, params: ModelParams, n_chains: int, *,
                     generator: torch.Generator | None = None,
                     dtype=torch.float32, n_imp: float | None = None,
                     delta0=None, disorder=None, device="cuda") -> HMCState:
    """B chains with disorder, a small random complex Δ start and matching
    eigenpairs.  Missing draws come from ``generator`` exactly as in
    ``hmc_real.init_chain_state_real`` (the disorder permutations, then the
    Δ uniforms), so both paths start one seed from the same (disorder, Δ).
    ``delta0`` (B, N, 2) complex injects the start."""
    from .hmc_real import init_chain_state_real

    d0 = None if delta0 is None else torch.as_tensor(delta0)
    s = init_chain_state_real(
        lat, params, n_chains, generator=generator, dtype=dtype, n_imp=n_imp,
        delta0_re=None if d0 is None else d0.real,
        delta0_im=None if d0 is None else d0.imag, disorder=disorder,
        diagonalize=False, device=device)
    delta = torch.complex(s.delta_re, s.delta_im)
    H = assemble_bdg(lat, static_hamiltonian(lat, params.t, params.tp,
                                             params.mu, s.disorder), delta)
    evals, evecs = diagonalize(H)
    return HMCState(delta=delta, pi=torch.zeros_like(delta),
                    disorder=s.disorder, evals=evals, evecs=evecs)


def leapfrog(lat: LatticeSpec, H_static, params: ModelParams, delta, pi,
             evals, evecs, Nt: int, dt):
    """Leapfrog integration of the complex-field equations of motion,
    dΔ/dt = π/(2m), dπ/dt = F = −∂H/∂Δ*; kicks half, (Nt−1) full, half.
    Every step runs one complex Hermitian eigh.  A non-finite Δ is zeroed
    in the matrix handed to the eigh (``torch.linalg.eigh`` raises on NaN
    where JAX's returns NaN); the Δ carried on stays non-finite, so its ΔH
    is NaN and the proposal is rejected.  Returns (Δ, π, E, U)."""
    beta, J, mass = params.beta, params.J, params.mass
    dt = torch.as_tensor(dt, dtype=evals.dtype, device=evals.device)
    dtv = chain_view(dt, 3)
    coef = chain_view(dt / (2.0 * mass), 3)

    F, _ = hmc_forces(lat, delta, evals, evecs, beta, J)
    pi = pi + (0.5 * dtv) * F
    for _ in range(Nt):
        delta = delta + coef * pi
        evals, evecs = diagonalize(assemble_bdg(lat, H_static,
                                                _finite_or_zero(delta)))
        F, _ = hmc_forces(lat, delta, evals, evecs, beta, J)
        pi = pi + dtv * F       # full kick every step; halved after the loop
    pi = pi - (0.5 * dtv) * F
    return delta, pi, evals, evecs


def hmc_sweep(lat: LatticeSpec, params: ModelParams, state: HMCState,
              Nt: int, dt, *, normals=None, uniforms=None,
              generator: torch.Generator | None = None
              ) -> tuple[HMCState, SweepInfo]:
    """One HMC trajectory + Metropolis step for every chain.  ``normals``
    (B, 2, N, 2) are the standard-normal momentum draws (scaled by √m here)
    and ``uniforms`` (B,) the float32 accept draws; either comes from
    ``generator`` when not given.  ``dt`` is a scalar or per-chain (B,)."""
    beta, J, mass = params.beta, params.J, params.mass
    rdt, dev = state.evals.dtype, state.evals.device
    normals, u = sweep_draws(normals, uniforms, generator,
                             (state.delta.shape[0], 2)
                             + tuple(state.delta.shape[1:]), rdt, dev,
                             "hmc_sweep")
    pi0 = refresh_momentum(normals, mass)
    H_old = total_energy(state.delta, pi0, state.evals, beta, J, mass)
    H_static = static_hamiltonian(lat, params.t, params.tp, params.mu,
                                  state.disorder)
    delta_n, pi_n, evals_n, evecs_n = leapfrog(
        lat, H_static, params, state.delta, pi0, state.evals, state.evecs,
        Nt, dt)
    # ΔH as term-by-term differences: conditioning, see energy_difference
    dH = energy_difference(delta_n, pi_n, evals_n, state.delta, pi0,
                           state.evals, beta, J, mass)
    accept = (dH < 0) | (u < torch.exp(-dH.to(torch.float32)))

    def sel(new, old):
        return torch.where(chain_view(accept, new.ndim), new, old)

    new_state = HMCState(
        delta=sel(delta_n, state.delta),
        pi=pi_n,                              # refreshed next sweep anyway
        disorder=state.disorder,
        evals=sel(evals_n, state.evals),
        evecs=sel(evecs_n, state.evecs))
    return new_state, SweepInfo(accepted=accept, dH=dH, H_old=H_old,
                                H_new=H_old + dH)
