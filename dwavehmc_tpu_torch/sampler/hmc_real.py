"""Complex-free tracked HMC sweep (port of the tracked half of
``dwavehmc_tpu/sampler/hmc_real.py``) over a leading chain dimension.

Random draws come from an explicit ``torch.Generator``; every function that
draws also takes its draws as arguments (``normals``, ``uniforms``,
``disorder``, ``delta0_re``/``delta0_im``) so that tests can hand in the
JAX package's draws.

Leapfrog conventions: π refresh Re π, Im π ~ N(0, m); Δ += dt·π/(2m);
kicks half, (Nt−1) full, half.  Accept: ΔH < 0 or u < exp(−ΔH) compared in
float32; a non-finite proposal is rejected and zeroed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.bdg import static_hamiltonian
from ..models.bdg_real import (
    assemble_embedding,
    assemble_parts,
    diagonalize_embedding,
    static_embedding,
)
from ..models.lattice import LatticeSpec
from ..models.params import ModelParams, chain_view, sample_disorder
from ..ops.forces_real import hmc_forces_real
from ..ops.spectral import softplus
from ..ops.tracked_eigh import tracked_eigh_nofallback
from ..utils.device import resolve_device
from .hmc import SweepInfo


class HMCStateReal(NamedTuple):
    """Real-pair Markov state of B chains.  X + iY are the complex
    eigenvector parts.  (The JAX state's PRNG key has no counterpart: draws
    come from a ``torch.Generator``.)"""

    delta_re: torch.Tensor    # (B, N, 2)
    delta_im: torch.Tensor
    pi_re: torch.Tensor       # (B, N, 2)
    pi_im: torch.Tensor
    disorder: torch.Tensor    # (B, N)
    evals: torch.Tensor       # (B, 2N)
    X: torch.Tensor           # (B, 2N, 2N)
    Y: torch.Tensor           # (B, 2N, 2N)


class Proposal(NamedTuple):
    """Endpoint of a tracked leapfrog trajectory, input to the accept step."""

    delta_re: torch.Tensor
    delta_im: torch.Tensor
    pi_re: torch.Tensor
    pi_im: torch.Tensor
    pi_re0: torch.Tensor      # refreshed momenta at the trajectory start
    pi_im0: torch.Tensor
    u: torch.Tensor           # (B,) float32 accept uniforms
    res_max: torch.Tensor     # (B,) max in-trajectory tracked residual
    evals: torch.Tensor       # tracked endpoint spectrum (unsorted)
    X: torch.Tensor
    Y: torch.Tensor
    res_end: torch.Tensor     # (B,) endpoint residual


def _exact_diagonalize(M, solver: str = "qdwh"):
    """Anchor/init eigensolver: "qdwh" = ``torch.linalg.eigh`` on the full
    embedding.  The PH-split solver ("ph") is not ported yet."""
    if solver != "qdwh":
        raise NotImplementedError(
            f"exact_solver={solver!r}: only 'qdwh' is ported; the PH-split "
            "solver (ops/ph_eigh.py) is the next slice of the port")
    return diagonalize_embedding(M)


def init_chain_state_real(lat: LatticeSpec, params: ModelParams,
                          n_chains: int, *,
                          generator: torch.Generator | None = None,
                          dtype=torch.float32, n_imp: float | None = None,
                          delta0_re=None, delta0_im=None, disorder=None,
                          exact_solver: str = "qdwh",
                          diagonalize: bool = True,
                          device="cuda") -> HMCStateReal:
    """B chains with disorder, a small random Δ start and matching exact
    eigenpairs.  Missing draws come from ``generator``: the disorder
    permutations first, then the Δ uniforms, (U[0,1) − 0.5)·0.1 for the real
    and imaginary parts.  ``diagonalize=False`` leaves the eigenpairs zero."""
    device = resolve_device(device)
    N = lat.n_sites
    if disorder is None:
        frac = float(params.n_imp) if n_imp is None else float(n_imp)
        disorder = sample_disorder(lat, float(params.W), frac, n_chains,
                                   generator=generator, dtype=dtype,
                                   device=device)
    disorder = torch.as_tensor(disorder, device=device).to(dtype)
    if delta0_re is None:
        if generator is None:
            raise ValueError("init_chain_state_real needs generator= or "
                             "delta0_re=")
        u = torch.rand((n_chains, 2, N, 2), generator=generator,
                       dtype=dtype, device=generator.device).to(device) - 0.5
        delta0_re, delta0_im = 0.1 * u[:, 0], 0.1 * u[:, 1]
    delta0_re = torch.as_tensor(delta0_re, device=device).to(dtype)
    delta0_im = (torch.zeros_like(delta0_re) if delta0_im is None
                 else torch.as_tensor(delta0_im, device=device).to(dtype))

    dim = 2 * N
    if diagonalize:
        M = assemble_embedding(
            lat, static_embedding(lat, params.t, params.tp, params.mu,
                                  disorder),
            delta0_re, delta0_im)
        evals, X, Y = _exact_diagonalize(M, exact_solver)
    else:
        evals = torch.zeros((n_chains, dim), dtype=dtype, device=device)
        X = torch.zeros((n_chains, dim, dim), dtype=dtype, device=device)
        Y = torch.zeros_like(X)
    z = torch.zeros_like(delta0_re)
    return HMCStateReal(delta0_re, delta0_im, z, z.clone(), disorder,
                        evals, X, Y)


def _energy_terms(delta_re, delta_im, pi_re, pi_im, evals, beta, J, mass):
    """Per-chain H_HMC, fermion term in the PH-even all-levels/2 form
    (valid for an unsorted spectrum)."""
    kin = torch.sum(pi_re**2 + pi_im**2, dim=(-2, -1)) / (2.0 * mass)
    bos = (beta / (2.0 * J)) * torch.sum(delta_re**2 + delta_im**2,
                                         dim=(-2, -1))
    x = chain_view(beta, 2) * torch.abs(evals)
    fer = -0.5 * torch.sum(x + 2.0 * softplus(-x), dim=-1)
    return kin + bos + fer


def _finite_or_zero(x):
    """NaN/Inf guard ahead of eigh: a diverged trajectory is zeroed here and
    rejected by the accept step's finiteness check."""
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def _all_finite(*xs):
    out = None
    for x in xs:
        f = torch.isfinite(x).flatten(1).all(dim=1)
        out = f if out is None else out & f
    return out


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


def tracked_leapfrog(lat: LatticeSpec, params: ModelParams,
                     state: HMCStateReal, Nt: int, dt,
                     tracked_iters: int = 6, refine_iters: int = 0,
                     polish_iters: int = 6, ns_steps: int = 2,
                     rot_dtype=None, polish_precision: str = "highest",
                     polish_correction: bool = False, rot_scheme: str = "ns",
                     *, normals=None, uniforms=None,
                     generator: torch.Generator | None = None) -> Proposal:
    """Momentum refresh + fully tracked leapfrog (no exact eigh).

    ``normals`` (B, 2, N, 2) are the standard-normal momentum draws (scaled
    by √m here) and ``uniforms`` (B,) the accept draws; both come from
    ``generator`` when not given.  ``refine_iters``/``polish_iters`` > 0 add
    endpoint refinement (fast rotations, then rotations at
    ``polish_precision`` with a "highest" readout) so the tracked endpoint
    spectrum can serve as a cheap Metropolis anchor; those endpoint phases
    keep two Newton–Schulz steps and the carry dtype, as in the JAX package.
    """
    beta, J, mass = params.beta, params.J, params.mass
    rdt = state.evals.dtype
    dev = state.evals.device
    B = state.delta_re.shape[0]
    if normals is None or uniforms is None:
        if generator is None:
            raise ValueError("tracked_leapfrog needs generator= or the draws")
        n_draw, u_draw = draw_momenta(generator, (B, 2) + tuple(
            state.delta_re.shape[1:]), rdt, dev)
        normals = n_draw if normals is None else normals
        uniforms = u_draw if uniforms is None else uniforms
    normals = torch.as_tensor(normals, device=dev).to(rdt)
    uniforms = torch.as_tensor(uniforms, device=dev).to(torch.float32)
    scale = chain_view(torch.sqrt(mass).to(rdt), 3)
    pi_re0, pi_im0 = normals[:, 0] * scale, normals[:, 1] * scale

    Hs_real = static_hamiltonian(lat, params.t, params.tp, params.mu,
                                 state.disorder)
    dt = torch.as_tensor(dt, dtype=rdt, device=dev)
    dtv = chain_view(dt, 3)
    coef = chain_view(dt / (2.0 * mass), 3)

    F_re, F_im, _, _ = hmc_forces_real(
        lat, state.delta_re, state.delta_im, state.evals, state.X, state.Y,
        beta, J)
    pre = pi_re0 + 0.5 * dtv * F_re
    pim = pi_im0 + 0.5 * dtv * F_im

    dre, dim_, e, X, Y = (state.delta_re, state.delta_im, state.evals,
                          state.X, state.Y)
    res_all = []
    for _ in range(Nt):
        dre = _finite_or_zero(dre + coef * pre)
        dim_ = _finite_or_zero(dim_ + coef * pim)
        hr, hi = assemble_parts(lat, Hs_real, dre, dim_)
        e, X, Y, res = tracked_eigh_nofallback(hr, hi, X, Y,
                                               n_iter=tracked_iters,
                                               ns_steps=ns_steps,
                                               rot_dtype=rot_dtype,
                                               rot_scheme=rot_scheme)
        F_re, F_im, _, _ = hmc_forces_real(lat, dre, dim_, e, X, Y, beta, J)
        pre = pre + dtv * F_re
        pim = pim + dtv * F_im
        res_all.append(res)
    pre = pre - 0.5 * dtv * F_re
    pim = pim - 0.5 * dtv * F_im

    res_end = res_all[-1]
    if refine_iters > 0 or polish_iters > 0:
        hr, hi = assemble_parts(lat, Hs_real,
                                _finite_or_zero(dre), _finite_or_zero(dim_))
        if refine_iters > 0:
            e, X, Y, res_end = tracked_eigh_nofallback(
                hr, hi, X, Y, n_iter=refine_iters,
                eval_precision="highest" if polish_iters == 0 else None,
                eval_correction=polish_correction and polish_iters == 0,
                rot_scheme=rot_scheme)
        if polish_iters > 0:
            e, X, Y, res_end = tracked_eigh_nofallback(
                hr, hi, X, Y, n_iter=polish_iters,
                precision=polish_precision, eval_precision="highest",
                eval_correction=polish_correction, rot_scheme=rot_scheme)

    return Proposal(dre, dim_, pre, pim, pi_re0, pi_im0, uniforms,
                    torch.stack(res_all).amax(dim=0), e, X, Y, res_end)


def _metropolis(params, state, proposal, evals_n, finite):
    """Difference-based ΔH (all-levels/2 fermion form, any level order)
    and the float32 accept decision."""
    beta, J, mass = params.beta, params.J, params.mass
    p = proposal
    H_old = _energy_terms(state.delta_re, state.delta_im, p.pi_re0, p.pi_im0,
                          state.evals, beta, J, mass)
    d_kin = torch.sum(p.pi_re**2 + p.pi_im**2 - p.pi_re0**2 - p.pi_im0**2,
                      dim=(-2, -1)) / (2.0 * mass)
    d_bos = (beta / (2.0 * J)) * torch.sum(
        p.delta_re**2 + p.delta_im**2 - state.delta_re**2
        - state.delta_im**2, dim=(-2, -1))
    b2 = chain_view(beta, 2)
    En = torch.abs(evals_n)
    Eo = torch.abs(state.evals)
    d_fer = -0.5 * (beta * (torch.sum(En, -1) - torch.sum(Eo, -1))
                    + 2.0 * (torch.sum(softplus(-b2 * En), -1)
                             - torch.sum(softplus(-b2 * Eo), -1)))
    dH = d_kin + d_bos + d_fer
    accept = finite & ((dH < 0)
                       | (p.u < torch.exp(-dH.to(torch.float32))))
    return dH, accept, SweepInfo(accepted=accept, dH=dH, H_old=H_old,
                                 H_new=H_old + dH)


def _select(accept, new, old):
    return torch.where(chain_view(accept, new.ndim), new, old)


def tracked_accept_cheap(lat: LatticeSpec, params: ModelParams,
                         state: HMCStateReal, proposal: Proposal
                         ) -> tuple[HMCStateReal, SweepInfo]:
    """Cheap anchor: Metropolis from the refined tracked endpoint spectrum
    (no exact eigh)."""
    p = proposal
    finite = _all_finite(p.delta_re, p.delta_im, p.pi_re, p.pi_im, p.evals)
    dH, accept, info = _metropolis(params, state, p, _finite_or_zero(p.evals),
                                   finite)
    new_state = HMCStateReal(
        delta_re=_select(accept, _finite_or_zero(p.delta_re),
                         state.delta_re),
        delta_im=_select(accept, _finite_or_zero(p.delta_im),
                         state.delta_im),
        pi_re=_finite_or_zero(p.pi_re), pi_im=_finite_or_zero(p.pi_im),
        disorder=state.disorder,
        evals=_select(accept, _finite_or_zero(p.evals), state.evals),
        X=_select(accept, _finite_or_zero(p.X), state.X),
        Y=_select(accept, _finite_or_zero(p.Y), state.Y))
    return new_state, info


def tracked_accept(lat: LatticeSpec, params: ModelParams,
                   state: HMCStateReal, proposal: Proposal,
                   exact_solver: str = "qdwh"
                   ) -> tuple[HMCStateReal, SweepInfo]:
    """Exact anchor: exact embedding eigh of the proposal, difference-based
    ΔH, Metropolis select."""
    p = proposal
    finite = _all_finite(p.delta_re, p.delta_im, p.pi_re, p.pi_im)
    dre_s = _finite_or_zero(p.delta_re)
    dim_s = _finite_or_zero(p.delta_im)
    M_static = static_embedding(lat, params.t, params.tp, params.mu,
                                state.disorder)
    M = assemble_embedding(lat, M_static, dre_s, dim_s)
    evals_n, X_n, Y_n = _exact_diagonalize(M, exact_solver)
    dH, accept, info = _metropolis(params, state, p, evals_n, finite)
    new_state = HMCStateReal(
        delta_re=_select(accept, dre_s, state.delta_re),
        delta_im=_select(accept, dim_s, state.delta_im),
        pi_re=_finite_or_zero(p.pi_re), pi_im=_finite_or_zero(p.pi_im),
        disorder=state.disorder,
        evals=_select(accept, evals_n, state.evals),
        X=_select(accept, X_n, state.X), Y=_select(accept, Y_n, state.Y))
    return new_state, info
