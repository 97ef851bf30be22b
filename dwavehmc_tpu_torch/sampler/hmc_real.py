"""Complex-free HMC sweeps (port of ``dwavehmc_tpu/sampler/hmc_real.py``)
over a leading chain dimension: the split tracked sweep (leapfrog, then a
cheap or an exact accept) and the untracked ``hmc_sweep_real``.

Random draws come from an explicit ``torch.Generator``; every function that
draws also takes its draws as arguments (``normals``, ``uniforms``,
``disorder``, ``delta0_re``/``delta0_im``) so that tests can hand in the
JAX package's draws.

Leapfrog conventions: π refresh Re π, Im π ~ N(0, m); Δ += dt·π/(2m);
kicks half, (Nt−1) full, half.  Accept: ΔH < 0 or u < exp(−ΔH) compared in
float32; a non-finite proposal is rejected and zeroed.  The energies' sums
over the fields and the levels go through K3 (``ops/kernels.chain_sum``),
whose order does not depend on the batch: a chain gets the same ΔH alone
as inside any batch.
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
from ..models.params import (
    HMCState,
    ModelParams,
    chain_view,
    init_delta,
    sample_disorder,
)
from ..ops.forces_real import hmc_forces_real
from ..ops.kernels import chain_sum
from ..ops.ph_eigh import diagonalize_embedding_ph
from ..ops.spectral import softplus
from ..ops.tracked_eigh import hop_table, tracked_eigh_nofallback
from ..utils.device import resolve_device
from ..utils.profiling import span, spanned, sync_span
from .hmc import SweepInfo, _finite_or_zero, sweep_draws


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


def from_complex_state(state: HMCState) -> HMCStateReal:
    """The real-pair layout of a complex-path ``HMCState``."""
    return HMCStateReal(
        delta_re=state.delta.real, delta_im=state.delta.imag,
        pi_re=state.pi.real, pi_im=state.pi.imag,
        disorder=state.disorder, evals=state.evals,
        X=state.evecs.real, Y=state.evecs.imag)


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
    """Anchor/init eigensolver switch: "qdwh" = ``torch.linalg.eigh`` on the
    full embedding, "ph" = the PH-split half-dimension solver
    (``ops/ph_eigh.diagonalize_embedding_ph``, unguarded)."""
    if solver == "ph":
        return diagonalize_embedding_ph(M)
    if solver != "qdwh":
        raise ValueError(f"exact_solver={solver!r}: expected 'qdwh' or 'ph'")
    return diagonalize_embedding(M)


def draw_init_state(lat: LatticeSpec, params: ModelParams, n_chains: int,
                    *, generator: torch.Generator | None = None,
                    dtype=torch.float32, n_imp: float | None = None,
                    delta0_re=None, delta0_im=None, disorder=None,
                    device="cuda"):
    """(disorder (B, N), Δ_re, Δ_im (B, N, 2)) of B chains on ``device``.
    Missing draws come from ``generator``: the disorder permutations first,
    then the Δ uniforms of ``models/params.init_delta``."""
    device = resolve_device(device)
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
        d0 = init_delta(lat, n_chains, generator=generator, dtype=dtype,
                        device=device)
        delta0_re, delta0_im = d0.real.contiguous(), d0.imag.contiguous()
    delta0_re = torch.as_tensor(delta0_re, device=device).to(dtype)
    delta0_im = (torch.zeros_like(delta0_re) if delta0_im is None
                 else torch.as_tensor(delta0_im, device=device).to(dtype))
    return disorder, delta0_re, delta0_im


def init_chain_state_real(lat: LatticeSpec, params: ModelParams,
                          n_chains: int, *,
                          generator: torch.Generator | None = None,
                          dtype=torch.float32, n_imp: float | None = None,
                          delta0_re=None, delta0_im=None, disorder=None,
                          exact_solver: str = "qdwh",
                          diagonalize: bool = True,
                          device="cuda") -> HMCStateReal:
    """B chains with disorder, a small random Δ start (``draw_init_state``)
    and matching exact eigenpairs.  ``diagonalize=False`` leaves the
    eigenpairs zero."""
    device = resolve_device(device)
    disorder, delta0_re, delta0_im = draw_init_state(
        lat, params, n_chains, generator=generator, dtype=dtype, n_imp=n_imp,
        delta0_re=delta0_re, delta0_im=delta0_im, disorder=disorder,
        device=device)

    dim = 2 * lat.n_sites
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


def _chain_sum(x):
    """Σ over every axis but the chain axis, in one order whatever the
    batch (K3, ``ops/kernels.chain_sum``)."""
    return chain_sum(x.reshape(x.shape[0], -1))


def _energy_terms(delta_re, delta_im, pi_re, pi_im, evals, beta, J, mass):
    """Per-chain H_HMC, fermion term in the PH-even all-levels/2 form
    (valid for an unsorted spectrum)."""
    kin = _chain_sum(pi_re**2 + pi_im**2) / (2.0 * mass)
    bos = (beta / (2.0 * J)) * _chain_sum(delta_re**2 + delta_im**2)
    x = chain_view(beta, 2) * torch.abs(evals)
    fer = -0.5 * _chain_sum(x + 2.0 * softplus(-x))
    return kin + bos + fer


def _all_finite(*xs):
    out = None
    for x in xs:
        f = torch.isfinite(x).flatten(1).all(dim=1)
        out = f if out is None else out & f
    return out


def _refresh(params: ModelParams, state: HMCStateReal, normals, uniforms,
             generator: torch.Generator | None, caller: str):
    """(π_re0, π_im0, accept uniforms) of one sweep: the given standard
    normals (B, 2, N, 2) scaled by √m and uniforms (B,), each drawn from
    ``generator`` when not given."""
    rdt = state.evals.dtype
    normals, uniforms = sweep_draws(
        normals, uniforms, generator,
        (state.delta_re.shape[0], 2) + tuple(state.delta_re.shape[1:]), rdt,
        state.evals.device, caller)
    scale = chain_view(torch.sqrt(params.mass).to(rdt), 3)
    return normals[:, 0] * scale, normals[:, 1] * scale, uniforms


def device_step(dt, like: torch.Tensor) -> torch.Tensor:
    """The leapfrog step ``dt`` (a number, or per chain) as a tensor of
    ``like``'s dtype on its device: a number is filled there, which the
    host does not wait for; data on the host is copied from pageable
    memory, which waits for the stream, one host sync."""
    if isinstance(dt, torch.Tensor) and dt.device == like.device:
        return dt.to(like.dtype)
    if isinstance(dt, (int, float)):
        return torch.full((), float(dt), dtype=like.dtype, device=like.device)
    with sync_span("leapfrog_dt"):
        return torch.as_tensor(dt, dtype=like.dtype, device=like.device)


@spanned("dwavehmc.leapfrog")
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
    ``polish_precision="high"`` runs the polish rotations' products as
    three TF32 passes on the card; their eigenvalue readout stays IEEE
    ("highest").  Every tracked solve gets H's K6 table, so its float32
    IEEE products by H go through K6 (``ops/tracked_eigh._h_times``).
    """
    beta, J, mass = params.beta, params.J, params.mass
    dev = state.evals.device
    pi_re0, pi_im0, uniforms = _refresh(params, state, normals, uniforms,
                                        generator, "tracked_leapfrog")

    Hs_real = static_hamiltonian(lat, params.t, params.tp, params.mu,
                                 state.disorder)
    hop = hop_table(lat, dev)
    dt = device_step(dt, state.evals)
    dtv = chain_view(dt, 3)
    coef = chain_view(dt / (2.0 * mass), 3)

    with span("dwavehmc.forces"):
        F_re, F_im, _, _ = hmc_forces_real(
            lat, state.delta_re, state.delta_im, state.evals, state.X,
            state.Y, beta, J)
    pre = pi_re0 + 0.5 * dtv * F_re
    pim = pi_im0 + 0.5 * dtv * F_im

    dre, dim_, e, X, Y = (state.delta_re, state.delta_im, state.evals,
                          state.X, state.Y)
    res_all = []
    for _ in range(Nt):
        dre = _finite_or_zero(dre + coef * pre)
        dim_ = _finite_or_zero(dim_ + coef * pim)
        hr, hi = assemble_parts(lat, Hs_real, dre, dim_)
        with span("dwavehmc.tracked_eigh"):
            e, X, Y, res = tracked_eigh_nofallback(hr, hi, X, Y,
                                                   n_iter=tracked_iters,
                                                   ns_steps=ns_steps,
                                                   rot_dtype=rot_dtype,
                                                   rot_scheme=rot_scheme,
                                                   hop=hop)
        with span("dwavehmc.forces"):
            F_re, F_im, _, _ = hmc_forces_real(lat, dre, dim_, e, X, Y,
                                               beta, J)
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
            with span("dwavehmc.tracked_eigh"):
                e, X, Y, res_end = tracked_eigh_nofallback(
                    hr, hi, X, Y, n_iter=refine_iters,
                    eval_precision="highest" if polish_iters == 0 else None,
                    eval_correction=polish_correction and polish_iters == 0,
                    rot_scheme=rot_scheme, hop=hop)
        if polish_iters > 0:
            with span("dwavehmc.tracked_eigh"):
                e, X, Y, res_end = tracked_eigh_nofallback(
                    hr, hi, X, Y, n_iter=polish_iters,
                    precision=polish_precision, eval_precision="highest",
                    eval_correction=polish_correction,
                    rot_scheme=rot_scheme, hop=hop)

    return Proposal(dre, dim_, pre, pim, pi_re0, pi_im0, uniforms,
                    torch.stack(res_all).amax(dim=0), e, X, Y, res_end)


def _metropolis(params, state, proposal, evals_n, finite, dH_host=None):
    """Difference-based ΔH (all-levels/2 fermion form, any level order)
    and the float32 accept decision.  ``dH_host`` replaces the device ΔH
    (cast to float32) in the decision and the record."""
    beta, J, mass = params.beta, params.J, params.mass
    p = proposal
    H_old = _energy_terms(state.delta_re, state.delta_im, p.pi_re0, p.pi_im0,
                          state.evals, beta, J, mass)
    d_kin = _chain_sum(p.pi_re**2 + p.pi_im**2 - p.pi_re0**2
                       - p.pi_im0**2) / (2.0 * mass)
    d_bos = (beta / (2.0 * J)) * _chain_sum(
        p.delta_re**2 + p.delta_im**2 - state.delta_re**2
        - state.delta_im**2)
    b2 = chain_view(beta, 2)
    En = torch.abs(evals_n)
    Eo = torch.abs(state.evals)
    d_fer = -0.5 * (beta * (_chain_sum(En) - _chain_sum(Eo))
                    + 2.0 * (_chain_sum(softplus(-b2 * En))
                             - _chain_sum(softplus(-b2 * Eo))))
    dH = d_kin + d_bos + d_fer
    if dH_host is not None:
        dH = torch.as_tensor(dH_host, device=dH.device).to(torch.float32)
    accept = finite & ((dH < 0)
                       | (p.u < torch.exp(-dH.to(torch.float32))))
    return dH, accept, SweepInfo(accepted=accept, dH=dH, H_old=H_old,
                                 H_new=H_old + dH)


def _select(accept, new, old):
    return torch.where(chain_view(accept, new.ndim), new, old)


@spanned("dwavehmc.accept_cheap")
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


def proposal_embedding(lat: LatticeSpec, params: ModelParams,
                       state: HMCStateReal, proposal: Proposal
                       ) -> torch.Tensor:
    """The embedding M (B, 4N, 4N) of the proposal's NaN-zeroed Δ."""
    M_static = static_embedding(lat, params.t, params.tp, params.mu,
                                state.disorder)
    return assemble_embedding(lat, M_static,
                              _finite_or_zero(proposal.delta_re),
                              _finite_or_zero(proposal.delta_im))


def tracked_accept(lat: LatticeSpec, params: ModelParams,
                   state: HMCStateReal, proposal: Proposal,
                   exact_solver: str = "qdwh", dH_host=None,
                   finite_host=None, eig_new=None
                   ) -> tuple[HMCStateReal, SweepInfo]:
    """Exact anchor: exact embedding eigh of the proposal, difference-based
    ΔH, Metropolis select.

    ``dH_host`` (B,) with ``finite_host`` (B,) bool: the host float64 ΔH
    (``ops/host_energy.py``), which replaces the device ΔH, cast to
    float32, in the decision; a chain is accepted only if ``finite_host``
    holds too.  The exact eigh still runs, so an accepted state carries
    anchor-grade eigenpairs.  ``eig_new``: precomputed ``(evals, X, Y)`` of
    the proposal's (NaN-zeroed) embedding, which skips the internal
    diagonalization (the guarded PH anchor of
    ``parallel/ensemble.run_segment_tracked``)."""
    p = proposal
    finite = _all_finite(p.delta_re, p.delta_im, p.pi_re, p.pi_im)
    if finite_host is not None:
        finite = finite & torch.as_tensor(finite_host, device=finite.device)
    dre_s = _finite_or_zero(p.delta_re)
    dim_s = _finite_or_zero(p.delta_im)
    if eig_new is not None:
        evals_n, X_n, Y_n = eig_new
    else:
        M = proposal_embedding(lat, params, state, p)
        evals_n, X_n, Y_n = _exact_diagonalize(M, exact_solver)
    dH, accept, info = _metropolis(params, state, p, evals_n, finite,
                                   dH_host)
    new_state = HMCStateReal(
        delta_re=_select(accept, dre_s, state.delta_re),
        delta_im=_select(accept, dim_s, state.delta_im),
        pi_re=_finite_or_zero(p.pi_re), pi_im=_finite_or_zero(p.pi_im),
        disorder=state.disorder,
        evals=_select(accept, evals_n, state.evals),
        X=_select(accept, X_n, state.X), Y=_select(accept, Y_n, state.Y))
    return new_state, info


def hmc_sweep_real(lat: LatticeSpec, params: ModelParams,
                   state: HMCStateReal, Nt: int, dt,
                   eigh_mode: str = "exact", tracked_iters: int = 6, *,
                   normals=None, uniforms=None,
                   generator: torch.Generator | None = None
                   ) -> tuple[HMCStateReal, SweepInfo]:
    """One untracked-path HMC trajectory + Metropolis for every chain.

    ``eigh_mode``:
      * "exact"   — every leapfrog step runs the exact embedding eigh;
      * "tracked" — leapfrog steps refine the carried eigenbasis with
        ``tracked_iters`` tracked rotations, and ONE exact eigh at the
        trajectory end re-anchors it and supplies the Metropolis energies.

    Draws as in ``tracked_leapfrog``.  ΔH uses the upper half of the sorted
    spectra (Σ over E > 0), and a proposal is not NaN-guarded, exactly as
    the JAX package's ``hmc_sweep_real``."""
    if eigh_mode not in ("exact", "tracked"):
        raise ValueError(f"eigh_mode={eigh_mode!r}: expected 'exact' or "
                         "'tracked'")
    beta, J, mass = params.beta, params.J, params.mass
    pi_re0, pi_im0, u = _refresh(params, state, normals, uniforms, generator,
                                 "hmc_sweep_real")

    H_old = _energy_terms(state.delta_re, state.delta_im, pi_re0, pi_im0,
                          state.evals, beta, J, mass)
    tracked = eigh_mode == "tracked"
    if tracked:
        Hs_real = static_hamiltonian(lat, params.t, params.tp, params.mu,
                                     state.disorder)
    M_static = static_embedding(lat, params.t, params.tp, params.mu,
                                state.disorder)
    dt = device_step(dt, state.evals)
    dtv = chain_view(dt, 3)
    coef = chain_view(dt / (2.0 * mass), 3)

    F_re, F_im, _, _ = hmc_forces_real(
        lat, state.delta_re, state.delta_im, state.evals, state.X, state.Y,
        beta, J)
    pre = pi_re0 + 0.5 * dtv * F_re
    pim = pi_im0 + 0.5 * dtv * F_im
    dre, dim_, evals_n, X_n, Y_n = (state.delta_re, state.delta_im,
                                    state.evals, state.X, state.Y)
    for _ in range(Nt):
        dre = _finite_or_zero(dre + coef * pre)
        dim_ = _finite_or_zero(dim_ + coef * pim)
        if tracked:
            hr, hi = assemble_parts(lat, Hs_real, dre, dim_)
            evals_n, X_n, Y_n, _ = tracked_eigh_nofallback(
                hr, hi, X_n, Y_n, n_iter=tracked_iters)
        else:
            evals_n, X_n, Y_n = diagonalize_embedding(
                assemble_embedding(lat, M_static, dre, dim_))
        F_re, F_im, _, _ = hmc_forces_real(lat, dre, dim_, evals_n, X_n,
                                           Y_n, beta, J)
        pre = pre + dtv * F_re
        pim = pim + dtv * F_im
    pre = pre - 0.5 * dtv * F_re
    pim = pim - 0.5 * dtv * F_im

    if tracked:
        # re-anchor: exact spectrum at the trajectory end
        evals_n, X_n, Y_n = diagonalize_embedding(
            assemble_embedding(lat, M_static, dre, dim_))

    d_kin = _chain_sum(pre**2 + pim**2 - pi_re0**2 - pi_im0**2) / (2.0 * mass)
    d_bos = (beta / (2.0 * J)) * _chain_sum(
        dre**2 + dim_**2 - state.delta_re**2 - state.delta_im**2)
    half = evals_n.shape[-1] // 2
    b2 = chain_view(beta, 2)
    En = torch.abs(evals_n[..., half:])
    Eo = torch.abs(state.evals[..., half:])
    d_fer = -(beta * _chain_sum(En - Eo)
              + 2.0 * _chain_sum(softplus(-b2 * En) - softplus(-b2 * Eo)))
    dH = d_kin + d_bos + d_fer
    accept = (dH < 0) | (u < torch.exp(-dH.to(torch.float32)))
    new_state = HMCStateReal(
        delta_re=_select(accept, dre, state.delta_re),
        delta_im=_select(accept, dim_, state.delta_im),
        pi_re=pre, pi_im=pim, disorder=state.disorder,
        evals=_select(accept, evals_n, state.evals),
        X=_select(accept, X_n, state.X), Y=_select(accept, Y_n, state.Y))
    return new_state, SweepInfo(accepted=accept, dH=dH, H_old=H_old,
                                H_new=H_old + dH)
