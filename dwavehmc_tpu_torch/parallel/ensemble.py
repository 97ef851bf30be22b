"""Ensemble runner, real-pair tracked half (port of the tracked production
path of ``dwavehmc_tpu/parallel/ensemble.py``).

Chains are the leading dimension of every tensor, so one call of each
function advances the whole ensemble.  The JAX package splits a tracked
sweep into separately compiled programs and caps fused sweeps per program
(``_watchdog_chunk_caps``, ``max_fused``) to work around its TPU runtime;
PyTorch runs eagerly, so none of that is needed.  What those workarounds
protected stays: the anchor cadence (K−1 cheap sweeps, then one sweep with
an exact anchor), and a segment always ends on an exact anchor, so the
eigenpairs it hands to transport are exact.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.bdg_real import assemble_embedding, static_embedding
from ..models.lattice import LatticeSpec
from ..models.observables import ObservablesResult
from ..models.observables_real import measure_observables_real
from ..models.params import ModelParams, SpectralSpec
from ..models.transport import SpectrumResult
from ..models.transport_real import measure_transport_and_spectra_real
from ..sampler.hmc_real import (
    HMCStateReal,
    _exact_diagonalize,
    init_chain_state_real,
    tracked_accept,
    tracked_accept_cheap,
    tracked_leapfrog,
)


class SegmentResult(NamedTuple):
    """Per-sweep records of one segment: leaves (n_sweeps, n_chains)."""

    accepted: torch.Tensor
    dH: torch.Tensor
    observables: ObservablesResult | None


def init_ensemble_real(lat: LatticeSpec, params: ModelParams,
                       generator: torch.Generator | None, n_chains: int, *,
                       dtype=torch.float32, n_imp: float = 0.0,
                       exact_solver: str = "qdwh",
                       init_chunk: int | None = None,
                       disorder=None, delta0_re=None, delta0_im=None,
                       device="cuda") -> HMCStateReal:
    """``n_chains`` chains, each with its own disorder realization and Δ
    start, drawn from ``generator`` unless given.  ``init_chunk``:
    diagonalize the initial ensemble in sub-batches of this many chains to
    bound the eigensolver's workspace."""
    states = init_chain_state_real(
        lat, params, n_chains, generator=generator, dtype=dtype, n_imp=n_imp,
        delta0_re=delta0_re, delta0_im=delta0_im, disorder=disorder,
        exact_solver=exact_solver, diagonalize=False, device=device)
    M_static = static_embedding(lat, params.t, params.tp, params.mu,
                                states.disorder)
    M = assemble_embedding(lat, M_static, states.delta_re, states.delta_im)
    chunk = n_chains if init_chunk is None else max(1, init_chunk)
    parts = [_exact_diagonalize(M[i:i + chunk], exact_solver)
             for i in range(0, n_chains, chunk)]
    evals, X, Y = (torch.cat(xs) for xs in zip(*parts))
    return states._replace(evals=evals, X=X, Y=Y)


def _sweep_draws(normals, uniforms, i):
    return (None if normals is None else normals[i],
            None if uniforms is None else uniforms[i])


def run_segment_tracked(lat: LatticeSpec, params: ModelParams,
                        states: HMCStateReal, n_sweeps: int, Nt: int, dt,
                        measure: bool = True, tracked_iters: int = 6,
                        anchor_every: int = 1, refine_iters: int = 12,
                        polish_iters: int = 4, ns_steps: int = 2,
                        rot_dtype=None, exact_solver: str = "qdwh",
                        polish_precision: str = "highest",
                        polish_correction: bool = False,
                        rot_scheme: str = "ns", *,
                        generator: torch.Generator | None = None,
                        normals=None, uniforms=None
                        ) -> tuple[HMCStateReal, SegmentResult]:
    """``n_sweeps`` tracked sweeps over the ensemble.

    ``anchor_every`` = K: the exact embedding eigh anchors every K-th sweep;
    the K−1 sweeps in between accept on the refined tracked endpoint
    spectrum (``refine_iters`` fast + ``polish_iters`` "highest" rotations).
    A final short block still ends on an exact anchor.  ``dt`` is a scalar
    or a per-chain (B,) step.  Draws: ``normals`` (n_sweeps, B, 2, N, 2) and
    ``uniforms`` (n_sweeps, B), or else from ``generator``, sweep by sweep.
    """
    accs, dHs, obss = [], [], []

    def sweep(states, i, cheap):
        n, u = _sweep_draws(normals, uniforms, i)
        prop = tracked_leapfrog(
            lat, params, states, Nt, dt, tracked_iters,
            refine_iters if cheap else 0, polish_iters if cheap else 0,
            ns_steps, rot_dtype, polish_precision, polish_correction,
            rot_scheme, normals=n, uniforms=u, generator=generator)
        if cheap:
            states, info = tracked_accept_cheap(lat, params, states, prop)
        else:
            states, info = tracked_accept(lat, params, states, prop,
                                          exact_solver)
        accs.append(info.accepted)
        dHs.append(info.dH)
        if measure:
            obss.append(measure_observables_real(lat, params, states))
        return states

    K = max(1, anchor_every)
    done = 0
    while done < n_sweeps:
        k = min(K, n_sweeps - done)        # k−1 cheap + 1 anchored
        for j in range(k):
            states = sweep(states, done + j, cheap=j < k - 1)
        done += k

    obs = (ObservablesResult(*(torch.stack(xs) for xs in zip(*obss)))
           if measure else None)
    return states, SegmentResult(accepted=torch.stack(accs),
                                 dH=torch.stack(dHs), observables=obs)


def ensemble_transport_real(lat: LatticeSpec, spec: SpectralSpec,
                            params: ModelParams,
                            states: HMCStateReal) -> SpectrumResult:
    """Heavy measurement on every chain (leaves have a leading chain dim)."""
    return measure_transport_and_spectra_real(lat, spec, params, states)
