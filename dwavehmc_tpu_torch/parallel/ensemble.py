"""Ensemble runner (port of ``dwavehmc_tpu/parallel/ensemble.py``): the
complex path (``init_ensemble``, ``run_segment``, ``ensemble_transport``),
and on the real-pair path the tracked production segment, the tracked
segment with the host float64 Metropolis readout (``run_segment_hostacc``)
and the untracked ``run_segment_real``.

Chains are the leading dimension of every tensor, so one call of each
function advances the whole ensemble, or this rank's block of it.  The
counterpart of the JAX package's ``mesh=``/``shard_ensemble``: the inits
take ``rows=``, draw the global ensemble's disorder and Δ in the
one-process order and keep (and diagonalize) only those rows, and
``RowDraws`` hands a segment runner its rows of each sweep's global draws
(``parallel/mesh.py``).  The JAX package splits a tracked
sweep into separately compiled programs and caps fused sweeps per program
(``_watchdog_chunk_caps``, ``max_fused``) to work around its TPU runtime;
PyTorch runs eagerly, so none of that is needed.  What those workarounds
protected stays: the anchor cadence (K−1 cheap sweeps, then one sweep with
an exact anchor), and a segment always ends on an exact anchor, so the
eigenpairs it hands to transport are exact.  On a CUDA device a small
batch's cheap sweep is replayed as one CUDA graph (``cheap_graph.py``);
the anchored sweep, whose guard reads the host, stays eager.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import numpy as np
import torch

from ..models.bdg_real import assemble_embedding, static_embedding
from ..models.lattice import LatticeSpec
from ..models.observables import ObservablesResult, measure_observables
from ..models.observables_real import measure_observables_real
from ..models.params import HMCState, ModelParams, SpectralSpec
from ..models.transport import SpectrumResult, measure_transport_and_spectra
from ..models.transport_real import measure_transport_and_spectra_real
from ..ops import host_energy
from ..ops.ph_eigh import diagonalize_embedding_ph_guarded
from ..sampler.hmc import SweepInfo, draw_momenta, hmc_sweep, init_chain_state
from ..sampler.hmc_real import (
    HMCStateReal,
    _exact_diagonalize,
    device_step,
    draw_init_state,
    hmc_sweep_real,
    init_chain_state_real,
    proposal_embedding,
    tracked_accept,
    tracked_leapfrog,
)
from ..utils.profiling import span, spanned
from .cheap_graph import CheapSpec, cheap_sweep


class SegmentResult(NamedTuple):
    """Per-sweep records of one segment: leaves (n_sweeps, n_chains)."""

    accepted: torch.Tensor
    dH: torch.Tensor
    observables: ObservablesResult | None


def _keep_rows(rows, lat, params, generator, n_chains, dtype, n_imp,
               disorder, delta0_re, delta0_im, device):
    """(disorder, Δ_re, Δ_im) of chains ``rows`` of an ``n_chains``
    ensemble, drawn as ``draw_init_state`` draws the whole ensemble."""
    d, re, im = draw_init_state(lat, params, n_chains, generator=generator,
                                dtype=dtype, n_imp=n_imp, delta0_re=delta0_re,
                                delta0_im=delta0_im, disorder=disorder,
                                device=device)
    idx = torch.as_tensor(np.asarray(rows), device=d.device)
    return d[idx], re[idx], im[idx]


def init_ensemble(lat: LatticeSpec, params: ModelParams,
                  generator: torch.Generator | None, n_chains: int, *,
                  dtype=torch.float32, n_imp: float = 0.0, delta0=None,
                  disorder=None, rows=None, device="cuda") -> HMCState:
    """``n_chains`` complex-path chains, each with its own disorder
    realization and Δ start, drawn from ``generator`` unless given.
    ``rows`` (indices, repeats allowed): keep only those chains of the
    ``n_chains`` drawn."""
    if rows is not None:
        d0 = None if delta0 is None else torch.as_tensor(delta0)
        disorder, re, im = _keep_rows(
            rows, lat, params, generator, n_chains, dtype, n_imp, disorder,
            None if d0 is None else d0.real, None if d0 is None else d0.imag,
            device)
        delta0, n_chains = torch.complex(re, im), len(rows)
    return init_chain_state(lat, params, n_chains, generator=generator,
                            dtype=dtype, n_imp=n_imp, delta0=delta0,
                            disorder=disorder, device=device)


def ensemble_sweep(lat: LatticeSpec, params: ModelParams, states: HMCState,
                   Nt: int, dt, *, generator: torch.Generator | None = None,
                   normals=None, uniforms=None
                   ) -> tuple[HMCState, SweepInfo]:
    """One complex-path HMC sweep on every chain: ``params`` and ``dt`` are
    0-d or per-chain (B,)."""
    return hmc_sweep(lat, params, states, Nt, dt, normals=normals,
                     uniforms=uniforms, generator=generator)


def run_segment(lat: LatticeSpec, params: ModelParams, states: HMCState,
                n_sweeps: int, Nt: int, dt, *, measure: bool = True,
                generator: torch.Generator | None = None,
                normals=None, uniforms=None
                ) -> tuple[HMCState, SegmentResult]:
    """``n_sweeps`` complex-path sweeps over the ensemble; draws as in
    ``run_segment_tracked``."""
    accs, dHs, obss = [], [], []
    for i in range(n_sweeps):
        n, u = _sweep_draws(normals, uniforms, i)
        states, info = ensemble_sweep(lat, params, states, Nt, dt,
                                      generator=generator, normals=n,
                                      uniforms=u)
        accs.append(info.accepted)
        dHs.append(info.dH)
        if measure:
            obss.append(measure_observables(lat, params, states))
    return states, _segment_result(accs, dHs, obss, measure)


def ensemble_transport(lat: LatticeSpec, spec: SpectralSpec,
                       params: ModelParams,
                       states: HMCState) -> SpectrumResult:
    """Complex-path heavy measurement on every chain."""
    return measure_transport_and_spectra(lat, spec, params, states)


def _batch_eigs(M: torch.Tensor, exact_solver: str, vote=None):
    """Eigenpairs of a batch of embeddings, for the init and the exact
    anchors: "ph" is one floor-guarded PH solve of the whole batch (a chain
    below the solver's floor sends the batch to the full eigh;
    ``ops/ph_eigh.GUARD`` counts both; ``vote`` as there), "qdwh" the
    full-embedding eigh."""
    if exact_solver == "ph":
        return diagonalize_embedding_ph_guarded(M, vote=vote)[:3]
    return _exact_diagonalize(M, exact_solver)


def init_ensemble_real(lat: LatticeSpec, params: ModelParams,
                       generator: torch.Generator | None, n_chains: int, *,
                       dtype=torch.float32, n_imp: float = 0.0,
                       exact_solver: str = "qdwh",
                       init_chunk: int | None = None,
                       disorder=None, delta0_re=None, delta0_im=None,
                       rows=None, vote=None,
                       device="cuda") -> HMCStateReal:
    """``n_chains`` chains, each with its own disorder realization and Δ
    start, drawn from ``generator`` unless given.  ``init_chunk``:
    assemble and diagonalize the initial ensemble in sub-batches of this
    many chains to bound the embedding's and the eigensolver's memory;
    each sub-batch is one
    ``_batch_eigs`` call (a cold random-Δ spectrum is where near-zero
    levels can sit under the PH solver's floor).  ``rows`` (indices,
    repeats allowed): keep, and diagonalize, only those chains of the
    ``n_chains`` drawn; ``vote`` (one bool per kept chain) as in
    ``ops/ph_eigh.diagonalize_embedding_ph_guarded``."""
    if rows is not None:
        disorder, delta0_re, delta0_im = _keep_rows(
            rows, lat, params, generator, n_chains, dtype, n_imp, disorder,
            delta0_re, delta0_im, device)
        n_chains = len(rows)
    states = init_chain_state_real(
        lat, params, n_chains, generator=generator, dtype=dtype, n_imp=n_imp,
        delta0_re=delta0_re, delta0_im=delta0_im, disorder=disorder,
        exact_solver=exact_solver, diagonalize=False, device=device)
    chunk = n_chains if init_chunk is None else max(1, init_chunk)

    def embedding(rows: slice) -> torch.Tensor:
        # one sub-batch's embedding at a time: at 32×32 the whole
        # ensemble's would be 4096² floats per chain
        pick = lambda x: x[rows] if x.ndim else x  # noqa: E731
        M_static = static_embedding(lat, pick(params.t), pick(params.tp),
                                    pick(params.mu), states.disorder[rows])
        return assemble_embedding(lat, M_static, states.delta_re[rows],
                                  states.delta_im[rows])

    parts = [_batch_eigs(embedding(slice(i, i + chunk)), exact_solver,
                         None if vote is None else vote[i:i + chunk])
             for i in range(0, n_chains, chunk)]
    evals, X, Y = (torch.cat(xs) for xs in zip(*parts))
    return states._replace(evals=evals, X=X, Y=Y)


def _sweep_draws(normals, uniforms, i):
    return (None if normals is None else normals[i],
            None if uniforms is None else uniforms[i])


class RowDraws:
    """One rank's rows of each sweep's draws.  Sweep i draws the standard
    normals (n_draw, 2, N, 2) and float32 uniforms (n_draw,) of a batch of
    ``n_draw`` chains from ``generator`` exactly as a segment runner draws
    them for that batch (``sampler/hmc.draw_momenta``), and keeps the
    chains ``rows``: so every rank consumes the generator as the
    one-process run does, and each of its chains gets the draws it gets
    there.  ``normals``/``uniforms`` go to a runner's arguments of those
    names; the runner reads sweep i's normals, then its uniforms, sweep
    after sweep."""

    class _Column:
        def __init__(self, owner, k):
            self.owner, self.k = owner, k

        def __getitem__(self, i):
            return self.owner.sweep(i)[self.k]

    def __init__(self, generator: torch.Generator, n_draw: int, tail: tuple,
                 dtype, rows, device):
        self.generator, self.shape = generator, (n_draw, *tail)
        self.dtype, self.device = dtype, device
        self.rows = torch.as_tensor(np.asarray(rows), device=device)
        self._i, self._cur = -1, None
        self.normals, self.uniforms = self._Column(self, 0), \
            self._Column(self, 1)

    def sweep(self, i: int):
        if i != self._i:
            if i != self._i + 1:
                raise IndexError(f"draws of sweep {i} asked after sweep "
                                 f"{self._i}: sweeps are drawn in order")
            n, u = draw_momenta(self.generator, self.shape, self.dtype,
                                self.device)
            self._i, self._cur = i, (n[self.rows], u[self.rows])
        return self._cur


class DrawStream:
    """Every sweep's draws of one ensemble, kept so that a later segment
    can take them again.  Sweep i's standard normals (B, 2, N, 2) and
    float32 accept uniforms (B,) are drawn from ``generator`` once, in
    sweep order (``sampler/hmc.draw_momenta``, as a segment runner draws
    them), unless given as ``normals`` (n, B, 2, N, 2) and ``uniforms``
    (n, B), as a test hands in the JAX run's.  ``take(start, n)`` returns
    sweeps [start, start + n) stacked, for a runner's ``normals`` and
    ``uniforms``: two segments that start from the same sweep take the same
    draws, as two JAX segments started from the same per-chain keys do."""

    def __init__(self, generator: torch.Generator | None, shape: tuple,
                 dtype, device, normals=None, uniforms=None):
        self.generator, self.shape = generator, tuple(shape)
        self.dtype, self.device = dtype, device
        self.normals = ([] if normals is None else list(
            torch.as_tensor(normals).to(device=device, dtype=dtype)))
        self.uniforms = ([] if uniforms is None else list(
            torch.as_tensor(uniforms).to(device=device,
                                         dtype=torch.float32)))

    def take(self, start: int, n: int) -> tuple[torch.Tensor, torch.Tensor]:
        while len(self.normals) < start + n:
            if self.generator is None:
                raise IndexError(f"sweeps [{start}, {start + n}) asked of "
                                 f"{len(self.normals)} given draws")
            nrm, u = draw_momenta(self.generator, self.shape, self.dtype,
                                  self.device)
            self.normals.append(nrm)
            self.uniforms.append(u)
        if n == 0:
            return (torch.empty((0, *self.shape), dtype=self.dtype,
                                device=self.device),
                    torch.empty((0, self.shape[0]), device=self.device))
        return (torch.stack(self.normals[start:start + n]),
                torch.stack(self.uniforms[start:start + n]))


@spanned("dwavehmc.anchor")
def tracked_accept_exact(lat: LatticeSpec, params: ModelParams,
                         states: HMCStateReal, proposal,
                         exact_solver: str = "qdwh", vote=None
                         ) -> tuple[HMCStateReal, SweepInfo]:
    """The exact anchor of a tracked sweep: ``tracked_accept`` with the
    proposals' eigenpairs from one ``_batch_eigs`` call ("ph": the guarded
    PH solve of the whole batch).  It reads the proposal's accept uniforms,
    as ``tracked_accept_cheap`` does, so both accepts of one proposal take
    the same draw."""
    eig_new = _batch_eigs(proposal_embedding(lat, params, states, proposal),
                          exact_solver, vote)
    return tracked_accept(lat, params, states, proposal, eig_new=eig_new)


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
                        normals=None, uniforms=None, vote=None
                        ) -> tuple[HMCStateReal, SegmentResult]:
    """``n_sweeps`` tracked sweeps over the ensemble.

    ``anchor_every`` = K: the exact embedding eigh anchors every K-th sweep;
    the K−1 sweeps in between accept on the refined tracked endpoint
    spectrum (``refine_iters`` fast + ``polish_iters`` "highest" rotations).
    A final short block still ends on an exact anchor, one ``_batch_eigs``
    call of the proposals' embeddings.  ``dt`` is a scalar
    or a per-chain (B,) step, made a device tensor once a segment.  Draws:
    ``normals`` (n_sweeps, B, 2, N, 2) and ``uniforms`` (n_sweeps, B), or
    else from ``generator``, sweep by sweep.  ``vote``: the guarded
    anchor's (``_batch_eigs``).  A cheap sweep goes through
    ``cheap_graph.cheap_sweep``: one CUDA-graph replay for a small batch on
    the card, with the eager sweep's bits.
    """
    accs, dHs, obss = [], [], []
    dt = device_step(dt, states.evals)
    spec = CheapSpec(Nt, tracked_iters, refine_iters, polish_iters, ns_steps,
                     rot_dtype, polish_precision, polish_correction,
                     rot_scheme)

    @spanned("dwavehmc.sweep")
    def sweep(states, i, cheap):
        n, u = _sweep_draws(normals, uniforms, i)
        if cheap:
            states, accepted, dH = cheap_sweep(lat, spec, params, states, dt,
                                               n, u, generator)
        else:
            prop = tracked_leapfrog(
                lat, params, states, Nt, dt, tracked_iters, 0, 0, ns_steps,
                rot_dtype, polish_precision, polish_correction, rot_scheme,
                normals=n, uniforms=u, generator=generator)
            states, info = tracked_accept_exact(lat, params, states, prop,
                                                exact_solver, vote)
            accepted, dH = info.accepted, info.dH
        accs.append(accepted)
        dHs.append(dH)
        if measure:
            with span("dwavehmc.observables"):
                obss.append(measure_observables_real(lat, params, states))
        return states

    K = max(1, anchor_every)
    done = 0
    while done < n_sweeps:
        k = min(K, n_sweeps - done)        # k−1 cheap + 1 anchored
        for j in range(k):
            states = sweep(states, done + j, cheap=j < k - 1)
        done += k

    return states, _segment_result(accs, dHs, obss, measure)


def run_segment_real(lat: LatticeSpec, params: ModelParams,
                     states: HMCStateReal, n_sweeps: int, Nt: int, dt, *,
                     measure: bool = True, eigh_mode: str = "exact",
                     tracked_iters: int = 6,
                     generator: torch.Generator | None = None,
                     normals=None, uniforms=None
                     ) -> tuple[HMCStateReal, SegmentResult]:
    """``n_sweeps`` untracked-path sweeps (``hmc_sweep_real``) over the
    ensemble; draws as in ``run_segment_tracked``."""
    accs, dHs, obss = [], [], []
    for i in range(n_sweeps):
        n, u = _sweep_draws(normals, uniforms, i)
        states, info = hmc_sweep_real(lat, params, states, Nt, dt, eigh_mode,
                                      tracked_iters, normals=n, uniforms=u,
                                      generator=generator)
        accs.append(info.accepted)
        dHs.append(info.dH)
        if measure:
            obss.append(measure_observables_real(lat, params, states))
    return states, _segment_result(accs, dHs, obss, measure)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _hostacc_fingerprint(params: ModelParams, disorder, delta_re,
                         delta_im) -> str:
    """Identity and state fingerprint of the host readout's potential
    cache (numpy inputs).

    Disorder alone is not enough: on a clean lattice every equal-sized
    chain subset has the same all-zeros disorder, and the scan's bucketed
    thermalization hands different subsets, at different β, through one
    cache.  So the Δ bytes and every per-chain coupling are hashed too, as
    in the JAX package; all are stable across back-to-back segments of the
    same chains, so the cache still carries over."""
    h = hashlib.sha1()
    h.update(b"ax0" if params.beta.ndim == 1 else b"axN")
    for a in (disorder, delta_re, delta_im):
        h.update(np.ascontiguousarray(a).tobytes())
    for leaf in (params.beta, params.J, params.t, params.tp, params.mu,
                 params.mass):
        h.update(_np(leaf).astype(np.float64).tobytes())
    return h.hexdigest()


def run_segment_hostacc(lat: LatticeSpec, params: ModelParams,
                        states: HMCStateReal, n_sweeps: int, Nt: int, dt, *,
                        measure: bool = True, tracked_iters: int = 6,
                        ns_steps: int = 2, rot_dtype=None,
                        exact_solver: str = "qdwh", pot_cache=None,
                        rot_scheme: str = "ns",
                        generator: torch.Generator | None = None,
                        normals=None, uniforms=None, vote=None
                        ) -> tuple[HMCStateReal, SegmentResult, dict]:
    """Tracked segment with the host float64 Metropolis readout
    (``ops/host_energy.py``), for β past the float32 wall (β ≳ 3e3).

    Per sweep: the tracked leapfrog (no endpoint refine or polish) runs on
    the device; the endpoint (Δ, π) comes to the host, which evaluates the
    exact float64 H (complex128 ``eigvalsh`` per chain) and hands the ΔH
    back to ``tracked_accept``.  The exact anchor (``exact_solver``; "ph"
    is the guarded PH solve of the batch) still runs on the device every
    sweep, so the carried eigenpairs stay anchor-grade for forces,
    observables and transport.

    ``pot_cache`` (a dict) holds the current state's potentials and a
    fingerprint of the chains' identity and state
    (``_hostacc_fingerprint``); it is refreshed on accept, re-fingerprinted
    to the final state on return, and recomputed when the fingerprint does
    not match.  Pass the returned dict back in across segments.  Draws and
    ``vote`` as in ``run_segment_tracked``.  Returns (states, SegmentResult,
    pot_cache); the recorded ΔH is the host's, in float32."""
    disorder = _np(states.disorder)
    b = disorder.shape[0]
    mass = host_energy.mass_array_np(params, b)
    dre0, dim0 = _np(states.delta_re), _np(states.delta_im)
    fp = _hostacc_fingerprint(params, disorder, dre0, dim0)
    if pot_cache is None:
        pot_cache = {}
    if pot_cache.get("fp") != fp:
        pot_cache = {"fp": fp, "pot": host_energy.potential_batch_np(
            lat, params, disorder, dre0, dim0)}

    accs, dHs, obss = [], [], []
    for i in range(n_sweeps):
        n, u = _sweep_draws(normals, uniforms, i)
        prop = tracked_leapfrog(lat, params, states, Nt, dt, tracked_iters,
                                0, 0, ns_steps, rot_dtype,
                                rot_scheme=rot_scheme, normals=n, uniforms=u,
                                generator=generator)
        dre, dim_, pre, pim, pi0r, pi0i = (_np(x) for x in prop[:6])
        pot_new = host_energy.potential_batch_np(lat, params, disorder, dre,
                                                 dim_)
        dH = ((host_energy.kinetic_energy_np(pre, pim, mass) + pot_new)
              - (host_energy.kinetic_energy_np(pi0r, pi0i, mass)
                 + pot_cache["pot"]))
        finite = np.isfinite(dH) & np.isfinite(pot_new)
        eig_new = _batch_eigs(proposal_embedding(lat, params, states, prop),
                              exact_solver, vote)
        states, info = tracked_accept(lat, params, states, prop,
                                      dH_host=dH.astype(np.float32),
                                      finite_host=finite, eig_new=eig_new)
        pot_cache["pot"] = np.where(_np(info.accepted), pot_new,
                                    pot_cache["pot"])
        accs.append(info.accepted)
        dHs.append(info.dH)
        if measure:
            obss.append(measure_observables_real(lat, params, states))

    # the fingerprint of the final state, so the same dict hits on the next
    # segment of these chains
    pot_cache["fp"] = _hostacc_fingerprint(params, disorder,
                                           _np(states.delta_re),
                                           _np(states.delta_im))
    return states, _segment_result(accs, dHs, obss, measure), pot_cache


def _segment_result(accs, dHs, obss, measure: bool) -> SegmentResult:
    obs = (ObservablesResult(*(torch.stack(xs) for xs in zip(*obss)))
           if measure else None)
    return SegmentResult(accepted=torch.stack(accs), dH=torch.stack(dHs),
                         observables=obs)


def ensemble_transport_real(lat: LatticeSpec, spec: SpectralSpec,
                            params: ModelParams,
                            states: HMCStateReal) -> SpectrumResult:
    """Heavy measurement on every chain (leaves have a leading chain dim)."""
    return measure_transport_and_spectra_real(lat, spec, params, states)
