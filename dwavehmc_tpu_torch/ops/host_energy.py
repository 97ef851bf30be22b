"""Host float64 HMC energy readout: exact Metropolis past the float32 wall
(numpy port of ``dwavehmc_tpu/ops/host_energy.py``).

A float32 ΔH carries the float32 eigenvalue floor: storing or solving E
to ~2e-7·‖M‖ gives a Metropolis error of order β·√(2N)·2e-7·‖M‖, which
is O(1) past β ≈ 3e3, so acceptance collapses however small dt gets.  The
production T grid reaches T = 1e-4 (β = 1e4), well inside that regime.

The trajectory (forces, leapfrog, eigenbasis tracking) stays on the device
in float32 — any proposal distribution is valid for HMC — and only the
once-per-sweep Metropolis energy moves to the host: the endpoint (Δ, π)
pairs come over ((N, 2) each per chain), the host assembles the complex
2N×2N BdG matrix in complex128 and takes ``eigvalsh``, and H is evaluated
in float64.  The sampled distribution is then exp(−H_f64(Δ)) exactly, on
the float32 grid of Δ.

Conventions mirror ``sampler/hmc_real``: kinetic Σ|π|²/2m, boson
β/(2J)Σ|Δ|², fermion −Σ_{E>0}(βE + 2·log1pexp(−βE)) in the PH-even
all-levels/2 form.  Per-chain parameters are the port's 0-d or (B,) torch
tensors; everything else is numpy.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..models.bdg import adjacency, pairing_scatter_indices
from ..models.lattice import LatticeSpec


@functools.lru_cache(maxsize=None)
def _adjacency_f64(lat: LatticeSpec):
    A_nn, A_nnn = adjacency(lat)
    return (np.asarray(A_nn, np.float64), np.asarray(A_nnn, np.float64))


def complex_bdg_np(lat: LatticeSpec, t: float, tp: float, mu: float,
                   disorder, delta_re, delta_im) -> np.ndarray:
    """The 2N×2N complex Hermitian BdG matrix of one chain in complex128:
    H = [[h, TR], [TR†, −h]] with h = −t·A_nn − tp·A_nnn + diag(w−μ) and TR
    the complex-symmetric Δ/2 pairing scatter — the matrix
    ``models/bdg.assemble_bdg`` and ``models/bdg_real.assemble_parts``
    build on the device."""
    N = lat.n_sites
    A_nn, A_nnn = _adjacency_f64(lat)
    h = (-float(t)) * A_nn + (-float(tp)) * A_nnn
    h = h + np.diag(np.asarray(disorder, np.float64) - float(mu))

    rows, cols = pairing_scatter_indices(lat)
    half = 0.5 * (np.asarray(delta_re, np.float64)
                  + 1j * np.asarray(delta_im, np.float64))
    vals = np.concatenate([half[:, 0], half[:, 0], half[:, 1], half[:, 1]])
    TR = np.zeros((N, N), np.complex128)
    np.add.at(TR, (rows, cols), vals)

    H = np.zeros((2 * N, 2 * N), np.complex128)
    H[:N, :N] = h
    H[N:, N:] = -h
    H[:N, N:] = TR
    H[N:, :N] = TR.conj().T
    return H


def _softplus(x):
    """log(1+exp(x)) for x ≤ 0 — stable, underflows cleanly to 0."""
    return np.log1p(np.exp(x))


def fermion_energy_np(evals, beta: float) -> float:
    """−Σ_{E>0}(βE + 2·log1pexp(−βE)) via the PH-even all-levels/2 form."""
    x = float(beta) * np.abs(np.asarray(evals, np.float64))
    return float(-0.5 * np.sum(x + 2.0 * _softplus(-x)))


def potential_energy_np(lat: LatticeSpec, t, tp, mu, beta, J,
                        disorder, delta_re, delta_im) -> float:
    """Boson + fermion potential of one chain's Δ, in float64; ``+inf`` for
    a non-finite Δ (the caller rejects such a proposal, and ``eigvalsh``
    never sees a NaN)."""
    dre = np.asarray(delta_re, np.float64)
    dim_ = np.asarray(delta_im, np.float64)
    if not (np.isfinite(dre).all() and np.isfinite(dim_).all()):
        return float("inf")
    bos = (float(beta) / (2.0 * float(J))) * float(np.sum(dre**2 + dim_**2))
    H = complex_bdg_np(lat, t, tp, mu, disorder, dre, dim_)
    return bos + fermion_energy_np(np.linalg.eigvalsh(H), beta)


def kinetic_energy_np(pi_re, pi_im, mass) -> np.ndarray:
    """Σ|π|²/2m per chain: inputs (B, N, 2) → (B,) float64, inf where
    non-finite."""
    pr = np.asarray(pi_re, np.float64)
    pi_ = np.asarray(pi_im, np.float64)
    kin = np.sum(pr**2 + pi_**2, axis=(-2, -1)) / (2.0 * np.asarray(
        mass, np.float64))
    bad = ~(np.isfinite(pr).all(axis=(-2, -1))
            & np.isfinite(pi_).all(axis=(-2, -1)))
    return np.where(bad, np.inf, kin)


def _per_chain(x, b: int, i: int) -> float:
    """Chain i's value of a 0-d or per-chain (b,) parameter.

    A parameter that is neither means the states and the parameters were
    subset inconsistently; handing every chain chain 0's β would corrupt
    the exact readout, so this raises instead."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    a = np.asarray(x, np.float64).reshape(-1)
    if a.size not in (1, b):
        raise ValueError(
            f"per-chain params leaf has size {a.size}, but the state batch "
            f"is {b}: params and states were subset inconsistently")
    return float(a[i]) if a.size == b else float(a[0])


def potential_batch_np(lat: LatticeSpec, params, disorder,
                       delta_re, delta_im) -> np.ndarray:
    """(B,) float64 potential energies of a batch; ``params`` is a
    ModelParams with 0-d or per-chain (B,) fields."""
    dre, dim_ = np.asarray(delta_re), np.asarray(delta_im)
    b = dre.shape[0]
    dis = np.asarray(disorder)
    out = np.empty(b, np.float64)
    for i in range(b):
        t, tp, mu, beta, J = (_per_chain(x, b, i) for x in (
            params.t, params.tp, params.mu, params.beta, params.J))
        out[i] = potential_energy_np(lat, t, tp, mu, beta, J, dis[i],
                                     dre[i], dim_[i])
    return out


def mass_array_np(params, b: int) -> np.ndarray:
    """(b,) float64 masses from a 0-d or per-chain ``params.mass``."""
    return np.asarray([_per_chain(params.mass, b, i) for i in range(b)])
