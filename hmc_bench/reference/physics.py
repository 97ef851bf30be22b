"""Plain float64 reference of the disordered d-wave BdG sampler: the
Hamiltonian, its exact eigenpairs, the forces, the leapfrog, ΔH and the
Metropolis decision.

Written from the model's equations in complex128 with ``torch.linalg``,
batched over a few chains (leading dimension b).  It imports nothing of
the measured program and takes nothing it made: the couplings, the
disorder, Δ and the draws come from the harness.

Conventions (the model's, as the measured program states them):

* sites i = y·Lx + x on a periodic Lx×Ly torus; bonds +x and +y carry Δ;
* H = [[h, TR], [TR†, −h]] with h = −t·A_nn − t'·A_nnn + diag(w − μ) and
  TR[i, j] = TR[j, i] = Δ_ij/2 for every +x and +y bond (i, j);
* f(E) = 1/(1 + e^{βE});  P_ij = −ρ_{i, j+N} − ρ_{j, i+N} with
  ρ_{uv} = Σ_n U_un f_n conj(U_vn);  F = −β/(2J)·(Δ − J·P);
* leapfrog: π₀ = √m·(n_re + i·n_im); half kick, Nt drifts Δ += dt·π/(2m)
  with a full kick between them, half kick;
* H_HMC = Σ|π|²/(2m) + β/(2J)·Σ|Δ|² − ½·Σ_n (β|E_n| + 2·log(1 + e^{−β|E_n|}))
  over all 2N levels; accept when ΔH < 0 or u < e^{−ΔH}.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

CDT = torch.complex128
RDT = torch.float64


@functools.lru_cache(maxsize=None)
def bonds(Lx: int, Ly: int) -> dict:
    """Neighbour tables of the torus (numpy int64, each (N,)): the +x, +y,
    +x+y and +x−y neighbour of every site."""
    i = np.arange(Lx * Ly)
    x, y = i % Lx, i // Lx

    def at(dx, dy):
        return ((y + dy) % Ly) * Lx + (x + dx) % Lx

    return {"x": at(1, 0), "y": at(0, 1), "xpy": at(1, 1),
            "xmy": at(1, -1)}


@functools.lru_cache(maxsize=None)
def hopping(Lx: int, Ly: int) -> tuple[np.ndarray, np.ndarray]:
    """(A_nn, A_nnn): symmetric 0/1 adjacency of nearest and next-nearest
    neighbours."""
    b = bonds(Lx, Ly)
    N = Lx * Ly
    i = np.arange(N)
    A1, A2 = np.zeros((N, N)), np.zeros((N, N))
    for key, A in (("x", A1), ("y", A1), ("xpy", A2), ("xmy", A2)):
        A[i, b[key]] += 1.0
        A[b[key], i] += 1.0
    return A1, A2


def hamiltonian(Lx: int, Ly: int, c: dict, disorder: torch.Tensor,
                delta: torch.Tensor) -> torch.Tensor:
    """H (b, 2N, 2N) complex128 from disorder (b, N) and Δ (b, N, 2)."""
    N = Lx * Ly
    dev = delta.device
    A1, A2 = (torch.as_tensor(a, dtype=RDT, device=dev)
              for a in hopping(Lx, Ly))
    b = delta.shape[0]
    h = (-c["t"] * A1 - c["tp"] * A2)[None] + torch.diag_embed(
        disorder.to(RDT) - c["mu"])
    tb = bonds(Lx, Ly)
    i = torch.arange(N, device=dev)
    TR = torch.zeros((b, N, N), dtype=CDT, device=dev)
    for col, key in ((0, "x"), (1, "y")):
        j = torch.as_tensor(tb[key], device=dev)
        half = 0.5 * delta[:, :, col].to(CDT)
        TR[:, i, j] += half
        TR[:, j, i] += half
    H = torch.zeros((b, 2 * N, 2 * N), dtype=CDT, device=dev)
    H[:, :N, :N] = h
    H[:, N:, N:] = -h
    H[:, :N, N:] = TR
    H[:, N:, :N] = TR.conj().mT
    return H


def eigh(H: torch.Tensor):
    """(E (b, 2N) ascending, U (b, 2N, 2N)) in float64."""
    return torch.linalg.eigh(H)


def pairing(Lx: int, Ly: int, E, U, beta: float) -> torch.Tensor:
    """P (b, N, 2) complex: P_ij = −ρ_{i, j+N} − ρ_{j, i+N} on +x, +y."""
    N = Lx * Ly
    dev = U.device
    f = torch.sigmoid(-beta * E).to(CDT)
    W = U * f[:, None, :]
    i = torch.arange(N, device=dev)
    tb = bonds(Lx, Ly)
    out = []
    for key in ("x", "y"):
        j = torch.as_tensor(tb[key], device=dev)
        r1 = (W[:, i] * U[:, j + N].conj()).sum(-1)
        r2 = (W[:, j] * U[:, i + N].conj()).sum(-1)
        out.append(-(r1 + r2))
    return torch.stack(out, -1)


def force(Lx, Ly, delta, E, U, c) -> torch.Tensor:
    """F = −β/(2J)·(Δ − J·P), (b, N, 2) complex."""
    P = pairing(Lx, Ly, E, U, c["beta"])
    return -(c["beta"] / (2.0 * c["J"])) * (delta - c["J"] * P)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def fermion_levels(E, beta: float):
    """−½ Σ_n (β|E_n| + 2·log(1 + e^{−β|E_n|})) per chain."""
    x = beta * E.abs()
    return -0.5 * (x + 2.0 * _softplus(-x)).sum(-1)


def delta_H(c, pi0, pi1, d0, d1, E0, E1):
    """ΔH of a trajectory (b,), term by term."""
    kin = ((pi1.abs() ** 2).sum((-2, -1))
           - (pi0.abs() ** 2).sum((-2, -1))) / (2.0 * c["mass"])
    bos = (c["beta"] / (2.0 * c["J"])) * ((d1.abs() ** 2).sum((-2, -1))
                                          - (d0.abs() ** 2).sum((-2, -1)))
    return kin + bos + fermion_levels(E1, c["beta"]) - fermion_levels(
        E0, c["beta"])


def leapfrog(Lx, Ly, c, disorder, delta, E, U, normals, Nt: int, dt: float):
    """One trajectory from (Δ, E, U) with standard normals (b, 2, N, 2):
    (π₀, Δ', π', E', U')."""
    m = c["mass"]
    pi0 = math.sqrt(m) * torch.complex(normals[:, 0].to(RDT),
                                       normals[:, 1].to(RDT))
    F = force(Lx, Ly, delta, E, U, c)
    pi = pi0 + 0.5 * dt * F
    d = delta
    for step in range(Nt):
        d = d + (dt / (2.0 * m)) * pi
        E, U = eigh(hamiltonian(Lx, Ly, c, disorder, d))
        F = force(Lx, Ly, d, E, U, c)
        pi = pi + (dt if step < Nt - 1 else 0.5 * dt) * F
    return pi0, d, pi, E, U


def accepts(dH, u):
    """The Metropolis decision of each chain (b,) bool."""
    return (dH < 0) | (u.to(RDT) < torch.exp(-dH))
