"""Bogoliubov–de Gennes Hamiltonian pieces (port of the parts of
``dwavehmc_tpu/models/bdg.py`` that the real-pair path uses).

Conventions (every sign is physics):
 * particle block     h_ij = −t (NN) − t' (NNN) + (w_i − μ) δ_ij
 * hole block         −h* = −h  (h real)
 * pairing block      TR[i, j+N] = TR[j, i+N] = Δ_ij / 2  for +x,+y bonds
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .lattice import LatticeSpec, neighbor_tables
from .params import chain_view


@functools.lru_cache(maxsize=None)
def adjacency(lat: LatticeSpec) -> tuple[np.ndarray, np.ndarray]:
    """(A_nn, A_nnn) dense 0/1 adjacency constants of shape (N, N), built
    from all 4 directions so both (i,j) and (j,i) are set."""
    nn, nnn = neighbor_tables(lat)
    N = lat.n_sites

    def build(table):
        A = np.zeros((N, N), dtype=np.float64)
        rows = np.repeat(np.arange(N), table.shape[1])
        np.add.at(A, (rows, table.reshape(-1)), 1.0)
        return A

    return build(nn), build(nnn)


@functools.lru_cache(maxsize=None)
def pairing_scatter_indices(lat: LatticeSpec) -> tuple[np.ndarray, np.ndarray]:
    """Row/col index constants for scattering Δ into the top-right block.

    Each +x bond (i → jx) contributes Δx[i]/2 at (i, jx) and (jx, i) of the
    N×N top-right block; likewise +y.  Order of values: [Δx at (i,jx), Δx at
    (jx,i), Δy at (i,jy), Δy at (jy,i)].
    """
    nn, _ = neighbor_tables(lat)
    i = np.arange(lat.n_sites)
    jx, jy = nn[:, 0], nn[:, 1]
    rows = np.concatenate([i, jx, i, jy]).astype(np.int32)
    cols = np.concatenate([jx, i, jy, i]).astype(np.int32)
    return rows, cols


@functools.lru_cache(maxsize=None)
def _adjacency_tensors(lat: LatticeSpec, dtype: torch.dtype,
                       device: torch.device):
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in adjacency(lat))


def static_hamiltonian(lat: LatticeSpec, t, tp, mu,
                       disorder: torch.Tensor) -> torch.Tensor:
    """Kinetic + potential part of H_BdG, (B, 2N, 2N) real, from the (B, N)
    disorder potential."""
    A_nn, A_nnn = _adjacency_tensors(lat, disorder.dtype, disorder.device)
    diag = disorder - chain_view(mu, 2)                            # (B, N)
    h = (-chain_view(t, 3) * A_nn - chain_view(tp, 3) * A_nnn
         + torch.diag_embed(diag))                                 # (B, N, N)
    B, N = disorder.shape
    H = torch.zeros((B, 2 * N, 2 * N), dtype=h.dtype, device=h.device)
    H[:, :N, :N] = h
    H[:, N:, N:] = -h
    return H
