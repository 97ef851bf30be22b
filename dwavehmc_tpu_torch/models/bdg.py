"""Bogoliubov–de Gennes Hamiltonian assembly (port of
``dwavehmc_tpu/models/bdg.py``), batched over a leading chain dimension.

H = H_static(disorder) + P(Δ), the pairing in the off-diagonal Nambu
blocks.  Conventions (every sign is physics):
 * particle block     h_ij = −t (NN) − t' (NNN) + (w_i − μ) δ_ij
 * hole block         −h* = −h  (h real)
 * pairing block      TR[i, j+N] = TR[j, i+N] = Δ_ij / 2  for +x,+y bonds,
                      bottom-left TR†
"""

from __future__ import annotations

import functools
import os

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


@functools.lru_cache(maxsize=None)
def _pairing_tensors(lat: LatticeSpec, device: torch.device):
    return tuple(torch.as_tensor(a, dtype=torch.long, device=device)
                 for a in pairing_scatter_indices(lat))


def _scatter_add(M: torch.Tensor, rows, cols, vals: torch.Tensor):
    """M[b, rows, cols] += vals[b] for every chain b, accumulating
    duplicates (in place), as the JAX ``.at[].add`` does."""
    B = vals.shape[0]
    b = torch.arange(B, device=vals.device)[:, None].expand_as(vals)
    M.index_put_((b, rows.expand_as(vals), cols.expand_as(vals)), vals,
                 accumulate=True)
    return M


def pairing_block(lat: LatticeSpec, delta: torch.Tensor) -> torch.Tensor:
    """Top-right (B, N, N) Nambu block TR(Δ) from ``delta`` (B, N, 2):
    column 0 the +x bond, column 1 the +y bond; one scatter-add."""
    rows, cols = _pairing_tensors(lat, delta.device)
    half = 0.5 * delta
    vals = torch.cat([half[..., 0], half[..., 0], half[..., 1],
                      half[..., 1]], dim=-1)
    N = lat.n_sites
    TR = torch.zeros((delta.shape[0], N, N), dtype=delta.dtype,
                     device=delta.device)
    return _scatter_add(TR, rows, cols, vals)


def assemble_bdg(lat: LatticeSpec, H_static: torch.Tensor,
                 delta: torch.Tensor) -> torch.Tensor:
    """Full Hermitian H_BdG = H_static + [[0, TR], [TR†, 0]], (B, 2N, 2N)
    in the complex dtype of ``delta``."""
    N = lat.n_sites
    TR = pairing_block(lat, delta)
    H = H_static.to(delta.dtype, copy=True)
    H[:, :N, N:] += TR
    H[:, N:, :N] += TR.conj().mT
    return H


def diagonalize(H: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Hermitian eigendecomposition (ascending) of a (B, 2N, 2N) batch.
    The implementation is chosen by ``DWAVEHMC_EIGH_IMPL``, as in the JAX
    package: "complex" (default) or "real_embedding" (``ops/eigh.py``)."""
    from ..ops.eigh import get_eigh

    return get_eigh(os.environ.get("DWAVEHMC_EIGH_IMPL", "complex"))(H)
