"""Complex-free BdG path (port of ``dwavehmc_tpu/models/bdg_real.py``).

The complex Hermitian H = A + iB (2N×2N) is handled either as its real
symmetric embedding

    M = [[A, −B], [B, A]]        (4N × 4N)

whose spectrum is that of H with each eigenvalue doubled, or as the pair
(Hr, Hi) = (A, B) for the tracked eigensolver.  All functions take a
leading chain dimension B.

Block structure (TR = pairing block, complex-symmetric TR = TRᵀ):
    A = H_static + [[0, TRr], [TRr, 0]]      (symmetric)
    B =            [[0, TRi], [−TRi, 0]]     (antisymmetric)

Every scatter accumulates duplicate indices (``index_put_`` with
``accumulate=True``), as the JAX ``.at[].add`` does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .bdg import pairing_scatter_indices, static_hamiltonian
from .lattice import LatticeSpec, neighbor_tables


@functools.lru_cache(maxsize=None)
def embedding_scatter_indices(lat: LatticeSpec
                              ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                         np.ndarray]:
    """(rows, cols, signs, source) for scattering Δ into M in one shot.

    ``source`` indexes a flat value vector [Δr_x, Δr_y, Δi_x, Δi_y] (each
    length N); every bond contributes 16 scatter points (4 A-positions × 2
    diagonal copies + 4 B-positions × 2 off-diagonal copies) with ``signs``
    carrying the antisymmetry of B and the −B top-right block.
    """
    nn, _ = neighbor_tables(lat)
    N = lat.n_sites
    dim = 2 * N   # complex dimension; M is (2*dim, 2*dim)
    i = np.arange(N)

    rows, cols, signs, src = [], [], [], []

    def add(r, c, s, k):
        rows.append(r)
        cols.append(c)
        signs.append(np.full(N, s, dtype=np.float64))
        src.append(k)

    for b, jmap in ((0, nn[:, 0]), (1, nn[:, 1])):   # +x, +y bonds
        j = jmap
        re_k = np.full(N, b, dtype=np.int64) * N + i          # Δr column b
        im_k = np.full(N, 2 + b, dtype=np.int64) * N + i      # Δi column b
        # A entries (value Δr/2), symmetric, at both diagonal copies
        for (r, c) in ((i, j + N), (j + N, i), (j, i + N), (i + N, j)):
            add(r, c, +1.0, re_k)                  # M[r, c]           += Δr/2
            add(r + dim, c + dim, +1.0, re_k)      # M[r+2N, c+2N]     += Δr/2
        # B entries (value Δi/2): B[r,c]=+v at (i,j+N),(j,i+N);
        # antisymmetric partners get −v.  M gets +B bottom-left, −B top-right.
        for (r, c, s) in ((i, j + N, +1.0), (j + N, i, -1.0),
                          (j, i + N, +1.0), (i + N, j, -1.0)):
            add(r + dim, c, +s, im_k)              # bottom-left  +B
            add(r, c + dim, -s, im_k)              # top-right    −B
    return (np.concatenate(rows).astype(np.int32),
            np.concatenate(cols).astype(np.int32),
            np.concatenate(signs),
            np.concatenate(src).astype(np.int32))


@functools.lru_cache(maxsize=None)
def _embedding_tensors(lat: LatticeSpec, dtype: torch.dtype,
                       device: torch.device):
    rows, cols, signs, src = embedding_scatter_indices(lat)
    as_long = lambda a: torch.as_tensor(a, dtype=torch.long, device=device)  # noqa: E731
    return (as_long(rows), as_long(cols),
            torch.as_tensor(signs, dtype=dtype, device=device), as_long(src))


@functools.lru_cache(maxsize=None)
def _pairing_tensors(lat: LatticeSpec, device: torch.device):
    return tuple(torch.as_tensor(a, dtype=torch.long, device=device)
                 for a in pairing_scatter_indices(lat))


def _scatter_add(M: torch.Tensor, rows, cols, vals: torch.Tensor):
    """M[b, rows, cols] += vals[b] for every chain b, accumulating
    duplicates (in place)."""
    B = vals.shape[0]
    b = torch.arange(B, device=vals.device)[:, None].expand_as(vals)
    M.index_put_((b, rows.expand_as(vals), cols.expand_as(vals)), vals,
                 accumulate=True)
    return M


def static_embedding(lat: LatticeSpec, t, tp, mu,
                     disorder: torch.Tensor) -> torch.Tensor:
    """M_static (B, 4N, 4N): the real H_static on both diagonal blocks."""
    Hs = static_hamiltonian(lat, t, tp, mu, disorder)              # (B, 2N, 2N)
    B, dim = Hs.shape[0], Hs.shape[-1]
    M = torch.zeros((B, 2 * dim, 2 * dim), dtype=Hs.dtype, device=Hs.device)
    M[:, :dim, :dim] = Hs
    M[:, dim:, dim:] = Hs
    return M


def assemble_embedding(lat: LatticeSpec, M_static: torch.Tensor,
                       delta_re: torch.Tensor, delta_im: torch.Tensor
                       ) -> torch.Tensor:
    """M(Δ) = M_static + pairing scatter.  delta_re/delta_im: (B, N, 2)."""
    rows, cols, signs, src = _embedding_tensors(lat, M_static.dtype,
                                                M_static.device)
    vals_flat = 0.5 * torch.cat(
        [delta_re[..., 0], delta_re[..., 1], delta_im[..., 0],
         delta_im[..., 1]], dim=-1)                                # (B, 4N)
    vals = signs * vals_flat[:, src]
    return _scatter_add(M_static.clone(), rows, cols, vals)


def assemble_parts(lat: LatticeSpec, Hs_real: torch.Tensor,
                   delta_re: torch.Tensor, delta_im: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Hr, Hi) real/imag parts of the (B, 2N, 2N) complex H, for the
    tracked eigensolver.

    Hr = H_static + [[0, TRr], [TRr, 0]],  Hi = [[0, TRi], [−TRi, 0]].
    """
    N = lat.n_sites
    rows, cols = _pairing_tensors(lat, Hs_real.device)
    B = Hs_real.shape[0]

    def tr_block(vals_col):
        half = 0.5 * vals_col
        vals = torch.cat([half[..., 0], half[..., 0], half[..., 1],
                          half[..., 1]], dim=-1)
        TR = torch.zeros((B, N, N), dtype=Hs_real.dtype,
                         device=Hs_real.device)
        return _scatter_add(TR, rows, cols, vals)

    TRr = tr_block(delta_re)
    TRi = tr_block(delta_im)
    Hr = Hs_real.clone()
    Hr[:, :N, N:] += TRr
    Hr[:, N:, :N] += TRr.mT
    Hi = torch.zeros_like(Hs_real)
    Hi[:, :N, N:] += TRi
    Hi[:, N:, :N] += -TRi.mT
    return Hr, Hi


def diagonalize_embedding(M: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(evals (B, 2N), X (B, 2N, 2N), Y (B, 2N, 2N)): one eigenpair per
    doubled level, kept as the JAX package keeps it (``V[..., ::2]``); the
    complex eigenvectors are U = X + iY (phase-arbitrary, which every
    downstream quantity is invariant to).

    On CUDA, PyTorch sends float32 matrices of dimension 32–512 to
    cuSOLVER's Jacobi solver, whose eigenvalues were measured 25× less
    accurate than the CPU's (2.2e-4 vs 8.8e-6 at 4N = 144 on an H100) —
    enough to move ΔH by 0.1 at β = 50.  Those embeddings (lattices up to
    11×11) are diagonalized in float64 and cast back; larger ones go to
    the divide-and-conquer solver in float32."""
    if M.is_cuda and M.dtype == torch.float32 and M.shape[-1] <= 512:
        w, V = torch.linalg.eigh(M.double())
        w, V = w.float(), V.float()
    else:
        w, V = torch.linalg.eigh(M)
    dim = M.shape[-1] // 2
    evals = w[..., ::2].contiguous()
    X = V[..., :dim, ::2].contiguous()
    Y = V[..., dim:, ::2].contiguous()
    return evals, X, Y
