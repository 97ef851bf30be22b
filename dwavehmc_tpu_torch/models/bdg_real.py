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

from ..utils.profiling import sync_span
from .bdg import (
    _pairing_tensors,
    _scatter_add,
    pairing_scatter_indices,
    static_hamiltonian,
)
from .lattice import LatticeSpec, neighbor_tables

#: the most columns a row of H holds: the diagonal, 4 nearest and 4
#: next-nearest neighbours in its Nambu block, 4 bond partners in the other
ROW_COLUMNS = 13


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


@functools.lru_cache(maxsize=None)
def hamiltonian_columns(lat: LatticeSpec) -> tuple[np.ndarray, np.ndarray]:
    """(cols (2N, 13), nnz (2N,)) int32: the distinct columns, ascending,
    where row r of ``assemble_parts``' Hr or Hi can be nonzero, in
    ``cols[r, :nnz[r]]``; the rest of the row repeats its last column.
    Row i < N (particle block) holds i, its nearest and next-nearest
    neighbours, and N + j for every j that the pairing scatter
    (``models/bdg.pairing_scatter_indices``) puts in row i of TR; row N + j
    (hole block) the same in its block, and every i whose TR row holds j.
    Neighbours that coincide on a small torus count once."""
    nn, nnn = neighbor_tables(lat)
    N = lat.n_sites
    prow, pcol = pairing_scatter_indices(lat)
    other = [set() for _ in range(2 * N)]
    for i, j in zip(prow.tolist(), pcol.tolist()):
        other[i].add(N + j)          # TR at (i, N + j)
        other[N + j].add(i)          # TR† at (N + j, i)
    cols = np.empty((2 * N, ROW_COLUMNS), dtype=np.int32)
    nnz = np.empty(2 * N, dtype=np.int32)
    for r in range(2 * N):
        base, i = (r // N) * N, r % N
        row = sorted({r, *(base + nn[i]).tolist(), *(base + nnn[i]).tolist(),
                      *other[r]})
        nnz[r] = len(row)
        cols[r] = row + [row[-1]] * (ROW_COLUMNS - len(row))
    return cols, nnz


#: single-precision dtypes ``symmetric_eigh`` widens for small matrices
_WIDER = {torch.float32: torch.float64, torch.complex64: torch.complex128}


def symmetric_eigh(A: torch.Tensor, counts: dict | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """``torch.linalg.eigh`` of a batch of real symmetric or complex
    Hermitian matrices, with single-precision accuracy on the card.

    On CUDA, PyTorch sends float32 matrices of dimension 32–512 to
    cuSOLVER's Jacobi solver, whose eigenvalues were measured 25× less
    accurate than the CPU's (2.2e-4 vs 8.8e-6 at dimension 144 on an H100)
    — enough to move ΔH by 0.1 at β = 50.  Single-precision matrices
    (float32 and complex64) of dimension ≤ 512 are diagonalized in double
    precision and cast back; larger ones go to the divide-and-conquer
    solver as they are.

    A single-precision batch whose solver does not converge (as cuSOLVER's
    float32 solver did on a diverged chain's embedding at dimension 2304)
    does not raise: it is solved again chain by chain (``_eigh_by_chain``),
    and only the chains that fail alone are redone in double precision,
    their number added to ``counts["redone"]``.  A batch that converges
    takes the one call it always took."""
    wide = _WIDER.get(A.dtype)
    if A.is_cuda and wide is not None and A.shape[-1] <= 512:
        w, V = _eigh(A.to(wide))
        return w.float(), V.to(A.dtype)
    try:
        return _eigh(A)
    except torch.linalg.LinAlgError:
        if wide is None:
            raise
    w, V, redone = _eigh_by_chain(A, wide)
    if counts is not None:
        counts["redone"] += redone
    return w, V


def _eigh(A: torch.Tensor, site: str = "eigh_info"):
    """``torch.linalg.eigh``: its check of the solver's info value reads
    the device, a host sync inside the call, so the span covers the call."""
    with sync_span(site):
        return torch.linalg.eigh(A)


def _eigh_by_chain(A: torch.Tensor, wide: torch.dtype):
    """(w, V, redone): each matrix of the batch ``A`` solved alone in its
    own precision, and the ones that fail to converge again solved in
    ``wide`` and cast back (``redone`` of them); one that fails in ``wide``
    too gets NaN eigenpairs, which the Metropolis step rejects.  Each solve
    is one host read, under ``dwavehmc.sync.fallback_redo``."""
    real = A.real.dtype
    ws, Vs, redone = [], [], 0
    for a in A.reshape(-1, *A.shape[-2:]):
        try:
            w, V = _eigh(a, "fallback_redo")
        except torch.linalg.LinAlgError:
            redone += 1
            try:
                w, V = _eigh(a.to(wide), "fallback_redo")
            except torch.linalg.LinAlgError:
                w = torch.full(a.shape[-1:], float("nan"), dtype=real,
                               device=a.device)
                V = torch.full_like(a, float("nan"))
        ws.append(w.to(real))
        Vs.append(V.to(A.dtype))
    return (torch.stack(ws).reshape(A.shape[:-1]),
            torch.stack(Vs).reshape(A.shape), redone)


def diagonalize_embedding(M: torch.Tensor, counts: dict | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(evals (B, 2N), X (B, 2N, 2N), Y (B, 2N, 2N)): one eigenpair per
    doubled level, kept as the JAX package keeps it (``V[..., ::2]``); the
    complex eigenvectors are U = X + iY (phase-arbitrary, which every
    downstream quantity is invariant to).  The eigensolver is
    ``symmetric_eigh`` (float64 on the card up to dimension 512, i.e.
    lattices up to 11×11; ``counts`` as there)."""
    w, V = symmetric_eigh(M, counts)
    dim = M.shape[-1] // 2
    evals = w[..., ::2].contiguous()
    X = V[..., :dim, ::2].contiguous()
    Y = V[..., dim:, ::2].contiguous()
    return evals, X, Y
