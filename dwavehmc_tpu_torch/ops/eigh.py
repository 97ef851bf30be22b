"""Hermitian eigensolver variants for the complex BdG path (port of
``dwavehmc_tpu/ops/eigh.py``), batched over a leading chain dimension.

 * ``eigh_complex`` — ``torch.linalg.eigh`` of the complex Hermitian H
   (the default).
 * ``eigh_real_embedding`` — eigh of the 4N×4N real symmetric embedding
   [[A, −B], [B, A]] of H = A + iB, whose spectrum is that of H with every
   eigenvalue doubled; one eigenvector [x; y] per pair gives u = x + iy.

Both go through ``models/bdg_real.symmetric_eigh``, which diagonalizes
single-precision matrices of dimension ≤ 512 in double precision on the
card.  The recovery of eigenvectors from the embedding assumes a simple
complex spectrum; every downstream quantity is phase-invariant.
"""

from __future__ import annotations

import torch

from ..models.bdg_real import symmetric_eigh


def eigh_complex(H: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return symmetric_eigh(H)


def eigh_real_embedding(H: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(evals (B, d), evecs (B, d, d) complex) of H via the real symmetric
    embedding; equal to ``eigh_complex`` up to a phase per column."""
    d = H.shape[-1]
    A, B = H.real, H.imag
    M = torch.cat([torch.cat([A, -B], dim=-1), torch.cat([B, A], dim=-1)],
                  dim=-2)
    w, V = symmetric_eigh(M)
    U = torch.complex(V[..., :d, ::2], V[..., d:, ::2])
    # ‖[x; y]‖ = 1 gives ‖u‖ = 1 already; enforce it against roundoff
    U = U / torch.linalg.vector_norm(U, dim=-2, keepdim=True)
    return w[..., ::2].contiguous(), U


_IMPLS = {
    "complex": eigh_complex,
    "real_embedding": eigh_real_embedding,
}


def get_eigh(impl: str = "complex"):
    return _IMPLS[impl]
