"""Model parameters, spectral grid and disorder sampling.

Port of ``dwavehmc_tpu/models/params.py``.  ``ModelParams`` holds tensors
that are either 0-d (shared by every chain) or ``(B,)`` (one value per
chain, e.g. the β of a temperature scan); ``chain_view`` lines either up
against a ``(B, ...)`` tensor.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .lattice import LatticeSpec


@dataclasses.dataclass(frozen=True)
class SpectralSpec:
    """Static spectral-grid configuration.

    ``omega_min = eta`` and ``n_omega = floor((omega_max-omega_min)/domega)+1``
    as the reference constructor computes them.
    """

    eta: float = 0.01
    domega: float = 0.002
    omega_max: float = 4.0

    @property
    def omega_min(self) -> float:
        return self.eta

    @property
    def n_omega(self) -> int:
        return int(np.floor((self.omega_max - self.omega_min) / self.domega)) + 1

    def omega_grid(self) -> np.ndarray:
        """Positive-frequency grid for σ(ω)."""
        return self.omega_min + self.domega * np.arange(self.n_omega)

    def dos_grid(self) -> np.ndarray:
        """Symmetric grid for the DOS."""
        n = int(np.floor(2 * self.omega_max / self.domega)) + 1
        return -self.omega_max + self.domega * np.arange(n)


class ModelParams(NamedTuple):
    """Physics couplings: each field a 0-d or per-chain ``(B,)`` tensor."""

    t: torch.Tensor
    tp: torch.Tensor
    mu: torch.Tensor
    W: torch.Tensor
    n_imp: torch.Tensor
    beta: torch.Tensor
    J: torch.Tensor
    mass: torch.Tensor


class HMCState(NamedTuple):
    """Complex-path Markov state of B chains.  (The JAX state's PRNG key
    has no counterpart: draws come from a ``torch.Generator``.)"""

    delta: torch.Tensor      # (B, N, 2) complex — bond fields on +x, +y
    pi: torch.Tensor         # (B, N, 2) complex — conjugate momenta
    disorder: torch.Tensor   # (B, N) real — site potential w_i ∈ {0, W}
    evals: torch.Tensor      # (B, 2N) real, ascending
    evecs: torch.Tensor      # (B, 2N, 2N) complex, eigenvectors as columns


def complex_dtype_of(real_dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if real_dtype == torch.float64 else torch.complex64


def chain_view(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """``x`` shaped to broadcast against a ``(B, ...)`` tensor of ``ndim``
    dims: a per-chain ``(B,)`` tensor becomes ``(B, 1, ..., 1)``; a 0-d
    tensor is returned as is."""
    if x.ndim == 0:
        return x
    return x.reshape(x.shape[0], *([1] * (ndim - 1)))


def make_params(t=1.0, tp=-0.35, mu=-1.08, W=0.0, n_imp=0.0, beta=1.0, J=1.0,
                mass=1.0, *, dtype=torch.float32, device="cuda") -> ModelParams:
    """ModelParams on ``device``; any field given as a sequence becomes a
    per-chain ``(B,)`` tensor."""
    device = resolve_device(device)
    as_t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)  # noqa: E731
    return ModelParams(t=as_t(t), tp=as_t(tp), mu=as_t(mu), W=as_t(W),
                       n_imp=as_t(n_imp), beta=as_t(beta), J=as_t(J),
                       mass=as_t(mass))


def sample_disorder(lat: LatticeSpec, W: float, n_imp: float, n_chains: int,
                    *, perm=None, generator: torch.Generator | None = None,
                    dtype=torch.float32, device="cuda") -> torch.Tensor:
    """(B, N) impurity potential: ``round(N·n_imp)`` sites per chain set to W.

    The impurity sites are the first entries of a random permutation per
    chain, as in the JAX package.  ``perm`` ((B, N) integer) injects those
    permutations; otherwise they are drawn from ``generator``.
    """
    device = resolve_device(device)
    N = lat.n_sites
    n_sites_imp = int(np.rint(N * float(n_imp)))
    if perm is None:
        if generator is None:
            raise ValueError("sample_disorder needs perm= or generator=")
        perm = torch.stack([torch.randperm(N, generator=generator,
                                           device=generator.device)
                            for _ in range(n_chains)])
    perm = torch.as_tensor(perm, device=device).long().reshape(n_chains, N)
    pot = torch.zeros((n_chains, N), dtype=dtype, device=device)
    pot.scatter_(1, perm[:, :n_sites_imp], float(W))
    return pot
