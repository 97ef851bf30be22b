"""Spectral primitives (port of ``dwavehmc_tpu/ops/spectral.py``)."""

from __future__ import annotations

import torch

from ..models.params import chain_view


def fermi_factors(evals: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """f(E) = 1/(1+e^{βE}) = logistic(−βE) for ``evals`` (B, n)."""
    return torch.sigmoid(-chain_view(beta, evals.ndim) * evals)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + eˣ) as ``jax.nn.softplus`` defines it (``logaddexp(x, 0)``),
    with no threshold switch."""
    return torch.logaddexp(x, torch.zeros_like(x))
