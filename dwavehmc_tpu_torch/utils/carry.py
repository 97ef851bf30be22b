"""Carry state and parameters in from numpy arrays.

The JAX package's ``HMCStateReal`` and ``ModelParams``, given as mappings of
field name → numpy array (``{k: np.asarray(v) for k, v in
state._asdict().items()}``), become the port's on a given device, so that
both packages can compute from the same state.  Fields the port does not
carry (the JAX state's PRNG ``key``) are ignored.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from ..models.params import ModelParams
from ..sampler.hmc_real import HMCStateReal
from .device import resolve_device


def _torch_dtype(a) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=np.asarray(a).dtype)).dtype


def state_from_numpy(arrays: Mapping, *, dtype=None,
                     device="cuda") -> HMCStateReal:
    """HMCStateReal from batched arrays (leading chain dimension).
    ``dtype`` defaults to that of ``arrays["evals"]``."""
    device = resolve_device(device)
    if dtype is None:
        dtype = _torch_dtype(arrays["evals"])
    return HMCStateReal(**{
        name: torch.as_tensor(np.array(arrays[name]), device=device).to(
            dtype)
        for name in HMCStateReal._fields})


def params_from_numpy(arrays: Mapping, *, dtype=None,
                      device="cuda") -> ModelParams:
    """ModelParams from 0-d or per-chain (B,) arrays.  ``dtype`` defaults to
    that of ``arrays["beta"]``."""
    device = resolve_device(device)
    if dtype is None:
        dtype = _torch_dtype(arrays["beta"])
    return ModelParams(**{
        name: torch.as_tensor(np.array(arrays[name]), device=device).to(
            dtype)
        for name in ModelParams._fields})
