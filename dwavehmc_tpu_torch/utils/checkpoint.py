"""Checkpoint / resume of the real-pair ensemble (port of the real path of
``dwavehmc_tpu/utils/checkpoint.py``).

One ``.npz`` holds the Markov state as the JAX package writes it — ``delta``
and ``pi`` recombined to complex, ``disorder``, ``sweep_idx`` and any
caller-supplied ``extra_*`` arrays — plus, in place of the JAX PRNG
``key``, the torch generator's state under ``torch_generator_state``.  The
two packages' checkpoints therefore do not load into each other: each
lacks the other's random state.

``load_checkpoint`` rediagonalizes the eigenpairs from the saved (disorder,
Δ) with ``models/bdg_real.diagonalize_embedding``; a tracked-mode resume
re-anchors at the checkpoint (statistically equivalent, not bit-identical).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models.bdg_real import (
    assemble_embedding,
    diagonalize_embedding,
    static_embedding,
)
from ..models.lattice import LatticeSpec
from ..models.params import ModelParams
from ..sampler.hmc_real import HMCStateReal
from .device import resolve_device

GENERATOR_KEY = "torch_generator_state"


def save_checkpoint(path: str, states: HMCStateReal, sweep_idx: int,
                    extra: dict | None = None,
                    generator: torch.Generator | None = None) -> None:
    """Write a resumable snapshot of an ensemble (leading chain dim), and
    ``generator``'s state when given.  Atomic: written to a temporary file,
    then renamed."""
    as_np = lambda x: x.detach().cpu().numpy()  # noqa: E731
    payload = {
        "delta": as_np(states.delta_re) + 1j * as_np(states.delta_im),
        "pi": as_np(states.pi_re) + 1j * as_np(states.pi_im),
        "disorder": as_np(states.disorder),
    }
    if generator is not None:
        payload[GENERATOR_KEY] = generator.get_state().numpy()
    payload["sweep_idx"] = np.asarray(sweep_idx)
    for k, v in (extra or {}).items():
        payload[f"extra_{k}"] = np.asarray(v)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def load_checkpoint(path: str, lat: LatticeSpec, params: ModelParams,
                    state_path: str = "real", *,
                    generator: torch.Generator | None = None,
                    device="cuda") -> tuple[HMCStateReal, int, dict]:
    """(state on ``device``, sweep_idx, extra) with eigenpairs recomputed
    from (disorder, Δ).  A saved generator state is restored into
    ``generator`` when both exist.  ``params`` supplies t, t′ and μ.  Only
    the real-pair layout is ported (``state_path="real"``)."""
    if state_path != "real":
        raise NotImplementedError(
            f"state_path={state_path!r}: only the real-pair state is ported "
            "(the complex path is ROADMAP Queue 1 (d))")
    device = resolve_device(device)
    with np.load(path) as z:
        delta, pi, disorder = z["delta"], z["pi"], z["disorder"]
        sweep_idx = int(z["sweep_idx"])
        gen_state = z[GENERATOR_KEY] if GENERATOR_KEY in z.files else None
        extra = {k[len("extra_"):]: z[k] for k in z.files
                 if k.startswith("extra_")}
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)  # noqa: E731
    dis = t(disorder)
    rdt = dis.dtype
    dre, dim = t(delta.real).to(rdt), t(delta.imag).to(rdt)
    M = assemble_embedding(lat, static_embedding(lat, params.t, params.tp,
                                                 params.mu, dis), dre, dim)
    evals, X, Y = diagonalize_embedding(M)
    if generator is not None and gen_state is not None:
        generator.set_state(torch.from_numpy(gen_state))
    state = HMCStateReal(delta_re=dre, delta_im=dim,
                         pi_re=t(pi.real).to(rdt), pi_im=t(pi.imag).to(rdt),
                         disorder=dis, evals=evals, X=X, Y=Y)
    return state, sweep_idx, extra
