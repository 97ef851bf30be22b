"""Checkpoint / resume of an ensemble (port of
``dwavehmc_tpu/utils/checkpoint.py``), for both state layouts.

One ``.npz`` holds the Markov state as the JAX package writes it — ``delta``
and ``pi`` as complex arrays (the real-pair path's parts recombined),
``disorder``, ``sweep_idx`` and any caller-supplied ``extra_*`` arrays —
plus, in place of the JAX PRNG ``key``, the torch generator's state under
``torch_generator_state``.  The two packages' checkpoints therefore do not
load into each other: each lacks the other's random state.

``load_checkpoint`` rediagonalizes the eigenpairs from the saved (disorder,
Δ): ``models/bdg.diagonalize`` for the complex state,
``models/bdg_real.diagonalize_embedding`` for the real pair.  A tracked-mode
resume re-anchors at the checkpoint (statistically equivalent, not
bit-identical).

A sharded ensemble writes the same file: rank 0 gathers every rank's
``state_arrays`` (the eigenpairs are not saved) and saves them, and on
resume each rank loads its ``rows`` and rediagonalizes only those.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models.bdg import assemble_bdg, diagonalize, static_hamiltonian
from ..models.bdg_real import (
    assemble_embedding,
    diagonalize_embedding,
    static_embedding,
)
from ..models.lattice import LatticeSpec
from ..models.params import HMCState, ModelParams, complex_dtype_of
from ..sampler.hmc_real import HMCStateReal
from .device import resolve_device

GENERATOR_KEY = "torch_generator_state"


def state_arrays(states: HMCState | HMCStateReal) -> dict:
    """What a checkpoint keeps of an ensemble, as numpy: ``delta`` and
    ``pi`` complex (B, N, 2), ``disorder`` (B, N)."""
    as_np = lambda x: x.detach().cpu().numpy()  # noqa: E731
    if isinstance(states, HMCStateReal):
        delta = as_np(states.delta_re) + 1j * as_np(states.delta_im)
        pi = as_np(states.pi_re) + 1j * as_np(states.pi_im)
    else:
        delta, pi = as_np(states.delta), as_np(states.pi)
    return {"delta": delta, "pi": pi, "disorder": as_np(states.disorder)}


def save_checkpoint(path: str, states: HMCState | HMCStateReal | dict,
                    sweep_idx: int, extra: dict | None = None,
                    generator: torch.Generator | None = None) -> None:
    """Write a resumable snapshot of an ensemble (leading chain dim),
    complex or real-pair, or of its ``state_arrays``, and ``generator``'s
    state when given.  Atomic: written to a temporary file, then
    renamed."""
    payload = dict(states if isinstance(states, dict)
                   else state_arrays(states))
    if generator is not None:
        payload[GENERATOR_KEY] = generator.get_state().numpy()
    payload["sweep_idx"] = np.asarray(sweep_idx)
    for k, v in (extra or {}).items():
        payload[f"extra_{k}"] = np.asarray(v)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def load_checkpoint(path: str, lat: LatticeSpec, params: ModelParams,
                    state_path: str = "complex", *,
                    generator: torch.Generator | None = None,
                    rows=None, device="cuda"
                    ) -> tuple[HMCState | HMCStateReal, int, dict]:
    """(state on ``device``, sweep_idx, extra) with eigenpairs recomputed
    from (disorder, Δ).  ``state_path``: "complex" → HMCState, "real" →
    HMCStateReal.  A saved generator state is restored into ``generator``
    when both exist.  ``params`` supplies t, t′ and μ.  ``rows`` (indices
    into the saved ensemble, repeats allowed): load only those chains."""
    if state_path not in ("complex", "real"):
        raise ValueError(f"state_path={state_path!r}: expected 'complex' or "
                         "'real'")
    device = resolve_device(device)
    with np.load(path) as z:
        delta, pi, disorder = z["delta"], z["pi"], z["disorder"]
        sweep_idx = int(z["sweep_idx"])
        gen_state = z[GENERATOR_KEY] if GENERATOR_KEY in z.files else None
        extra = {k[len("extra_"):]: z[k] for k in z.files
                 if k.startswith("extra_")}
    if rows is not None:
        rows = np.asarray(rows)
        delta, pi, disorder = delta[rows], pi[rows], disorder[rows]
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)  # noqa: E731
    dis = t(disorder)
    rdt = dis.dtype
    if generator is not None and gen_state is not None:
        generator.set_state(torch.from_numpy(gen_state))
    if state_path == "complex":
        cdt = complex_dtype_of(rdt)
        d = t(delta).to(cdt)
        H = assemble_bdg(lat, static_hamiltonian(lat, params.t, params.tp,
                                                 params.mu, dis), d)
        evals, evecs = diagonalize(H)
        state = HMCState(delta=d, pi=t(pi).to(cdt), disorder=dis,
                         evals=evals, evecs=evecs)
        return state, sweep_idx, extra
    dre, dim = t(delta.real).to(rdt), t(delta.imag).to(rdt)
    M = assemble_embedding(lat, static_embedding(lat, params.t, params.tp,
                                                 params.mu, dis), dre, dim)
    evals, X, Y = diagonalize_embedding(M)
    state = HMCStateReal(delta_re=dre, delta_im=dim,
                         pi_re=t(pi.real).to(rdt), pi_im=t(pi.imag).to(rdt),
                         disorder=dis, evals=evals, X=X, Y=Y)
    return state, sweep_idx, extra
