"""Device-memory footprint estimate of an ensemble (port of
``dwavehmc_tpu/utils/memory.py``), for sizing the chains per card.

The byte formula is the JAX package's, so the two estimates agree for the
same lattice, chain count and dtype.  The default capacity is the card's own
(``torch.cuda.get_device_properties(dev).total_memory``).  What PyTorch
really allocates is read by ``torch.cuda.max_memory_allocated``;
``chip_smoke.py`` prints the two side by side.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.lattice import LatticeSpec


@dataclasses.dataclass
class MemoryEstimate:
    state_bytes: int        # Markov-state tensors per chain
    eigh_work_bytes: int    # eigh workspace (a few dense copies)
    transport_bytes: int    # J_mn + temporaries per chain
    per_chain_bytes: int
    n_chains: int
    total_bytes: int

    def fits(self, device_bytes: int | None = None,
             headroom: float = 0.8, device="cuda") -> bool:
        """Whether the estimate stays under ``headroom`` of
        ``device_bytes`` (default: the memory of card ``device``)."""
        if device_bytes is None:
            device_bytes = device_memory(device)
        return self.total_bytes <= device_bytes * headroom

    def __str__(self):
        gb = 2**30
        return (f"{self.n_chains} chains x {self.per_chain_bytes/2**20:.1f} "
                f"MiB = {self.total_bytes/gb:.2f} GiB "
                f"(state {self.state_bytes/2**20:.1f} MiB, eigh work "
                f"{self.eigh_work_bytes/2**20:.1f} MiB, transport "
                f"{self.transport_bytes/2**20:.1f} MiB per chain)")


def device_memory(device="cuda") -> int:
    """Total memory of a CUDA card in bytes."""
    return torch.cuda.get_device_properties(torch.device(device)).total_memory


def estimate_memory(lat: LatticeSpec, n_chains: int,
                    dtype=torch.float32, with_transport: bool = True,
                    eigh_copies: int = 4) -> MemoryEstimate:
    """Shape-derived peak model: the carried and the proposed state (the
    accept step holds both), the eigh workspace (``eigh_copies`` dense
    (2N)² complex buffers), the tracked rotations' temporaries and, with
    ``with_transport``, the transport pass's current matrices."""
    N = lat.n_sites
    dim = 2 * N
    r = torch.finfo(dtype).bits // 8
    c = 2 * r

    evecs = dim * dim * c
    state = (2 * N * 2 * c          # delta, pi
             + N * r                # disorder
             + dim * r              # evals
             + evecs)               # evecs
    eigh_work = eigh_copies * dim * dim * c
    transport = (2 * dim * dim * c  # J_mn + JU temp
                 + dim * dim * r)   # |J|²
    tracked_work = 3 * dim * dim * r   # rotation matmul temporaries
    per_chain = (2 * state          # carried + proposal (accept phase)
                 + eigh_work + tracked_work
                 + (transport if with_transport else 0))
    return MemoryEstimate(
        state_bytes=state, eigh_work_bytes=eigh_work,
        transport_bytes=transport if with_transport else 0,
        per_chain_bytes=per_chain, n_chains=n_chains,
        total_bytes=per_chain * n_chains)


def max_chains(lat: LatticeSpec, dtype=torch.float32,
               device_bytes: int | None = None, headroom: float = 0.8,
               with_transport: bool = True, device="cuda") -> int:
    """The most chains whose estimate fits ``headroom`` of the card."""
    if device_bytes is None:
        device_bytes = device_memory(device)
    one = estimate_memory(lat, 1, dtype, with_transport).per_chain_bytes
    return max(1, int(device_bytes * headroom) // one)
