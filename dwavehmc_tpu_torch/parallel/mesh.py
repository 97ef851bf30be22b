"""Ranks of a sharded ensemble (port of ``dwavehmc_tpu/parallel/mesh.py``).

The JAX package shards the ensemble over a device mesh inside one program.
Here each rank is a process that computes on its own card: the flat,
point-major chain axis is split into contiguous blocks in rank order, under
the 1-D ``("chain",)`` and the 2-D ``("grid", "chain")`` layout alike, as
``grid_chain_sharding``'s ``P(("grid", "chain"))`` splits it.  Chains never
communicate while they sample, so what crosses ranks is host data only:
per-chain accepts and dH, observables, transport rows and spectra, the
checkpoint's Δ, π and disorder, and the PH guard's fallback vote.  It goes
over a ``gloo`` process group on the CPU.  No device memory crosses ranks,
so several ranks may share one card (NCCL refuses two ranks on one device),
and the same code runs on the CPU.

Launch one rank per card with

    python -m torch.distributed.run --standalone --nproc_per_node W \\
        -m dwavehmc_tpu_torch.drivers.batch_scan_T ...

Rank r computes on ``cuda:(LOCAL_RANK mod device_count)``.  Without a
process group there is one rank, and every collective here returns its
input.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

#: collectives of this process: calls and wall seconds spent in them
#: (waiting for the slowest rank included)
COMM = {"calls": 0, "seconds": 0.0}


def _get(*names):
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return v
    return None


def _torchrun_address() -> str | None:
    addr, port = _get("MASTER_ADDR"), _get("MASTER_PORT")
    return None if addr is None or port is None else f"{addr}:{port}"


def distributed_env_spec() -> dict | None:
    """Launch parameters from the environment, or None for one process.

    Recognized (the first spelling set wins):
      DWAVEHMC_COORDINATOR / MASTER_ADDR:MASTER_PORT   host:port of rank 0
      DWAVEHMC_NUM_PROCESSES / WORLD_SIZE              world size
      DWAVEHMC_PROCESS_ID / RANK                       this process's rank
      LOCAL_RANK                                       rank on this host
    ``torch.distributed.run`` sets the second spellings.  A world of one
    process is not distributed unless DWAVEHMC_COORDINATOR or
    DWAVEHMC_DISTRIBUTED=1 asks for a process group."""
    nproc = _get("DWAVEHMC_NUM_PROCESSES", "WORLD_SIZE")
    flag = os.environ.get("DWAVEHMC_DISTRIBUTED", "0") == "1"
    if (_get("DWAVEHMC_COORDINATOR") is None and not flag
            and (nproc is None or int(nproc) <= 1)):
        return None
    pid = _get("DWAVEHMC_PROCESS_ID", "RANK")
    local = _get("LOCAL_RANK")
    return {"coordinator_address": (_get("DWAVEHMC_COORDINATOR")
                                    or _torchrun_address()),
            "num_processes": None if nproc is None else int(nproc),
            "process_id": None if pid is None else int(pid),
            "local_rank": None if local is None else int(local)}


def setup_distributed(coordinator_address: str | None = None,
                      num_processes: int | None = None,
                      process_id: int | None = None) -> bool:
    """Join a ``gloo`` process group; a no-op for one process (returns
    False).  Arguments default to torchrun's variables.  At torchrun's own
    address (or with none) the group starts from ``env://``, which joins
    the launcher's store; at any other ``coordinator_address``, rank 0
    serves ``tcp://`` there."""
    n = num_processes if num_processes is not None else int(
        os.environ.get("WORLD_SIZE", "1"))
    if n <= 1 and coordinator_address is None:
        return False
    if not dist.is_initialized():
        rank = process_id if process_id is not None else int(
            os.environ.get("RANK", "0"))
        init = ("env://" if coordinator_address in (None,
                                                    _torchrun_address())
                else f"tcp://{coordinator_address}")
        dist.init_process_group("gloo", init_method=init, world_size=n,
                                rank=rank)
    return True


def maybe_setup_distributed() -> bool:
    """Env-gated process group for the entry points: call before any device
    use.  Returns True when this process joined a group."""
    spec = distributed_env_spec()
    if spec is None:
        return False
    spec.pop("local_rank")
    return setup_distributed(**spec)


def teardown_distributed() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def world() -> tuple[int, int]:
    """(this rank, world size); (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank_device(device="cuda") -> torch.device:
    """The device this rank computes on.  Under a process group of several
    ranks, "cuda" means ``cuda:(LOCAL_RANK mod device_count)``, made the
    current device; a rank that asked for CUDA and has none raises."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None or world()[1] == 1:
        return dev
    local = int(os.environ.get("LOCAL_RANK", world()[0]))
    dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


# --- layouts ------------------------------------------------------------------

class RankMesh(NamedTuple):
    """Ranks on named axes: the JAX ``Mesh``'s ``devices`` and
    ``axis_names``, with ranks in place of devices."""

    ranks: np.ndarray
    axis_names: tuple


def _n_ranks(n_ranks: int | None) -> int:
    return world()[1] if n_ranks is None else n_ranks


def make_mesh_1d(axis_name: str = "chain",
                 n_ranks: int | None = None) -> RankMesh:
    return RankMesh(np.arange(_n_ranks(n_ranks)), (axis_name,))


def make_mesh_2d(grid_points: int, axis_names=("grid", "chain"),
                 n_ranks: int | None = None) -> RankMesh:
    """(grid × chain) layout for a vectorized scan: g = min(grid_points, n),
    lowered until it divides n."""
    n = _n_ranks(n_ranks)
    g = min(grid_points, n)
    while n % g:
        g -= 1
    return RankMesh(np.arange(n).reshape(g, n // g), tuple(axis_names))


def make_ensemble_mesh(grid_points: int | None = None,
                       n_ranks: int | None = None) -> RankMesh:
    """1-D ``("chain",)``, or 2-D ``("grid", "chain")`` when
    ``grid_points`` is given, over every rank of the job."""
    if grid_points is None:
        return make_mesh_1d(n_ranks=n_ranks)
    return make_mesh_2d(grid_points, n_ranks=n_ranks)


def process_batch_slice(n_total: int, mesh: RankMesh | None = None,
                        rank: int | None = None) -> slice:
    """This rank's contiguous slice of a length-``n_total`` global batch
    laid out over ``mesh``'s ranks in order.  ``n_total`` must divide evenly
    (callers pad the ensemble to the rank count)."""
    mesh = make_mesh_1d() if mesh is None else mesh
    rank = world()[0] if rank is None else rank
    n = mesh.ranks.size
    if n_total % n:
        raise ValueError(f"batch {n_total} not divisible by {n} ranks")
    per = n_total // n
    pos = int(np.flatnonzero(mesh.ranks.ravel() == rank)[0])
    return slice(pos * per, (pos + 1) * per)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def distribute_global_batch(global_leaves, mesh: RankMesh | None = None,
                            device="cuda"):
    """This rank's slice of a global host batch (a dict, tuple or NamedTuple
    of arrays with the chains leading), as tensors on this rank's device
    (``rank_device(device)``: its card, unless ``device="cpu"``)."""
    device = rank_device(device)

    def put(x):
        x = torch.as_tensor(np.asarray(x))
        return x[process_batch_slice(x.shape[0], mesh)].to(device)

    return _tree_map(put, global_leaves)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _timed(fn, *args, **kwargs):
    t0 = time.perf_counter()
    try:
        return fn(*args, **kwargs)
    finally:
        COMM["calls"] += 1
        COMM["seconds"] += time.perf_counter() - t0


def gather_objects(obj, dst: int | None = None) -> list | None:
    """``obj`` of every rank, in rank order: on every rank, or only on
    ``dst`` (None elsewhere)."""
    rank, n = world()
    if n == 1:
        return [obj]
    if dst is None:
        out = [None] * n
        _timed(dist.all_gather_object, out, obj)
        return out
    out = [None] * n if rank == dst else None
    _timed(dist.gather_object, obj, out, dst=dst)
    return out


def gather_global_batch(local_leaves, dst: int | None = None, axis: int = 0):
    """Per-chain host arrays of every rank concatenated along ``axis`` in
    rank order: the inverse of ``distribute_global_batch``.  ``dst=None``
    gives the result to every rank, else to ``dst`` only (None
    elsewhere)."""
    parts = gather_objects(_tree_map(_host, local_leaves), dst)
    if parts is None:
        return None

    def cat(*xs):
        return np.concatenate(xs, axis=axis)

    def merge(trees):
        first = trees[0]
        if isinstance(first, dict):
            return {k: merge([t[k] for t in trees]) for k in first}
        if isinstance(first, tuple) and hasattr(first, "_fields"):
            return type(first)(*(merge(list(xs)) for xs in zip(*trees)))
        if isinstance(first, (list, tuple)):
            return type(first)(merge(list(xs)) for xs in zip(*trees))
        return cat(*trees)

    return merge(parts)


def any_across_ranks(flag: bool) -> bool:
    """True when ``flag`` holds on any rank: an all-reduce MAX of one bool.
    Every rank must call it the same number of times."""
    if world()[1] == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    _timed(dist.all_reduce, t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def barrier() -> None:
    if world()[1] > 1:
        _timed(dist.barrier)
