"""The cheap tracked sweep as one CUDA graph, for ``run_segment_tracked``.

A cheap sweep (``sampler/hmc_real.tracked_leapfrog`` with endpoint refine
and polish, then ``tracked_accept_cheap``) is some 5,760 small launches at
16×16 with 8 chains, and there Python's dispatch of them, not the card,
sets the pace.  On a CUDA device, where the work B·(2N)² of the batch is at
most ``GRAPH_MAX_WORK``, the first cheap sweep of a signature runs eagerly
and is then captured; every later one replays the graph.  The signature
(``sweep_key``) holds every Python-valued argument, the lattice, the
shape, dtype and device of every tensor the sweep reads, and the
process-wide matmul settings (``matmul_flags``): cuBLAS picks a product's
kernel when it is captured, and a graph replays that kernel whatever the
settings are later, so a change of them is a new signature.  Above the
threshold the device is busy while the host dispatches, a graph gains
nothing and its private memory pool would hold a second working set, so
those sweeps stay eager, as does every sweep on the CPU and every sweep
traced before its signature was captured.

What the graph reads and writes:

* static inputs: the sweep's draws (drawn eagerly first when they come from
  a generator, with the calls and in the order the leapfrog makes them),
  every leaf of ``params``, the disorder and ``dt`` are copied into the
  graph's own buffers before each replay, so the graph never holds the
  address of a caller's tensor;
* the chain state in place: the eager sweep's output tensors become the
  graph's state buffers; the graph reads the state from them and writes
  the new state back into them at its end, so one cheap sweep hands them
  to the next without a copy.  A segment always ends on an eager anchored
  sweep, which makes fresh tensors, so no caller of ``run_segment_tracked``
  holds a buffer, and the buffers stand in for the state the eager path
  would have held at that point: the allocated peak does not grow;
* the sweep's record (accept flags and ΔH) is cloned out of the graph's
  output.

Each copy of several tensors is one multi-tensor launch
(``torch._foreach_copy_``): a replay adds to the sweep's own work the
inputs copied in, the state written back and the two records copied out,
and the first replay of a segment the state copied in.

Each replay adds to ``ops/kernels.LAUNCHES`` the launches the capture made
(the capture itself launches nothing).  A capture that raises leaves the
signature eager for the rest of the process and counts in
``COUNTS["capture_failures"]``.  The cache keeps the ``KEEP`` signatures
replayed last, so a long process that meets many does not pile up their
private memory pools.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import torch

from ..models.params import ModelParams
from ..ops.kernels import LAUNCHES
from ..sampler.hmc import SweepInfo, sweep_draws
from ..sampler.hmc_real import (
    HMCStateReal,
    tracked_accept_cheap,
    tracked_leapfrog,
)
from ..utils.profiling import span

#: the most work B·(2N)² (chains × the BdG dimension squared) at which a
#: cheap sweep is replayed as a graph.  Timed on an H100 (``chip_smoke.py``
#: ``graph.cheap_sweep``, PERF.md §6): the replay takes 69–71 % off a
#: cheap sweep of the fast mix at 16×16 with 8 chains (2.1 M), 42–50 %
#: with 16 (4.2 M), 23–26 % at 24×24 with 4 (5.3 M), but 4–5 % with 8
#: (10.6 M) and under 2 % above: there the eager sweep already keeps the
#: card busy, and the graph's private pool (a quarter GiB at 10.6 M) would
#: buy nothing.
GRAPH_MAX_WORK = 8 * 2**20

#: the captured sweeps kept at once: the one a run replays, with room for
#: a settings change (a TF32 control after its program) and a few shapes
KEEP = 4

#: captures made, replays run and captures that raised, since import
COUNTS = {"captures": 0, "replays": 0, "capture_failures": 0}

#: signature → captured sweep, the one replayed last at the end
_GRAPHS: dict = {}

#: signatures whose capture raised: left eager, not tried again
_FAILED: set = set()

#: the state fields the graph updates in place (all but the disorder)
_STATE = tuple(f for f in HMCStateReal._fields if f != "disorder")


class CheapSpec(NamedTuple):
    """The Python-valued arguments of a cheap sweep."""

    Nt: int
    tracked_iters: int
    refine_iters: int
    polish_iters: int
    ns_steps: int
    rot_dtype: object
    polish_precision: str
    polish_correction: bool
    rot_scheme: str


def eager_sweep(lat, spec: CheapSpec, params: ModelParams,
                states: HMCStateReal, dt, normals=None, uniforms=None,
                generator: torch.Generator | None = None):
    """One cheap sweep, launched op by op: (states, SweepInfo)."""
    prop = tracked_leapfrog(
        lat, params, states, spec.Nt, dt, spec.tracked_iters,
        spec.refine_iters, spec.polish_iters, spec.ns_steps, spec.rot_dtype,
        spec.polish_precision, spec.polish_correction, spec.rot_scheme,
        normals=normals, uniforms=uniforms, generator=generator)
    return tracked_accept_cheap(lat, params, states, prop)


def graph_worthwhile(batch: int, dim: int) -> bool:
    """Whether a cheap sweep of ``batch`` chains of BdG dimension ``dim``
    (2N) is small enough for its dispatch to outweigh its device work."""
    return batch * dim * dim <= GRAPH_MAX_WORK


def use_graph(states: HMCStateReal) -> bool:
    """A CUDA state small enough (``graph_worthwhile``), outside another
    capture (a graph does not nest in one)."""
    X = states.X
    return (X.is_cuda and not torch.cuda.is_current_stream_capturing()
            and graph_worthwhile(X.shape[0], X.shape[-1]))


def _meta(x: torch.Tensor) -> tuple:
    return tuple(x.shape), x.dtype, x.device


def _legacy(read):
    """A setting read through torch's older switch, or None where torch
    refuses that read (it does once the newer switch has been set)."""
    try:
        return read()
    except RuntimeError:
        return None


def matmul_flags() -> tuple:
    """The process-wide settings by which cuBLAS picks the kernel of a
    float32, bfloat16 or float16 product, when it is launched or captured:
    TF32 (the per-backend and global switches where torch has them, and
    the older two), reduced-precision reductions, the BLAS library."""
    m = torch.backends.cuda.matmul
    return (getattr(m, "fp32_precision", None),
            getattr(torch.backends, "fp32_precision", None),
            _legacy(lambda: m.allow_tf32),
            _legacy(torch.get_float32_matmul_precision),
            m.allow_bf16_reduced_precision_reduction,
            m.allow_fp16_reduced_precision_reduction,
            torch.backends.cuda.preferred_blas_library())


def sweep_key(lat, spec: CheapSpec, params: ModelParams,
              states: HMCStateReal, dt: torch.Tensor) -> tuple:
    """A captured sweep's signature: the lattice, the Python-valued
    arguments, the shape, dtype and device of each tensor it reads, and
    the matmul settings in force (``matmul_flags``)."""
    return (lat, spec, tuple(_meta(x) for x in (*params, *states, dt)),
            matmul_flags())


def reset_graphs() -> None:
    """Drop every captured sweep (and its memory pool) and forget the
    captures that raised."""
    _GRAPHS.clear()
    _FAILED.clear()


def _draws(states: HMCStateReal, normals, uniforms, generator):
    """The sweep's standard normals and accept uniforms, as the leapfrog
    takes them (``_refresh``): the given ones, else drawn in its order."""
    shape = (states.delta_re.shape[0], 2) + tuple(states.delta_re.shape[1:])
    return sweep_draws(normals, uniforms, generator, shape,
                       states.evals.dtype, states.evals.device,
                       "tracked_leapfrog")


class CheapGraph:
    """One captured cheap sweep: its static inputs, its state buffers, its
    record and the kernel launches one replay makes."""

    def __init__(self, graph, inputs: list, state: HMCStateReal,
                 info: SweepInfo, launches: dict):
        self.graph, self.inputs, self.state = graph, inputs, state
        self.info, self.launches = info, launches

    @classmethod
    def capture(cls, lat, spec: CheapSpec, params: ModelParams,
                state: HMCStateReal, dt, normals, uniforms):
        """Capture the sweep on a state that an eager sweep of the same
        signature has just produced (the warm-up PyTorch asks for): its
        tensors, but the disorder, become the graph's state buffers."""
        inputs = [x.clone() for x in (*params, state.disorder, dt, normals,
                                      uniforms)]
        n_p = len(params)
        s_params = ModelParams(*inputs[:n_p])
        disorder, s_dt, s_n, s_u = inputs[n_p:]
        buf = state._replace(disorder=disorder)
        before = dict(LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        # cuBLAS keeps a workspace (32 MiB on Hopper) per handle and stream.
        # Dropped before the capture, the capture stream's is made in the
        # graph's private pool, which no other allocation draws from;
        # dropped after it, the graph alone holds those bytes, and they no
        # longer count as allocated (as torch._inductor's CUDA graphs do).
        torch._C._cuda_clearCublasWorkspaces()
        try:
            with torch.cuda.graph(graph):
                new, info = eager_sweep(lat, spec, s_params, buf, s_dt, s_n,
                                        s_u)
                torch._foreach_copy_([getattr(buf, f) for f in _STATE],
                                     [getattr(new, f) for f in _STATE])
            launches = {k: LAUNCHES[k] - n for k, n in before.items()
                        if LAUNCHES[k] != n}
        finally:
            torch._C._cuda_clearCublasWorkspaces()
            LAUNCHES.update(before)     # the capture launched nothing
        return cls(graph, inputs, buf, info, launches)

    def replay(self, params: ModelParams, states: HMCStateReal, dt, normals,
               uniforms):
        """Copy the inputs in, replay, and return (the state buffers with
        the caller's disorder, a copy of the accept flags, of ΔH)."""
        torch._foreach_copy_(self.inputs, [*params, states.disorder, dt,
                                           normals, uniforms])
        if any(getattr(states, f) is not getattr(self.state, f)
               for f in _STATE):
            torch._foreach_copy_([getattr(self.state, f) for f in _STATE],
                                 [getattr(states, f) for f in _STATE])
        self.graph.replay()
        for k, n in self.launches.items():
            LAUNCHES[k] += n
        COUNTS["replays"] += 1
        return (self.state._replace(disorder=states.disorder),
                self.info.accepted.clone(), self.info.dH.clone())


def cheap_sweep(lat, spec: CheapSpec, params: ModelParams,
                states: HMCStateReal, dt: torch.Tensor, normals=None,
                uniforms=None, generator: torch.Generator | None = None):
    """One cheap sweep of ``run_segment_tracked``: (states, accept flags,
    ΔH); ``dt`` is a tensor on the states' device.  Replays the
    signature's graph where ``use_graph`` holds and one was captured; else
    runs eagerly, and captures after that eager sweep where ``use_graph``
    holds, no capture has been tried for the signature and no profiler is
    on."""
    if not use_graph(states):
        new, info = eager_sweep(lat, spec, params, states, dt, normals,
                                uniforms, generator)
        return new, info.accepted, info.dH
    key = sweep_key(lat, spec, params, states, dt)
    normals, uniforms = _draws(states, normals, uniforms, generator)
    entry = _GRAPHS.pop(key, None)
    if entry is not None:
        _GRAPHS[key] = entry
        with span("dwavehmc.cheap_graph"):
            return entry.replay(params, states, dt, normals, uniforms)
    new, info = eager_sweep(lat, spec, params, states, dt, normals, uniforms)
    if key not in _FAILED and not torch.autograd._profiler_enabled():
        try:
            _GRAPHS[key] = CheapGraph.capture(lat, spec, params, new, dt,
                                              normals, uniforms)
            COUNTS["captures"] += 1
            while len(_GRAPHS) > KEEP:
                del _GRAPHS[next(iter(_GRAPHS))]
        except RuntimeError as e:
            _FAILED.add(key)
            COUNTS["capture_failures"] += 1
            warnings.warn(f"cheap sweep left eager: its CUDA graph capture "
                          f"raised {e!r}", RuntimeWarning, stacklevel=2)
    return new, info.accepted, info.dH
