"""One run of one cell: the cell's files found by name, the program's
set-up, the timed window of whole anchor periods, the per-layer readers
and what the correctness check needs.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``:
the lattice, the couplings, the chains and the set-up's thermalization, as
``RunConfig`` fields, with an optional ``dt_factor`` on the leapfrog step)
and a traffic mix (``traffic/<name>.json``: the sweep schedule a user
runs, as ``RunConfig`` fields).  Its limits are in ``limits/<cell>.json``
and each per-layer metric's reader in ``metrics/<metric>.py``.  Adding a
cell adds files; none is edited.

The program is driven through ``drivers/simulation.segment_functions``,
the entry the production scan uses: ``init_fn`` and an exact-anchored
thermalization in set-up, then one warm-up period that reaches every shape
of the timed path, then ``seg_fn`` in the window.  Every input comes from
``--seed`` through the harness's own generator on the device: disorder,
the initial Δ, and each sweep's momentum normals and accept uniforms,
which ``seg_fn`` takes as ``normals=``/``uniforms=``.  What the check
needs of each period is copied to the host once the period has ended, so
that the device holds only the program's working set.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import Callable, NamedTuple

import torch

from . import trace as tr

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent

#: whole periods are traced from the window's start until this many seconds
TRACE_MIN_S = 4.0

#: traffic keys that are the harness's and not ``RunConfig`` fields
TRAFFIC_KEYS = ("why",)
#: configuration keys that are the harness's and not ``RunConfig`` fields
CONFIG_KEYS = ("name", "source", "reduced", "assumed", "dt_factor", "why")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    per_layer: list
    end_to_end: list


def load_cell(name: str, bench: dict | None = None,
              here: Path = HERE) -> Cell:
    """The workload ``name`` of ``BENCHMARK.json`` with its files."""
    bench = bench or load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[name]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_json(here / "configs" / f"{w['config']}.json"),
        traffic=_json(here / "traffic" / f"{w['traffic']}.json"),
        limits=_json(here / "limits" / f"{name}.json"),
        per_layer=bench["per_layer"], end_to_end=bench["end_to_end"])


def reader(metric: str, here: Path = HERE) -> Callable:
    """``read(ctx)`` of ``metrics/<metric>.py``."""
    path = here / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"hmc_bench_metrics_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_config(cell: Cell):
    """The program's ``RunConfig`` of the cell: the configuration's
    fields, then the traffic's over them."""
    from dwavehmc_tpu_torch.utils.config import RunConfig

    names = {f.name for f in dataclasses.fields(RunConfig)}
    kw = {}
    for src, skip in ((cell.config, CONFIG_KEYS),
                      (cell.traffic, TRAFFIC_KEYS)):
        for k, v in src.items():
            if k in skip:
                continue
            if k not in names:
                raise KeyError(f"{cell.name}: {k!r} is not a RunConfig field")
            kw[k] = v
    cfg = RunConfig(**kw)
    cfg.validate()
    return cfg


def optimal_dt(beta: float, J: float, mass: float, Nt: int) -> float:
    """The harmonic step: half an oscillation period 2π√(mJ/β) over Nt."""
    return 2.0 * math.pi * math.sqrt(mass * J / beta) / (2 * Nt)


def dt_factor(cell: Cell) -> float:
    return float(cell.config.get("dt_factor", 1.0))


class Inputs:
    """Every input of a run, drawn from one generator on the device seeded
    with ``--seed``, in a fixed order: the impurity sites, the initial Δ,
    then each sweep's standard normals (B, 2, N, 2) and float32 accept
    uniforms (B,), sweep after sweep."""

    def __init__(self, seed: int, chains: int, sites: int, device):
        self.g = torch.Generator(device=device).manual_seed(seed)
        self.B, self.N, self.device = chains, sites, device

    def initial(self, W: float, n_imp: float):
        """(disorder (B, N), Δ_re, Δ_im (B, N, 2)): round(N·n_imp) sites of
        potential W a chain; Δ = (U[0,1)² − ½(1 + i))·0.1."""
        B, N, dev = self.B, self.N, self.device
        k = int(round(N * n_imp))
        order = torch.rand((B, N), generator=self.g, device=dev).argsort(1)
        disorder = torch.zeros((B, N), device=dev)
        disorder.scatter_(1, order[:, :k], float(W))
        u = torch.rand((B, 2, N, 2), generator=self.g, device=dev) - 0.5
        return (disorder, (0.1 * u[:, 0]).contiguous(),
                (0.1 * u[:, 1]).contiguous())

    def draws(self, n: int):
        nrm = torch.randn((n, self.B, 2, self.N, 2), generator=self.g,
                          device=self.device)
        u = torch.rand((n, self.B), generator=self.g, device=self.device)
        return nrm, u


class Period(NamedTuple):
    """What the reference needs of one timed period, on the host: the
    program's state at its start and end (Δ parts, the end's spectrum),
    the period's draws and the program's records (accepted, dH)."""

    start: tuple
    normals: torch.Tensor
    uniforms: torch.Tensor
    accepted: torch.Tensor
    dH: torch.Tensor
    end: tuple
    evals: torch.Tensor
    seconds: float
    traced: bool


def _host(*xs):
    return tuple(x.cpu() for x in xs)


def period(start, nrm, u, res, states, seconds: float,
           traced: bool) -> Period:
    """The period's records copied to the host (``start`` already is)."""
    return Period(start, *_host(nrm, u, res.accepted, res.dH),
                  _host(states.delta_re, states.delta_im),
                  states.evals.cpu(), seconds, traced)


@dataclasses.dataclass
class Run:
    """One run's results before the reference check."""

    setup_s: float
    window_s: float
    attempted: int
    accepted: int
    failed: int
    peak_bytes: int | None
    periods: list
    init: dict
    therm: Period | None
    traced: tr.Reduced | None
    counters: dict


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def process_start() -> float:
    """The ``time.time()`` at which this process started (Linux's
    ``/proc``), or now where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


def _profiler():
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             *, started: float | None = None, wrap_seg=None) -> Run:
    """Set up the program, time the window, and keep what the reference
    check needs.  ``started``: the ``time.time()`` the set-up is counted
    from (default: now).  ``wrap_seg`` wraps ``seg_fn`` (tests plant
    faults with it)."""
    from dwavehmc_tpu_torch.drivers.simulation import segment_functions
    from dwavehmc_tpu_torch.ops import kernels, ph_eigh

    started = time.time() if started is None else started
    dev = torch.device(device)
    cfg = run_config(cell)
    lat = cfg.lattice()
    params = cfg.params(device=dev)
    B, N = cfg.n_chains, lat.n_sites
    K, Nt = max(1, cfg.anchor_every), cfg.Nt_measure
    dt = dt_factor(cell) * optimal_dt(cfg.beta, cfg.J, cfg.mass, Nt)

    inputs = Inputs(seed, B, N, dev)
    disorder, d0re, d0im = inputs.initial(cfg.W, cfg.n_imp)
    gen = torch.Generator(device=dev).manual_seed(seed)
    seg_fn, init_fn, _ = segment_functions(cfg, lat, gen)
    if wrap_seg is not None:
        seg_fn = wrap_seg(seg_fn)

    states = init_fn(lat, params, gen, B, dtype=cfg.torch_dtype(),
                     n_imp=cfg.n_imp, disorder=disorder, delta0_re=d0re,
                     delta0_im=d0im, device=dev)
    init = dict(zip(("disorder", "delta_re", "delta_im", "evals"),
                    _host(disorder, d0re, d0im, states.evals)))
    start = _host(states.delta_re, states.delta_im)
    therm = None
    if cfg.n_therm:
        nrm, u = inputs.draws(cfg.n_therm)
        states, res = seg_fn(params, states, cfg.n_therm,
                             cfg.Nt_therm_init,
                             optimal_dt(cfg.beta, cfg.J, cfg.mass,
                                        cfg.Nt_therm_init),
                             False, anchor_every=1, normals=nrm, uniforms=u)
        therm = period(start, nrm, u, res, states, 0.0, False)
    k_w = min(K, 2)                    # a cheap sweep and an anchored one
    nrm, u = inputs.draws(k_w)
    states, _ = seg_fn(params, states, k_w, Nt, dt, False,
                       anchor_every=k_w, normals=nrm, uniforms=u)
    start = _host(states.delta_re, states.delta_im)
    del nrm, u
    _sync(dev)
    setup_s = time.time() - started

    kernels.reset_launches()
    ph_eigh.reset_guard()
    periods = []
    prof, traced_s = None, 0.0
    t0 = time.perf_counter()
    while True:
        tracing = trace and traced_s < TRACE_MIN_S
        if tracing and prof is None:
            prof = _profiler()
            prof.start()
        nrm, u = inputs.draws(K)
        tp0 = time.perf_counter()
        with (torch.profiler.record_function(tr.PERIOD) if tracing
              else contextlib.nullcontext()):
            states, res = seg_fn(params, states, K, Nt, dt, False,
                                 anchor_every=K, normals=nrm, uniforms=u)
            _sync(dev)
        tp1 = time.perf_counter()
        periods.append(period(start, nrm, u, res, states, tp1 - tp0,
                              tracing))
        start = periods[-1].end
        del nrm, u, res
        if tracing:
            traced_s += tp1 - tp0
            if traced_s >= TRACE_MIN_S:
                prof.stop()
        elapsed = tp1 - t0
        if elapsed + elapsed / len(periods) > seconds:
            break
    window_s = elapsed
    if prof is not None and traced_s < TRACE_MIN_S:
        prof.stop()
    counters = {"launches": dict(kernels.LAUNCHES),
                "ph_guard": dict(ph_eigh.GUARD)}
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    acc = torch.cat([p.accepted.reshape(-1) for p in periods])
    dH = torch.cat([p.dH.reshape(-1) for p in periods])
    del states
    traced = _reduce(prof) if prof is not None else None
    return Run(setup_s=setup_s, window_s=window_s, attempted=int(acc.numel()),
               accepted=int(acc.sum()),
               failed=int((~torch.isfinite(dH)).sum()), peak_bytes=peak,
               periods=periods, init=init, therm=therm, traced=traced,
               counters=counters)


def _reduce(prof) -> tr.Reduced | None:
    """Write the trace under ``$TMPDIR``, reduce it, delete it."""
    tmp = tempfile.mkdtemp(prefix="hmc_bench_trace_")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return tr.reduce_file(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


class Context(NamedTuple):
    """What a per-layer reader reads: the cell, its ``RunConfig``, the
    reduced trace of the traced periods and their chain-trajectories, and
    the program's counters over the window."""

    cell: Cell
    cfg: object
    trace: tr.Reduced | None
    traced_periods: int
    traced_traj: int
    counters: dict


def context(cell: Cell, run: Run) -> Context:
    cfg = run_config(cell)
    traced = [p for p in run.periods if p.traced]
    traj = sum(int(p.accepted.numel()) for p in traced)
    return Context(cell, cfg, run.traced, len(traced), traj, run.counters)


def per_layer(cell: Cell, run: Run) -> dict:
    """Each per-layer metric the cell reports that its reader finds:
    {name: {"value", "unit"}}."""
    ctx = context(cell, run)
    out = {}
    for m in cell.per_layer:
        v = reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
