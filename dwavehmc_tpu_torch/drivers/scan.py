"""Temperature/β scans, the production workload (port of
``dwavehmc_tpu/drivers/scan.py``).

 * ``run_scan_serial`` — one full ``run_simulation`` (adaptive
   thermalization included) per grid point, each into its own
   ``<scan_param>_<value>/`` directory; with ``cfg.resume`` a finished point
   is skipped and a partial one resumes.  One process.
 * ``run_scan_vectorized`` — every (grid point × replica) chain as one row
   of a single ensemble with per-chain (β, dt), the results sliced back
   into the same per-point layout (``<scan_param>_<value>/{observables.csv,
   transport.csv, spectra_bins.npz}`` plus ``scan.log``,
   ``scan_config.json``, ``therm_health.json`` and ``scan_checkpoint.npz``
   under the root).  Under a process group of W ranks
   (``parallel/mesh.py``) the ensemble is padded to a multiple of W and
   each rank runs a contiguous block of it on its own card; every chain
   gets the draws, the decisions and the guard fallbacks of the one-process
   run, so the output does not depend on W, and rank 0 writes it.

Either package's post-processing reads either package's scans.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import hashlib
from typing import NamedTuple

import numpy as np
import torch

from ..models.params import ModelParams
from ..ops import kernels, ph_eigh
from ..parallel.ensemble import RowDraws
from ..parallel.mesh import (
    COMM,
    barrier,
    gather_global_batch,
    gather_objects,
    process_batch_slice,
    rank_device,
    world,
)
from ..sampler.hmc import calc_optimal_dt
from ..utils.checkpoint import load_checkpoint, save_checkpoint, state_arrays
from ..utils.config import RunConfig
from ..utils.io import (
    OBS_HEADER,
    TRANS_HEADER,
    CsvWriter,
    SpectraBinStore,
    TeeLogger,
    write_json,
)
from ..utils.memory import device_memory, estimate_memory
from .simulation import run_simulation, segment_functions


def default_T_grid(n=24, lo=1e-4, hi=1e3) -> np.ndarray:
    """Log-spaced temperature grid."""
    return np.logspace(np.log10(lo), np.log10(hi), n)


def default_beta_grid(n=24, lo=0.01, hi=1e5) -> np.ndarray:
    """Log-spaced β grid."""
    return np.logspace(np.log10(lo), np.log10(hi), n)


def _point_complete(out_dir: str, n_measure: int) -> bool:
    """True when a scan point's checkpoint says all measurement sweeps ran
    (``run_simulation`` writes a final checkpoint at ``n_measure``)."""
    p = os.path.join(out_dir, "checkpoint.npz")
    if not os.path.exists(p):
        return False
    try:
        with np.load(p) as z:
            return int(z["sweep_idx"]) >= n_measure
    except (OSError, ValueError, KeyError):   # unreadable ⇒ run it again
        return False


def run_scan_serial(cfg: RunConfig, values, *, scan_param: str = "T",
                    out_root: str | None = None,
                    device="cuda") -> list[dict]:
    """One ``run_simulation`` per grid value.  ``scan_param``: "T" (β = 1/T)
    or any RunConfig field name (e.g. "beta", "J", "W").

    With ``cfg.resume``, grid points whose checkpoint already covers all
    ``n_measure`` sweeps are skipped and partially done points resume
    mid-run."""
    out_root = out_root or cfg.out_dir
    os.makedirs(out_root, exist_ok=True)
    results = []
    for v in values:
        sub = dataclasses.replace(cfg)
        if scan_param == "T":
            sub.beta = 1.0 / float(v)
        else:
            setattr(sub, scan_param, float(v))
        sub.out_dir = os.path.join(out_root, f"{scan_param}_{float(v):.6g}")
        if cfg.resume and _point_complete(sub.out_dir, sub.n_measure):
            results.append({"acceptance": float("nan"),
                            "sweeps": sub.n_measure,
                            "out_dir": sub.out_dir, "skipped": True})
            continue
        results.append(run_simulation(sub, device=device))
    return results


def _broadcast_params(base: ModelParams, n: int, **per_chain) -> ModelParams:
    """ModelParams with every field broadcast to (n,); ``per_chain`` fields
    get explicit arrays."""
    fields = {}
    for name in base._fields:
        ref = getattr(base, name)
        if name in per_chain:
            fields[name] = torch.as_tensor(np.asarray(per_chain[name]),
                                           dtype=ref.dtype, device=ref.device)
        else:
            fields[name] = ref.expand(n)
    return ModelParams(**fields)


#: dt may shrink to at most this fraction of the harmonic dt0; chains pinned
#: at the floor are reported by ``chain_health``
DT_MIN_FACTOR = 0.05

#: Reversibility guard (see adapt_dts): a chain whose window MEDIAN dH sits
#: below −NEG_DH_GUARD is treated as biased and its dt shrinks; one below
#: −NEG_DH_BLOCK merely stops growing.  At stationarity ⟨e^{−dH}⟩ = 1 keeps
#: the dH distribution centred ≳ 0 for a reversible proposal; the tracked
#: leapfrog's lagging basis at grown dt is not reversible, and an
#: acceptance-only controller would grow dt into that bias.
NEG_DH_GUARD = 0.5
NEG_DH_BLOCK = 0.05


def adapt_dts(dts: np.ndarray, acc: np.ndarray, dt0: np.ndarray,
              lo: float = 0.60, hi: float = 0.95, shrink: float = 0.7,
              grow: float = 1.1, max_factor: float = 4.0,
              min_factor: float = DT_MIN_FACTOR,
              med_absdH: np.ndarray | None = None,
              dH_target: float = 0.5,
              med_dH: np.ndarray | None = None) -> np.ndarray:
    """Per-chain step-size controller toward the 0.60–0.95 acceptance
    window: acceptance below it shrinks dt (floored at ``min_factor``·dt0),
    above it grows dt (capped at ``max_factor``·dt0).

    With the window's median |dH| the shrink follows |dH| ∝ dt² toward
    ``dH_target`` (dt ← dt·√(dH_target/|dH|), at least 0.25× per window; a
    non-finite median takes the largest shrink).  With the signed median
    dH the reversibility guard applies (NEG_DH_GUARD, NEG_DH_BLOCK)."""
    if med_absdH is not None:
        med_absdH = np.where(np.isfinite(med_absdH), med_absdH, np.inf)
        f = np.sqrt(dH_target / np.maximum(med_absdH, 1e-6))
        down = np.clip(np.minimum(f, shrink), 0.25, 1.0)
        dts = np.where(acc < lo, np.maximum(dts * down, dt0 * min_factor),
                       dts)
    else:
        dts = np.where(acc < lo, np.maximum(dts * shrink, dt0 * min_factor),
                       dts)
    if med_dH is not None:
        dts = np.where(med_dH < -NEG_DH_GUARD,
                       np.maximum(dts * shrink, dt0 * min_factor), dts)
        grow_ok = med_dH > -NEG_DH_BLOCK
    else:
        grow_ok = np.ones_like(acc, dtype=bool)
    dts = np.where((acc > hi) & grow_ok,
                   np.minimum(dts * grow, dt0 * max_factor), dts)
    return dts


def chain_health(dts: np.ndarray, acc: np.ndarray, dt0: np.ndarray,
                 lo: float = 0.60,
                 min_factor: float = DT_MIN_FACTOR,
                 acc_floor: float = 0.05) -> np.ndarray:
    """Mask of UNHEALTHY chains: pinned at the dt floor while below the
    acceptance window, or accepting at most ``acc_floor`` in the last
    window whatever their dt."""
    at_floor = dts <= dt0 * min_factor * 1.0001
    return (at_floor & (acc < lo)) | (acc <= acc_floor)


def nt_buckets(acc_point: np.ndarray, Nt0: int,
               thresholds=((0.30, 2.0), (0.60, 1.5))) -> dict[int, list[int]]:
    """Partition grid points into Nt buckets from probe-window acceptance:
    {Nt: [point indices]}, ascending Nt."""
    need = np.ones_like(acc_point)
    for cut, factor in sorted(thresholds):
        need = np.where(acc_point < cut, np.maximum(need, factor), need)
    out: dict[int, list[int]] = {}
    for Nt in sorted({int(np.ceil(Nt0 * f)) for f in np.unique(need)}):
        pts = [int(g) for g in range(len(acc_point))
               if int(np.ceil(Nt0 * need[g])) == Nt]
        if pts:
            out[Nt] = pts
    return out


def _take_rows(tree, rows):
    """Chains ``rows`` (an index tensor) of every leaf."""
    return type(tree)(*(x[rows] for x in tree))


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class _Part(NamedTuple):
    """Chains that run one segment together, as one rank sees them."""

    rows: np.ndarray       # the chains, ascending (global indices)
    sel: np.ndarray        # this rank's rows (of its block) that run them
    draw: np.ndarray       # each of those rows' position in ``rows``: its
    #                        draws, dt and β
    vote: np.ndarray       # which of those rows are real chains
    stand_in: bool         # no chain of ``rows`` is here: ``sel`` is a
    #                        stand-in whose results are dropped


def _part(src: np.ndarray, real: np.ndarray, rows: np.ndarray) -> _Part:
    """The ``_Part`` of chains ``rows`` on a rank whose block runs chains
    ``src`` (a padded row repeats the last real chain; ``real`` marks the
    others).  A rank that holds none of them runs its first row as a
    stand-in with the first chain's draws, dt and β, so that it still makes
    every collective of the segment (the PH guard's vote among them); the
    stand-in votes False."""
    sel = np.flatnonzero(np.isin(src, rows))
    if sel.size == 0:
        zero = np.zeros(1, dtype=int)
        return _Part(rows, zero, zero, np.zeros(1, dtype=bool), True)
    return _Part(rows, sel, np.searchsorted(rows, src[sel]), real[sel], False)


def _gather_rows(pt: _Part, arrays, axis: int, dst: int | None = None):
    """Each array's entries (along ``axis``) of the real chains of ``pt``
    from every rank: the ranks hold contiguous blocks in rank order, so the
    concatenation is in the order of ``pt.rows``.  ``dst`` as in
    ``parallel/mesh.gather_global_batch``."""
    keep = np.flatnonzero(pt.vote)
    out = gather_global_batch([np.take(a, keep, axis=axis) for a in arrays],
                              dst=dst, axis=axis)
    if out is not None and out[0].shape[axis] != len(pt.rows):
        raise RuntimeError(f"gathered {out[0].shape[axis]} chains of "
                           f"{len(pt.rows)}")
    return out


def _sha1(a: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()


def _rank_map(where: list) -> str:
    """"2 rank(s) on 1 card(s): rank 0 → cuda:0 (name), rank 1 → …"."""
    cards = {w for w in where if w != "cpu"}
    on = f"{len(cards)} card(s)" if cards else "the CPU"
    return (f"{len(where)} rank(s) on {on}: "
            + ", ".join(f"rank {r} → {w}" for r, w in enumerate(where)))


def run_scan_vectorized(cfg: RunConfig, values, *, scan_param: str = "T",
                        out_root: str | None = None,
                        replicas: int | None = None,
                        device="cuda", use_mesh: bool = True) -> dict:
    """Whole grid in one ensemble: chains = len(values) × replicas.

    Optional β-ladder anneal, then thermalization with ``Nt_therm_init``
    and a per-chain adaptive dt (a probe window sorts points into Nt
    buckets, each re-escalated at most twice while acceptance stays below
    0.30), a shrink-only dt probe at ``Nt_measure``, then the measurement
    loop: one CSV row per chain and sweep, a transport pass and a spectra
    bin entry every ``measure_transport_freq`` sweeps, a checkpoint every
    ``checkpoint_freq``.  Thermalization and anneal anchor every sweep;
    ``cfg.anchor_every`` applies to measurement.  The compute path follows
    ``cfg`` (``simulation.segment_functions``): the tracked or untracked
    real path, the tracked path with the host float64 Metropolis readout
    (an exact anchor every sweep), or the complex path.

    Random draws come from one ``torch.Generator`` on ``device`` seeded
    with ``cfg.seed``.  Resume (``cfg.resume``): ``scan_checkpoint.npz``
    holds the ensemble, the generator state, the measurement sweep counter,
    the learned per-chain dt and each point's partial spectra bin; a resumed
    run skips anneal and thermalization, keeps every CSV row and bin flushed
    up to the checkpoint, and continues the measurement loop.  Each guarded
    PH solve and fallback is counted in ``scan.log``.

    Under a process group of W ranks the chains are padded to a multiple
    of W with copies of the last chain (its state, draws, β and dt; left
    out of every output and count) and each rank runs a contiguous block
    on its own card (``parallel/mesh.rank_device``).
    Every rank draws each sweep's draws of all chains and keeps its own
    (``parallel/ensemble.RowDraws``), the per-chain accepts and dH of every
    segment go to every rank, so that the dt controller, the Nt buckets and
    the health tests decide alike everywhere, and the PH guard falls back
    on all ranks together: each chain runs as in the one-process run.  A
    rank with no chain of an Nt bucket runs a stand-in, so that every rank
    makes the same collectives.  Rank 0 gathers the rows, bins and
    checkpoint and writes every file.  ``use_mesh`` keeps the JAX
    signature; its only effect is that ``False`` under several ranks
    raises (each would run and write the whole ensemble).

    Returns the point directories, the chain count, the PH guard's counts
    over this run (``ops/ph_eigh.GUARD``; the failing chains summed over
    ranks), ``stage_seconds``/``stage_sweeps`` for init, anneal, therm,
    probe and measure (wall seconds of the slowest rank, ending in a device
    synchronize and a barrier; sweeps that each advance every chain once),
    the world size, and per rank its device, kernel launches, guard counts
    and seconds in collectives."""
    cfg.validate()
    rank, W = world()
    if W > 1 and not use_mesh:
        raise ValueError(f"use_mesh=False runs the whole ensemble in one "
                         f"process, but this is rank {rank} of {W}: every "
                         f"rank would run and write it")
    dev = rank_device(device)
    out_root = out_root or cfg.out_dir
    os.makedirs(out_root, exist_ok=True)
    tee = (TeeLogger(os.path.join(out_root, "scan.log"), cfg.verbose)
           if rank == 0 else None)

    def log(msg: str) -> None:
        if tee is not None:
            tee(msg)

    values = np.asarray([float(v) for v in values])
    G = len(values)
    C = replicas if replicas is not None else cfg.n_chains
    n_total = G * C
    lat = cfg.lattice()
    spec = cfg.spectral()
    dtype = cfg.torch_dtype()

    if scan_param == "T":
        betas = 1.0 / values
    elif scan_param == "beta":
        betas = values
    else:
        raise ValueError("vectorized scan supports scan_param in {'T','beta'}")
    beta_per_chain = np.repeat(betas, C)

    n_pad = (-n_total) % W
    if n_pad:
        log(f"Padding ensemble with {n_pad} throwaway chain(s) to reach a "
            f"multiple of {W} devices ({n_total} -> {n_total + n_pad}).")
    block = process_batch_slice(n_total + n_pad, rank=rank)
    mine = np.arange(block.start, block.stop)
    src = np.minimum(mine, n_total - 1)     # the chain each row runs
    real = mine < n_total
    every = _part(src, real, np.arange(n_total))

    base = cfg.params(device=dev)
    params = _broadcast_params(base, len(src), beta=beta_per_chain[src])
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    where = gather_objects(f"{dev} ({torch.cuda.get_device_name(dev)})"
                           if dev.type == "cuda" else str(dev))
    log(f"Vectorized {scan_param}-scan: {G} points x {C} replicas = "
        f"{n_total} chains on {_rank_map(where)}; lattice {cfg.Lx}x{cfg.Ly}")
    est = estimate_memory(lat, len(src), dtype)
    log(f"{len(src)} chain(s) per rank; memory estimate per rank: {est}"
        + (f" of {device_memory(dev) / 2**30:.1f} GiB on the card"
           if dev.type == "cuda" else ""))

    path = cfg.resolved_path()
    guard0, launch0 = dict(ph_eigh.GUARD), dict(kernels.LAUNCHES)
    comm0 = dict(COMM)
    stage_seconds: dict[str, float] = {}
    stage_sweeps = dict.fromkeys(("init", "anneal", "therm", "probe",
                                  "measure"), 0)
    t_stage = [time.perf_counter()]

    def stage_done(name: str) -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        barrier()
        now = time.perf_counter()
        stage_seconds[name] = now - t_stage[0]
        t_stage[0] = now

    # the host readout keeps one potential cache across every segment of
    # this run; a resume recomputes it from the loaded states
    seg_fn, init_fn, transport_fn = segment_functions(cfg, lat, gen)
    tail = (2, lat.n_sites, 2)

    def run_seg(pt, s, n, Nt, dt_R, beta_R, measure, anchor_every=None):
        """``n`` sweeps of the chains ``pt.rows``, of which ``s`` holds this
        rank's (``pt.sel``); ``dt_R``/``beta_R`` give each chain of
        ``pt.rows`` its step and β.  The local states and SegmentResult,
        and the accepts and dH of every chain of ``pt.rows`` as numpy
        (n, len(pt.rows)), the same on every rank."""
        p = _broadcast_params(base, len(pt.draw),
                              beta=np.asarray(beta_R)[pt.draw])
        dt = torch.as_tensor(np.asarray(dt_R)[pt.draw], dtype=dtype,
                             device=dev)
        draws = RowDraws(gen, len(pt.rows), tail, dtype, pt.draw, dev)
        s, seg = seg_fn(p, s, n, Nt, dt, measure, anchor_every=anchor_every,
                        normals=draws.normals, uniforms=draws.uniforms,
                        vote=pt.vote)
        acc, dH = _gather_rows(pt, (_np(seg.accepted), _np(seg.dH)), axis=1)
        return s, seg, acc, dH

    # --- resume: restore ensemble + measurement progress -----------------
    ckpt_path = os.path.join(out_root, "scan_checkpoint.npz")
    cfg_path = os.path.join(out_root, "scan_config.json")
    n_done0 = 0
    dt_m_saved = None
    ckpt_extra: dict = {}
    if cfg.resume and os.path.exists(ckpt_path):
        ok = True
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                saved = json.load(f)
            for k, want in (("values", values.tolist()), ("replicas", C),
                            ("Lx", cfg.Lx), ("Ly", cfg.Ly),
                            ("scan_param", scan_param)):
                if saved.get(k) != want:
                    log(f"Resume: scan_config mismatch on '{k}' — "
                        f"starting fresh.")
                    ok = False
                    break
        if ok:
            states, n_done0, ckpt_extra = load_checkpoint(
                ckpt_path, lat, base, state_path=path, generator=gen,
                rows=src, device=dev)
            dt_m_saved = ckpt_extra.get("dt_m")
            log(f"Resumed scan at measurement sweep {n_done0} "
                f"from {ckpt_path}.")
    if n_done0 == 0:
        states = init_fn(lat, base, gen, n_total, dtype=dtype,
                         n_imp=cfg.n_imp, rows=src, vote=real, device=dev)
        got = _gather_rows(every, [state_arrays(states)[k] for k in (
            "disorder", "delta")], axis=0, dst=0)
        if got is not None:
            log(f"Initial ensemble: sha1 {_sha1(got[0])} of the disorder, "
                f"{_sha1(got[1])} of Δ")
    stage_done("init")

    # --- β-ladder annealing (warm start) --------------------------------
    # every chain runs a geometric β ramp from min(β, anneal_start_beta) up
    # to its target before thermalization; warm chains run their own β
    anneal_factor = np.ones(n_total)
    needs_ramp = bool(np.any(beta_per_chain > cfg.anneal_start_beta))
    if n_done0 == 0 and cfg.anneal_stages > 0 and not needs_ramp:
        log(f"Annealing skipped: all {n_total} chain(s) have "
            f"β ≤ {cfg.anneal_start_beta:g} (warm start unnecessary)")
    if n_done0 == 0 and cfg.anneal_stages > 0 and needs_ramp:
        Nt_a = cfg.Nt_therm_init
        b_origin = np.minimum(beta_per_chain, cfg.anneal_start_beta)
        K = cfg.anneal_stages
        log(f"Annealing: {K} stage(s) x {cfg.anneal_sweeps} sweep(s), "
            f"geometric β ramp from min(β, {cfg.anneal_start_beta:g})")
        for k in range(1, K + 1):
            beta_k = b_origin * (beta_per_chain / b_origin) ** (k / K)
            dt0_k = np.asarray([calc_optimal_dt(b, cfg.J, cfg.mass, Nt_a)
                                for b in beta_k])
            dt_k = dt0_k * anneal_factor
            states, _, acc_w, dH_k = run_seg(every, states,
                                             cfg.anneal_sweeps, Nt_a, dt_k,
                                             beta_k, False, anchor_every=1)
            acc_k = acc_w.mean(axis=0)
            dt_k = adapt_dts(dt_k, acc_k, dt0_k,
                             med_absdH=np.median(np.abs(dH_k), axis=0),
                             med_dH=np.median(dH_k, axis=0))
            anneal_factor = dt_k / dt0_k
            stage_sweeps["anneal"] += cfg.anneal_sweeps
            log(f"Anneal stage {k}/{K} (β up to {beta_k.max():.3g}): "
                f"acc [{acc_k.min():.2f}, {acc_k.max():.2f}]")
    stage_done("anneal")

    # --- thermalization: probe window + bucketed per-point Nt -----------
    Nt_th = cfg.Nt_therm_init
    window = 5
    dt0 = np.asarray(
        [calc_optimal_dt(b, cfg.J, cfg.mass, Nt_th) for b in beta_per_chain])
    dts = dt0 * anneal_factor   # carry the annealing ramp's learned shrink
    point_of_chain = np.arange(n_total) // C
    Nt_chain = np.full(n_total, Nt_th, dtype=int)
    acc_chain = np.ones(n_total)
    med_dH_chain = np.zeros(n_total)

    done = 0 if n_done0 == 0 else cfg.n_therm   # resumed: already thermal
    stage_sweeps["therm"] = cfg.n_therm - done
    if done < cfg.n_therm:
        n = min(window, cfg.n_therm - done)
        states, _, acc_w, dH_w = run_seg(every, states, n, Nt_th, dts,
                                         beta_per_chain, False,
                                         anchor_every=1)
        done += n
        acc_chain = acc_w.mean(axis=0)
        med_dH_chain = np.median(dH_w, axis=0)
        dts = adapt_dts(dts, acc_chain, dt0,
                        med_absdH=np.median(np.abs(dH_w), axis=0),
                        med_dH=med_dH_chain)
        log(f"Therm probe {done}/{cfg.n_therm}: acc "
            f"[{acc_chain.min():.2f}, {acc_chain.max():.2f}]")

    if done < cfg.n_therm:
        if cfg.Nt_escalate:
            acc_point = np.asarray([acc_chain[point_of_chain == g].min()
                                    for g in range(G)])
            buckets = nt_buckets(acc_point, Nt_th)
        else:
            buckets = {Nt_th: list(range(G))}
        if list(buckets) != [Nt_th]:
            log(f"Therm buckets (Nt -> #points): "
                f"{ {k: len(v) for k, v in buckets.items()} }")
        merged = []
        for Nt_b, pts in buckets.items():
            rows = np.sort(np.concatenate(
                [np.flatnonzero(point_of_chain == g) for g in pts]))
            pt = _part(src, real, rows)
            st_b = _take_rows(states, torch.as_tensor(pt.sel, device=dev))
            dt0_b = np.asarray([calc_optimal_dt(b, cfg.J, cfg.mass, Nt_b)
                                for b in beta_per_chain[rows]])
            # preserve the probe window's learned per-chain correction
            dts_b = dt0_b * (dts[rows] / dt0[rows])
            Nt_chain[rows] = Nt_b
            med_dH_b = np.zeros(len(rows))
            Nt_cur, escal_left, done_b = Nt_b, 2, done
            while done_b < cfg.n_therm:
                n = min(window, cfg.n_therm - done_b)
                st_b, _, acc_w, dH_b = run_seg(pt, st_b, n, Nt_cur, dts_b,
                                               beta_per_chain[rows], False,
                                               anchor_every=1)
                done_b += n
                acc_b = acc_w.mean(axis=0)
                # bounded re-escalation while acceptance stays collapsed
                if (cfg.Nt_escalate and escal_left > 0
                        and acc_b.min() < 0.30 and done_b < cfg.n_therm):
                    escal_left -= 1
                    Nt_cur = int(np.ceil(1.5 * Nt_cur))
                    log(f"Therm {done_b}/{cfg.n_therm} bucket Nt={Nt_b}: "
                        f"min acc={acc_b.min():.2f} -> re-escalating to "
                        f"Nt={Nt_cur}")
                    # keep the learned per-chain shrink across the escalation
                    ratio = dts_b / dt0_b
                    dt0_b = np.asarray(
                        [calc_optimal_dt(b, cfg.J, cfg.mass, Nt_cur)
                         for b in beta_per_chain[rows]])
                    dts_b = dt0_b * ratio
                    Nt_chain[rows] = Nt_cur
                    continue
                med_dH_b = np.median(dH_b, axis=0)
                dts_b = adapt_dts(dts_b, acc_b, dt0_b,
                                  med_absdH=np.median(np.abs(dH_b), axis=0),
                                  med_dH=med_dH_b)
            merged.append((rows, pt, st_b, dts_b, dt0_b, acc_b, med_dH_b))
            log(f"Therm bucket Nt={Nt_cur} done ({len(pts)} point(s)), "
                f"acc [{acc_b.min():.2f}, {acc_b.max():.2f}]")
        # merge buckets back in original chain order: the host arrays over
        # every chain, the states over this rank's rows (stand-ins dropped)
        inv = np.argsort(np.concatenate([m[0] for m in merged]))
        held = [m for m in merged if not m[1].stand_in]
        tinv = torch.as_tensor(np.argsort(np.concatenate(
            [m[1].sel for m in held])), device=dev)
        states = type(states)(*(torch.cat(xs)[tinv] for xs in
                                zip(*[m[2] for m in held])))
        dts = np.concatenate([m[3] for m in merged])[inv]
        dt0 = np.concatenate([m[4] for m in merged])[inv]
        acc_chain = np.concatenate([m[5] for m in merged])[inv]
        med_dH_chain = np.concatenate([m[6] for m in merged])[inv]

    if n_done0 == 0:
        unhealthy = chain_health(dts, acc_chain, dt0)
        biased = med_dH_chain < -NEG_DH_GUARD
        health = {}
        for g in range(G):
            sel = point_of_chain == g
            health[f"{scan_param}_{values[g]:.6g}"] = {
                "Nt_therm": int(Nt_chain[np.flatnonzero(sel)[0]]),
                "min_acc_last_window": float(acc_chain[sel].min()),
                "dt_factor_min": float((dts[sel] / dt0[sel]).min()),
                "med_dH_last_window": float(med_dH_chain[sel].min()),
                "unhealthy_chains": int(unhealthy[sel].sum()),
                "neg_dH_biased_chains": int(biased[sel].sum()),
            }
        if rank == 0:
            write_json(os.path.join(out_root, "therm_health.json"), health)
        n_bad = int(unhealthy.sum())
        if n_bad:
            log(f"WARNING: {n_bad} chain(s) pinned at the dt floor with "
                f"acceptance < 0.60 after thermalization — see "
                f"therm_health.json")
        n_biased = int(biased.sum())
        if n_biased:
            log(f"WARNING: {n_biased} chain(s) end thermalization with "
                f"median dH < -{NEG_DH_GUARD} (tracked-basis reversibility "
                f"bias; dt should have shrunk — see therm_health.json)")
        log(f"Thermalization done ({cfg.n_therm} sweeps, Nt "
            f"{Nt_chain.min()}..{Nt_chain.max()}), "
            f"mean acc={acc_chain.mean():.2f}")
    stage_done("therm")

    # --- measurement ----------------------------------------------------
    # the learned per-chain dt factor carries into the measurement step,
    # SHRINK only: growth earned at Nt_therm would multiply the smaller
    # measurement step (leapfrog error ∝ factor³/Nt² at fixed length)
    Nt_m = cfg.Nt_measure
    factor = np.minimum(dts / dt0, 1.0)
    dt0_m = np.asarray([calc_optimal_dt(b, cfg.J, cfg.mass, Nt_m)
                        for b in beta_per_chain])
    if dt_m_saved is not None:
        dt_m = np.asarray(dt_m_saved)
    else:
        dt_m = dt0_m * factor
        # shrink-only probe windows at the measurement (Nt, dt) before any
        # row is recorded
        probe_left = 0 if n_done0 > 0 else int(cfg.meas_probe_sweeps)
        while probe_left > 0:
            n = min(window, probe_left)
            states, _, acc_w, dH_p = run_seg(every, states, n, Nt_m, dt_m,
                                             beta_per_chain, False)
            probe_left -= n
            stage_sweeps["probe"] += n
            acc_p = acc_w.mean(axis=0)
            dt_m = adapt_dts(dt_m, acc_p, dt0_m, grow=1.0,
                             med_absdH=np.median(np.abs(dH_p), axis=0),
                             med_dH=np.median(dH_p, axis=0))
            log(f"Meas probe ({n} sweep(s) at Nt={Nt_m}): acc "
                f"[{acc_p.min():.2f}, {acc_p.max():.2f}]")
            if acc_p.min() >= 0.60:
                break
    # the dt the measurement runs at, in the state's dtype (as checkpointed)
    dt_m = np.asarray(dt_m).astype(np.float64 if dtype == torch.float64
                                   else np.float32)
    stage_done("probe")

    # per-point output channels, rank 0's
    dirs = [os.path.join(out_root, f"{scan_param}_{v:.6g}") for v in values]
    f_obs, f_trans, stores = [], [], []
    res_at = n_done0 if n_done0 > 0 else None
    for v, d in zip(values if rank == 0 else [], dirs):
        os.makedirs(d, exist_ok=True)
        header_o = OBS_HEADER if C == 1 else (
            "Sweep,Chain," + OBS_HEADER.split(",", 1)[1])
        header_t = TRANS_HEADER if C == 1 else (
            "Sweep,Chain," + TRANS_HEADER.split(",", 1)[1])
        f_obs.append(CsvWriter(os.path.join(d, "observables.csv"), header_o,
                               resume_at=res_at))
        f_trans.append(CsvWriter(os.path.join(d, "transport.csv"), header_t,
                                 resume_at=res_at))
        stores.append(SpectraBinStore(
            os.path.join(d, "spectra_bins.npz"), cfg.bin_size,
            meta={"omega_grid": spec.omega_grid(),
                  "dos_grid": spec.dos_grid(), "Lx": cfg.Lx, "Ly": cfg.Ly,
                  scan_param: v, "eta": spec.eta, "n_chains": C},
            resume_at=res_at))
    if rank == 0:
        write_json(cfg_path, {**cfg.to_dict(), "scan_param": scan_param,
                              "values": values.tolist(), "replicas": C})
    if n_done0 > 0:
        # each point's partial-bin accumulator rides the checkpoint
        for g, st in enumerate(stores):
            pref = f"store{g}_"
            st.load_state({k[len(pref):]: v for k, v in ckpt_extra.items()
                           if k.startswith(pref)})

    def _ckpt_extra():
        extra = {"dt_m": dt_m}
        for g, st in enumerate(stores):
            for k, v in st.state_dict().items():
                extra[f"store{g}_{k}"] = v
        return extra

    freq = max(1, cfg.measure_transport_freq)
    n_done = n_done0
    meas_acc_sum = np.zeros(n_total)
    meas_acc_n = 0
    meas_dH_chunks = []
    while n_done < cfg.n_measure:
        n = min(freq, cfg.n_measure - n_done)
        states, seg, acc, dH = run_seg(every, states, n, Nt_m, dt_m,
                                       beta_per_chain, True)
        meas_acc_sum += acc.sum(axis=0)
        meas_acc_n += n
        meas_dH_chunks.append(dH)
        o = seg.observables
        cols = _gather_rows(every, [_np(x) for x in (
            o.total_energy, o.delta_amp, o.delta_local, o.delta_global,
            o.S_delta, o.hole_conc, o.delta_diff, o.delta_pair,
            o.delta_localpair)], axis=1, dst=0)
        for s in range(n if rank == 0 else 0):
            sweep = n_done + 1 + s
            for g in range(G):
                for c in range(C):
                    idx = g * C + c
                    row = [sweep] + ([c] if C > 1 else []) + \
                        [bool(acc[s, idx]), dH[s, idx]] + \
                        [col[s, idx] for col in cols]
                    f_obs[g].row(*row)
        n_done += n

        if n_done % freq == 0:
            res = transport_fn(lat, spec, params, states)
            got = _gather_rows(every, [_np(x) for x in (
                res.superfluid_stiffness, res.dc_conductivity,
                res.optical_conductivity, res.dos, res.dos_AN, res.A_k0)],
                axis=0, dst=0)
            if got is not None:
                rho, dc, oc, dos, dan, ak = got
                for g in range(G):
                    sl = slice(g * C, (g + 1) * C)
                    if C == 1:
                        f_trans[g].row(n_done, rho[g * C], dc[g * C])
                    else:
                        for c in range(C):
                            f_trans[g].row(n_done, c, rho[g * C + c],
                                           dc[g * C + c])
                    stores[g].add(n_done, {
                        "opt_cond": oc[sl], "dos": dos[sl],
                        "dos_AN": dan[sl], "A_k0": ak[sl]})
        if cfg.checkpoint_freq and (n_done % cfg.checkpoint_freq == 0
                                    or n_done >= cfg.n_measure):
            arrays = state_arrays(states)
            got = _gather_rows(every, list(arrays.values()), axis=0, dst=0)
            if got is not None:
                save_checkpoint(ckpt_path, dict(zip(arrays, got)), n_done,
                                extra=_ckpt_extra(), generator=gen)
        if n_done % 10 == 0:
            log(f"Meas {n_done}/{cfg.n_measure}. "
                f"Acc={acc.mean():.2f}")

    stage_sweeps["measure"] = n_done - n_done0
    stage_done("measure")
    for w in f_obs + f_trans:
        w.close()
    if cfg.n_measure % freq != 0:
        log(f"NOTE: final {cfg.n_measure % freq} sweep(s) had no transport "
            f"measurement (n_measure={cfg.n_measure} is not a multiple of "
            f"measure_transport_freq={freq}).")
    # --- measurement-phase health ---------------------------------------
    if meas_acc_n and rank == 0:
        meas_acc = meas_acc_sum / meas_acc_n
        dH_all = np.concatenate(meas_dH_chunks, axis=0)
        # diverged proposals are rejected sweeps but would NaN the median:
        # report the finite median and a count of the non-finite ones
        with np.errstate(all="ignore"):
            meas_med_dH = np.nanmedian(
                np.where(np.isfinite(dH_all), dH_all, np.nan), axis=0)
        meas_nonfinite = (~np.isfinite(dH_all)).sum(axis=0)
        hp = os.path.join(out_root, "therm_health.json")
        try:
            with open(hp) as f:
                health_all = json.load(f)
        except (OSError, ValueError):
            health_all = {}
        bad_pts, biased_pts = [], []
        for g in range(G):
            sel = point_of_chain == g
            # a chain whose every measurement dH was non-finite is broken:
            # null median (valid JSON), point flagged
            med_sel = meas_med_dH[sel]
            med_finite = med_sel[np.isfinite(med_sel)]
            all_nonfinite_chain = med_finite.size < med_sel.size
            med_min = (float(med_finite.min()) if med_finite.size else None)
            m = {"mean_acc": float(meas_acc[sel].mean()),
                 "min_acc": float(meas_acc[sel].min()),
                 "med_dH": med_min,
                 "dt_factor_min": float((dt_m[sel] / dt0_m[sel]).min()),
                 "dH_nonfinite": int(meas_nonfinite[sel].sum()),
                 "sweeps": int(meas_acc_n)}
            health_all.setdefault(
                f"{scan_param}_{values[g]:.6g}", {})["measurement"] = m
            if m["min_acc"] < 0.60:
                bad_pts.append(f"{scan_param}_{values[g]:.6g}")
            if all_nonfinite_chain or (med_min is not None
                                       and med_min < -NEG_DH_GUARD):
                biased_pts.append(f"{scan_param}_{values[g]:.6g}")
        write_json(hp, health_all)
        if bad_pts:
            log(f"WARNING: measurement-phase acceptance below the 0.60 "
                f"window at {len(bad_pts)} point(s): {', '.join(bad_pts)} "
                f"— statistics there are suspect (therm_health.json)")
        if biased_pts:
            log(f"WARNING: measurement-phase median dH < -{NEG_DH_GUARD} "
                f"at {len(biased_pts)} point(s): {', '.join(biased_pts)} "
                f"— a reversible sampler at equilibrium cannot sit there "
                f"(tracked-basis lag bias); re-run with a smaller dt "
                f"(therm_health.json)")
    ranks = gather_objects({
        "rank": rank, "device": where[rank],
        "launches": {k: v - launch0[k] for k, v in kernels.LAUNCHES.items()},
        "ph_guard": {k: v - guard0[k] for k, v in ph_eigh.GUARD.items()},
        "collectives": COMM["calls"] - comm0["calls"],
        "collective_seconds": COMM["seconds"] - comm0["seconds"]})
    # solves and fallbacks are the same on every rank; a chain failing the
    # guard is counted on the rank that holds it
    guard = {k: (ranks[0]["ph_guard"][k] if k in ("solves", "fallbacks")
                 else sum(r["ph_guard"][k] for r in ranks))
             for k in ph_eigh.GUARD}
    if guard["solves"]:
        log(f"PH anchor: {guard['solves']} guarded solve(s), "
            f"{guard['fallbacks']} fell back to the full eigh (chains "
            f"failing the guard: {guard['resid_failed']} unconverged sign, "
            f"{guard['ratio_failed']} Ritz value under the floor, "
            f"{guard['nonfinite']} non-finite)")
    log("Stage seconds: " + ", ".join(
        f"{k} {v:.3f} ({stage_sweeps[k]} sweep(s))"
        for k, v in stage_seconds.items()))
    log("Ranks: " + json.dumps(ranks))
    log("Scan done.")
    if tee is not None:
        tee.close()
    return {"dirs": dirs, "values": values.tolist(), "chains": n_total,
            "ph_guard": guard, "stage_seconds": stage_seconds,
            "stage_sweeps": stage_sweeps, "world_size": W, "ranks": ranks}
