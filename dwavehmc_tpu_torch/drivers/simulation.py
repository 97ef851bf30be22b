"""Single-run driver: adaptive thermalization, measurement loop and outputs
(port of ``dwavehmc_tpu/drivers/simulation.py``).

 * adaptive thermalization, window 5: acc < 0.60 ⇒ Nt += 2; acc > 0.95 and
   Nt > 4 ⇒ Nt −= 1; dt from the harmonic heuristic,
 * observables.csv / transport.csv with the reference's headers and one
   flushed row per sweep (and chain, with several chains),
 * a heavy measurement every ``measure_transport_freq`` sweeps, binned by
   ``bin_size`` into ``spectra_bins.npz``,
 * checkpoint and resume that keep every row and bin flushed before the
   checkpoint.

``segment_functions`` picks the segment runner, the init and the
transport for a configuration — the host float64 readout, the tracked or
the untracked real path, or the complex path — and the scan driver uses
it too.
"""

from __future__ import annotations

import os
import time
from collections.abc import Callable

import numpy as np
import torch

from ..parallel.ensemble import (
    ensemble_transport,
    ensemble_transport_real,
    init_ensemble,
    init_ensemble_real,
    run_segment,
    run_segment_hostacc,
    run_segment_real,
    run_segment_tracked,
)
from ..sampler.hmc import calc_optimal_dt
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.config import RunConfig
from ..utils.device import resolve_device
from ..utils.io import (
    OBS_HEADER,
    TRANS_HEADER,
    CsvWriter,
    SpectraBinStore,
    TeeLogger,
    write_json,
)
from ..utils.profiling import PhaseTimer, device_trace

#: ``draws(n)`` → (standard normals (n, B, 2, N, 2), float32 uniforms (n, B))
#: for the next ``n`` sweeps
Draws = Callable[[int], tuple]


def segment_functions(cfg: RunConfig, lat, generator: torch.Generator,
                      draws: Draws | None = None):
    """(seg_fn, init_fn, transport_fn) of ``cfg``'s compute path.

    ``seg_fn(params, states, n, Nt, dt, measure, anchor_every=None)`` runs
    ``n`` sweeps and returns (states, SegmentResult).  Thermalization passes
    ``anchor_every=1`` to the tracked path; ``cfg.anchor_every`` applies
    otherwise.  The host readout anchors every sweep and keeps its
    potential cache, over the chains this process holds, across the calls
    of one ``seg_fn`` (a resume starts it afresh from the loaded states).
    Draws come from ``generator``, or from ``draws`` when given, or from
    ``seg_fn``'s own ``normals``/``uniforms`` (``parallel/ensemble.
    RowDraws``); its ``vote`` goes to the guarded anchor, and ``init_fn``
    takes ``rows``/``vote`` as ``init_ensemble_real`` does."""
    host_cache: dict = {"c": None}
    path = cfg.resolved_path()

    def seg_fn(p, s, n, Nt, dt, measure, anchor_every=None, *,
               normals=None, uniforms=None, vote=None):
        if normals is None and draws is not None:
            normals, uniforms = draws(n)
        kw = dict(generator=generator, normals=normals, uniforms=uniforms)
        if path == "complex":
            return run_segment(lat, p, s, n, Nt, dt, measure=measure, **kw)
        if cfg.eigh_mode == "tracked" and cfg.metropolis_readout == "host":
            s, res, host_cache["c"] = run_segment_hostacc(
                lat, p, s, n, Nt, dt, measure=measure,
                tracked_iters=cfg.tracked_iters,
                ns_steps=cfg.resolved_ns_steps(),
                rot_dtype=cfg.rot_torch_dtype(),
                exact_solver=cfg.exact_solver, pot_cache=host_cache["c"],
                rot_scheme=cfg.rot_scheme, vote=vote, **kw)
            return s, res
        if cfg.eigh_mode == "tracked":
            return run_segment_tracked(
                lat, p, s, n, Nt, dt, measure, cfg.tracked_iters,
                anchor_every if anchor_every is not None
                else cfg.anchor_every,
                cfg.refine_iters, cfg.polish_iters, cfg.resolved_ns_steps(),
                cfg.rot_torch_dtype(), cfg.exact_solver,
                cfg.polish_precision, cfg.polish_correction, cfg.rot_scheme,
                vote=vote, **kw)
        return run_segment_real(lat, p, s, n, Nt, dt, measure=measure,
                                eigh_mode=cfg.eigh_mode,
                                tracked_iters=cfg.tracked_iters, **kw)

    if path == "complex":
        def init_complex(*args, vote=None, **kwargs):
            return init_ensemble(*args, **kwargs)   # no guarded solve

        return seg_fn, init_complex, ensemble_transport

    def init_fn(*args, **kwargs):
        return init_ensemble_real(*args, exact_solver=cfg.exact_solver,
                                  **kwargs)

    return seg_fn, init_fn, ensemble_transport_real


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _obs_rows(writer: CsvWriter, start_sweep: int, seg, n_chains: int):
    """One CSV row per sweep (single chain) or per (sweep, chain)."""
    acc = _np(seg.accepted)
    dH = _np(seg.dH)
    o = seg.observables
    cols = [_np(x) for x in (
        o.total_energy, o.delta_amp, o.delta_local, o.delta_global,
        o.S_delta, o.hole_conc, o.delta_diff, o.delta_pair, o.delta_localpair)]
    for s in range(acc.shape[0]):
        sweep = start_sweep + s
        if n_chains == 1:
            writer.row(sweep, bool(acc[s, 0]), dH[s, 0],
                       *[c[s, 0] for c in cols])
        else:
            for c_idx in range(n_chains):
                writer.row(sweep, c_idx, bool(acc[s, c_idx]), dH[s, c_idx],
                           *[c[s, c_idx] for c in cols])


def run_simulation(cfg: RunConfig, *, device="cuda", states=None,
                   draws: Draws | None = None) -> dict:
    """One run of ``cfg.n_chains`` chains at ``cfg.beta`` into
    ``cfg.out_dir``: ``simulation.log``, ``config.json``,
    ``observables.csv``, ``transport.csv``, ``spectra_bins.npz`` and
    ``checkpoint.npz``, as the JAX package writes them.

    Draws come from one ``torch.Generator`` on ``device`` seeded with
    ``cfg.seed``; ``states`` (an initial ensemble) and ``draws`` replace the
    generator's, so that a test can replay another run's.  With
    ``cfg.resume`` and a checkpoint in ``out_dir``, thermalization is
    skipped and measurement continues from the checkpoint.  Returns the
    acceptance, the sweep count, the directory, and the wall seconds of the
    thermalization and of the measurement's spans (hmc, io, transport;
    each ends in a device synchronize)."""
    cfg.validate()
    dev = resolve_device(device)
    lat = cfg.lattice()
    spec = cfg.spectral()
    params = cfg.params(device=dev)
    dtype = cfg.torch_dtype()
    n_chains = cfg.n_chains
    path = cfg.resolved_path()
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    seg_fn, init_fn, transport_fn = segment_functions(cfg, lat, gen, draws)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    os.makedirs(cfg.out_dir, exist_ok=True)
    log = TeeLogger(os.path.join(cfg.out_dir, "simulation.log"), cfg.verbose)
    obs_header = OBS_HEADER if n_chains == 1 else (
        "Sweep,Chain," + OBS_HEADER.split(",", 1)[1])
    trans_header = TRANS_HEADER if n_chains == 1 else (
        "Sweep,Chain," + TRANS_HEADER.split(",", 1)[1])

    # resolve the resume point before opening any output, so a resumed run
    # keeps every row and bin flushed up to the checkpoint
    ckpt_path = os.path.join(cfg.out_dir, "checkpoint.npz")
    start_sweep = 0
    ckpt_extra: dict = {}
    resumed = cfg.resume and os.path.exists(ckpt_path)
    if resumed:
        states, start_sweep, ckpt_extra = load_checkpoint(
            ckpt_path, lat, params, state_path=path, generator=gen,
            device=dev)
    resume_at = start_sweep if resumed else None

    f_obs = CsvWriter(os.path.join(cfg.out_dir, "observables.csv"),
                      obs_header, resume_at=resume_at)
    f_trans = CsvWriter(os.path.join(cfg.out_dir, "transport.csv"),
                        trans_header, resume_at=resume_at)
    write_json(os.path.join(cfg.out_dir, "config.json"), cfg.to_dict())

    dev_name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
    log("Starting Simulation (dwavehmc_tpu_torch)...")
    log(f"System: {cfg.Lx}x{cfg.Ly}, beta={cfg.beta}, n_imp={cfg.n_imp}, "
        f"J={cfg.J}, chains={n_chains}, dtype={cfg.dtype}, path={path}, "
        f"device={dev_name}")
    log(f"Config: Therm={cfg.n_therm}, Sweep={cfg.n_measure}, "
        f"TransFreq={cfg.measure_transport_freq}, BinSize={cfg.bin_size}")

    spectra = SpectraBinStore(
        os.path.join(cfg.out_dir, "spectra_bins.npz"), cfg.bin_size,
        meta={"omega_grid": spec.omega_grid(), "dos_grid": spec.dos_grid(),
              "Lx": cfg.Lx, "Ly": cfg.Ly, "beta": cfg.beta, "J": cfg.J,
              "eta": spec.eta, "n_chains": n_chains},
        resume_at=resume_at)

    if resumed:
        spectra.load_state(ckpt_extra)
        log(f"Resumed from checkpoint at sweep {start_sweep} "
            f"(partial bin: {spectra.count}/{cfg.bin_size}).")
    elif states is None:
        log("Initializing State...")
        states = init_fn(lat, params, gen, n_chains, dtype=dtype,
                         n_imp=cfg.n_imp, device=dev)

    # --- thermalization with the adaptive-Nt controller ----------------
    Nt = cfg.Nt_therm_init
    dt = calc_optimal_dt(cfg.beta, cfg.J, cfg.mass, Nt)
    window = 5
    log("--- Thermalization Start ---")
    log(f"Init: Nt={Nt}, dt={dt:.5f}")
    t0 = time.perf_counter()
    done = 0
    if start_sweep == 0:
        while done < cfg.n_therm:
            n = min(window, cfg.n_therm - done)
            states, seg = seg_fn(params, states, n, Nt, dt, False,
                                 anchor_every=1)
            done += n
            rate = float(seg.accepted.float().mean())
            old_Nt = Nt
            if rate < 0.60:
                Nt += 2
            elif rate > 0.95 and Nt > 4:
                Nt -= 1
            if Nt != old_Nt:
                dt = calc_optimal_dt(cfg.beta, cfg.J, cfg.mass, Nt)
                log(f"Therm {done}/{cfg.n_therm}. Rate={rate:.2f}. "
                    f"Adjust Nt: {old_Nt} -> {Nt}, dt: {dt:.4f}")
            elif done % 20 == 0:
                log(f"Therm {done}/{cfg.n_therm}. Rate={rate:.2f}. "
                    f"Nt={Nt} (Stable)")
        sync()
        log(f"Thermalization Done. Time: {time.perf_counter()-t0:.2f}s")
    else:
        log("Skipping thermalization (resumed).")
    therm_seconds = time.perf_counter() - t0

    # --- measurement ----------------------------------------------------
    Nt_m = cfg.Nt_measure
    dt_m = calc_optimal_dt(cfg.beta, cfg.J, cfg.mass, Nt_m)
    log("--- Measurement Start ---")
    log(f"Settings: Nt={Nt_m}, dt={dt_m:.5f}")
    t0 = time.perf_counter()
    acc_total = 0.0
    n_done = start_sweep
    freq = max(1, cfg.measure_transport_freq)
    timer = PhaseTimer()

    with device_trace(cfg.profile_dir):
        while n_done < cfg.n_measure:
            n = min(freq, cfg.n_measure - n_done)
            with timer.span("hmc"):
                states, seg = seg_fn(params, states, n, Nt_m, dt_m, True)
                sync()
            with timer.span("io"):
                _obs_rows(f_obs, n_done + 1, seg, n_chains)
            acc_total += float(seg.accepted.float().sum())
            n_done += n

            if n_done % freq == 0:
                with timer.span("transport"):
                    res = transport_fn(lat, spec, params, states)
                    sync()
                rho = _np(res.superfluid_stiffness)
                dc = _np(res.dc_conductivity)
                if n_chains == 1:
                    f_trans.row(n_done, rho[0], dc[0])
                else:
                    for c in range(n_chains):
                        f_trans.row(n_done, c, rho[c], dc[c])
                spectra.add(n_done, {
                    "opt_cond": _np(res.optical_conductivity),
                    "dos": _np(res.dos),
                    "dos_AN": _np(res.dos_AN),
                    "A_k0": _np(res.A_k0),
                })

            if cfg.checkpoint_freq and n_done % cfg.checkpoint_freq == 0:
                save_checkpoint(ckpt_path, states, n_done,
                                extra=spectra.state_dict(), generator=gen)

            if n_done % 10 == 0:
                rate = acc_total / (max(1, n_done - start_sweep) * n_chains)
                e = float(seg.observables.total_energy.mean())
                log(f"Meas {n_done}/{cfg.n_measure}. Acc={rate:.2f}. "
                    f"E={e:.4f}")

    save_checkpoint(ckpt_path, states, n_done, extra=spectra.state_dict(),
                    generator=gen)
    if cfg.n_measure % freq != 0:
        log(f"NOTE: final {cfg.n_measure % freq} sweep(s) had no transport "
            f"measurement (n_measure={cfg.n_measure} is not a multiple of "
            f"measure_transport_freq={freq}).")
    log(f"Measurement Done. Total Time: {time.perf_counter()-t0:.2f}s "
        f"[{timer.summary()}]")
    log.close()
    f_obs.close()
    f_trans.close()

    return {
        "acceptance": acc_total / (max(1, n_done - start_sweep) * n_chains),
        "sweeps": n_done,
        "out_dir": cfg.out_dir,
        "therm_seconds": therm_seconds,
        "measure_seconds": dict(timer.spans),
    }
