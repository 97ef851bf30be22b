"""Headline benchmark on the card (port of the top-level ``bench.py``):
HMC trajectories per second of a batch of disordered 16×16 chains.

    python -m dwavehmc_tpu_torch.drivers.bench [--device cuda|cpu]

Prints ONE JSON line on stdout with the JAX script's keys (progress goes
to stderr).  What each part measures:

- ``init``: ``init_ensemble_real`` (or, with ``BENCH_PATH=complex``,
  ``init_ensemble``) at L = ``BENCH_L``, ``BENCH_BATCH`` chains, float32,
  from ``torch.Generator(device).manual_seed(0)``;
- the batched ``eigh`` figures: ``eigh_ms`` is the full-embedding anchor
  (``models/bdg_real.diagonalize_embedding``, the JAX package's "qdwh"),
  ``eigh_ph_ms`` the unguarded PH-split solver on the same matrices,
  assembly included, each the mean of 5 calls timed on the card after a
  warm-up (``utils/profiling.call_ms``); ``eigh_tflops_eff`` counts
  9·B·(4N)³ flops (32·B·(2N)³ on the complex path), a convention, not a
  count of what the solver does;
- therm, then three modes, each one warm-up segment and the best of
  ``BENCH_REPS`` timed ``BENCH_SWEEPS``-sweep segments (wall clock between
  syncs): ``exact`` (the untracked sweep, an exact ``eigh`` every leapfrog
  step), ``tracked`` (tracked leapfrog, an exact anchor every sweep) and
  ``tracked_fast`` (anchors every ``BENCH_ANCHOR_EVERY`` sweeps, refine 6 /
  polish 3, bf16 rotations, exp2 with one Newton–Schulz step, the anchor
  solver ``BENCH_EXACT_SOLVER``).  The headline is the mode with the best
  traj/s × acceptance.  ``model_tflops`` counts only the rotation matmuls
  (``utils/flops.tracked_model_flops``); ``mfu_pct`` and
  ``mfu_pct_nominal`` divide it by the H100's dense BF16 peak
  (``utils/flops.BF16_PEAK``, a data-sheet figure);
- ``shape_leg``: the fast configuration at the production shape (24×24,
  64 chains, Nt = 6, with both anchors' ``eigh`` times and the measured
  chained bf16 batched-matmul rate at the rotations' operand shape) and at
  the capacity shape (32×32, 40 chains, initialized 8 at a time), each
  with the median segment dH, a lag-bias flag, and ``peak_memory_gib``,
  the allocator's peak over the leg.

``vs_baseline`` divides by ``reference_cpu_traj_per_sec``, a documented
estimate of the reference's single-chain CPU rate, not a measurement.

Environment knobs (the JAX script's names and defaults): BENCH_BATCH (8),
BENCH_L (16), BENCH_NT (6), BENCH_SWEEPS (20), BENCH_REPS (3),
BENCH_SKIP_EIGH (0), BENCH_PATH (real|complex), BENCH_THERM (10),
BENCH_NT_THERM (20), BENCH_MODES (exact,tracked,tracked_fast),
BENCH_TRACKED_ITERS (6), BENCH_NS_STEPS (1 for exp2, else 2),
BENCH_ANCHOR_EVERY (10), BENCH_REFINE_ITERS (6), BENCH_POLISH_ITERS (3),
BENCH_ROT_DTYPE (bfloat16|float32), BENCH_ROT_SCHEME (exp2|ns),
BENCH_EXACT_SOLVER (ph|qdwh), BENCH_DT_FACTOR (0.6, the shape legs'),
BENCH_PRODUCTION (1), BENCH_CAPACITY (1), BENCH_PROD_L (24),
BENCH_PROD_B (64), BENCH_CAP_L (32), BENCH_CAP_B (40).
BENCH_PALLAS_S and BENCH_LEAPFROG_UNROLL are read and recorded in the legs'
``config`` and select nothing: the rotation kernel K1 runs wherever the
tensors are on the card, and an eager sweep has no loop to unroll.

A mode, leg or ``eigh`` figure that fails is recorded with its error (a
leg as ``{"error": ...}``), the line is still printed, and the run then
exits nonzero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..models.bdg import assemble_bdg, static_hamiltonian
from ..models.bdg_real import (
    assemble_embedding,
    diagonalize_embedding,
    static_embedding,
)
from ..models.lattice import LatticeSpec
from ..models.params import make_params
from ..ops.eigh import eigh_complex
from ..ops.ph_eigh import diagonalize_embedding_ph
from ..parallel.ensemble import (
    init_ensemble,
    init_ensemble_real,
    run_segment,
    run_segment_real,
    run_segment_tracked,
)
from ..sampler.hmc import calc_optimal_dt
from ..utils.device import resolve_device
from ..utils.flops import BF16_PEAK, tracked_model_flops
from ..utils.profiling import call_ms
from .validate_cheap_anchor import device_label, log, sync

BETA, J, MASS = 10.0, 0.8, 1.0
PHYS = dict(t=1.0, tp=-0.35, mu=-1.08, W=1.0, n_imp=0.05)
#: a segment median dH below this flags a lagging (non-reversible) basis
LAG_MED_DH = -0.5
#: the shape legs' fixed depth in the JAX script (keyword arguments of
#: ``shape_leg``)
PRODUCTION = dict(Ntp=6, n_sweeps=10, n_therm_p=6, reps_p=2,
                  init_chunk=None, eigh_bench=True)
CAPACITY = dict(Ntp=6, n_sweeps=4, n_therm_p=2, reps_p=1, init_chunk=8,
                eigh_bench=False, nt_therm=6)
#: chained products in the matmul-ceiling measurement
N_MM = 30


def knobs(env=os.environ) -> dict:
    """The ``BENCH_*`` knobs with the JAX script's defaults."""
    g = env.get
    scheme = g("BENCH_ROT_SCHEME", "exp2")
    return dict(
        batch=int(g("BENCH_BATCH", 8)), L=int(g("BENCH_L", 16)),
        Nt=int(g("BENCH_NT", 6)), sweeps=int(g("BENCH_SWEEPS", 20)),
        reps=int(g("BENCH_REPS", 3)),
        skip_eigh=g("BENCH_SKIP_EIGH", "0") == "1",
        path=g("BENCH_PATH", "real"), therm=int(g("BENCH_THERM", 10)),
        nt_therm=int(g("BENCH_NT_THERM", 20)),
        modes=g("BENCH_MODES", "exact,tracked,tracked_fast").split(","),
        tracked_iters=int(g("BENCH_TRACKED_ITERS", 6)),
        ns_steps=int(g("BENCH_NS_STEPS", 1 if scheme == "exp2" else 2)),
        anchor_every=int(g("BENCH_ANCHOR_EVERY", 10)),
        refine_iters=int(g("BENCH_REFINE_ITERS", 6)),
        polish_iters=int(g("BENCH_POLISH_ITERS", 3)),
        rot_dtype=g("BENCH_ROT_DTYPE", "bfloat16"), rot_scheme=scheme,
        exact_solver=g("BENCH_EXACT_SOLVER", "ph"),
        dt_factor=float(g("BENCH_DT_FACTOR", 0.6)),
        pallas_s=g("BENCH_PALLAS_S", "1") == "1",
        leapfrog_unroll=int(g("BENCH_LEAPFROG_UNROLL", 1)),
        production=g("BENCH_PRODUCTION", "1") == "1",
        capacity=g("BENCH_CAPACITY", "1") == "1",
        prod_L=int(g("BENCH_PROD_L", 24)), prod_B=int(g("BENCH_PROD_B", 64)),
        cap_L=int(g("BENCH_CAP_L", 32)), cap_B=int(g("BENCH_CAP_B", 40)))


def reference_cpu_traj_per_sec(L: int, Nt: int) -> float:
    """Shape-aware estimate of the reference's single-chain CPU throughput:
    MKL zheevd ≈ 20 ms at 512² complex, scaling (2N/512)³, ×Nt per
    trajectory, +15% for forces/assembly.  (Documented estimate — the
    reference publishes no numbers, BASELINE.md.)"""
    dim = 2 * L * L
    eigh_s = 0.020 * (dim / 512.0) ** 3
    return 1.0 / (Nt * eigh_s * 1.15)


def _params(device):
    return make_params(beta=BETA, J=J, mass=MASS, dtype=torch.float32,
                       device=device, **PHYS)


def _rot(kn: dict):
    return torch.bfloat16 if kn["rot_dtype"] == "bfloat16" else None


def _error(e: Exception, n: int = 160) -> str:
    return f"{type(e).__name__}: {str(e)[:n]}"


def _mean_ms(fn, reps: int, device) -> float:
    return float(np.mean(call_ms(fn, reps, device)[0]))


def _embedding_eigh(lat, params, states, solver):
    """The eigenvalues of every chain's embedding, assembled from its Δ."""
    M = assemble_embedding(
        lat, static_embedding(lat, params.t, params.tp, params.mu,
                              states.disorder),
        states.delta_re, states.delta_im)
    return solver(M)[0]


def eigh_figures(kn: dict, lat, params, states, device) -> dict:
    """``eigh_ms``, ``eigh_tflops_eff`` and, on the real path, ``eigh_ph_ms``
    with ``eigh_ph_speedup``."""
    B = kn["batch"]
    if kn["path"] == "real":
        dim, flop_k = 4 * lat.n_sites, 9
        f = lambda: _embedding_eigh(lat, params, states,  # noqa: E731
                                    diagonalize_embedding)
    else:
        dim, flop_k = 2 * lat.n_sites, 32

        def f():
            Hs = static_hamiltonian(lat, params.t, params.tp, params.mu,
                                    states.disorder)
            return eigh_complex(assemble_bdg(lat, Hs, states.delta))[0]
    eigh_ms = _mean_ms(f, 5, device)
    tflops = flop_k * B * dim**3 / (eigh_ms * 1e-3) / 1e12
    log(f"batched eigh ({B},{dim},{dim}): {eigh_ms:.2f} ms "
        f"(~{tflops:.2f} TFLOP/s effective)")
    out = {"eigh_ms": eigh_ms, "eigh_tflops_eff": tflops}
    if kn["path"] == "real":
        ph_ms = _mean_ms(lambda: _embedding_eigh(
            lat, params, states, diagonalize_embedding_ph), 5, device)
        out.update(eigh_ph_ms=ph_ms, eigh_ph_speedup=eigh_ms / ph_ms)
        log(f"PH-split eigh ({B},{dim},{dim}): {ph_ms:.2f} ms "
            f"({eigh_ms / ph_ms:.2f}x qdwh)")
    return out


def mode_segment(kn: dict, mode: str, lat, params, states, dt, gen):
    """One ``kn["sweeps"]``-sweep segment of ``mode``."""
    sweeps, Nt = kn["sweeps"], kn["Nt"]
    if kn["path"] != "real":
        return run_segment(lat, params, states, sweeps, Nt, dt,
                           measure=True, generator=gen)
    if mode == "tracked":
        return run_segment_tracked(
            lat, params, states, sweeps, Nt, dt, True, kn["tracked_iters"],
            ns_steps=kn["ns_steps"], rot_dtype=_rot(kn),
            exact_solver=kn["exact_solver"], rot_scheme=kn["rot_scheme"],
            generator=gen)
    if mode == "tracked_fast":
        return run_segment_tracked(
            lat, params, states, sweeps, Nt, dt, True, kn["tracked_iters"],
            kn["anchor_every"], kn["refine_iters"], kn["polish_iters"],
            kn["ns_steps"], _rot(kn), exact_solver=kn["exact_solver"],
            rot_scheme=kn["rot_scheme"], generator=gen)
    return run_segment_real(lat, params, states, sweeps, Nt, dt,
                            measure=True, eigh_mode=mode, generator=gen)


def run_mode(kn: dict, mode: str, lat, params, states, dt, gen, device):
    """(states, the mode's record): a warm-up segment, then the best of
    ``kn["reps"]`` timed ones."""
    t0 = time.perf_counter()
    states, seg = mode_segment(kn, mode, lat, params, states, dt, gen)
    sync(device)
    log(f"[{mode}] warm-up segment: {time.perf_counter() - t0:.1f}s")
    times = []
    for r in range(kn["reps"]):
        t0 = time.perf_counter()
        states, seg = mode_segment(kn, mode, lat, params, states, dt, gen)
        acc = float(seg.accepted.float().mean())
        times.append(time.perf_counter() - t0)
        log(f"[{mode}] rep {r}: {times[-1]:.3f}s")
    best = min(times)
    out = {"traj_per_sec": kn["batch"] * kn["sweeps"] / best,
           "acceptance": acc, "times_s": [round(t, 4) for t in times]}
    if mode.startswith("tracked"):
        fast = mode == "tracked_fast"
        flops = tracked_model_flops(
            kn["L"], kn["Nt"], kn["batch"], kn["sweeps"],
            kn["tracked_iters"], kn["anchor_every"] if fast else 1,
            kn["refine_iters"] if fast else 0,
            kn["polish_iters"] if fast else 0, kn["ns_steps"],
            kn["rot_scheme"])
        out["model_tflops"] = round(flops / best / 1e12, 2)
        out["mfu_pct"] = round(100 * flops / best / 1e12
                               / BF16_PEAK["tflops"], 2)
        log(f"[{mode}] tracked-pipeline model rate: {out['model_tflops']} "
            f"TFLOP/s ({out['mfu_pct']}% of {BF16_PEAK['name']})")
    return states, out


def matmul_ceiling_tflops(bp: int, n2: int, device) -> float:
    """The chained bf16 batched-matmul rate at the rotations' operand shape
    (bp, n2, n2): ``N_MM`` products c ← (c·x) in bf16, one timed call after
    a warm-up."""
    g = torch.Generator(device=device).manual_seed(2)
    x = (torch.randn(bp, n2, n2, generator=g, device=device)
         / np.sqrt(n2)).to(torch.bfloat16)

    def chain():
        c = x
        for _ in range(N_MM):
            c = torch.matmul(c, x).to(torch.bfloat16)
        return c

    ms = call_ms(chain, 1, device)[0][0]
    return 2 * bp * n2**3 * N_MM / (ms * 1e-3) / 1e12


def _peak_gib(device):
    if device.type != "cuda":
        return None
    return round(torch.cuda.max_memory_allocated(device) / 2**30, 3)


def shape_leg(kn: dict, device, Lp: int, bp: int, Ntp: int, n_sweeps: int,
              n_therm_p: int, reps_p: int, init_chunk, eigh_bench: bool,
              nt_therm: int | None = None) -> dict:
    """One tracked_fast leg at (Lp, bp): init, a short therm, timed
    segments (and, with ``eigh_bench``, both anchors' ``eigh`` and the
    matmul ceiling).  The production knobs (K, refine, polish, rotation
    dtype and scheme, anchor solver) come from ``kn``, as the headline's."""
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    lat = LatticeSpec(Lp, Lp)
    params = _params(device)
    K, solver = kn["anchor_every"], kn["exact_solver"]
    gen = torch.Generator(device=device).manual_seed(1)
    t0 = time.perf_counter()
    st = init_ensemble_real(lat, params, gen, bp, dtype=torch.float32,
                            n_imp=PHYS["n_imp"], exact_solver=solver,
                            init_chunk=init_chunk, device=device)
    sync(device)
    log(f"[{Lp}x{Lp}/b{bp}] init: {time.perf_counter() - t0:.1f}s")

    eigh = {}
    if eigh_bench:
        dim = 4 * lat.n_sites
        for name, fn in (("qdwh", diagonalize_embedding),
                         ("ph", diagonalize_embedding_ph)):
            ms = _mean_ms(lambda: _embedding_eigh(lat, params, st, fn), 3,
                          device)
            eigh[f"eigh_{name}_ms"] = round(ms, 2)
            eigh[f"eigh_{name}_tflops_eff"] = round(
                9 * bp * dim**3 / (ms * 1e-3) / 1e12, 2)
        eigh["matmul_ceiling_bf16_tflops"] = round(
            matmul_ceiling_tflops(bp, 2 * lat.n_sites, device), 3)
        log(f"[{Lp}x{Lp}/b{bp}] eigh: {eigh}")

    nt_th = kn["nt_therm"] if nt_therm is None else nt_therm
    st, seg = run_segment_tracked(
        lat, params, st, n_therm_p, nt_th,
        calc_optimal_dt(BETA, J, MASS, nt_th), False, kn["tracked_iters"],
        generator=gen)
    sync(device)
    dtp = kn["dt_factor"] * calc_optimal_dt(BETA, J, MASS, Ntp)

    def seg_run(st):
        return run_segment_tracked(
            lat, params, st, n_sweeps, Ntp, dtp, False, kn["tracked_iters"],
            K, kn["refine_iters"], kn["polish_iters"], kn["ns_steps"],
            _rot(kn), exact_solver=solver, rot_scheme=kn["rot_scheme"],
            generator=gen)

    t0 = time.perf_counter()
    st, seg = seg_run(st)
    sync(device)
    log(f"[{Lp}x{Lp}/b{bp}] warm-up segment: "
        f"{time.perf_counter() - t0:.1f}s")
    times, dH_all = [], []
    for r in range(reps_p):
        t0 = time.perf_counter()
        st, seg = seg_run(st)
        acc = float(seg.accepted.float().mean())
        dH_all.append(seg.dH.double().cpu().numpy().ravel())
        times.append(time.perf_counter() - t0)
        log(f"[{Lp}x{Lp}/b{bp}] rep {r}: {times[-1]:.3f}s")
    best = min(times)
    dH_all = np.concatenate(dH_all)
    dH_fin = dH_all[np.isfinite(dH_all)]
    # reversibility diagnostic: a median dH under LAG_MED_DH marks the
    # tracked-lag regime where raw traj/s overstates honest sampling
    med_dH = float(np.median(dH_fin)) if dH_fin.size else None
    flops = tracked_model_flops(Lp, Ntp, bp, n_sweeps, kn["tracked_iters"],
                                K, kn["refine_iters"], kn["polish_iters"],
                                kn["ns_steps"], kn["rot_scheme"])
    rate = bp * n_sweeps / best
    ceiling = eigh.get("matmul_ceiling_bf16_tflops")
    leg = {"traj_per_sec": round(rate, 3), "acceptance": round(acc, 3),
           "segment_med_dH": None if med_dH is None else round(med_dH, 3),
           "lag_bias_flag": bool(med_dH is not None and med_dH < LAG_MED_DH),
           "effective_traj_per_sec": round(rate * acc, 3),
           "vs_baseline": round(rate / reference_cpu_traj_per_sec(Lp, Ntp),
                                2),
           "model_tflops": round(flops / best / 1e12, 2),
           "mfu_pct_nominal": round(100 * flops / best / 1e12
                                    / BF16_PEAK["tflops"], 2),
           # against the chained-matmul rate measured at this operand shape
           "mfu_pct_measured_ceiling": (
               None if not ceiling
               else round(100 * flops / best / 1e12 / ceiling, 1)),
           "config": {"Nt": Ntp, "sweeps": n_sweeps, "K": K,
                      "scheme": kn["rot_scheme"], "ns_steps": kn["ns_steps"],
                      "exact_solver": solver, "pallas_s": kn["pallas_s"],
                      "leapfrog_unroll": kn["leapfrog_unroll"]},
           **eigh, "peak_memory_gib": _peak_gib(device)}
    log(f"[{Lp}x{Lp}/b{bp}] {leg['traj_per_sec']} traj/s acc={acc:.3f} "
        f"{leg['model_tflops']} TF/s ({leg['mfu_pct_nominal']}% of "
        f"{BF16_PEAK['name']}) peak {leg['peak_memory_gib']} GiB")
    return leg


def bench(kn: dict, device, production: dict = PRODUCTION,
          capacity: dict = CAPACITY) -> tuple[dict, list]:
    """(the JSON line, the errors): the headline modes, then the shape
    legs at ``production``'s and ``capacity``'s depth."""
    device = resolve_device(device)
    L, batch, Nt, path = kn["L"], kn["batch"], kn["Nt"], kn["path"]
    errors = []
    log(f"bench: device={device_label(device)} batch={batch} L={L} Nt={Nt} "
        f"sweeps={kn['sweeps']} path={path} (BENCH_PALLAS_S and "
        "BENCH_LEAPFROG_UNROLL are recorded and select nothing)")
    lat = LatticeSpec(L, L)
    params = _params(device)
    gen = torch.Generator(device=device).manual_seed(0)
    init = init_ensemble_real if path == "real" else init_ensemble
    t0 = time.perf_counter()
    states = init(lat, params, gen, batch, dtype=torch.float32,
                  n_imp=PHYS["n_imp"], device=device)
    sync(device)
    log(f"init + first eigh: {time.perf_counter() - t0:.1f}s")

    eigh = {}
    if not kn["skip_eigh"]:
        try:
            eigh = eigh_figures(kn, lat, params, states, device)
        except Exception as e:  # noqa: BLE001 — recorded; exits nonzero
            log(f"eigh sub-bench failed: {_error(e, 200)}")
            errors.append(f"eigh: {_error(e)}")

    nt_th = kn["nt_therm"]
    dt_th = calc_optimal_dt(BETA, J, MASS, nt_th)
    t0 = time.perf_counter()
    if path == "real":
        states, seg = run_segment_tracked(lat, params, states, kn["therm"],
                                          nt_th, dt_th, False, 6,
                                          generator=gen)
    else:
        states, seg = run_segment(lat, params, states, kn["therm"], nt_th,
                                  dt_th, measure=False, generator=gen)
    log(f"therm ({kn['therm']} sweeps, Nt={nt_th}): "
        f"{time.perf_counter() - t0:.1f}s "
        f"acc={float(seg.accepted.float().mean()):.2f}")

    dt = calc_optimal_dt(BETA, J, MASS, Nt)
    results, mode_errors = {}, {}
    for mode in (kn["modes"] if path == "real" else ["exact"]):
        try:
            states, results[mode] = run_mode(kn, mode, lat, params, states,
                                             dt, gen, device)
        except Exception as e:  # noqa: BLE001 — recorded; exits nonzero
            log(f"[{mode}] FAILED: {_error(e, 200)}")
            mode_errors[mode] = _error(e)
            errors.append(f"{mode}: {_error(e)}")
            break
    del states
    if not results:
        return ({"metric": "bench_failed", "value": 0, "unit": "traj/s",
                 "vs_baseline": 0, "mode_errors": mode_errors}, errors)

    legs = {}
    for key, on, Lp, bp, depth in (
            ("production_24x24_b64", kn["production"], kn["prod_L"],
             kn["prod_B"], production),
            ("capacity_32x32_b40", kn["capacity"], kn["cap_L"], kn["cap_B"],
             capacity)):
        legs[key] = None
        if path != "real" or not on:
            continue
        try:
            legs[key] = shape_leg(kn, device, Lp, bp, **depth)
        except Exception as e:  # noqa: BLE001 — recorded; exits nonzero
            log(f"[{key}] FAILED: {_error(e, 200)}")
            legs[key] = {"error": _error(e)}
            errors.append(f"{key}: {_error(e)}")

    # headline = the best traj/s × acceptance: raw throughput with a
    # collapsed acceptance is not progress
    best_mode = max(results, key=lambda m: (results[m]["traj_per_sec"]
                                            * results[m]["acceptance"]))
    r = results[best_mode]
    eigh_ms, eigh_ph = eigh.get("eigh_ms"), eigh.get("eigh_ph_ms")
    line = {
        "metric": f"hmc_trajectories_per_sec_per_chip_{L}x{L}_b{batch}"
                  f"_Nt{Nt}",
        "value": round(r["traj_per_sec"], 3),
        "unit": "traj/s",
        "vs_baseline": round(r["traj_per_sec"]
                             / reference_cpu_traj_per_sec(L, Nt), 3),
        "baseline_note": ("vs documented CPU estimate "
                          "(reference publishes no numbers)"),
        "acceptance": round(r["acceptance"], 3),
        "effective_traj_per_sec": round(r["traj_per_sec"]
                                        * r["acceptance"], 3),
        "eigh_mode": best_mode,
        "modes": {m: {k: x for k, x in (
            ("traj_per_sec", round(v["traj_per_sec"], 3)),
            ("acceptance", round(v["acceptance"], 3)),
            ("model_tflops", v.get("model_tflops")),
            ("mfu_pct", v.get("mfu_pct"))) if x is not None}
            for m, v in results.items()},
        "eigh_ms": None if eigh_ms is None else round(eigh_ms, 3),
        "eigh_tflops_eff": (None if eigh_ms is None
                            else round(eigh["eigh_tflops_eff"], 2)),
        "eigh_ph_ms": None if eigh_ph is None else round(eigh_ph, 3),
        "eigh_ph_speedup": (None if eigh_ph is None
                            else round(eigh["eigh_ph_speedup"], 2)),
        **legs,
        "device": device_label(device),
        "times_s": r["times_s"],
    }
    if mode_errors:
        line["mode_errors"] = mode_errors
    if errors:
        line["errors"] = errors
    return line, errors


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def main(argv=None) -> dict:
    ns = parser().parse_args(argv)
    line, errors = bench(knobs(), ns.device)
    print(json.dumps(line), flush=True)
    if errors:
        raise SystemExit(f"bench: failed: {errors}")
    return line


if __name__ == "__main__":
    main(sys.argv[1:])
