"""A/B the rotation-path variants at the production shape (port of
``scripts/ab_rotation.py``): the exp2 rotation scheme, guarded-PH anchors
and iteration trims against the baseline (ns scheme, qdwh anchors).

    python -m dwavehmc_tpu_torch.drivers.ab_rotation [--device cuda|cpu]
        [--out runs/rotation_ab_<L>x<L>[_<suffix>].json]

Per variant: (a) the paired |dH_cheap − dH_exact| bias on identical
proposals (each proposal's one accept draw read by both accepts), (b) a
timed fast tracked segment (traj/s and acceptance, the better of two runs
after a warm one, with the segment's median dH and a lag-bias flag), (c)
model TFLOP/s under that variant's matmul count (``model_tflops``) and the
utilization against the H100's dense BF16 peak, which the JSON names.

``use_pallas_s`` is recorded as the table gives it and selects nothing:
the rotation kernel K1 runs wherever the tensors are on the card, so
``baseline`` and ``pallas`` run the same code there.

Environment knobs: AB_L (24), AB_BATCH (64), AB_NT (6), AB_THERM (10),
AB_PAIRED (3), AB_SWEEPS (10), AB_K (10), AB_ROT (bfloat16), AB_VARIANTS
(comma list to subset), AB_DT_FACTOR (1.0), AB_OUT_SUFFIX.  A variant that
fails is recorded with its error, the others still run, and the run then
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

from ..models.lattice import LatticeSpec
from ..models.params import make_params
from ..parallel.ensemble import (
    init_ensemble_real,
    run_segment_tracked,
    tracked_accept_exact,
)
from ..sampler.hmc import calc_optimal_dt
from ..sampler.hmc_real import tracked_accept_cheap, tracked_leapfrog
from ..utils.device import resolve_device
from ..utils.flops import BF16_PEAK, tracked_model_flops
from .validate_cheap_anchor import PHYS, device_label, log, sync

#: (tag, rot_scheme, ns_steps, use_pallas_s, exact_solver, overrides)
#: overrides: optional dict with tracked_iters / refine_iters /
#: polish_iters / polish_precision / polish_correction to probe trims
VARIANTS = [
    ("baseline", "ns", 2, False, "qdwh", {}),
    ("pallas", "ns", 2, True, "qdwh", {}),
    ("exp2", "exp2", 1, True, "qdwh", {}),
    ("exp2_ph", "exp2", 1, True, "ph", {}),
    ("exp2_ns0", "exp2", 0, True, "qdwh", {}),
    ("exp2_ph_t5", "exp2", 1, True, "ph", {"tracked_iters": 5}),
    ("exp2_ph_t4", "exp2", 1, True, "ph", {"tracked_iters": 4}),
    ("exp2_ph_r8", "exp2", 1, True, "ph", {"refine_iters": 8}),
    ("exp2_ph_hp", "exp2", 1, True, "ph", {"polish_precision": "high"}),
    ("ns_ph", "ns", 2, True, "ph", {}),
    ("ns_ph_r8", "ns", 2, True, "ph", {"refine_iters": 8}),
    ("ns_ph_hp", "ns", 2, True, "ph", {"polish_precision": "high"}),
    ("ns_ph_t5", "ns", 2, True, "ph", {"tracked_iters": 5}),
    ("combo", "ns", 2, True, "ph",
     {"tracked_iters": 5, "refine_iters": 8, "polish_precision": "high"}),
    ("combo_t4", "ns", 2, True, "ph",
     {"tracked_iters": 4, "refine_iters": 8, "polish_precision": "high"}),
    ("combo_p3", "ns", 2, True, "ph",
     {"tracked_iters": 5, "refine_iters": 8, "polish_iters": 3,
      "polish_precision": "high"}),
    ("ns_ph_pc", "ns", 2, True, "ph", {"polish_correction": True}),
    ("ns_ph_pc_p6", "ns", 2, True, "ph",
     {"polish_correction": True, "polish_iters": 6}),
    ("exp2e_ph", "exp2", 1, True, "ph", {}),
    ("exp2_ph_r8hp", "exp2", 1, True, "ph",
     {"refine_iters": 8, "polish_precision": "high"}),
    ("exp2_ph_r8hp_p3", "exp2", 1, True, "ph",
     {"refine_iters": 8, "polish_iters": 3, "polish_precision": "high"}),
    ("exp2_ph_r6", "exp2", 1, True, "ph", {"refine_iters": 6}),
    ("exp2_ph_r4", "exp2", 1, True, "ph", {"refine_iters": 4}),
    ("exp2_ph_r6_p3", "exp2", 1, True, "ph",
     {"refine_iters": 6, "polish_iters": 3}),
    ("exp2_ph_r6hp_p3", "exp2", 1, True, "ph",
     {"refine_iters": 6, "polish_iters": 3, "polish_precision": "high"}),
]
#: the JAX script's fixed settings
BETA, J, MASS = 10.0, 0.8, 1.0
REFINE_ITERS, TRACKED_ITERS, POLISH_ITERS = 12, 6, 4
NT_THERM = 20
#: the seed of the run's generator (the JAX script's PRNGKey(0))
SEED = 0
#: a segment median dH below this flags a lagging (non-reversible) basis
LAG_MED_DH = -0.5
USE_PALLAS_S_NOTE = ("use_pallas_s is recorded as given and selects "
                     "nothing: K1 runs wherever the tensors are on the card")


#: the variant's model FLOPs: the JAX script's ``model_tflops`` is the
#: benchmark's ``tracked_model_flops`` by another name
model_tflops = tracked_model_flops


def knobs(env=os.environ) -> dict:
    return dict(L=int(env.get("AB_L", 24)), batch=int(env.get("AB_BATCH", 64)),
                Nt=int(env.get("AB_NT", 6)),
                therm=int(env.get("AB_THERM", 10)),
                paired=int(env.get("AB_PAIRED", 3)),
                sweeps=int(env.get("AB_SWEEPS", 10)),
                K=int(env.get("AB_K", 10)),
                rot=env.get("AB_ROT", "bfloat16"),
                variants=env.get("AB_VARIANTS"),
                dt_factor=float(env.get("AB_DT_FACTOR", 1.0)),
                suffix=env.get("AB_OUT_SUFFIX", ""))


def select(names: str | None) -> list:
    """The rows of ``VARIANTS`` named in the comma list (all for None)."""
    if names is None:
        return list(VARIANTS)
    missing = set(names.split(",")) - {v[0] for v in VARIANTS}
    if missing:
        raise ValueError(f"unknown variants: {sorted(missing)}")
    return [v for v in VARIANTS if v[0] in names.split(",")]


def variant_row(lat, params, states, kn, dt, variant, gen, device) -> dict:
    """One variant's record: paired bias, timed segment, model TFLOP/s."""
    tag, scheme, ns, pallas_s, solver, ov = variant
    L, batch, Nt, K, sweeps = (kn[k] for k in ("L", "batch", "Nt", "K",
                                               "sweeps"))
    rot = torch.bfloat16 if kn["rot"] == "bfloat16" else None
    t_it = ov.get("tracked_iters", TRACKED_ITERS)
    r_it = ov.get("refine_iters", REFINE_ITERS)
    p_it = ov.get("polish_iters", POLISH_ITERS)
    p_prec = ov.get("polish_precision", "highest")
    p_corr = ov.get("polish_correction", False)

    # paired dH bias on identical proposals (cheap vs exact)
    st, errs, errs_nonfinite = states, [], 0
    t0 = time.perf_counter()
    for _ in range(kn["paired"]):
        prop = tracked_leapfrog(lat, params, st, Nt, dt, t_it, r_it, p_it,
                                ns, rot, p_prec, p_corr, scheme,
                                generator=gen)
        _, info_cheap = tracked_accept_cheap(lat, params, st, prop)
        st, info_exact = tracked_accept_exact(lat, params, st, prop, solver)
        dc = info_cheap.dH.double().cpu().numpy()
        de = info_exact.dH.double().cpu().numpy()
        # a diverged proposal has non-finite dH on both sides and is
        # rejected by both: not a bias; compare where both are finite
        both = np.isfinite(dc) & np.isfinite(de)
        errs.append(np.abs(dc[both] - de[both]))
        errs_nonfinite += int((~both).sum())
    errs = np.concatenate(errs)
    log(f"[{tag}] paired pass: {time.perf_counter() - t0:.1f}s "
        f"max|ddH|={errs.max():.3e} (nonfinite pairs {errs_nonfinite})")

    def seg_run(st):
        return run_segment_tracked(
            lat, params, st, sweeps, Nt, dt, False, t_it, K, r_it, p_it, ns,
            rot, exact_solver=solver, polish_precision=p_prec,
            polish_correction=p_corr, rot_scheme=scheme, generator=gen)

    t0 = time.perf_counter()
    st2, seg = seg_run(states)
    sync(device)
    log(f"[{tag}] segment warm run: {time.perf_counter() - t0:.1f}s")
    times, dH_all = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        st2, seg = seg_run(st2)
        acc = float(seg.accepted.float().mean())
        dH_all.append(seg.dH.double().cpu().numpy().ravel())
        times.append(time.perf_counter() - t0)
    t_best = min(times)
    dH_all = np.concatenate(dH_all)
    dH_fin = dH_all[np.isfinite(dH_all)]
    # a reversible proposal at equilibrium has median dH >= ~0; a trimmed
    # tracked basis can lag, pinning acceptance near 1 with median dH < 0
    med_dH = float(np.median(dH_fin)) if dH_fin.size else None
    flops = model_tflops(L, Nt, batch, sweeps, t_it, K, r_it, p_it, ns,
                         scheme)
    return {"variant": tag, "rot_scheme": scheme, "ns_steps": ns,
            "use_pallas_s": pallas_s, "exact_solver": solver, **ov,
            "max_dH_err": float(errs.max()),
            "mean_dH_err": float(errs.mean()),
            "paired_nonfinite": errs_nonfinite,
            "traj_per_sec": round(batch * sweeps / t_best, 2),
            "acceptance": round(acc, 4),
            "segment_med_dH": None if med_dH is None else round(med_dH, 4),
            "segment_mean_dH": (None if not dH_fin.size
                                else round(float(dH_fin.mean()), 4)),
            "lag_bias_flag": bool(med_dH is not None and med_dH < LAG_MED_DH),
            "model_tflops": round(flops / t_best / 1e12, 2),
            "mfu_pct_nominal": round(flops / t_best / 1e12
                                     / BF16_PEAK["tflops"] * 100, 2),
            "wall_s": round(t_best, 3)}


def ab_rotation(kn: dict, variants, device, log=log) -> dict:
    device = resolve_device(device)
    L, batch = kn["L"], kn["batch"]
    lat = LatticeSpec(L, L)
    params = make_params(beta=BETA, J=J, dtype=torch.float32, device=device,
                         **dict(PHYS, mass=MASS))
    # AB_DT_FACTOR scales the harmonic-heuristic dt: at 24×24 the K = 10
    # cheap-anchor mode at full dt0 sits in the proposal-lag regime
    dt = kn["dt_factor"] * calc_optimal_dt(BETA, J, MASS, kn["Nt"])
    log(f"ab_rotation: device={device_label(device)} L={L} batch={batch} "
        f"K={kn['K']} rot={kn['rot']} variants={[v[0] for v in variants]}")

    gen = torch.Generator(device=device).manual_seed(SEED)
    t0 = time.perf_counter()
    states = init_ensemble_real(lat, params, gen, batch, dtype=torch.float32,
                                n_imp=PHYS["n_imp"], device=device)
    sync(device)
    log(f"init: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    states, seg = run_segment_tracked(
        lat, params, states, kn["therm"], NT_THERM,
        calc_optimal_dt(BETA, J, MASS, NT_THERM), False, TRACKED_ITERS,
        generator=gen)
    log(f"therm {time.perf_counter() - t0:.1f}s "
        f"acc={float(seg.accepted.float().mean()):.2f}")

    results = []
    for v in variants:
        try:
            row = variant_row(lat, params, states, kn, dt, v, gen, device)
        # one variant must not kill the A/B; main exits nonzero after
        except Exception as e:  # noqa: BLE001
            log(f"[{v[0]}] FAILED: {type(e).__name__}: {str(e)[:200]}")
            results.append({"variant": v[0], "error":
                            f"{type(e).__name__}: {str(e)[:200]}"})
            continue
        results.append(row)
        log(f"[{row['variant']}] {row['traj_per_sec']} traj/s "
            f"acc={row['acceptance']:.3f} med_dH={row['segment_med_dH']} "
            f"{row['model_tflops']} TF/s ({row['mfu_pct_nominal']}% "
            "nominal)")

    return {"config": {"L": L, "batch": batch, "Nt": kn["Nt"], "K": kn["K"],
                       "dt_factor": kn["dt_factor"], "rot_dtype": kn["rot"],
                       "refine_iters": REFINE_ITERS,
                       "polish_iters": POLISH_ITERS, "sweeps": kn["sweeps"],
                       "paired": kn["paired"], "nominal_peak": BF16_PEAK,
                       "use_pallas_s": USE_PALLAS_S_NOTE},
            "device": device_label(device), "results": results}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=None,
                   help="default: runs/rotation_ab_<L>x<L>[_<suffix>].json")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def main(argv=None) -> dict:
    ns = parser().parse_args(argv)
    kn = knobs()
    out = ab_rotation(kn, select(kn["variants"]), ns.device)
    suffix = f"_{kn['suffix']}" if kn["suffix"] else ""
    path = ns.out or os.path.join(
        "runs", f"rotation_ab_{kn['L']}x{kn['L']}{suffix}.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    log(f"wrote {path}")
    print(json.dumps(out))
    failed = [r["variant"] for r in out["results"] if "error" in r]
    if failed:
        raise SystemExit(f"ab_rotation: variants failed: {failed}")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
