"""A/B the cheap anchor's endpoint-polish variants (port of
``scripts/ab_polish.py``): wall time of a fast tracked segment against the
paired |dH_cheap − dH_exact| bias, across (polish_iters, polish_precision,
polish_correction):

    python -m dwavehmc_tpu_torch.drivers.ab_polish [--device cuda|cpu]
        [--out runs/polish_ab.json]

Two cost levers against the baseline (4 iterations, "highest", no
correction):

* ``polish_precision="high"``: the polish rotations' products as three
  TF32 passes on the card (basis noise enters dH at second order; the
  readout stays "highest");
* ``polish_correction``: the O(n²) second-order Rayleigh readout correction
  (``ops/tracked_eigh.rayleigh_corrected_evals``) in place of O(n³)
  rotations.

For each variant: ``AB_PAIRED`` proposals scored by the cheap and the exact
accept (one draw each, the proposal's), then a segment of ``AB_SWEEPS``
sweeps with an exact anchor every ``AB_K``, run once to warm up and twice
timed (the faster counts).  Environment knobs: AB_L (16), AB_BATCH (8),
AB_NT (6), AB_THERM (10), AB_PAIRED (6), AB_SWEEPS (20), AB_K (10), AB_ROT
(bfloat16).  The JSON goes to ``--out`` (default under ``runs/``); the last
line printed is the baseline's traj/s and the fastest variant under 3e-3
bias.
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
    DrawStream,
    init_ensemble_real,
    run_segment_tracked,
    tracked_accept_exact,
)
from ..sampler.hmc import calc_optimal_dt
from ..sampler.hmc_real import tracked_accept_cheap, tracked_leapfrog
from ..utils.device import resolve_device
from .validate_cheap_anchor import PHYS, device_label, log, sync

DEFAULT_OUT = os.path.join("runs", "polish_ab.json")

CONFIGS = [
    # (polish_iters, polish_precision, polish_correction)
    (4, "highest", False),   # baseline
    (4, "high", False),      # cheaper rotations
    (2, "high", True),       # correction replaces 2 rotations
    (1, "high", True),
    (2, "highest", True),
    (0, "highest", True),    # correction only (refine-phase readout)
]
#: the JAX script's fixed settings
BETA, J, MASS = 10.0, 0.8, 1.0
REFINE_ITERS, TRACKED_ITERS, NS_STEPS = 12, 6, 2
#: the seed of the run's generator (the JAX script's PRNGKey(0))
SEED = 0
#: a variant under this paired bias may be called the best
BEST_MAX_DH_ERR = 3e-3


def knobs(env=os.environ) -> dict:
    return dict(L=int(env.get("AB_L", 16)), batch=int(env.get("AB_BATCH", 8)),
                Nt=int(env.get("AB_NT", 6)),
                therm=int(env.get("AB_THERM", 10)),
                paired=int(env.get("AB_PAIRED", 6)),
                sweeps=int(env.get("AB_SWEEPS", 20)),
                K=int(env.get("AB_K", 10)),
                rot=env.get("AB_ROT", "bfloat16"))


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def ab_polish(kn: dict, configs, device, log=log) -> dict:
    """The report of ``configs`` at the knobs ``kn``: its ``results`` rows
    (bias, traj/s, acceptance, wall seconds per variant)."""
    device = resolve_device(device)
    L, batch, Nt, K = kn["L"], kn["batch"], kn["Nt"], kn["K"]
    rot = torch.bfloat16 if kn["rot"] == "bfloat16" else None
    lat = LatticeSpec(L, L)
    params = make_params(beta=BETA, J=J, dtype=torch.float32, device=device,
                         **dict(PHYS, mass=MASS))
    dt = calc_optimal_dt(BETA, J, MASS, Nt)
    log(f"ab_polish: device={device_label(device)} L={L} batch={batch} "
        f"K={K} rot={kn['rot']}")

    gen = torch.Generator(device=device).manual_seed(SEED)
    states = init_ensemble_real(lat, params, gen, batch, dtype=torch.float32,
                                n_imp=PHYS["n_imp"], device=device)
    states, seg = run_segment_tracked(
        lat, params, states, kn["therm"], 20,
        calc_optimal_dt(BETA, J, MASS, 20), False, TRACKED_ITERS,
        generator=gen)
    log(f"therm acc={float(seg.accepted.float().mean()):.2f}")
    stream = DrawStream(gen, (batch, 2, lat.n_sites, 2), torch.float32,
                        device)

    results = []
    for p_iters, p_prec, p_corr in configs:
        st, errs = states, []
        for i in range(kn["paired"]):
            n, u = stream.take(i, 1)
            prop = tracked_leapfrog(
                lat, params, st, Nt, dt, TRACKED_ITERS, REFINE_ITERS,
                p_iters, NS_STEPS, rot, p_prec, p_corr, normals=n[0],
                uniforms=u[0])
            _, info_cheap = tracked_accept_cheap(lat, params, st, prop)
            st, info_exact = tracked_accept_exact(lat, params, st, prop)
            errs.append((info_cheap.dH.double() - info_exact.dH.double())
                        .abs().cpu().numpy())
        errs = np.concatenate(errs)

        def seg_run(st):
            return run_segment_tracked(
                lat, params, st, kn["sweeps"], Nt, dt, False, TRACKED_ITERS,
                K, REFINE_ITERS, p_iters, NS_STEPS, rot,
                polish_precision=p_prec, polish_correction=p_corr,
                generator=gen)

        st2, seg = seg_run(states)           # warm
        sync(device)
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            st2, seg = seg_run(st2)
            acc = float(seg.accepted.float().mean())
            times.append(time.perf_counter() - t0)
        t_best = min(times)
        row = {"polish_iters": p_iters, "polish_precision": p_prec,
               "polish_correction": p_corr,
               "max_dH_err": float(errs.max()),
               "mean_dH_err": float(errs.mean()),
               "traj_per_sec": round(batch * kn["sweeps"] / t_best, 2),
               "acceptance": acc, "wall_s": round(t_best, 3)}
        results.append(row)
        log(f"iters={p_iters} prec={p_prec} corr={p_corr}: "
            f"max|ddH|={row['max_dH_err']:.3e} {row['traj_per_sec']} traj/s "
            f"acc={acc:.3f}")

    return {"config": {"L": L, "batch": batch, "Nt": Nt, "K": K,
                       "rot_dtype": kn["rot"], "refine_iters": REFINE_ITERS,
                       "sweeps": kn["sweeps"], "paired": kn["paired"]},
            "device": device_label(device), "results": results}


def best_of(results: list) -> dict:
    return max(results, key=lambda r: (r["max_dH_err"] < BEST_MAX_DH_ERR,
                                       r["traj_per_sec"]))


def main(argv=None) -> dict:
    ns = parser().parse_args(argv)
    out = ab_polish(knobs(), CONFIGS, ns.device)
    os.makedirs(os.path.dirname(os.path.abspath(ns.out)), exist_ok=True)
    with open(ns.out, "w") as f:
        json.dump(out, f, indent=1)
    log(f"wrote {ns.out}")
    print(json.dumps({"baseline_traj_per_sec":
                      out["results"][0]["traj_per_sec"],
                      "best": best_of(out["results"])}))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
