"""Probe the deep-cold (β ≥ 1e4) acceptance collapse on the clean 12×12
lattice (port of ``scripts/probe_beta_dt.py``): is |dH| integrator error
(scaling ~dt²) or a float32 conditioning floor (independent of dt)?

    python -m dwavehmc_tpu_torch.drivers.probe_beta_dt [--device cuda|cpu]
        [--out runs/beta_dt_probe.json]

A briefly thermalized ensemble (10 exact-anchored sweeps at Nt = 20 and
dt0/4) runs 8 exact-anchored tracked sweeps at dt0, dt0/2, dt0/4 and
dt0/8, each from the same state with the same draws; mean and median |dH|
and the acceptance per dt are printed and written to ``--out`` (default
under ``runs/``).  Environment knobs: PROBE_BETA (1e4), PROBE_L (12),
PROBE_B (4 chains), PROBE_NT (6).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..models.lattice import LatticeSpec
from ..models.params import make_params
from ..parallel.ensemble import (
    DrawStream,
    init_ensemble_real,
    run_segment_tracked,
)
from ..sampler.hmc import calc_optimal_dt
from ..utils.device import resolve_device

DEFAULT_OUT = os.path.join("runs", "beta_dt_probe.json")
DT_SCALES = (1.0, 0.5, 0.25, 0.125)
#: the segments' tracked settings: 6 rotations per step, an exact anchor
#: every sweep (refine 12 / polish 4 / 2 Newton–Schulz steps, unused at K=1)
SEGMENT = dict(tracked_iters=6, anchor_every=1, refine_iters=12,
               polish_iters=4, ns_steps=2, rot_dtype=None)


def knobs(env=os.environ) -> dict:
    return dict(beta=float(env.get("PROBE_BETA", 1e4)),
                L=int(env.get("PROBE_L", 12)), b=int(env.get("PROBE_B", 4)),
                Nt=int(env.get("PROBE_NT", 6)))


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def probe(kn: dict, device, *, therm: int = 10, sweeps: int = 8,
          states=None, therm_draws=None, probe_draws=None, log=None) -> dict:
    """The probe's record after ``therm`` thermalization sweeps, with
    ``sweeps`` sweeps per dt.  ``states`` replaces the initial ensemble
    drawn from a generator seeded with 0; ``therm_draws`` and
    ``probe_draws`` ((normals, uniforms) of the thermalization and of each
    dt's segment) replace its sweep draws."""
    log = log or (lambda s: print(s, file=sys.stderr))
    device = resolve_device(device)
    b, Nt = kn["b"], kn["Nt"]
    lat = LatticeSpec(kn["L"], kn["L"])
    params = make_params(t=1.0, tp=-0.35, mu=-1.08, W=1.0, n_imp=0.0,
                         beta=kn["beta"], J=0.8, mass=1.0,
                         dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    if states is None:
        states = init_ensemble_real(lat, params, gen, b, dtype=torch.float32,
                                    n_imp=0.0, device=device)
    log("init done")

    dt0 = calc_optimal_dt(kn["beta"], 0.8, 1.0, Nt)
    stream = DrawStream(gen, (b, 2, lat.n_sites, 2), torch.float32, device)

    # a short thermalization at a shrunken dt, so that the probe's states
    # are not cold-start outliers (the acceptance may still be ~0)
    dtv = torch.full((b,), dt0 * 0.25, dtype=torch.float32, device=device)
    n, u = therm_draws or stream.take(0, therm)
    states, seg = run_segment_tracked(lat, params, states, therm, 20,
                                      dtv, False, normals=n, uniforms=u,
                                      **SEGMENT)
    log(f"therm acc={float(seg.accepted.float().mean()):.2f}")

    out = {"beta": kn["beta"], "L": kn["L"], "batch": b, "Nt": Nt,
           "dt0": float(dt0), "points": []}
    n, u = probe_draws or stream.take(therm, sweeps)
    for scale in DT_SCALES:
        dtv = torch.full((b,), dt0 * scale, dtype=torch.float32,
                         device=device)
        _, seg = run_segment_tracked(lat, params, states, sweeps, Nt,
                                     dtv, False, normals=n, uniforms=u,
                                     **SEGMENT)
        dH = seg.dH.to("cpu", torch.float64).numpy()
        rec = {"dt_scale": scale, "mean_absdH": float(np.mean(np.abs(dH))),
               "med_absdH": float(np.median(np.abs(dH))),
               "acc": float(seg.accepted.float().mean())}
        out["points"].append(rec)
        log(str(rec))

    p = out["points"]
    if p[0]["med_absdH"] > 0 and p[2]["med_absdH"] > 0:
        out["ratio_dt0_over_quarter"] = p[0]["med_absdH"] / p[2]["med_absdH"]
    return out


def main(argv=None) -> dict:
    ns = parser().parse_args(argv)
    out = probe(knobs(), ns.device)
    os.makedirs(os.path.dirname(os.path.abspath(ns.out)), exist_ok=True)
    with open(ns.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
