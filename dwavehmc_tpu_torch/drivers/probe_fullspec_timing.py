"""Timing probe at the full-spec production shapes, to size a T scan (port
of ``scripts/probe_fullspec_timing.py``).

    [PROBE_B=72 PROBE_L=24] python -m \\
        dwavehmc_tpu_torch.drivers.probe_fullspec_timing [--device cuda|cpu]

PROBE_B chains at PROBE_L × PROBE_L (the β of the production 24-point T
grid, each repeated PROBE_B // 24 times, so a batch under 24 has no β and
fails as the JAX script does), initialized with the full-embedding eigh:
two reps each of one exact-anchored tracked sweep at Nt = 20 and at Nt = 6
(per-chain dt, refine 12 / polish 4), then two transport passes on the
``RunConfig().spectral()`` grid.  Each time is printed to stderr as the JAX
script prints it.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..parallel.ensemble import (
    DrawStream,
    ensemble_transport_real,
    init_ensemble_real,
    run_segment_tracked,
)
from ..sampler.hmc import calc_optimal_dt
from ..utils.config import RunConfig
from ..utils.device import resolve_device
from .scan import _broadcast_params, default_T_grid

#: the legs: (label, Nt)
LEGS = (("therm Nt=20", 20), ("meas Nt=6", 6))
#: the seed of the run's generator (the JAX script's PRNGKey(0))
SEED = 0


def knobs(env=os.environ) -> dict:
    return dict(B=int(env.get("PROBE_B", "72")),
                L=int(env.get("PROBE_L", "24")))


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def probe(kn: dict, device, *, reps: int = 2, init=None,
          stream: DrawStream | None = None, log=None) -> dict:
    """The probe's timings: ``{"n_omega", "legs": [{tag, rep, seconds,
    acc, accepted (per chain)}], "transport": [{rep, seconds, rho0}]}``.
    ``init`` = (disorder, Δ_re, Δ_im) and ``stream`` replace the initial
    ensemble's and the sweeps' draws (the Nt = 20 reps' first)."""
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    device = resolve_device(device)
    B, L = kn["B"], kn["L"]
    cfg = RunConfig(Lx=L, Ly=L, W=1.0, n_imp=0.05, J=0.8)
    lat = cfg.lattice()
    spec = cfg.spectral()
    log(f"probe: {L}x{L} b{B}, n_omega={spec.n_omega}")

    Ts = default_T_grid(24, 1e-4, 1e3)
    betas = np.repeat(1.0 / Ts, B // 24)[:B]
    base = cfg.params(device)
    params = _broadcast_params(base, B, beta=betas)
    gen = torch.Generator(device=device).manual_seed(SEED)
    given = {} if init is None else dict(zip(
        ("disorder", "delta0_re", "delta0_im"), init))
    states = init_ensemble_real(lat, base, gen, B, dtype=torch.float32,
                                n_imp=cfg.n_imp, device=device, **given)
    sync(device)
    log("init done")
    if stream is None:
        stream = DrawStream(gen, (B, 2, lat.n_sites, 2), torch.float32,
                            device)

    out = {"n_omega": spec.n_omega, "legs": [], "transport": []}
    sweep = 0
    for tag, Nt in LEGS:
        dts = torch.tensor([calc_optimal_dt(b, 0.8, 1.0, Nt) for b in betas],
                           dtype=torch.float32, device=device)
        for rep in range(reps):
            normals, uniforms = stream.take(sweep, 1)
            sweep += 1
            t0 = time.time()
            states, seg = run_segment_tracked(
                lat, params, states, 1, Nt, dts, False, tracked_iters=6,
                anchor_every=1, refine_iters=12, polish_iters=4, ns_steps=2,
                normals=normals, uniforms=uniforms)
            sync(device)
            dt_s = time.time() - t0
            acc = float(seg.accepted.float().mean())
            out["legs"].append({"tag": tag, "rep": rep, "seconds": dt_s,
                                "acc": acc,
                                "accepted": seg.accepted[0].tolist()})
            log(f"{tag} rep{rep}: {dt_s:.2f}s/sweep  acc={acc:.2f}")

    for rep in range(reps):
        t0 = time.time()
        res = ensemble_transport_real(lat, spec, params, states)
        sync(device)
        dt_s = time.time() - t0
        rho0 = float(res.superfluid_stiffness[0])
        out["transport"].append({"rep": rep, "seconds": dt_s, "rho0": rho0})
        log(f"transport rep{rep}: {dt_s:.2f}s rho[0]={rho0:.4f}")
    return out


def main(argv=None) -> dict:
    ns = parser().parse_args(argv)
    return probe(knobs(), ns.device)


if __name__ == "__main__":
    main(sys.argv[1:])
