"""32×32 lattice demonstration, BASELINE config 5's largest shape (port of
``scripts/demo_32x32.py``).

    [DEMO_L=32 DEMO_BATCH=2 ...] python -m dwavehmc_tpu_torch.drivers.demo_32x32
        [--device cuda|cpu] [--out runs/demo_32x32.json]

A short disordered HMC run at 32×32 (2N = 2048, real embedding dimension
4096) on the tracked sampler: ``init_ensemble_real`` (the full-embedding
eigh), a thermalization of DEMO_THERM sweeps at Nt = 20, then two measured
segments of DEMO_SWEEPS sweeps at DEMO_NT (anchor every DEMO_ANCHOR_EVERY
sweeps, endpoint refine 12 / polish 6, bf16 in-trajectory rotations unless
DEMO_ROT_DTYPE says otherwise), then one transport pass on the grid
η = 8/N, Δω = 0.02, ω_max = DEMO_OMEGA_MAX.  Throughput, acceptance and the
transport observables go to ``--out`` (default under ``runs/``) under the
JAX script's keys, with ``"device"`` the card's name.

The JAX script logs its first measured segment as "compile+run": there it
includes the compile.  Eager PyTorch compiles nothing, so here that line is
the first call of the segment (library set-up included) and the warm
second call is the headline, as there.

Environment knobs: DEMO_L (32), DEMO_BATCH (2), DEMO_THERM (8), DEMO_SWEEPS
(10), DEMO_NT (6), DEMO_ANCHOR_EVERY (5), DEMO_OMEGA_MAX (2.0),
DEMO_ROT_DTYPE (bfloat16; anything else means float32 rotations).
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
from ..models.params import SpectralSpec, make_params
from ..parallel.ensemble import (
    DrawStream,
    ensemble_transport_real,
    init_ensemble_real,
    run_segment_tracked,
)
from ..sampler.hmc import calc_optimal_dt
from ..utils.device import resolve_device

DEFAULT_OUT = os.path.join("runs", "demo_32x32.json")
#: the run's couplings (the JAX script's)
PHYS = dict(t=1.0, tp=-0.35, mu=-1.08, W=1.0, n_imp=0.05)
BETA, J, MASS = 10.0, 0.8, 1.0
#: thermalization's leapfrog length
NT_THERM = 20
#: the tracked settings of every segment (the JAX script's positional
#: arguments after ``anchor_every``)
TRACK = dict(tracked_iters=6, refine_iters=12, polish_iters=6, ns_steps=2)
#: the seed of the run's generator (the JAX script's PRNGKey(0))
SEED = 0


def knobs(env=os.environ) -> dict:
    return dict(L=int(env.get("DEMO_L", 32)),
                batch=int(env.get("DEMO_BATCH", 2)),
                therm=int(env.get("DEMO_THERM", 8)),
                sweeps=int(env.get("DEMO_SWEEPS", 10)),
                Nt=int(env.get("DEMO_NT", 6)),
                anchor_every=int(env.get("DEMO_ANCHOR_EVERY", 5)),
                omega_max=float(env.get("DEMO_OMEGA_MAX", 2.0)),
                rot_dtype=env.get("DEMO_ROT_DTYPE", "bfloat16"))


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().to("cpu", torch.float64).numpy()


def demo(kn: dict, device, *, init=None, stream: DrawStream | None = None,
         log=None):
    """(the JSON record, the final states, the segments' records).

    ``init`` = (disorder, Δ_re, Δ_im) replaces the initial draws and
    ``stream`` every sweep's draws (the thermalization's first, then the
    two measured segments'), as a test hands in the JAX run's; by default
    both come from a generator seeded with ``SEED``."""
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    device = resolve_device(device)
    L, batch, Nt, K = kn["L"], kn["batch"], kn["Nt"], kn["anchor_every"]
    log(f"demo_32x32: device={device_name(device)} L={L} batch={batch} "
        f"therm={kn['therm']} sweeps={kn['sweeps']} Nt={Nt} K={K}")
    lat = LatticeSpec(L, L)
    params = make_params(beta=BETA, J=J, mass=MASS, dtype=torch.float32,
                         device=device, **PHYS)
    gen = torch.Generator(device=device).manual_seed(SEED)
    given = {} if init is None else dict(zip(
        ("disorder", "delta0_re", "delta0_im"), init))

    t0 = time.perf_counter()
    states = init_ensemble_real(lat, params, gen, batch, dtype=torch.float32,
                                n_imp=PHYS["n_imp"], device=device, **given)
    sync(device)
    t_init = time.perf_counter() - t0
    log(f"init+first exact eigh (dim {2 * lat.dim}): {t_init:.1f}s")
    if stream is None:
        stream = DrawStream(gen, (batch, 2, lat.n_sites, 2), torch.float32,
                            device)
    rot = torch.bfloat16 if kn["rot_dtype"] == "bfloat16" else None
    segs = []

    def segment(states, start, n, nt, dt, measure):
        normals, uniforms = stream.take(start, n)
        states, seg = run_segment_tracked(
            lat, params, states, n, nt, dt, measure, anchor_every=K,
            rot_dtype=rot, normals=normals, uniforms=uniforms, **TRACK)
        sync(device)
        segs.append(seg)
        return states, seg

    # thermalize with the tracked runner (not timed for the headline)
    n_therm, sweeps = kn["therm"], kn["sweeps"]
    t0 = time.perf_counter()
    states, seg = segment(states, 0, n_therm, NT_THERM,
                          calc_optimal_dt(BETA, J, MASS, NT_THERM), False)
    acc_th = float(seg.accepted.float().mean())
    t_therm = time.perf_counter() - t0
    log(f"therm ({n_therm} sweeps, Nt={NT_THERM}): {t_therm:.1f}s "
        f"acc={acc_th:.2f}")

    dt = calc_optimal_dt(BETA, J, MASS, Nt)
    t0 = time.perf_counter()
    states, seg = segment(states, n_therm, sweeps, Nt, dt, True)
    t_first = time.perf_counter() - t0
    log(f"measure segment compile+run (first call): {t_first:.1f}s "
        f"acc={float(seg.accepted.float().mean()):.2f}")
    t0 = time.perf_counter()
    states, seg = segment(states, n_therm + sweeps, sweeps, Nt, dt, True)
    t_meas = time.perf_counter() - t0
    traj_per_sec = batch * sweeps / t_meas
    acceptance = float(seg.accepted.float().mean())
    energy = _np(seg.observables.total_energy)
    delta_amp = _np(seg.observables.delta_amp)
    log(f"measure segment (warm): {t_meas:.1f}s -> {traj_per_sec:.2f} "
        f"traj/s acc={acceptance:.2f}")

    # transport/spectra pass on the (exact-anchored) final eigenpairs
    spec = SpectralSpec(eta=8.0 / lat.n_sites, domega=0.02,
                        omega_max=kn["omega_max"])
    t0 = time.perf_counter()
    spectra = ensemble_transport_real(lat, spec, params, states)
    rho_s = _np(spectra.superfluid_stiffness)
    sigma_dc = _np(spectra.dc_conductivity)
    t_trans = time.perf_counter() - t0
    log(f"transport pass: {t_trans:.1f}s rho_s={rho_s.tolist()} "
        f"sigma_dc={sigma_dc.tolist()}")

    out = {
        "config": {"L": L, "batch": batch, "beta": BETA, "J": J, "Nt": Nt,
                   "anchor_every": K, "n_therm": n_therm,
                   "sweeps": sweeps, "bdg_dim": 2 * lat.n_sites,
                   "embedding_dim": 4 * lat.n_sites,
                   "eta": spec.eta, "domega": spec.domega,
                   "omega_max": kn["omega_max"]},
        "device": device_name(device),
        "timings_s": {"init_first_eigh": round(t_init, 1),
                      "therm": round(t_therm, 1),
                      "measure_warm": round(t_meas, 1),
                      "transport": round(t_trans, 1)},
        "traj_per_sec": round(traj_per_sec, 3),
        "acceptance": acceptance,
        "acceptance_therm": acc_th,
        "energy_mean": float(np.mean(energy)),
        "delta_amp_mean": float(np.mean(delta_amp)),
        "superfluid_stiffness": rho_s.tolist(),
        "dc_conductivity": sigma_dc.tolist(),
        "finite": bool(np.all(np.isfinite(energy))
                       and np.all(np.isfinite(rho_s))
                       and np.all(np.isfinite(sigma_dc))),
    }
    return out, states, segs


def main(argv=None) -> dict:
    """Run, write ``--out`` and print the summary line; returns the
    record."""
    ns = parser().parse_args(argv)
    out, _, _ = demo(knobs(), ns.device)
    os.makedirs(os.path.dirname(os.path.abspath(ns.out)), exist_ok=True)
    with open(ns.out, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {ns.out}", file=sys.stderr)
    print(json.dumps({"L": out["config"]["L"],
                      "traj_per_sec": out["traj_per_sec"],
                      "acceptance": out["acceptance"],
                      "rho_s_mean": float(np.mean(
                          out["superfluid_stiffness"])),
                      "finite": out["finite"]}))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
