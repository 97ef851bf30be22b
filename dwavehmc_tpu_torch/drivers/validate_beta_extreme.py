"""Validate the deep-cold end of the β scan (port of
``scripts/validate_beta_extreme.py``): the 12×12 clean lattice at β = 1e4
and 1e5, through ``run_scan_vectorized`` with the host float64 Metropolis
readout and a β-ladder warm start:

    python -m dwavehmc_tpu_torch.drivers.validate_beta_extreme
        [--device cuda|cpu] [--report_only] [--root runs/beta_extreme_12x12]
        [--out runs/beta_extreme_validation.json]
        [--n_therm 20 --n_measure 50 --anneal_stages 10 --anneal_sweeps 5]

Pass criteria:

* acceptance inside [0.60, 0.999] at both β, and every recorded dH finite;
* ground-state saturation: |Δ_global| and ρ_s at β = 1e5 agree with
  β = 1e4 within 5 combined SEM, or within 0.25 % relative when the
  combined SEM itself is below 0.1 % of the value.

The scan never cold-starts β = 1e5: ``anneal_stages`` × ``anneal_sweeps``
of a geometric ramp from β = 100 equilibrate each intermediate temperature
first.  ``--report_only`` re-derives the report from the scan output under
``--root`` (``beta_<value>/observables.csv`` and ``transport.csv``, the
names of ``utils/io.py``).  The JSON goes to ``--out`` (default under
``runs/``).  Run as a program, the quick tier (``utils/quickcheck``) runs
first.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..utils.config import RunConfig
from ..utils.device import resolve_device
from ..utils.quickcheck import run_quick_suite
from .scan import run_scan_vectorized

BETAS = [1e4, 1e5]
#: the clean lattice's side
L = 12
DEFAULT_ROOT = os.path.join("runs", "beta_extreme_12x12")
DEFAULT_OUT = os.path.join("runs", "beta_extreme_validation.json")
#: the device float32 readout's failure on the same scan, as the JAX
#: package measured it on a TPU: a record of that chip, not of this port
TPU_DEVICE_READOUT = {
    "note": "same scan with the on-device f32 dH, measured with the JAX "
            "package on a TPU v5 lite (2026-08-20), not on this device: "
            "the f32 conditioning wall",
    "beta_1e+04": {"acceptance": 0.39, "dH_absmean": 1.07},
    "beta_1e+05": {"acceptance": 0.20, "dH_absmean": 3.46},
}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--report_only", action="store_true")
    p.add_argument("--n_therm", type=int, default=20)
    p.add_argument("--n_measure", type=int, default=50)
    p.add_argument("--anneal_stages", type=int, default=10)
    p.add_argument("--anneal_sweeps", type=int, default=5)
    p.add_argument("--root", default=DEFAULT_ROOT)
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def scan_config(ns: argparse.Namespace) -> RunConfig:
    return RunConfig(
        Lx=L, Ly=L, W=1.0, n_imp=0.0, J=0.8,     # clean
        n_therm=ns.n_therm, n_measure=ns.n_measure, Nt_therm_init=20,
        Nt_measure=6, measure_transport_freq=1, bin_size=10,
        dtype="float32", path="real", eigh_mode="tracked", anchor_every=1,
        metropolis_readout="host",
        anneal_stages=ns.anneal_stages, anneal_sweeps=ns.anneal_sweeps,
        anneal_start_beta=100.0,
        out_dir=ns.root, checkpoint_freq=0, verbose=True)


def _saturated(gap_over_sem, a, b, sem) -> bool:
    """Agreement across the top decade in SEM units, or, when the
    statistics resolve the known ~0.2 % finite-T drift (combined SEM below
    0.1 % of the value), within 0.25 % relative."""
    scale = max(abs(a), abs(b), 1e-12)
    return (gap_over_sem <= 5.0
            or (sem <= 1e-3 * scale and abs(a - b) <= 2.5e-3 * scale))


def report(root: str, cfg: RunConfig, betas=BETAS) -> dict:
    """The pass/fail report from the scan output under ``root``."""
    out = {"betas": list(betas), "readout": "host_f64",
           "device_readout_measured": TPU_DEVICE_READOUT, "points": {}}
    ok = True
    for b in betas:
        d = os.path.join(root, f"beta_{b:.6g}")
        obs = np.genfromtxt(os.path.join(d, "observables.csv"),
                            delimiter=",", names=True)
        tr = np.genfromtxt(os.path.join(d, "transport.csv"),
                           delimiter=",", names=True)
        acc = float(obs["Accepted"].mean())
        dH = obs["dH"]
        dglob = obs["Delta_Glob"]
        rho = tr["Superfluid_Stiffness"]
        pt = {"acceptance": round(acc, 3),
              "dH_all_finite": bool(np.isfinite(dH).all()),
              "dH_absmean": round(float(np.abs(dH).mean()), 4),
              "delta_global": round(float(dglob.mean()), 5),
              "delta_global_sem": round(float(dglob.std()
                                              / np.sqrt(len(dglob))), 6),
              "rho_s": round(float(rho.mean()), 5),
              "rho_s_sem": round(float(rho.std() / np.sqrt(len(rho))), 6)}
        ok &= 0.60 <= acc <= 0.999 and pt["dH_all_finite"]
        out["points"][f"beta_{b:.0e}"] = pt

    p4, p5 = (out["points"][f"beta_{b:.0e}"] for b in betas)
    sem = max(p4["delta_global_sem"] + p5["delta_global_sem"], 1e-6)
    out["delta_global_gap_over_sem"] = round(
        abs(p4["delta_global"] - p5["delta_global"]) / sem, 2)
    sem_r = max(p4["rho_s_sem"] + p5["rho_s_sem"], 1e-6)
    out["rho_s_gap_over_sem"] = round(abs(p4["rho_s"] - p5["rho_s"]) / sem_r,
                                      2)
    out["protocol"] = (
        f"beta-ladder warm start (anneal_stages={cfg.anneal_stages} x "
        f"{cfg.anneal_sweeps} sweeps from beta={cfg.anneal_start_beta:g}) + "
        "host-f64 readout; saturation criterion: beta=1e4 vs 1e5 within 5 "
        "combined SEM, OR within 0.25% relative WHEN the combined SEM "
        "itself resolves below 0.1% of the value — the SEM-only criterion "
        "anti-selects better statistics (a run with 4x smaller error bars "
        "resolves the ~0.2% residual finite-temperature drift between "
        "T=1e-4 and 1e-5 — the d-wave nodal correction scale — and would "
        "'fail' where a noisier run passes); the SEM gate keeps the "
        "relative branch from excusing a genuinely unsaturated gap in a "
        "noisy run")
    saturated = (
        _saturated(out["delta_global_gap_over_sem"], p4["delta_global"],
                   p5["delta_global"], sem)
        and _saturated(out["rho_s_gap_over_sem"], p4["rho_s"], p5["rho_s"],
                       sem_r))
    out["rho_s_gap_abs"] = round(abs(p4["rho_s"] - p5["rho_s"]), 6)
    out["delta_global_gap_abs"] = round(
        abs(p4["delta_global"] - p5["delta_global"]), 6)
    out["saturated"] = bool(saturated)
    out["pass"] = bool(ok and saturated)
    return out


def main(argv=None) -> dict:
    """Scan (unless ``--report_only``), write ``--out``, print the report;
    returns it."""
    ns = parser().parse_args(argv)
    device = resolve_device(ns.device)
    cfg = scan_config(ns)
    if not ns.report_only:
        run_scan_vectorized(cfg, BETAS, scan_param="beta", replicas=2,
                            device=device)
    rep = report(ns.root, cfg)
    os.makedirs(os.path.dirname(os.path.abspath(ns.out)), exist_ok=True)
    with open(ns.out, "w") as f:
        json.dump(rep, f, indent=1)
    print(json.dumps(rep))
    return rep


if __name__ == "__main__":
    run_quick_suite()
    main(sys.argv[1:])
