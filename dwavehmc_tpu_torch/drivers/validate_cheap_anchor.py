"""Cheap-anchor Metropolis bias at production shape (port of
``scripts/validate_cheap_anchor.py``):

    python -m dwavehmc_tpu_torch.drivers.validate_cheap_anchor
        [--device cuda|cpu] [--L 16] [--batch 8] [--anchor_every 10]
        [--rot_dtype bfloat16] [--rot_scheme exp2] [--exact_solver ph]
        [--dt_factor 1.0] [--therm 10] [--paired 10] [--sweeps 40]
        [--out runs/cheap_anchor_validation.json]

The fast tracked configuration (``run_segment_tracked`` with
``anchor_every`` = K > 1) skips the exact embedding eigh on K−1 of K sweeps:
Metropolis runs on the refined tracked endpoint spectrum instead.  The
sampler stays exact only while |dH_cheap − dH_exact| is negligible against
the O(1) Metropolis scale.  This measures it:

1. the paired audit: the SAME proposal of ``tracked_leapfrog`` goes through
   ``tracked_accept_cheap`` and through the exact accept (the guarded PH
   anchor under ``--exact_solver ph``); both read the proposal's accept
   uniform, so they judge one proposal with one draw.  |ΔdH| and the
   endpoint residual are recorded; a pair that is certain to be rejected on
   both sides (non-finite, or dH > 50 on both) is decision-identical and
   left out;
2. the equilibrium comparison: an exact-anchored chain (K = 1) against a
   cheap-anchored one (K) from the same initial state and the same draws;
   energy, Δ_amp and Δ_pair over the second half must agree within 3
   combined SEM.

``pass`` = max |ΔdH| < 0.1 and every shift < 3 SEM.  The JSON goes to
``--out`` (default under ``runs/``).  ``--use_pallas_s`` is accepted and
ignored: the rotation kernel K1 runs wherever the tensors are on the card.
Run as a program, the quick tier (``utils/quickcheck``) runs first.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import NamedTuple

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
from ..sampler.hmc_real import (
    draw_init_state,
    tracked_accept_cheap,
    tracked_leapfrog,
)
from ..utils.device import resolve_device
from ..utils.quickcheck import run_quick_suite

DEFAULT_OUT = os.path.join("runs", "cheap_anchor_validation.json")
#: the production couplings (``scan_config.json`` of the 24×24 scans)
PHYS = dict(t=1.0, tp=-0.35, mu=-1.08, W=1.0, n_imp=0.05, mass=1.0)
#: thermalization: Nt and the exact-anchored sweeps' length
NT_THERM = 20
#: a proposal with dH above this on both sides is certainly rejected
CERTAIN_REJECT_DH = 50.0
#: the seed of the run's generator (the JAX script's PRNGKey(0))
SEED = 0
#: the gate: paired bias and equilibrium shift in combined SEM
MAX_DH_ERR = 0.1
MAX_SHIFT_OVER_SEM = 3.0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--L", type=int, default=16)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--beta", type=float, default=10.0)
    p.add_argument("--J", type=float, default=0.8)
    p.add_argument("--Nt", type=int, default=6)
    p.add_argument("--anchor_every", type=int, default=10)
    p.add_argument("--tracked_iters", type=int, default=6)
    p.add_argument("--refine_iters", type=int, default=12)
    p.add_argument("--polish_iters", type=int, default=6)
    p.add_argument("--polish_precision", default="highest",
                   choices=("highest", "high"),
                   help="precision of the polish rotations' products "
                        "(three TF32 passes on the card for 'high'; the "
                        "readout is always 'highest')")
    p.add_argument("--polish_correction", action="store_true",
                   help="second-order Rayleigh correction on the readout")
    p.add_argument("--rot_dtype", default=None, choices=(None, "bfloat16"),
                   help="storage dtype of the in-trajectory rotations")
    p.add_argument("--rot_scheme", default="exp2", choices=("ns", "exp2"))
    p.add_argument("--ns_steps", type=int, default=None,
                   help="Newton–Schulz steps (default: 1 for exp2, 2 for ns)")
    p.add_argument("--exact_solver", default="ph", choices=("qdwh", "ph"),
                   help="anchor (and paired init) exact eigensolver")
    p.add_argument("--use_pallas_s", type=int, default=None,
                   help="accepted and ignored: K1 runs on CUDA tensors")
    p.add_argument("--dt_factor", type=float, default=1.0,
                   help="scale of the harmonic-heuristic dt")
    p.add_argument("--therm", type=int, default=10)
    p.add_argument("--paired", type=int, default=10,
                   help="number of paired cheap-vs-exact dH comparisons")
    p.add_argument("--sweeps", type=int, default=40,
                   help="equilibrium sweeps per mode")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def ns_steps_of(ns: argparse.Namespace) -> int:
    if ns.ns_steps is not None:
        return ns.ns_steps
    return 1 if ns.rot_scheme == "exp2" else 2


def device_label(device: torch.device) -> str:
    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _np64(x: torch.Tensor) -> np.ndarray:
    return x.detach().to("cpu", torch.float64).numpy()


class PairedAudit(NamedTuple):
    """Per proposal (paired, B): both sides' dH, whether the pair counts
    (its decision could differ), and the endpoint residual."""

    dH_cheap: np.ndarray
    dH_exact: np.ndarray
    compared: np.ndarray
    res_end: np.ndarray


class Setup(NamedTuple):
    lat: LatticeSpec
    params: object
    dt: float
    dt_therm: float
    rot_dtype: object
    ns_steps: int
    device: torch.device


def setup(ns: argparse.Namespace) -> Setup:
    device = resolve_device(ns.device)
    params = make_params(beta=ns.beta, J=ns.J, dtype=torch.float32,
                         device=device, **PHYS)
    return Setup(
        LatticeSpec(ns.L, ns.L), params,
        ns.dt_factor * calc_optimal_dt(ns.beta, ns.J, 1.0, ns.Nt),
        calc_optimal_dt(ns.beta, ns.J, 1.0, NT_THERM),
        torch.bfloat16 if ns.rot_dtype == "bfloat16" else None,
        ns_steps_of(ns), device)


def initial_draws(su: Setup, ns: argparse.Namespace,
                  generator: torch.Generator):
    """(init, stream): the initial (disorder, Δ_re, Δ_im) of ``ns.batch``
    chains, then every sweep's draws, from ``generator``."""
    init = draw_init_state(su.lat, su.params, ns.batch, generator=generator,
                           dtype=torch.float32, n_imp=PHYS["n_imp"],
                           device=su.device)
    return init, DrawStream(generator, (ns.batch, 2, su.lat.n_sites, 2),
                            torch.float32, su.device)


def thermalized(su: Setup, ns: argparse.Namespace, init, stream: DrawStream,
                exact_solver: str, cache: dict | None = None):
    """The ensemble of ``init`` = (disorder, Δ_re, Δ_im), diagonalized by
    ``exact_solver``, after ``ns.therm`` exact-anchored sweeps at Nt = 20
    on the stream's first draws, and the thermalization's record.  The
    result is deterministic in its inputs, so ``cache`` keeps it by
    ``exact_solver`` for runs that share ``init``, ``stream`` and the
    thermalization's settings (the rotation dtype and the polish act only
    after it)."""
    if cache is not None:
        if exact_solver not in cache:
            cache[exact_solver] = thermalized(su, ns, init, stream,
                                              exact_solver)
        return cache[exact_solver]
    disorder, dre, dim = init
    states = init_ensemble_real(
        su.lat, su.params, None, ns.batch, dtype=torch.float32,
        n_imp=PHYS["n_imp"], exact_solver=exact_solver, disorder=disorder,
        delta0_re=dre, delta0_im=dim, device=su.device)
    n, u = stream.take(0, ns.therm)
    return run_segment_tracked(su.lat, su.params, states, ns.therm,
                               NT_THERM, su.dt_therm, False,
                               ns.tracked_iters, normals=n, uniforms=u)


def paired_audit(su: Setup, ns: argparse.Namespace, states,
                 stream: DrawStream, log=log) -> PairedAudit:
    """``ns.paired`` proposals from ``states``, each scored by the cheap and
    by the exact accept; the chain moves on by the exact decision."""
    dc, de, cmp, res = [], [], [], []
    for i in range(ns.paired):
        n, u = stream.take(ns.therm + i, 1)
        prop = tracked_leapfrog(
            su.lat, su.params, states, ns.Nt, su.dt, ns.tracked_iters,
            ns.refine_iters, ns.polish_iters, su.ns_steps, su.rot_dtype,
            ns.polish_precision, ns.polish_correction, ns.rot_scheme,
            normals=n[0], uniforms=u[0])
        _, info_cheap = tracked_accept_cheap(su.lat, su.params, states, prop)
        states, info_exact = tracked_accept_exact(su.lat, su.params, states,
                                                  prop, ns.exact_solver)
        c, e = _np64(info_cheap.dH), _np64(info_exact.dH)
        both_fin = np.isfinite(c) & np.isfinite(e)
        certain = both_fin & (c > CERTAIN_REJECT_DH) & (e > CERTAIN_REJECT_DH)
        keep = both_fin & ~certain
        r = _np64(prop.res_end)
        dc.append(c)
        de.append(e)
        cmp.append(keep)
        res.append(r)
        err = np.abs(c[keep] - e[keep])
        fin = r[np.isfinite(r)]
        log(f"paired {i}: max|dH_cheap-dH_exact|="
            f"{err.max() if err.size else float('nan'):.3e} "
            f"(excluded {int((~keep).sum())} decision-identical diverged) "
            f"max res={fin.max() if fin.size else float('nan'):.3e}")
    return PairedAudit(np.array(dc), np.array(de), np.array(cmp),
                       np.array(res))


def paired_summary(audit: PairedAudit) -> dict:
    err = np.abs(audit.dH_cheap - audit.dH_exact)[audit.compared]
    res = audit.res_end[np.isfinite(audit.res_end)]
    return {"max_abs_err": float(err.max()),
            "mean_abs_err": float(err.mean()),
            "max_endpoint_residual": float(res.max()),
            "n_samples": int(err.size),
            "n_diverged_decision_identical": int((~audit.compared).sum())}


def equilibrium_chain(su: Setup, ns: argparse.Namespace, init,
                      stream: DrawStream, anchor_every: int,
                      cache: dict | None = None) -> dict:
    """One chain of the equilibrium comparison: the ensemble of ``init``
    (qdwh-diagonalized, as the JAX script's), thermalized, then
    ``ns.sweeps`` sweeps with an exact anchor every ``anchor_every``;
    mean and SEM of the observables over the second half, the acceptance
    and the trajectories per second."""
    st, _ = thermalized(su, ns, init, stream, "qdwh", cache)
    n, u = stream.take(ns.therm, ns.sweeps)
    sync(su.device)
    t0 = time.perf_counter()
    st, seg = run_segment_tracked(
        su.lat, su.params, st, ns.sweeps, ns.Nt, su.dt, True,
        ns.tracked_iters, anchor_every, ns.refine_iters, ns.polish_iters,
        su.ns_steps, su.rot_dtype, ns.exact_solver, ns.polish_precision,
        ns.polish_correction, ns.rot_scheme, normals=n, uniforms=u)
    accepted = _np64(seg.accepted)
    wall = time.perf_counter() - t0
    o = seg.observables
    half = ns.sweeps // 2
    stats = {}
    for name in ("total_energy", "delta_amp", "delta_pair"):
        arr = _np64(getattr(o, name))[half:]
        key = "energy" if name == "total_energy" else name
        stats[key] = {"mean": float(arr.mean()),
                      "sem": float(arr.std(ddof=1) / np.sqrt(arr.shape[0]))}
    stats["acceptance"] = float(accepted.mean())
    stats["traj_per_sec"] = ns.batch * ns.sweeps / wall
    return stats


def shifts_of(exact: dict, cheap: dict) -> dict:
    out = {}
    for name in ("energy", "delta_amp", "delta_pair"):
        d = abs(cheap[name]["mean"] - exact[name]["mean"])
        sem = (cheap[name]["sem"] ** 2 + exact[name]["sem"] ** 2) ** 0.5
        out[name] = {"abs_shift": d, "combined_sem": sem,
                     "shift_over_sem": d / max(sem, 1e-30)}
    return out


CONFIG_KEYS = ("L", "batch", "beta", "J", "Nt", "anchor_every",
               "tracked_iters", "refine_iters", "polish_iters",
               "polish_precision", "polish_correction", "therm", "paired",
               "sweeps", "rot_dtype", "rot_scheme", "exact_solver",
               "dt_factor")


def validate(ns: argparse.Namespace, *, init=None,
             stream: DrawStream | None = None, cache: dict | None = None,
             log=log) -> tuple[dict, PairedAudit]:
    """(the JSON report, the paired audit's arrays).  ``init`` (disorder,
    Δ_re, Δ_im) and ``stream`` replace the draws of a ``torch.Generator``
    seeded with ``SEED`` (``initial_draws``).  The two equilibrium chains
    start from one thermalization, as their inputs are the same; ``cache``
    (see ``thermalized``) shares the thermalizations with other runs."""
    su = setup(ns)
    if init is None or stream is None:
        gen = torch.Generator(device=su.device).manual_seed(SEED)
        init, stream = initial_draws(su, ns, gen)
    cache = {} if cache is None else cache
    log(f"device={device_label(su.device)} L={ns.L} batch={ns.batch} "
        f"anchor_every={ns.anchor_every} refine_iters={ns.refine_iters} "
        f"polish_iters={ns.polish_iters} rot_dtype={ns.rot_dtype} "
        f"scheme={ns.rot_scheme} ns_steps={su.ns_steps} "
        f"solver={ns.exact_solver} dt_factor={ns.dt_factor}")

    t0 = time.perf_counter()
    states, seg = thermalized(su, ns, init, stream, ns.exact_solver, cache)
    log(f"therm: {time.perf_counter() - t0:.1f}s "
        f"acc={float(_np64(seg.accepted).mean()):.2f}")
    audit = paired_audit(su, ns, states, stream, log)

    log("equilibrium: exact-anchored chain (K=1)...")
    exact = equilibrium_chain(su, ns, init, stream, 1, cache)
    log(f"  {json.dumps(exact['energy'])} acc={exact['acceptance']:.2f}")
    log(f"equilibrium: cheap-anchored chain (K={ns.anchor_every})...")
    cheap = equilibrium_chain(su, ns, init, stream, ns.anchor_every, cache)
    log(f"  {json.dumps(cheap['energy'])} acc={cheap['acceptance']:.2f}")
    shifts = shifts_of(exact, cheap)

    paired = paired_summary(audit)
    report = {
        "config": {k: getattr(ns, k) for k in CONFIG_KEYS},
        "ns_steps": su.ns_steps, "use_pallas_s": su.device.type == "cuda",
        "device": device_label(su.device),
        "paired_dH": paired,
        "equilibrium": {"exact": exact, "cheap": cheap, "shifts": shifts},
        "pass": bool(paired["max_abs_err"] < MAX_DH_ERR
                     and all(s["shift_over_sem"] < MAX_SHIFT_OVER_SEM
                             for s in shifts.values())),
    }
    return report, audit


def main(argv=None) -> dict:
    """Run, write ``--out`` and print the summary line; returns the
    report."""
    ns = parser().parse_args(argv)
    report, _ = validate(ns)
    os.makedirs(os.path.dirname(os.path.abspath(ns.out)), exist_ok=True)
    with open(ns.out, "w") as f:
        json.dump(report, f, indent=2)
    log(f"wrote {ns.out}")
    shifts = report["equilibrium"]["shifts"]
    print(json.dumps({"pass": report["pass"],
                      "max_dH_err": report["paired_dH"]["max_abs_err"],
                      "max_shift_over_sem": max(
                          s["shift_over_sem"] for s in shifts.values())}))
    return report


if __name__ == "__main__":
    run_quick_suite()
    main(sys.argv[1:])
