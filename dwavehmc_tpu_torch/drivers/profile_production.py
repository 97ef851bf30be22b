"""Device trace of the production fast tracked segment (port of
``scripts/profile_production.py``): measured utilization beside the
model-FLOP one.

    python -m dwavehmc_tpu_torch.drivers.profile_production
        [--device cuda|cpu] [--out runs/profile_production.json]

Thermalize briefly (PROF_THERM sweeps at Nt = 20), run one warm segment of
PROF_SWEEPS sweeps, time a second one, then trace a third with
``torch.profiler`` (the CPU and the card; ``utils/profiling.device_trace``)
into ``runs/trace_<L>x<L>_b<B>/`` and read every trace file there with
``drivers/analyze_trace.py`` (per-track busy time, the device's busy share)
and the newest one's self time by kernel family.  The
segment is the fast tracked configuration: bf16 in-trajectory rotations,
the "ns" scheme, an exact anchor every PROF_ANCHOR_EVERY sweeps, refine 12
/ polish 4 on the cheap sweeps, β = 10.  The model FLOPs are ``utils/flops.
tracked_model_flops``; the utilization is taken against the H100's dense
BF16 peak, which the JSON names (``config.nominal_peak``).

Environment knobs: PROF_L (24), PROF_BATCH (64), PROF_SWEEPS (20), PROF_NT
(6), PROF_ANCHOR_EVERY (10), PROF_THERM (6).  The JSON keeps the JAX
script's keys; a failed trace is recorded under ``trace_error`` and the run
exits nonzero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from ..models.lattice import LatticeSpec
from ..models.params import make_params
from ..parallel.ensemble import init_ensemble_real, run_segment_tracked
from ..sampler.hmc import calc_optimal_dt
from ..utils.device import resolve_device
from ..utils.flops import BF16_PEAK, tracked_model_flops
from ..utils.profiling import device_trace
from .analyze_trace import analyze, category_self_time, trace_files
from .validate_cheap_anchor import PHYS, device_label, log, sync

DEFAULT_OUT = os.path.join("runs", "profile_production.json")
#: the JAX script's fixed settings
BETA, J, MASS = 10.0, 0.8, 1.0
NT_THERM = 20
TRACKED_ITERS, REFINE_ITERS, POLISH_ITERS, NS_STEPS = 6, 12, 4, 2
#: the seed of the run's generator (the JAX script's PRNGKey(0))
SEED = 0
ANALYSIS_NOTE = ("self time (nested-event-corrected) of the device's work "
                 "by kernel family (drivers/analyze_trace.py "
                 "--categories); the key keeps the JAX artifact's name, a "
                 "CUDA trace has no hlo_category")


def knobs(env=os.environ) -> dict:
    return dict(L=int(env.get("PROF_L", 24)),
                batch=int(env.get("PROF_BATCH", 64)),
                sweeps=int(env.get("PROF_SWEEPS", 20)),
                Nt=int(env.get("PROF_NT", 6)),
                anchor_every=int(env.get("PROF_ANCHOR_EVERY", 10)),
                therm=int(env.get("PROF_THERM", 6)))


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--trace_dir", default=None,
                   help="default: runs/trace_<L>x<L>_b<batch>")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def profile(kn: dict, device, trace_dir: str, log=log) -> dict:
    """The report of one profiled run at the knobs ``kn``, with the trace
    under ``trace_dir``."""
    device = resolve_device(device)
    L, batch, sweeps, Nt, K = (kn[k] for k in ("L", "batch", "sweeps", "Nt",
                                               "anchor_every"))
    lat = LatticeSpec(L, L)
    params = make_params(beta=BETA, J=J, dtype=torch.float32, device=device,
                         **dict(PHYS, mass=MASS))
    log(f"profile_production: device={device_label(device)} L={L} "
        f"batch={batch} sweeps={sweeps} Nt={Nt} K={K}")

    gen = torch.Generator(device=device).manual_seed(SEED)
    states = init_ensemble_real(lat, params, gen, batch, dtype=torch.float32,
                                n_imp=PHYS["n_imp"], device=device)
    sync(device)
    log("init done")

    rot = torch.bfloat16
    track = (TRACKED_ITERS, K, REFINE_ITERS, POLISH_ITERS, NS_STEPS, rot)
    states, seg = run_segment_tracked(
        lat, params, states, kn["therm"], NT_THERM,
        calc_optimal_dt(BETA, J, MASS, NT_THERM), False, *track,
        generator=gen)
    sync(device)
    log("therm done")

    dt = calc_optimal_dt(BETA, J, MASS, Nt)

    def one_segment(states):
        return run_segment_tracked(lat, params, states, sweeps, Nt, dt, True,
                                   *track, generator=gen)

    t0 = time.perf_counter()
    states, seg = one_segment(states)
    acc = float(seg.accepted.float().mean())
    log(f"warm segment: {time.perf_counter() - t0:.1f}s acc={acc:.3f}")

    t0 = time.perf_counter()
    states, seg = one_segment(states)
    sync(device)
    t_plain = time.perf_counter() - t0
    log(f"plain warm segment: {t_plain:.2f}s "
        f"({batch * sweeps / t_plain:.1f} traj/s)")

    trace_error, t_traced, analyses, self_time = None, None, [], None
    try:
        with device_trace(trace_dir):
            t0 = time.perf_counter()
            states, seg = one_segment(states)
            sync(device)
            t_traced = time.perf_counter() - t0
        log(f"traced segment: {t_traced:.2f}s -> {trace_dir}")
        paths = trace_files(trace_dir)
        if not paths:
            raise FileNotFoundError(f"no trace file under {trace_dir}")
        log(f"trace files: {paths}")
        analyses = [analyze(p, 12) for p in paths]
        self_time = category_self_time(max(paths, key=os.path.getmtime))
    except Exception as e:  # noqa: BLE001 — recorded; main exits nonzero
        trace_error = f"{type(e).__name__}: {e}"
        log(f"profiler trace failed: {trace_error}")

    flops = tracked_model_flops(L, Nt, batch, sweeps, TRACKED_ITERS, K,
                                REFINE_ITERS, POLISH_ITERS, NS_STEPS)
    model_tflops = flops / t_plain / 1e12
    return {
        "config": {"L": L, "batch": batch, "sweeps": sweeps, "Nt": Nt,
                   "anchor_every": K, "rot_dtype": "bfloat16",
                   "therm": kn["therm"], "nominal_peak": BF16_PEAK},
        "device": device_label(device),
        "wall_s_plain": round(t_plain, 3),
        "wall_s_traced": round(t_traced, 3) if t_traced else None,
        "traj_per_sec": round(batch * sweeps / t_plain, 2),
        "acceptance": acc,
        "model_tflops": round(model_tflops, 2),
        "model_mfu_pct_nominal_peak": round(
            100 * model_tflops / BF16_PEAK["tflops"], 2),
        "trace_dir": trace_dir,
        "trace_error": trace_error,
        "track_analyses": analyses,
        "device_self_time_by_hlo_category": self_time,
        "analysis_note": ANALYSIS_NOTE,
    }


def main(argv=None) -> dict:
    ns = parser().parse_args(argv)
    kn = knobs()
    trace_dir = ns.trace_dir or os.path.join(
        "runs", f"trace_{kn['L']}x{kn['L']}_b{kn['batch']}")
    out = profile(kn, ns.device, trace_dir)
    os.makedirs(os.path.dirname(os.path.abspath(ns.out)), exist_ok=True)
    with open(ns.out, "w") as f:
        json.dump(out, f, indent=1)
    log(f"wrote {ns.out}")
    print(json.dumps({"traj_per_sec": out["traj_per_sec"],
                      "acceptance": out["acceptance"],
                      "model_tflops": out["model_tflops"],
                      "trace_ok": out["trace_error"] is None,
                      "n_track_analyses": len(out["track_analyses"])}))
    if out["trace_error"] is not None:
        raise SystemExit(f"profile_production: the trace failed: "
                         f"{out['trace_error']}")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
