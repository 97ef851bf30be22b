#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dwavehmc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S]

Run from the root of a checkout on a machine with one CUDA device.  It

1. builds both CUDA kernels from ``dwavehmc_tpu_torch/csrc`` with nvcc;
2. checks each kernel against its plain PyTorch version on the card, at the
   shapes of the main path and at unaligned ones (K1 max abs error ≤ 1e-6,
   K2 rtol ≤ 1e-4), and times kernel and plain version with CUDA events;
3. holds a small run on the card (float32, kernels) against the same run on
   the CPU (float64, plain versions);
4. drives the main path — the 24×24 production configuration, 8 chains at 8
   temperatures of the production T grid, tracked leapfrog (Nt = 20) with
   ``exact_solver="qdwh"``: ``init_ensemble_real``, a 2-sweep
   ``run_segment_tracked`` with K=1, a 4-sweep one with K=4 (3 cheap + 1
   exact anchor), ``ensemble_transport_real`` after each — with the kernel
   launch counts reset just before and read after, each phase's count
   checked against the schedule, and every output checked finite;
5. profiles one more K=1 sweep and transport pass with ``torch.profiler``
   and prints device time by kernel family (outside the counted window).

One JSON line per phase; then the card's ``nvidia-smi`` name and power
limit, the kernel table as one JSON line, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits nonzero before that line.  Without a CUDA device it exits 2 and prints
no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

#: published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, FP32 FLOP/s
#: outside the tensor cores
H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOP_PER_S = 67e12
#: operations per element (K1) and per Lorentzian (K2) counted for the bound:
#: K1 ≈ gap, |T| (3 + sqrt), atan2, scale and clamp, two divisions, sign and
#: four products; K2 = subtract, fused multiply-add, reciprocal, and a fused
#: multiply-accumulate counted as two each
K1_OPS_PER_ELEMENT = 20
K2_OPS_PER_LORENTZIAN = 6

L_MAIN = 24
N_CHAINS = 8
#: leapfrog steps: the production scan's thermalization setting
#: (``Nt_therm_init`` in examples/T_scan_full_24x24/scan_config.json), with
#: the harmonic dt0 of ``calc_optimal_dt`` — the state a scan starts from
NT = 20
PHYS = dict(t=1.0, tp=-0.35, mu=-1.08, W=1.0, n_imp=0.05, J=0.8, mass=1.0)
TRACK = dict(tracked_iters=6, refine_iters=6, polish_iters=3, ns_steps=1,
             rot_dtype=None, polish_precision="highest",
             polish_correction=False, rot_scheme="exp2",
             exact_solver="qdwh")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def roofline(nbytes: float, ops: float) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations") for work
    that moves ``nbytes`` and does ``ops`` float32 operations."""
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = ops / H100_FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def gpu_name_and_power() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def production_spec(lat):
    from dwavehmc_tpu_torch.models.params import SpectralSpec

    eta = 8.0 / lat.n_sites
    return SpectralSpec(eta=eta, domega=0.2 * eta, omega_max=4.0)


def main_config(dev):
    """(lattice, spectral grid, temperatures, params, per-chain dt) of the
    main path: 24×24, 8 chains at every third point of the production T
    grid (1e-4 … 1e3, 24 log-spaced points), float32."""
    from dwavehmc_tpu_torch.models.lattice import LatticeSpec
    from dwavehmc_tpu_torch.models.params import make_params
    from dwavehmc_tpu_torch.sampler.hmc import calc_optimal_dt

    lat = LatticeSpec(L_MAIN, L_MAIN)
    temps = np.logspace(-4.0, 3.0, 24)[::3]
    betas = (1.0 / temps).tolist()
    params = make_params(beta=betas, dtype=torch.float32, device=dev,
                         **PHYS)
    dt = torch.tensor([calc_optimal_dt(b, PHYS["J"], PHYS["mass"], NT)
                       for b in betas], device=dev)
    return lat, production_spec(lat), temps, params, dt


def expected_rotations(n_sweeps: int, K: int) -> int:
    """K1 launches of one segment: every tracked rotation is one batched
    launch; cheap sweeps add the endpoint refine and polish rotations."""
    per_step = NT * TRACK["tracked_iters"]
    cheap = per_step + TRACK["refine_iters"] + TRACK["polish_iters"]
    total, done = 0, 0
    while done < n_sweeps:
        k = min(K, n_sweeps - done)
        total += (k - 1) * cheap + per_step
        done += k
    return total


# --- kernels ----------------------------------------------------------------

def kernel_phases(dev, gen, power: str):
    from dwavehmc_tpu_torch.models.lattice import LatticeSpec
    from dwavehmc_tpu_torch.ops import kernels

    table = {}
    for B, n, main in ((N_CHAINS, 2 * L_MAIN * L_MAIN, True),
                       (2, 300, False)):
        a = torch.randn(B, n, n, generator=gen, device=dev)
        b = torch.randn(B, n, n, generator=gen, device=dev)
        tr, ti = (a + a.mT) * 0.01, (b - b.mT) * 0.01
        d = torch.sort(torch.randn(B, n, generator=gen, device=dev),
                       dim=-1).values * 3.0
        before = kernels.LAUNCHES["rotation_s_parts"]
        sr, si = kernels.rotation_s_parts(tr, ti, d, 0.1)
        torch.cuda.synchronize()
        check(kernels.LAUNCHES["rotation_s_parts"] == before + 1,
              "K1 wrapper did not count its launch")
        pr, pi = kernels.rotation_s_parts_plain(tr, ti, d, 0.1)
        err = max(float((sr - pr).abs().max()), float((si - pi).abs().max()))
        ms = cuda_ms(lambda: kernels.rotation_s_parts(tr, ti, d, 0.1), 20)
        plain_ms = cuda_ms(
            lambda: kernels.rotation_s_parts_plain(tr, ti, d, 0.1), 5)
        bound_ms, bound_by = roofline(4 * (4 * B * n * n + B * n),
                                      K1_OPS_PER_ELEMENT * B * n * n)
        emit({"phase": "kernel.rotation_s_parts", "shape": [B, n, n],
              "max_abs_err": err, "tol": 1e-6, "ms": ms,
              "plain_ms": plain_ms, "bound_ms": bound_ms,
              "launches": kernels.LAUNCHES["rotation_s_parts"],
              "gpu": power})
        check(err <= 1e-6, f"K1 at {(B, n)}: max abs err {err} > 1e-6")
        if main:
            table["rotation_s_parts"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)
        del a, b, tr, ti, sr, si, pr, pi

    lat = LatticeSpec(L_MAIN, L_MAIN)
    spec = production_spec(lat)
    M = (2 * lat.n_sites) ** 2
    grid = torch.as_tensor(spec.omega_grid(), dtype=torch.float32,
                           device=dev)
    # (label, chains, grid, is the main path's σ(ω) call)
    cases = (("optical", N_CHAINS, grid, True), ("dc", N_CHAINS, None, False),
             ("optical", 2, grid, False), ("unaligned", 1, None, False))
    for label, B, om, main in cases:
        if label == "dc":
            omega = torch.zeros((B, 1), device=dev)
        elif label == "unaligned":
            omega = torch.linspace(0.01, 4.0, 37, device=dev)[None]
        else:
            omega = om.expand(B, -1).contiguous()
        m = 1000 if label == "unaligned" else M
        de = torch.randn(B, m, generator=gen, device=dev) * 2.0
        w2 = torch.rand(B, m, generator=gen, device=dev)
        before = kernels.LAUNCHES["weighted_lorentzian_sum"]
        got = kernels.weighted_lorentzian_sum(omega, de, w2, spec.eta)
        torch.cuda.synchronize()
        check(kernels.LAUNCHES["weighted_lorentzian_sum"] == before + 1,
              "K2 wrapper did not count its launch")
        want = kernels.weighted_lorentzian_sum_plain(omega, de, w2, spec.eta)
        abs_err = float((got - want).abs().max())
        rel_err = float(((got - want).abs() / want.abs()).max())
        again = kernels.weighted_lorentzian_sum(omega, de, w2, spec.eta)
        repeat = bool(torch.equal(got, again))
        reps = 3 if m == M and omega.shape[-1] > 1 else 20
        ms = cuda_ms(lambda: kernels.weighted_lorentzian_sum(
            omega, de, w2, spec.eta), reps)
        plain_ms = cuda_ms(lambda: kernels.weighted_lorentzian_sum_plain(
            omega, de, w2, spec.eta), 2, warmup=1)
        n_w = omega.shape[-1]
        bound_ms, bound_by = roofline(4 * (2 * B * n_w + 2 * B * m),
                                      K2_OPS_PER_LORENTZIAN * B * n_w * m)
        emit({"phase": f"kernel.weighted_lorentzian_sum.{label}",
              "shape": [B, n_w, m], "max_abs_err": abs_err,
              "max_rel_err": rel_err, "rtol": 1e-4, "bit_repeat": repeat,
              "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
              "launches": kernels.LAUNCHES["weighted_lorentzian_sum"],
              "gpu": power})
        check(rel_err <= 1e-4, f"K2 {label} at {(B, n_w, m)}: rel err "
              f"{rel_err} > 1e-4")
        check(repeat, f"K2 {label}: two runs differ")
        if main:
            table["weighted_lorentzian_sum"] = dict(
                max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)
        del de, w2, got, want, again
    return table


# --- small run: card (float32, kernels) vs CPU (float64, plain) -------------

def reference_phase(dev, seed: int) -> None:
    from dwavehmc_tpu_torch.models.lattice import LatticeSpec
    from dwavehmc_tpu_torch.models.params import make_params
    from dwavehmc_tpu_torch.parallel.ensemble import (
        ensemble_transport_real,
        init_ensemble_real,
        run_segment_tracked,
    )
    from dwavehmc_tpu_torch.sampler.hmc import calc_optimal_dt

    lat = LatticeSpec(6, 6)
    spec = production_spec(lat)
    betas = [10.0, 50.0]
    g = torch.Generator().manual_seed(seed)
    p64 = make_params(beta=betas, dtype=torch.float64, device="cpu", **PHYS)
    s64 = init_ensemble_real(lat, p64, g, 2, dtype=torch.float64,
                             n_imp=PHYS["n_imp"], device="cpu")
    p32 = make_params(beta=betas, dtype=torch.float32, device=dev, **PHYS)
    s32 = type(s64)(*(x.to(dev, torch.float32) for x in s64))
    normals = torch.randn((1, 2, 2, lat.n_sites, 2), generator=g,
                          dtype=torch.float64)
    uniforms = torch.rand((1, 2), generator=g)
    dt = [calc_optimal_dt(b, PHYS["J"], PHYS["mass"], NT) for b in betas]

    tr64 = ensemble_transport_real(lat, spec, p64, s64)
    tr32 = ensemble_transport_real(lat, spec, p32, s32)
    rel = {}
    for name in tr64._fields:
        a = getattr(tr32, name).double().cpu()
        b = getattr(tr64, name)
        rel[name] = float((a - b).norm() / b.norm())
    _, seg64 = run_segment_tracked(lat, p64, s64, 1, NT,
                                   torch.tensor(dt, dtype=torch.float64),
                                   normals=normals, uniforms=uniforms,
                                   **TRACK)
    _, seg32 = run_segment_tracked(lat, p32, s32, 1, NT,
                                   torch.tensor(dt, device=dev),
                                   normals=normals, uniforms=uniforms,
                                   **TRACK)
    dH64, dH32 = seg64.dH[0], seg32.dH[0].double().cpu()
    emit({"phase": "reference.6x6", "transport_rel_l2": rel,
          "dH_cpu_f64": dH64.tolist(), "dH_gpu_f32": dH32.tolist()})
    for name, r in rel.items():
        check(r <= 1e-3, f"reference {name}: rel L2 {r} > 1e-3")
    check(bool(((dH32 - dH64).abs() <= 1e-2 + 1e-3 * dH64.abs()).all()),
          f"reference dH: card {dH32.tolist()} vs CPU {dH64.tolist()}")


# --- the main path ----------------------------------------------------------

def _finite(nt, what: str) -> None:
    for name, x in nt._asdict().items():
        check(bool(torch.isfinite(x).all()), f"{what}.{name} not finite")


def main_path(dev, seed: int, power: str) -> dict:
    from dwavehmc_tpu_torch.ops import kernels
    from dwavehmc_tpu_torch.parallel.ensemble import (
        ensemble_transport_real,
        init_ensemble_real,
        run_segment_tracked,
    )

    lat, spec, temps, params, dt = main_config(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def counts():
        return dict(kernels.LAUNCHES)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    kernels.reset_launches()
    c0 = counts()
    states, sec = timed(lambda: init_ensemble_real(
        lat, params, gen, N_CHAINS, dtype=torch.float32,
        n_imp=PHYS["n_imp"], exact_solver="qdwh", device=dev))
    emit({"phase": "main.init", "lattice": [L_MAIN, L_MAIN],
          "chains": N_CHAINS, "T": temps.tolist(), "seconds": sec,
          "gpu": power})
    check(counts() == c0, "init launched a kernel")
    _finite(states, "init")

    for n_sweeps, K in ((2, 1), (4, 4)):
        c0 = counts()
        (states, seg), sec = timed(lambda: run_segment_tracked(
            lat, params, states, n_sweeps, NT, dt, True,
            anchor_every=K, generator=gen, **TRACK))
        c1 = counts()
        k1 = c1["rotation_s_parts"] - c0["rotation_s_parts"]
        emit({"phase": f"main.segment_K{K}", "sweeps": n_sweeps, "Nt": NT,
              "acceptance": seg.accepted.float().mean().item(),
              "accepted": seg.accepted.int().tolist(),
              "dH": seg.dH.tolist(), "seconds": sec,
              "traj_per_s": N_CHAINS * n_sweeps / sec,
              "k1_launches": k1, "gpu": power})
        check(k1 == expected_rotations(n_sweeps, K),
              f"K{K} segment: {k1} K1 launches, schedule implies "
              f"{expected_rotations(n_sweeps, K)}")
        check(c1["weighted_lorentzian_sum"] == c0["weighted_lorentzian_sum"],
              "a segment launched K2")
        _finite(seg.observables, f"segment_K{K}.observables")
        _finite(states, f"segment_K{K}.state")

        c0 = counts()
        res, sec = timed(lambda: ensemble_transport_real(lat, spec, params,
                                                         states))
        c1 = counts()
        k2 = c1["weighted_lorentzian_sum"] - c0["weighted_lorentzian_sum"]
        emit({"phase": f"main.transport_after_K{K}", "seconds": sec,
              "k2_launches": k2,
              "dc_conductivity": res.dc_conductivity.tolist(),
              "stiffness": res.superfluid_stiffness.tolist(),
              "shapes": {k: list(v.shape) for k, v in res._asdict().items()},
              "gpu": power})
        check(k2 == 2, f"transport: {k2} K2 launches, expected 2")
        check(c1["rotation_s_parts"] == c0["rotation_s_parts"],
              "transport launched K1")
        check(tuple(res.optical_conductivity.shape)
              == (N_CHAINS, spec.n_omega), "sigma(omega) shape")
        _finite(res, f"transport_after_K{K}")
    return counts()


#: kernel-name fragments → family, first match wins
FAMILIES = (("rotation_s", "K1 rotation_s"), ("lorentz", "K2 lorentzian"),
            ("syev", "eigh"), ("sytrd", "eigh"), ("stedc", "eigh"),
            ("ormtr", "eigh"), ("gemm", "matmul"), ("gemv", "matmul"),
            ("cutlass", "matmul"), ("xmma", "matmul"),
            ("index", "gather/scatter"), ("scatter", "gather/scatter"),
            ("gather", "gather/scatter"), ("reduce", "reduction"),
            ("elementwise", "elementwise"), ("copy", "copy"))


def profile_phase(dev, seed: int, power: str) -> None:
    """Device time by kernel family over one K=1 sweep plus one transport
    pass of the main configuration."""
    from torch.profiler import ProfilerActivity, profile

    from dwavehmc_tpu_torch.parallel.ensemble import (
        ensemble_transport_real,
        init_ensemble_real,
        run_segment_tracked,
    )

    lat, spec, _temps, params, dt = main_config(dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    states = init_ensemble_real(lat, params, gen, N_CHAINS,
                                n_imp=PHYS["n_imp"], device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        states, _ = run_segment_tracked(lat, params, states, 1, NT, dt,
                                        True, anchor_every=1, generator=gen,
                                        **TRACK)
        ensemble_transport_real(lat, spec, params, states)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels_us = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kernels_us[ev.key] = kernels_us.get(ev.key, 0.0) + \
            ev.self_device_time_total
    families = {}
    for name, us in kernels_us.items():
        fam = next((f for frag, f in FAMILIES if frag in name.lower()),
                   "other")
        families[fam] = families.get(fam, 0.0) + us / 1e3
    busy_ms = sum(kernels_us.values()) / 1e3
    top = sorted(kernels_us.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "profile.sweep_K1_and_transport", "wall_ms": 1e3 * wall,
          "device_busy_ms": busy_ms,
          "device_busy_share": busy_ms / (1e3 * wall),
          "family_ms": dict(sorted(families.items(), key=lambda kv: -kv[1])),
          "top_kernels_ms": [[k[:90], us / 1e3] for k, us in top],
          "gpu": power})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA device", file=sys.stderr)
        return 2
    from dwavehmc_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    power = gpu_name_and_power()
    t_all = time.perf_counter()

    info = kernels.build(force=True)
    emit({"phase": "build", "seconds": info["seconds"],
          "library": info["library"], "ptxas": info["ptxas"]})

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    table = kernel_phases(dev, gen, power)
    reference_phase(dev, args.seed)
    launches = main_path(dev, args.seed, power)
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    profile_phase(dev, args.seed, power)

    rows = [
        dict(name="rotation_s_parts", route="cuda",
             source="dwavehmc_tpu_torch/csrc/rotation_s.cu",
             replaces="dwavehmc_tpu/ops/pallas_kernels.py:193",
             launches=launches["rotation_s_parts"], library_ms=None,
             **table["rotation_s_parts"]),
        dict(name="weighted_lorentzian_sum", route="cuda",
             source="dwavehmc_tpu_torch/csrc/lorentzian.cu",
             replaces="dwavehmc_tpu/ops/pallas_kernels.py:86",
             launches=launches["weighted_lorentzian_sum"], library_ms=None,
             **table["weighted_lorentzian_sum"]),
    ]
    emit({"phase": "done", "seconds": time.perf_counter() - t_all})
    print(power, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
