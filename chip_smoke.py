#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dwavehmc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S]

Run from the root of a checkout on a machine with one CUDA device.  It

1. builds the CUDA kernels (K1, K2, K3, K5, K6) from
   ``dwavehmc_tpu_torch/csrc`` with nvcc, one library;
2. checks each kernel against its plain PyTorch version on the card, at the
   shapes of the main path, at BASELINE config 5's (32×32: K1 at (2, 2048,
   2048), K2 at (2, 2556, 4194304) and, on the narrow geometry, (2, 100,
   4194304), K2 there against the plain version in float64) and at
   unaligned ones (K1 max abs error ≤ 1e-6, K2 rtol ≤ 1e-4), and times
   kernel and plain version with CUDA events (the kernel from the replay of
   a CUDA graph of 20 calls, so that the number is device time and not the
   host's launch rate); holds K2 on the σ(ω) path's signed weights against
   a float64 plain run (error at most 4× the float32 plain version's, or
   1e-5);
   then K3 ``chain_sum`` (the sweep's per-chain sums in one halving tree)
   against its plain version at the main path's shapes and others, float32
   and float64, up to rows past one block's registers (40000 values): they
   must be bit-equal, and a block of a batch alone must get the batch's
   bits; times it beside its plain version and ``torch.sum``; then K5
   ``spectral_norm_est``
   (``csrc/sigma_cap.cu``, the σ-cap's power iteration in one launch) at
   the σ-cap's shapes from 8 × 512 to 1 × 8464 float64 (the production
   scan's 24 × 1152 among them), bit-equal to its plain version under its
   own plan, each mode's plan and with −0.0 entries in S, block-alone
   invariant, one device operation a call, each plan's mode, registers,
   spills, shared memory and warps an SM printed, timed beside the
   library's iteration and two bounds
   (``kernel.sigma_cap``); then K6 ``bdg_hop`` (``csrc/bdg_hop.cu``, H·U
   through H's own entries) at the bench's, the main path's and the
   production shapes and two ragged ones, within 4e-6 of Σ|h||u| of the
   float64 product as its plain version is, timed beside its bound, the
   plain version and the dense 3-multiplication product
   (``kernel.bdg_hop``);
   times K1 alone at the bench's three shapes;
3. checks the guarded PH-split anchor at the main path's shape (8 × 2304,
   IEEE float32 products asserted): no fallback, eigenvalues against
   float64 ``eigh`` within 4× float32 ``eigh``'s error (or 1e-5·‖M‖∞),
   ‖XᵀX + YᵀY − I‖max ≤ 5e-4, the positive-level projector within 1e-3 of
   the full-embedding (qdwh) anchor's, and times both anchors; then a batch
   with one gapless chain must fall back to ``diagonalize_embedding``; then
   the guard on further seeded random-Δ batches of the same shape, each
   chain's smallest level over ‖M‖∞ in float32 (the guard's) and, near the
   floor, in float64: a fallback where float64 puts every level above the
   floor is a false one and there must be none; a chain whose float32
   CholeskyQR³ broke down must be the one the guard rescued, its
   eigenvalue error at most the healthy chains' (``anchor.ph_draws``);
   then the benchmark's production cell (64 chains of 24×24, the fast
   mix) from the seed on which a chain once diverged and the anchor's
   float32 ``eigh`` did not converge (F8): the run ends, every diverged
   trajectory is rejected, and the guard's counts, ``redone`` among them,
   and each such trajectory's ΔH are printed (``anchor.diverged_chain``);
4. holds a small run on the card (float32, kernels) against the same run on
   the CPU (float64, plain versions), once per exact solver (qdwh, ph);
5. drives the main path — the 24×24 production configuration, 8 chains at 8
   temperatures of the production T grid, tracked leapfrog (Nt = 20) with
   ``exact_solver="qdwh"``: ``init_ensemble_real``, a 2-sweep
   ``run_segment_tracked`` with K=1, a 4-sweep one with K=4 (3 cheap + 1
   exact anchor), ``ensemble_transport_real`` after each — with the kernel
   launch counts reset just before and read after, each phase's count
   checked against the schedule, and every output checked finite;
6. drives the scan entry point, ``run_scan_vectorized``, at the same width
   and temperatures with the guarded PH anchor into ``build/scan_smoke/``
   (anneal, therm, probe and four measurement sweeps with a transport pass
   each), resumes it to six sweeps, and runs the untracked exact sweep at
   12×12; counts are reset before and read after each run and checked
   against the schedule, the CSVs, bins and health file are checked;
7. drives the complex path through ``run_simulation`` at 24×24 (8 chains,
   2 therm + 2 measurement sweeps, a transport pass per sweep), holds one
   complex trajectory on the card against CPU float64 at 6×6 and measures
   the card's complex64 ``eigh`` error by dimension, runs the vectorized
   scan with the host float64 readout on the cold end of the production T
   grid (``examples/T_scan_cold_host_24x24/scan_config.json``, cut to 2
   points × 2 replicas and 8 sweeps), and the serial scan
   (``batch_scan_T --mode serial``, complex path, 12×12, 2 points) and its
   rerun, which skips both; counts are reset before and read after each;
8. runs the scan sharded over W = min(4, max(2, device_count)) ranks with
   ``torch.distributed.run`` (gloo; several ranks may share a card):
   ``scan.sharded.equal`` holds a 6×6 float64 tracked scan of 3 points
   (padded to a multiple of W) under W ranks against the same scan in one
   process (accept columns equal, values within 1e-6 relative or one unit
   of the CSV's sixth digit); ``scan.sharded`` runs ``batch_scan_T`` at the
   production width and temperatures of ``scan.vectorized``, in this
   process and under W ranks with the same arguments, and checks the
   ranks' files, the post-processing, the initial ensemble (bit-equal to
   ``scan.vectorized``'s), each rank's K1 and K2 launches against the
   schedule and the guard counts (equal on every rank); it reports how far
   the float32 runs agree, the guard's fallbacks and the acceptance of
   each, and one anchored sweep of the same 8 chains as one batch, again,
   and as the ranks' blocks (the batch-rounding witness); ``scan.beta`` runs
   ``batch_scan_beta`` at its 12×12 width, 2 β points, under W ranks; the
   kernels are built once before any launcher starts;
9. prints the memory estimate of ``utils/memory.py`` for the main path's 8
   chains beside ``torch.cuda.max_memory_allocated`` over
   ``main.segment_K1``;
10. runs the clean-limit gate S3 (``drivers/benchmark_clean --fast``, seed
   0): on the float64 complex path |⟨|Δ_global|⟩ − RHS| < 0.02 and
   measurement acceptance > 0.5 (``bcs.clean``); on the float32 real path
   with tracked leapfrog steps finite output and K1's schedule, its gap
   difference reported (``bcs.clean_real``); ``tracked_eigh`` at (8, 1152,
   1152) float32, warm from a nearby exact eigenbasis (no fallback,
   eigenvalues within 1e-5·max|e| of ``full_eigh_from_parts``) and cold from
   the identity (every chain falls back), n_iter K1 launches each; the β
   benchmark S4 at 12×12 cut to 2 β (``bcs.beta_scan``); the three
   post-processing CLIs as subprocesses against the library functions on
   copies of the scan output (``postprocess.cli``); and the quick tier
   ``utils/quickcheck.run_quick_suite`` once (``quickcheck``; every other
   entry point runs under SKIP_QUICK_TESTS=1);
11. validates the fast tracked configuration and the precision modes below
   "highest": ``bench_ph_eigh`` at (8, 2304, 2304) with the PH lift at
   "highest", "high" (three TF32 passes: eigenvalue error within 10× the
   "highest" lift's, the guard's residual under its threshold) and
   "default" (one TF32 pass, reported) (``anchor.ph_lift``);
   ``validate_cheap_anchor`` at 24×24 (K = 10, refine 6 / polish 3, exp2,
   the PH anchor) with bf16 and with float32 rotations: the paired gate
   max |dH_cheap − dH_exact| < 0.1 and K1's schedule
   (``validate.cheap_anchor``) and one proposal of each dtype against a
   float64 recomputation (``validate.cheap_anchor.trajectory``);
   ``ab_polish``'s "highest" and "high" polish, and "default"
   (``validate.polish``); ``validate_beta_extreme`` at 12×12, β =
   1e4 and 1e5, with the host readout, every dH finite and both kernels
   launched (``validate.beta_extreme``); ``probe_beta_dt`` and
   ``tune_Nt_efficiency`` (``validate.beta_dt``, ``tune.Nt``); counts are
   reset before and read after each;
12. drives BASELINE config 5, the disorder-averaged 32×32 ensemble:
   ``demo_config5 --mode card`` at 64 chains (the chunked init, 1 therm
   sweep at Nt = 20, 2 timed sweeps at Nt = 6, K = 5) and one transport
   pass on its final states at the spectral grid (2556 frequencies), with
   the therm sweep's dH finite, every non-finite dH rejected (their count
   reported by stage), the states and every output finite, 64
   distinct realizations, K1 on its schedule, K2 twice, the memory
   estimate beside the allocator's peak and chain 0's 4096 anchor against
   float64 (``config5.card``);
   ``demo_32x32`` at its defaults (``config5.demo_32x32``);
   ``probe_fullspec_timing`` at 72 chains of 24×24, one rep per leg
   (``probe.fullspec``); and ``demo_config5 --mode mesh_exec`` (8 chains
   of 32×32) under W ranks, in float64 and float32: bit-equal to the
   ranks' blocks run one after another in this process (initial and final
   disorder and Δ, accepts, dH), and against the one-process batch the
   initial ensemble, disorder and decisions equal, and, in each dtype in
   which every call the sweep makes gives a block the batch's bits (the
   probe ``_batch_invariance``; K3 and K5 must), every saved array
   bit-equal; the calls that are not are named (``config5.mesh_exec``);
   config 5's first therm sweep on the JAX run's draws
   (``tests/data/config5_replay_32x32.npz``, two 32×32 chains) in float64
   within 1e-8 of the CPU port's dH with its decisions, in float32 finite
   with the CPU's decisions and within 1e-2 of the card's float64 run on
   the float32 inputs (``config5.replay``);
   counts are reset before and read after each;
13. runs the measurement and audit tools (after 12, before the CLIs of
   10): ``profile_production`` at its full width (64 chains of 24×24, Nt =
   6, K = 10, bf16) cut to 1 therm sweep and 2-sweep segments, its
   ``torch.profiler`` trace read by ``analyze_trace`` (the trace parsed, the
   device's tracks CUDA streams holding K1, K1 on its schedule; the device
   busy share, time by kernel family and top kernels printed)
   (``profile.production``); ``bench_kernels`` at L = 24, batch 8, 3 reps,
   every row and none failed (``bench.kernels``); ``bench_forces`` at L =
   24 in float32, ``OK`` (``bench.forces``); ``spectra_parity_production``
   on the three checkpoint chains, ``pass`` at the script's tolerances and
   K2 twice a chain, its float64 oracle on the plain sums
   (``spectra.parity_production``); ``ab_rotation``
   at 24×24, batch 8, variants baseline and exp2_ph cut to a few sweeps,
   the JAX script's keys and finite numbers (``ab.rotation``);
   ``audit_rhos_dip`` cut to 4 + 6 sweeps, the report written and its
   f-sum finite (``audit.rhos_dip``); ``debug_transport`` at its defaults
   and at Δ = 0, ρ_s within 1e-8 of the analytic Drude weight
   (``debug.transport``); counts are reset before and read after each;
14. runs the headline benchmark ``drivers/bench.bench`` at its full widths
   (16×16 at 8 chains with its three modes and the eigh figures, 64 ×
   24×24, 40 × 32×32) with its depth cut (``BENCH_CUT``,
   ``BENCH_LEG_CUT``): every mode and leg finite traj/s and an acceptance
   in [0, 1], no error, K1 on its schedule, no K2, the PH guard's
   fallbacks and rescues reported (``bench``);
15. drives the tracked path at 46×46 (``tracked.large_lattice``):
   2 chains of 46×46 (2N = 4232) at the production couplings, the guarded
   PH init, a 2-sweep segment with K = 2 (Nt = 2, exp2) and one transport
   pass: every output finite, K1 on its schedule, K5 once a rotation,
   K2 twice, the allocator's peak and the seconds reported; then
   the graft entry: ``graft_entry.entry()`` on the card, its sweep twice
   (``graft.entry``), and ``dryrun_multichip(2)`` with both ranks on the
   card under its own limit, each rank's launches in its report
   (``graft.dryrun_multichip``);
16. replays the cheap tracked sweep as a CUDA graph
   (``parallel/cheap_graph``, ``graph.cheap_sweep``): two anchor periods
   of the fast mix at 16×16 with 8 chains, β changed between them, eager
   and through the graph, bit-equal, the launch counts equal, the peak
   allocated and reserved of each, the kernels a traced replay shows; then
   a cheap sweep eager against graph from 16×16/b8 to 24×24/b64, which set
   the gate's threshold;
17. profiles one more K=1 sweep and transport pass with ``torch.profiler``
   and prints device time by kernel family, then times five transport passes
   and profiles one alone (outside the counted window).

One JSON line per phase; then the card's ``nvidia-smi`` name and power
limit, the kernel table as one JSON line, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits nonzero before that line.  Without a CUDA device it exits 2 and prints
no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

#: operations per element (K1) and per Lorentzian (K2) counted for the bound:
#: K1 ≈ gap, |T| (3 + sqrt), atan2, scale and clamp, two divisions, sign and
#: four products; K2 = subtract, fused multiply-add, reciprocal, and a fused
#: multiply-accumulate counted as two each
K1_OPS_PER_ELEMENT = 20
K2_OPS_PER_LORENTZIAN = 6

L_MAIN = 24
N_CHAINS = 8
#: BASELINE config 5's lattice (``examples/config5_*.json``): 2N = 2048,
#: the real embedding 4096; its kernel phases run 2 chains, not 64 (the
#: plain K2 keeps a (B, 16, M) float32 block live, 17 GB at 64 chains)
C5_L = 32
#: the chains' temperatures: every third point of the production T grid
TEMPS = np.logspace(-4.0, 3.0, 24)[::3]
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


def cuda_ms(fn, reps: int, warmup: int = 2, graph: bool = False) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events.  With
    ``graph`` the calls are captured in one CUDA graph and replayed, so the
    host's per-call overhead drops out and a short kernel's own device time
    is what is measured."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    run = lambda: [fn() for _ in range(reps)]  # noqa: E731
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        g.replay()
        run = g.replay
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def roofline(nbytes: float, ops: float) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations") for work
    that moves ``nbytes`` and does ``ops`` float32 operations, at the H100
    SXM data sheet's HBM3 bandwidth and FP32 peak (``utils/flops.py``)."""
    from dwavehmc_tpu_torch.utils.flops import (
        H100_FP32_PEAK_TFLOPS,
        H100_HBM_BYTES_PER_S,
    )

    t_bytes = nbytes / H100_HBM_BYTES_PER_S
    t_ops = ops / (H100_FP32_PEAK_TFLOPS * 1e12)
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


def demo32_spec(lat):
    """``demo_32x32``'s grid: η = 8/N, Δω = 0.02, ω_max = 2 (100
    frequencies at 32×32, K2's narrow geometry)."""
    from dwavehmc_tpu_torch.models.params import SpectralSpec

    return SpectralSpec(eta=8.0 / lat.n_sites, domega=0.02, omega_max=2.0)


def main_config(dev):
    """(lattice, spectral grid, temperatures, params, per-chain dt) of the
    main path: 24×24, 8 chains at every third point of the production T
    grid (1e-4 … 1e3, 24 log-spaced points), float32."""
    from dwavehmc_tpu_torch.models.lattice import LatticeSpec
    from dwavehmc_tpu_torch.models.params import make_params
    from dwavehmc_tpu_torch.sampler.hmc import calc_optimal_dt

    lat = LatticeSpec(L_MAIN, L_MAIN)
    temps = TEMPS
    betas = (1.0 / temps).tolist()
    params = make_params(beta=betas, dtype=torch.float32, device=dev,
                         **PHYS)
    dt = torch.tensor([calc_optimal_dt(b, PHYS["J"], PHYS["mass"], NT)
                       for b in betas], device=dev)
    return lat, production_spec(lat), temps, params, dt


def expected_rotations(n_sweeps: int, K: int, nt: int = NT,
                       tracked: int = TRACK["tracked_iters"],
                       refine: int = TRACK["refine_iters"],
                       polish: int = TRACK["polish_iters"]) -> int:
    """K1 launches of one segment of ``nt``-step sweeps: every tracked
    rotation is one batched launch; cheap sweeps add the endpoint refine
    and polish rotations."""
    per_step = nt * tracked
    cheap = per_step + refine + polish
    total, done = 0, 0
    while done < n_sweeps:
        k = min(K, n_sweeps - done)
        total += (k - 1) * cheap + per_step
        done += k
    return total


def expected_hops(n_sweeps: int, K: int, nt: int = NT,
                  tracked: int = TRACK["tracked_iters"],
                  refine: int = TRACK["refine_iters"],
                  polish: int = TRACK["polish_iters"]) -> int:
    """K6 launches of one segment of ``nt``-step sweeps with float32
    rotations and a "highest" polish (``TRACK``): each tracked rotation and
    each step's readout is one product by H; cheap sweeps add the refine's
    and the polish's rotations, each phase with its readout."""
    return expected_rotations(n_sweeps, K, nt, tracked + 1, refine + 1,
                              polish + 1)


# --- kernels ----------------------------------------------------------------

#: K1 at ``drivers/bench.py``'s three shapes (16×16/b8, 24×24/b64,
#: 32×32/b40), timed alone
BENCH_K1_SHAPES = ((8, 512), (64, 1152), (40, 2048))


def k1_case(dev, g, B: int, n: int, power: str, label: str) -> dict:
    """K1 against its plain version at (B, n, n), both timed; inputs from
    ``g``.  Returns the kernel-table fields."""
    from dwavehmc_tpu_torch.ops import kernels

    a = torch.randn(B, n, n, generator=g, device=dev)
    b = torch.randn(B, n, n, generator=g, device=dev)
    tr, ti = (a + a.mT) * 0.01, (b - b.mT) * 0.01
    del a, b
    d = torch.sort(torch.randn(B, n, generator=g, device=dev),
                   dim=-1).values * 3.0
    before = kernels.LAUNCHES["rotation_s_parts"]
    sr, si = kernels.rotation_s_parts(tr, ti, d, 0.1)
    torch.cuda.synchronize()
    check(kernels.LAUNCHES["rotation_s_parts"] == before + 1,
          "K1 wrapper did not count its launch")
    pr, pi = kernels.rotation_s_parts_plain(tr, ti, d, 0.1)
    err = max(float((sr - pr).abs().max()), float((si - pi).abs().max()))
    del sr, si, pr, pi
    ms = cuda_ms(lambda: kernels.rotation_s_parts(tr, ti, d, 0.1), 20,
                 graph=True)
    plain_ms = cuda_ms(
        lambda: kernels.rotation_s_parts_plain(tr, ti, d, 0.1), 5)
    bound_ms, bound_by = roofline(4 * (4 * B * n * n + B * n),
                                  K1_OPS_PER_ELEMENT * B * n * n)
    emit({"phase": "kernel.rotation_s_parts", "case": label,
          "shape": [B, n, n], "max_abs_err": err, "tol": 1e-6, "ms": ms,
          "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
          "launches": kernels.LAUNCHES["rotation_s_parts"], "gpu": power})
    check(err <= 1e-6, f"K1 at {(B, n)}: max abs err {err} > 1e-6")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def kernel_phases(dev, gen, power: str):
    from dwavehmc_tpu_torch.models.lattice import LatticeSpec
    from dwavehmc_tpu_torch.ops import kernels

    table = {}
    # config 5's inputs come from a generator of their own, so that every
    # later phase draws what it drew before they were added; so do the
    # bench's shapes
    gen5 = torch.Generator(device=dev).manual_seed(C5_L)
    for B, n, label, g in ((N_CHAINS, 2 * L_MAIN * L_MAIN, "main", gen),
                           (2, 300, "unaligned", gen),
                           (2, 2 * C5_L * C5_L, "config5", gen5)):
        row = k1_case(dev, g, B, n, power, label)
        if label == "main":
            table["rotation_s_parts"] = row
    genb = torch.Generator(device=dev).manual_seed(16)
    for B, n in BENCH_K1_SHAPES:
        k1_case(dev, genb, B, n, power, "bench")
        torch.cuda.empty_cache()

    lat = LatticeSpec(L_MAIN, L_MAIN)
    spec = production_spec(lat)
    M = (2 * lat.n_sites) ** 2
    grid = torch.as_tensor(spec.omega_grid(), dtype=torch.float32,
                           device=dev)
    lat5 = LatticeSpec(C5_L, C5_L)
    spec5, spec5_demo = production_spec(lat5), demo32_spec(lat5)
    M5 = (2 * lat5.n_sites) ** 2

    def om_grid(sp):
        return torch.as_tensor(sp.omega_grid(), dtype=torch.float32,
                               device=dev)

    # (label, chains, grid, pairs, η, is the main path's σ(ω) call).  At
    # config 5's 4.19M pairs the float32 plain version's own rounding
    # reaches a few 1e-4 relative (cuBLAS sums 4.19M terms per product), so
    # there both are held against the plain version in float64
    cases = (("optical", N_CHAINS, grid, M, spec.eta, True),
             ("dc", N_CHAINS, None, M, spec.eta, False),
             ("optical", 2, grid, M, spec.eta, False),
             ("unaligned", 1, None, 1000, spec.eta, False),
             ("config5_optical", 2, om_grid(spec5), M5, spec5.eta, False),
             ("config5_narrow", 2, om_grid(spec5_demo), M5, spec5_demo.eta,
              False))
    for label, B, om, m, eta, main in cases:
        if label == "dc":
            omega = torch.zeros((B, 1), device=dev)
        elif label == "unaligned":
            omega = torch.linspace(0.01, 4.0, 37, device=dev)[None]
        else:
            omega = om.expand(B, -1).contiguous()
        g = gen5 if label.startswith("config5") else gen
        de = torch.randn(B, m, generator=g, device=dev) * 2.0
        w2 = torch.rand(B, m, generator=g, device=dev)
        before = kernels.LAUNCHES["weighted_lorentzian_sum"]
        got = kernels.weighted_lorentzian_sum(omega, de, w2, eta)
        torch.cuda.synchronize()
        check(kernels.LAUNCHES["weighted_lorentzian_sum"] == before + 1,
              "K2 wrapper did not count its launch")
        want = kernels.weighted_lorentzian_sum_plain(omega, de, w2, eta)
        ref = {}
        if label.startswith("config5"):
            want64 = kernels.weighted_lorentzian_sum_plain(
                omega.double(), de.double(), w2.double(), eta)
            ref = {"reference": "plain float64", "plain_f32_rel_err": float(
                ((want - want64).abs() / want64.abs()).max())}
            want = want64
        abs_err = float((got - want).abs().max())
        rel_err = float(((got - want).abs() / want.abs()).max())
        again = kernels.weighted_lorentzian_sum(omega, de, w2, eta)
        repeat = bool(torch.equal(got, again))
        ms = cuda_ms(lambda: kernels.weighted_lorentzian_sum(
            omega, de, w2, eta), 20, graph=True)
        plain_ms = cuda_ms(lambda: kernels.weighted_lorentzian_sum_plain(
            omega, de, w2, eta), 2, warmup=1)
        n_w = omega.shape[-1]
        bound_ms, bound_by = roofline(4 * (2 * B * n_w + 2 * B * m),
                                      K2_OPS_PER_LORENTZIAN * B * n_w * m)
        emit({"phase": f"kernel.weighted_lorentzian_sum.{label}",
              "shape": [B, n_w, m], "max_abs_err": abs_err,
              "max_rel_err": rel_err, "rtol": 1e-4, "bit_repeat": repeat,
              "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
              "launch": launch_geometry(n_w, m),
              "launches": kernels.LAUNCHES["weighted_lorentzian_sum"],
              **ref, "gpu": power})
        check(rel_err <= 1e-4, f"K2 {label} at {(B, n_w, m)}: rel err "
              f"{rel_err} > 1e-4")
        check(repeat, f"K2 {label}: two runs differ")
        if main:
            table["weighted_lorentzian_sum"] = dict(
                max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)
        del de, w2, got, want, again
    signed_phase(dev, gen, grid, spec.eta, power)
    return table


#: the kernels the main path launches
PATH_KERNELS = ("rotation_s_parts", "weighted_lorentzian_sum", "chain_sum",
                "sigma_cap", "bdg_hop")
#: K3 (``csrc/chain_sum.cu``) at the main path's shape first (the
#: energies' sums over 2N = 1152 values of 8 chains), then unaligned,
#: production-batch, config-5 float64 and the longest rows one block holds
#: in registers, then rows past them, which fold their upper levels as they
#: load (past 16384: 2N = 16562 at 91×91): (rows, length, dtype, is the main
#: path's)
CHAIN_CASES = ((N_CHAINS, 2 * L_MAIN * L_MAIN, "float32", True),
               (3, 7, "float32", False),
               (64, 2 * L_MAIN * L_MAIN, "float32", False),
               (N_CHAINS * 1152, 1152, "float32", False),
               (8, 2 * C5_L * C5_L, "float64", False),
               (2, 16384, "float64", False),
               (2, 16385, "float32", False),
               (3, 16562, "float64", False),
               (2, 40000, "float32", False))


def chain_kernel_phases(dev, power: str) -> dict:
    """K3 against its plain version (the same halving tree: the results
    must be bit-equal), also on the first half of its batch alone (the same
    bits as inside the batch), timed beside the plain version and
    ``torch.sum``, at every shape.  Inputs from a generator of their own."""
    from dwavehmc_tpu_torch.ops import kernels

    table = {}
    g = torch.Generator(device=dev).manual_seed(3)
    for B, m, dtype, main in CHAIN_CASES:
        dt = getattr(torch, dtype)
        x = torch.randn(B, m, generator=g, device=dev, dtype=dt)
        before = kernels.LAUNCHES["chain_sum"]
        got = kernels.chain_sum(x)
        torch.cuda.synchronize()
        check(kernels.LAUNCHES["chain_sum"] == before + 1,
              "chain_sum wrapper did not count its launch")
        want = kernels.chain_sum_plain(x)
        err = float((got - want).abs().max())
        bit_equal = bool(torch.equal(got, want))
        k = max(1, B // 2)
        invariant = bool(torch.equal(got[:k], kernels.chain_sum(x[:k])))
        ms = cuda_ms(lambda: kernels.chain_sum(x), 20, graph=True)
        plain_ms = cuda_ms(lambda: kernels.chain_sum_plain(x),
                           5 if main else 2, warmup=2 if main else 1)
        library_ms = cuda_ms(lambda: x.sum(-1), 20, graph=True)
        bound_ms, bound_by = roofline(dt.itemsize * (B * m + B), B * m)
        emit({"phase": "kernel.chain_sum", "shape": [B, m], "dtype": dtype,
              "max_abs_err": err, "bit_equal_plain": bit_equal,
              "block_alone_bit_equal": invariant, "ms": ms,
              "plain_ms": plain_ms, "library_ms": library_ms,
              "bound_ms": bound_ms, "bound_by": bound_by,
              "launches": kernels.LAUNCHES["chain_sum"], "gpu": power})
        if main:
            table["chain_sum"] = dict(max_abs_err=err, ms=ms,
                                      plain_ms=plain_ms, bound_ms=bound_ms,
                                      bound_by=bound_by,
                                      library_ms=library_ms)
        check(bit_equal, f"chain_sum at {(B, m)} {dtype}: differs from its "
              f"plain version by {err}")
        check(invariant, f"chain_sum at {(B, m)} {dtype}: a block alone "
              "gets other bits than inside the batch")
        del x, got, want
    return table


#: K5 (``csrc/sigma_cap.cu``) at the σ-cap's shapes: the bench's 16×16/b8,
#: the main path's, the production scan's 24 chains and 24×24/b64, config
#: 5's 32×32 at 2 chains, 46×46 and float64 8464: (chains, n, dtype, is the
#: main path's)
SIGMA_CASES = ((8, 512, "float32", False),
               (N_CHAINS, 2 * L_MAIN * L_MAIN, "float32", True),
               (24, 2 * L_MAIN * L_MAIN, "float32", False),
               (64, 2 * L_MAIN * L_MAIN, "float32", False),
               (2, 2 * C5_L * C5_L, "float32", False),
               (2, 4232, "float32", False),
               (1, 8464, "float64", False))
#: the card's L2 cache (H100 SXM): S that fits is read from device memory
#: once, not once a pass
L2_BYTES = 50 * 2**20


def _library_sigma_cap(S, iters: int = 3):
    """The same iteration in PyTorch's calls (order-unstable): the complex
    ``matmul``, the squares and ``torch.sum``, v0 made on the card."""
    B, n = S.shape[0], S.shape[-1]
    v = torch.full((B, n, 1), 1.0 / n ** 0.5, dtype=S.dtype, device=S.device)
    for _ in range(iters):
        w = torch.matmul(S, v)
        v = w / (torch.sqrt(torch.sum(w.real * w.real + w.imag * w.imag,
                                      dim=(-2, -1)))[:, None, None] + 1e-30)
    w = torch.matmul(S, v)
    return torch.sqrt(torch.sum(w.real * w.real + w.imag * w.imag,
                                dim=(-2, -1)))


def _wall_ms(fn, reps: int) -> float:
    """Host milliseconds per call over ``reps`` calls, the card drained
    before and after (so a call's own stream syncs are inside)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def _device_launches(fn) -> int:
    """Kernels and copies the card runs for one call of ``fn``
    (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def _sigma_cap_plans(sr, si, want) -> dict:
    """K5 under the plan each mode the kernels are built for at n would
    take, and with one CTA a chain (the chains in turns where the batch
    does not fit at once): bit-equal to ``want``, the graph-replay ms, and
    the kernel's registers, spills, shared memory and warps an SM (a
    comparison of the plans; the wrapper's own choice is timed apart)."""
    from dwavehmc_tpu_torch.ops import kernels

    B, n, dt = sr.shape[0], sr.shape[-1], sr.dtype
    query = kernels._resident_query(dt, n)
    plans = []
    for mode in kernels.SIGMA_CAP_MODES:
        try:
            plans.append(kernels.choose_sigma_cap_plan(
                B, n, dt.itemsize, query, modes=(mode,)))
        except ValueError:
            continue
    # the streamed plan with the L2 prefetch the other way round
    plans += [p._replace(prefetch=not p.prefetch) for p in plans
              if p.mode == "stream"]
    smem = kernels.sigma_cap_smem(n, 1, dt.itemsize, "stream")
    room = query("stream", smem) if smem <= kernels.SIGMA_CAP_SMEM_MAX else 0
    if room >= 1:
        plans.append(kernels.SigmaCapPlan(1, "stream", smem, min(B, room),
                                          True))
    out = {}
    for plan in plans:
        def run(plan=plan):
            return kernels.spectral_norm_est_cuda(sr, si, plan=plan)

        key = f"{plan.mode}:{plan.ctas}x{plan.at_once}"
        out[key + (":prefetch" if plan.prefetch else "")] = {
            "bit_equal_plain": bool(torch.equal(run(), want)),
            "ms": cuda_ms(run, 5, warmup=1, graph=True),
            **kernels.sigma_cap_info(n, dt, plan)}
    return out


def _signed_zeros(sr, si):
    """S with −0.0 entries: a diagonal of signed zeros as K1 writes it, a
    row of −0.0 and a row of mixed ±0."""
    n = sr.shape[-1]
    g = torch.Generator(device=sr.device).manual_seed(7)
    sign = torch.where(torch.rand(sr.shape[:-1], generator=g,
                                  device=sr.device) < 0.5,
                       -0.0, 0.0).to(sr.dtype)
    sr, si = sr.clone(), si.clone()
    sr.diagonal(dim1=-2, dim2=-1).copy_(sign)
    si.diagonal(dim1=-2, dim2=-1).copy_(sign.flip(-1))
    sr[:, 0] = -0.0
    si[:, 0] = -0.0
    sr[:, n // 2] = sign
    return sr, si


def sigma_cap_phase(dev, power: str) -> dict:
    """K5 against its plain version at ``SIGMA_CASES`` (bit-equal, also
    under every mode's plan and on a copy of S with −0.0 entries, and a
    block of the batch alone gets the batch's bits), timed (CUDA-graph
    replay, eager, and wall clock per call) beside the plain version, the
    library's iteration under graph replay, and two bounds: S read
    once and four times (a pass each) at the card's memory rate.  Each
    plan's mode, registers, spills, shared memory and warps an SM come
    from the kernel's attributes and the residency query.  The kernels and
    copies each σ-cap puts on the card are counted with ``torch.profiler``
    at the main path's shape.  Inputs from a generator of their own."""
    from dwavehmc_tpu_torch.ops import kernels

    table = {}
    g = torch.Generator(device=dev).manual_seed(5)
    t0 = time.perf_counter()
    for B, n, dtype, main in SIGMA_CASES:
        dt = getattr(torch, dtype)
        a = torch.randn(B, n, n, generator=g, device=dev, dtype=dt)
        sr = (a - a.mT) * 0.01
        a = torch.randn(B, n, n, generator=g, device=dev, dtype=dt)
        si = (a + a.mT) * 0.01
        del a
        before = kernels.LAUNCHES["sigma_cap"]
        got = kernels.spectral_norm_est(sr, si)
        torch.cuda.synchronize()
        check(kernels.LAUNCHES["sigma_cap"] == before + 1,
              "sigma_cap wrapper did not count its launch")
        want = kernels.spectral_norm_est_plain(sr, si)
        err = float((got - want).abs().max())
        bit_equal = bool(torch.equal(got, want))
        k = max(1, B // 2)
        invariant = bool(torch.equal(
            kernels.spectral_norm_est(sr[:k], si[:k]), got[:k]))
        zr, zi = _signed_zeros(sr, si)
        zeros_equal = bool(torch.equal(kernels.spectral_norm_est(zr, zi),
                                       kernels.spectral_norm_est_plain(zr,
                                                                       zi)))
        del zr, zi
        plan = kernels._sigma_cap_plan(B, n, dt)
        plan_info = kernels.sigma_cap_info(n, dt, plan)
        plans = _sigma_cap_plans(sr, si, want)
        ms = cuda_ms(lambda: kernels.spectral_norm_est(sr, si), 20,
                     graph=True)
        eager_ms = cuda_ms(lambda: kernels.spectral_norm_est(sr, si), 20)
        wall_ms = _wall_ms(lambda: kernels.spectral_norm_est(sr, si), 20)
        plain_ms = cuda_ms(lambda: kernels.spectral_norm_est_plain(sr, si),
                           2, warmup=1)
        S = torch.complex(sr, si)
        library_ms = cuda_ms(lambda: _library_sigma_cap(S), 20, graph=True)
        lib_err = float((_library_sigma_cap(S) - want).abs().max())
        del S
        s_bytes = 2 * B * n * n * dt.itemsize
        ops = 4 * 8 * B * n * n
        bound_ms, bound_by = roofline(s_bytes + B * dt.itemsize, ops)
        four_ms, _ = roofline(4 * s_bytes + B * dt.itemsize, ops)
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=library_ms)
        launches = {}
        if main:
            launches = {"sigma_cap": _device_launches(
                lambda: kernels.spectral_norm_est(sr, si)),
                "library": _device_launches(
                    lambda: _library_sigma_cap(torch.complex(sr, si)))}
            table["sigma_cap"] = row
            check(launches["sigma_cap"] == 1, "sigma_cap put "
                  f"{launches['sigma_cap']} operations on the card a call")
        emit({"phase": "kernel.sigma_cap", "shape": [B, n], "dtype": dtype,
              "plan": {**plan._asdict(), **plan_info}, "plans_ms": plans,
              "bit_equal_plain": bit_equal,
              "signed_zeros_bit_equal_plain": zeros_equal,
              "block_alone_bit_equal": invariant,
              "library_max_abs_diff": lib_err, **row,
              "eager_ms": eager_ms, "wall_ms": wall_ms,
              "bound_four_reads_ms": four_ms,
              "s_fits_l2": s_bytes <= L2_BYTES,
              "device_ops_per_call": launches,
              "seconds_so_far": time.perf_counter() - t0,
              "launches": kernels.LAUNCHES["sigma_cap"], "gpu": power})
        check(bit_equal, f"sigma_cap at {(B, n)} {dtype}: differs from its "
              f"plain version by {err}")
        check(all(p["bit_equal_plain"] for p in plans.values()),
              f"sigma_cap at {(B, n)} {dtype}: a plan differs from the "
              f"plain version ({plans})")
        check(invariant, f"sigma_cap at {(B, n)} {dtype}: a block alone gets "
              "other bits than inside the batch")
        check(zeros_equal, f"sigma_cap at {(B, n)} {dtype}: S with -0.0 "
              "entries differs from the plain version")
        del sr, si, got, want
        torch.cuda.empty_cache()
    return table


#: K6 (``csrc/bdg_hop.cu``) at the bench's 16×16/b8, the main path's
#: 24×24/b8 and the production 24×24/b64, then n = 50 (rows not 16-byte
#: aligned) and 46×46 (a ragged chunk of columns): (chains, L, is the
#: production shape)
HOP_CASES = ((8, 16, False), (N_CHAINS, L_MAIN, False), (64, 24, True),
             (3, 5, False), (2, 46, False))


def _hop_inputs(dev, g, B: int, L: int):
    """(hr, hi, ur, ui, K6's table): H with the BdG pattern of an L×L
    lattice (random, zero off the table), U random, float32."""
    from dwavehmc_tpu_torch.models.bdg_real import hamiltonian_columns
    from dwavehmc_tpu_torch.models.lattice import LatticeSpec
    from dwavehmc_tpu_torch.ops import kernels

    cols, nnz = hamiltonian_columns(LatticeSpec(L, L))
    table = kernels.bdg_hop_table(cols, nnz, dev)
    n = cols.shape[0]
    c = table.cols.long()
    live = torch.arange(13, device=dev)[None, :] < table.nnz.long()[:, None]
    mask = torch.zeros((n, n), dtype=torch.bool, device=dev)
    mask[torch.arange(n, device=dev)[:, None].expand_as(c)[live],
         c[live]] = True
    hr, hi, ur, ui = (torch.randn(B, n, n, generator=g, device=dev)
                      for _ in range(4))
    return hr * mask, hi * mask, ur, ui, (cols, nnz, table)


def bdg_hop_phase(dev, power: str) -> dict:
    """K6 against its plain version and the float64 product at
    ``HOP_CASES`` (each entry within 4e-6 of Σ|h||u|), timed by CUDA-graph
    replay beside its bound (U read and W written once, 16 n² bytes a
    chain, at the card's memory rate), the plain version (eager) and the
    dense 3-multiplication product the projections ran before it
    (``ops/tracked_eigh.cmm``: three GEMMs and their adds, graph replay).
    Inputs from a generator of their own."""
    from dwavehmc_tpu_torch.ops import kernels
    from dwavehmc_tpu_torch.ops.tracked_eigh import cmm

    table = {}
    g = torch.Generator(device=dev).manual_seed(6)
    for B, L, main in HOP_CASES:
        hr, hi, ur, ui, (cols, nnz, hop) = _hop_inputs(dev, g, B, L)
        n = cols.shape[0]
        before = kernels.LAUNCHES["bdg_hop"]
        wr, wi = kernels.bdg_hop(hr, hi, hop, ur, ui)
        torch.cuda.synchronize()
        check(kernels.LAUNCHES["bdg_hop"] == before + 1,
              "bdg_hop wrapper did not count its launch")
        pr, pi = kernels.bdg_hop_plain(hr, hi, hop, ur, ui)
        H = torch.complex(hr.double(), hi.double())
        U = torch.complex(ur.double(), ui.double())
        want = H @ U
        size = H.abs() @ U.abs()
        del H, U
        rel = max(float(((a.double() - w).abs() / size).max())
                  for a, w in ((wr, want.real), (wi, want.imag)))
        plain_rel = max(float(((a.double() - w).abs() / size).max())
                        for a, w in ((pr, want.real), (pi, want.imag)))
        del want, size, pr, pi
        ms = cuda_ms(lambda: kernels.bdg_hop(hr, hi, hop, ur, ui), 20,
                     graph=True)
        plain_ms = cuda_ms(lambda: kernels.bdg_hop_plain(hr, hi, hop, ur, ui),
                           3, warmup=1)
        library_ms = cuda_ms(lambda: cmm(hr, hi, ur, ui), 20, graph=True)
        bound_ms, bound_by = roofline(16.0 * B * n * n, 104.0 * B * n * n)
        row = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   max_rel_err=rel)
        emit({"phase": "kernel.bdg_hop", "shape": [B, n], "L": L,
              "plain_max_rel_err": plain_rel, "rows_per_block":
              hop.rows.shape[1], "halo_rows": hop.halo.shape[1],
              "bound_pct": 100.0 * bound_ms / ms, **row,
              "launches": kernels.LAUNCHES["bdg_hop"], "gpu": power})
        if main:
            table["bdg_hop"] = row
        check(rel <= 4e-6 and plain_rel <= 4e-6,
              f"bdg_hop at {(B, n)}: {rel} (plain {plain_rel}) of Σ|h||u| "
              "off the float64 product")
        del hr, hi, ur, ui, wr, wi
        torch.cuda.empty_cache()
    return table


def launch_geometry(n_w: int, M: int) -> dict:
    from dwavehmc_tpu_torch.ops import kernels

    g = kernels._lorentzian_launch(n_w, M)
    return dict(g._asdict(), threads=g.threads, columns=g.columns,
                smem_bytes=g.smem_bytes)


def signed_pairs(betas, n_levels: int, gen, dev):
    """(de, w2) of σ(ω) as ``models/transport.optical_conductivity`` builds
    them, for a ±-symmetric sorted spectrum of ``n_levels`` levels per
    chain, Fermi factors at ``betas`` and a random symmetric nonnegative
    |J|²: de = E_m − E_n, w2 = (f_n − f_m)·|J_nm|², float32 (B, n_levels²)."""
    from dwavehmc_tpu_torch.ops.spectral import fermi_factors

    B = len(betas)
    e = torch.randn(B, n_levels // 2, generator=gen, device=dev,
                    dtype=torch.float64).abs() * 1.5
    E = torch.sort(torch.cat([-e, e], dim=-1), dim=-1).values
    f = fermi_factors(E, torch.tensor(betas, dtype=torch.float64,
                                      device=dev))
    a = torch.rand(B, n_levels, n_levels, generator=gen, device=dev,
                   dtype=torch.float64)
    J2 = 0.5 * (a + a.mT)
    de = (E[:, None, :] - E[:, :, None]).reshape(B, -1)
    w2 = ((f[:, :, None] - f[:, None, :]) * J2).reshape(B, -1)
    return de.float(), w2.float()


def signed_phase(dev, gen, grid, eta: float, power: str) -> None:
    """K2 on the σ(ω) path's signed weights at the main-path shape, the
    kernel and the float32 plain version each held against the float64
    plain version; error = max |S − S64| / max |S64| per chain."""
    from dwavehmc_tpu_torch.ops import kernels

    betas = (1.0 / TEMPS).tolist()
    de, w2 = signed_pairs(betas, 2 * L_MAIN * L_MAIN, gen, dev)
    omega = grid.expand(len(betas), -1).contiguous()
    got = kernels.weighted_lorentzian_sum(omega, de, w2, eta)
    plain32 = kernels.weighted_lorentzian_sum_plain(omega, de, w2, eta)
    want = kernels.weighted_lorentzian_sum_plain(
        omega.double(), de.double(), w2.double(), eta)
    torch.cuda.synchronize()
    scale = want.abs().amax(dim=-1)

    def err(s):
        return float(((s.double() - want).abs().amax(dim=-1) / scale).max())

    kernel_err, plain_err = err(got), err(plain32)
    tol = max(4.0 * plain_err, 1e-5)
    emit({"phase": "kernel.weighted_lorentzian_sum.signed",
          "shape": list(de.shape[:1]) + [omega.shape[-1], de.shape[-1]],
          "kernel_err": kernel_err, "plain_f32_err": plain_err, "tol": tol,
          "finite": bool(torch.isfinite(got).all()), "gpu": power})
    check(bool(torch.isfinite(got).all()), "K2 signed: non-finite output")
    check(kernel_err <= tol, f"K2 signed: error {kernel_err} > {tol} "
          f"(float32 plain {plain_err})")


# --- small run: card (float32, kernels) vs CPU (float64, plain) -------------

def reference_phase(dev, seed: int, solver: str) -> None:
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
                             n_imp=PHYS["n_imp"], exact_solver=solver,
                             device="cpu")
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
    track = dict(TRACK, exact_solver=solver)
    _, seg64 = run_segment_tracked(lat, p64, s64, 1, NT,
                                   torch.tensor(dt, dtype=torch.float64),
                                   normals=normals, uniforms=uniforms,
                                   **track)
    _, seg32 = run_segment_tracked(lat, p32, s32, 1, NT,
                                   torch.tensor(dt, device=dev),
                                   normals=normals, uniforms=uniforms,
                                   **track)
    dH64, dH32 = seg64.dH[0], seg32.dH[0].double().cpu()
    emit({"phase": "reference.6x6", "exact_solver": solver,
          "transport_rel_l2": rel,
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
        torch.cuda.reset_peak_memory_stats(dev)
        (states, seg), sec = timed(lambda: run_segment_tracked(
            lat, params, states, n_sweeps, NT, dt, True,
            anchor_every=K, generator=gen, **TRACK))
        if K == 1:
            memory_phase(dev, lat, torch.cuda.max_memory_allocated(dev),
                         power)
        c1 = counts()
        k1 = c1["rotation_s_parts"] - c0["rotation_s_parts"]
        k6 = c1["bdg_hop"] - c0["bdg_hop"]
        emit({"phase": f"main.segment_K{K}", "sweeps": n_sweeps, "Nt": NT,
              "acceptance": seg.accepted.float().mean().item(),
              "accepted": seg.accepted.int().tolist(),
              "dH": seg.dH.tolist(), "seconds": sec,
              "traj_per_s": N_CHAINS * n_sweeps / sec,
              "k1_launches": k1, "k6_launches": k6, "gpu": power})
        check(k1 == expected_rotations(n_sweeps, K),
              f"K{K} segment: {k1} K1 launches, schedule implies "
              f"{expected_rotations(n_sweeps, K)}")
        check(k6 == expected_hops(n_sweeps, K),
              f"K{K} segment: {k6} K6 launches, schedule implies "
              f"{expected_hops(n_sweeps, K)}")
        check(c1["hu_dense"] == c0["hu_dense"],
              f"K{K} segment: {c1['hu_dense'] - c0['hu_dense']} float32 "
              "IEEE products by H left dense")
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


def memory_phase(dev, lat, peak: int, power: str) -> None:
    """``utils/memory.estimate_memory`` of the main path's chains beside the
    allocator's peak over ``main.segment_K1``."""
    from dwavehmc_tpu_torch.utils.memory import device_memory, estimate_memory

    est = estimate_memory(lat, N_CHAINS, torch.float32)
    emit({"phase": "memory", "lattice": [lat.Lx, lat.Ly], "chains": N_CHAINS,
          "estimate": str(est), "estimate_bytes": est.total_bytes,
          "max_memory_allocated_bytes": peak,
          "estimate_over_allocated": est.total_bytes / peak,
          "card_bytes": device_memory(dev), "gpu": power})
    check(peak > 0, "memory: no allocation over main.segment_K1")


def _device_profile(fn) -> tuple[float, dict]:
    """(wall ms, device µs by kernel name) of one call of ``fn`` under
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels_us = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels_us[ev.key] = kernels_us.get(ev.key, 0.0) + \
                ev.self_device_time_total
    return 1e3 * wall, kernels_us


def _profile_summary(wall_ms: float, kernels_us: dict) -> dict:
    from dwavehmc_tpu_torch.drivers.analyze_trace import family

    families = {}
    for name, us in kernels_us.items():
        fam = family(name)
        families[fam] = families.get(fam, 0.0) + us / 1e3
    busy_ms = sum(kernels_us.values()) / 1e3
    top = sorted(kernels_us.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "k2_kernels_ms": {k[:60]: us / 1e3 for k, us in kernels_us.items()
                              if "lorentz" in k.lower()},
            "family_ms": dict(sorted(families.items(), key=lambda kv: -kv[1])),
            "top_kernels_ms": [[k[:90], us / 1e3] for k, us in top]}


def profile_phase(dev, seed: int, power: str) -> None:
    """Device time by kernel family over one K=1 sweep plus one transport
    pass of the main configuration; then five transport passes timed on the
    host one by one, and one more profiled alone."""
    from dwavehmc_tpu_torch.parallel.ensemble import (
        ensemble_transport_real,
        init_ensemble_real,
        run_segment_tracked,
    )

    lat, spec, _temps, params, dt = main_config(dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    states = init_ensemble_real(lat, params, gen, N_CHAINS,
                                n_imp=PHYS["n_imp"], device=dev)

    def sweep_and_transport():
        nonlocal states
        states, _ = run_segment_tracked(lat, params, states, 1, NT, dt,
                                        True, anchor_every=1, generator=gen,
                                        **TRACK)
        ensemble_transport_real(lat, spec, params, states)

    emit({"phase": "profile.sweep_K1_and_transport",
          **_profile_summary(*_device_profile(sweep_and_transport)),
          "gpu": power})

    def transport():
        return ensemble_transport_real(lat, spec, params, states)

    seconds = _host_pass_seconds(transport)
    emit({"phase": "profile.transport", "pass_seconds": seconds,
          "median_seconds": float(np.median(seconds)),
          **_profile_summary(*_device_profile(transport)), "gpu": power})
    profile_complex_phase(dev, seed, power)


def _host_pass_seconds(fn, reps: int = 5) -> list:
    """Host-timed seconds of ``reps`` calls, each ending in a synchronize."""
    seconds = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return seconds


def profile_complex_phase(dev, seed: int, power: str) -> None:
    """The complex path at the main configuration (24×24, 8 chains at the
    main path's temperatures, Nt = 20): three sweeps host-timed, then one
    profiled; five transport passes host-timed, then one profiled."""
    from dwavehmc_tpu_torch.parallel.ensemble import (
        ensemble_transport,
        init_ensemble,
        run_segment,
    )
    from dwavehmc_tpu_torch.sampler.hmc import calc_optimal_dt

    lat, spec, _temps, params, _dt = main_config(dev)
    nt = SIM["Nt_measure"]
    dt = torch.tensor([calc_optimal_dt(b, PHYS["J"], PHYS["mass"], nt)
                       for b in params.beta.tolist()], device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    states = init_ensemble(lat, params, gen, N_CHAINS, n_imp=PHYS["n_imp"],
                           device=dev)

    def sweep():
        nonlocal states
        states, _ = run_segment(lat, params, states, 1, nt, dt,
                                generator=gen)

    sweep_s = _host_pass_seconds(sweep, 3)
    emit({"phase": "profile.sweep_complex", "Nt": nt,
          "sweep_seconds": sweep_s,
          "traj_per_s": N_CHAINS / float(np.median(sweep_s)),
          **_profile_summary(*_device_profile(sweep)), "gpu": power})

    def transport():
        return ensemble_transport(lat, spec, params, states)

    seconds = _host_pass_seconds(transport)
    emit({"phase": "profile.transport_complex", "pass_seconds": seconds,
          "median_seconds": float(np.median(seconds)),
          **_profile_summary(*_device_profile(transport)), "gpu": power})



# --- the exact anchor: guarded PH solve vs the full eigh ---------------------

def _anchor_batch(dev, gen, gapless_first: bool = False):
    """(params, embedding M) of 8 chains at 24×24: the production couplings,
    disorder and a random Δ start (a non-degenerate spectrum); with
    ``gapless_first`` chain 0 is the clean lattice at t′ = 0, μ = 0, Δ = 0,
    whose band touches zero."""
    from dwavehmc_tpu_torch.models.bdg_real import (
        assemble_embedding, static_embedding)
    from dwavehmc_tpu_torch.models.lattice import LatticeSpec
    from dwavehmc_tpu_torch.models.params import make_params
    from dwavehmc_tpu_torch.sampler.hmc_real import init_chain_state_real

    lat = LatticeSpec(L_MAIN, L_MAIN)
    tp = [PHYS["tp"]] * N_CHAINS
    mu = [PHYS["mu"]] * N_CHAINS
    if gapless_first:
        tp[0] = mu[0] = 0.0
    phys = dict(PHYS, tp=tp, mu=mu)
    params = make_params(beta=(1.0 / TEMPS).tolist(), dtype=torch.float32,
                         device=dev, **phys)
    s = init_chain_state_real(lat, params, N_CHAINS, generator=gen,
                              n_imp=PHYS["n_imp"], diagonalize=False,
                              device=dev)
    if gapless_first:
        for x in (s.delta_re, s.delta_im, s.disorder):
            x[0] = 0.0
    M = assemble_embedding(lat, static_embedding(lat, params.t, params.tp,
                                                 params.mu, s.disorder),
                           s.delta_re, s.delta_im)
    return M


def event_ms(fn, reps: int = 3) -> list:
    """Device milliseconds of ``reps`` single calls, each between two CUDA
    events (after one warm-up call)."""
    fn()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        out.append(start.elapsed_time(stop))
    return out


def _positive_projector(X, Y):
    """(Re, Im) of Σ_{E>0} u u† from the (B, 2N, 2N) eigenvector parts."""
    n = X.shape[-1] // 2
    Xp, Yp = X[..., n:], Y[..., n:]
    return Xp @ Xp.mT + Yp @ Yp.mT, Yp @ Xp.mT - Xp @ Yp.mT


#: orthonormality of the PH eigenvectors in float32, ‖XᵀX + YᵀY − I‖max: the
#: JAX package's own bound (tests/test_ph_eigh.py).  The positive/negative
#: cross block measures the positive subspace's error, ≈ ε·‖M‖/gap for the
#: levels nearest zero, so it exceeds float32 ``eigh``'s own at 2304.
PH_ORTH_TOL = 5e-4


def anchor_phases(dev, gen, power: str) -> None:
    """The guarded PH solve at the main path's shape against float64 and
    float32 ``torch.linalg.eigh`` and the full-embedding (qdwh) anchor, then
    the fallback on a batch holding one gapless chain."""
    from dwavehmc_tpu_torch.models.bdg_real import diagonalize_embedding
    from dwavehmc_tpu_torch.ops import ph_eigh

    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "float32 matmuls are not IEEE (TF32 allowed)")
    M = _anchor_batch(dev, gen)
    ph_eigh.reset_guard()
    ev, X, Y, fb = ph_eigh.diagonalize_embedding_ph_guarded(M)
    w64 = torch.linalg.eigvalsh(M.double())[..., ::2]
    w32 = torch.linalg.eigvalsh(M)[..., ::2]
    ev_q, X_q, Y_q = diagonalize_embedding(M)
    norm = float(M.abs().sum(-1).amax())
    err_ph = float((ev.double() - w64).abs().max())
    err_32 = float((w32.double() - w64).abs().max())
    tol = max(4.0 * err_32, 1e-5 * norm)
    eye = torch.eye(X.shape[-1], device=dev)
    orth = float((X.mT @ X + Y.mT @ Y - eye).abs().max())
    (pr, pi), (qr, qi) = _positive_projector(X, Y), _positive_projector(
        X_q, Y_q)
    proj = max(float((pr - qr).abs().max()), float((pi - qi).abs().max()))
    ph_ms = event_ms(lambda: ph_eigh.diagonalize_embedding_ph_guarded(M))
    qdwh_ms = event_ms(lambda: diagonalize_embedding(M))
    ph_profile = _profile_summary(*_device_profile(
        lambda: ph_eigh.diagonalize_embedding_ph_guarded(M)))
    emit({"phase": "anchor.ph", "shape": list(M.shape),
          "used_fallback": fb, "eval_err_ph": err_ph,
          "eval_err_eigh_f32": err_32, "tol": tol, "norm_inf": norm,
          "orth_err": orth, "projector_err_vs_qdwh": proj,
          "ph_ms": ph_ms, "ph_ms_median": float(np.median(ph_ms)),
          "qdwh_ms": qdwh_ms, "qdwh_ms_median": float(np.median(qdwh_ms)),
          "ph_profile": {k: ph_profile[k] for k in (
              "wall_ms", "device_busy_ms", "family_ms", "top_kernels_ms")},
          "guard": dict(ph_eigh.GUARD), "gpu": power})
    check(not fb, "anchor.ph: the guard fell back on a healthy batch")
    check(err_ph <= tol, f"anchor.ph: eigenvalue error {err_ph} > {tol}")
    check(orth <= PH_ORTH_TOL, f"anchor.ph: ‖XᵀX+YᵀY−I‖max {orth} > "
          f"{PH_ORTH_TOL}")
    check(proj <= 1e-3, f"anchor.ph: projector differs from qdwh's by "
          f"{proj} > 1e-3")
    del X, Y, X_q, Y_q, pr, pi, qr, qi

    Mg = _anchor_batch(dev, gen, gapless_first=True)
    ev, X, Y, fb = ph_eigh.diagonalize_embedding_ph_guarded(Mg)
    ev0, X0, Y0 = diagonalize_embedding(Mg)
    diff = max(float((a - b).abs().max())
               for a, b in ((ev, ev0), (X, X0), (Y, Y0)))
    emit({"phase": "anchor.ph_fallback", "shape": list(Mg.shape),
          "used_fallback": fb, "max_abs_diff_vs_diagonalize_embedding": diff,
          "guard": dict(ph_eigh.GUARD), "gpu": power})
    check(fb, "anchor.ph_fallback: the gapless chain did not force the "
          "fallback")
    check(diff == 0.0, f"anchor.ph_fallback: result differs from "
          f"diagonalize_embedding by {diff}")


#: further random-Δ batches the guard runs on (``anchor.ph_draws``), each from
#: a generator of its own, seeded 1001, 1002, …
PH_DRAW_BATCHES = 8
#: a chain whose float32 smallest-level ratio is under this many times the
#: guard's floor also gets its levels in float64
PH_DRAW_NEAR = 4.0


def _other_rescues(M, sgn, w64) -> dict:
    """The broken-down chains' largest eigenvalue error against float64
    (``w64``, one per doubled level) under the two rescues the guard does
    not use: CholeskyQR³'s passes in float64 on the float32 sketch Y, and
    the matmul-only ``orth_ns`` of Y; each then a float32 Ritz step."""
    from dwavehmc_tpu_torch.ops import ph_eigh

    Y = ph_eigh._sketched(M, sgn)
    out = {}
    for name, Q in (("float64_passes", ph_eigh.cholqr2(Y.double()).float()),
                    ("orth_ns", ph_eigh.orth_ns(Y))):
        wt, _ = ph_eigh._ritz(M, Q)
        half = w64.shape[-1] // 2
        out[name] = (wt[..., ::2].double() - w64[..., half:]).abs().amax(
            -1).tolist()
    return out


def _sketch_condition(M, sgn) -> list:
    """κ of each chain's float32 sketch Y = P₊G, from its float64 singular
    values."""
    from dwavehmc_tpu_torch.ops import ph_eigh

    sv = torch.linalg.svdvals(ph_eigh._sketched(M, sgn).double())
    return (sv[..., 0] / sv[..., -1]).tolist()


def ph_draws_phase(dev, power: str) -> None:
    """The guarded PH anchor on ``PH_DRAW_BATCHES`` seeded batches of the
    main path's shape (8 × 2304, a random Δ start, as ``anchor.ph``'s): per
    batch whether it fell back, the sign iteration's largest residual
    against ``PH_GUARD_RESID``, the smallest |Ritz value| / ‖M‖∞ against
    ``PH_GUARD_RATIO`` (the guard's own quantities, recomputed without the
    rescue), the chains whose float32 CholeskyQR³ broke down (a non-finite
    ``positive_basis``) and which the guard rescued (``GUARD["rescued"]``),
    and, for chains within ``PH_DRAW_NEAR``× of the ratio floor, the same
    ratio from float64 ``eigvalsh``.  On a batch with a rescue: each
    chain's eigenvalue error against float64 ``eigvalsh`` (a rescued
    chain's must be at most the worst healthy chain's), the rescued
    chains' error under the two rescues the guard does not use
    (``_other_rescues``), each chain's κ(P₊G) (``_sketch_condition``),
    and the guarded solve's device ms.  A fallback where float64 puts every level above
    the floor is a false one: their count must be 0 (F5)."""
    from dwavehmc_tpu_torch.ops import ph_eigh

    rows = []
    for i in range(PH_DRAW_BATCHES):
        g = torch.Generator(device=dev).manual_seed(1001 + i)
        M = _anchor_batch(dev, g)
        ph_eigh.reset_guard()
        ev, _, _, fb = ph_eigh.diagonalize_embedding_ph_guarded(M)
        guard = dict(ph_eigh.GUARD)
        sgn, resid = ph_eigh.sign_embedding(M, return_resid=True)
        Q = ph_eigh.positive_basis(M, sgn)
        broken = torch.nonzero(~torch.isfinite(Q).all(-1).all(-1))
        wt, _ = ph_eigh._ritz(M, Q)
        lam = M.abs().sum(-1).amax(-1)
        ratio = (wt.abs().amin(-1) / lam).double().cpu()
        near = torch.nonzero(ratio < PH_DRAW_NEAR * ph_eigh.PH_GUARD_RATIO)
        ratio64 = ratio.clone()
        del Q, wt
        if len(near):
            idx = near[:, 0].to(dev)
            w64 = torch.linalg.eigvalsh(M[idx].double())
            ratio64[near[:, 0]] = (w64.abs().amin(-1)
                                   / lam[idx].double()).cpu()
        below = bool((ratio64 <= ph_eigh.PH_GUARD_RATIO).any())
        row = {"seed": 1001 + i, "fell_back": fb, "guard": guard,
               "max_resid": float(resid.max()),
               "resid_passed": bool((resid < ph_eigh.PH_GUARD_RESID).all()),
               "min_ratio_f32": ratio.tolist(),
               "min_ratio_f64_near": {int(c): float(ratio64[c])
                                      for c in near[:, 0]},
               "basis_nonfinite_chains": broken[:, 0].tolist(),
               "level_below_floor_f64": below,
               "false_fallback": fb and not below}
        if guard["rescued"]:
            w64 = torch.linalg.eigvalsh(M.double())[..., ::2]
            err = (ev.double() - w64).abs().amax(-1).cpu()
            bad = row["basis_nonfinite_chains"]
            healthy = [float(err[c]) for c in range(len(err))
                       if c not in bad]
            row.update(eval_err=err.tolist(),
                       eval_err_healthy_max=max(healthy),
                       eval_err_rescued={c: float(err[c]) for c in bad},
                       eval_err_other_rescues=_other_rescues(
                           M[bad], sgn[bad], w64[bad]),
                       kappa_Y=_sketch_condition(M, sgn),
                       guarded_ms=event_ms(
                           lambda: ph_eigh.diagonalize_embedding_ph_guarded(
                               M)))
            del w64
        rows.append(row)
        del M, ev, sgn
    false = sum(r["false_fallback"] for r in rows)
    emit({"phase": "anchor.ph_draws", "batches": rows,
          "resid_floor": ph_eigh.PH_GUARD_RESID,
          "ratio_floor": ph_eigh.PH_GUARD_RATIO,
          "fallbacks": sum(r["fell_back"] for r in rows),
          "batches_with_a_level_below_floor": sum(
              r["level_below_floor_f64"] for r in rows),
          "batches_with_a_basis_breakdown": sum(
              bool(r["basis_nonfinite_chains"]) for r in rows),
          "rescued_chains": sum(r["guard"]["rescued"] for r in rows),
          "false_fallbacks": false, "gpu": power})
    check(false == 0, f"anchor.ph_draws: {false} fallbacks in "
          f"{PH_DRAW_BATCHES} batches with every level above the floor")
    for r in rows:
        check(r["guard"]["rescued"] == len(r["basis_nonfinite_chains"]),
              f"anchor.ph_draws seed {r['seed']}: {r['guard']['rescued']} "
              f"chains rescued, {len(r['basis_nonfinite_chains'])} broke "
              "down")
        for c, e in r.get("eval_err_rescued", {}).items():
            check(e <= r["eval_err_healthy_max"],
                  f"anchor.ph_draws seed {r['seed']}: rescued chain {c}'s "
                  f"eigenvalue error {e} > the healthy chains' "
                  f"{r['eval_err_healthy_max']}")


#: the production cell of the benchmark, and the seed on which, at dt × 1.0
#: and 10 thermalization sweeps, one of its chains diverged and the
#: anchor's float32 ``eigh`` did not converge (ROADMAP fault F8); at the
#: cell's own settings the seed's run diverges several trajectories too
F8_CELL, F8_SEED = "dwave24_b64.fast", 3500000012
#: a trajectory whose |ΔH| passes this (or is not finite) has diverged
DIVERGED_DH = 1e6


def diverged_chain_phase(dev, power: str, seconds: float = 51.0) -> dict:
    """The benchmark's production cell (64 chains of 24×24, the fast mix)
    from ``F8_SEED`` as ``hmc_bench.run`` drives it (``harness.run_cell``:
    ``init_fn``, the thermalization, the warm-up period and a window of
    ``seconds``), each ``seg_fn`` call watched: the guard's counts over
    it, and each trajectory whose |ΔH| passes ``DIVERGED_DH`` or is not
    finite with its decision (``anchor.diverged_chain``).  The run must
    end, every such trajectory be rejected, and the final state be finite;
    ``GUARD["redone"]`` counts the chains whose float32 ``eigh`` did not
    converge and were redone in float64."""
    from dwavehmc_tpu_torch.ops import ph_eigh
    from hmc_bench.harness import load_cell, run_cell

    calls = []

    def watch(seg_fn):
        def step(*a, **k):
            g0, t0 = dict(ph_eigh.GUARD), time.perf_counter()
            states, res = seg_fn(*a, **k)
            dH = res.dH.double().cpu()
            acc = res.accepted.cpu()
            bad = torch.nonzero(~torch.isfinite(dH)
                                | (dH.abs() > DIVERGED_DH)).tolist()
            calls.append({
                "sweeps": int(dH.shape[0]),
                "seconds": time.perf_counter() - t0,
                "guard": {n: ph_eigh.GUARD[n] - g0[n] for n in g0},
                "diverged": [{"sweep": i, "chain": c, "dH": float(dH[i, c]),
                              "accepted": bool(acc[i, c])}
                             for i, c in bad]})
            return states, res
        return step

    cell = load_cell(F8_CELL)
    run = run_cell(cell, F8_SEED, seconds, False, dev, wrap_seg=watch)
    diverged = [dict(d, call=i) for i, c in enumerate(calls)
                for d in c["diverged"]]
    guard = {n: sum(c["guard"][n] for c in calls) for n in ph_eigh.GUARD}
    end = run.periods[-1]
    finite = all(bool(torch.isfinite(x).all()) for x in (*end.end,
                                                         end.evals))
    emit({"phase": "anchor.diverged_chain", "cell": F8_CELL,
          "seed": F8_SEED, "guard": guard, "diverged": diverged,
          "calls": [{k: c[k] for k in ("sweeps", "seconds", "guard")}
                    for c in calls],
          "setup_s": run.setup_s, "window_s": run.window_s,
          "periods": len(run.periods), "attempted": run.attempted,
          "accepted": run.accepted, "failed": run.failed,
          "peak_gib": run.peak_bytes and run.peak_bytes / 2**30,
          "final_state_finite": finite,
          "gpu": power})
    check(all(not d["accepted"] for d in diverged),
          f"anchor.diverged_chain: a diverged trajectory was accepted: "
          f"{diverged}")
    check(finite, "anchor.diverged_chain: the final state is not finite")
    return guard


# --- the scan entry point -----------------------------------------------------

#: the production scan's settings (examples/T_scan_full_24x24/scan_config.json
#: and the RunConfig defaults), cut to a fixed schedule of a few sweeps
SCAN = dict(Lx=L_MAIN, Ly=L_MAIN, t=1.0, tp=-0.35, mu=-1.08, W=1.0,
            n_imp=0.05, J=0.8, mass=1.0, dtype="float32", path="real",
            eigh_mode="tracked", exact_solver="ph", anchor_every=1,
            Nt_therm_init=20, Nt_measure=6, anneal_stages=1, anneal_sweeps=1,
            n_therm=5, meas_probe_sweeps=2, n_measure=4,
            measure_transport_freq=1, bin_size=2, checkpoint_freq=2,
            Nt_escalate=False, verbose=False)


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


def _csv_rows(path: str) -> tuple[str, np.ndarray]:
    """(header, rows as floats) of a CSV the drivers write."""
    lines = _read(path).splitlines()
    return lines[0], np.array([[float(x) for x in ln.split(",")]
                               for ln in lines[1:]])


def _check_csvs(d: str, C: int, n_rows: int) -> int:
    """Header, row count and finite values of one point's CSVs.  A dH may
    be non-finite only on a rejected sweep (a diverged proposal, zeroed and
    rejected, as in the JAX package); returns how many such rows there
    are."""
    from dwavehmc_tpu_torch.utils.io import OBS_HEADER, TRANS_HEADER

    diverged = 0
    for name, header in (("observables.csv", OBS_HEADER),
                         ("transport.csv", TRANS_HEADER)):
        if C > 1:
            header = "Sweep,Chain," + header.split(",", 1)[1]
        got, vals = _csv_rows(os.path.join(d, name))
        check(got == header, f"{d}/{name}: header {got!r}")
        check(len(vals) == n_rows * C, f"{d}/{name}: "
              f"{len(vals)} rows, expected {n_rows * C}")
        ok = np.isfinite(vals)
        if name == "observables.csv":
            i_acc, i_dH = header.split(",").index("Accepted"), \
                header.split(",").index("dH")
            bad_dH = ~ok[:, i_dH]
            check(not bool((bad_dH & (vals[:, i_acc] != 0)).any()),
                  f"{d}/{name}: an accepted sweep has a non-finite dH")
            diverged += int(bad_dH.sum())
            ok[:, i_dH] = True
        check(bool(ok.all()), f"{d}/{name}: non-finite value")
    return diverged


def _scan_run(cfg, dev, values):
    from dwavehmc_tpu_torch.drivers.scan import run_scan_vectorized
    from dwavehmc_tpu_torch.ops import kernels, ph_eigh

    kernels.reset_launches()
    ph_eigh.reset_guard()
    t0 = time.perf_counter()
    out = run_scan_vectorized(cfg, values, scan_param="T", replicas=1,
                              device=dev)
    torch.cuda.synchronize()
    return out, dict(kernels.LAUNCHES), time.perf_counter() - t0


def _stage_rates(out, chains: int) -> dict:
    return {k: chains * out["stage_sweeps"][k] / sec
            for k, sec in out["stage_seconds"].items()
            if out["stage_sweeps"][k] and sec > 0}


def scan_phases(dev, power: str) -> tuple[dict, dict]:
    """``run_scan_vectorized`` at the production width into build/, then a
    resume to six measurement sweeps; then the untracked exact sweep at
    12×12.  Kernel counts are zeroed just before each run and read just
    after it.  Returns the launches and the first run's result."""
    import shutil

    from dwavehmc_tpu_torch.utils.config import RunConfig
    from dwavehmc_tpu_torch.utils.io import SpectraBinStore

    root = os.path.join(REPO, "build", "scan_smoke")
    shutil.rmtree(root, ignore_errors=True)
    cfg = RunConfig(**SCAN, out_dir=os.path.join(root, "tracked"))
    values = TEMPS
    out, launches, sec = _scan_run(cfg, dev, values)
    # every sweep exactly anchored (K = 1): anneal and therm at
    # Nt_therm_init, probe and measurement at Nt_measure
    nt_a, nt_m = cfg.Nt_therm_init, cfg.Nt_measure
    k1_want = (expected_rotations(cfg.anneal_stages * cfg.anneal_sweeps
                                  + cfg.n_therm, 1, nt_a)
               + expected_rotations(cfg.meas_probe_sweeps + cfg.n_measure,
                                    1, nt_m))
    health = json.loads(_read(os.path.join(cfg.out_dir,
                                           "therm_health.json")))
    acc = [h["measurement"]["mean_acc"] for h in health.values()]
    pre, diverged = {}, 0
    for d in out["dirs"]:
        diverged += _check_csvs(d, 1, cfg.n_measure)
        for name in ("observables.csv", "transport.csv"):
            pre[(d, name)] = _read(os.path.join(d, name))
    emit({"phase": "scan.vectorized", "lattice": [cfg.Lx, cfg.Ly],
          "T": values.tolist(), "seconds": sec,
          "stage_seconds": out["stage_seconds"],
          "stage_sweeps": out["stage_sweeps"],
          "traj_per_s": _stage_rates(out, len(values)),
          "measurement_acceptance": float(np.mean(acc)),
          "acceptance_by_point": acc, "rejected_nonfinite_dH": diverged,
          "launches": launches, "k1_expected": k1_want,
          "ph_guard": out["ph_guard"], "gpu": power})
    check(launches["rotation_s_parts"] == k1_want,
          f"scan: {launches['rotation_s_parts']} K1 launches, the schedule "
          f"implies {k1_want}")
    check(launches["weighted_lorentzian_sum"] == 2 * cfg.n_measure,
          f"scan: {launches['weighted_lorentzian_sum']} K2 launches, "
          f"expected 2 per transport pass")
    check(set(health) == {f"T_{v:.6g}" for v in values},
          "therm_health.json lacks a point")

    cfg2 = dataclasses.replace(cfg, n_measure=6, resume=True)
    out2, launches2, sec2 = _scan_run(cfg2, dev, values)
    k1_want2 = expected_rotations(2, 1, nt_m)
    for d in out2["dirs"]:
        _check_csvs(d, 1, cfg2.n_measure)
        for name in ("observables.csv", "transport.csv"):
            check(_read(os.path.join(d, name)).startswith(pre[(d, name)]),
                  f"resume rewrote the earlier rows of {d}/{name}")
        _, bins = SpectraBinStore.load_bins(os.path.join(
            d, "spectra_bins.npz"))
        check(sorted(bins) == [2, 4, 6], f"{d}: bins {sorted(bins)}")
        check(all(bool(np.isfinite(a).all()) for b in bins.values()
                  for a in b.values()), f"{d}: non-finite spectra")
    emit({"phase": "scan.vectorized.resume", "seconds": sec2,
          "stage_seconds": out2["stage_seconds"],
          "stage_sweeps": out2["stage_sweeps"], "launches": launches2,
          "k1_expected": k1_want2, "ph_guard": out2["ph_guard"],
          "gpu": power})
    check(launches2["rotation_s_parts"] == k1_want2,
          f"resume: {launches2['rotation_s_parts']} K1 launches, expected "
          f"{k1_want2}")
    check(launches2["weighted_lorentzian_sum"] == 4,
          f"resume: {launches2['weighted_lorentzian_sum']} K2 launches")

    cfg3 = RunConfig(**dict(SCAN, Lx=12, Ly=12, eigh_mode="exact",
                            anneal_stages=0, n_therm=2, n_measure=2,
                            meas_probe_sweeps=0, checkpoint_freq=0),
                     out_dir=os.path.join(root, "exact"))
    out3, launches3, sec3 = _scan_run(cfg3, dev, TEMPS[[2, 5]])
    emit({"phase": "scan.exact_mode", "lattice": [12, 12], "seconds": sec3,
          "stage_seconds": out3["stage_seconds"], "launches": launches3,
          "ph_guard": out3["ph_guard"], "gpu": power})
    for d in out3["dirs"]:
        _check_csvs(d, 1, cfg3.n_measure)
    check(launches3["rotation_s_parts"] == 0, "exact mode launched K1")
    check(launches3["weighted_lorentzian_sum"] == 2 * cfg3.n_measure,
          f"exact mode: {launches3['weighted_lorentzian_sum']} K2 launches")
    return {name: launches[name] + launches2[name] + launches3[name]
            for name in launches}, dict(out, seconds=sec, k1_expected=k1_want)


# --- the scan sharded over ranks ----------------------------------------------

def ranks_for_sharding() -> int:
    """W of the sharded phases: one rank per card, at least 2 (ranks share
    a card when there are fewer) and at most 4."""
    return min(4, max(2, torch.cuda.device_count()))


def torchrun(module: str, argv: list, nproc: int, timeout: float,
             log_path: str) -> float:
    """``python -m torch.distributed.run --standalone --nproc_per_node
    nproc -m module argv`` from the checkout, its output to ``log_path``.
    Wall seconds; the launcher and its ranks are one process group, killed
    if they outlast ``timeout`` or this script fails while they run."""
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 1) // nproc)))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), "-m", module, *argv]
    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            pass
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    seconds = time.perf_counter() - t0
    tail = _read(log_path)[-3000:]
    check(seconds < timeout, f"{module} under {nproc} ranks did not finish "
          f"in {timeout} s:\n{tail}")
    check(proc.returncode == 0, f"{module} under {nproc} ranks exited "
          f"{proc.returncode}:\n{tail}")
    return seconds


def _cli(fields: dict) -> list:
    """``RunConfig`` fields as the entry points' flags."""
    return [a for k, v in fields.items() for a in (f"--{k}", str(v))]


def _scan_log(root: str) -> list:
    """scan.log's lines, without their time stamps."""
    return [ln.split("] ", 1)[1] for ln in _read(
        os.path.join(root, "scan.log")).splitlines()]


def _log_line(lines: list, prefix: str) -> str:
    got = [ln for ln in lines if ln.startswith(prefix)]
    check(bool(got), f"scan.log has no line '{prefix}…'")
    return got[0][len(prefix):]


def _log_stages(lines: list) -> tuple[dict, dict]:
    """(stage seconds, stage sweeps) of the "Stage seconds:" line."""
    seconds, sweeps = {}, {}
    for name, sec, n in re.findall(r"(\w+) ([0-9.]+) \((\d+) sweep",
                                   _log_line(lines, "Stage seconds: ")):
        seconds[name], sweeps[name] = float(sec), int(n)
    return seconds, sweeps


def _rel_errors(a: np.ndarray, b: np.ndarray) -> float:
    """max |a − b| / max |a| (0 for two empty or all-zero arrays)."""
    scale = float(np.max(np.abs(a))) if a.size else 0.0
    return float(np.max(np.abs(a - b))) / scale if scale > 0 else \
        float(np.max(np.abs(a - b), initial=0.0))


def compare_scans(a: str, b: str, rtol: float) -> dict:
    """Largest relative differences between two scan roots: every CSV (the
    accept column must be equal; a value may differ by ``rtol`` relative or
    by one unit of its sixth printed digit), every spectra bin and the
    checkpoint's arrays (max difference over max magnitude), and the
    health file's numbers."""
    from dwavehmc_tpu_torch.utils.io import SpectraBinStore

    worst = {"csv": 0.0, "bins": 0.0, "checkpoint": 0.0, "health": 0.0}
    names = sorted(os.listdir(a))
    check(names == sorted(os.listdir(b)), f"{a} and {b} hold other files")
    for d in (n for n in names if os.path.isdir(os.path.join(a, n))):
        for name in ("observables.csv", "transport.csv"):
            ha, va = _csv_rows(os.path.join(a, d, name))
            hb, vb = _csv_rows(os.path.join(b, d, name))
            check(ha == hb and va.shape == vb.shape, f"{d}/{name}: shape")
            cols = ha.split(",")
            if "Accepted" in cols:
                i = cols.index("Accepted")
                check(bool((va[:, i] == vb[:, i]).all()),
                      f"{d}/{name}: accept columns differ")
            diff = np.abs(va - vb)
            unit = 10.0 ** (np.floor(np.log10(np.maximum(np.abs(va),
                                                         1e-300))) - 5)
            check(bool((diff <= np.maximum(rtol * np.abs(va),
                                           1.0001 * unit)).all()),
                  f"{d}/{name}: values differ beyond {rtol}")
            with np.errstate(divide="ignore", invalid="ignore"):
                rel = np.where(diff > 0, diff / np.abs(va), 0.0)
            worst["csv"] = max(worst["csv"], float(rel.max()))
        _, ba = SpectraBinStore.load_bins(os.path.join(a, d,
                                                       "spectra_bins.npz"))
        _, bb = SpectraBinStore.load_bins(os.path.join(b, d,
                                                       "spectra_bins.npz"))
        check(sorted(ba) == sorted(bb), f"{d}: bins differ")
        for i in ba:
            for k in ba[i]:
                worst["bins"] = max(worst["bins"], _rel_errors(
                    np.asarray(ba[i][k], float), np.asarray(bb[i][k], float)))
    with np.load(os.path.join(a, "scan_checkpoint.npz")) as za, \
            np.load(os.path.join(b, "scan_checkpoint.npz")) as zb:
        for k in ("delta", "pi", "disorder", "sweep_idx", "extra_dt_m"):
            worst["checkpoint"] = max(worst["checkpoint"],
                                      _rel_errors(za[k], zb[k]))
    ha = json.loads(_read(os.path.join(a, "therm_health.json")))
    hb = json.loads(_read(os.path.join(b, "therm_health.json")))

    def walk(x, y):
        if isinstance(x, dict):
            check(x.keys() == y.keys(), "therm_health.json keys differ")
            for k in x:
                walk(x[k], y[k])
        elif isinstance(x, (int, float)) and x is not None:
            worst["health"] = max(worst["health"], abs(x - y) / max(
                abs(x), 1e-300) if x != y else 0.0)
        else:
            check(x == y, "therm_health.json values differ")

    walk(ha, hb)
    for k, v in worst.items():
        check(v <= rtol or k == "csv", f"{k} differ by {v} > {rtol}")
    return worst


#: the equality run: 6×6 float64, 3 points (padded to a multiple of W), the
#: tracked path with the guarded PH anchor, Nt buckets after the probe
#: window (n_therm = 7), a measurement probe, checkpoints
EQUAL_ARGS = ["--Lx", "6", "--Ly", "6", "--dtype",
              "float64", "--path", "real", "--eigh_mode", "tracked",
              "--exact_solver", "ph", "--n_T", "3", "--T_min", "0.01",
              "--T_max", "1", "--replicas", "1", "--n_therm", "7",
              "--n_measure", "4", "--Nt_therm_init", "10", "--Nt_measure",
              "6", "--anneal_stages", "0", "--meas_probe_sweeps", "2",
              "--bin_size", "2", "--checkpoint_freq", "2", "--verbose",
              "false", "--no-summarize"]


def scan_sharded_equal_phase(dev, power: str, W: int) -> None:
    """The same 6×6 float64 scan in one process and under W ranks."""
    import shutil

    from dwavehmc_tpu_torch.drivers import batch_scan_T

    root = os.path.join(REPO, "build", "scan_smoke", "sharded_equal")
    shutil.rmtree(root, ignore_errors=True)
    one, many = os.path.join(root, "one"), os.path.join(root, "ranks")
    argv = EQUAL_ARGS + ["--device", dev.type]
    _, _, sec1 = _counted(lambda: batch_scan_T.main(
        argv + ["--out_dir", one]))
    secW = torchrun("dwavehmc_tpu_torch.drivers.batch_scan_T",
                    argv + ["--out_dir", many], W, 300,
                    os.path.join(root, "launcher.log"))
    worst = compare_scans(one, many, 1e-6)
    lines = _scan_log(many)
    pad = (-3) % W
    emit({"phase": "scan.sharded.equal", "lattice": [6, 6],
          "dtype": "float64", "chains": 3, "ranks": W, "padded": pad,
          "rank_map": _log_line(lines, "Vectorized T-scan: "),
          "seconds_one_process": sec1, "seconds_ranks": secW,
          "max_rel_diff": worst, "rtol": 1e-6, "gpu": power})
    if pad:
        check(any(f"Padding ensemble with {pad} throwaway chain(s)" in ln
                  for ln in lines), "scan.sharded.equal: no padding line")


def _mean_acceptance(root: str) -> float:
    health = json.loads(_read(os.path.join(root, "therm_health.json")))
    return float(np.mean([h["measurement"]["mean_acc"]
                          for h in health.values()]))


def scan_agreement(a: str, b: str) -> dict:
    """How far two scan roots of the same chains agree, without a limit:
    whether every point's CSVs are byte-equal, how many accept decisions
    agree, and the largest relative CSV difference (a value non-finite in
    both counts as equal)."""
    same, agree, total, worst = True, 0, 0, 0.0
    for d in sorted(n for n in os.listdir(a)
                    if os.path.isdir(os.path.join(a, n))):
        for name in ("observables.csv", "transport.csv"):
            pa, pb = os.path.join(a, d, name), os.path.join(b, d, name)
            same = same and _read(pa) == _read(pb)
            ha, va = _csv_rows(pa)
            _, vb = _csv_rows(pb)
            if "Accepted" in ha:
                i = ha.split(",").index("Accepted")
                agree += int((va[:, i] == vb[:, i]).sum())
                total += len(va)
            equal = (va == vb) | (np.isnan(va) & np.isnan(vb))
            with np.errstate(divide="ignore", invalid="ignore"):
                rel = np.abs(va - vb) / np.abs(va)
            worst = max(worst, float(np.nanmax(np.where(equal, 0.0, rel))))
    return {"csv_byte_equal": same, "accept_agree": [agree, total],
            "max_rel_csv": worst}


def batch_rounding_witness(dev, W: int) -> dict:
    """One anchored tracked sweep of the main path's 8 chains (Nt = 20 and
    the scan's rotation settings; the qdwh anchor, so that no guard
    decides) from one state with one set of draws: as one batch, again as
    one batch, and as the W ranks' blocks.  Largest |difference| of the new
    Δ and of dH against the first run, and whether the accepts agree."""
    from dwavehmc_tpu_torch.models.params import ModelParams
    from dwavehmc_tpu_torch.parallel.ensemble import (
        init_ensemble_real, run_segment_tracked)
    from dwavehmc_tpu_torch.sampler.hmc import draw_momenta
    from dwavehmc_tpu_torch.utils.config import RunConfig

    cfg = RunConfig(**SCAN)
    lat, _, _, params, dt = main_config(dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    s0 = init_ensemble_real(lat, params, gen, N_CHAINS, n_imp=PHYS["n_imp"],
                            device=dev)
    normals, uniforms = draw_momenta(gen, (N_CHAINS, 2, lat.n_sites, 2),
                                     torch.float32, dev)

    def sweep(blocks):
        out = []
        for rows in blocks:
            i = torch.as_tensor(rows, device=dev)
            p = ModelParams(*(x[i] if x.ndim else x for x in params))
            s, seg = run_segment_tracked(
                lat, p, type(s0)(*(x[i] for x in s0)), 1, NT, dt[i], False,
                cfg.tracked_iters, 1, ns_steps=cfg.resolved_ns_steps(),
                rot_dtype=cfg.rot_torch_dtype(), rot_scheme=cfg.rot_scheme,
                normals=normals[i][None], uniforms=uniforms[i][None])
            out.append((torch.stack([s.delta_re, s.delta_im], -1),
                        seg.dH[0], seg.accepted[0]))
        return [torch.cat(xs) for xs in zip(*out)]

    one = sweep([np.arange(N_CHAINS)])
    per = N_CHAINS // W
    got = {"batch_again": sweep([np.arange(N_CHAINS)]),
           f"{W}_blocks_of_{per}": sweep([np.arange(r * per, (r + 1) * per)
                                          for r in range(W)])}
    return {k: {"max_abs_delta": float((v[0] - one[0]).abs().max()),
                "max_abs_dH": float((v[1] - one[1]).abs().max()),
                "accepts_agree": bool(torch.equal(v[2], one[2]))}
            for k, v in got.items()}


def scan_sharded_phase(dev, power: str, W: int, vec: dict) -> dict:
    """``batch_scan_T`` at the production width and temperatures of
    ``scan.vectorized``, in this process and under W ranks with the same
    arguments, and how far the two runs agree; the batch-rounding witness.
    Returns the launches summed over the ranks."""
    import shutil

    from dwavehmc_tpu_torch.drivers import batch_scan_T
    from dwavehmc_tpu_torch.drivers.postprocess import batch_process_spectra

    base = os.path.join(REPO, "build", "scan_smoke")
    root, one = (os.path.join(base, "sharded"),
                 os.path.join(base, "sharded_one"))
    for d in (root, one):
        shutil.rmtree(d, ignore_errors=True)
    argv = _cli(SCAN) + ["--device", dev.type, "--n_T", str(len(TEMPS)),
                        "--T_min", repr(float(TEMPS[0])), "--T_max",
                        repr(float(TEMPS[-1])), "--replicas", "1"]
    batch_scan_T.main(argv + ["--out_dir", one])
    torch.cuda.empty_cache()
    sec = torchrun("dwavehmc_tpu_torch.drivers.batch_scan_T",
                   argv + ["--out_dir", root], W, 600,
                   os.path.join(base, "sharded_launcher.log"))
    lines = _scan_log(root)
    one_lines = _scan_log(one)
    vec_lines = _scan_log(os.path.join(base, "tracked"))
    init = _log_line(lines, "Initial ensemble: ")
    check(init == _log_line(vec_lines, "Initial ensemble: "),
          "scan.sharded: the initial disorder and Δ differ from "
          "scan.vectorized's")
    ranks = json.loads(_log_line(lines, "Ranks: "))
    check(len(ranks) == W, f"scan.sharded: {len(ranks)} ranks reported")
    n_m = SCAN["n_measure"]
    for r in ranks:
        k1, k2 = (r["launches"]["rotation_s_parts"],
                  r["launches"]["weighted_lorentzian_sum"])
        check(k1 == vec["k1_expected"], f"scan.sharded rank {r['rank']}: "
              f"{k1} K1 launches, the schedule implies {vec['k1_expected']}")
        check(k2 == 2 * n_m, f"scan.sharded rank {r['rank']}: {k2} K2 "
              f"launches, expected 2 per transport pass")
        check({k: r["ph_guard"][k] for k in ("solves", "fallbacks")}
              == {k: ranks[0]["ph_guard"][k] for k in ("solves",
                                                       "fallbacks")},
              "scan.sharded: the guard decided differently on two ranks")
    diverged = 0
    for v in TEMPS:
        diverged += _check_csvs(os.path.join(root, f"T_{v:.6g}"), 1, n_m)
    res = batch_process_spectra(root, "T_*")
    check(not res["failed"] and len(res["processed"]) == len(TEMPS),
          f"scan.sharded: post-processing failed on {res['failed']}")
    check(os.path.exists(os.path.join(root, "summary_all.csv")),
          "scan.sharded: no summary_all.csv")
    seconds, sweeps = _log_stages(lines)
    seconds1, _ = _log_stages(one_lines)
    chains = len(TEMPS)
    coll = [r["collective_seconds"] for r in ranks]

    def rates(sec_by_stage):
        return {k: chains * sweeps[k] / t for k, t in sec_by_stage.items()
                if sweeps[k] and t > 0}

    emit({"phase": "scan.sharded", "lattice": [L_MAIN, L_MAIN],
          "T": TEMPS.tolist(), "ranks": W,
          "rank_map": _log_line(lines, "Vectorized T-scan: "),
          "launcher_seconds": sec, "stage_seconds": seconds,
          "stage_sweeps": sweeps, "traj_per_s": rates(seconds),
          "measurement_acceptance": _mean_acceptance(root),
          "one_process_same_argv": {
              "stage_seconds": seconds1, "traj_per_s": rates(seconds1),
              "measurement_acceptance": _mean_acceptance(one),
              "ph_guard": json.loads(_log_line(one_lines,
                                               "Ranks: "))[0]["ph_guard"],
              "initial_ensemble_equal": _log_line(
                  one_lines, "Initial ensemble: ") == init,
              # scan.vectorized's root was resumed past these rows
              "csv_rows_equal_to_scan_vectorized": all(
                  _read(os.path.join(base, "tracked", d, n)).startswith(
                      _read(os.path.join(one, d, n)))
                  for d in os.listdir(one)
                  if os.path.isdir(os.path.join(one, d))
                  for n in ("observables.csv", "transport.csv"))},
          "ranks_vs_one_process": scan_agreement(one, root),
          "batch_rounding_witness": batch_rounding_witness(dev, W),
          "collective_seconds_by_rank": coll,
          "collective_share": max(coll) / sum(seconds.values()),
          "host_readout": "none: this configuration reads out on the card",
          "rejected_nonfinite_dH": diverged, "initial_ensemble": init,
          "launches_by_rank": [r["launches"] for r in ranks],
          "ph_guard_by_rank": [r["ph_guard"] for r in ranks],
          "gpu": power})
    return {k: sum(r["launches"][k] for r in ranks)
            for k in ranks[0]["launches"]}


def scan_beta_phase(dev, power: str, W: int) -> dict:
    """``batch_scan_beta`` at its 12×12 default width under W ranks, cut to
    2 β points (0.01 and 100), 2 therm and 2 measurement sweeps."""
    import shutil

    root = os.path.join(REPO, "build", "scan_smoke", "beta")
    shutil.rmtree(root, ignore_errors=True)
    argv = ["--device", dev.type, "--n_beta", "2", "--beta_min", "0.01",
            "--beta_max", "100", "--n_therm", "2", "--n_measure", "2",
            "--meas_probe_sweeps", "0", "--bin_size", "1",
            "--checkpoint_freq", "0", "--verbose", "false",
            "--out_dir", root]
    sec = torchrun("dwavehmc_tpu_torch.drivers.batch_scan_beta", argv, W,
                   300, os.path.join(REPO, "build", "scan_smoke",
                                     "beta_launcher.log"))
    lines = _scan_log(root)
    ranks = json.loads(_log_line(lines, "Ranks: "))
    for v in (0.01, 100.0):
        _check_csvs(os.path.join(root, f"beta_{v:.6g}"), 1, 2)
    summary = _read(os.path.join(root, "summary_all.csv")).splitlines()
    check(len(summary) == 3, "scan.beta: summary_all.csv lacks a point")
    for r in ranks:
        check(r["launches"]["weighted_lorentzian_sum"] == 4,
              f"scan.beta rank {r['rank']}: "
              f"{r['launches']['weighted_lorentzian_sum']} K2 launches, "
              f"expected 2 per transport pass")
    seconds, sweeps = _log_stages(lines)
    emit({"phase": "scan.beta", "lattice": [12, 12], "beta": [0.01, 100.0],
          "ranks": W, "rank_map": _log_line(lines, "Vectorized beta-scan: "),
          "launcher_seconds": sec, "stage_seconds": seconds,
          "stage_sweeps": sweeps,
          "launches_by_rank": [r["launches"] for r in ranks], "gpu": power})
    return {k: sum(r["launches"][k] for r in ranks)
            for k in ranks[0]["launches"]}


# --- the complex path and the host readout -----------------------------------

def _counted(fn):
    """(fn(), kernel launches during the call, wall seconds), the counts
    reset just before and read just after."""
    from dwavehmc_tpu_torch.ops import kernels

    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(kernels.LAUNCHES), time.perf_counter() - t0


#: the complex path's run: the production width and couplings (the
#: RunConfig defaults: β = 10, the spectral grid η = 8/N), 8 chains, a short
#: fixed schedule at the production thermalization's Nt = 20 (at Nt = 6 a
#: cold start's ΔH is ≈ 15 at this width, and nothing is accepted)
SIM = dict(Lx=L_MAIN, Ly=L_MAIN, **PHYS, dtype="float32", path="complex",
           n_chains=N_CHAINS, n_therm=2, n_measure=2, Nt_therm_init=NT,
           Nt_measure=NT, measure_transport_freq=1, bin_size=1,
           checkpoint_freq=0, verbose=False)


def simulation_complex_phase(dev, power: str) -> dict:
    """``run_simulation`` on the complex path at 24×24: every leapfrog step
    one complex Hermitian eigh of (8, 1152, 1152), a transport pass per
    measurement sweep (two K2 launches each), no K1."""
    from dwavehmc_tpu_torch.drivers.simulation import run_simulation
    from dwavehmc_tpu_torch.utils.config import RunConfig

    cfg = RunConfig(**SIM, out_dir=os.path.join(REPO, "build", "sim_smoke",
                                                "complex"))
    out, launches, sec = _counted(lambda: run_simulation(cfg, device=dev))
    spans = out["measure_seconds"]
    n_pass = cfg.n_measure // cfg.measure_transport_freq
    _, rows = _csv_rows(os.path.join(cfg.out_dir, "observables.csv"))
    emit({"phase": "simulation.complex", "lattice": [cfg.Lx, cfg.Ly],
          "chains": cfg.n_chains, "beta": cfg.beta, "Nt": cfg.Nt_measure,
          "seconds": sec, "therm_seconds": out["therm_seconds"],
          "measure_seconds": spans,
          "traj_per_s_therm": cfg.n_chains * cfg.n_therm
          / out["therm_seconds"],
          "traj_per_s_measure": cfg.n_chains * cfg.n_measure / spans["hmc"],
          "transport_seconds_per_pass": spans["transport"] / n_pass,
          "acceptance": out["acceptance"],
          "dH_median": float(np.median(rows[:, 3])),
          "dH_min_max": [float(rows[:, 3].min()), float(rows[:, 3].max())],
          "launches": launches, "gpu": power})
    _check_csvs(cfg.out_dir, cfg.n_chains, cfg.n_measure)
    check(launches["weighted_lorentzian_sum"] == 2 * n_pass,
          f"simulation.complex: {launches['weighted_lorentzian_sum']} K2 "
          f"launches, expected {2 * n_pass}")
    check(launches["rotation_s_parts"] == 0,
          "simulation.complex launched K1")
    return launches


def reference_complex_phase(dev, seed: int) -> None:
    """One complex trajectory and a transport pass at 6×6 on the card
    (float32/complex64, K2) against the same on the CPU (float64, plain
    versions); and the card's complex64 ``eigh`` eigenvalue error by
    dimension, raw and through ``symmetric_eigh``'s switch, beside the
    CPU's complex64 error."""
    from dwavehmc_tpu_torch.models.bdg import assemble_bdg, static_hamiltonian
    from dwavehmc_tpu_torch.models.bdg_real import symmetric_eigh
    from dwavehmc_tpu_torch.models.lattice import LatticeSpec
    from dwavehmc_tpu_torch.models.params import make_params
    from dwavehmc_tpu_torch.parallel.ensemble import (
        ensemble_transport,
        init_ensemble,
        run_segment,
    )
    from dwavehmc_tpu_torch.sampler.hmc import calc_optimal_dt

    lat = LatticeSpec(6, 6)
    spec = production_spec(lat)
    betas = [10.0, 50.0]
    g = torch.Generator().manual_seed(seed)
    p64 = make_params(beta=betas, dtype=torch.float64, device="cpu", **PHYS)
    s64 = init_ensemble(lat, p64, g, 2, dtype=torch.float64,
                        n_imp=PHYS["n_imp"], device="cpu")
    p32 = make_params(beta=betas, dtype=torch.float32, device=dev, **PHYS)
    s32 = type(s64)(*(x.to(dev, torch.complex64 if x.is_complex()
                           else torch.float32) for x in s64))
    normals = torch.randn((1, 2, 2, lat.n_sites, 2), generator=g,
                          dtype=torch.float64)
    uniforms = torch.rand((1, 2), generator=g)
    dt = [calc_optimal_dt(b, PHYS["J"], PHYS["mass"], 6) for b in betas]
    tr64 = ensemble_transport(lat, spec, p64, s64)
    tr32 = ensemble_transport(lat, spec, p32, s32)
    rel = {name: float((getattr(tr32, name).double().cpu()
                        - getattr(tr64, name)).norm()
                       / getattr(tr64, name).norm())
           for name in tr64._fields}
    _, seg64 = run_segment(lat, p64, s64, 1, 6,
                           torch.tensor(dt, dtype=torch.float64),
                           normals=normals, uniforms=uniforms)
    _, seg32 = run_segment(lat, p32, s32, 1, 6, torch.tensor(dt, device=dev),
                           normals=normals, uniforms=uniforms)
    dH64, dH32 = seg64.dH[0], seg32.dH[0].double().cpu()

    eigh_err = {}
    p = make_params(dtype=torch.float64, device="cpu", **PHYS)
    for L in (6, 12, 16, 24):
        lt = LatticeSpec(L, L)
        dis = (torch.rand(1, lt.n_sites, generator=g, dtype=torch.float64)
               < PHYS["n_imp"]).double()
        d = 0.1 * (torch.rand(1, lt.n_sites, 2, generator=g,
                              dtype=torch.complex128) - (0.5 + 0.5j))
        H = assemble_bdg(lt, static_hamiltonian(lt, p.t, p.tp, p.mu, dis), d)
        want = torch.linalg.eigvalsh(H)
        H32 = H.to(torch.complex64)

        def err(w):
            return float((w.double().cpu() - want).abs().max())

        eigh_err[2 * lt.n_sites] = {
            "cpu_c64": err(torch.linalg.eigvalsh(H32)),
            "card_c64_raw": err(torch.linalg.eigvalsh(H32.to(dev))),
            "card_symmetric_eigh": err(symmetric_eigh(H32.to(dev))[0])}
    emit({"phase": "reference.6x6.complex", "transport_rel_l2": rel,
          "dH_cpu_f64": dH64.tolist(), "dH_gpu_f32": dH32.tolist(),
          "eigh_complex64_err_by_dim": eigh_err})
    for name, r in rel.items():
        check(r <= 1e-3, f"reference complex {name}: rel L2 {r} > 1e-3")
    check(bool(((dH32 - dH64).abs() <= 1e-2 + 1e-3 * dH64.abs()).all()),
          f"reference complex dH: card {dH32.tolist()} vs CPU "
          f"{dH64.tolist()}")
    for dim, e in eigh_err.items():
        check(e["card_symmetric_eigh"] <= max(2.0 * e["cpu_c64"], 2e-5),
              f"complex eigh at dimension {dim}: {e}")


def _cold_host_config(root: str):
    """(RunConfig, T values, replicas) of the cold end of the production T
    grid with the host readout, cut to its first and last point × 2
    replicas, 1 anneal stage of 1 sweep, the probe window of therm and 2
    measurement sweeps."""
    from dwavehmc_tpu_torch.utils.config import RunConfig

    saved = json.loads(_read(os.path.join(
        REPO, "examples", "T_scan_cold_host_24x24", "scan_config.json")))
    grid = saved.pop("values")
    values = [grid[0], grid[-1]]
    for k in ("scan_param", "replicas"):
        saved.pop(k)
    saved.update(anneal_stages=1, anneal_sweeps=1, n_therm=5,
                 meas_probe_sweeps=0, n_measure=2, checkpoint_freq=0,
                 resume=False, verbose=False, out_dir=root)
    return RunConfig(**saved), values, 2


def scan_host_readout_phase(dev, power: str) -> dict:
    """``run_scan_vectorized`` with ``metropolis_readout="host"`` at 24×24:
    the tracked leapfrog and the exact anchor on the card, each sweep's ΔH
    from complex128 ``eigvalsh`` on the host (timed here by wrapping
    ``ops/host_energy.potential_batch_np``)."""
    from dwavehmc_tpu_torch.drivers.scan import run_scan_vectorized
    from dwavehmc_tpu_torch.ops import host_energy

    cfg, values, C = _cold_host_config(os.path.join(REPO, "build",
                                                    "scan_smoke", "host"))
    cfg.validate()
    host = {"calls": 0, "seconds": 0.0}
    inner = host_energy.potential_batch_np

    def timed_potentials(*a, **k):
        t0 = time.perf_counter()
        try:
            return inner(*a, **k)
        finally:
            host["calls"] += 1
            host["seconds"] += time.perf_counter() - t0

    host_energy.potential_batch_np = timed_potentials
    try:
        out, launches, sec = _counted(lambda: run_scan_vectorized(
            cfg, values, scan_param="T", replicas=C, device=dev))
    finally:
        host_energy.potential_batch_np = inner
    n_sweeps = cfg.anneal_sweeps * cfg.anneal_stages + cfg.n_therm \
        + cfg.n_measure
    k1_want = (expected_rotations(n_sweeps - cfg.n_measure, 1,
                                  cfg.Nt_therm_init)
               + expected_rotations(cfg.n_measure, 1, cfg.Nt_measure))
    swept = sum(out["stage_seconds"][k] for k in ("anneal", "therm",
                                                  "measure"))
    health = json.loads(_read(os.path.join(cfg.out_dir,
                                           "therm_health.json")))
    acc = [h["measurement"]["mean_acc"] for h in health.values()]
    diverged = sum(_check_csvs(d, C, cfg.n_measure) for d in out["dirs"])
    emit({"phase": "scan.host_readout", "lattice": [cfg.Lx, cfg.Ly],
          "T": values, "replicas": C, "chains": out["chains"],
          "exact_solver": cfg.exact_solver, "seconds": sec,
          "stage_seconds": out["stage_seconds"],
          "stage_sweeps": out["stage_sweeps"],
          "sweep_seconds": swept / n_sweeps,
          "host_readout_calls": host["calls"],
          "host_readout_seconds": host["seconds"],
          "host_readout_seconds_per_call": host["seconds"] / host["calls"],
          "device_seconds_per_sweep": (swept - host["seconds"]) / n_sweeps,
          "measurement_acceptance": float(np.mean(acc)),
          "acceptance_by_point": acc, "rejected_nonfinite_dH": diverged,
          "launches": launches, "k1_expected": k1_want, "gpu": power})
    check(host["calls"] >= n_sweeps, f"scan.host_readout: {host['calls']} "
          f"host readouts for {n_sweeps} sweeps")
    check(launches["rotation_s_parts"] == k1_want,
          f"scan.host_readout: {launches['rotation_s_parts']} K1 launches, "
          f"the schedule implies {k1_want}")
    check(launches["weighted_lorentzian_sum"] == 2 * cfg.n_measure,
          f"scan.host_readout: {launches['weighted_lorentzian_sum']} K2 "
          f"launches, expected 2 per transport pass")
    return launches


def scan_serial_phase(dev, power: str) -> dict:
    """``batch_scan_T --mode serial`` on the complex path at 12×12, two
    points, then the same command with ``--resume true``, which skips
    both."""
    from dwavehmc_tpu_torch.drivers import batch_scan_T

    root = os.path.join(REPO, "build", "scan_smoke", "serial")
    argv = ["--mode", "serial", "--device", dev.type, "--path", "complex",
            "--Lx", "12", "--Ly", "12", "--n_T", "2", "--T_min", "0.01",
            "--T_max", "1", "--n_therm", "2", "--n_measure", "2",
            "--Nt_therm_init", str(NT), "--Nt_measure", str(NT),
            "--bin_size", "1",
            "--checkpoint_freq", "0", "--verbose", "false",
            "--no-summarize", "--out_dir", root]
    out, launches, sec = _counted(lambda: batch_scan_T.main(argv))
    out2, launches2, sec2 = _counted(
        lambda: batch_scan_T.main(argv + ["--resume", "true"]))
    emit({"phase": "scan.serial", "lattice": [12, 12],
          "points": [os.path.basename(r["out_dir"]) for r in out],
          "seconds": sec, "acceptance": [r["acceptance"] for r in out],
          "launches": launches, "rerun_seconds": sec2,
          "rerun_skipped": [bool(r.get("skipped")) for r in out2],
          "rerun_launches": launches2, "gpu": power})
    for r in out:
        _check_csvs(r["out_dir"], 1, 2)
    check(launches["weighted_lorentzian_sum"] == 2 * 2 * len(out),
          f"scan.serial: {launches['weighted_lorentzian_sum']} K2 launches")
    check(launches["rotation_s_parts"] == 0, "scan.serial launched K1")
    check(all(r.get("skipped") for r in out2),
          "scan.serial: the rerun did not skip the finished points")
    check(sum(launches2.values()) == 0, "scan.serial: the rerun launched")
    return launches


# --- the clean-limit gate, the β benchmark, tracked_eigh, the CLIs, the gate -

#: the S3 gate on the card: ``benchmark_clean --fast`` (8×8, β = 100,
#: J = 1.6, 40 + 60 sweeps at Nt 20 / 5), seed 0
CLEAN_ARGS = ["--fast", "--seed", "0"]
#: the README's float32 real-path figures for the same gate, taken on a TPU
#: (not the card's): printed beside the card's for comparison only
TPU_REAL_CLAIM = {"diff": 0.009, "acceptance": 0.88}


def bcs_clean_phases(dev, power: str) -> dict:
    """``benchmark_clean --fast`` on the card: the float64 complex path must
    meet the gate (|⟨|Δ_global|⟩ − RHS| < 0.02, acceptance > 0.5, as
    tests/test_observables.py asks of the same run); then the float32 real
    path with tracked leapfrog steps, held to finite output and to K1's
    schedule (``tracked_iters`` launches per leapfrog step).  Its gap
    difference is reported, not asserted (ROADMAP fault F0: the clean start
    is degenerate)."""
    import inspect

    from dwavehmc_tpu_torch.drivers import benchmark_clean as s3
    from dwavehmc_tpu_torch.sampler.hmc_real import hmc_sweep_real

    def run(extra):
        ns = s3.resolve_args(s3.parser().parse_args(
            CLEAN_ARGS + ["--device", dev.type] + extra))
        res, launches, sec = _counted(
            lambda: s3.benchmark(ns, log=lambda s: None))
        run = res.pop("run")
        check(bool(np.isfinite(run.delta_global).all())
              and all(np.isfinite(res[k]) for k in ("gap", "rhs", "diff")),
              f"bcs.clean {extra}: non-finite output")
        return ns, res, launches, sec

    ns, res, launches, sec = run([])
    emit({"phase": "bcs.clean", "lattice": [ns.L, ns.L], "beta": ns.beta,
          "J": ns.J, "dtype": ns.dtype, "path": ns.path, **res,
          "phase_seconds": sec, "launches": launches, "gpu": power})
    check(res["diff"] < 0.02, f"bcs.clean: |gap − RHS| = {res['diff']:.6f}"
          " ≥ 0.02")
    check(res["acceptance"] > 0.5, f"bcs.clean: acceptance "
          f"{res['acceptance']:.2f} ≤ 0.5")

    real = ["--path", "real", "--eigh_mode", "tracked", "--dtype", "float32"]
    ns, res2, launches2, sec2 = run(real)
    iters = inspect.signature(hmc_sweep_real).parameters[
        "tracked_iters"].default
    k1_want = iters * (ns.n_therm * ns.Nt_therm
                       + ns.n_measure * ns.Nt_measure)
    emit({"phase": "bcs.clean_real", "lattice": [ns.L, ns.L],
          "beta": ns.beta, "dtype": ns.dtype, "path": ns.path,
          "eigh_mode": ns.eigh_mode, **res2, "gate_met": res2["diff"] < 0.02,
          "tpu_figures_in_readme": TPU_REAL_CLAIM, "phase_seconds": sec2,
          "launches": launches2, "k1_expected": k1_want, "gpu": power})
    check(launches2["rotation_s_parts"] == k1_want,
          f"bcs.clean_real: {launches2['rotation_s_parts']} K1 launches, "
          f"the schedule implies {k1_want}")
    check(launches["rotation_s_parts"] == 0, "bcs.clean launched K1")
    return {k: launches[k] + launches2[k] for k in launches}


#: how far the warm start's state is moved from the state whose exact
#: eigenbasis it starts from: a normal draw of this size on each Δ component
TRACKED_MOVE = 1e-3
#: the warm start's eigenvalues against ``full_eigh_from_parts``, relative to
#: max|e|: float32 (ε ≈ 6e-8) with room for 2304-dimensional eigh and
#: rotation round-off
TRACKED_EIG_RTOL = 1e-5


def tracked_eigh_phase(dev, gen, power: str) -> dict:
    """``tracked_eigh`` at the main path's shape, (8, 1152, 1152) float32:
    from the exact eigenbasis of a production state (24×24, the production
    couplings and disorder, the scan's random Δ start) applied to a state
    moved by ``TRACKED_MOVE``, no chain may fall back and the eigenvalues
    must agree with ``full_eigh_from_parts`` within ``TRACKED_EIG_RTOL``;
    from the identity basis every chain must fall back.  Each call makes
    its n_iter = 3 K1 launches."""
    from dwavehmc_tpu_torch.models.bdg import static_hamiltonian
    from dwavehmc_tpu_torch.models.bdg_real import assemble_parts
    from dwavehmc_tpu_torch.models.lattice import LatticeSpec
    from dwavehmc_tpu_torch.models.params import make_params
    from dwavehmc_tpu_torch.ops.tracked_eigh import (
        full_eigh_from_parts, tracked_eigh)
    from dwavehmc_tpu_torch.sampler.hmc_real import draw_init_state

    lat = LatticeSpec(L_MAIN, L_MAIN)
    params = make_params(dtype=torch.float32, device=dev, **PHYS)
    dis, dre, dim = draw_init_state(lat, params, N_CHAINS, generator=gen,
                                    device=dev)
    Hs = static_hamiltonian(lat, params.t, params.tp, params.mu, dis)
    _, X0, Y0 = full_eigh_from_parts(*assemble_parts(lat, Hs, dre, dim))
    move = TRACKED_MOVE * torch.randn((2,) + tuple(dre.shape), generator=gen,
                                      device=dev)
    hr, hi = assemble_parts(lat, Hs, dre + move[0], dim + move[1])
    e_full = full_eigh_from_parts(hr, hi)[0]
    M = torch.cat([torch.cat([hr, -hi], -1), torch.cat([hi, hr], -1)], -2)
    e64 = torch.linalg.eigvalsh(M.double())[..., ::2]
    scale = float(e_full.abs().max())
    n_iter = 3

    (e, X, Y, bad), launches, sec = _counted(
        lambda: tracked_eigh(hr, hi, X0, Y0, n_iter=n_iter))
    U = torch.complex(X, Y)
    eye = torch.eye(U.shape[-1], dtype=U.dtype, device=dev)
    warm = {"fell_back": bad.tolist(),
            "max_abs_err_vs_full_eigh": float((e - e_full).abs().max()),
            "max_abs_err_vs_float64": float((e.double() - e64).abs().max()),
            "orthonormality": float((U.mH @ U - eye).abs().max()),
            "launches": launches, "seconds": sec,
            "ms": event_ms(lambda: tracked_eigh(hr, hi, X0, Y0,
                                                n_iter=n_iter))}
    ident = torch.eye(hr.shape[-1], device=dev).expand_as(hr)
    (e2, _, _, bad2), launches2, sec2 = _counted(
        lambda: tracked_eigh(hr, hi, ident, torch.zeros_like(hr),
                             n_iter=n_iter))
    cold = {"fell_back": bad2.tolist(),
            "max_abs_err_vs_full_eigh": float((e2 - e_full).abs().max()),
            "launches": launches2, "seconds": sec2}
    emit({"phase": "tracked_eigh", "shape": list(hr.shape),
          "dtype": "float32", "n_iter": n_iter, "tol": 1e-4,
          "move": TRACKED_MOVE, "scale": scale, "warm": warm, "cold": cold,
          "full_eigh_from_parts_ms": event_ms(
              lambda: full_eigh_from_parts(hr, hi)),
          "full_eigh_max_abs_err_vs_float64": float(
              (e_full.double() - e64).abs().max()), "gpu": power})
    check(not bool(bad.any()), f"tracked_eigh warm start fell back on "
          f"chains {bad.nonzero().flatten().tolist()}")
    check(warm["max_abs_err_vs_full_eigh"] <= TRACKED_EIG_RTOL * scale,
          f"tracked_eigh warm start: eigenvalues "
          f"{warm['max_abs_err_vs_full_eigh']:.3g} from the full eigh's")
    check(bool(bad2.all()), "tracked_eigh from the identity basis: chains "
          f"{(~bad2).nonzero().flatten().tolist()} did not fall back")
    check(cold["max_abs_err_vs_full_eigh"] <= TRACKED_EIG_RTOL * scale,
          "tracked_eigh cold start: eigenvalues off the full eigh's")
    for name, got in (("warm", launches), ("cold", launches2)):
        check(got["rotation_s_parts"] == n_iter,
              f"tracked_eigh {name}: {got['rotation_s_parts']} K1 launches, "
              f"expected {n_iter}")
    return {k: launches[k] + launches2[k] for k in launches}


def bcs_beta_scan_phase(dev, power: str) -> dict:
    """``benchmark_beta_scan`` at its 12×12 width, float64 complex path, cut
    to 2 β (1 and 5000, its grid's ends) and 2 + 3 sweeps at Nt = 10: the
    CSV's columns and finite values."""
    from dwavehmc_tpu_torch.drivers import benchmark_beta_scan as s4

    out = os.path.join(REPO, "build", "bcs_smoke", "benchmark_beta_scan.csv")
    argv = ["--n_beta", "2", "--n_therm", "2", "--n_measure", "3",
            "--device", dev.type, "--out", out]
    rows, launches, sec = _counted(lambda: s4.main(argv))
    header, vals = _csv_rows(out)
    emit({"phase": "bcs.beta_scan", "lattice": [12, 12], "argv": argv[:6],
          "header": header, "rows": vals.tolist(), "seconds": sec,
          "launches": launches, "gpu": power})
    check(header == s4.CSV_HEADER, f"bcs.beta_scan: header {header!r}")
    check(vals.shape == (2, 7), f"bcs.beta_scan: rows {vals.shape}")
    check(bool(np.isfinite(vals).all()), "bcs.beta_scan: non-finite value")
    check(np.allclose(vals[:, 0], [1.0, 5000.0]), "bcs.beta_scan: β grid")
    return launches


def _python_m(module: str, argv: list) -> str:
    """``python -m module argv`` from the checkout; its standard output."""
    out = subprocess.run([sys.executable, "-m", module, *argv], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"{module} exited {out.returncode}:\n"
          f"{out.stderr[-3000:]}")
    return out.stdout


def _tree(top: str) -> dict:
    """Relative path → bytes of every file under ``top``."""
    out = {}
    for d, _, files in os.walk(top):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), top)] = fh.read()
    return out


def postprocess_cli_phase(power: str) -> None:
    """The three post-processing CLIs as subprocesses on a copy of the
    ``scan.vectorized`` output (resumed, 6 measurement sweeps), against the
    library functions on another copy: every file equal.  The merge takes
    as donor 2 points of ``scan.sharded``'s one-process run (same T
    grid)."""
    import shutil

    from dwavehmc_tpu_torch.drivers import merge_scan_points as merge_cli
    from dwavehmc_tpu_torch.drivers.postprocess import (
        batch_process_spectra, summarize_scan)

    base = os.path.join(REPO, "build", "scan_smoke")
    work = os.path.join(REPO, "build", "cli_smoke")
    shutil.rmtree(work, ignore_errors=True)
    lib, cli = os.path.join(work, "lib"), os.path.join(work, "cli")
    for d in (lib, cli):
        shutil.copytree(os.path.join(base, "tracked"), d)
    donor = os.path.join(work, "donor")
    shutil.copytree(os.path.join(base, "sharded_one"), donor)
    points = sorted(p for p in os.listdir(donor) if p.startswith("T_"))
    keep = points[:1] + points[-1:]
    for p in points:
        if p not in keep:
            shutil.rmtree(os.path.join(donor, p))

    t0 = time.perf_counter()
    res = batch_process_spectra(lib, "T_*")
    check(not res["failed"], f"postprocess: library failed on "
          f"{res['failed']}")
    out = _python_m("dwavehmc_tpu_torch.drivers.process_spectra",
                    [cli, "--batch", "--pattern", "T_*"])
    check("FAILED" not in out, f"process_spectra CLI:\n{out}")
    summarize_scan(lib, "T_", "T")
    _python_m("dwavehmc_tpu_torch.drivers.summarize_scan",
              [cli, "--prefix", "T_", "--name", "T"])
    a, b = _tree(lib), _tree(cli)
    check(a == b, "postprocess CLIs: files differ from the library's: "
          f"{sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))}")
    n_processed = sum("processed_" in k for k in a)
    note = "smoke: 2 points of the one-process sharded-argv run"
    merge_cli.merge(lib, donor, "T", note)
    _python_m("dwavehmc_tpu_torch.drivers.merge_scan_points",
              ["--target", cli, "--donor", donor, "--param", "T",
               "--note", note])
    a, b = _tree(lib), _tree(cli)
    check(a == b, "merge_scan_points CLI: files differ from the library's: "
          f"{sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))}")
    prov = json.loads(a["provenance.json"])
    check(sorted(prov["points"]) == keep, f"merge: provenance {prov}")
    emit({"phase": "postprocess.cli", "points": len(points),
          "processed_files": n_processed, "merged_points": keep,
          "files_compared": len(a), "seconds": time.perf_counter() - t0,
          "gpu": power})


def quickcheck_phase(power: str) -> None:
    """``utils/quickcheck.run_quick_suite`` once on the card (the CUDA tier
    under ``--noconftest``): it must pass.  Every other launch of an entry
    point in this script runs under SKIP_QUICK_TESTS=1."""
    from dwavehmc_tpu_torch.utils.quickcheck import (
        QUICK_TESTS, run_quick_suite)

    torch.cuda.empty_cache()
    skip = os.environ.pop("SKIP_QUICK_TESTS", None)
    t0 = time.perf_counter()
    try:
        run_quick_suite(REPO)
    except SystemExit as e:
        check(False, f"quickcheck: {e}")
    finally:
        if skip is not None:
            os.environ["SKIP_QUICK_TESTS"] = skip
    emit({"phase": "quickcheck", "tests": list(QUICK_TESTS),
          "seconds": time.perf_counter() - t0, "gpu": power})


# --- the fast tracked configuration and the tools that validate it ----------

#: ``validate_cheap_anchor`` at the JAX package's 24×24 configuration
#: (examples/cheap_anchor_validation_exp2_24x24.json: β = 10, J = 0.8, Nt = 6,
#: K = 10, refine 6 / polish 3, exp2, the PH anchor, dt × 0.6) at the batch
#: of 8 this script runs at 24×24 (64 there), its depth cut from 8 therm,
#: 3 paired and 30 equilibrium sweeps to 6, 4 and 10 (after 2 therm sweeps
#: most chains have accepted nothing yet, and float32 trajectories from
#: there are rejected)
CHEAP_ANCHOR_ARGS = [
    "--L", str(L_MAIN), "--batch", str(N_CHAINS), "--beta", "10", "--J",
    "0.8", "--Nt", "6", "--anchor_every", "10", "--tracked_iters", "6",
    "--refine_iters", "6", "--polish_iters", "3", "--rot_scheme", "exp2",
    "--exact_solver", "ph", "--dt_factor", "0.6", "--therm", "6",
    "--paired", "4", "--sweeps", "10"]
#: the JAX package's paired bias max |dH_cheap − dH_exact| with bf16
#: rotations, measured on a TPU (not the card's; printed for comparison):
#: examples/cheap_anchor_validation_bf16.json (16×16) and the filtered
#: 24×24 figure its exp2_24x24 artifact quotes
TPU_PAIRED_BIAS = {"16x16": 1.2e-3, "24x24": 0.0165}


def cheap_anchor_rotations(ns, n_therms: int) -> int:
    """K1 launches of one ``validate_cheap_anchor`` run: ``n_therms``
    thermalizations (exact-anchored sweeps at Nt = 20), the paired
    proposals (each with the endpoint refine and polish), and the K = 1 and
    K = K equilibrium segments."""
    from dwavehmc_tpu_torch.drivers.validate_cheap_anchor import NT_THERM

    track = dict(tracked=ns.tracked_iters, refine=ns.refine_iters,
                 polish=ns.polish_iters)
    therm = expected_rotations(ns.therm, 1, NT_THERM, **track)
    paired = ns.paired * (ns.Nt * ns.tracked_iters + ns.refine_iters
                          + ns.polish_iters)
    return (n_therms * therm + paired
            + expected_rotations(ns.sweeps, 1, ns.Nt, **track)
            + expected_rotations(ns.sweeps, ns.anchor_every, ns.Nt, **track))


def validate_cheap_anchor_phase(dev, power: str) -> dict:
    """``validate_cheap_anchor`` at 24×24 with bf16 rotations, then with
    float32 ones, from the same initial state and draws (the float32 run
    reuses the bf16 run's two thermalizations, which the rotation dtype
    does not enter): the paired gate max |ΔdH| < 0.1 over the compared
    pairs (finite on both sides by construction), finite observables, and
    K1's schedule.  The equilibrium shifts over SEM are reported, not
    asserted, at this depth.  Then ``trajectory_dtype_check``, outside the
    counted windows."""
    from dwavehmc_tpu_torch.drivers import validate_cheap_anchor as vca
    from dwavehmc_tpu_torch.ops import ph_eigh

    total, cache = None, {}
    for rot in ("bfloat16", None):
        ns = vca.parser().parse_args(
            CHEAP_ANCHOR_ARGS + ["--device", dev.type]
            + (["--rot_dtype", rot] if rot else []))
        gen = torch.Generator(device=dev).manual_seed(vca.SEED)
        init, stream = vca.initial_draws(vca.setup(ns), ns, gen)
        n_therms = 2 - len(cache)
        ph_eigh.reset_guard()
        (report, audit), launches, sec = _counted(lambda: vca.validate(
            ns, init=init, stream=stream, cache=cache,
            log=lambda m: print(m, file=sys.stderr)))
        eq = report["equilibrium"]
        k1_want = cheap_anchor_rotations(ns, n_therms)
        emit({"phase": "validate.cheap_anchor", "rot_dtype": rot or "float32",
              "config": report["config"], "paired_dH": report["paired_dH"],
              "gate": vca.MAX_DH_ERR,
              "dH_cheap": audit.dH_cheap.tolist(),
              "dH_exact": audit.dH_exact.tolist(),
              "guard": dict(ph_eigh.GUARD),
              "acceptance": {k: eq[k]["acceptance"] for k in ("exact",
                                                              "cheap")},
              "traj_per_sec": {k: eq[k]["traj_per_sec"] for k in ("exact",
                                                                  "cheap")},
              "shift_over_sem": {k: v["shift_over_sem"]
                                 for k, v in eq["shifts"].items()},
              "pass_at_this_depth": report["pass"],
              "tpu_paired_bias_bf16": TPU_PAIRED_BIAS, "seconds": sec,
              "launches": launches, "k1_expected": k1_want, "gpu": power})
        paired = report["paired_dH"]
        check(paired["n_samples"] > 0, f"validate.cheap_anchor {rot}: no "
              "pair left to compare")
        check(paired["max_abs_err"] < vca.MAX_DH_ERR,
              f"validate.cheap_anchor {rot}: paired max |dH_cheap − "
              f"dH_exact| = {paired['max_abs_err']:.4g} ≥ {vca.MAX_DH_ERR}")
        check(all(np.isfinite(eq[k][o]["mean"]) for k in ("exact", "cheap")
                  for o in ("energy", "delta_amp", "delta_pair")),
              f"validate.cheap_anchor {rot}: non-finite observables")
        check(launches["rotation_s_parts"] == k1_want,
              f"validate.cheap_anchor {rot}: {launches['rotation_s_parts']}"
              f" K1 launches, the schedule implies {k1_want}")
        total = launches if total is None else {
            k: total[k] + launches[k] for k in total}
    trajectory_dtype_check(ns, cache[ns.exact_solver][0], stream, power)
    return total


#: the exact anchor's float32 dH against a float64 recomputation of the same
#: proposal: float32 eigenvalues of a 2304-dimensional embedding, summed
#: with β = 10, stay far inside the paired gate
DH_FLOAT64_TOL = 0.05


def _energy_float64(lat, params, state, prop):
    """H(new) − H(old) of a tracked proposal in float64 from scratch: the
    kinetic and bosonic terms and the fermion term over the float64
    eigenvalues of both embeddings (all levels / 2)."""
    from dwavehmc_tpu_torch.models.bdg_real import (
        assemble_embedding, static_embedding)

    beta, J = float(params.beta), float(params.J)
    Ms = static_embedding(lat, params.t, params.tp, params.mu,
                          state.disorder).double()

    def H(dre, dim, pre, pim):
        M = assemble_embedding(lat, Ms, dre.double(), dim.double())
        x = beta * torch.linalg.eigvalsh(M)[..., ::2].abs()
        fer = -0.5 * torch.sum(x + 2.0 * torch.nn.functional.softplus(-x),
                               dim=-1)
        kin = torch.sum(pre.double() ** 2 + pim.double() ** 2, (-2, -1)) / 2
        bos = beta / (2 * J) * torch.sum(dre.double() ** 2
                                         + dim.double() ** 2, (-2, -1))
        return kin + bos + fer

    return (H(prop.delta_re, prop.delta_im, prop.pi_re, prop.pi_im)
            - H(state.delta_re, state.delta_im, prop.pi_re0, prop.pi_im0))


def trajectory_dtype_check(ns, state, stream, power: str) -> None:
    """The first paired proposal of ``validate.cheap_anchor`` once with bf16
    and once with float32 in-trajectory rotations, from the same
    thermalized state and draws: the largest in-trajectory residual, the
    exact dH (the guarded PH anchor) and its distance from a float64
    recomputation of the same proposal, which must stay under
    ``DH_FLOAT64_TOL``: the audit's exact side is exact to that."""
    from dwavehmc_tpu_torch.drivers import validate_cheap_anchor as vca
    from dwavehmc_tpu_torch.parallel.ensemble import tracked_accept_exact
    from dwavehmc_tpu_torch.sampler.hmc_real import tracked_leapfrog

    su = vca.setup(ns)
    n, u = stream.take(ns.therm, 1)
    rows = {}
    for rot in (torch.bfloat16, None):
        prop = tracked_leapfrog(
            su.lat, su.params, state, ns.Nt, su.dt, ns.tracked_iters,
            ns.refine_iters, ns.polish_iters, su.ns_steps, rot,
            ns.polish_precision, ns.polish_correction, ns.rot_scheme,
            normals=n[0], uniforms=u[0])
        _, info = tracked_accept_exact(su.lat, su.params, state, prop,
                                       ns.exact_solver)
        dH = info.dH.double()
        dH64 = _energy_float64(su.lat, su.params, state, prop)
        rows["bfloat16" if rot else "float32"] = {
            "res_max": prop.res_max.tolist(), "dH_exact": dH.tolist(),
            "mean_dH_exact": float(dH.mean()),
            "max_abs_dH_minus_float64": float((dH - dH64).abs().max())}
    emit({"phase": "validate.cheap_anchor.trajectory", "rows": rows,
          "tol": DH_FLOAT64_TOL, "gpu": power})
    for name, r in rows.items():
        check(r["max_abs_dH_minus_float64"] < DH_FLOAT64_TOL,
              f"validate.cheap_anchor.trajectory {name}: exact dH "
              f"{r['max_abs_dH_minus_float64']:.3g} from float64")


#: ``ab_polish`` cut to its first two variants (4 polish rotations at
#: "highest" and at "high"), at its own 16×16 width and batch 8, bf16
#: rotations, K = 10, its depth cut from 10 therm, 6 paired and 20 sweeps;
#: and the same polish at "default" (one TF32 pass), which the JAX script
#: does not race, to show why "high" takes three
POLISH_KNOBS = dict(L=16, batch=8, Nt=6, therm=4, paired=4, sweeps=10, K=10,
                    rot="bfloat16")


def validate_polish_phase(dev, power: str) -> dict:
    """``ab_polish``'s two precision variants and the one-pass "default":
    segment seconds and traj/s beside the paired bias of each; finite, and
    K1's schedule."""
    from dwavehmc_tpu_torch.drivers import ab_polish as ab

    kn = POLISH_KNOBS
    configs = ab.CONFIGS[:2] + [(4, "default", False)]
    out, launches, sec = _counted(lambda: ab.ab_polish(
        kn, configs, dev, log=lambda m: print(m, file=sys.stderr)))
    k1_want = expected_rotations(kn["therm"], 1, 20, ab.TRACKED_ITERS)
    for p_iters, _, _ in configs:
        track = dict(tracked=ab.TRACKED_ITERS, refine=ab.REFINE_ITERS,
                     polish=p_iters)
        k1_want += (kn["paired"] * (kn["Nt"] * ab.TRACKED_ITERS
                                    + ab.REFINE_ITERS + p_iters)
                    + 3 * expected_rotations(kn["sweeps"], kn["K"], kn["Nt"],
                                             **track))
    emit({"phase": "validate.polish", "config": out["config"],
          "results": out["results"], "seconds": sec, "launches": launches,
          "k1_expected": k1_want, "gpu": power})
    check(all(np.isfinite([r["max_dH_err"], r["traj_per_sec"]]).all()
              for r in out["results"]), "validate.polish: non-finite result")
    check(launches["rotation_s_parts"] == k1_want,
          f"validate.polish: {launches['rotation_s_parts']} K1 launches, the "
          f"schedule implies {k1_want}")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "validate.polish: TF32 left on after the polish")
    return launches


#: "high" may lose at most this factor of "highest"'s eigenvalue error
LIFT_HIGH_EVAL_FACTOR = 10.0


def ph_lift_phase(dev, gen, power: str) -> None:
    """``bench_ph_eigh`` at (8, 2304, 2304), the lift at "highest", "high"
    (three TF32 products per product) and "default" (one) against the full
    eigh: "high" keeps the eigenvalue error within 10× "highest"'s and the
    guard's convergence residual under its threshold, its sign matrix
    differs from "highest"'s (the TF32 products ran), and TF32 is off again
    after each.  "default" is reported, not held to a bound."""
    from dwavehmc_tpu_torch.drivers import bench_ph_eigh as bench
    from dwavehmc_tpu_torch.ops import ph_eigh

    M = bench.build_batch(L_MAIN, N_CHAINS, gen, dev)
    rows, signs = {}, {}
    for prec in ("highest", "high", "default"):
        ns = bench.parser().parse_args(
            ["--lift_prec", prec, "--device", dev.type]
            + (["--skip_qdwh"] if prec != "highest" else []))
        res, (w, X, Y) = bench.race(
            M, ns, log=lambda m: print(m, file=sys.stderr))
        sgn, resid = ph_eigh.sign_embedding(M, lift_precision=prec,
                                            return_resid=True)
        signs[prec] = sgn
        eye = torch.eye(X.shape[-1], device=dev)
        res["orth_err"] = max(float((X.mT @ X + Y.mT @ Y - eye).abs().max()),
                              float((X.mT @ Y - Y.mT @ X).abs().max()))
        res["guard_resid"] = float(resid.max())
        rows[prec] = res
        del w, X, Y
        check(not torch.backends.cuda.matmul.allow_tf32,
              f"anchor.ph_lift: TF32 left on after lift_prec={prec}")
    sign_diff = float((signs["high"] - signs["highest"]).abs().max())
    emit({"phase": "anchor.ph_lift", "shape": list(M.shape), "rows": rows,
          "sign_max_diff_high_vs_highest": sign_diff,
          "eval_err_factor": LIFT_HIGH_EVAL_FACTOR, "gpu": power})
    hi, top = rows["high"], rows["highest"]
    check(hi["eval_err"] <= LIFT_HIGH_EVAL_FACTOR * top["eval_err"],
          f"anchor.ph_lift: eval_err {hi['eval_err']:.3g} at 'high' > "
          f"{LIFT_HIGH_EVAL_FACTOR:g} × {top['eval_err']:.3g} at 'highest'")
    for prec in ("highest", "high"):
        check(rows[prec]["guard_resid"] < ph_eigh.PH_GUARD_RESID,
              f"anchor.ph_lift {prec}: sign residual "
              f"{rows[prec]['guard_resid']:.3g}")
    check(sign_diff > 0.0, "anchor.ph_lift: 'high' gave the IEEE sign "
          "matrix bit for bit; the TF32 products did not run")


def beta_extreme_phase(dev, power: str) -> dict:
    """``validate_beta_extreme`` at its 12×12 width (β = 1e4 and 1e5, 2
    replicas, the host float64 readout), cut to 2 anneal stages × 2 sweeps,
    3 therm and 4 measurement sweeps: every dH finite and both kernels
    launched; the acceptance and the saturation fields are reported (not a
    pass at this length)."""
    from dwavehmc_tpu_torch.drivers import validate_beta_extreme as vbe

    work = os.path.join(REPO, "build", "validate_smoke")
    argv = ["--device", dev.type, "--n_therm", "3", "--n_measure", "4",
            "--anneal_stages", "2", "--anneal_sweeps", "2",
            "--root", os.path.join(work, "beta_extreme_12x12"),
            "--out", os.path.join(work, "beta_extreme_validation.json")]
    rep, launches, sec = _counted(lambda: vbe.main(argv))
    emit({"phase": "validate.beta_extreme", "argv": argv[2:10],
          "points": rep["points"], "saturated": rep["saturated"],
          "delta_global_gap_over_sem": rep["delta_global_gap_over_sem"],
          "rho_s_gap_over_sem": rep["rho_s_gap_over_sem"],
          "pass_at_this_depth": rep["pass"], "seconds": sec,
          "launches": launches, "gpu": power})
    check(all(p["dH_all_finite"] for p in rep["points"].values()),
          "validate.beta_extreme: a recorded dH is not finite")
    for name in ("rotation_s_parts", "weighted_lorentzian_sum"):
        check(launches[name] > 0, f"validate.beta_extreme: {name} was not "
              "launched")
    return launches


def beta_dt_and_tune_phases(dev, power: str) -> dict:
    """``probe_beta_dt`` (12×12 clean, β = 1e4, its four dt scales at 2
    sweeps each after 2 therm sweeps) and ``tune_Nt_efficiency`` (8×8,
    ``--Nt_list 4 8 16 --n_therm 3 --n_sweeps 5``): their tables, finite;
    the probe launches K1, the complex-path study no kernel."""
    from dwavehmc_tpu_torch.drivers import probe_beta_dt as probe
    from dwavehmc_tpu_torch.drivers import tune_Nt_efficiency as tune

    kn = probe.knobs({})
    out, launches, sec = _counted(lambda: probe.probe(
        kn, dev, therm=2, sweeps=2,
        log=lambda m: print(m, file=sys.stderr)))
    emit({"phase": "validate.beta_dt", "knobs": kn, "therm": 2, "sweeps": 2,
          "dt0": out["dt0"],
          "points": out["points"],
          "ratio_dt0_over_quarter": out.get("ratio_dt0_over_quarter"),
          "seconds": sec, "launches": launches, "gpu": power})
    check(all(np.isfinite(p["mean_absdH"]) for p in out["points"]),
          "validate.beta_dt: non-finite |dH|")
    check(launches["rotation_s_parts"] > 0,
          "validate.beta_dt: K1 was not launched")

    argv = ["--Nt_list", "4", "8", "16", "--n_therm", "3", "--n_sweeps", "5",
            "--device", dev.type]
    lines = []
    (rows, best), launches2, sec2 = _counted(
        lambda: tune.tune(tune.parser().parse_args(argv), log=lines.append))
    emit({"phase": "tune.Nt", "argv": argv[:-2], "table": lines,
          "best": list(best), "seconds": sec2, "launches": launches2,
          "gpu": power})
    check(len(rows) == 3 and all(np.isfinite(r).all() for r in rows),
          "tune.Nt: table incomplete or non-finite")
    return {k: launches[k] + launches2[k] for k in launches}



# --- BASELINE config 5: the disorder-averaged 32×32 ensemble ------------------

#: ``demo_config5 --mode card`` at full width (64 chains of 32×32, the
#: ensemble config 5 defines), its depth cut from 10 therm, 2 warm-up and
#: 10 timed sweeps to 1, 0 and 2
C5_CARD = dict(batch=64, L=C5_L, therm=1, warmup=0, sweeps=2)
#: the card mode's tracked settings (``drivers/demo_config5.card_demo``)
C5_TRACK = dict(tracked=6, refine=12, polish=4)


def _anchor_4096(lat, params, states) -> dict:
    """Chain 0's exact anchor (``diagonalize_embedding``, float32) at the
    32×32 embedding against float64 ``eigvalsh`` of the same matrix,
    reported as ``anchor.ph`` reports the 2304 anchor: max eigenvalue error,
    ‖M‖∞, and the device ms of each solve."""
    from dwavehmc_tpu_torch.models.bdg_real import (
        assemble_embedding, diagonalize_embedding, static_embedding)

    one = slice(0, 1)
    M = assemble_embedding(lat, static_embedding(
        lat, params.t, params.tp, params.mu, states.disorder[one]),
        states.delta_re[one], states.delta_im[one])
    ev = diagonalize_embedding(M)[0]
    w64 = torch.linalg.eigvalsh(M.double())[..., ::2]
    norm = float(M.abs().sum(-1).amax())
    err = float((ev.double() - w64).abs().max())
    return {"dim": M.shape[-1], "eval_err": err, "norm_inf": norm,
            "eval_err_over_norm": err / norm,
            "anchor_ms": event_ms(lambda: diagonalize_embedding(M), reps=2),
            "float64_ms": event_ms(
                lambda: torch.linalg.eigvalsh(M.double()), reps=1)}


def config5_card_phase(dev, power: str) -> dict:
    """``demo_config5 --mode card`` at 64 × 32×32 (``C5_CARD``), then one
    transport pass on its final states at the spectral grid η = 8/N,
    Δω = 0.2η, ω_max = 4 (2556 frequencies; the card mode itself runs
    none): the therm sweep's dH finite; every non-finite dH rejected, and
    their count by stage reported (the card mode's ``nonfinite_dH``); the
    states and every transport output finite, 64 distinct realizations, K1
    on its schedule and no K2 in the run, K2 twice in the pass; the memory
    estimate beside the allocator's peak; chain 0's 4096 anchor against
    float64.

    A finite dH over the timed sweeps cannot be asked at this depth: after
    one therm sweep (acceptance ≈ 0.17) most chains hold their random
    start, where the Nt = 6 step (dt ≈ 3× the Nt = 20 one) diverges on a
    few; the full run (10 therm sweeps) reports its own count."""
    from dwavehmc_tpu_torch.drivers import demo_config5 as c5
    from dwavehmc_tpu_torch.parallel.ensemble import ensemble_transport_real
    from dwavehmc_tpu_torch.utils.memory import device_memory, estimate_memory

    kn = C5_CARD
    out = os.path.join(REPO, "build", "config5_smoke", "card.json")
    run, launches, sec = _counted(lambda: c5.card_demo(
        out, dev, log=lambda m: print(m, file=sys.stderr), **kn))
    k1_want = (expected_rotations(kn["therm"], 1, 20, **C5_TRACK)
               + expected_rotations(kn["warmup"], 5, 6, **C5_TRACK)
               + expected_rotations(kn["sweeps"], 5, 6, **C5_TRACK))
    distinct = len({d.tobytes() for d in
                    run.states.disorder.cpu().numpy()})
    spec = production_spec(run.lat)
    res, launches2, sec2 = _counted(lambda: ensemble_transport_real(
        run.lat, spec, run.params, run.states))
    peak = torch.cuda.max_memory_allocated(dev)
    est = estimate_memory(run.lat, kn["batch"], torch.float32)
    anchor = _anchor_4096(run.lat, run.params, run.states)
    nonfinite = ~np.isfinite(run.dH)
    emit({"phase": "config5.card", "knobs": kn, "report": run.report,
          "seconds": sec, "dH": run.dH.tolist(),
          "distinct_disorder_realizations": distinct,
          "launches": launches, "k1_expected": k1_want,
          "transport": {"seconds": sec2, "n_omega": spec.n_omega,
                        "launches": launches2,
                        "shapes": {k: list(v.shape)
                                   for k, v in res._asdict().items()},
                        "stiffness_mean": float(
                            res.superfluid_stiffness.mean()),
                        "dc_conductivity_mean": float(
                            res.dc_conductivity.mean())},
          "memory": {"estimate": str(est), "estimate_bytes": est.total_bytes,
                     "max_memory_allocated_bytes": peak,
                     "allocated_over_estimate": peak / est.total_bytes,
                     "card_bytes": device_memory(dev)},
          "anchor_4096": anchor, "gpu": power})
    check(np.isfinite(run.dH[:kn["therm"]]).all(),
          "config5.card: a therm sweep's dH is not finite")
    check(not (nonfinite & run.accepted).any(),
          "config5.card: a non-finite dH was accepted")
    check(sum(run.report["nonfinite_dH"].values()) == int(nonfinite.sum()),
          "config5.card: the report's non-finite dH count is wrong")
    _finite(run.states, "config5.card.state")
    check(distinct == kn["batch"], f"config5.card: {distinct} distinct "
          f"realizations of {kn['batch']}")
    check(launches["rotation_s_parts"] == k1_want,
          f"config5.card: {launches['rotation_s_parts']} K1 launches, the "
          f"schedule implies {k1_want}")
    check(launches["weighted_lorentzian_sum"] == 0,
          "config5.card: the segments launched K2")
    check(launches2["weighted_lorentzian_sum"] == 2,
          f"config5.card: {launches2['weighted_lorentzian_sum']} K2 "
          "launches in the transport pass, expected 2")
    check(tuple(res.optical_conductivity.shape)
          == (kn["batch"], spec.n_omega), "config5.card: σ(ω) shape")
    _finite(res, "config5.card.transport")
    check(anchor["eval_err"] <= 1e-5 * anchor["norm_inf"],
          f"config5.card: the 4096 anchor's eigenvalue error "
          f"{anchor['eval_err']:.3g} > 1e-5·‖M‖∞")
    del run, res
    torch.cuda.empty_cache()
    return {k: launches[k] + launches2[k] for k in launches}


def config5_demo32_phase(dev, power: str) -> dict:
    """``demo_32x32`` at its defaults (2 chains of 32×32, 8 therm at
    Nt = 20 and 2 × 10 measured sweeps at Nt = 6, K = 5, refine 12 /
    polish 6, bf16 rotations, one transport pass on 100 frequencies):
    finite, K1 on its schedule, K2 twice."""
    from dwavehmc_tpu_torch.drivers import demo_32x32 as demo

    kn = demo.knobs({})
    (out, _, _), launches, sec = _counted(lambda: demo.demo(
        kn, dev, log=lambda m: print(m, file=sys.stderr)))
    track = dict(tracked=demo.TRACK["tracked_iters"],
                 refine=demo.TRACK["refine_iters"],
                 polish=demo.TRACK["polish_iters"])
    k1_want = (expected_rotations(kn["therm"], kn["anchor_every"],
                                  demo.NT_THERM, **track)
               + 2 * expected_rotations(kn["sweeps"], kn["anchor_every"],
                                        kn["Nt"], **track))
    emit({"phase": "config5.demo_32x32", "knobs": kn, "report": out,
          "seconds": sec, "launches": launches, "k1_expected": k1_want,
          "gpu": power})
    check(out["finite"], "config5.demo_32x32: non-finite output")
    check(launches["rotation_s_parts"] == k1_want,
          f"config5.demo_32x32: {launches['rotation_s_parts']} K1 launches, "
          f"the schedule implies {k1_want}")
    check(launches["weighted_lorentzian_sum"] == 2,
          f"config5.demo_32x32: {launches['weighted_lorentzian_sum']} K2 "
          "launches, expected 2")
    return launches


def probe_fullspec_phase(dev, power: str) -> dict:
    """``probe_fullspec_timing`` at its full width (72 chains of 24×24, the
    production T grid's β three times over, the full spectral grid), cut to
    one rep per leg: each leg's seconds and acceptance, ρ_s finite, K1 on
    its schedule, K2 twice."""
    from dwavehmc_tpu_torch.drivers import probe_fullspec_timing as pft

    kn = pft.knobs({})
    out, launches, sec = _counted(lambda: pft.probe(
        kn, dev, reps=1, log=lambda m: print(m, file=sys.stderr)))
    k1_want = sum(expected_rotations(1, 1, nt, refine=12, polish=4)
                  for _, nt in pft.LEGS)
    emit({"phase": "probe.fullspec", "knobs": kn, "n_omega": out["n_omega"],
          "legs": [{k: v for k, v in leg.items() if k != "accepted"}
                   for leg in out["legs"]],
          "transport": out["transport"], "seconds": sec,
          "launches": launches, "k1_expected": k1_want, "gpu": power})
    check(all(np.isfinite(t["rho0"]) for t in out["transport"]),
          "probe.fullspec: non-finite ρ_s")
    check(launches["rotation_s_parts"] == k1_want,
          f"probe.fullspec: {launches['rotation_s_parts']} K1 launches, the "
          f"schedule implies {k1_want}")
    check(launches["weighted_lorentzian_sum"] == 2,
          f"probe.fullspec: {launches['weighted_lorentzian_sum']} K2 "
          "launches, expected 2")
    return launches


#: ``demo_config5 --mode mesh_exec`` at its defaults: 8 chains of 32×32,
#: 2 cheap-anchor sweeps at Nt = 2
C5_EXEC_ARGS = ["--mode", "mesh_exec", "--batch", "8", "--sweeps", "2",
                "--L", str(C5_L)]


#: config 5's replay draws: the JAX run's initial ensemble and first-sweep
#: draws of two 32×32 chains with the CPU's dH beside them
#: (``tests/test_torch_config5_replay.py`` writes and checks the file)
REPLAY_DATA = os.path.join(REPO, "tests", "data", "config5_replay_32x32.npz")
#: the card's float64 dH against the CPU port's; the card's float32 dH
#: against its float64 run on the float32 inputs: the sum of the two
#: packages' float32 errors at 32×32 and β = 20 (ROADMAP Queue 3)
REPLAY_F64_TOL, REPLAY_F32_TOL = 1e-8, 1e-2


def config5_replay_phase(dev, power: str) -> dict:
    """Config 5's first thermalization sweep (Nt = 20, 6 rotations a step,
    exact anchor) on the JAX run's draws (``REPLAY_DATA``) on the card, in
    float64, in float32, and in float64 on the float32 inputs
    (``demo_config5.replay_first_therm_sweep``): the float64 dH within
    ``REPLAY_F64_TOL`` of the CPU port's with its decisions; the float32 dH
    finite, with the CPU's decisions, within ``REPLAY_F32_TOL`` of the
    float64 run on its inputs.  Reported beside them: the float64 sweep
    with K1's plain version in float64 (outside the counted launches)."""
    from dwavehmc_tpu_torch.drivers import demo_config5 as c5
    from dwavehmc_tpu_torch.ops import kernels, tracked_eigh

    d = np.load(REPLAY_DATA)
    (runs, launches, sec) = _counted(lambda: {
        "f64": c5.replay_first_therm_sweep(d, "f64", dev),
        "f32": c5.replay_first_therm_sweep(d, "f32", dev),
        "f32_as_f64": c5.replay_first_therm_sweep(d, "f32", dev,
                                                  torch.float64)})
    (dh64, acc64), (dh32, acc32), (up, _) = (runs["f64"], runs["f32"],
                                             runs["f32_as_f64"])
    # what K1's float32 S (the TPU wrapper's cast, kept for float64 runs)
    # moves: the float64 sweep again with K1's plain version in float64
    real = tracked_eigh.rotation_s_parts
    tracked_eigh.rotation_s_parts = kernels.rotation_s_parts_plain
    try:
        dh64_k1 = c5.replay_first_therm_sweep(d, "f64", dev)[0]
    finally:
        tracked_eigh.rotation_s_parts = real
    f64_err = float(np.abs(dh64 - d["f64_dH_port_cpu"]).max())
    f32_err = float(np.abs(dh32 - up).max())
    emit({"phase": "config5.replay", "seconds": sec,
          "float64": {"dH_card": dh64.tolist(),
                      "dH_port_cpu": d["f64_dH_port_cpu"].tolist(),
                      "dH_jax_cpu": d["f64_dH_jax_cpu"].tolist(),
                      "accepted_card": acc64.tolist(),
                      "accepted_cpu": d["f64_accepted_cpu"].tolist(),
                      "max_abs_diff_cpu": f64_err, "tol": REPLAY_F64_TOL,
                      "dH_card_k1_plain_float64": dh64_k1.tolist(),
                      "k1_plain_minus_cpu": (
                          dh64_k1 - d["f64_dH_port_cpu"]).tolist()},
          "float32": {"dH_card": dh32.tolist(),
                      "dH_card_float64": up.tolist(),
                      "dH_port_cpu": d["f32_dH_port_cpu"].tolist(),
                      "dH_jax_cpu": d["f32_dH_jax_cpu"].tolist(),
                      "dH_port_cpu_float64": d[
                          "f32_dH_port_cpu_float64"].tolist(),
                      "accepted_card": acc32.tolist(),
                      "accepted_cpu": d["f32_accepted_cpu"].tolist(),
                      "error_card": (dh32 - up).tolist(),
                      "float64_card_minus_cpu": (
                          up - d["f32_dH_port_cpu_float64"]).tolist(),
                      "max_abs_error": f32_err, "tol": REPLAY_F32_TOL},
          "launches": launches, "gpu": power})
    check(f64_err <= REPLAY_F64_TOL, f"config5.replay: the card's float64 dH "
          f"is {f64_err:.3g} from the CPU's (> {REPLAY_F64_TOL})")
    check(np.array_equal(acc64, d["f64_accepted_cpu"]),
          "config5.replay: float64 decisions differ from the CPU's")
    check(np.isfinite(dh32).all(), "config5.replay: float32 dH not finite")
    check(np.array_equal(acc32, d["f32_accepted_cpu"]),
          "config5.replay: float32 decisions differ from the CPU's")
    check(f32_err <= REPLAY_F32_TOL, f"config5.replay: the card's float32 dH "
          f"is {f32_err:.3g} from its float64 run (> {REPLAY_F32_TOL})")
    return launches


def _mesh_exec_blocks(c5, dev, ns, dtype, W: int,
                      work: str) -> tuple[dict, dict]:
    """The ranks' blocks of the ``mesh_exec`` ensemble run one after another
    in this process, each as a batch of its own: the one-process initial
    ensemble and draws, sliced to the block's chains.  Each block has the
    shapes a rank's batch has, so the same library kernels run.  Returns
    the blocks' saved state, concatenated in chain order, and how far one
    Nt = 2 leapfrog of the first block alone lands from the same chains'
    leapfrog in the whole batch (max |ΔΔ| and max |ΔX|)."""
    from dwavehmc_tpu_torch.models.lattice import LatticeSpec
    from dwavehmc_tpu_torch.parallel.ensemble import DrawStream
    from dwavehmc_tpu_torch.sampler.hmc import calc_optimal_dt
    from dwavehmc_tpu_torch.sampler.hmc_real import tracked_leapfrog

    lat = LatticeSpec(ns.L, ns.L)
    params = c5.setup(dev, dtype)
    st, gen = c5.init_block(lat, params, c5.rank_block(ns.batch), ns.batch,
                            dev, dtype=dtype)
    shape = (ns.batch, 2, lat.n_sites, 2)
    normals, uniforms = DrawStream(gen, shape, dtype, dev).take(0, ns.sweeps)
    per = -(-ns.batch // W)
    # mesh_exec's step: Nt = 2 at the Nt = 6 dt
    dt = torch.full((ns.batch,), calc_optimal_dt(20.0, 0.8, 1.0, 6),
                    dtype=dtype, device=dev)
    whole, alone = (tracked_leapfrog(
        lat, params, type(st)(*(x[:b] for x in st)), 2, dt[:b], 6, 0, 0, 2,
        normals=normals[0, :b], uniforms=uniforms[0, :b])
        for b in (ns.batch, per))
    leapfrog = {k: float((getattr(whole, k)[:per] - getattr(alone, k))
                         .abs().max()) for k in ("delta_re", "X")}
    del whole, alone
    parts = []
    for r in range(W):
        rows = np.minimum(np.arange(r * per, (r + 1) * per), ns.batch - 1)
        idx = torch.as_tensor(rows, device=dev)
        path = os.path.join(work, f"mesh_exec_blocks_{r}")
        c5.mesh_exec_demo(
            path + ".json", dev, batch=per, sweeps=ns.sweeps, L=ns.L,
            min_ranks=1, dtype=dtype,
            init=tuple(x[idx].cpu().numpy() for x in (
                st.disorder, st.delta_re, st.delta_im)),
            stream=DrawStream(None, (per, *shape[1:]), dtype, dev,
                              normals[:, idx], uniforms[:, idx]),
            save_state=path + ".npz", log=lambda m: None)
        parts.append(np.load(path + ".npz"))
    return {k: np.take(np.concatenate(
        [p[k] for p in parts], axis=int(k in ("accepted", "dH"))),
        np.arange(ns.batch), axis=int(k in ("accepted", "dH")))
        for k in parts[0].files}, leapfrog


#: the library and port calls a tracked sweep makes, by the probe's names
#: (``_batch_invariance``): a sweep is batch-invariant when all of these are
SWEEP_CALLS = ("matmul", "matmul_tn", "row_sum", "chain_sum", "sigma_cap",
               "eigh")


def _batch_invariance(dev, dtype, B: int, n: int, W: int) -> dict:
    """Whether the calls a tracked sweep makes give the first block of
    B / W chains the same bits alone as inside the batch of B: the batched
    products (B, n, n)·(B, n, n) and (B, n, n)ᵀ·(B, n, n) (the rotations),
    the forces' row sums over (B, n/2, n), K3 ``chain_sum`` over (B, n)
    (the energies), K5 ``spectral_norm_est`` (the σ-cap) and the
    embedding's ``eigh`` (the anchor, at (W, 2n, 2n), one chain alone).
    Also the two calls K3 and K5 replace: the per-chain ``torch.sum`` over
    (B, n) and the batched matrix-vector product (B, n, n)·(B, n, 1), whose
    launch cuBLAS and PyTorch's reduction kernels choose by the batch's
    size."""
    from dwavehmc_tpu_torch.models.bdg_real import symmetric_eigh
    from dwavehmc_tpu_torch.ops import kernels

    g = torch.Generator(device=dev).manual_seed(7)
    a = torch.randn(B, n, n, generator=g, device=dev, dtype=dtype)
    v = torch.randn(B, n, 1, generator=g, device=dev, dtype=dtype)
    k = B // W
    calls = (("matmul", lambda x, y: x @ x),
             ("matmul_tn", lambda x, y: x.mT @ x),
             ("row_sum", lambda x, y: (x[:, :n // 2] * x[:, :n // 2])
              .sum(-1)),
             ("chain_sum", lambda x, y: kernels.chain_sum(y[..., 0])),
             ("sigma_cap", lambda x, y: kernels.spectral_norm_est(
                 x, x.mT.contiguous())),
             ("matvec", lambda x, y: x @ y),
             ("sum_per_chain", lambda x, y: y[..., 0].sum(-1)))
    out = {name: bool(torch.equal(f(a, v)[:k], f(a[:k], v[:k])))
           for name, f in calls}
    del a, v
    h = torch.randn(W, 2 * n, 2 * n, generator=g, device=dev, dtype=dtype)
    h = h + h.mT
    w_all, v_all = symmetric_eigh(h)
    w_one, v_one = symmetric_eigh(h[:1])
    out["eigh"] = bool(torch.equal(w_all[:1], w_one)
                       and torch.equal(v_all[:1], v_one))
    return out


def config5_mesh_exec_phase(dev, power: str, W: int) -> dict:
    """``demo_config5 --mode mesh_exec`` (``C5_EXEC_ARGS``) under W ranks on
    the card and the same call in this process (``min_ranks=1``), in
    float64 and in float32, each writing its gathered initial and final
    disorder and Δ, accepts and dH.

    In each dtype the ranks are bit-equal on all of them to their blocks
    run one after another in this process (``_mesh_exec_blocks``).  Against
    the one-process batch of 8 the initial ensemble, the disorder and the
    decisions must be equal; the final Δ and dH are reported, beside
    whether the calls the sweep makes give a block the same bits alone as
    in the batch (``_batch_invariance``; K3 and K5 must) and how far one
    leapfrog of a block alone lands from the batch's.  Where every call of
    ``SWEEP_CALLS`` is batch-invariant in a dtype, every saved array must
    be bit-equal to one process (ROADMAP fault F6); the others are named
    under ``blocked_by``.  mesh_exec runs Nt = 2 at the Nt = 6 step (dt = 0.105, 3.3×
    the Nt = 20 one) from a cold start, so one rounding's difference grows
    over the trajectory.  W ranks, 8 distinct realizations, finite dH.  Returns the
    launches of the one-process calls (the ranks count their own)."""
    from dwavehmc_tpu_torch.drivers import demo_config5 as c5

    work = os.path.join(REPO, "build", "config5_smoke")
    ns = c5.parser().parse_args(C5_EXEC_ARGS)
    from dwavehmc_tpu_torch.ops import kernels

    launches = dict.fromkeys(kernels.LAUNCHES, 0)
    res = {"phase": "config5.mesh_exec", "W": W}
    runs = {}
    for name in ("float64", "float32"):
        dtype = getattr(torch, name)
        paths = {w: os.path.join(work, f"mesh_exec_{name}_{w}")
                 for w in ("one", "ranks")}
        one, counts, sec_one = _counted(lambda: c5.mesh_exec_demo(
            paths["one"] + ".json", dev, batch=ns.batch, sweeps=ns.sweeps,
            L=ns.L, min_ranks=1, dtype=dtype,
            save_state=paths["one"] + ".npz",
            log=lambda m: print(m, file=sys.stderr)))
        for k, n in counts.items():
            launches[k] += n
        sec_ranks = torchrun(
            "dwavehmc_tpu_torch.drivers.demo_config5",
            C5_EXEC_ARGS + ["--device", dev.type, "--dtype", name,
                            "--out", paths["ranks"] + ".json",
                            "--save_state", paths["ranks"] + ".npz"],
            W, 600, os.path.join(work, f"mesh_exec_{name}.launcher.log"))
        with open(paths["ranks"] + ".json") as f:
            ranks = json.load(f)
        a, b = (dict(np.load(paths[w] + ".npz")) for w in ("one", "ranks"))
        runs[name] = (one, ranks)
        res[name] = {
            "one_process": one, "ranks": ranks,
            "bit_equal_one_process": {k: bool(np.array_equal(a[k], b[k]))
                                      for k in a},
            "max_abs_dH_diff_one_process": float(np.abs(a["dH"]
                                                        - b["dH"]).max()),
            "seconds_one_process": sec_one, "launcher_seconds": sec_ranks,
            "batch_invariant": _batch_invariance(
                dev, dtype, ns.batch, 2 * ns.L * ns.L, W)}
        res[name]["blocked_by"] = [
            c for c in SWEEP_CALLS if not res[name]["batch_invariant"][c]]
        blocks, leapfrog = _mesh_exec_blocks(c5, dev, ns, dtype, W, work)
        res[name]["bit_equal_blocks"] = {
            k: bool(np.array_equal(blocks[k], b[k])) for k in b}
        res[name]["leapfrog_block_vs_batch"] = leapfrog
    res.update(launches=launches, gpu=power)
    emit(res)
    for name, (one, ranks) in runs.items():
        check(ranks["devices"] == W, f"config5.mesh_exec {name}: "
              f"{ranks['devices']} ranks, launched {W}")
        for r in (one, ranks):
            check(r["distinct_disorder_realizations"] == ns.batch and
                  r["dH_finite"], f"config5.mesh_exec {name}: {r}")
        for k, eq in res[name]["bit_equal_blocks"].items():
            check(eq, f"config5.mesh_exec {name}: the ranks' {k} differs "
                  "from their blocks run in one process")
        for k in ("init_disorder", "init_delta_re", "init_delta_im",
                  "final_disorder", "accepted"):
            check(res[name]["bit_equal_one_process"][k],
                  f"config5.mesh_exec {name}: the ranks' {k} differs from "
                  "one process")
        probe = res[name]["batch_invariant"]
        for call in ("chain_sum", "sigma_cap"):
            check(probe[call], f"config5.mesh_exec {name}: K3/K5 {call} "
                  "gives a block alone other bits than in the batch")
        # with every call of the sweep batch-invariant, the ranks must be
        # bit-equal to one process on every saved array (F6)
        if all(probe[c] for c in SWEEP_CALLS):
            for k, eq in res[name]["bit_equal_one_process"].items():
                check(eq, f"config5.mesh_exec {name}: every call of the "
                      f"sweep is batch-invariant, but the ranks' {k} "
                      "differs from one process")
    check(launches["rotation_s_parts"] > 0,
          "config5.mesh_exec: K1 was not launched")
    return launches


# --- the measurement and audit tools ------------------------------------------

TOOLS_DIR = os.path.join(REPO, "build", "tools_smoke")
#: ``profile_production`` at its full width (64 chains of 24×24, Nt = 6,
#: K = 10, bf16), its depth cut from 6 therm and 3 × 20 sweeps to 1 and
#: 3 × 2
PROF_CUT = dict(therm=1, sweeps=2)
#: ``ab_rotation`` at 24×24, batch 8 (not 64), two variants, cut from 10
#: therm, 3 paired and 3 × 10 sweeps to 1, 1 and 3 × 2
AB_CUT = dict(batch=8, therm=1, paired=1, sweeps=2)
AB_VARIANTS = "baseline,exp2_ph"
#: an ``ab_rotation`` row's keys (the JAX script's)
AB_ROW_KEYS = {"variant", "rot_scheme", "ns_steps", "use_pallas_s",
               "exact_solver", "max_dH_err", "mean_dH_err",
               "paired_nonfinite", "traj_per_sec", "acceptance",
               "segment_med_dH", "segment_mean_dH", "lag_bias_flag",
               "model_tflops", "mfu_pct_nominal", "wall_s"}
#: ``audit_rhos_dip`` at its 12×12 width, cut from 20 therm + 100
#: measurement sweeps to 4 + 6 (the β points need no anneal: all ≤ 100)
AUDIT_CUT = dict(AUDIT_THERM="4", AUDIT_MEASURE="6")
#: the bar of ``tests/test_transport.py`` for ρ_s against the analytic
#: Drude weight of the clean normal state at 8×8
DRUDE_TOL = 1e-8


def _stdout_lines(fn) -> tuple:
    """(fn(), its standard output as lines)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue().splitlines()


def profile_production_phase(dev, power: str) -> dict:
    """``profile_production`` at its full width, cut by ``PROF_CUT``: the
    trace parses, K1 is on the device's tracks and on its schedule, the
    device's tracks are CUDA stream tracks, traj/s and acceptance are
    finite; the device's busy share, time by kernel family and top kernels
    are printed."""
    import shutil

    from dwavehmc_tpu_torch.drivers import profile_production as pp

    kn = dict(pp.knobs({}), L=L_MAIN, **PROF_CUT)
    trace_dir = os.path.join(TOOLS_DIR, f"trace_{kn['L']}x{kn['L']}"
                             f"_b{kn['batch']}")
    shutil.rmtree(trace_dir, ignore_errors=True)   # this run's trace alone
    out, launches, sec = _counted(lambda: pp.profile(
        kn, dev, trace_dir, log=lambda m: print(m, file=sys.stderr)))
    track = dict(tracked=pp.TRACKED_ITERS, refine=pp.REFINE_ITERS,
                 polish=pp.POLISH_ITERS)
    k1_want = (expected_rotations(kn["therm"], kn["anchor_every"],
                                  pp.NT_THERM, **track)
               + 3 * expected_rotations(kn["sweeps"], kn["anchor_every"],
                                        kn["Nt"], **track))
    device = out["track_analyses"][0]["device"] if out["track_analyses"] \
        else {}
    emit({"phase": "profile.production", "knobs": kn,
          **{k: out[k] for k in ("wall_s_plain", "wall_s_traced",
                                 "traj_per_sec", "acceptance",
                                 "model_tflops",
                                 "model_mfu_pct_nominal_peak",
                                 "trace_error")},
          "nominal_peak": out["config"]["nominal_peak"]["name"],
          "device_tracks": device.get("tracks"),
          "device_busy_pct": device.get("busy_pct"),
          "device_busy_ms": device.get("busy_ms"),
          "window_ms": device.get("window_ms"),
          "family_ms": device.get("family_ms"),
          "top_kernels_ms": {k[:90]: v for k, v in
                             (device.get("top_kernels_ms") or {}).items()},
          "self_time": out["device_self_time_by_hlo_category"],
          "seconds": sec, "launches": launches, "k1_expected": k1_want,
          "gpu": power})
    check(out["trace_error"] is None,
          f"profile.production: the trace failed: {out['trace_error']}")
    check(device.get("events", 0) > 0,
          "profile.production: no device event in the trace")
    check(device["family_ms"].get("K1 rotation_s", 0.0) > 0.0,
          "profile.production: K1 is not on the device's tracks")
    check(all("stream" in t.lower() for t in device["tracks"]),
          f"profile.production: device tracks {device['tracks']} are not "
          "CUDA stream tracks")
    check(np.isfinite(out["traj_per_sec"]) and np.isfinite(out["acceptance"]),
          "profile.production: non-finite traj/s or acceptance")
    check(launches["rotation_s_parts"] == k1_want,
          f"profile.production: {launches['rotation_s_parts']} K1 launches, "
          f"the schedule implies {k1_want}")
    return launches


def bench_kernels_phase(dev, power: str) -> dict:
    """``bench_kernels`` at L = 24, batch 8, 3 reps: exit code 0 (no row
    failed), every row printed; K1 in the tracked refinement rows."""
    from dwavehmc_tpu_torch.drivers import bench_kernels as bk

    argv = ["--device", dev.type, "--L", str(L_MAIN), "--batch", "8",
            "--reps", "3"]
    (_, lines), launches, sec = _counted(
        lambda: _stdout_lines(lambda: bk.main(argv)))
    # n_iter = 1, 4, 8, each called once to warm up and 3 times timed
    k1_want = (1 + 3) * (1 + 4 + 8)
    emit({"phase": "bench.kernels", "argv": argv[2:], "rows": lines,
          "seconds": sec, "launches": launches, "k1_expected": k1_want,
          "gpu": power})
    check(len(lines) == 11 and not any("FAILED" in ln for ln in lines),
          "bench.kernels: a row is missing or failed")
    check(launches["rotation_s_parts"] == k1_want,
          f"bench.kernels: {launches['rotation_s_parts']} K1 launches, "
          f"expected {k1_want}")
    return launches


def bench_forces_phase(dev, power: str) -> dict:
    """``bench_forces`` at L = 24 in float32: the two formulations agree
    (``OK``); their times printed."""
    from dwavehmc_tpu_torch.drivers import bench_forces as bf

    argv = ["--device", dev.type, "--L", str(L_MAIN), "--dtype", "float32"]
    (_, lines), launches, sec = _counted(
        lambda: _stdout_lines(lambda: bf.main(argv)))
    emit({"phase": "bench.forces", "argv": argv[2:], "lines": lines,
          "seconds": sec, "launches": launches, "gpu": power})
    check(lines[0].endswith(" OK"), f"bench.forces: {lines[0]}")
    return launches


def spectra_parity_phase(dev, power: str) -> dict:
    """``spectra_parity_production`` on the three checkpoint chains at
    24×24: ``pass`` true at the script's tolerances, each observable's
    error relative to its peak printed; K2 twice a chain (the production
    leg's σ_DC and σ(ω); the float64 oracle leg runs the plain sums)."""
    from dwavehmc_tpu_torch.drivers import spectra_parity_production as spp

    out, launches, sec = _counted(lambda: spp.parity(
        spp.CHECKPOINT, dev, log=lambda m: print(m, file=sys.stderr)))
    os.makedirs(TOOLS_DIR, exist_ok=True)
    with open(os.path.join(TOOLS_DIR, "spectra_parity_24x24.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    emit({"phase": "spectra.parity_production", "pass": out["pass"],
          "chains": [{"chain": r["chain"],
                      "eigh_evals_rel": r["eigh_evals"]["max_abs"]
                      / r["eigh_evals"]["scale"],
                      "rel_to_peak": {k: r[k]["rel_to_peak"]
                                      for k in spp.OBSERVABLES},
                      "rho_s": [r["superfluid_stiffness"]["production"],
                                r["superfluid_stiffness"]["oracle"]],
                      "f_sum": r["f_sum"]} for r in out["chains"]],
          "tolerances": out["tolerances"], "seconds": sec,
          "launches": launches, "gpu": power})
    check(out["pass"], "spectra.parity_production: outside the tolerances")
    check(launches["weighted_lorentzian_sum"] == 2 * len(out["chains"]),
          f"spectra.parity_production: {launches['weighted_lorentzian_sum']}"
          " K2 launches, expected 2 a chain")
    return launches


def ab_rotation_phase(dev, power: str) -> dict:
    """``ab_rotation`` at 24×24 cut by ``AB_CUT``, variants baseline and
    exp2_ph: every row has the JAX script's keys and finite numbers, no
    variant failed, K1 launched."""
    from dwavehmc_tpu_torch.drivers import ab_rotation as abr

    kn = dict(abr.knobs({}), L=L_MAIN, **AB_CUT)
    out, launches, sec = _counted(lambda: abr.ab_rotation(
        kn, abr.select(AB_VARIANTS), dev,
        log=lambda m: print(m, file=sys.stderr)))
    emit({"phase": "ab.rotation", "config": out["config"],
          "results": out["results"], "seconds": sec, "launches": launches,
          "gpu": power})
    for row in out["results"]:
        check(set(row) == AB_ROW_KEYS, f"ab.rotation: {row['variant']} "
              f"keys {sorted(set(row) ^ AB_ROW_KEYS)} differ")
        check(all(np.isfinite(row[k]) for k in AB_ROW_KEYS
                  if isinstance(row[k], float)),
              f"ab.rotation: {row['variant']} has a non-finite number")
    check([r["variant"] for r in out["results"]] == AB_VARIANTS.split(","),
          "ab.rotation: variants missing")
    check(launches["rotation_s_parts"] > 0, "ab.rotation: K1 not launched")
    return launches


def audit_rhos_dip_phase(dev, power: str) -> dict:
    """``audit_rhos_dip`` at its 12×12 width (complex float64 on the card,
    3 β × 3 replicas), cut by ``AUDIT_CUT``: the report is written and its
    f-sum numbers are finite; the verdict is printed (this depth cannot
    decide it)."""
    from dwavehmc_tpu_torch.drivers import audit_rhos_dip as audit

    out = os.path.join(TOOLS_DIR, "rhos_dip_audit.json")
    argv = ["--device", dev.type, "--root",
            os.path.join(TOOLS_DIR, "rhos_dip_audit_f64"), "--out", out]
    saved = {k: os.environ.get(k) for k in AUDIT_CUT}
    os.environ.update(AUDIT_CUT)
    try:
        (rep, _), launches, sec = _counted(
            lambda: _stdout_lines(lambda: audit.main(argv)))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    fs = rep["f_sum_check"]["points"]
    emit({"phase": "audit.rhos_dip", "cut": AUDIT_CUT,
          "dip_is_physics_at_this_depth": rep["dip_is_physics"],
          "points": {b: {k: p[k] for k in ("rho_s_gap", "combined_sem",
                                           "agree")}
                     | {"f64_rho_s": p["f64_oracle"]["rho_s"],
                        "f32_rho_s": p["f32_production"]["rho_s"],
                        "f64_acceptance": p["f64_oracle"]["acceptance"]}
                     for b, p in rep["points"].items()},
          "f_sum": {b: {g: r[g]["rel_err"] for g in r}
                    for b, r in fs.items()},
          "seconds": sec, "launches": launches, "gpu": power})
    check(os.path.exists(out), "audit.rhos_dip: no report written")
    check(all(np.isfinite(r[g][k]) for r in fs.values() for g in r
              for k in ("s_grid", "s_pred_pi_lambda", "rel_err")),
          "audit.rhos_dip: a non-finite f-sum number")
    check(launches["weighted_lorentzian_sum"] > 0,
          "audit.rhos_dip: K2 not launched")
    return launches


def debug_transport_phase(dev, power: str) -> None:
    """``debug_transport`` at its defaults (8×8, float64), then the clean
    normal state (``--delta 0``): ρ_s within ``DRUDE_TOL`` of the analytic
    Drude weight."""
    from dwavehmc_tpu_torch.drivers import debug_transport as dbg

    runs = {}
    for extra in ([], ["--delta", "0"]):
        lines = []
        terms = dbg.inspect(dbg.parser().parse_args(
            ["--device", dev.type, *extra]), out=lines.append)
        runs[" ".join(extra) or "defaults"] = {"lines": lines, **terms}
    emit({"phase": "debug.transport", "runs": runs, "gpu": power})
    diff = runs["--delta 0"]["drude_diff"]
    check(diff <= DRUDE_TOL, f"debug.transport: ρ_s is {diff:.2e} off the "
          "analytic Drude weight")


# --- the headline benchmark ---------------------------------------------------

#: ``drivers/bench`` at its full widths (16×16 at 8 chains, 64 × 24×24,
#: 40 × 32×32), its depth cut from the JAX script's 10 therm sweeps and 3
#: reps of 20-sweep segments to 2 and 1 of 2, and each shape leg's from 6
#: (capacity 2) therm sweeps and 2 (1) reps of 10-sweep (4-sweep) segments
#: to 2 and 1 of 2
BENCH_CUT = {"BENCH_THERM": "2", "BENCH_SWEEPS": "2", "BENCH_REPS": "1"}
BENCH_LEG_CUT = dict(n_therm_p=2, n_sweeps=2, reps_p=1)


def bench_rotations(kn: dict, legs: tuple) -> int:
    """K1 launches of ``drivers/bench.bench`` at knobs ``kn`` and shape legs
    ``legs`` (their ``shape_leg`` keyword arguments): the therm's and every
    tracked segment's rotations; the exact mode, the inits and the eigh
    figures launch none."""
    tr, K = kn["tracked_iters"], kn["anchor_every"]
    fast = dict(tracked=tr, refine=kn["refine_iters"],
                polish=kn["polish_iters"])
    total = expected_rotations(kn["therm"], 1, kn["nt_therm"], 6)
    segs = 1 + kn["reps"]
    for mode in kn["modes"]:
        if mode == "tracked":
            total += segs * expected_rotations(kn["sweeps"], 1, kn["Nt"], tr)
        elif mode == "tracked_fast":
            total += segs * expected_rotations(kn["sweeps"], K, kn["Nt"],
                                               **fast)
    for leg in legs:
        nt_th = leg.get("nt_therm") or kn["nt_therm"]
        total += expected_rotations(leg["n_therm_p"], 1, nt_th, tr)
        total += (1 + leg["reps_p"]) * expected_rotations(
            leg["n_sweeps"], K, leg["Ntp"], **fast)
    return total


def bench_phase(dev, power: str) -> dict:
    """``drivers/bench.bench`` (``BENCH_CUT``, ``BENCH_LEG_CUT``): the
    16×16 headline with its three modes and the eigh figures, the
    production leg (64 × 24×24) and the capacity leg (40 × 32×32).  Every
    mode and leg finite traj/s and an acceptance in [0, 1], no error, K1 on
    the schedule, no K2; the PH guard's fallbacks and rescues reported."""
    from dwavehmc_tpu_torch.drivers import bench as tb
    from dwavehmc_tpu_torch.ops import ph_eigh

    kn = tb.knobs(BENCH_CUT)
    legs = (dict(tb.PRODUCTION, **BENCH_LEG_CUT),
            dict(tb.CAPACITY, **BENCH_LEG_CUT))
    ph_eigh.reset_guard()
    (line, errors), launches, sec = _counted(
        lambda: tb.bench(kn, dev, *legs))
    k1_want = bench_rotations(kn, legs)
    emit({"phase": "bench", "line": line, "seconds": sec,
          "cut": {"knobs": BENCH_CUT, "legs": BENCH_LEG_CUT},
          "launches": launches, "k1_schedule": k1_want,
          "guard": dict(ph_eigh.GUARD), "gpu": power})
    check(not errors, f"bench: {errors}")
    rows = dict(line["modes"])
    rows.update((k, line[k]) for k in ("production_24x24_b64",
                                       "capacity_32x32_b40"))
    check(set(rows) == {"exact", "tracked", "tracked_fast",
                        "production_24x24_b64", "capacity_32x32_b40"},
          f"bench: modes and legs {sorted(rows)}")
    for name, r in rows.items():
        check(np.isfinite(r["traj_per_sec"]) and r["traj_per_sec"] > 0
              and 0.0 <= r["acceptance"] <= 1.0,
              f"bench {name}: traj/s {r['traj_per_sec']}, acceptance "
              f"{r['acceptance']}")
    check(launches["rotation_s_parts"] == k1_want,
          f"bench: {launches['rotation_s_parts']} K1 launches, the schedule "
          f"gives {k1_want}")
    check(launches["weighted_lorentzian_sum"] == 0, "bench launched K2")
    return launches


def tools_phases(dev, power: str) -> dict:
    """The measurement and audit tools; their kernel launches summed."""
    total = {}
    for phase in (profile_production_phase, bench_kernels_phase,
                  bench_forces_phase, spectra_parity_phase,
                  ab_rotation_phase, audit_rhos_dip_phase):
        for name, n in phase(dev, power).items():
            total[name] = total.get(name, 0) + n
    debug_transport_phase(dev, power)
    return total




#: the tracked path at long rows (ROADMAP fault F7): 46×46, 2N = 4232, 2
#: chains at the production couplings at β = 10 (the bench's) and 20
#: (config 5's), Nt = 2, K = 2 (one cheap and one anchored sweep) with
#: the PH anchor and exp2 rotations
LARGE_L = 46
LARGE = dict(chains=2, betas=(10.0, 20.0), Nt=2, sweeps=2, K=2)


def large_lattice_phase(dev, power: str) -> dict:
    """``init_ensemble_real`` (the guarded PH solve), a 2-sweep
    ``run_segment_tracked`` and one ``ensemble_transport_real`` pass at
    46×46 on the card, the counts reset before and read after: K1 on the
    schedule, K2 twice, K3 launched, K5 once a rotation; every dH,
    observable, state and transport output finite; the allocator's peak
    and the seconds printed."""
    from dwavehmc_tpu_torch.models.lattice import LatticeSpec
    from dwavehmc_tpu_torch.models.params import make_params
    from dwavehmc_tpu_torch.ops import ph_eigh
    from dwavehmc_tpu_torch.parallel.ensemble import (
        ensemble_transport_real,
        init_ensemble_real,
        run_segment_tracked,
    )
    from dwavehmc_tpu_torch.sampler.hmc import calc_optimal_dt

    lat = LatticeSpec(LARGE_L, LARGE_L)
    spec = production_spec(lat)
    betas = list(LARGE["betas"])
    params = make_params(beta=betas, dtype=torch.float32, device=dev,
                         **PHYS)
    dt = torch.tensor([calc_optimal_dt(b, PHYS["J"], PHYS["mass"],
                                       LARGE["Nt"]) for b in betas],
                      device=dev)
    track = dict(TRACK, exact_solver="ph")
    gen = torch.Generator(device=dev).manual_seed(LARGE_L)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ph_eigh.reset_guard()

    def run():
        st = init_ensemble_real(lat, params, gen, LARGE["chains"],
                                dtype=torch.float32, n_imp=PHYS["n_imp"],
                                exact_solver="ph", device=dev)
        st, seg = run_segment_tracked(lat, params, st, LARGE["sweeps"],
                                      LARGE["Nt"], dt, True,
                                      anchor_every=LARGE["K"], generator=gen,
                                      **track)
        torch.cuda.synchronize()
        t_seg = time.perf_counter()
        res = ensemble_transport_real(lat, spec, params, st)
        torch.cuda.synchronize()
        return st, seg, res, time.perf_counter() - t_seg

    (states, seg, res, transport_s), launches, sec = _counted(run)
    peak = torch.cuda.max_memory_allocated(dev)
    k1_want = expected_rotations(LARGE["sweeps"], LARGE["K"], LARGE["Nt"])
    emit({"phase": "tracked.large_lattice", "lattice": [LARGE_L, LARGE_L],
          "embedding": 4 * lat.n_sites, **LARGE, "seconds": sec,
          "transport_seconds": transport_s,
          "max_memory_allocated_gib": peak / 2**30,
          "accepted": seg.accepted.int().tolist(), "dH": seg.dH.tolist(),
          "stiffness": res.superfluid_stiffness.tolist(),
          "launches": launches, "k1_schedule": k1_want,
          "guard": dict(ph_eigh.GUARD), "gpu": power})
    check(launches["rotation_s_parts"] == k1_want,
          f"large lattice: {launches['rotation_s_parts']} K1 launches, the "
          f"schedule gives {k1_want}")
    check(launches["weighted_lorentzian_sum"] == 2,
          f"large lattice: {launches['weighted_lorentzian_sum']} K2 "
          "launches, expected 2")
    check(launches["sigma_cap"] == k1_want,
          f"large lattice: {launches['sigma_cap']} K5 launches, expected "
          f"one a rotation ({k1_want})")
    check(launches["chain_sum"] > 0, "large lattice: chain_sum not launched")
    check(bool(torch.isfinite(seg.dH).all()), f"large lattice: dH {seg.dH}")
    _finite(seg.observables, "large_lattice.observables")
    _finite(states, "large_lattice.state")
    _finite(res, "large_lattice.transport")
    check(tuple(res.optical_conductivity.shape)
          == (LARGE["chains"], spec.n_omega), "large lattice: sigma shape")
    del states, seg, res
    torch.cuda.empty_cache()
    return launches


#: the fast mix (``hmc_bench/traffic/fast.json``) as the cheap sweep runs it
FAST_TRACK = dict(tracked_iters=6, refine_iters=6, polish_iters=3,
                  ns_steps=1, rot_dtype=torch.bfloat16,
                  polish_precision="highest", polish_correction=False,
                  rot_scheme="exp2", exact_solver="ph")
#: (L, chains) of the cheap sweeps timed eager against graph, around the
#: gate's threshold on B·(2N)² (2.1 M at 16×16/b8, 10.6 M at 24×24/b8)
GRAPH_SHAPES = ((16, 8), (16, 16), (24, 4), (24, 8), (24, 16), (24, 64))
GRAPH_K = 10


def _graph_periods(dev, lat, B: int):
    """Two anchor periods (K = 10) of the fast mix at β 10 then 12 from
    one guarded-PH start: a function that runs them, [(SegmentResult,
    end state)] each."""
    from dwavehmc_tpu_torch.models.params import make_params
    from dwavehmc_tpu_torch.parallel.ensemble import (
        init_ensemble_real,
        run_segment_tracked,
    )
    from dwavehmc_tpu_torch.sampler.hmc import calc_optimal_dt

    K = GRAPH_K
    g = torch.Generator(device=dev).manual_seed(1717)
    p0 = make_params(beta=10.0, dtype=torch.float32, device=dev, **PHYS)
    s0 = init_ensemble_real(lat, p0, g, B, dtype=torch.float32,
                            n_imp=PHYS["n_imp"], exact_solver="ph",
                            device=dev)
    nrm = torch.randn((2 * K, B, 2, lat.n_sites, 2), generator=g, device=dev)
    u = torch.rand((2 * K, B), generator=g, device=dev)

    def run():
        s, out = s0, []
        for k, beta in enumerate((10.0, 12.0)):
            p = make_params(beta=beta, dtype=torch.float32, device=dev,
                            **PHYS)
            s, seg = run_segment_tracked(
                lat, p, s, K, 6, calc_optimal_dt(beta, PHYS["J"],
                                                 PHYS["mass"], 6),
                False, anchor_every=K, normals=nrm[k * K:(k + 1) * K],
                uniforms=u[k * K:(k + 1) * K], **FAST_TRACK)
            out.append((seg, s))
        return out
    return run


def _memory_counted(fn):
    """(``_counted(fn)``, peak allocated, peak reserved) from an emptied
    cache and reset peaks."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = _counted(fn)
    return out, torch.cuda.max_memory_allocated(), \
        torch.cuda.max_memory_reserved()


def _bit_diff(eager, graph) -> dict:
    """Where two runs' records and end states differ, and by how much."""
    out = {"equal": True, "dH_max_abs": 0.0, "accept_flips": 0,
           "state_max_abs": 0.0}
    for (se, xe), (sg, xg) in zip(eager, graph):
        out["equal"] &= bool(torch.equal(se.dH, sg.dH)
                             and torch.equal(se.accepted, sg.accepted)
                             and all(torch.equal(a, b)
                                     for a, b in zip(xe, xg)))
        out["dH_max_abs"] = max(out["dH_max_abs"],
                                float((se.dH - sg.dH).abs().max()))
        out["accept_flips"] += int((se.accepted != sg.accepted).sum())
        out["state_max_abs"] = max(out["state_max_abs"], *(
            float((a - b).abs().max()) for a, b in zip(xe, xg)))
    return out


def _traced_kernels(fn) -> dict:
    """What a ``torch.profiler`` trace of ``fn()`` shows on the device: its
    kernels' count, by ``analyze_trace`` family their count and
    milliseconds, and by name their count; its memcpy events' count."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from dwavehmc_tpu_torch.drivers import analyze_trace as at

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        events = at.load_events(path)
    fam: dict = {}
    names: dict = {}
    n = copies = 0
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            n += 1
            rec = fam.setdefault(at.family(e["name"]), [0, 0.0])
            rec[0] += 1
            rec[1] += float(e.get("dur", 0.0)) * 1e-3
            names[e["name"][:100]] = names.get(e["name"][:100], 0) + 1
        copies += e.get("ph") == "X" and e.get("cat") == "gpu_memcpy"
    return {"kernels": n, "memcpy": copies, "families": fam,
            "names": names}


def _cheap_timings(dev, L: int, B: int, reps: int) -> dict:
    """Milliseconds a cheap sweep of the fast mix takes at (L, B), eager
    and as a graph replay (host clock, synchronized), the capture's
    seconds and the graph's private pool."""
    from dwavehmc_tpu_torch.models.lattice import LatticeSpec
    from dwavehmc_tpu_torch.models.params import make_params
    from dwavehmc_tpu_torch.parallel import cheap_graph as cg
    from dwavehmc_tpu_torch.parallel.ensemble import init_ensemble_real
    from dwavehmc_tpu_torch.sampler.hmc import calc_optimal_dt
    from dwavehmc_tpu_torch.sampler.hmc_real import device_step

    lat = LatticeSpec(L, L)
    spec = cg.CheapSpec(6, *(FAST_TRACK[k] for k in cg.CheapSpec._fields[1:]))
    g = torch.Generator(device=dev).manual_seed(L * 1000 + B)
    p = make_params(beta=10.0, dtype=torch.float32, device=dev, **PHYS)
    s = init_ensemble_real(lat, p, g, B, dtype=torch.float32,
                           n_imp=PHYS["n_imp"], exact_solver="ph",
                           device=dev)
    n = torch.randn((B, 2, lat.n_sites, 2), generator=g, device=dev)
    u = torch.rand((B,), generator=g, device=dev)
    dt = device_step(calc_optimal_dt(10.0, PHYS["J"], PHYS["mass"], 6),
                     s.evals)

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0), out

    new = cg.eager_sweep(lat, spec, p, s, dt, n, u)[0]
    eager = [wall(lambda: cg.eager_sweep(lat, spec, p, s, dt, n, u))[0]
             for _ in range(reps)]
    del new
    torch.cuda.empty_cache()
    new = cg.eager_sweep(lat, spec, p, s, dt, n, u)[0]
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    capture_ms, graph = wall(lambda: cg.CheapGraph.capture(
        lat, spec, p, new, dt, n, u))
    pool = torch.cuda.memory_reserved() - reserved
    state, replay = graph.state, []
    for _ in range(reps):
        ms, (state, *_) = wall(lambda: graph.replay(p, state, dt, n, u))
        replay.append(ms)
    out = {"L": L, "chains": B, "work": B * (2 * lat.n_sites) ** 2,
           "eager_ms": eager, "graph_ms": replay,
           "eager_median_ms": float(np.median(eager)),
           "graph_median_ms": float(np.median(replay)),
           "capture_ms": capture_ms, "pool_reserved_gib": pool / 2**30,
           "gate_on": cg.graph_worthwhile(B, 2 * lat.n_sites)}
    out["graph_over_eager"] = out["graph_median_ms"] / out["eager_median_ms"]
    del graph, state, new, s
    torch.cuda.empty_cache()
    return out


def graph_cheap_sweep_phase(dev, power: str) -> dict:
    """``parallel/cheap_graph``: two anchor periods of the fast mix at
    16×16 with 8 chains (β 10, then 12), eager (the gate closed) and
    through the graph (a warm-up sweep, its capture, 17 replays), then the
    graph again from its cache: dH, accept flags and end states bit-equal
    (a difference fails the phase; its size is reported), ``LAUNCHES`` equal,
    peak allocated and reserved of each; the kernels a traced replay shows
    by family beside a traced eager sweep's; then a cheap sweep's
    milliseconds, eager against graph, at ``GRAPH_SHAPES``, which set the
    gate's threshold."""
    from dwavehmc_tpu_torch.models.lattice import LatticeSpec
    from dwavehmc_tpu_torch.models.params import make_params
    from dwavehmc_tpu_torch.parallel import cheap_graph as cg
    from dwavehmc_tpu_torch.sampler.hmc import calc_optimal_dt
    from dwavehmc_tpu_torch.sampler.hmc_real import device_step

    lat, B = LatticeSpec(16, 16), N_CHAINS
    run = _graph_periods(dev, lat, B)
    cg.reset_graphs()
    gate = cg.use_graph
    cg.use_graph = lambda states: False     # the eager reference
    try:
        (eager, l_eager, s_eager), a_eager, r_eager = _memory_counted(run)
    finally:
        cg.use_graph = gate
    counts = dict(cg.COUNTS)
    (graph, l_graph, s_graph), a_graph, r_graph = _memory_counted(run)
    counts = {k: cg.COUNTS[k] - n for k, n in counts.items()}
    (again, l_again, s_again), a_again, r_again = _memory_counted(run)
    diff, diff_again = _bit_diff(eager, graph), _bit_diff(eager, again)

    # one more cheap sweep from the last state, traced: eager, then replayed
    spec = cg.CheapSpec(6, *(FAST_TRACK[k] for k in cg.CheapSpec._fields[1:]))
    p = make_params(beta=12.0, dtype=torch.float32, device=dev, **PHYS)
    st = graph[-1][1]
    dt = device_step(calc_optimal_dt(12.0, PHYS["J"], PHYS["mass"], 6),
                     st.evals)
    gen = torch.Generator(device=dev).manual_seed(99)
    traced_eager = _traced_kernels(lambda: cg.eager_sweep(
        lat, spec, p, st, dt, generator=gen))
    traced_graph = _traced_kernels(lambda: cg.cheap_sweep(
        lat, spec, p, st, dt, generator=gen))
    # kernels whose count differs between the traced replay and eager sweep
    names_e, names_g = traced_eager.pop("names"), traced_graph.pop("names")
    traced_graph["kernels_not_in_eager"] = {
        k: names_g.get(k, 0) - names_e.get(k, 0)
        for k in set(names_e) | set(names_g)
        if names_g.get(k, 0) != names_e.get(k, 0)}
    emit({"phase": "graph.cheap_sweep", "lattice": [16, 16], "chains": B,
          "K": GRAPH_K, "periods": 2, "bits": diff,
          "bits_from_cache": diff_again, "counts": counts,
          "launches": {"eager": l_eager, "graph": l_graph,
                       "cached": l_again},
          "seconds": {"eager": s_eager, "graph": s_graph,
                      "cached": s_again},
          "max_memory_allocated_gib": {"eager": a_eager / 2**30,
                                       "graph": a_graph / 2**30,
                                       "cached": a_again / 2**30},
          "max_memory_reserved_gib": {"eager": r_eager / 2**30,
                                      "graph": r_graph / 2**30,
                                      "cached": r_again / 2**30},
          "traced_sweep": {"eager": traced_eager, "graph": traced_graph},
          "gpu": power})
    check(counts["captures"] == 1 and counts["capture_failures"] == 0
          and counts["replays"] == 2 * (GRAPH_K - 1) - 1,
          f"graph.cheap_sweep: counts {counts}")
    check(diff["equal"] and diff_again["equal"],
          f"graph.cheap_sweep: graph against eager {diff}, from the cache "
          f"{diff_again}")
    check(l_eager == l_graph == l_again,
          f"graph.cheap_sweep: launches eager {l_eager}, graph {l_graph}, "
          f"cached {l_again}")
    for seg, _ in graph + again:
        check(bool(torch.isfinite(seg.dH).all()),
              f"graph.cheap_sweep: dH {seg.dH}")
    cg.reset_graphs()
    del eager, graph, again, st
    torch.cuda.empty_cache()

    rows = [_cheap_timings(dev, L, b, 3 if b * L * L > 10000 else 5)
            for L, b in GRAPH_SHAPES]
    emit({"phase": "graph.cheap_sweep.timings", "rows": rows,
          "threshold": cg.GRAPH_MAX_WORK, "gpu": power})
    launches = dict(l_eager)
    for k, n in l_graph.items():
        launches[k] += n + l_again[k]
    return launches


#: the graft dry run's ranks, all on the card
GRAFT_RANKS = 2


def graft_entry_phase(dev, power: str) -> dict:
    """``graft_entry.entry()`` on the card, its sweep run twice with finite
    output, then ``dryrun_multichip(2)`` with both ranks on the card under
    its own limit (``graft_entry.DRYRUN_SECONDS``, which kills the ranks'
    process groups).  Returns the
    launches of the entry's sweeps and of every rank's dry run."""
    from dwavehmc_tpu_torch import graft_entry

    def sweeps():
        fn, args = graft_entry.entry()
        check(args[1].delta_re.device.type == "cuda",
              "graft.entry: the state is not on the card")
        return [fn(*args) for _ in range(2)]

    outs, launches, sec = _counted(sweeps)
    emit({"phase": "graft.entry", "seconds": sec,
          "delta_shape": list(outs[0][0].shape),
          "dH": [dH.tolist() for _delta, dH in outs], "launches": launches,
          "gpu": power})
    for delta, dH in outs:
        check(bool(torch.isfinite(delta).all() & torch.isfinite(dH).all()),
              f"graft.entry: Δ or dH not finite (dH {dH.tolist()})")
    check(launches["chain_sum"] > 0, "graft.entry: chain_sum not launched")

    t0 = time.perf_counter()
    reports = graft_entry.dryrun_multichip(GRAFT_RANKS)
    sec = time.perf_counter() - t0
    total = dict(launches)
    for r in reports:
        for name, n in r["launches"].items():
            total[name] += n
    emit({"phase": "graft.dryrun_multichip", "ranks": GRAFT_RANKS,
          "seconds": sec, "reports": [{k: r[k] for k in (
              "rank", "device", "rows", "rows_2d", "impurities",
              "collectives", "launches")} for r in reports], "gpu": power})
    for r in reports:
        check(r["device"].startswith("cuda"),
              f"graft.dryrun rank {r['rank']} ran on {r['device']}")
        check(all(n > 0 for n in r["impurities"] + r["impurities_2d"]),
              f"graft.dryrun rank {r['rank']}: a chain without disorder "
              f"({r['impurities']}, {r['impurities_2d']})")
        for name in PATH_KERNELS:
            check(r["launches"][name] > 0,
                  f"graft.dryrun rank {r['rank']}: {name} not launched")
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA device", file=sys.stderr)
        return 2
    from dwavehmc_tpu_torch.ops import kernels

    # only quickcheck_phase runs the quick tier; no driver launch may
    os.environ["SKIP_QUICK_TESTS"] = "1"
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
    table.update(chain_kernel_phases(dev, power))
    table.update(sigma_cap_phase(dev, power))
    table.update(bdg_hop_phase(dev, power))
    anchor_phases(dev, gen, power)
    ph_draws_phase(dev, power)
    diverged_chain_phase(dev, power)
    for solver in ("qdwh", "ph"):
        reference_phase(dev, args.seed, solver)
    launches = main_path(dev, args.seed, power)
    for name in PATH_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the main path")
    scan_launches, vec = scan_phases(dev, power)
    for name, n in scan_launches.items():
        check(n > 0 or name not in PATH_KERNELS,
              f"kernel {name} was not launched by the scan")
        launches[name] += n
    reference_complex_phase(dev, args.seed)
    # path B (complex) launches K2 only; path A (host readout) both kernels
    for phase, path_kernels in ((simulation_complex_phase,
                                 ("weighted_lorentzian_sum",)),
                                (scan_host_readout_phase,
                                 ("rotation_s_parts",
                                  "weighted_lorentzian_sum")),
                                (scan_serial_phase,
                                 ("weighted_lorentzian_sum",))):
        counts = phase(dev, power)
        for name in path_kernels:
            check(counts[name] > 0, f"kernel {name} was not launched by "
                  f"{phase.__name__}")
        for name, n in counts.items():
            launches[name] += n
    # the sharded phases start W processes on the card: leave them room
    torch.cuda.empty_cache()
    W = ranks_for_sharding()
    scan_sharded_equal_phase(dev, power, W)
    for name, n in scan_sharded_phase(dev, power, W, vec).items():
        check(n > 0 or name not in PATH_KERNELS,
              f"kernel {name} was not launched by scan.sharded")
        launches[name] += n
    for name, n in scan_beta_phase(dev, power, W).items():
        launches[name] += n
    for counts in (bcs_clean_phases(dev, power),
                   tracked_eigh_phase(dev, gen, power),
                   bcs_beta_scan_phase(dev, power)):
        for name, n in counts.items():
            launches[name] += n
    ph_lift_phase(dev, gen, power)
    for counts in (validate_cheap_anchor_phase(dev, power),
                   validate_polish_phase(dev, power),
                   beta_extreme_phase(dev, power),
                   beta_dt_and_tune_phases(dev, power)):
        for name, n in counts.items():
            launches[name] += n
    for counts in (config5_card_phase(dev, power),
                   config5_demo32_phase(dev, power),
                   probe_fullspec_phase(dev, power),
                   config5_replay_phase(dev, power)):
        for name, n in counts.items():
            launches[name] += n
    torch.cuda.empty_cache()
    for name, n in config5_mesh_exec_phase(dev, power, W).items():
        launches[name] += n
    for name, n in tools_phases(dev, power).items():
        launches[name] += n
    for name, n in bench_phase(dev, power).items():
        launches[name] += n
    for name, n in large_lattice_phase(dev, power).items():
        check(n > 0 or name not in PATH_KERNELS,
              f"kernel {name} was not launched by tracked.large_lattice")
        launches[name] += n
    for name, n in graft_entry_phase(dev, power).items():
        launches[name] += n
    for name, n in graph_cheap_sweep_phase(dev, power).items():
        launches[name] += n
    postprocess_cli_phase(power)
    quickcheck_phase(power)
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
        # K3 and K5 replace no TPU kernel: they fix the order of XLA's
        # per-chain reductions at these lines of the JAX package
        dict(name="chain_sum", route="cuda",
             source="dwavehmc_tpu_torch/csrc/chain_sum.cu",
             replaces="dwavehmc_tpu/sampler/hmc_real.py:94",
             launches=launches["chain_sum"], **table["chain_sum"]),
        dict(name="sigma_cap", route="cuda",
             source="dwavehmc_tpu_torch/csrc/sigma_cap.cu",
             replaces="dwavehmc_tpu/ops/tracked_eigh.py:49-65",
             launches=launches["sigma_cap"], **table["sigma_cap"]),
        # K6 replaces no TPU kernel: XLA's dense H·U multiplies H's zeros
        dict(name="bdg_hop", route="cuda",
             source="dwavehmc_tpu_torch/csrc/bdg_hop.cu",
             replaces="dwavehmc_tpu/ops/tracked_eigh.py:112",
             launches=launches["bdg_hop"], **table["bdg_hop"]),
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
