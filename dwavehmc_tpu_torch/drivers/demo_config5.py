"""BASELINE config 5: the disorder-averaged 32×32 ensemble, ≥ 64
realizations (port of ``scripts/demo_config5.py``).

    python -m dwavehmc_tpu_torch.drivers.demo_config5 --mode card
        [--batch 48] [--sweeps 10] [--therm 10] [--warmup 2] [--L 32]
        [--device cuda|cpu] [--out runs/config5_tpu_32x32.json]
    python -m torch.distributed.run --standalone --nproc_per_node W \\
        -m dwavehmc_tpu_torch.drivers.demo_config5 --mode {mesh,mesh_exec,mesh64}
        [--dtype float32|float64]

Modes (each writes its JSON under ``runs/`` unless ``--out`` says
otherwise, with the JAX script's keys):

* ``card`` (``tpu`` is the same mode, under the JAX script's name): the
  one-card throughput at 32×32: ``init_ensemble_real`` in chunks of 8
  chains, ``--therm`` exact-anchored sweeps at Nt = 20, ``--warmup``
  sweeps and then ``--sweeps`` timed ones at Nt = 6 with an exact anchor
  every 5 sweeps (refine 12 / polish 4, float32 rotations).  Beside the
  formula's ``hbm_est_gib`` (``utils/memory.estimate_memory``) it writes
  the allocator's peak over the run, ``max_memory_allocated_gib``, and the
  count of non-finite dH by stage, ``nonfinite_dH``.
* ``mesh``: the 64-chain layout over W ≥ 2 ranks.  The JAX script's first
  part compiles the full-shape sharded programs without running them;
  eager PyTorch has no such step, so ``full_shape`` says so and lists
  nothing as compiled.  The second part runs 64 chains at 12×12 for 2
  sweeps (Nt = 4), each rank its block of chains
  (``parallel/mesh.process_batch_slice``), and asserts 64 distinct
  disorder realizations; the third reports ``estimate_memory`` and
  ``max_chains`` at 32×32 against the card's memory.
* ``mesh_exec``: the sharded ensemble at 32×32 (default 8 chains, 2
  cheap-anchor sweeps at Nt = 2) over W ≥ 2 ranks.
* ``mesh64``: 64 chains at 32×32 over W ≥ 2 ranks: the chunked init, one
  sweep at Nt = 1 (tracked 2, refine 2 / polish 1) and a transport pass on
  the coarse grid η = Δω = 0.05, ω_max = 2.

Under ranks the batch is padded to a multiple of W by repeating its last
chain; each rank draws the whole ensemble's disorder, Δ and sweep draws in
the one-process order and keeps its rows, so the ranks' ensemble is the
one-process ensemble.  Per-chain results are gathered over the process
group (gloo), and rank 0 writes the file.  ``--save_state`` writes the
gathered initial and final disorder and Δ, and the accepts and dH, as
``.npz``.  Run as a program, the quick tier (``utils/quickcheck``) runs
first.
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
from ..models.params import SpectralSpec, make_params
from ..parallel.ensemble import (
    DrawStream,
    ensemble_transport_real,
    init_ensemble_real,
    run_segment_tracked,
)
from ..parallel.mesh import (
    gather_global_batch,
    maybe_setup_distributed,
    process_batch_slice,
    rank_device,
    teardown_distributed,
    world,
)
from ..sampler.hmc import calc_optimal_dt
from ..utils.memory import device_memory, estimate_memory, max_chains
from ..utils.quickcheck import run_quick_suite

MODES = ("mesh", "mesh_exec", "mesh64", "tpu", "card")
DEFAULT_OUT = {"mesh": "config5_mesh_demo.json",
               "mesh_exec": "config5_mesh_exec.json",
               "mesh64": "config5_mesh_64.json",
               "tpu": "config5_tpu_32x32.json"}
#: the couplings of every mode (the JAX script's)
PHYS = dict(t=1.0, tp=-0.35, mu=-1.08, W=1.0, n_imp=0.05, beta=20.0, J=0.8,
            mass=1.0)
#: BASELINE config 5's lattice
L_FULL = 32
#: the seed of the run's generator (the JAX script's PRNGKey(0))
SEED = 0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Block(NamedTuple):
    """This rank's block of a batch padded to a multiple of the ranks."""

    rank: int
    n_ranks: int
    n_pad: int
    src: np.ndarray     # the global chain each of its rows runs


def rank_block(batch: int, min_ranks: int = 1) -> Block:
    """This rank's rows of ``batch`` chains; raises unless the job has at
    least ``min_ranks`` ranks."""
    rank, n = world()
    if n < min_ranks:
        raise RuntimeError(
            f"this mode needs at least {min_ranks} ranks, got {n}: run it "
            f"under python -m torch.distributed.run --nproc_per_node W")
    n_pad = -(-batch // n) * n
    rows = np.arange(n_pad)[process_batch_slice(n_pad)]
    return Block(rank, n, n_pad, np.minimum(rows, batch - 1))


def layout_label(blk: Block) -> str:
    """How the chain axis lies over the ranks, as a sharding's repr."""
    per = blk.n_pad // blk.n_ranks
    return (f"chain axis split over {blk.n_ranks} rank(s) in blocks of {per}"
            f" (padded to {blk.n_pad}): " + ", ".join(
                f"rank {r} → [{r * per}, {(r + 1) * per})"
                for r in range(blk.n_ranks)))


def gathered(blk: Block, batch: int, arrays, axis: int = 0) -> list:
    """Per-chain host arrays of every rank, the batch's chains in order
    (padding dropped); the same on every rank."""
    out = gather_global_batch([np.asarray(a) for a in arrays], axis=axis)
    return [np.take(x, np.arange(batch), axis=axis) for x in out]


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def setup(device, dtype=torch.float32):
    return make_params(dtype=dtype, device=device, **PHYS)


def init_block(lat, params, blk: Block, batch: int, device, *,
               dtype=torch.float32, init_chunk=None, init=None):
    """(states of this rank's rows, the generator after the draws of the
    initial ensemble).  ``init`` = (disorder, Δ_re, Δ_im) of the whole
    batch replaces the draws."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    given = {} if init is None else dict(zip(
        ("disorder", "delta0_re", "delta0_im"),
        (torch.as_tensor(np.asarray(x), device=device) for x in init)))
    states = init_ensemble_real(lat, params, gen, batch, dtype=dtype,
                                n_imp=PHYS["n_imp"], init_chunk=init_chunk,
                                rows=blk.src, device=device, **given)
    sync(device)
    return states, gen


def block_draws(stream: DrawStream, blk: Block, start: int, n: int):
    """Sweeps [start, start + n) of the whole batch's draws, this rank's
    rows."""
    normals, uniforms = stream.take(start, n)
    idx = torch.as_tensor(blk.src, device=normals.device)
    return normals[:, idx], uniforms[:, idx]


def n_distinct(disorder: np.ndarray) -> int:
    return len({d.tobytes() for d in disorder})


def _save_state(path, blk, batch, init_states, states, seg) -> None:
    if not path:
        return
    parts = gathered(blk, batch, [_np(x) for s in (init_states, states)
                                  for x in (s.disorder, s.delta_re,
                                            s.delta_im)])
    parts += gathered(blk, batch, [_np(seg.accepted), _np(seg.dH)], axis=1)
    if blk.rank == 0:
        names = [f"{w}_{x}" for w in ("init", "final")
                 for x in ("disorder", "delta_re", "delta_im")]
        np.savez(path, **dict(zip(names + ["accepted", "dH"], parts)))


def memory_plan(lat: LatticeSpec, device_bytes: int | None,
                n_ranks: int) -> dict:
    """``estimate_memory`` of 8 chains at ``lat`` and ``max_chains`` against
    ``device_bytes`` of card memory (None on the CPU: no card)."""
    est8 = estimate_memory(lat, 8)
    most = (None if device_bytes is None
            else max_chains(lat, device_bytes=device_bytes))
    card = ("no card (CPU run)" if device_bytes is None
            else f"{device_bytes / 2**30:.1f} GiB")
    return {"per_chain_mib": round(est8.per_chain_bytes / 2**20, 1),
            "chains_per_chip_8": round(est8.total_bytes / 2**30, 2),
            "max_chains_per_chip": most,
            "note": (f"estimate_memory: 8 chains of {lat.Lx}x{lat.Ly} per "
                     f"card need {est8.total_bytes / 2**30:.2f} GiB of "
                     f"{card}; 64 realizations over {n_ranks} rank(s) are "
                     f"{-(-64 // n_ranks)} chains per rank.  The formula "
                     "undercounts the allocator's peak (card mode prints "
                     "both).")}


def mesh_demo(out_path, device, *, batch: int = 64, L: int = 12,
              min_ranks: int = 2, dtype=torch.float32, init=None,
              stream=None, log=log) -> dict:
    """The layout over the ranks, a reduced-lattice run of ``batch``
    chains, and the memory plan at 32×32."""
    blk = rank_block(batch, min_ranks)
    report = {"devices": blk.n_ranks, "chains": batch,
              "leapfrog_compile_s": None, "accept_compile_s": None,
              "transport_compile_s": None}
    lat_full = LatticeSpec(L_FULL, L_FULL)
    report["full_shape"] = {
        "L": L_FULL, "chains": batch, "embedding_dim": 4 * lat_full.n_sites,
        "compiled": [],
        "note": ("eager PyTorch runs no ahead-of-time compile, so no "
                 "full-shape program is compiled here; the full shape runs "
                 "in the card and mesh64 modes")}

    params = setup(device, dtype)
    lat = LatticeSpec(L, L)
    t0 = time.time()
    st, gen = init_block(lat, params, blk, batch, device, dtype=dtype,
                         init=init)
    if stream is None:
        stream = DrawStream(gen, (batch, 2, lat.n_sites, 2), dtype, device)
    dt = torch.full((len(blk.src),), 0.02, dtype=dtype, device=device)
    normals, uniforms = block_draws(stream, blk, 0, 2)
    st, seg = run_segment_tracked(lat, params, st, 2, 4, dt, True,
                                  normals=normals, uniforms=uniforms)
    sync(device)
    dis = gathered(blk, batch, [_np(st.disorder)])[0]
    acc = gathered(blk, batch, [_np(seg.accepted)], axis=1)[0]
    distinct = n_distinct(dis)
    report["reduced_exec"] = {
        "L": L, "sweeps": 2, "acceptance": float(acc.mean()),
        "distinct_disorder_realizations": distinct,
        "wall_s": round(time.time() - t0, 1),
        "state_sharding": layout_label(blk)}
    assert distinct == batch, f"{distinct} distinct realizations of {batch}"
    log(f"reduced exec ok: acc={float(acc.mean()):.2f}")

    card = device_memory(device) if device.type == "cuda" else None
    report["hbm_plan"] = memory_plan(lat_full, card, blk.n_ranks)
    _write(out_path, blk, report)
    if blk.rank == 0:
        print(json.dumps({"config5_mesh_demo": "ok", **report["hbm_plan"]}))
    return report


def mesh_exec_demo(out_path, device, *, batch: int = 8, sweeps: int = 2,
                   L: int = L_FULL, min_ranks: int = 2, dtype=torch.float32,
                   init=None, stream=None, save_state=None,
                   log=log) -> dict:
    """``batch`` chains at ``L`` over the ranks: the init and ``sweeps``
    cheap-anchor sweeps at Nt = 2 (K = sweeps + 1: the last sweep of the
    segment is its only exact anchor)."""
    blk = rank_block(batch, min_ranks)
    params = setup(device, dtype)
    lat = LatticeSpec(L, L)
    t0 = time.time()
    st0, gen = init_block(lat, params, blk, batch, device, dtype=dtype,
                          init=init)
    t_init = time.time() - t0
    log(f"init done ({t_init:.0f}s)")
    if stream is None:
        stream = DrawStream(gen, (batch, 2, lat.n_sites, 2), dtype, device)
    Nt = 2
    dt = torch.full((len(blk.src),), calc_optimal_dt(20.0, 0.8, 1.0, 6),
                    dtype=dtype, device=device)
    t0 = time.time()
    normals, uniforms = block_draws(stream, blk, 0, sweeps)
    st, seg = run_segment_tracked(
        lat, params, st0, sweeps, Nt, dt, False, tracked_iters=6,
        anchor_every=sweeps + 1, refine_iters=12, polish_iters=4, ns_steps=2,
        normals=normals, uniforms=uniforms)
    sync(device)
    wall = time.time() - t0
    acc, dH = gathered(blk, batch, [_np(seg.accepted), _np(seg.dH)], axis=1)
    dis = gathered(blk, batch, [_np(st.disorder)])[0]
    _save_state(save_state, blk, batch, st0, st, seg)
    res = {"L": L, "batch": batch, "devices": blk.n_ranks, "sweeps": sweeps,
           "Nt": Nt, "acceptance": round(float(acc.mean()), 3),
           "dH_finite": bool(np.isfinite(dH).all()),
           "distinct_disorder_realizations": n_distinct(dis),
           "init_wall_s": round(t_init, 1), "exec_wall_s": round(wall, 1),
           "state_sharding": layout_label(blk),
           "note": (f"full-L (embedding {4 * lat.n_sites}) execution with "
                    f"the chains split over {blk.n_ranks} rank(s), each on "
                    f"{device.type}")}
    _write(out_path, blk, res)
    if blk.rank == 0:
        print(json.dumps({"config5_mesh_exec": res}))
    return res


def mesh64_demo(out_path, device, *, batch: int = 64, L: int = L_FULL,
                min_ranks: int = 2, dtype=torch.float32, init=None,
                stream=None, save_state=None, log=log) -> dict:
    """The full config-5 layout: ``batch`` chains at ``L`` over the ranks
    through the chunked init (8 chains per eigh), one sweep at Nt = 1
    (tracked 2, refine 2 / polish 1) and a transport pass on the coarse
    grid η = Δω = 0.05, ω_max = 2; asserts nothing, reports finiteness and
    the distinct realizations."""
    blk = rank_block(batch, min_ranks)
    params = setup(device, dtype)
    lat = LatticeSpec(L, L)
    t0 = time.time()
    st0, gen = init_block(lat, params, blk, batch, device, dtype=dtype,
                          init_chunk=8, init=init)
    t_init = time.time() - t0
    log(f"init done ({t_init:.0f}s)")
    if stream is None:
        stream = DrawStream(gen, (batch, 2, lat.n_sites, 2), dtype, device)
    Nt = 1
    dt = torch.full((len(blk.src),), calc_optimal_dt(20.0, 0.8, 1.0, 6),
                    dtype=dtype, device=device)
    t0 = time.time()
    normals, uniforms = block_draws(stream, blk, 0, 1)
    st, seg = run_segment_tracked(
        lat, params, st0, 1, Nt, dt, False, tracked_iters=2, anchor_every=2,
        refine_iters=2, polish_iters=1, ns_steps=2, normals=normals,
        uniforms=uniforms)
    sync(device)
    t_sweep = time.time() - t0
    log(f"sweep done ({t_sweep:.0f}s)")

    spec = SpectralSpec(eta=0.05, domega=0.05, omega_max=2.0)
    t0 = time.time()
    spectra = ensemble_transport_real(lat, spec, params, st)
    sync(device)
    t_meas = time.time() - t0
    log(f"transport done ({t_meas:.0f}s)")
    rho, sig, ak, dis = gathered(blk, batch, [
        _np(spectra.superfluid_stiffness), _np(spectra.optical_conductivity),
        _np(spectra.A_k0), _np(st.disorder)])
    acc, dH = gathered(blk, batch, [_np(seg.accepted), _np(seg.dH)], axis=1)
    _save_state(save_state, blk, batch, st0, st, seg)
    res = {"L": L, "batch": batch, "devices": blk.n_ranks,
           "chains_per_device": blk.n_pad // blk.n_ranks,
           "Nt": Nt, "acceptance": round(float(acc.mean()), 3),
           "dH_finite": bool(np.isfinite(dH).all()),
           "distinct_disorder_realizations": n_distinct(dis),
           "rho_s_shape": list(rho.shape),
           "rho_s_finite": bool(np.isfinite(rho).all()),
           "sigma_finite": bool(np.isfinite(sig).all()),
           "A_k0_finite": bool(np.isfinite(ak).all()),
           "state_sharding": layout_label(blk),
           "spectra_sharding": layout_label(blk),
           "init_wall_s": round(t_init, 1),
           "sweep_wall_s": round(t_sweep, 1),
           "transport_wall_s": round(t_meas, 1),
           "note": (f"config-5 layout ({batch} realizations of {L}x{L}) "
                    f"with the chains split over {blk.n_ranks} rank(s), "
                    f"each on {device.type}; the JAX script's knobs (Nt 1, "
                    "tracked 2, refine 2 / polish 1, the coarse grid)")}
    _write(out_path, blk, res)
    if blk.rank == 0:
        print(json.dumps({"config5_mesh_64": res}))
    return res


class CardRun(NamedTuple):
    """The card mode's record, its final states and setting, and the dH and
    accepts of every sweep it ran (n, batch)."""

    report: dict
    states: object
    lat: LatticeSpec
    params: object
    dH: np.ndarray
    accepted: np.ndarray


def card_demo(out_path, device, *, batch: int = 48, sweeps: int = 10,
              L: int = L_FULL, therm: int = 10, warmup: int = 2, init=None,
              stream=None, log=log) -> CardRun:
    """One-card throughput: ``therm`` exact-anchored sweeps at Nt = 20,
    ``warmup`` and then ``sweeps`` timed sweeps at Nt = 6 with K = 5
    (refine 12 / polish 4), float32 rotations.  ``init`` and ``stream``
    replace the initial ensemble's draws and every sweep's (the
    thermalization's first)."""
    lat = LatticeSpec(L, L)
    params = setup(device)
    est = estimate_memory(lat, batch)
    log(f"memory estimate: {est}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    blk = rank_block(batch)
    st, gen = init_block(lat, params, blk, batch, device, init_chunk=8,
                         init=init)
    log("init done")
    if stream is None:
        stream = DrawStream(gen, (batch, 2, lat.n_sites, 2), torch.float32,
                            device)

    dHs, accs = [], []

    def segment(st, start, n, Nt, K):
        dt = torch.full((batch,), calc_optimal_dt(20.0, 0.8, 1.0, Nt),
                        dtype=torch.float32, device=device)
        normals, uniforms = stream.take(start, n)
        st, seg = run_segment_tracked(
            lat, params, st, n, Nt, dt, False, tracked_iters=6,
            anchor_every=K, refine_iters=12, polish_iters=4, ns_steps=2,
            normals=normals, uniforms=uniforms)
        sync(device)
        dHs.append(_np(seg.dH))
        accs.append(_np(seg.accepted))
        return st, seg

    # thermalize first (a cold random start's dH is huge: a timed segment
    # at acceptance 0 says nothing of the production rate)
    acc_th = None
    if therm:
        st, seg = segment(st, 0, therm, 20, 1)
        acc_th = float(seg.accepted.float().mean())
        log(f"therm acc={acc_th:.2f}")
    if warmup:
        st, _ = segment(st, therm, warmup, 6, 5)
    t0 = time.time()
    st, seg = segment(st, therm + warmup, sweeps, 6, 5)
    wall = time.time() - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    # a diverged trajectory's dH is NaN and the chain rejects it (as in the
    # JAX package); how many, by stage, stands beside the acceptance
    bad = [int((~np.isfinite(x)).sum()) for x in dHs]
    stages = [n for n, k in (("therm", therm), ("warmup", warmup)) if k]
    res = {"L": L, "batch": batch, "Nt": 6, "sweeps": sweeps,
           "traj_per_sec": round(batch * sweeps / wall, 2),
           "acceptance": round(float(seg.accepted.float().mean()), 3),
           "therm_acceptance": None if acc_th is None else round(acc_th, 2),
           "wall_s": round(wall, 1),
           "hbm_est_gib": round(est.total_bytes / 2**30, 2),
           "max_memory_allocated_gib": (None if peak is None
                                        else round(peak / 2**30, 2)),
           "nonfinite_dH": dict(zip(stages + ["timed"], bad))}
    _write(out_path, blk, res)
    print(json.dumps({"config5_tpu_32x32": res}))
    return CardRun(res, st, lat, params, np.concatenate(dHs),
                   np.concatenate(accs))


#: the replayed sweep: config 5's first thermalization sweep (Nt = 20, 6
#: rotations a step, exact anchor)
REPLAY_NT, REPLAY_ITERS = 20, 6


def replay_first_therm_sweep(draws, src: str, device, dtype=None):
    """Config 5's first thermalization sweep on given draws: (dH, accepted)
    per chain, as numpy arrays.  ``draws`` maps ``{src}_disorder``, ``{src}_delta_re``,
    ``{src}_delta_im``, ``{src}_normals`` (1, B, 2, N, 2), ``{src}_uniforms``
    (1, B) and ``dt`` (the JAX run's initial ensemble and draws, as
    ``tests/data/config5_replay_32x32.npz`` holds them for src "f32" and
    "f64").  The params and dt are made in the source's dtype and, with
    ``dtype``, cast to it with the inputs (a float64 run on float32
    inputs)."""
    src_dtype = {"f32": torch.float32, "f64": torch.float64}[src]
    dtype = dtype or src_dtype
    disorder = np.asarray(draws[f"{src}_disorder"])
    chains, n = disorder.shape
    L = int(round(n ** 0.5))
    lat = LatticeSpec(L, L)
    params = setup(device, src_dtype)
    params = type(params)(*(x.to(dtype) for x in params))

    def given(key, dt=dtype):
        return torch.as_tensor(np.asarray(draws[key])).to(device, dt)

    st = init_ensemble_real(lat, params, None, chains, n_imp=PHYS["n_imp"],
                            dtype=dtype, device=device,
                            disorder=given(f"{src}_disorder"),
                            delta0_re=given(f"{src}_delta_re"),
                            delta0_im=given(f"{src}_delta_im"))
    dt = torch.full((chains,), float(draws["dt"]), dtype=src_dtype).to(
        device, dtype)
    _, seg = run_segment_tracked(
        lat, params, st, 1, REPLAY_NT, dt, False, tracked_iters=REPLAY_ITERS,
        normals=given(f"{src}_normals"),
        uniforms=given(f"{src}_uniforms", torch.float32))
    return _np(seg.dH[0]), _np(seg.accepted[0])


def _write(path, blk: Block, obj) -> None:
    if blk.rank != 0:
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", choices=MODES, default="mesh")
    p.add_argument("--batch", type=int, default=None,
                   help="card: 48, mesh_exec: 8, mesh and mesh64: 64")
    p.add_argument("--sweeps", type=int, default=None,
                   help="card: 10, mesh_exec: 2")
    p.add_argument("--L", type=int, default=None,
                   help="the lattice run: 32 (mesh: 12, its reduced run)")
    p.add_argument("--therm", type=int, default=10,
                   help="card: thermalization sweeps at Nt = 20")
    p.add_argument("--warmup", type=int, default=2,
                   help="card: untimed sweeps before the timed ones")
    p.add_argument("--dtype", choices=("float32", "float64"),
                   default="float32",
                   help="mesh, mesh_exec, mesh64: the ensemble's dtype")
    p.add_argument("--save_state", default=None,
                   help="mesh_exec, mesh64: .npz of the gathered initial "
                        "and final disorder and Δ, accepts and dH")
    p.add_argument("--out", default=None)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def main(argv=None):
    """Run ``--mode``; returns its record (the card mode's ``CardRun``)."""
    ns = parser().parse_args(argv)
    mode = "tpu" if ns.mode == "card" else ns.mode
    out = ns.out or os.path.join("runs", DEFAULT_OUT[mode])
    if mode == "tpu":
        return card_demo(out, rank_device(ns.device), batch=ns.batch or 48,
                         sweeps=ns.sweeps or 10, L=ns.L or L_FULL,
                         therm=ns.therm, warmup=ns.warmup)
    joined = maybe_setup_distributed()
    dtype = getattr(torch, ns.dtype)
    try:
        device = rank_device(ns.device)
        if mode == "mesh":
            return mesh_demo(out, device, batch=ns.batch or 64,
                             L=ns.L or 12, dtype=dtype)
        if mode == "mesh_exec":
            return mesh_exec_demo(out, device, batch=ns.batch or 8,
                                  sweeps=ns.sweeps or 2, L=ns.L or L_FULL,
                                  dtype=dtype, save_state=ns.save_state)
        return mesh64_demo(out, device, batch=ns.batch or 64,
                           L=ns.L or L_FULL, dtype=dtype,
                           save_state=ns.save_state)
    finally:
        if joined:
            teardown_distributed()


if __name__ == "__main__":
    run_quick_suite()
    main(sys.argv[1:])
