"""Graft entry points of the port (the counterpart of the JAX package's
root ``__graft_entry__.py``): one HMC sweep to build and check, and a dry
run of every ensemble runner over n ranks.

    python -m dwavehmc_tpu_torch.graft_entry [--device cpu]
        entry()'s sweep once; prints the output shapes
    python -m dwavehmc_tpu_torch.graft_entry --dryrun N [--device cpu]
        dryrun_multichip(N): N gloo ranks, each one step of every runner

Both run on the card unless ``device="cpu"``.  The JAX dry run forces N
virtual CPU devices and shards the ensemble over them; here each rank is a
process holding its block of the chains (``parallel/mesh.py``), and ranks
may share one card.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from .models.lattice import LatticeSpec
from .models.params import ModelParams, SpectralSpec, make_params
from .ops import kernels
from .parallel import mesh
from .parallel.ensemble import (
    RowDraws,
    ensemble_transport_real,
    init_ensemble,
    init_ensemble_real,
    run_segment,
    run_segment_hostacc,
    run_segment_real,
    run_segment_tracked,
)
from .sampler.hmc_real import hmc_sweep_real, init_chain_state_real
from .utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: a dry run's ranks must all finish within this many seconds
DRYRUN_SECONDS = 240
#: torchrun's and the package's launch variables, cleared for the ranks
_LAUNCH_ENV = ("DWAVEHMC_COORDINATOR", "DWAVEHMC_NUM_PROCESSES",
               "DWAVEHMC_PROCESS_ID", "DWAVEHMC_DISTRIBUTED", "MASTER_ADDR",
               "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def entry(device=None):
    """(fn, (params, state)): one real-path HMC sweep (Nt = 4, dt = 0.05)
    of one chain on an 8×8 lattice, in float32.

    The state is drawn from a ``torch.Generator`` seeded 0 on the device,
    and ``fn(params, state)`` draws the sweep's momenta and accept uniform
    from the same generator, unless given as ``normals`` (1, 2, N, 2) and
    ``uniforms`` (1,).  It returns ``(state.delta_re, info.dH)`` with the
    chain axis leading: (1, N, 2) and (1,)."""
    dev = resolve_device("cuda" if device is None else device)
    lat = LatticeSpec(8, 8)
    params = make_params(t=1.0, tp=-0.35, mu=-1.08, W=1.0, n_imp=0.05,
                         beta=10.0, J=0.8, mass=1.0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = init_chain_state_real(lat, params, 1, generator=gen, n_imp=0.05,
                                  device=dev)

    def fn(params, state, *, normals=None, uniforms=None):
        new_state, info = hmc_sweep_real(lat, params, state, 4, 0.05,
                                         normals=normals, uniforms=uniforms,
                                         generator=gen)
        return new_state.delta_re, info.dH

    return fn, (params, state)


# --- the multi-rank dry run ---------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_ranks: int, device=None) -> list:
    """One step of every ensemble runner over ``n_ranks`` gloo ranks, on
    the card (ranks share it) unless ``device="cpu"``.

    Starts the ranks as processes of their own session, waits at most
    ``DRYRUN_SECONDS`` for all of them (then kills every process group and
    raises), and raises if any rank failed.  Returns each rank's report
    (``_dryrun_rank``: its rows, each of its chains' count of impurity
    sites, its collectives, its kernel launches and each step's per-chain
    numbers), in rank order; every rank made the same
    number of collectives."""
    dev = "cuda" if device is None else str(device)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCH_ENV}
    env.update(OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo",
               SKIP_QUICK_TESTS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "dwavehmc_tpu_torch.graft_entry", "--rank",
         str(r), "--world", str(n_ranks), "--port", str(port), "--device",
         dev], env=dict(env, LOCAL_RANK=str(r)), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True) for r in range(n_ranks)]
    deadline = time.monotonic() + DRYRUN_SECONDS
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"dryrun_multichip({n_ranks}): the ranks did not "
                           f"finish in {DRYRUN_SECONDS} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"dryrun_multichip({n_ranks}): ranks {failed} "
                           "failed:\n" + "\n".join(
                               logs[r][-3000:] for r in failed))
    reports = [json.loads(log.strip().splitlines()[-1]) for log in logs]
    calls = {rep["collectives"] for rep in reports}
    if len(calls) != 1:
        raise RuntimeError(f"dryrun_multichip({n_ranks}): ranks made "
                           f"different numbers of collectives: {calls}")
    return reports


def _finite(name: str, *xs) -> None:
    for x in xs:
        if not bool(torch.isfinite(x).all()):
            raise RuntimeError(f"dry run: {name} is not finite: {x}")


def _hold_rows(name: str, local: torch.Tensor, sl: slice,
               n_total: int) -> None:
    """This rank holds exactly its ``sl`` rows of the global batch: the
    gathered batch has ``n_total`` rows, and rows ``sl`` are this rank's."""
    if local.shape[0] != sl.stop - sl.start:
        raise RuntimeError(f"dry run: {name} holds {local.shape[0]} chains, "
                           f"its slice {sl} has {sl.stop - sl.start}")
    glob = mesh.gather_global_batch(local)
    if glob.shape[0] != n_total or not np.array_equal(
            glob[sl], local.detach().cpu().numpy()):
        raise RuntimeError(f"dry run: {name}: the ranks' blocks are not "
                           f"rows {sl} of a batch of {n_total}")


def _dryrun_rank(rank: int, world: int, port: int, device: str) -> dict:
    """The steps of the JAX ``dryrun_multichip``, in its order, on this
    rank's block of the ensemble; raises at the first failed check."""
    mesh.setup_distributed(f"localhost:{port}", world, rank)
    try:
        dev = mesh.rank_device(device)
        lat = LatticeSpec(4, 4)
        params = make_params(t=1.0, tp=-0.35, mu=-1.08, W=1.0, n_imp=0.25,
                             beta=5.0, J=1.0, mass=1.0, dtype=torch.float32,
                             device=dev)
        tail = (2, lat.n_sites, 2)
        steps = {}

        # 1-D layout: one chain per rank
        layout = mesh.make_ensemble_mesh()
        n_total = world
        sl = mesh.process_batch_slice(n_total, layout)
        rows = list(range(sl.start, sl.stop))
        gen = torch.Generator(device=dev).manual_seed(0)

        def draws(n_draw=n_total, keep=rows):
            d = RowDraws(gen, n_draw, tail, torch.float32, keep, dev)
            return dict(normals=d.normals, uniforms=d.uniforms)

        # the real path
        states = init_ensemble_real(lat, params, gen, n_total,
                                    n_imp=0.25, rows=rows, device=dev)
        states, seg = run_segment_real(lat, params, states, 2, 3, 0.05,
                                       measure=True, **draws())
        energy = seg.observables.total_energy
        if tuple(energy.shape) != (2, len(rows)):
            raise RuntimeError(f"dry run: energy shape {energy.shape}")
        _finite("run_segment_real energy", energy)
        _hold_rows("run_segment_real", states.delta_re, sl, n_total)
        steps["real"] = energy.tolist()

        # the tracked runner: one anchored and one cheap-anchor sweep
        tstates, tseg = run_segment_tracked(
            lat, params, states, 2, 3, 0.05, True, tracked_iters=2,
            anchor_every=2, refine_iters=2, **draws())
        _finite("run_segment_tracked dH", tseg.dH)
        _hold_rows("run_segment_tracked", tstates.delta_re, sl, n_total)
        steps["tracked"] = tseg.dH.tolist()

        # the guarded PH anchor with the exp2 rotation scheme
        pstates, pseg = run_segment_tracked(
            lat, params, states, 1, 2, 0.05, True, tracked_iters=2,
            anchor_every=1, exact_solver="ph", rot_scheme="exp2",
            ns_steps=1, **draws())
        _finite("the PH-anchored segment's dH", pseg.dH)
        _hold_rows("the PH-anchored segment", pstates.delta_re, sl, n_total)
        steps["ph_exp2"] = pseg.dH.tolist()

        # the host float64 Metropolis readout
        hstates, hseg, _ = run_segment_hostacc(
            lat, params, states, 1, 3, 0.05, measure=True, tracked_iters=2,
            **draws())
        _finite("run_segment_hostacc dH", hseg.dH)
        _hold_rows("run_segment_hostacc", hstates.delta_re, sl, n_total)
        steps["hostacc"] = hseg.dH.tolist()

        # the transport and spectra pass
        spec = SpectralSpec(eta=0.5, domega=0.5, omega_max=2.0)
        rho_s = ensemble_transport_real(lat, spec, params,
                                        tstates).superfluid_stiffness
        if tuple(rho_s.shape) != (len(rows),):
            raise RuntimeError(f"dry run: rho_s shape {rho_s.shape}")
        _finite("rho_s", rho_s)
        _hold_rows("ensemble_transport_real", rho_s, sl, n_total)
        steps["rho_s"] = rho_s.tolist()

        # the complex oracle path
        cstates = init_ensemble(lat, params, gen, n_total,
                                n_imp=0.25, rows=rows, device=dev)
        cstates, cseg = run_segment(lat, params, cstates, 2, 3, 0.05,
                                    measure=True, **draws())
        _finite("run_segment energy", cseg.observables.total_energy)
        _hold_rows("run_segment", torch.view_as_real(cstates.delta), sl,
                   n_total)
        steps["complex"] = cseg.observables.total_energy.tolist()

        # the 2-D (grid × chain) layout, 2 chains a rank, with per-chain β
        # (the first half 4.0, the second 6.0) and dt: every rank draws the
        # global ensemble and keeps its slice, as each host would feed its
        # share through distribute_global_batch
        G = 2 if world % 2 == 0 else 1
        layout2 = mesh.make_ensemble_mesh(grid_points=G)
        n2 = 2 * world
        sl2 = mesh.process_batch_slice(n2, layout2)
        gen7 = torch.Generator(device=dev).manual_seed(7)
        full = init_ensemble_real(lat, params, gen7, n2, n_imp=0.25,
                                  device=dev)
        gstates = type(full)(*mesh.distribute_global_batch(
            tuple(x.cpu().numpy() for x in full), layout2, device=dev))
        _hold_rows("distribute_global_batch", gstates.delta_re, sl2, n2)
        beta = np.where(np.arange(n2) < n2 // 2, 4.0, 6.0)[sl2]
        pb = ModelParams(*(x.expand(len(beta)) for x in params))._replace(
            beta=torch.as_tensor(beta, dtype=torch.float32, device=dev))
        dt = torch.full((len(beta),), 0.05, device=dev)
        g2, seg2 = run_segment_tracked(
            lat, pb, gstates, 2, 3, dt, True, tracked_iters=2,
            anchor_every=2, refine_iters=2,
            **draws(n2, list(range(sl2.start, sl2.stop))))
        _finite("the 2-D layout's dH", seg2.dH)
        _hold_rows("the 2-D layout", g2.delta_re, sl2, n2)
        steps["grid_chain"] = seg2.dH.tolist()

        calls = mesh.COMM["calls"]
        every = mesh.gather_objects(calls)
        if len(set(every)) != 1:
            raise RuntimeError(f"dry run: collectives by rank {every}")
        impurities = lambda st: (st.disorder != 0).sum(-1).tolist()  # noqa: E731
        return {"rank": rank, "world": world, "device": str(dev),
                "rows": [sl.start, sl.stop], "rows_2d": [sl2.start, sl2.stop],
                "impurities": impurities(states),
                "impurities_2d": impurities(gstates),
                "layout_2d": list(layout2.ranks.shape), "collectives": calls,
                "launches": dict(kernels.LAUNCHES), "steps": steps}
    finally:
        mesh.teardown_distributed()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dryrun", type=int, default=None, metavar="N",
                    help="run dryrun_multichip(N) instead of entry()")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        torch.set_num_threads(1)
        print(json.dumps(_dryrun_rank(args.rank, args.world, args.port,
                                      args.device)), flush=True)
    elif args.dryrun is not None:
        reports = dryrun_multichip(args.dryrun, args.device)
        print("dryrun ok:", json.dumps(
            [{k: r[k] for k in ("rank", "device", "rows", "rows_2d",
                                "collectives")} for r in reports]))
    else:
        fn, fargs = entry(args.device)
        out = fn(*fargs)
        print("entry ok:", [tuple(x.shape) for x in out])


if __name__ == "__main__":
    main()
