"""The correctness check: a sample of the window's answers, drawn from the
seed, judged against the plain float64 reference (``reference/physics``).

Chains are independent, so each (chain, period) pair is an answer.  For
each sampled pair the reference starts from the program's state at the
period's start (its Δ; the eigenpairs it works out itself), runs every
sweep of the period on the same normals, computes ΔH and the Metropolis
decision on the same uniform, and follows the program's decision to the
next sweep.  It compares:

``dH_gap``          the widest |ΔH_program − ΔH_reference| of the sweeps
                    (``dH_gap_median`` their median, ``dH_bias`` the
                    size of their signed mean); a sweep whose
                    program ΔH is not finite is a diverged trajectory,
                    which the program rejects: it is counted
                    (``nonfinite``), and its ΔH is not compared;
``flips``           decisions the program took against the reference's,
                    among those whose margin |ΔH_ref + ln u| exceeds the
                    cell's ``flip_margin`` (a decision nearer the edge is
                    not judged);
``accept_shift``    (accepted by the reference − accepted by the program)
                    over the sweeps compared, on the same uniforms: the
                    share of trajectories the program rejects that exact
                    dynamics accept, net of the converse;
``delta_gap``       ‖Δ_program − Δ_reference‖ / ‖Δ_reference‖ at the end
                    of the period, the widest over the sampled chains
                    (``period_move``: the least ‖Δ_end − Δ_start‖/‖Δ_end‖
                    of the reference's chains that moved, which is what a
                    step that returned its state unchanged would read);
``evals_gap``       the program's spectrum at the period's end against the
                    exact spectrum of its own Δ there, as the widest level
                    gap over the spectral radius;
``init_evals_gap``  the same for the initial ensemble (``init_fn``'s
                    guarded anchor on the harness's Δ₀);
``therm_*``         ``dH_gap``, ``dH_bias``, ``flips``, ``delta_gap`` and
                    ``evals_gap`` of the set-up's thermalization, replayed
                    as one more period from the initial ensemble: the
                    stage between the start and the window that the
                    replay of sampled periods skips.

A number not listed in the cell's limits is printed and not judged.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .harness import Cell, Run, dt_factor, optimal_dt, run_config
from .reference import physics as ref

RDT = torch.float64


def sample(seed: int, n_chains: int, n_periods: int, spec: dict):
    """(chains, periods) drawn from ``seed``: ``spec["chains"]`` of the
    chains and ``spec["periods"]`` of the window's periods (all where there
    are fewer)."""
    rng = np.random.default_rng(seed)
    chains = rng.permutation(n_chains)[:min(spec["chains"], n_chains)]
    periods = rng.permutation(n_periods)[:min(spec["periods"], n_periods)]
    return sorted(int(c) for c in chains), sorted(int(p) for p in periods)


def _cdelta(re, im, idx, dev):
    return torch.complex(re[idx].to(dev, RDT), im[idx].to(dev, RDT))


def _evals_gap(prog, exact) -> float:
    """Widest level gap of the sorted spectra over the spectral radius,
    the widest over chains."""
    p = torch.sort(prog.to(RDT), dim=-1).values
    gap = (p - exact).abs().amax(-1) / exact.abs().amax(-1)
    return float(gap.max())


def readings(cell: Cell, run: Run, seed: int, device) -> dict:
    """Every number of the check for ``run``."""
    cfg = run_config(cell)
    dev = torch.device(device)
    Lx, Ly = cfg.Lx, cfg.Ly
    c = {k: float(getattr(cfg, k)) for k in ("t", "tp", "mu", "beta", "J",
                                              "mass")}
    chains, periods = sample(seed, cfg.n_chains, len(run.periods),
                             cell.limits["sample"])
    idx = torch.tensor(chains)
    margin = cell.limits["flip_margin"]
    dis = run.init["disorder"][idx].to(dev, RDT)

    def replay(P, Nt: int, dt: float) -> dict:
        """Follow the period ``P`` from the program's Δ at its start,
        sweep by sweep, on its draws and the program's decisions."""
        d = _cdelta(*P.start, idx, dev)
        E, U = ref.eigh(ref.hamiltonian(Lx, Ly, c, dis, d))
        r = {"diffs": [], "flips": 0, "shift": 0, "n": 0, "nonfinite": 0}
        for s in range(P.accepted.shape[0]):
            pi0, d1, pi1, E1, U1 = ref.leapfrog(
                Lx, Ly, c, dis, d, E, U, P.normals[s, idx].to(dev), Nt, dt)
            dH_r = ref.delta_H(c, pi0, pi1, d, d1, E, E1)
            u = P.uniforms[s, idx].to(dev, RDT)
            a_r = ref.accepts(dH_r, u)
            a_p = P.accepted[s, idx].to(dev)
            dH_p = P.dH[s, idx].to(dev, RDT)
            done = torch.isfinite(dH_p)
            r["nonfinite"] += int((~done).sum())
            r["diffs"].append((dH_p - dH_r)[done])
            clear = (dH_r + torch.log(u)).abs() > margin
            r["flips"] += int(((a_p != a_r) & clear & done).sum())
            r["shift"] += int((a_r & done).sum()) - int((a_p & done).sum())
            r["n"] += int(done.sum())
            keep = a_p[:, None, None]
            d = torch.where(keep, d1, d)
            E = torch.where(a_p[:, None], E1, E)
            U = torch.where(keep, U1, U)
        dP = _cdelta(*P.end, idx, dev)
        norm = d.abs().pow(2).sum((-2, -1)).sqrt()
        r["delta_gap"] = float(((dP - d).abs().pow(2).sum((-2, -1)).sqrt()
                                / norm).max())
        move = (d - _cdelta(*P.start, idx, dev)).abs().pow(2).sum(
            (-2, -1)).sqrt() / norm
        r["moves"] = [float(m) for m, a in
                      zip(move, P.accepted[:, idx].any(0)) if a]
        exact = torch.linalg.eigvalsh(ref.hamiltonian(Lx, Ly, c, dis, dP))
        r["evals_gap"] = _evals_gap(P.evals[idx].to(dev), exact)
        r["diffs"] = torch.cat(r["diffs"])
        return r

    d0 = _cdelta(run.init["delta_re"], run.init["delta_im"], idx, dev)
    E0 = torch.linalg.eigvalsh(ref.hamiltonian(Lx, Ly, c, dis, d0))
    out = {"init_evals_gap": _evals_gap(run.init["evals"][idx].to(dev), E0)}
    if run.therm is not None:
        Nt = cfg.Nt_therm_init
        t = replay(run.therm, Nt, optimal_dt(cfg.beta, cfg.J, cfg.mass, Nt))
        out.update(therm_dH_gap=float(t["diffs"].abs().max()),
                   therm_dH_bias=float(t["diffs"].mean().abs()),
                   therm_flips=t["flips"], therm_delta_gap=t["delta_gap"],
                   therm_evals_gap=t["evals_gap"])

    Nt = cfg.Nt_measure
    dt = dt_factor(cell) * optimal_dt(cfg.beta, cfg.J, cfg.mass, Nt)
    rs = [replay(run.periods[p], Nt, dt) for p in periods]
    diffs = torch.cat([r["diffs"] for r in rs])
    n = sum(r["n"] for r in rs)
    moves = [m for r in rs for m in r["moves"]]
    out.update(
        dH_gap=float(diffs.abs().max()) if diffs.numel() else 0.0,
        dH_gap_median=float(diffs.abs().median()) if diffs.numel() else 0.0,
        dH_bias=float(diffs.mean().abs()) if diffs.numel() else 0.0,
        flips=sum(r["flips"] for r in rs),
        accept_shift=sum(r["shift"] for r in rs) / n if n else 0.0,
        nonfinite=sum(r["nonfinite"] for r in rs),
        delta_gap=max(r["delta_gap"] for r in rs),
        period_move=min(moves) if moves else None,
        evals_gap=max(r["evals_gap"] for r in rs))
    out["sampled"] = {"chains": chains, "periods": periods}
    return out


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the limits' names; a
    missing or non-finite number fails."""
    table, ok = {}, True
    for name, limit in limits.items():
        v = values.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        table[name] = {"value": v, "limit": limit}
    return ok, table
