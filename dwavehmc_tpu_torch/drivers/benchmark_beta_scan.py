"""β-scan benchmark against BCS with acceptance tracking, S4 (port of
``scripts/benchmark_beta_scan.py``):

    python -m dwavehmc_tpu_torch.drivers.benchmark_beta_scan
        [--device cuda|cpu] [--out data/benchmark_beta_scan.csv] ...

12×12 clean lattice, J = 1.6, 12 log-spaced β ∈ [1, 5000], 30 + 60 sweeps
at Nt = 10 per point.  One chain from the uniform d-wave start is carried
from each β point to the next (a warm start, not the anneal ladder of
``batch_scan_beta``).  Writes the CSV ``Beta,Global,Pair,RHS,Diff,
Delta_Diff,AccRate``, one row per β, values as ``.6g``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..models.bcs import bcs_gap_rhs
from ..models.lattice import LatticeSpec
from ..models.params import make_params
from ..utils.device import resolve_device
from .benchmark_clean import DTYPES, MU, TP, T, clean_chain, run_chain

CSV_HEADER = "Beta,Global,Pair,RHS,Diff,Delta_Diff,AccRate"


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--L", type=int, default=12)
    p.add_argument("--J", type=float, default=1.6)
    p.add_argument("--n_beta", type=int, default=12)
    p.add_argument("--beta_min", type=float, default=1.0)
    p.add_argument("--beta_max", type=float, default=5000.0)
    p.add_argument("--n_therm", type=int, default=30)
    p.add_argument("--n_measure", type=int, default=60)
    p.add_argument("--Nt", type=int, default=10)
    p.add_argument("--dtype", choices=tuple(DTYPES), default="float64")
    p.add_argument("--out", default="data/benchmark_beta_scan.csv")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--path", choices=("complex", "real"), default="complex")
    p.add_argument("--eigh_mode", choices=("exact", "tracked"),
                   default="exact")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def beta_scan(ns: argparse.Namespace, *, normals=None, uniforms=None
              ) -> list[tuple]:
    """The rows (β, Global, Pair, RHS, Diff, Delta_Diff, AccRate) of the
    scan, written to ``ns.out``.  ``normals``/``uniforms`` hold every sweep's
    draws, point after point (as ``run_chain`` takes them); missing, they
    come from a generator seeded with ``ns.seed``."""
    device = resolve_device(ns.device)
    dtype = DTYPES[ns.dtype]
    lat = LatticeSpec(ns.L, ns.L)
    betas = np.logspace(np.log10(ns.beta_min), np.log10(ns.beta_max),
                        ns.n_beta)
    params = make_params(t=T, tp=TP, mu=MU, W=0.0, n_imp=0.0, beta=betas[0],
                         J=ns.J, mass=1.0, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(ns.seed)
    chain = clean_chain(lat, params, ns.path, ns.eigh_mode, generator=gen,
                        dtype=dtype, device=device)
    os.makedirs(os.path.dirname(ns.out) or ".", exist_ok=True)
    per_point = ns.n_therm + ns.n_measure
    rows = []
    for k, b in enumerate(betas):
        params = params._replace(beta=torch.as_tensor(b, dtype=dtype,
                                                      device=device))
        draws = {} if normals is None else dict(
            normals=normals[k * per_point:(k + 1) * per_point],
            uniforms=uniforms[k * per_point:(k + 1) * per_point])
        run = run_chain(lat, params, chain, b, ns.J, n_therm=ns.n_therm,
                        n_measure=ns.n_measure, Nt_therm=ns.Nt,
                        Nt_measure=ns.Nt, generator=gen, **draws)
        chain = chain._replace(state=run.state)
        g = np.mean(run.delta_global)
        pr = np.mean(run.delta_pair)
        df = np.mean(run.delta_diff)
        rhs = bcs_gap_rhs(g, lat, T, TP, MU, b, ns.J)
        rate = float(np.sum(run.accepted)) / ns.n_measure
        rows.append((b, g, pr, rhs, abs(g - rhs), df, rate))
        print(f"beta={b:10.3f}  Global={g:.5f}  Pair={pr:.5f}  "
              f"RHS={rhs:.5f}  Diff={abs(g-rhs):.5f}  Acc={rate:.2f}")

    with open(ns.out, "w") as f:
        f.write(CSV_HEADER + "\n")
        for r in rows:
            f.write(",".join(f"{x:.6g}" for x in r) + "\n")
    print("wrote", ns.out)
    return rows


def main(argv=None) -> list[tuple]:
    return beta_scan(parser().parse_args(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
