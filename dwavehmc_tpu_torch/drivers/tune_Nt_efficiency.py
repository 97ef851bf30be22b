"""HMC tuning study, workload S14 (port of
``scripts/tune_Nt_efficiency.py``): efficiency = acceptance/Nt against Nt
at a fixed trajectory length.

    python -m dwavehmc_tpu_torch.drivers.tune_Nt_efficiency
        [--device cuda|cpu] [--L 8] [--beta 20] [--J 1] [--mass 1]
        [--W 1] [--n_imp 0.05] [--Nt_list 2 4 6 8 12 16 24]
        [--n_sweeps 40] [--n_therm 20] [--dtype float32] [--seed 0]

The trajectory length is half the harmonic period, T_period/2 with
T_period = 4π√(mJ/β); each Nt steps with dt = length/Nt.  Every Nt starts
from the same chain (one complex-path chain, ``sampler/hmc.hmc_sweep``)
with the same draws, runs ``n_therm`` sweeps, then counts the accepted of
``n_sweeps``.  Prints the table and the best Nt.
"""

from __future__ import annotations

import argparse
import math
import sys

import torch

from ..models.lattice import LatticeSpec
from ..models.params import make_params
from ..parallel.ensemble import DrawStream
from ..sampler.hmc import hmc_sweep, init_chain_state
from ..utils.device import resolve_device

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--L", type=int, default=8)
    p.add_argument("--beta", type=float, default=20.0)
    p.add_argument("--J", type=float, default=1.0)
    p.add_argument("--mass", type=float, default=1.0)
    p.add_argument("--W", type=float, default=1.0)
    p.add_argument("--n_imp", type=float, default=0.05)
    p.add_argument("--Nt_list", type=int, nargs="+",
                   default=[2, 4, 6, 8, 12, 16, 24])
    p.add_argument("--n_sweeps", type=int, default=40)
    p.add_argument("--n_therm", type=int, default=20)
    p.add_argument("--dtype", choices=tuple(DTYPES), default="float32")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def tune(ns: argparse.Namespace, *, state0=None, draws=None, log=print):
    """(rows (Nt, dt, acceptance, efficiency), (best Nt, its efficiency)),
    the table printed through ``log``.  ``state0`` replaces the chain drawn
    from a generator seeded with ``ns.seed``; ``draws`` (normals (n, 1, 2,
    N, 2), uniforms (n, 1)) its ``n_therm + n_sweeps`` sweeps' draws, the
    same for every Nt."""
    device = resolve_device(ns.device)
    dtype = DTYPES[ns.dtype]
    lat = LatticeSpec(ns.L, ns.L)
    params = make_params(W=ns.W, n_imp=ns.n_imp, beta=ns.beta, J=ns.J,
                         mass=ns.mass, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(ns.seed)
    if state0 is None:
        state0 = init_chain_state(lat, params, 1, generator=gen, dtype=dtype,
                                  n_imp=ns.n_imp, device=device)
    stream = DrawStream(gen, (1, 2, lat.n_sites, 2), dtype, device,
                        *(draws or (None, None)))
    normals, uniforms = stream.take(0, ns.n_therm + ns.n_sweeps)

    # fixed trajectory length: half the harmonic period
    period = 4.0 * math.pi * math.sqrt(ns.mass * ns.J / ns.beta)
    length = period / 2.0

    log(f"trajectory length L={length:.4f} (T_period={period:.4f})")
    log(f"{'Nt':>4} {'dt':>9} {'acc':>6} {'eff=acc/Nt':>11}")
    rows, best = [], (None, -1.0)
    for Nt in ns.Nt_list:
        dt = length / Nt
        state = state0
        for i in range(ns.n_therm):
            state, _ = hmc_sweep(lat, params, state, Nt, dt,
                                 normals=normals[i], uniforms=uniforms[i])
        acc = 0
        for i in range(ns.n_therm, ns.n_therm + ns.n_sweeps):
            state, info = hmc_sweep(lat, params, state, Nt, dt,
                                    normals=normals[i], uniforms=uniforms[i])
            acc += int(info.accepted[0])
        rate = acc / ns.n_sweeps
        eff = rate / Nt
        log(f"{Nt:>4} {dt:>9.5f} {rate:>6.2f} {eff:>11.4f}")
        rows.append((Nt, dt, rate, eff))
        if eff > best[1]:
            best = (Nt, eff)
    log(f"best Nt = {best[0]} (efficiency {best[1]:.4f})")
    return rows, best


def main(argv=None):
    return tune(parser().parse_args(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
