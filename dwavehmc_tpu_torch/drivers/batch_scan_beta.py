"""β-scan workload on a clean(er) system (port of
``scripts/batch_scan_beta.py``):

    python -m dwavehmc_tpu_torch.drivers.batch_scan_beta [--device cuda|cpu] ...

Defaults are the reference's shape: 12×12, W=1 with n_imp=0 (clean),
J=0.8; 24 log-spaced β ∈ [0.01, 1e5]; 20 therm + 100 measure sweeps,
Nt_therm=20, Nt_meas=6, transport every sweep, bin 10, and the geometric
β-ladder anneal (10 stages × 5 sweeps from β = 100) in place of the
reference's warm start of each β from the previous one.  Every
``RunConfig`` field is a flag; the modes, ``--device`` and the launch on
several cards are those of ``batch_scan_T``.  A summary of the points goes
to ``summary_all.csv``.
"""

from __future__ import annotations

import argparse
import sys

from .batch_scan_T import run_grid
from .scan import default_beta_grid
from ..utils.config import RunConfig, add_cli_args


def parser() -> argparse.ArgumentParser:
    defaults = RunConfig(
        Lx=12, Ly=12, W=1.0, n_imp=0.0, J=0.8,
        n_therm=20, n_measure=100, Nt_therm_init=20, Nt_measure=6,
        measure_transport_freq=1, bin_size=10,
        anneal_stages=10, anneal_sweeps=5, anneal_start_beta=100.0,
        out_dir="data/beta_scan")
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_cli_args(p, defaults)
    p.add_argument("--mode", choices=("vectorized", "serial"),
                   default="vectorized")
    p.add_argument("--n_beta", type=int, default=24)
    p.add_argument("--beta_min", type=float, default=0.01)
    p.add_argument("--beta_max", type=float, default=1e5)
    p.add_argument("--replicas", type=int, default=None,
                   help="chains per β point (vectorized mode)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def main(argv=None):
    """The vectorized scan's result dict, or the serial scan's list of
    per-point results."""
    ns = parser().parse_args(argv)
    return run_grid(ns, default_beta_grid(ns.n_beta, ns.beta_min,
                                          ns.beta_max), "beta")


if __name__ == "__main__":
    main(sys.argv[1:])
