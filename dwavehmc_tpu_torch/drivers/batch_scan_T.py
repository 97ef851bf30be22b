"""Temperature-scan production workload on the card (port of
``scripts/batch_scan_T.py``):

    python -m dwavehmc_tpu_torch.drivers.batch_scan_T [--device cuda|cpu] ...

Defaults are the production shape: 24×24 lattice, t=1, t'=−0.35, μ=−1.08,
W=1, n_imp=0.05, J=0.8; 24 log-spaced T ∈ [1e−4, 1e3]; η=8/N, Δω=0.2η,
ω_max=4; 20 therm + 100 measure sweeps, Nt_therm=20, Nt_meas=6, transport
every sweep, bin 10, a 10-stage β-ladder anneal.  Every ``RunConfig`` field
is a flag.  ``--mode vectorized`` runs the whole grid as one ensemble;
``--mode serial`` runs one ``run_simulation`` per point (with ``--resume
true`` a finished point is skipped).  ``--summarize`` (default on) writes
``summary_all.csv``.

On a node of several cards the vectorized scan runs one rank per card,
each on a block of the chains (``parallel/mesh.py``):

    python -m torch.distributed.run --standalone --nproc_per_node W \\
        -m dwavehmc_tpu_torch.drivers.batch_scan_T ...

Its files equal the one-process run's; rank 0 writes them.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch.distributed as dist

from .postprocess import summarize_scan
from .scan import default_T_grid, run_scan_serial, run_scan_vectorized
from ..parallel.mesh import (
    maybe_setup_distributed,
    rank_device,
    teardown_distributed,
    world,
)
from ..utils.config import RunConfig, add_cli_args, from_namespace
from ..utils.quickcheck import run_quick_suite


def parser() -> argparse.ArgumentParser:
    defaults = RunConfig(
        Lx=24, Ly=24, W=1.0, n_imp=0.05, J=0.8,
        n_therm=20, n_measure=100, Nt_therm_init=20, Nt_measure=6,
        measure_transport_freq=1, bin_size=10,
        # β-ladder warm start for the cold tail (T ≤ 1e-2 ⇒ β ≥ 100)
        anneal_stages=10, anneal_sweeps=5, anneal_start_beta=100.0,
        out_dir="data/T_scan")
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_cli_args(p, defaults)
    p.add_argument("--mode", choices=("vectorized", "serial"),
                   default="vectorized")
    p.add_argument("--n_T", type=int, default=24)
    p.add_argument("--T_min", type=float, default=1e-4)
    p.add_argument("--T_max", type=float, default=1e3)
    p.add_argument("--replicas", type=int, default=None,
                   help="chains per T point (vectorized mode)")
    p.add_argument("--summarize", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def run_grid(ns: argparse.Namespace, values: np.ndarray, scan_param: str,
             summarize: bool = True):
    """The scan of ``values`` that ``ns`` asks for, in a process group when
    the environment has one (joined first, before any device use, and left
    at the end); rank 0 summarizes."""
    cfg = from_namespace(ns)
    joined = not dist.is_initialized() and maybe_setup_distributed()
    try:
        rank, W = world()
        if ns.mode == "serial":
            if W > 1:
                raise ValueError(
                    f"--mode serial runs one point after another in one "
                    f"process and has no rank layout; under {W} ranks use "
                    f"--mode vectorized")
            out = run_scan_serial(cfg, values, scan_param=scan_param,
                                  device=ns.device)
        else:
            out = run_scan_vectorized(cfg, values, scan_param=scan_param,
                                      replicas=ns.replicas,
                                      device=rank_device(ns.device))
        if summarize and rank == 0:
            prefix = f"{scan_param}_"
            print("summary:", summarize_scan(cfg.out_dir, prefix, scan_param))
        return out
    finally:
        if joined:
            teardown_distributed()


def main(argv=None):
    """The vectorized scan's result dict, or the serial scan's list of
    per-point results."""
    ns = parser().parse_args(argv)
    return run_grid(ns, default_T_grid(ns.n_T, ns.T_min, ns.T_max), "T",
                    ns.summarize)


if __name__ == "__main__":
    run_quick_suite()
    main(sys.argv[1:])
