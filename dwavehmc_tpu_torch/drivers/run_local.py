"""Quick local run: a clean 8×8 lattice at one β, a short HMC chain — the
smallest end-to-end run of ``run_simulation`` (port of
``scripts/run_local.py``):

    python -m dwavehmc_tpu_torch.drivers.run_local [--device cuda|cpu] ...

``--path`` picks the compute path ("auto" is the real-pair path);
``--metropolis_readout host`` takes the float64 ΔH on the host, with the
tracked real path.
"""

from __future__ import annotations

import argparse
import sys

from ..utils.config import RunConfig
from .simulation import run_simulation


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--L", type=int, default=8)
    p.add_argument("--beta", type=float, default=50.0)
    p.add_argument("--J", type=float, default=1.6)
    p.add_argument("--sweeps", type=int, default=30)
    p.add_argument("--out_dir", default="runs/local")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--path", choices=("auto", "real", "complex"),
                   default="auto")
    p.add_argument("--eigh_mode", choices=("exact", "tracked"),
                   default="exact")
    p.add_argument("--metropolis_readout", choices=("device", "host"),
                   default="device")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def main(argv=None) -> dict:
    ns = parser().parse_args(argv)
    cfg = RunConfig(Lx=ns.L, Ly=ns.L, W=0.0, n_imp=0.0, beta=ns.beta,
                    J=ns.J, eta=0.1, domega=0.05, omega_max=2.0,
                    n_therm=10, n_measure=ns.sweeps, Nt_therm_init=10,
                    Nt_measure=6, measure_transport_freq=10, bin_size=2,
                    n_chains=1, dtype=ns.dtype, path=ns.path,
                    eigh_mode=ns.eigh_mode,
                    metropolis_readout=ns.metropolis_readout,
                    out_dir=ns.out_dir)
    summary = run_simulation(cfg, device=ns.device)
    print(summary)
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
