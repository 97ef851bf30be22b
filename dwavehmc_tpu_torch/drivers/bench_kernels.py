"""Kernel microbenchmarks: assembly, eigensolvers, forces, transport (port
of ``scripts/bench_kernels.py``):

    python -m dwavehmc_tpu_torch.drivers.bench_kernels [--device cuda|cpu]
        [--L 16] [--batch 8] [--reps 5] [--dtype float32] [--skip ...]

Times, per row, one batched call over ``--batch`` chains of an
``init_ensemble_real`` ensemble: BdG assembly (real embedding and real 2N
pair), the exact eigh of the real embedding and of the complex matrices,
the raw 3-multiplication complex product, the tracked refinement at 1, 4
and 8 rotations (the rotation kernel K1 on the card), the real-pair force
and the transport |J_mn|².  Mean milliseconds per call after one warm-up
call (``utils/profiling.call_ms``: CUDA events on the card).

A row whose name contains an entry of ``--skip`` is skipped; a row that
fails prints ``FAILED`` and the others still run, but the run then exits
nonzero.
"""

from __future__ import annotations

import argparse
import statistics
import sys

import torch

from ..models.bdg import assemble_bdg, static_hamiltonian
from ..models.bdg_real import (
    assemble_embedding,
    assemble_parts,
    diagonalize_embedding,
    static_embedding,
    symmetric_eigh,
)
from ..models.lattice import LatticeSpec
from ..models.params import make_params
from ..models.transport_real import current_J2_real
from ..ops.forces_real import hmc_forces_real
from ..ops.tracked_eigh import cmm, tracked_eigh_nofallback
from ..parallel.ensemble import init_ensemble_real
from ..utils.device import resolve_device
from ..utils.profiling import call_ms
from .validate_cheap_anchor import device_label

#: the seed of the ensemble's generator (the JAX script's PRNGKey(0))
SEED = 0


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--L", type=int, default=16)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--skip", nargs="*", default=[],
                   help="rows to skip: any row whose name contains one")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def bench(ns: argparse.Namespace, out=print) -> list:
    """Prints the header and one line per row; returns the names of the
    rows that failed."""
    device = resolve_device(ns.device)
    dtype = torch.float64 if ns.dtype == "float64" else torch.float32
    lat = LatticeSpec(ns.L, ns.L)
    b = ns.batch
    params = make_params(W=1.0, n_imp=0.05, beta=10.0, J=0.8, dtype=dtype,
                         device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    states = init_ensemble_real(lat, params, gen, b, dtype=dtype, n_imp=0.05,
                                device=device)
    out(f"device={device_label(device)} L={ns.L} (2N={lat.dim}) batch={b} "
        f"dtype={ns.dtype}")
    failed = []

    def report(name, fn, *args, rate=None):
        if any(s in name for s in ns.skip):
            out(f"{name:34s}: skipped")
            return
        try:
            t = statistics.fmean(
                call_ms(lambda: fn(*args), ns.reps, device)[0]) / 1e3
        except Exception as e:  # noqa: BLE001 — every row runs; main fails
            failed.append(name)
            out(f"{name:34s}: FAILED {type(e).__name__}: {str(e)[:60]}")
            return
        extra = "" if rate is None else f" ({rate(t):.1f} TFLOP/s)"
        out(f"{name:34s}: {t * 1e3:9.2f} ms{extra}")

    t, tp, mu = params.t, params.tp, params.mu
    dr, di = states.delta_re, states.delta_im
    Ms = static_embedding(lat, t, tp, mu, states.disorder)
    report("assemble embedding (real 4N)",
           lambda m, r, i: assemble_embedding(lat, m, r, i), Ms, dr, di)

    Hs = static_hamiltonian(lat, t, tp, mu, states.disorder)
    report("assemble parts (real 2N pair)",
           lambda h, r, i: assemble_parts(lat, h, r, i), Hs, dr, di)

    report("exact eigh (real embedding 4N)",
           lambda m, r, i: diagonalize_embedding(
               assemble_embedding(lat, m, r, i))[0], Ms, dr, di)

    if "complex" not in ns.skip:
        delta_c = torch.complex(dr, di)
        report("exact eigh (complex 2N)",
               lambda h, d: symmetric_eigh(assemble_bdg(lat, h, d))[0],
               Hs, delta_c)

    # raw 3-mult complex product, the workhorse of the tracked step (one
    # tracked_step iteration = 7 products = 21 real matmuls); 7×cmm
    # against "tracked refine n_iter=1" isolates the elementwise overhead
    # of the rotation-angle construction
    def raw_cmm(X, Y):
        ar, ai = cmm(X, Y, X, Y)
        return ar + ai

    n = lat.dim
    report("raw cmm (3 real matmuls)", raw_cmm, states.X, states.Y,
           rate=lambda s: 3 * 2.0 * n**3 * b / s / 1e12)

    for it in (1, 4, 8):
        report(f"tracked refine n_iter={it}",
               lambda h, r, i, X, Y, it=it: tracked_eigh_nofallback(
                   *assemble_parts(lat, h, r, i), X, Y, n_iter=it)[0],
               Hs, dr, di, states.X, states.Y)

    report("force kernel (real pairs)",
           lambda r, i, e, X, Y: hmc_forces_real(
               lat, r, i, e, X, Y, params.beta, params.J)[0],
           dr, di, states.evals, states.X, states.Y)

    report("transport |J_mn|^2 (6 matmuls)",
           lambda X, Y: current_J2_real(lat, X, Y, t, tp),
           states.X, states.Y)
    return failed


def main(argv=None) -> list:
    failed = bench(parser().parse_args(argv))
    if failed:
        raise SystemExit(f"bench_kernels: {len(failed)} row(s) failed: "
                         f"{failed}")
    return failed


if __name__ == "__main__":
    main(sys.argv[1:])
