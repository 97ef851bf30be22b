"""Race the PH-split eigensolver against ``torch.linalg.eigh`` of the BdG
embedding (port of ``scripts/bench_ph_eigh.py``):

    python -m dwavehmc_tpu_torch.drivers.bench_ph_eigh [--device cuda|cpu]
        [--L 16 --batch 8 --reps 3] [--lift_prec default|high|highest]
        [--n_lift N] [--orth chol|ns] [--floor 1e-5] [--skip_qdwh]

A batch of random embeddings (disorder, Δ) of an L×L lattice goes through
``ops/ph_eigh.diagonalize_embedding_ph`` at ``--lift_prec`` (below "highest"
its lift loop runs TF32 products on the card) and through the full eigh
(``models/bdg_real.diagonalize_embedding``, the port's "qdwh" anchor).
Each is timed by the best of ``--reps`` calls after one warm-up: CUDA
events on the card, the host clock on the CPU.  One JSON line on stdout:
both times, the speed-up, ``eval_err`` = max |evals_ph − evals_eigh|
(``--skip_qdwh`` still computes it, untimed) and ``max_res_colnorm`` = the
largest column norm of M·V − V·diag(w) over the PH pairs.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..models import bdg_real
from ..models.lattice import LatticeSpec
from ..models.params import make_params
from ..ops.ph_eigh import diagonalize_embedding_ph
from ..utils.device import resolve_device
from ..utils.precision import PRECISIONS
from ..utils.profiling import call_ms


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--L", type=int, default=16)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--n_lift", type=int, default=None,
                   help="fixed-coefficient lift steps; default = the "
                        "minimax schedule")
    p.add_argument("--orth", default="chol")
    p.add_argument("--lift_prec", default="high", choices=PRECISIONS)
    p.add_argument("--skip_qdwh", action="store_true")
    p.add_argument("--floor", type=float, default=1e-5,
                   help="spectral floor |E|min/||M|| selecting the "
                        "minimax lift schedule")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def build_batch(L: int, batch: int, generator: torch.Generator,
                device) -> torch.Tensor:
    """``batch`` float32 embeddings (batch, 4N, 4N) of an L×L lattice: the
    band t = 1, t′ = −0.35, μ = −1.08, on-site disorder U(−0.5, 0.5), and
    bond fields Re Δ ~ N(0.04, 0.05²), Im Δ ~ N(0, 0.05²)."""
    lat = LatticeSpec(L, L)
    N = lat.n_sites
    gdev = generator.device
    dis = torch.rand((batch, N), generator=generator, dtype=torch.float64,
                     device=gdev) - 0.5
    dre = torch.randn((batch, N, 2), generator=generator,
                      dtype=torch.float64, device=gdev) * 0.05 + 0.04
    dim = torch.randn((batch, N, 2), generator=generator,
                      dtype=torch.float64, device=gdev) * 0.05
    dis, dre, dim = (x.to(device) for x in (dis, dre, dim))
    band = make_params(t=1.0, tp=-0.35, mu=-1.08, dtype=torch.float64,
                       device=device)
    M = bdg_real.assemble_embedding(
        lat, bdg_real.static_embedding(lat, band.t, band.tp, band.mu, dis),
        dre, dim)
    return M.to(torch.float32)


def race(M: torch.Tensor, ns: argparse.Namespace, log=print):
    """(the JSON record, the PH solver's output (evals, X, Y)) for the
    batch ``M``."""
    def ph(m):
        return diagonalize_embedding_ph(m, n_lift=ns.n_lift, orth=ns.orth,
                                        lift_precision=ns.lift_prec,
                                        floor=ns.floor)

    times, out_ph = call_ms(lambda: ph(M), ns.reps, M.device)
    t_ph = min(times)
    log(f"ph: {t_ph:.1f} ms")
    res = {"shape": list(M.shape), "ph_ms": t_ph, "n_lift": ns.n_lift,
           "orth": ns.orth, "lift_prec": ns.lift_prec, "floor": ns.floor}
    if not ns.skip_qdwh:
        times, out_q = call_ms(lambda: bdg_real.diagonalize_embedding(M),
                               ns.reps, M.device)
        t_q = min(times)
        log(f"qdwh: {t_q:.1f} ms")
        res.update(qdwh_ms=t_q, speedup=t_q / t_ph)
    else:
        out_q = bdg_real.diagonalize_embedding(M)
    res["eval_err"] = float((out_ph[0] - out_q[0]).abs().max())

    # residual per column: ||M v − w v||, the worst one
    w, X, Y = out_ph
    V = torch.cat([X, Y], dim=-2)
    R = M @ V - V * w[..., None, :]
    res["max_res_colnorm"] = float(torch.linalg.vector_norm(R, dim=-2).max())
    return res, out_ph


def main(argv=None) -> dict:
    ns = parser().parse_args(argv)
    device = resolve_device(ns.device)
    gen = torch.Generator(device=device).manual_seed(0)
    M = build_batch(ns.L, ns.batch, gen, device)
    dim = M.shape[-1]
    print(f"shapes: ({ns.batch},{dim},{dim})", file=sys.stderr)
    res, _ = race(M, ns, log=lambda s: print(s, file=sys.stderr))
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
