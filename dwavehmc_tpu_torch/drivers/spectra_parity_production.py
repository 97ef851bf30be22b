"""Production-shape spectra parity (port of
``scripts/spectra_parity_production.py``):

    python -m dwavehmc_tpu_torch.drivers.spectra_parity_production
        [--device cuda|cpu] [--checkpoint PATH]
        [--out runs/spectra_parity_24x24.json]

Takes the flagship T scan's checkpointed final states at T = 0.0135031
(mid-transition; ``examples/T_scan_full_24x24/scan_checkpoint.npz``, read
only, chains 21–23 of the point-major 24×3 layout) and computes the full
transport and spectra suite twice from the same state:

* the production leg: the float32 real path, the embedding's exact eigh
  (``models/bdg_real.diagonalize_embedding``, through ``symmetric_eigh``),
  the real-pair matrix elements and σ(ω)/σ_DC through the Lorentzian
  kernel K2 on the card (``measure_transport_and_spectra_real``);
* the oracle leg: the complex128 eigh of ``assemble_bdg`` and the float64
  complex-path measurement (``measure_transport_and_spectra``) with K2's
  plain version (``ops/kernels.weighted_lorentzian_sum_plain``) for its
  σ(ω)/σ_DC sums and the f-sums' σ(ω), so the leg stays in float64 on the
  card too and never runs K2: a fault of K2 cannot show in both legs.

Same state ⇒ every difference is numerics.  Tolerances (stated, checked,
recorded): eigenvalues within 5e-5·‖E‖∞; ρ_s, σ_DC and every spectral grid
within 2e-3 of that observable's oracle peak.  Also records the f-sum check
on the oracle at the production grid and at a tight-η grid.  ``pass``
false exits nonzero.

The real path keeps every second eigenvector of the embedding, as the JAX
package does; the checkpoint's thermalized states are non-degenerate, so
that is harmless here (ROADMAP F0).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..models.bdg import assemble_bdg, static_hamiltonian
from ..models.bdg_real import (
    assemble_embedding,
    diagonalize_embedding,
    static_embedding,
    symmetric_eigh,
)
from ..models.lattice import LatticeSpec
from ..models.params import HMCState, SpectralSpec, make_params
from ..models.transport import (
    current_matrix_elements,
    f_sum_check,
    measure_transport_and_spectra,
    optical_conductivity,
)
from ..models.transport_real import measure_transport_and_spectra_real
from ..ops.kernels import weighted_lorentzian_sum_plain
from ..ops.spectral import fermi_factors
from ..sampler.hmc_real import HMCStateReal
from ..utils.device import resolve_device
from .validate_cheap_anchor import device_label, log

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CHECKPOINT = os.path.join(REPO, "examples", "T_scan_full_24x24",
                          "scan_checkpoint.npz")
DEFAULT_OUT = os.path.join("runs", "spectra_parity_24x24.json")
T_POINT = 0.0135031
POINT_INDEX = 7          # ascending 24-point grid; chains 21-23
REPLICAS = 3
#: the production couplings (the scan's ``scan_config.json``)
PHYS = dict(t=1.0, tp=-0.35, mu=-1.08, W=1.0, n_imp=0.05, J=0.8, mass=1.0)
#: the verdict's tolerances
TOL_EV = 5e-5
TOL_REL = 2e-3
OBSERVABLES = ("superfluid_stiffness", "dc_conductivity",
               "optical_conductivity", "dos", "dos_AN", "A_k0")


def production_spec(lat: LatticeSpec) -> SpectralSpec:
    N = lat.n_sites
    return SpectralSpec(eta=8.0 / N, domega=0.2 * 8.0 / N, omega_max=4.0)


def _host(result) -> dict:
    """A one-chain ``SpectrumResult`` as float64 numpy arrays."""
    return {k: v[0].detach().to("cpu", torch.float64).numpy()
            for k, v in result._asdict().items()}


def production_state(lat, delta, disorder, beta, device):
    """(float32 params, one-chain ``HMCStateReal``) with the embedding's
    exact eigenpairs, for one chain's ``delta`` (N, 2) complex and
    ``disorder`` (N,)."""
    p32 = make_params(beta=beta, dtype=torch.float32, device=device, **PHYS)
    f32 = dict(dtype=torch.float32, device=p32.beta.device)
    dre = torch.as_tensor(np.real(delta)[None], **f32)
    dim_ = torch.as_tensor(np.imag(delta)[None], **f32)
    dis = torch.as_tensor(np.asarray(disorder)[None], **f32)
    M = assemble_embedding(
        lat, static_embedding(lat, p32.t, p32.tp, p32.mu, dis), dre, dim_)
    ev, X, Y = diagonalize_embedding(M)
    z = torch.zeros_like(dre)
    return p32, HMCStateReal(dre, dim_, z, z, dis, ev, X, Y)


def production_measurement(lat, spec, params, state):
    """(sorted eigenvalues, observables) of the real-path measurement."""
    prod = measure_transport_and_spectra_real(lat, spec, params, state)
    return (np.sort(state.evals[0].to("cpu", torch.float64).numpy()),
            _host(prod))


def production_leg(lat, spec, delta, disorder, beta, device):
    """The float32 real path for one chain: (sorted eigenvalues,
    observables)."""
    return production_measurement(
        lat, spec, *production_state(lat, delta, disorder, beta, device))


def oracle_leg(lat, spec, delta, disorder, beta, device):
    """(eigenvalues, observables, f-sum record) of the complex128 eigh and
    the float64 complex-path measurement for one chain, every Lorentzian
    sum through K2's plain version in float64 (no K2 launch)."""
    p64 = make_params(beta=beta, dtype=torch.float64, device=device, **PHYS)
    dev = p64.beta.device
    d64 = torch.as_tensor(np.asarray(delta)[None], dtype=torch.complex128,
                          device=dev)
    dis = torch.as_tensor(np.asarray(disorder)[None], dtype=torch.float64,
                          device=dev)
    H = assemble_bdg(lat, static_hamiltonian(lat, p64.t, p64.tp, p64.mu,
                                             dis), d64)
    ev, U = symmetric_eigh(H)
    st = HMCState(delta=d64, pi=torch.zeros_like(d64), disorder=dis,
                  evals=ev, evecs=U)
    orac = measure_transport_and_spectra(
        lat, spec, p64, st, lorentzian_sum=weighted_lorentzian_sum_plain)

    # f-sum on the oracle state: the production grid + a tight-η control
    N = lat.n_sites
    f = fermi_factors(ev, p64.beta)
    J2 = torch.abs(current_matrix_elements(lat, U, p64.t, p64.tp)) ** 2
    om = torch.as_tensor(spec.omega_grid(), dtype=torch.float64, device=dev)
    _, _, rel = f_sum_check(om, orac.optical_conductivity, ev, f, J2, N)
    spec_t = SpectralSpec(eta=0.005, domega=0.002, omega_max=14.0)
    om_t = torch.as_tensor(spec_t.omega_grid(), dtype=torch.float64,
                           device=dev)
    sig_t = optical_conductivity(
        om_t, ev, f, J2, spec_t.eta, N,
        lorentzian_sum=weighted_lorentzian_sum_plain)
    _, _, rel_t = f_sum_check(om_t, sig_t, ev, f, J2, N)
    f_sum = {"production_grid_rel_err": round(float(rel[0]), 4),
             "tight_eta_rel_err": round(float(rel_t[0]), 4)}
    return ev[0].to("cpu").numpy(), _host(orac), f_sum


def diff(a, b) -> dict:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    peak = max(np.abs(b).max(), 1e-30)
    return {"max_abs": float(np.abs(a - b).max()),
            "rel_to_peak": float(np.abs(a - b).max() / peak),
            "oracle_peak": float(peak)}


def compare(prod_leg, oracle) -> dict:
    """The JAX script's per-chain record of the production leg ``(evals,
    observables)`` against the oracle ``(evals, observables, ...)``."""
    ev32, prod = prod_leg
    ev64, orac = oracle[0], oracle[1]
    row = {"eigh_evals": {"max_abs": float(np.abs(ev32 - ev64).max()),
                          "scale": float(np.abs(ev64).max())}}
    for k in ("superfluid_stiffness", "dc_conductivity"):
        row[k] = {"production": float(prod[k]), "oracle": float(orac[k]),
                  **diff(prod[k], orac[k])}
    for k in ("optical_conductivity", "dos", "dos_AN", "A_k0"):
        row[k] = diff(prod[k], orac[k])
    return row


def compare_chain(lat, spec, delta, disorder, beta, device) -> dict:
    """Both legs on ``device`` for one chain, compared, with the oracle's
    f-sum record."""
    oracle = oracle_leg(lat, spec, delta, disorder, beta, device)
    row = compare(production_leg(lat, spec, delta, disorder, beta, device),
                  oracle)
    row["f_sum"] = oracle[2]
    return row


def verdict(rows) -> bool:
    ok = True
    for r in rows:
        ok &= r["eigh_evals"]["max_abs"] <= TOL_EV * r["eigh_evals"]["scale"]
        for k in OBSERVABLES:
            ok &= r[k]["rel_to_peak"] <= TOL_REL
    return bool(ok)


def parity(checkpoint: str, device, log=log) -> dict:
    device = resolve_device(device)
    lat = LatticeSpec(24, 24)
    beta = 1.0 / T_POINT
    spec = production_spec(lat)
    ck = np.load(checkpoint)
    chains = range(POINT_INDEX * REPLICAS, (POINT_INDEX + 1) * REPLICAS)
    log(f"spectra_parity_production: device={device_label(device)}")

    results = []
    for c in chains:
        delta = ck["delta"][c]               # (N, 2) complex64
        disorder = ck["disorder"][c]         # (N,) float32
        log(f"chain {c}: |delta| mean {np.abs(delta).mean():.4f}")
        row = {"chain": int(c),
               **compare_chain(lat, spec, delta, disorder, beta, device)}
        results.append(row)
        log(f"chain {c}: rho_s prod="
            f"{row['superfluid_stiffness']['production']:.5f}"
            f" oracle={row['superfluid_stiffness']['oracle']:.5f}; "
            f"sigma(w) rel={row['optical_conductivity']['rel_to_peak']:.2e};"
            f" f-sum rel={row['f_sum']['production_grid_rel_err']}")

    return {
        "T": T_POINT, "beta": beta, "lattice": "24x24",
        "device": device_label(device),
        "state_source": ("examples/T_scan_full_24x24/scan_checkpoint.npz "
                         f"chains {list(chains)} (point-major layout)"),
        "production_leg": ("float32 real-symmetric-embedding eigh "
                           "(symmetric_eigh) + real-pair transport + "
                           "sigma(w)/DC through the Lorentzian kernel K2 "
                           "on the card"),
        "oracle_leg": ("complex128 BdG eigh + float64 complex measurement "
                       "(its sigma(w)/DC sums through the plain float64 "
                       "Lorentzian sum, not K2)"),
        "tolerances": {"eigh_evals_rel": TOL_EV,
                       "observables_rel_to_peak": TOL_REL},
        "pass": verdict(results),
        "chains": results,
    }


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", default=CHECKPOINT)
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def main(argv=None) -> dict:
    ns = parser().parse_args(argv)
    out = parity(ns.checkpoint, ns.device)
    os.makedirs(os.path.dirname(os.path.abspath(ns.out)), exist_ok=True)
    with open(ns.out, "w") as f:
        json.dump(out, f, indent=1)
    log(f"wrote {ns.out}")
    print(json.dumps({"pass": out["pass"],
                      "sigma_rel": [r["optical_conductivity"]["rel_to_peak"]
                                    for r in out["chains"]]}))
    if not out["pass"]:
        raise SystemExit("spectra_parity_production: outside the tolerances")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
