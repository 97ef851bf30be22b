"""Post-processing: spectra statistics and scan summaries (port of
``dwavehmc_tpu/drivers/postprocess.py``, numpy only).

 * ``process_spectra``       — mean/SEM over bins → processed_{opt_cond,dos,
   dos_AN,ak0}.csv, k mapped to [−π, π)
 * ``batch_process_spectra`` — every scan subdir, one failure per dir
   isolated
 * ``summarize_scan``        — mean/SEM of every observables.csv +
   transport.csv column except Sweep/Chain, one row per scan point, sorted
   by the scan value, into summary_all.csv
"""

from __future__ import annotations

import csv
import glob
import os
import re

import numpy as np

from ..utils.io import SpectraBinStore


def _mean_sem(stack: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Mean and standard error over the leading (bin) axis
    (scripts/process_spectra.jl:22-55 semantics)."""
    n = stack.shape[0]
    mean = stack.mean(axis=0)
    if n > 1:
        sem = stack.std(axis=0, ddof=1) / np.sqrt(n)
    else:
        sem = np.zeros_like(mean)
    return mean, sem


def _write_grid_csv(path, xname, x, mean, sem):
    with open(path, "w") as f:
        f.write(f"{xname},Mean,SEM\n")
        for xi, m, s in zip(x, mean, sem):
            f.write(f"{xi:.6g},{m:.6g},{s:.6g}\n")


def process_spectra(run_dir: str) -> dict:
    """Aggregate one run's spectra_bins.npz into processed CSVs.

    Bin arrays may carry a leading chain axis; chains are pooled with the
    bins (every (bin, chain) pair is an independent sample).
    """
    meta, bins = SpectraBinStore.load_bins(
        os.path.join(run_dir, "spectra_bins.npz"))
    if not bins:
        raise ValueError(f"no bins in {run_dir}")

    def stack(field, grid_ndim):
        """(n_bins·[n_chains], *grid): pool the chain axis whenever the
        stored arrays carry one (decided by ndim, not by meta n_chains —
        n_chains=1 runs still store a length-1 chain axis)."""
        arrs = [b[field] for _, b in sorted(bins.items())]
        a = np.stack(arrs)                      # (n_bins, [chains,] *grid)
        if a.ndim == grid_ndim + 2:
            a = a.reshape((-1,) + a.shape[2:])  # pool chains into samples
        return a

    omega = np.asarray(meta["omega_grid"])
    dosgrid = np.asarray(meta["dos_grid"])

    m, s = _mean_sem(stack("opt_cond", 1))
    _write_grid_csv(os.path.join(run_dir, "processed_opt_cond.csv"),
                    "Omega", omega, m, s)
    m, s = _mean_sem(stack("dos", 1))
    _write_grid_csv(os.path.join(run_dir, "processed_dos.csv"),
                    "Omega", dosgrid, m, s)
    m, s = _mean_sem(stack("dos_AN", 1))
    _write_grid_csv(os.path.join(run_dir, "processed_dos_AN.csv"),
                    "Omega", dosgrid, m, s)

    # A(k,0): average map, k mapped to [−π, π) via fftshift
    ak = stack("A_k0", 2)
    ak_mean = ak.mean(axis=0)
    Lx, Ly = ak_mean.shape
    kx = 2 * np.pi * (np.fft.fftfreq(Lx))       # in (−π, π]
    ky = 2 * np.pi * (np.fft.fftfreq(Ly))
    order_x = np.argsort(kx)
    order_y = np.argsort(ky)
    with open(os.path.join(run_dir, "processed_ak0.csv"), "w") as f:
        f.write("kx,ky,A\n")
        for ix in order_x:
            for iy in order_y:
                f.write(f"{kx[ix]:.6g},{ky[iy]:.6g},{ak_mean[ix, iy]:.6g}\n")

    return {"n_bins": len(bins), "omega": omega, "dos_grid": dosgrid}


def batch_process_spectra(scan_root: str, pattern: str = "*") -> dict:
    """process_spectra over every matching subdir; one failure doesn't kill
    the batch (scripts/batch_process_spectra.jl:196-203)."""
    results, failures = {}, {}
    for d in sorted(glob.glob(os.path.join(scan_root, pattern))):
        if not os.path.isdir(d):
            continue
        try:
            results[d] = process_spectra(d)
        except Exception as e:  # noqa: BLE001 — per-dir isolation by design
            failures[d] = str(e)
    return {"processed": results, "failed": failures}


def fit_power_law(x, y) -> tuple[float, float, int]:
    """Least-squares log-log fit y ≈ a·x^b over strictly positive finite
    samples — the Δ_pair-vs-T power-law analysis from the reference's
    plot_stiffness.ipynb notebooks (SURVEY S20).  Returns (a, b, n_used).
    """
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    m = (x > 0) & (y > 0) & np.isfinite(x) & np.isfinite(y)
    if int(m.sum()) < 2:
        raise ValueError("power-law fit needs >= 2 positive finite samples")
    b, loga = np.polyfit(np.log(x[m]), np.log(y[m]), 1)
    return float(np.exp(loga)), float(b), int(m.sum())


def _csv_stats(path: str, skip_cols=("Sweep", "Chain", "Accepted")) -> dict:
    """Column means and SEMs of a per-sweep CSV, excluding index-ish columns
    except Accepted, which is averaged into an acceptance rate."""
    with open(path) as f:
        rows = list(csv.DictReader(f))
    if not rows:
        return {}
    out = {}
    cols = rows[0].keys()
    for c in cols:
        if c == "Accepted":
            out["AccRate"] = np.array(
                [float(r[c]) for r in rows]).mean()
            continue
        if c in skip_cols:
            continue
        vals = np.array([float(r[c]) for r in rows])
        # dH can legitimately be ±inf/nan on strongly rejected proposals
        # (e.g. f32 overflow on a cold-start trajectory — the state is
        # guarded, only the recorded diagnostic blows up); aggregate over
        # the finite entries and surface the count instead of poisoning
        # the whole column mean.
        finite = np.isfinite(vals)
        if not finite.all():
            out[f"{c}_nonfinite"] = int((~finite).sum())
            vals = vals[finite]
        n = len(vals)
        out[f"{c}_mean"] = vals.mean() if n else float("nan")
        out[f"{c}_sem"] = vals.std(ddof=1) / np.sqrt(n) if n > 1 else 0.0
        if c == "DC_Conductivity" and n and not vals.any():
            # every sample exactly 0: at β ≳ 1500 the f32 degenerate-limit
            # weight β·f·(1−f) underflows to 0 (the reference's f64 gives
            # ~1e-300-scale values there — src/Observables.jl:405-424), so
            # an exact-zero σ_DC is an underflow floor, not a measurement;
            # flag it so consumers can tell the two apart
            out["DC_Conductivity_underflow"] = 1
    return out


def summarize_scan(scan_root: str, prefix: str, value_name: str = "T"
                   ) -> str:
    """Aggregate <scan_root>/<prefix><value>/{observables,transport}.csv
    into one summary_all.csv sorted by the scan value
    (scripts/batch_csv_summary_T.jl:23-166)."""
    rows = []
    rx = re.compile(re.escape(prefix) + r"([0-9.eE+-]+)$")
    for d in sorted(glob.glob(os.path.join(scan_root, prefix + "*"))):
        m = rx.search(os.path.basename(d))
        if not m or not os.path.isdir(d):
            continue
        val = float(m.group(1))
        entry = {value_name: val}
        for fname in ("observables.csv", "transport.csv"):
            p = os.path.join(d, fname)
            if os.path.exists(p):
                entry.update(_csv_stats(p))
        rows.append(entry)
    rows.sort(key=lambda r: r[value_name])

    out_path = os.path.join(scan_root, "summary_all.csv")
    if rows:
        # union of keys over all points (e.g. *_nonfinite columns appear
        # only where a point had non-finite diagnostics), first-row order
        # first, extras appended
        keys = [value_name] + [k for k in rows[0] if k != value_name]
        for r in rows[1:]:
            keys += [k for k in r if k not in keys]
        with open(out_path, "w") as f:
            f.write(",".join(keys) + "\n")
            for r in rows:
                # a key missing at this point (e.g. an integer *_nonfinite
                # count only emitted where diagnostics fired) is an EMPTY
                # cell, not a float nan — nan in a count column reads as
                # data corruption
                f.write(",".join(f"{r[k]:.6g}" if k in r else ""
                                 for k in keys) + "\n")
    return out_path
