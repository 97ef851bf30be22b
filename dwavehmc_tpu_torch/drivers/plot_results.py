"""Publication plots from processed scan outputs (port of
``scripts/plot_results.py``):

    python -m dwavehmc_tpu_torch.drivers.plot_results ROOT [--prefix T_]
        [--out DIR]

Per scan root (after ``process_spectra --batch`` and ``summarize_scan``):

* sigma_omega.png  — Re σ(ω) with SEM bands, one curve per scan point
* dos.png          — N(ω) and the antinodal DOS
* ak0_<point>.png  — the Fermi-surface map A(k, 0)
* stiffness.png    — ρ_s against the scan value (``summary_all.csv``)
* order_params.png — the Δ order parameters against the scan value, with
  the power-law fit of Δ_localpair/Δ_loc over the high-T tail
  (``powerlaw_fit.json``)

It needs matplotlib (Agg backend), imported when it runs; without it the
run stops with an ``ImportError`` that says so.  It reads files only: no
device is involved.
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import sys

import numpy as np

from .postprocess import fit_power_law


def read_grid_csv(path):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    x = np.array([float(r[list(rows[0])[0]]) for r in rows])
    m = np.array([float(r["Mean"]) for r in rows])
    s = np.array([float(r["SEM"]) for r in rows])
    return x, m, s


def pyplot():
    """matplotlib's pyplot on the Agg backend."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plot_results needs matplotlib, which is not "
                          "installed in this environment") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("root")
    p.add_argument("--prefix", default="T_")
    p.add_argument("--out", default=None)
    return p


def plot(root: str, prefix: str, out: str, plt) -> None:
    dirs = sorted(d for d in glob.glob(os.path.join(root, prefix + "*"))
                  if os.path.isdir(d))

    # σ(ω) curves
    fig, ax = plt.subplots(figsize=(6, 4))
    for d in dirs:
        pth = os.path.join(d, "processed_opt_cond.csv")
        if not os.path.exists(pth):
            continue
        w, m, s = read_grid_csv(pth)
        ax.plot(w, m, label=os.path.basename(d), lw=1)
        ax.fill_between(w, m - s, m + s, alpha=0.25)
    ax.set_xlabel(r"$\omega$")
    ax.set_ylabel(r"Re $\sigma(\omega)$")
    ax.legend(fontsize=6)
    fig.tight_layout()
    fig.savefig(os.path.join(out, "sigma_omega.png"), dpi=150)
    plt.close(fig)

    # DOS
    fig, ax = plt.subplots(figsize=(6, 4))
    for d in dirs:
        pth = os.path.join(d, "processed_dos.csv")
        if not os.path.exists(pth):
            continue
        w, m, s = read_grid_csv(pth)
        ax.plot(w, m, lw=1, label=os.path.basename(d))
        pth2 = os.path.join(d, "processed_dos_AN.csv")
        if os.path.exists(pth2):
            w2, m2, _ = read_grid_csv(pth2)
            ax.plot(w2, m2, lw=1, ls="--")
    ax.set_xlabel(r"$\omega$")
    ax.set_ylabel(r"$N(\omega)$ (solid), antinodal (dashed)")
    ax.legend(fontsize=6)
    fig.tight_layout()
    fig.savefig(os.path.join(out, "dos.png"), dpi=150)
    plt.close(fig)

    # A(k,0) maps
    for d in dirs:
        pth = os.path.join(d, "processed_ak0.csv")
        if not os.path.exists(pth):
            continue
        with open(pth) as f:
            rows = list(csv.DictReader(f))
        kx = sorted({float(r["kx"]) for r in rows})
        ky = sorted({float(r["ky"]) for r in rows})
        A = np.zeros((len(kx), len(ky)))
        for r in rows:
            A[kx.index(float(r["kx"])),
              ky.index(float(r["ky"]))] = float(r["A"])
        fig, ax = plt.subplots(figsize=(4.5, 4))
        im = ax.pcolormesh(kx, ky, A.T, shading="nearest", cmap="inferno")
        fig.colorbar(im, ax=ax)
        ax.set_xlabel(r"$k_x$")
        ax.set_ylabel(r"$k_y$")
        ax.set_title(f"A(k, 0) — {os.path.basename(d)}", fontsize=8)
        fig.tight_layout()
        fig.savefig(os.path.join(out, f"ak0_{os.path.basename(d)}.png"),
                    dpi=150)
        plt.close(fig)

    summary = os.path.join(root, "summary_all.csv")
    if os.path.exists(summary):
        summary_plots(summary, out, plt)


def summary_plots(summary: str, out: str, plt) -> None:
    with open(summary) as f:
        rows = list(csv.DictReader(f))
    name = list(rows[0])[0]
    x = np.array([float(r[name]) for r in rows])

    def col(c):
        return np.array([float(r[c]) for r in rows if c in r])

    if "Superfluid_Stiffness_mean" in rows[0]:
        fig, ax = plt.subplots(figsize=(5, 4))
        ax.errorbar(x, col("Superfluid_Stiffness_mean"),
                    yerr=col("Superfluid_Stiffness_sem"), marker="o")
        ax.set_xscale("log")
        ax.set_xlabel(name)
        ax.set_ylabel(r"$\rho_s$")
        fig.tight_layout()
        fig.savefig(os.path.join(out, "stiffness.png"), dpi=150)
        plt.close(fig)

    fig, ax = plt.subplots(figsize=(5, 4))
    for c, lbl in (("Delta_Glob_mean", r"$\Delta_{glob}$"),
                   ("Delta_Pair_mean", r"$\Delta_{pair}$"),
                   ("Delta_Amp_mean", r"$\Delta_{amp}$")):
        if c in rows[0]:
            ax.errorbar(x, col(c), yerr=col(c.replace("_mean", "_sem")),
                        marker="o", ms=3, label=lbl)

    # log-log power-law fit of Δ_localpair/Δ_loc over the high-T tail
    # T > 10, where the pairing is thermal-fluctuation-dominated (the
    # reference notebook's mask); short scans fit the whole range
    if "Delta_LocalPair_mean" in rows[0] and "Delta_Loc_mean" in rows[0]:
        try:
            ratio = col("Delta_LocalPair_mean") / col("Delta_Loc_mean")
            mask = x > 10
            window = f"{name} > 10"
            if mask.sum() < 2:
                mask = np.ones_like(x, dtype=bool)
                window = "all points"
            a, b, n_used = fit_power_law(x[mask], ratio[mask])
            xs = np.logspace(np.log10(x[mask].min()),
                             np.log10(x[mask].max()), 50)
            ax.plot(xs, a * xs**b, "k:", lw=1,
                    label=rf"fit $\Delta_{{lp}}/\Delta_{{loc}} \propto "
                          rf"{name}^{{{b:.3f}}}$")
            print(f"power-law fit: Delta_LocalPair/Delta_Loc ~ "
                  f"{a:.4g} * {name}^{b:.4f} ({n_used} points, "
                  f"{window} window)")
            with open(os.path.join(out, "powerlaw_fit.json"), "w") as f:
                json.dump({"observable": "Delta_LocalPair/Delta_Loc",
                           "vs": name, "window": window,
                           "prefactor": a, "exponent": b,
                           "n_points": n_used}, f, indent=2)
        except ValueError as e:
            print(f"power-law fit skipped: {e}")

    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel(name)
    ax.legend()
    fig.tight_layout()
    fig.savefig(os.path.join(out, "order_params.png"), dpi=150)
    plt.close(fig)


def main(argv=None) -> str:
    ns = parser().parse_args(argv)
    out = ns.out or ns.root
    plot(ns.root, ns.prefix, out, pyplot())
    print("plots written to", out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
