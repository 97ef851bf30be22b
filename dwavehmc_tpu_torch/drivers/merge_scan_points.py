"""Merge re-run scan points into an existing scan directory (port of
``scripts/merge_scan_points.py``; numpy only):

    python -m dwavehmc_tpu_torch.drivers.merge_scan_points \\
        --target examples/T_scan_full_24x24 \\
        --donor examples/T_scan_cold_host_24x24 --param T --note host_readout

A subset of a scan's points re-run under other settings (for example the
cold end under the host float64 readout) replaces the same points of the
target:

 1. each ``<param>_<value>`` point directory of the donor is copied over the
    target's (a donor point the target lacks is refused);
 2. ``summary_all.csv`` is regenerated from the merged per-point CSVs;
 3. ``therm_health.json`` is merged, the donor's entry winning for its
    points;
 4. ``provenance.json`` records which run and readout measured each merged
    point.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

from .postprocess import summarize_scan


def load_json(path: str) -> dict:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--target", required=True)
    p.add_argument("--donor", required=True)
    p.add_argument("--param", default="T", help="scan parameter prefix")
    p.add_argument("--note", required=True,
                   help="provenance note for the merged points, e.g. "
                        "'host_readout + beta-ladder warm start'")
    return p


def merge(target: str, donor: str, param: str, note: str) -> str:
    """Merge ``donor``'s points into ``target``; the regenerated summary's
    path."""
    prefix = param + "_"
    donor_pts = sorted(d for d in os.listdir(donor)
                       if d.startswith(prefix)
                       and os.path.isdir(os.path.join(donor, d)))
    if not donor_pts:
        sys.exit(f"no {prefix}* point dirs in {donor}")

    target_pts = {d for d in os.listdir(target) if d.startswith(prefix)}
    for d in donor_pts:
        if d not in target_pts:
            sys.exit(f"donor point {d} has no counterpart in {target} "
                     "(grid mismatch — refusing to add new points)")

    donor_cfg = load_json(os.path.join(donor, "scan_config.json"))
    prov = load_json(os.path.join(target, "provenance.json"))
    points = prov.setdefault("points", {})
    for d in donor_pts:
        src, dst = os.path.join(donor, d), os.path.join(target, d)
        # the donor's copy is staged beside the target point and swapped in,
        # so a failure while copying leaves the target point whole
        tmp = dst + ".merge_tmp"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        shutil.copytree(src, tmp)
        # target-only files (processed_*.csv) describe the replaced data:
        # they are dropped, with a warning to regenerate them
        donor_files = set(os.listdir(src))
        lost = sorted(f for f in os.listdir(dst) if f not in donor_files)
        if lost:
            print(f"WARNING: {d}: target-only files dropped by merge "
                  f"(regenerate from the new bins): {', '.join(lost)}",
                  file=sys.stderr)
        shutil.rmtree(dst)
        os.rename(tmp, dst)
        points[d] = {
            "source": donor,
            "note": note,
            "metropolis_readout": donor_cfg.get("metropolis_readout"),
            "anneal_stages": donor_cfg.get("anneal_stages"),
        }
        print(f"merged {d}", file=sys.stderr)
    prov.setdefault(
        "default",
        "points not listed here are from the original scan run "
        "(device-f32 Metropolis readout, cold start)")

    th_t = load_json(os.path.join(target, "therm_health.json"))
    th_d = load_json(os.path.join(donor, "therm_health.json"))
    for d in donor_pts:
        if d in th_d:
            th_t[d] = th_d[d]
    with open(os.path.join(target, "therm_health.json"), "w") as f:
        json.dump(th_t, f, indent=1)
    with open(os.path.join(target, "provenance.json"), "w") as f:
        json.dump(prov, f, indent=1)
    return summarize_scan(target, prefix, param)


def main(argv=None) -> str:
    ns = parser().parse_args(argv)
    out = merge(ns.target, ns.donor, ns.param, ns.note)
    print(f"summary regenerated: {out}")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
