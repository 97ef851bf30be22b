"""Aggregate the per-point observables/transport CSVs of a scan into one
``summary_all.csv`` (port of ``scripts/summarize_scan.py``; numpy only):

    python -m dwavehmc_tpu_torch.drivers.summarize_scan SCAN_ROOT \\
        --prefix T_ --name T
"""

from __future__ import annotations

import argparse
import sys

from .postprocess import summarize_scan


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("root")
    p.add_argument("--prefix", default="T_")
    p.add_argument("--name", default="T")
    return p


def main(argv=None) -> str:
    ns = parser().parse_args(argv)
    out = summarize_scan(ns.root, ns.prefix, ns.name)
    print("wrote", out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
