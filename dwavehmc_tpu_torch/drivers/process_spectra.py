"""Post-process the spectra bins of one run or of a whole scan tree (port
of ``scripts/process_spectra.py``; numpy only, no device):

    python -m dwavehmc_tpu_torch.drivers.process_spectra RUN_DIR
    python -m dwavehmc_tpu_torch.drivers.process_spectra SCAN_ROOT --batch \\
        [--pattern 'T_*']

Each run's ``spectra_bins.npz`` becomes its processed_{opt_cond,dos,dos_AN,
ak0}.csv (``drivers/postprocess.process_spectra``).
"""

from __future__ import annotations

import argparse
import sys

from .postprocess import batch_process_spectra, process_spectra


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("path")
    p.add_argument("--batch", action="store_true")
    p.add_argument("--pattern", default="*")
    return p


def main(argv=None) -> None:
    ns = parser().parse_args(argv)
    if ns.batch:
        res = batch_process_spectra(ns.path, ns.pattern)
        for d in res["processed"]:
            print("processed", d)
        for d, err in res["failed"].items():
            print("FAILED", d, err)
    else:
        info = process_spectra(ns.path)
        print(f"processed {ns.path}: {info['n_bins']} bins")


if __name__ == "__main__":
    main(sys.argv[1:])
