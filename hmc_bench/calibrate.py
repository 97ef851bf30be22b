"""The readings a cell's limits are set from: the check's numbers for the
program on many seeds and for its control on a few, in one process.

    python3 -m hmc_bench.calibrate --workload <cell> --seeds 1,2,3
        [--control-seeds 4,5,6] [--seconds 51] [--out file.jsonl]

The control is the program with every float32 product in one TF32 pass
(``torch.backends.cuda.matmul.allow_tf32``, the port's "default"
precision), the precision below the IEEE float32 that the configuration
states.  The flag is set after the program's import, which turns it off,
and read at every ``seg_fn`` call: a run in which it is not what the run
asks for raises, and each record gives the values it was seen at
(``tf32``).  Each run is a whole set-up, a window of ``--seconds`` and the
reference check, as ``hmc_bench.run`` makes them; a run that raises is
recorded with its error.  One JSON line a run on standard output (and in
``--out``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import torch

from . import check
from .harness import load_cell, run_cell


def one(cell, seed: int, seconds: float, control: bool, dev) -> dict:
    import dwavehmc_tpu_torch  # noqa: F401 — its import sets the flag off

    seen = set()

    def watch(seg_fn):
        def step(*a, **k):
            seen.add(torch.backends.cuda.matmul.allow_tf32)
            return seg_fn(*a, **k)
        return step

    torch.backends.cuda.matmul.allow_tf32 = control
    t0 = time.time()
    try:
        run = run_cell(cell, seed, seconds, False, dev, wrap_seg=watch)
        if seen != {control}:
            raise RuntimeError(f"TF32 read {sorted(seen)} in a run with "
                               f"control={control}")
        torch.cuda.empty_cache()
        t1 = time.time()
        values = check.readings(cell, run, seed, dev)
        correct, _ = check.judge(values, cell.limits["limits"])
        return {"seed": seed, "control": control, "tf32": sorted(seen),
                "correct": correct, "readings": values, "setup_s": run.setup_s,
                "window_s": run.window_s, "periods": len(run.periods),
                "traj_per_s": run.attempted / run.window_s,
                "acceptance": run.accepted / run.attempted,
                "failed": run.failed, "check_s": time.time() - t1,
                "counters": run.counters}
    except Exception as e:  # noqa: BLE001 — a control may crash; recorded
        return {"seed": seed, "control": control, "tf32": sorted(seen),
                "error": repr(e)[:400],
                "trace": traceback.format_exc()[-2000:],
                "seconds": time.time() - t0}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--out")
    ns = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(ns.workload)
    dev = torch.device("cuda", 0)
    plan = ([(int(s), False) for s in ns.seeds.split(",") if s]
            + [(int(s), True) for s in ns.control_seeds.split(",") if s])
    for seed, control in plan:
        rec = one(cell, seed, ns.seconds, control, dev)
        rec["workload"] = ns.workload
        line = json.dumps(rec)
        print(line, flush=True)
        if ns.out:
            with open(ns.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
