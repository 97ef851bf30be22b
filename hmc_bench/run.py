"""Run one cell of the port's benchmark once and print its result line.

    python3 -m hmc_bench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Measures ``dwavehmc_tpu_torch`` on the CUDA device and nothing else: it
refuses to run without enough cards, and it prints no result if the JAX
package, ``jax``, ``jaxlib`` or ``flax`` is loaded once the window has
closed.  With ``--trace 0`` the line's metrics are the cell's end-to-end
ones; with ``--trace 1`` its per-layer ones, read from a ``torch.profiler``
trace of whole periods at the window's start (``harness.TRACE_MIN_S``).
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``check``: each number compared with its limit,
which the last lines of standard error repeat.
"""

from __future__ import annotations

import time

IMPORTED = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

#: top-level module names the measured process may not hold
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "dwavehmc_tpu"})

#: exit codes: no card, the program missing, a forbidden module loaded,
#: a cell that the files do not define
NO_DEVICE, NO_PROGRAM, FORBIDDEN_LOADED, BAD_CELL = 2, 3, 4, 5


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of ``FORBIDDEN``, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    line = out.stdout.strip().splitlines()
    return line[0].strip() if out.returncode == 0 and line else None


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def setup_env() -> None:
    """Before torch is imported: fixed compile caches inside the checkout
    (the program's own nvcc build is ``build/kernels``), one host thread
    for the CPU's thread pools (the run's host work is dispatch, which
    spinning pool threads only disturb), and no JAX through a library."""
    build = Path(__file__).resolve().parents[1] / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(build / "torch_extensions"))
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def started_at() -> float:
    """The process's start, or this module's import where ``/proc``
    disagrees with it by more than a minute."""
    from .harness import process_start

    t = process_start()
    return t if IMPORTED - 60.0 <= t <= IMPORTED else IMPORTED


def result_line(cell, run, trace: bool, correct: bool, table: dict,
                kind: str, power: str | None) -> dict:
    """The result's JSON object: with ``trace`` the cell's per-layer
    metrics and the trace's breakdown, else its end-to-end metrics; the
    check's table last."""
    from .harness import per_layer

    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": run.peak_bytes, "power_limit": power}
    if trace:
        metrics = per_layer(cell, run)
        if run.traced is not None:
            device.update(busy_s=run.traced.busy_s,
                          window_s=run.traced.window_s)
    else:
        metrics = {
            "traj_per_s": {"value": run.attempted / run.window_s,
                           "unit": "traj/s"},
            "acceptance": {"value": run.accepted / run.attempted,
                           "unit": "fraction"},
            "peak_mem_gib": {"value": run.peak_bytes / 2**30, "unit": "GiB"},
            "setup_s": {"value": run.setup_s, "unit": "s"}}
    line = {"correct": correct, "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics, "device": device}
    if trace and run.traced is not None:
        line["breakdown"] = {"device_ops": run.traced.device_ops,
                             "idle_gaps": run.traced.idle_gaps}
    line["check"] = table
    return line


def main(argv=None) -> int:
    ns = parser().parse_args(argv)
    setup_env()
    started = started_at()
    import torch

    torch.set_num_threads(1)
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    from . import check
    from .harness import load_cell, run_cell

    try:
        cell = load_cell(ns.workload)
    except (KeyError, OSError, ValueError) as e:
        log(f"hmc_bench: {e}")
        return BAD_CELL
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        log(f"hmc_bench: {ns.workload} needs {cell.chips} CUDA device(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}, "
            f"device_count={torch.cuda.device_count()}. No result.")
        return NO_DEVICE
    try:
        import dwavehmc_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"hmc_bench: the program dwavehmc_tpu_torch is missing: {e}")
        return NO_PROGRAM

    dev = torch.device("cuda", 0)
    run = run_cell(cell, ns.seed, ns.seconds, bool(ns.trace), dev,
                   started=started)
    kind = torch.cuda.get_device_name(dev)
    secs = sorted(p.seconds for p in run.periods)
    log(f"hmc_bench: {cell.name} seed={ns.seed} window {run.window_s:.3f} s, "
        f"{len(run.periods)} periods (s: min {secs[0]:.4f}, median "
        f"{secs[len(secs) // 2]:.4f}, max {secs[-1]:.4f}), {run.attempted} "
        f"traj, setup {run.setup_s:.3f} s, counters "
        f"{json.dumps(run.counters)}")

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    values = check.readings(cell, run, ns.seed, dev)
    correct, table = check.judge(values, cell.limits["limits"])
    log(f"hmc_bench: reference check {time.perf_counter() - t0:.1f} s, "
        f"sampled {values['sampled']}, readings "
        f"{json.dumps({k: v for k, v in values.items() if k != 'sampled'})}")
    loaded = forbidden_modules()
    if loaded:
        log(f"hmc_bench: forbidden modules loaded: {loaded}. No result.")
        return FORBIDDEN_LOADED

    line = result_line(cell, run, bool(ns.trace), correct, table, kind,
                       power_limit())
    for name, row in table.items():
        log(f"check {name} {row['value']} limit {row['limit']}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
