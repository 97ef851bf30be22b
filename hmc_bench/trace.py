"""Reduction of a ``torch.profiler`` chrome trace to what the per-layer
metrics read: the device's busy time (the union of its kernel, memcpy and
memset intervals) inside the traced window, its time and launch count by
kernel name and by kernel family, and the longest idle gaps named by what
the host was doing.

A frozen copy of ``dwavehmc_tpu_torch/drivers/analyze_trace.py``'s
``DEVICE_CATS``, ``FAMILIES`` and ``_union_us``, with the port's three
batch-invariant kernels in families of their own (K3 ``chain_sum``, K4
``chain_matvec``, K5 ``sigma_cap``); later changes to the program do not
move it.
"""

from __future__ import annotations

import bisect
import collections
import gzip
import json
from typing import NamedTuple

#: event categories ``torch.profiler`` gives the work a CUDA device runs
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

#: kernel-name fragments → family, first match wins ("nvjet": cuBLAS's
#: Hopper GEMM kernels)
FAMILIES = (("rotation_s", "K1 rotation_s"), ("lorentz", "K2 lorentzian"),
            ("chain_sum", "K3 chain_sum"), ("chain_matvec", "K4 chain_matvec"),
            ("sigma_cap", "K5 sigma_cap"),
            ("trsm", "triangular solve"), ("potrf", "cholesky"),
            ("syev", "eigh"), ("sytrd", "eigh"), ("stedc", "eigh"),
            ("ormtr", "eigh"), ("hetrd", "eigh"), ("heev", "eigh"),
            ("unmtr", "eigh"), ("fft", "fft"),
            ("gemm", "matmul"), ("gemv", "matmul"),
            ("cutlass", "matmul"), ("xmma", "matmul"), ("nvjet", "matmul"),
            ("index", "gather/scatter"), ("scatter", "gather/scatter"),
            ("gather", "gather/scatter"), ("reduce", "reduction"),
            ("elementwise", "elementwise"), ("copy", "copy"))

#: host event categories an idle gap is named by, most specific first
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")

#: the user annotation the harness puts around each traced period
PERIOD = "hmc_bench.period"

TOP = 10


def family(name: str) -> str:
    low = name.lower()
    return next((f for frag, f in FAMILIES if frag in low), "other")


def union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


class Reduced(NamedTuple):
    """The traced window, reduced.  Times in seconds."""

    window_s: float
    busy_s: float
    kernels: int                 # device kernel launches in the window
    by_name: dict                # kernel name → [launches, seconds]
    families: dict               # family → seconds (kernels, copies, sets)
    device_ops: list             # [[name, seconds]], the TOP longest
    idle_gaps: list              # [[host activity, seconds]], the TOP


def load_events(path: str) -> list:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def _gaps(spans, lo, hi):
    """Idle intervals of the device inside [lo, hi]."""
    out, end = [], lo
    for a, b in sorted(spans):
        if a > end:
            out.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return [(a, b) for a, b in out if b > a]


def _host_index(host):
    """Each category's events sorted by start, with their starts."""
    out = {}
    for cat, evs in host.items():
        evs = sorted(evs)
        out[cat] = ([a for a, _d, _n in evs], evs)
    return out


def _host_name(index, t, look_back: int = 256):
    """The innermost host event (the latest-starting of those that cover
    time ``t``, among the ``look_back`` that start last before it) of the
    most specific category, or "host between ops"."""
    for cat in HOST_CATS:
        if cat not in index:
            continue
        starts, evs = index[cat]
        k = bisect.bisect_right(starts, t)
        for a, d, name in reversed(evs[max(0, k - look_back):k]):
            if a + d >= t:
                return name
    return "host between ops"


def reduce_events(events: list) -> Reduced | None:
    """The window from the first period annotation's start to the last
    one's end; None when the trace has no period or no device work."""
    periods = [(e["ts"], e["ts"] + e.get("dur", 0.0)) for e in events
               if e.get("ph") == "X" and e.get("name") == PERIOD]
    if not periods:
        return None
    lo, hi = min(a for a, _ in periods), max(b for _, b in periods)
    spans, host = [], collections.defaultdict(list)
    by_name = collections.defaultdict(lambda: [0, 0.0])
    families = collections.Counter()
    kernels = 0
    for e in events:
        if e.get("ph") != "X":
            continue
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            a, b = max(ts, lo), min(ts + dur, hi)
            if b <= a:
                continue
            spans.append((a, b))
            name = e.get("name", "?")
            families[family(name)] += (b - a) * 1e-6
            if cat == "kernel":
                kernels += 1
                by_name[name][0] += 1
                by_name[name][1] += (b - a) * 1e-6
        elif cat in HOST_CATS and e.get("name") != PERIOD:
            if ts < hi and ts + dur > lo:
                host[cat].append((ts, dur, e.get("name", "?")))
    if not spans:
        return None
    idle = collections.Counter()
    index = _host_index(host)
    for a, b in _gaps(spans, lo, hi):
        idle[_host_name(index, 0.5 * (a + b))] += (b - a) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP]
    return Reduced(
        window_s=(hi - lo) * 1e-6, busy_s=union_us(spans) * 1e-6,
        kernels=kernels, by_name={k: list(v) for k, v in by_name.items()},
        families=dict(families),
        device_ops=[[name[:160], v[1]] for name, v in top],
        idle_gaps=[[name[:160], s] for name, s in idle.most_common(TOP)])


def reduce_file(path: str) -> Reduced | None:
    return reduce_events(load_events(path))
