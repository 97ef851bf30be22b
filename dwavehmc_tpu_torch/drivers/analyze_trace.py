"""Busy time, duty cycle and top ops of a ``torch.profiler`` chrome trace
(port of ``scripts/analyze_trace.py``):

    python -m dwavehmc_tpu_torch.drivers.analyze_trace <trace_dir>
        [--top 12] [--categories]

Scans ``<trace_dir>`` recursively for ``*.trace.json(.gz)`` (what
``utils/profiling.device_trace`` writes) and prints one JSON
summary per file: for each track (process/thread) its summed event time,
its span and their ratio, and its top ops, as the JAX script reports them.

``torch.profiler`` puts the work a CUDA device ran on one track per
stream (``stream 7``) and tags it with the categories in ``DEVICE_CATS``;
the ``device`` entry of a summary is that work alone: the union of its
intervals (the device's busy time) over the traced window, and its time by
kernel family (``FAMILIES``).  The ``spans`` entry is the device's time
by family under each innermost ``dwavehmc.*`` range the program opened
(``utils/profiling.span``): each kernel, copy or set goes to the range
open on the host thread at its launch, found by the correlation id that
the launch and the device event share.  ``--categories`` adds the
device's self time by family: events nest (a kernel inside an annotation
range, or a parent op around its children), so plain duration sums
double-count; the sweep of ``self_times`` subtracts each event from its
innermost enclosing parent on the same track.
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import sys

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


def family(name: str) -> str:
    low = name.lower()
    return next((f for frag, f in FAMILIES if frag in low), "other")


def load_events(path: str) -> list:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        data = json.load(f)
    return data.get("traceEvents", [])


def _track_names(events) -> tuple[dict, dict]:
    pnames, tnames = {}, {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pnames[e["pid"]] = e["args"].get("name", "")
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            tnames[(e["pid"], e.get("tid"))] = e["args"].get("name", "")
    return pnames, tnames


def _track_key(e, pnames, tnames) -> str:
    pid, tid = e.get("pid"), e.get("tid")
    return f"{pnames.get(pid, pid)}/{tnames.get((pid, tid), tid)}"


def _union_us(spans) -> float:
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


def device_summary(events, pnames, tnames, top_n: int) -> dict:
    """The device's work in ``events``: its tracks, busy time (the union
    of its intervals) over the window of every complete event, time by
    kernel family and its top kernels."""
    spans, tracks = [], set()
    by_name = collections.Counter()
    t0, t1 = None, None
    for e in events:
        if e.get("ph") != "X":
            continue
        ts, dur = e.get("ts", 0.0), e.get("dur", 0.0)
        t0 = ts if t0 is None else min(t0, ts)
        t1 = ts + dur if t1 is None else max(t1, ts + dur)
        if e.get("cat") in DEVICE_CATS:
            spans.append((ts, ts + dur))
            tracks.add(_track_key(e, pnames, tnames))
            by_name[e.get("name", "?")] += dur
    families = collections.Counter()
    for name, us in by_name.items():
        families[family(name)] += us
    busy = _union_us(spans)
    window = (t1 - t0) if spans else 0.0
    return {"tracks": sorted(tracks), "events": len(spans),
            "busy_ms": busy / 1e3, "window_ms": window / 1e3,
            "busy_pct": 100.0 * busy / window if window else 0.0,
            "family_ms": {k: v / 1e3 for k, v in families.most_common()},
            "top_kernels_ms": {k: v / 1e3
                               for k, v in by_name.most_common(top_n)}}


#: host event categories of a device launch (``cudaLaunchKernel``,
#: ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...)
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

#: the prefix of the program's ranges, and the entry of device work
#: launched outside all of them
SPAN_PREFIX = "dwavehmc."
NO_SPAN = "(no span)"


def _innermost(ranges, launches) -> dict:
    """Correlation id → name of the innermost range covering its launch,
    for the (ts, end, name) ``ranges`` and (ts, correlation) ``launches`` of
    one thread; ranges of one thread nest, so a stack finds it."""
    out, stack, i = {}, [], 0
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    for ts, corr in sorted(launches):
        while i < len(ranges) and ranges[i][0] <= ts:
            while stack and stack[-1][1] < ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < ts:
            stack.pop()
        if stack:
            out[corr] = stack[-1][2]
    return out


def span_device_time(events) -> dict:
    """Device milliseconds, kernel count and milliseconds by family of the
    work launched under each innermost ``dwavehmc.*`` range (the host
    ``user_annotation`` events ``utils/profiling.span`` opens), matched to
    its launch by correlation id; work launched outside every range under
    ``NO_SPAN``.  Empty when the trace has no such range."""
    ranges = collections.defaultdict(list)
    launches = collections.defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, key = e.get("cat"), (e.get("pid"), e.get("tid"))
        if (cat == "user_annotation"
                and e.get("name", "").startswith(SPAN_PREFIX)):
            ts = float(e["ts"])
            ranges[key].append((ts, ts + float(e.get("dur", 0.0)),
                                e["name"]))
        elif cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[key].append((float(e["ts"]),
                                  e["args"]["correlation"]))
    if not ranges:
        return {}
    owner = {}
    for key, lst in launches.items():
        owner.update(_innermost(ranges.get(key, []), lst))
    out = collections.defaultdict(lambda: {"device_ms": 0.0, "kernels": 0,
                                           "family_ms": collections.Counter()})
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        name = owner.get(e.get("args", {}).get("correlation"), NO_SPAN)
        ms = float(e.get("dur", 0.0)) / 1e3
        rec = out[name]
        rec["device_ms"] += ms
        rec["kernels"] += e.get("cat") == "kernel"
        rec["family_ms"][family(e.get("name", "?"))] += ms
    return {name: dict(rec, family_ms=dict(rec["family_ms"].most_common()))
            for name, rec in sorted(out.items(),
                                    key=lambda kv: -kv[1]["device_ms"])}


def analyze(path: str, top_n: int) -> dict:
    """Per-track busy time, span, duty and top ops (the JAX script's
    ``tracks``, its eight busiest), the device's work (``device``) and its
    time under the program's ranges (``spans``)."""
    events = load_events(path)
    pnames, tnames = _track_names(events)
    tracks = collections.defaultdict(lambda: {"busy": 0.0, "t0": None,
                                              "t1": None,
                                              "ops": collections.Counter()})
    for e in events:
        if e.get("ph") != "X":
            continue
        tr = tracks[_track_key(e, pnames, tnames)]
        ts, dur = e.get("ts", 0.0), e.get("dur", 0.0)
        tr["busy"] += dur
        tr["t0"] = ts if tr["t0"] is None else min(tr["t0"], ts)
        tr["t1"] = (ts + dur if tr["t1"] is None
                    else max(tr["t1"], ts + dur))
        tr["ops"][e.get("name", "?")] += dur

    out = {"file": os.path.relpath(path), "tracks": {}}
    for key, tr in sorted(tracks.items(),
                          key=lambda kv: -kv[1]["busy"])[:8]:
        span = (tr["t1"] - tr["t0"]) if tr["t1"] else 0.0
        out["tracks"][key] = {
            "busy_ms": round(tr["busy"] / 1e3, 1),
            "span_ms": round(span / 1e3, 1),
            "duty_pct": round(100.0 * tr["busy"] / span, 1) if span else 0,
            "top_ops_ms": {k: round(v / 1e3, 1)
                           for k, v in tr["ops"].most_common(top_n)},
        }
    out["device"] = device_summary(events, pnames, tnames, top_n)
    out["spans"] = span_device_time(events)
    return out


def self_times(spans) -> list:
    """Self time of each (ts, dur) event of one track: its duration less
    that of the events it encloses directly.  Sorted longer first at equal
    start, so a child sharing its parent's start nests under the parent."""
    order = sorted(range(len(spans)),
                   key=lambda i: (spans[i][0], -spans[i][1]))
    self_t = [0.0] * len(spans)
    stack = []
    for i in order:
        ts, dur = spans[i]
        while stack and ts >= spans[stack[-1]][0] + spans[stack[-1]][1]:
            stack.pop()
        if stack:
            self_t[stack[-1]] -= dur
        self_t[i] += dur
        stack.append(i)
    return self_t


def category_self_time(path: str) -> dict:
    """Self time (nested-event-corrected) of the device's work by kernel
    family — the measured matmul-vs-everything-else split."""
    events = load_events(path)
    pnames, tnames = _track_names(events)
    by_track = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            by_track[_track_key(e, pnames, tnames)].append(
                (e["ts"], e.get("dur", 0.0), family(e.get("name", "?"))))
    agg = collections.Counter()
    for lst in by_track.values():
        for (_ts, _dur, cat), t in zip(lst, self_times(
                [(ts, dur) for ts, dur, _ in lst])):
            if t > 0:
                agg[cat] += t
    total = sum(agg.values())
    return {
        "total_s": round(total / 1e6, 2),
        "by_category_pct": {c: round(100.0 * t / total, 1)
                            for c, t in agg.most_common(12)},
    }


def trace_files(trace_dir: str) -> list:
    return sorted(glob.glob(os.path.join(trace_dir, "**", "*.trace.json*"),
                            recursive=True))


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("trace_dir")
    p.add_argument("--top", type=int, default=12)
    p.add_argument("--categories", action="store_true",
                   help="also print the device self-time split by kernel "
                        "family")
    return p


def main(argv=None) -> list:
    ns = parser().parse_args(argv)
    paths = trace_files(ns.trace_dir)
    if not paths:
        print(f"no trace.json files under {ns.trace_dir}", file=sys.stderr)
        sys.exit(1)
    outs = []
    for path in paths:
        out = analyze(path, ns.top)
        if ns.categories:
            out["device_self_time"] = category_self_time(path)
        print(json.dumps(out, indent=1))
        outs.append(out)
    return outs


if __name__ == "__main__":
    main(sys.argv[1:])
