"""Profiling and timing hooks (port of ``dwavehmc_tpu/utils/profiling.py``):
per-phase wall-clock spans, an optional ``torch.profiler`` trace
(TensorBoard format, a chrome trace that ``drivers/analyze_trace.py``
reads) around any phase, and the time of each call of a function on its
device.

``span(name)`` marks a range of the program's own work on the profiler's
timeline: while a ``torch.profiler`` session is on it opens a
``record_function`` range (a ``user_annotation`` event beside the kernels
it launched) and adds one call and its host seconds to ``SPANS``; while
none is on it does nothing past one check.  ``sync_span(site)`` is the span
``dwavehmc.sync.<site>`` around one call that makes the host wait for the
device (a read of a device value, a copy from pageable host memory), so its
calls count the host syncs.  ``SPANS`` holds exactly the work done under a
profiler since the last ``reset_spans()``.
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch

#: name → [calls, host seconds] of every ``span`` closed while a
#: ``torch.profiler`` session was on, since the last ``reset_spans()``
SPANS: dict[str, list] = {}

#: the prefix of every span the program opens
PREFIX = "dwavehmc."
#: the prefix of the spans around a host sync
SYNC_PREFIX = PREFIX + "sync."

_OFF = contextlib.nullcontext()


def reset_spans() -> None:
    SPANS.clear()


class _Span:
    """A ``record_function`` range whose host time goes to ``SPANS``."""

    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter()

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._range.__exit__(*exc)
        rec = SPANS.setdefault(self.name, [0, 0.0])
        rec[0] += 1
        rec[1] += dt
        return False


def span(name: str):
    """Context manager: the range ``name`` while a profiler is on, else a
    no-op that reads no clock and writes nothing."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name)


def sync_span(site: str):
    """``span("dwavehmc.sync.<site>")``: wrap exactly one call that makes
    the host wait for the device's stream: a read of a device value
    (``.tolist()``, ``bool``, ``nonzero``, a library call that reads its
    own status) or a copy from pageable host memory."""
    return span(SYNC_PREFIX + site)


def spanned(name: str):
    """Decorator: every call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


class PhaseTimer:
    """Accumulates named wall-clock spans; renders a summary line.  Each
    span is also ``span("dwavehmc.<name>")``, so it shows in a trace."""

    def __init__(self):
        self.spans: dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(PREFIX + name):
                yield
        finally:
            self.spans[name] = self.spans.get(name, 0.0) + (
                time.perf_counter() - t0)

    def summary(self) -> str:
        return " ".join(f"{k}={v:.2f}s" for k, v in self.spans.items())


@contextlib.contextmanager
def device_trace(trace_dir: str | None):
    """``torch.profiler`` trace of the CPU and, where there is one, the CUDA
    device into ``trace_dir``; a no-op without a directory."""
    if not trace_dir:
        yield
        return
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(trace_dir)):
        yield


def call_ms(fn, reps: int, device: torch.device) -> tuple[list, object]:
    """(the milliseconds of each of ``reps`` calls of ``fn()`` after one
    warm-up call, the last call's output): CUDA events around each call on
    the card, the host clock elsewhere.  The caller takes the least or the
    mean."""
    out = fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        else:
            t0 = time.perf_counter()
            out = fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return times, out
