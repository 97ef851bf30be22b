"""Profiling and timing hooks (port of ``dwavehmc_tpu/utils/profiling.py``):
per-phase wall-clock spans, an optional ``torch.profiler`` trace
(TensorBoard format, a chrome trace that ``drivers/analyze_trace.py``
reads) around any phase, and the time of each call of a function on its
device."""

from __future__ import annotations

import contextlib
import time

import torch


class PhaseTimer:
    """Accumulates named wall-clock spans; renders a summary line."""

    def __init__(self):
        self.spans: dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
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
