"""Profiling and timing hooks (port of ``dwavehmc_tpu/utils/profiling.py``):
per-phase wall-clock spans, and an optional ``torch.profiler`` trace
(TensorBoard format) around any phase."""

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
