"""Tracing support (counterpart of ``openpsg_tpu/utils/profiling.py``):
``--profile DIR`` wraps the hot region in a ``torch.profiler`` trace (CPU
and, on the card, CUDA activities) written as a Chrome trace; a wall-clock
section timer whose sections appear in that trace by name; and the share
of a section's time in which the card ran a kernel."""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import torch


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """Trace the block into ``log_dir/trace.json`` (Chrome trace format);
    a no-op when ``log_dir`` is falsy.  Yields the profiler (or None)."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class SectionTimer:
    """Wall-clock section timer: every call's seconds per section name, and
    a one-line report.  Sections appear in a :func:`profile_trace` trace
    under their names."""

    def __init__(self):
        self.calls: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            self.calls.setdefault(name, []).append(time.perf_counter() - t0)

    def total(self, name: str) -> float:
        return sum(self.calls.get(name, ()))

    def report(self) -> str:
        parts = []
        for name in sorted(self.calls, key=self.total, reverse=True):
            t, n = self.total(name), len(self.calls[name])
            parts.append(f"{name}: {t:.2f}s/{n} ({t / n * 1e3:.1f}ms avg)")
        return " | ".join(parts)


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def device_busy(trace_path: str, window: str) -> Tuple[float, float]:
    """→ (seconds in which at least one CUDA kernel ran inside the sections
    named ``window``, those sections' total seconds), from a Chrome trace of
    :func:`profile_trace`: the kernels' intervals merged and clipped to the
    sections' CPU-side ``record_function`` spans."""
    with open(trace_path, "r", encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    span = lambda e: (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
    wins = _merged(span(e) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e.get("name") == window)
    kernels = _merged(span(e) for e in events
                      if e.get("ph") == "X" and e.get("cat") == "kernel")
    total = sum(b - a for a, b in wins)
    busy = sum(max(0.0, min(b, wb) - max(a, wa)) for a, b in kernels for wa, wb in wins)
    return busy * 1e-6, total * 1e-6      # trace times are in µs
