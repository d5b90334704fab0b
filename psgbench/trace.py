"""The traced window: ``torch.profiler`` over a phase, reduced to the card's
busy time, the device operations that took most time, the idle gaps by
what the host was doing (the innermost benchmark range open at the gap's
midpoint), and the device time of named kernels."""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List

import torch

from psgbench.stats import busy_within, gaps_within

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "psgbench.window"
TOP = 10
NAME_CHARS = 120   # a kernel's demangled name is cut to this many characters


class Trace:
    """What one profiled phase left: device ops and host ranges in µs."""

    def __init__(self, events: List[Dict], host_names):
        span = lambda e: (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
        xs = [e for e in events if e.get("ph") == "X"]
        wins = [span(e) for e in xs if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
        if not wins:
            raise RuntimeError("the trace holds no window range")
        self.lo, self.hi = wins[0]
        self.ops = [(e["name"],) + span(e) for e in xs if e.get("cat") in DEVICE_CATS]
        self.host = [(e["name"],) + span(e) for e in xs
                     if e.get("cat") == "user_annotation" and e.get("name") in host_names]

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-6

    @property
    def busy_s(self) -> float:
        return busy_within([(a, b) for _, a, b in self.ops], self.lo, self.hi) * 1e-6

    def device_time_s(self, match: Callable[[str], bool]) -> float:
        return sum(b - a for n, a, b in self.ops if match(n)) * 1e-6

    def top_ops(self):
        tot = defaultdict(float)
        for n, a, b in self.ops:
            tot[n[:NAME_CHARS]] += (b - a) * 1e-6
        return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self):
        tot = defaultdict(float)
        for a, b in gaps_within([(a, b) for _, a, b in self.ops], self.lo, self.hi):
            mid = 0.5 * (a + b)
            open_ = [(hb - ha, n) for n, ha, hb in self.host if ha <= mid < hb]
            tot[min(open_)[1] if open_ else "outside"] += (b - a) * 1e-6
        return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]]


@contextlib.contextmanager
def profiled(host_names, sink: Dict):
    """Profile the block (CPU and CUDA activity) inside one window range;
    on exit ``sink["trace"]`` holds its :class:`Trace`.  The Chrome trace
    goes through a file under ``TMPDIR`` that is removed at once."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW):
            yield
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, "r", encoding="utf-8") as f:
            sink["trace"] = Trace(json.load(f)["traceEvents"], set(host_names))
    finally:
        os.remove(path)
