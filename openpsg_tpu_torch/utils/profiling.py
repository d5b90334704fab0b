"""Tracing support (counterpart of ``openpsg_tpu/utils/profiling.py``):
the program's one span primitive (:func:`span`), a profiler range on the
trace's clock that can also time its block; ``--profile DIR`` wraps the hot
region in a ``torch.profiler`` trace (CPU and, on the card, CUDA
activities) written as a Chrome trace; a wall-clock section timer whose
sections appear in that trace by name; the share of a section's time in
which the card ran a kernel, copy or set; and the measurement tools'
sampling (:func:`time_samples`, :func:`sample_stats`), the record of the
card they ran on (:func:`device_record`) and its published peaks."""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

# one NVIDIA H100 SXM's published peaks (data sheet; at its 700 W limit):
# HBM bytes per second, float32 FLOP per second outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# what the card runs, in a Chrome trace of ``torch.profiler``
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the segmented CUDA graph being captured on this thread, if any
# (``utils/graphs.py``): a span that opens or closes ends its graph there
graph_capture = threading.local()


@contextlib.contextmanager
def span(name: str, times: Optional[Dict[str, float]] = None, device=None,
         prefix: str = "psg."):
    """The program's span: the block inside a ``torch.profiler`` range
    ``prefix + name``, which a running profiler puts on the same trace and
    clock as the card's kernels and copies (the host calls made inside it
    link to the device work by correlation id).  With no profiler running
    the range costs only its own host time and no device work.  Inside a
    segmented CUDA graph's capture (``utils/graphs.py``) the block becomes
    graphs of its own, which each replay launches inside the range.

    When ``times`` is a dict, the block's wall ms are also added to
    ``times[name]``, the card (``device``, where it is a CUDA device)
    synchronized before and after, outside the range; without a dict
    nothing synchronizes."""
    sync = times is not None and device is not None and torch.device(device).type == "cuda"
    if sync:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    rec = getattr(graph_capture, "recorder", None)
    if rec is not None:
        rec.boundary(("open", name, prefix))
    with torch.profiler.record_function(prefix + name):
        yield
        if rec is not None:
            rec.boundary(("close",))
    if times is not None:
        if sync:
            torch.cuda.synchronize(device)
        times[name] = times.get(name, 0.0) + (time.perf_counter() - t0) * 1e3


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
    a one-line report.  Each section is a :func:`span` under its bare name
    (no ``psg.`` prefix), so it appears in a :func:`profile_trace` trace
    under that name; it never synchronizes."""

    def __init__(self):
        self.calls: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(name, prefix=""):
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
    """→ (seconds in which the card ran at least one kernel, copy or set
    inside the sections named ``window``, those sections' total seconds),
    from a Chrome trace of :func:`profile_trace`: the device intervals merged
    and clipped to the sections' CPU-side ``record_function`` spans."""
    with open(trace_path, "r", encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    interval = lambda e: (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
    wins = _merged(interval(e) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e.get("name") == window)
    kernels = _merged(interval(e) for e in events
                      if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    total = sum(b - a for a, b in wins)
    busy = sum(max(0.0, min(b, wb) - max(a, wa)) for a, b in kernels for wa, wb in wins)
    return busy * 1e-6, total * 1e-6      # trace times are in µs


def sample_stats(samples_ms) -> Dict[str, float]:
    """Median, quartiles and interquartile range of a list of samples (ms),
    the quartiles linearly interpolated (``numpy.percentile``'s default)."""
    import numpy as np

    if len(samples_ms) == 0:
        raise ValueError("no samples")
    q1, med, q3 = (float(v) for v in np.percentile(np.asarray(samples_ms, np.float64),
                                                   [25, 50, 75]))
    return {"median_ms": med, "q1_ms": q1, "q3_ms": q3, "iqr_ms": q3 - q1,
            "samples_ms": [float(s) for s in samples_ms]}


def time_samples(fn, iters: int, device, launches: Optional[int] = None) -> Dict[str, float]:
    """One warm-up call of ``fn()``, then ``iters`` samples → :func:`sample_stats`.

    ``launches=None`` (a stage, host work included): each sample is a host
    clock around one call that ends in ``torch.cuda.synchronize()``.
    ``launches=n`` (pure device work: a kernel, a microbench): each sample
    is CUDA events around ``n`` back-to-back calls, divided by ``n``.  On
    the CPU both read the host clock (``n`` calls per sample for the
    latter)."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    fn()
    sync()
    samples = []
    for _ in range(max(int(iters), 1)):
        if launches is None:
            t0 = time.perf_counter()
            fn()
            sync()
            samples.append((time.perf_counter() - t0) * 1e3)
        elif cuda:
            with torch.cuda.device(dev):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(launches):
                    fn()
                b.record()
                b.synchronize()
            samples.append(a.elapsed_time(b) / launches)
        else:
            t0 = time.perf_counter()
            for _ in range(launches):
                fn()
            samples.append((time.perf_counter() - t0) * 1e3 / launches)
    return sample_stats(samples)


def device_record(device) -> str:
    """The device a measurement ran on: ``"cpu"``, or the card's name and
    power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them (the name alone, with the limit
    "not read", where ``nvidia-smi`` cannot be run)."""
    import subprocess

    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
        if out:
            return out.splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        pass
    return f"{torch.cuda.get_device_name(index)}, power limit not read"
