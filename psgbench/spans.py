"""The program's own spans: the ``psg.*`` profiler ranges that
``openpsg_tpu_torch.utils.profiling.span`` opens on the inference path
(``psg.infer``, its stages ``psg.segmenter``, ``psg.fusion_select``,
``psg.head``, ``psg.decode``, and inside them ``psg.ms_deform_attn``,
``psg.prefill``, ``psg.trip``), read with the CUDA API calls made inside
them and the device work those calls launched.

A call belongs to a span when it comes from the span's thread while a range
of that name is open there (enclosing ranges count, not only the
innermost); a kernel, copy or set belongs to it when the call that launched
it does, matched by correlation id.

``psgbench/trace.py`` keeps none of this from the run's profiled phase, so
the readers take it from a span pass of their own (:func:`span_pass`):
after the run's windows, one chunk of each bucket once more through the
program's call, under ``torch.profiler``."""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

from psgbench.trace import DEVICE_CATS, WINDOW

PREFIX = "psg."
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
# a host call that puts work on the card's queue: a kernel (a CUDA graph's
# launch counts once), an asynchronous copy or set
LAUNCH_MARKS = ("LaunchKernel", "GraphLaunch", "LaunchCooperativeKernel")
QUEUED = ("cudaMemcpyAsync", "cudaMemsetAsync")
# a host call that waits for the card (``cudaMemcpy`` is the blocking copy)
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")


def is_launch(name: str) -> bool:
    return name in QUEUED or any(m in name for m in LAUNCH_MARKS)


def is_sync(name: str) -> bool:
    return name in SYNCS


class SpanTrace:
    """The ``psg.*`` ranges by thread, the CUDA API calls, and the
    device time of each correlation id, from a Chrome trace's events (µs)."""

    def __init__(self, events: List[Dict]):
        xs = [e for e in events if e.get("ph") == "X"]
        thread = lambda e: (e.get("pid"), e.get("tid"))
        corr = lambda e: (e.get("args") or {}).get("correlation")
        self.ranges: Dict[str, Dict] = defaultdict(lambda: defaultdict(list))
        for e in xs:
            if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith(PREFIX):
                t0 = float(e["ts"])
                self.ranges[e["name"]][thread(e)].append((t0, t0 + float(e.get("dur", 0.0))))
        self.calls = [(e["name"], thread(e), float(e["ts"]), corr(e))
                      for e in xs if e.get("cat") in RUNTIME_CATS]
        self.device_us: Dict[int, float] = defaultdict(float)
        for e in xs:
            if e.get("cat") in DEVICE_CATS and corr(e) is not None:
                self.device_us[corr(e)] += float(e.get("dur", 0.0))

    def span_count(self, name: str) -> int:
        """Ranges named ``name`` (nested ones each count)."""
        return sum(len(r) for r in self.ranges.get(name, {}).values())

    def calls_in(self, name: str) -> List:
        """The CUDA API calls made inside a range named ``name``,
        each once."""
        merged = {}
        for th, rs in self.ranges.get(name, {}).items():
            out = []
            for a, b in sorted(rs):
                if out and a <= out[-1][1]:
                    out[-1][1] = max(out[-1][1], b)
                else:
                    out.append([a, b])
            merged[th] = ([a for a, _ in out], [b for _, b in out])
        hits = []
        for c in self.calls:
            m = merged.get(c[1])
            if m is None:
                continue
            i = bisect.bisect_right(m[0], c[2]) - 1
            if i >= 0 and c[2] < m[1][i]:
                hits.append(c)
        return hits

    def span_launches(self, name: str) -> int:
        return sum(is_launch(c[0]) for c in self.calls_in(name))

    def span_syncs(self, name: str) -> int:
        return sum(is_sync(c[0]) for c in self.calls_in(name))

    def span_device_s(self, name: str) -> float:
        """Seconds of the kernels, copies and sets launched inside the
        ranges named ``name`` (durations summed, overlaps not merged)."""
        ids = {c[3] for c in self.calls_in(name) if c[3] is not None}
        return sum(self.device_us.get(i, 0.0) for i in ids) * 1e-6


def program_spans() -> bool:
    """Whether the program under test opens ``psg.*`` spans."""
    try:
        from openpsg_tpu_torch.utils import profiling
    except ImportError:
        return False
    return callable(getattr(profiling, "span", None))


@contextlib.contextmanager
def profiled_events(sink: Dict):
    """Profile the block (CPU activity, and the card's where there is one)
    inside one window range; on exit ``sink["trace"]`` holds its
    :class:`SpanTrace`.  The Chrome trace goes through a file under
    ``TMPDIR`` that is removed at once."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, "r", encoding="utf-8") as f:
            sink["trace"] = SpanTrace(json.load(f)["traceEvents"])
    finally:
        os.remove(path)


def span_pass(ctx: Dict) -> Optional[Dict]:
    """The run's span pass, made on the first call and kept in ``ctx``: the
    first chunk of each bucket of the cell's traffic (the run's seed; what
    the warm-up runs), each through the system's call inside a
    ``run_chunk`` range, under the profiler → ``{"images", "seconds",
    "trace"}``; None where the program opens no spans (then nothing runs).
    Counts per image are exact on a chunk, since a bucket fixes every
    shape; the profiler slows the host several times over, so the pass
    stays short."""
    if "span_pass" in ctx:
        return ctx["span_pass"]
    ctx["span_pass"] = None
    if not program_spans():
        return None
    from psgbench.drivers.offline import OfflineLoop

    system = ctx["system"]
    loop = OfflineLoop(system, system.traffic, system.seed)
    out = {"images": 0}
    seen = set()
    t0 = time.perf_counter()
    with profiled_events(out):
        for bucket, ims, hws, _ in loop.prepared:
            if bucket in seen:
                continue
            seen.add(bucket)
            with torch.profiler.record_function("run_chunk"):
                system.run_chunk(ims, hws)
            out["images"] += len(ims)
        out["seconds"] = time.perf_counter() - t0
    print(f"psgbench: span pass of {out['images']} images in {out['seconds']:.1f} s, "
          f"its trace read in {time.perf_counter() - t0 - out['seconds']:.1f} s", file=sys.stderr)
    ctx["span_pass"] = out
    return out


def per_image(ctx: Dict, name: str, value) -> Optional[float]:
    """``value(trace)`` over the span pass's images; None where the program
    opened no range named ``name``."""
    sp = span_pass(ctx)
    if sp is None or not sp["images"] or not sp["trace"].span_count(name):
        return None
    return value(sp["trace"]) / sp["images"]
