"""The program-span readers (``psgbench/spans.py`` and the five metrics
that read it) on a hand-built event list, the run's own trace reduction
unchanged by the events they add, and the span pass on the tiny systems."""

import importlib.util
import os
import time

import pytest
import torch

from psgbench import spans
from psgbench.drivers import offline
from psgbench.trace import WINDOW, Trace
from tiny import ROOT, traffic, v1_config, v4_config

SEED = 2 ** 31 + 5151
A, B = (1, 11), (1, 22)        # (pid, tid) of the main thread and another


def X(cat, name, ts, dur=0.0, thread=A, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": thread[0], "tid": thread[1]}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def base_events():
    """``test_psgbench_arith.test_trace_reduction``'s list, its device
    operations given the correlation ids of their launches."""
    return [
        X("user_annotation", WINDOW, 0, 100),
        X("user_annotation", "segment", 0, 50),
        X("user_annotation", "run_chunk", 0, 100),
        X("kernel", "k1", 10, 20, corr=1),
        X("kernel", "k2", 20, 20, corr=2),
        X("gpu_memcpy", "copy", 70, 10, corr=7),
        X("cpu_op", "aten::add", 0, 90),
    ]


def host_events():
    """Program ranges and runtime calls on two threads, no device work."""
    ua = lambda name, ts, dur: X("user_annotation", name, ts, dur)
    rt = lambda name, ts, corr, thread=A: X("cuda_runtime", name, ts, 0.5, thread, corr)
    return [
        ua("psg.infer", 0, 98), ua("psg.segmenter", 0, 50),
        ua("psg.ms_deform_attn", 5, 10), ua("psg.ms_deform_attn", 20, 10),
        ua("psg.decode", 60, 35), ua("psg.prefill", 60, 10),
        ua("psg.trip", 72, 8), ua("psg.trip", 82, 8),
        rt("cudaLaunchKernel", 6, 1),            # k1: msda, segmenter, infer
        rt("cudaGetDevice", 7, 3),               # neither a launch nor a sync
        rt("cudaGraphLaunch", 22, 2),            # k2 and k3: one launch
        rt("cudaMemsetAsync", 40, 4),
        rt("cudaStreamSynchronize", 45, 5),
        rt("cudaLaunchCooperativeKernel", 47, 14),
        X("cuda_driver", "cuLaunchKernel", 62, 0.5, A, 6),   # p: prefill
        rt("cudaMemcpyAsync", 65, 7),            # copy: prefill
        rt("cudaLaunchKernel", 74, 8),           # t1: trip 1
        rt("cudaMemcpyAsync", 81, 12),           # the EOS check between trips
        rt("cudaStreamSynchronize", 81.5, 13),
        rt("cudaLaunchKernelExC", 84, 9),        # t2: trip 2
        rt("cudaMemcpy", 92, 10),                # blocking copy in decode
        rt("cudaEventSynchronize", 96, 11),      # in infer, after decode
        rt("cudaLaunchKernel", 99, 30),          # after infer closed
        rt("cudaLaunchKernel", 8, 20, B),        # another thread, no range there
        rt("cudaDeviceSynchronize", 10, 21, B),
    ]


def device_events():
    """Device work of the launches above that the base list lacks."""
    return [
        X("kernel", "k3", 41, 4, corr=2),        # the graph's second kernel
        X("kernel", "p", 62, 4, corr=6),
        X("kernel", "t1", 76, 2, corr=8),
        X("kernel", "t2", 86, 2, corr=9),
        X("kernel", "kb", 50, 5, corr=20),
        X("gpu_memset", "set", 46, 1, corr=4),
    ]


def events():
    return base_events() + host_events() + device_events()


def test_run_trace_unchanged_by_the_program_events():
    old = Trace(base_events(), {"segment", "run_chunk"})
    new = Trace(base_events() + host_events(), {"segment", "run_chunk"})
    assert new.window_s == old.window_s and new.busy_s == old.busy_s
    assert new.top_ops() == old.top_ops() and new.idle_gaps() == old.idle_gaps()
    assert new.busy_s == pytest.approx(40e-6)
    gaps = dict(new.idle_gaps())
    assert gaps["segment"] == pytest.approx(10e-6) and gaps["run_chunk"] == pytest.approx(50e-6)


def test_span_counts_launches_syncs_and_device_time():
    tr = spans.SpanTrace(events())
    assert tr.span_count("psg.ms_deform_attn") == 2 and tr.span_count("psg.trip") == 2
    assert tr.span_count("psg.segmenter") == 1 and tr.span_count("psg.missing") == 0
    # thread A inside 0-50: LaunchKernel, GraphLaunch, MemsetAsync, LaunchCooperativeKernel
    assert tr.span_launches("psg.segmenter") == 4
    assert tr.span_launches("psg.ms_deform_attn") == 2
    assert tr.span_launches("psg.prefill") == 2                # cuLaunchKernel and a copy
    assert tr.span_launches("psg.infer") == 4 + 2 + 1 + 1 + 1  # the trailing one is outside
    assert tr.span_syncs("psg.segmenter") == 1
    assert tr.span_syncs("psg.decode") == 2                    # the EOS check and cudaMemcpy
    assert tr.span_syncs("psg.trip") == 0
    assert tr.span_syncs("psg.infer") == 4                     # thread B's is not counted
    assert tr.span_device_s("psg.ms_deform_attn") == pytest.approx((20 + 20 + 4) * 1e-6)
    assert tr.span_device_s("psg.prefill") == pytest.approx((4 + 10) * 1e-6)
    assert tr.span_device_s("psg.trip") == pytest.approx((2 + 2) * 1e-6)
    assert tr.span_device_s("psg.segmenter") == pytest.approx((20 + 24 + 1) * 1e-6)
    assert tr.span_device_s("psg.missing") == 0.0


def test_enclosing_ranges_count_each_call_once():
    ev = events() + [X("user_annotation", "psg.infer", 10, 20)]   # nested in the first
    tr = spans.SpanTrace(ev)
    assert tr.span_count("psg.infer") == 2
    assert tr.span_syncs("psg.infer") == 4 and tr.span_launches("psg.infer") == 9


def _reader(name):
    path = os.path.join(ROOT, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("spans_reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_the_five_readers():
    ctx = {"span_pass": {"images": 2, "seconds": 1.0, "trace": spans.SpanTrace(events())}}
    assert _reader("segmenter_launches.offline")(ctx) == 2.0
    assert _reader("host_syncs.offline")(ctx) == 2.0
    assert _reader("ms_deform_attn_ms.offline")(ctx) == pytest.approx(44e-3 / 2)
    assert _reader("prefill_ms.offline")(ctx) == pytest.approx(14e-3 / 2)
    assert _reader("trip_ms.offline")(ctx) == pytest.approx(4e-3 / 2)
    # a program without the decode spans (v1): its readers read nothing
    v1 = [e for e in events() if e["name"] not in ("psg.decode", "psg.prefill", "psg.trip")]
    ctx = {"span_pass": {"images": 1, "seconds": 1.0, "trace": spans.SpanTrace(v1)}}
    assert _reader("prefill_ms.offline")(ctx) is None
    assert _reader("trip_ms.offline")(ctx) is None
    assert _reader("segmenter_launches.offline")(ctx) == 4.0


def test_a_program_without_spans_runs_no_pass(monkeypatch):
    monkeypatch.setattr(spans, "program_spans", lambda: False)
    ctx = {"system": None}
    for name in ("segmenter_launches.offline", "host_syncs.offline", "ms_deform_attn_ms.offline",
                 "prefill_ms.offline", "trip_ms.offline"):
        assert _reader(name)(ctx) is None
    assert ctx["span_pass"] is None


@pytest.mark.parametrize("kind", ["v4", "v1"])
def test_span_pass_on_the_tiny_systems(kind):
    torch.set_num_threads(1)
    if kind == "v4":
        from psgbench.systems.psg_v4 import System
        cfg, tr = v4_config(), traffic("vga_landscape_mb4")
    else:
        from psgbench.systems.psg_v1 import System
        cfg, tr = v1_config(), traffic("vga_landscape_single")
    s = System(cfg, tr, SEED, "cpu")
    ctx = offline.run(s, tr, SEED, 0.1, False, time.perf_counter())
    ctx["system"] = s
    sp = spans.span_pass(ctx)
    assert spans.span_pass(ctx) is sp                  # made once
    # the first chunk of each bucket
    first = {}
    for b, idx in offline.OfflineLoop(s, tr, SEED).chunks:
        first.setdefault(b, len(idx))
    n, t = sum(first.values()), sp["trace"]
    assert sp["images"] == n
    assert t.span_count("psg.segmenter") == n and t.span_count("psg.ms_deform_attn") > n
    chunks = len(first) if kind == "v4" else n
    assert t.span_count("psg.infer") == chunks
    if kind == "v4":
        trips = ctx["phases"]["timed"]["chunks"][0]["trips"]
        assert t.span_count("psg.prefill") == chunks
        assert t.span_count("psg.trip") == chunks * trips
        assert _reader("trip_ms.offline")(ctx) == 0.0   # no device on the CPU
    else:
        assert t.span_count("psg.trip") == 0 and _reader("trip_ms.offline")(ctx) is None
    assert _reader("segmenter_launches.offline")(ctx) == 0.0
    s.release()
