"""The program's spans (``utils/profiling.span``) on the offline inference
path: where each ``psg.*`` range opens in the tiny v4 and v1 programs, one
``psg.trip`` per decode step, and the primitive's two modes (a profiler
range only, which never synchronizes; and the stage timer, which fills the
``stage_times`` dict)."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from openpsg_tpu_torch.models.detectors.mask2former_relation import (
    M2FRelationConfig,
    PSGMask2FormerRelation,
)
from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4, PSGv4Config
from openpsg_tpu_torch.utils import profiling
from openpsg_tpu_torch.utils.profiling import span

# the suite's workers share the cores, and these tensors are tiny
torch.set_num_threads(1)

HWS = [(64, 64), (56, 60)]


def _images(n=2):
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8) for _ in range(n)]


@pytest.fixture(scope="module")
def v4():
    return PSGv4(PSGv4Config.tiny_test(), seed=0, device="cpu")


@pytest.fixture(scope="module")
def v1():
    return PSGMask2FormerRelation(M2FRelationConfig.tiny_test(), seed=0, device="cpu")


def _ranges(fn, tmp_path):
    """Run ``fn()`` under the CPU profiler → (its result, [(name, start, end,
    thread)] of the ``psg.*`` ranges)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["tid"])
              for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and e["name"].startswith("psg.")]
    return out, ranges


def _named(ranges, name):
    return [r for r in ranges if r[0] == name]


def _inside(r, outer_name, ranges):
    """Some range named ``outer_name`` on ``r``'s thread encloses ``r``."""
    return any(o[3] == r[3] and o[1] <= r[1] and r[2] <= o[2]
               for o in _named(ranges, outer_name))


def test_v4_microbatch_span_tree(v4, tmp_path):
    res, ranges = _ranges(lambda: v4.infer_microbatch(_images(), HWS), tmp_path)
    assert len(_named(ranges, "psg.infer")) == 1
    for stage in ("psg.segmenter", "psg.fusion_select", "psg.head"):
        assert len(_named(ranges, stage)) == 2
        assert all(_inside(r, "psg.infer", ranges) for r in _named(ranges, stage))
    msda = _named(ranges, "psg.ms_deform_attn")
    assert msda and all(_inside(r, "psg.segmenter", ranges) for r in msda)
    assert len(_named(ranges, "psg.decode")) == 1
    assert _inside(_named(ranges, "psg.decode")[0], "psg.infer", ranges)
    for part in ("psg.prefill", "psg.trip"):
        assert all(_inside(r, "psg.decode", ranges) for r in _named(ranges, part))
    assert len(_named(ranges, "psg.prefill")) == 1
    trips = _named(ranges, "psg.trip")
    assert trips and len(trips) == res[0]["decode_steps"] == res[1]["decode_steps"]
    # the prefill ends before the first trip opens; trips do not overlap
    trips.sort(key=lambda r: r[1])
    assert _named(ranges, "psg.prefill")[0][2] <= trips[0][1]
    assert all(a[2] <= b[1] for a, b in zip(trips, trips[1:]))


@pytest.mark.parametrize("budget", [0, 2])
def test_v4_one_trip_span_per_decode_step(v4, tmp_path, budget):
    res, ranges = _ranges(lambda: v4.infer_microbatch(_images(1), HWS[:1], trip_budget=budget),
                          tmp_path)
    assert len(_named(ranges, "psg.trip")) == res[0]["decode_steps"] == budget
    assert len(_named(ranges, "psg.prefill")) == 1


def test_v1_infer_span_tree(v1, tmp_path):
    _, ranges = _ranges(lambda: v1.infer(_images(1)[0], HWS[0]), tmp_path)
    assert len(_named(ranges, "psg.infer")) == 1
    for stage in ("psg.segmenter", "psg.fusion_select", "psg.head"):
        assert len(_named(ranges, stage)) == 1
        assert _inside(_named(ranges, stage)[0], "psg.infer", ranges)
    msda = _named(ranges, "psg.ms_deform_attn")
    assert msda and all(_inside(r, "psg.segmenter", ranges) for r in msda)
    assert not any(_named(ranges, n) for n in ("psg.decode", "psg.prefill", "psg.trip"))


def _no_sync(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span without a dict synchronized the card")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)


def test_span_without_dict_or_profiler_never_synchronizes(v4, v1, monkeypatch):
    _no_sync(monkeypatch)
    assert not torch.autograd.profiler._is_profiler_enabled
    with span("x", device=torch.device("cuda")):
        pass
    v4.infer_microbatch(_images(), HWS, trip_budget=1)
    v1.infer(_images(1)[0], HWS[0])


def test_span_with_dict_is_the_stage_timer(v4, v1, monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: synced.append(device))
    times = {}
    cuda = torch.device("cuda")
    for _ in range(2):
        with span("segmenter", times, cuda):
            pass
    assert list(times) == ["segmenter"] and times["segmenter"] >= 0.0
    assert synced == [cuda] * 4          # before and after each block
    with span("cpu_stage", times, torch.device("cpu")):
        pass
    assert "cpu_stage" in times and len(synced) == 4
    # the stage_times keys of both programs, summed over a microbatch's images
    st4, st1 = {}, {}
    v4.infer_microbatch(_images(), HWS, trip_budget=1, stage_times=st4)
    v1.infer(_images(1)[0], HWS[0], stage_times=st1)
    assert set(st4) == {"segmenter", "fusion_select", "head", "decode"}
    assert set(st1) == {"segmenter", "fusion_select", "head"}
    assert all(v > 0 for v in list(st4.values()) + list(st1.values()))


def test_span_block_raises_through():
    times = {}
    with pytest.raises(ValueError):
        with span("bad", times):
            raise ValueError("inside")
    assert times == {}


def test_span_and_section_names_on_the_trace(tmp_path):
    timer = profiling.SectionTimer()

    def run():
        with span("outer"):
            with timer.section("model"):
                torch.ones(4).sum()

    _, ranges = _ranges(run, tmp_path)
    assert [r[0] for r in ranges] == ["psg.outer"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    names = {e.name for e in prof.events()}
    assert {"psg.outer", "model"} <= names and "psg.model" not in names
    assert len(timer.calls["model"]) == 2
