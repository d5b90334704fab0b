"""The plain references against the port at tiny sizes on the CPU, the
float8 control failing the limits, and whole runs with the timed path
broken underneath coming out not correct."""

import time

import pytest
import torch

from psgbench import run as bench
from psgbench import weights as wgen
from psgbench.drivers import offline
from tiny import load, traffic, v1_config, v4_config

SEED = 2 ** 31 + 4242


def _system(kind):
    if kind == "v4":
        from psgbench.systems.psg_v4 import System
        return System, v4_config(), traffic("vga_landscape_mb4"), load("limits", "openpsg_v4_mistral7b.json")
    from psgbench.systems.psg_v1 import System
    return System, v1_config(), traffic("vga_landscape_single"), load("limits", "openpsg_v1_r50.json")


def tiny_run(kind, seed=SEED, modes=("f32",)):
    """One run of the cell's loop at tiny size on the CPU (no look for a
    card) → (readings by mode, the run's context)."""
    System, cfg, tr, _ = _system(kind)
    torch.set_num_threads(1)
    s = System(cfg, tr, seed, "cpu")
    ctx = offline.run(s, tr, seed, 0.2, False, time.perf_counter())
    taps = ctx.pop("taps")
    s.release()
    readings = s.check(taps, modes)
    ctx["objects"] = s.detail["objects"]
    ctx["llm_stopped_rows"] = s.detail.get("llm_stopped_rows", 0)
    return readings, ctx


def judged(kind, readings):
    return bench.judge(readings, _system(kind)[3])[0]


@pytest.mark.parametrize("kind", ["v4", "v1"])
def test_reference_matches_the_port(kind):
    r, ctx = tiny_run(kind)
    f = r["f32"]
    assert ctx["failed"] == 0 and ctx["attempted"] > 0
    assert max(ctx["objects"]) >= 2   # the shaped weights keep objects through fusion
    assert f["fusion_diff"] == 0
    for name, v in f.items():
        assert v < 1e-4, (name, v)
    assert judged(kind, f)


@pytest.mark.parametrize("kind", ["v4", "v1"])
def test_float8_control_fails(kind):
    r, _ = tiny_run(kind, modes=("f32", "fp8"))
    limits = _system(kind)[3]["numbers"]
    ctl = {n: v for n, v in r["fp8"].items() if n in limits}
    assert [n for n, v in ctl.items() if v > limits[n]["limit"]], ctl
    for n, v in ctl.items():   # every number with a tolerance tells the two apart
        if limits[n]["limit"] > 0:
            assert v > 100 * max(r["f32"][n], 1e-6), (n, v, r["f32"][n])


def test_a_row_that_stops_is_compared_up_to_its_eos(monkeypatch):
    """EOS made likely in the seeded LM head, so that sampled rows stop
    within the trips: the program goes on computing a stopped row from the
    EOS it fed back, and those unserved logits are not compared."""
    from psgbench.systems import psg_v4

    real = psg_v4.System.weights

    def weights(self, shift):
        W = real(self, shift)
        lm = W["llm.core.lm_head.weight"]
        g = torch.Generator().manual_seed(5)
        lm[self.eos_id] += 10 * torch.randn(lm.shape[1], generator=g) / lm.shape[1] ** 0.5
        return W

    monkeypatch.setattr(psg_v4.System, "weights", weights)
    r, ctx = tiny_run("v4")
    assert ctx["llm_stopped_rows"] > 0
    assert r["f32"]["llm_logits_rel"] < 1e-4 and r["f32"]["llm_gap"] < 1e-4, r["f32"]
    assert judged("v4", r["f32"])


def _fault_token(monkeypatch):
    from openpsg_tpu_torch.models.detectors import psg_v4

    real = psg_v4.greedy_decode

    def altered(*a, **k):
        toks, scores, trips = real(*a, **k)
        toks = toks.clone()
        toks[0, 0] = (toks[0, 0] + 1) % 97 + 4   # a different real token
        return toks, scores, trips

    monkeypatch.setattr(psg_v4, "greedy_decode", altered)


def _fault_pan(monkeypatch, cls):
    real = cls.fuse_select

    def altered(self, *a, **k):
        out = list(real(self, *a, **k))
        pan = out[5].clone()   # the pan map: 6th of v4's 7 outputs and of v1's 6
        pan[0, 0] = pan[0, 0] + 1
        out[5] = pan
        return tuple(out)

    monkeypatch.setattr(cls, "fuse_select", altered)


def _fault_segmenter(monkeypatch, cls):
    real = cls.segment

    def altered(self, *a, **k):
        out = dict(real(self, *a, **k))
        logits = out["cls_logits"].clone()
        logits[0] = -logits[0]   # one query's class logits
        out["cls_logits"] = logits
        return out

    monkeypatch.setattr(cls, "segment", altered)


def _fault_triplet(monkeypatch, cls):
    real = cls.relation_tail

    def altered(self, *a, **k):
        out = dict(real(self, *a, **k))
        t = out["triplets"].clone()
        t[0, 2] = (t[0, 2] + 1) % 56
        out["triplets"] = t
        return out

    monkeypatch.setattr(cls, "relation_tail", altered)


def _fault_pairs(monkeypatch):
    from openpsg_tpu_torch.models.relation import head_v4

    real = head_v4.pair_or_masks

    def altered(obj):
        return real(obj).roll(1, dims=1)   # pair (s, o) gets the patches of (s, o - 1)

    monkeypatch.setattr(head_v4, "pair_or_masks", altered)


def _fault_object_rows(monkeypatch, cls):
    real = cls.object_tokens

    def altered(self, *a, **k):
        return real(self, *a, **k).roll(1, dims=0)   # each object gets its neighbour's token

    monkeypatch.setattr(cls, "object_tokens", altered)


@pytest.mark.parametrize("kind,fault", [("v4", "token"), ("v4", "pan"), ("v4", "segmenter"),
                                        ("v4", "pairs"), ("v1", "pan"), ("v1", "segmenter"),
                                        ("v1", "triplet"), ("v1", "object_rows")])
def test_broken_timed_path_is_not_correct(monkeypatch, kind, fault):
    from openpsg_tpu_torch.models.detectors.mask2former_relation import PSGMask2FormerRelation
    from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4

    cls = PSGv4 if kind == "v4" else PSGMask2FormerRelation
    if fault == "token":
        _fault_token(monkeypatch)
    elif fault == "pan":
        _fault_pan(monkeypatch, cls)
    elif fault == "segmenter":
        _fault_segmenter(monkeypatch, cls)
    elif fault == "pairs":
        _fault_pairs(monkeypatch)
    elif fault == "object_rows":
        _fault_object_rows(monkeypatch, cls)
    else:
        _fault_triplet(monkeypatch, cls)
    r, _ = tiny_run(kind)
    assert not judged(kind, r["f32"]), r["f32"]


def test_weights_are_reproducible_and_scaled():
    spec = [("a.w", (64, 32), torch.float32), ("a.norm.weight", (32,), torch.float32),
            ("a.bias", (32,), torch.bfloat16), ("a.s", (), torch.float32)]
    w1, w2 = wgen.make(spec, SEED, "cpu"), wgen.make(spec, SEED, "cpu")
    w3 = wgen.make(spec, SEED + 1, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert not torch.equal(w1["a.w"], w3["a.w"])
    assert w1["a.bias"].dtype == torch.bfloat16 and w1["a.s"].shape == ()
    assert abs(float(w1["a.w"].std()) - 32 ** -0.5) < 0.03
    assert abs(float(w1["a.norm.weight"].mean()) - 1.0) < 0.1
    assert float(w1["a.bias"].float().abs().max()) < 1.0
