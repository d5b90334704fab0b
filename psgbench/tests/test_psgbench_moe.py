"""The DeepSeek-V3 configuration's pieces of the benchmark: the benchmark's
copy of the reference against the port's, the operation and byte counts by
hand, the manifest's new entries, and the adapter's whole comparison at a
tiny size on the CPU (the port against the reference, the float8 control
failing, a broken expert choice not correct)."""

import copy
import json
import os
import time

import torch

from psgbench import run as bench
from psgbench.drivers import offline
from psgbench.flops import moe_mla
from psgbench.reference import deepseek_v3 as ref_ds
from psgbench.reference.prec import Prec
from tiny import ROOT, load, traffic, v4_config

REPO = os.path.dirname(ROOT)
SEED = 2 ** 31 + 5151
NEW_CELLS = ("v4moon-offline-trip16", "v4m-offline-trip16")
NEW_METRICS = ("moe_ms.offline", "mla_ms.offline", "moe_roofline.offline")

torch.set_num_threads(1)


def moon_config():
    """``openpsg_v4_moonlight16b`` with the tiny LLM sizes of the port's
    tests and the tiny v4 pipeline (float32 throughout)."""
    c = copy.deepcopy(load("configs", "openpsg_v4_moonlight16b.json"))
    c.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32,
             qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, intermediate_size=128,
             moe_intermediate_size=32, n_routed_experts=8, num_experts_per_tok=2,
             n_shared_experts=1, num_hidden_layers=3, vocab_size=512, torch_dtype="float32")
    c["psg"] = v4_config()["psg"]
    return c


def test_reference_is_the_ports_reference():
    """psgbench's copy (through ``Prec("f32")``) and the port's
    ``deepseek_v3_reference`` agree on seeded weights, with the reference's
    own choice and with a given one."""
    from openpsg_tpu_torch.models.common import init_params
    from openpsg_tpu_torch.models.llm import deepseek_v3_reference as port_ref
    from openpsg_tpu_torch.models.llm.deepseek_v3 import (
        DeepseekV3Config,
        DeepseekV3WithEmbeddings,
    )
    from psgbench.systems.psg_v4_moe import llm_config

    cfg = llm_config(moon_config())
    m = DeepseekV3WithEmbeddings(DeepseekV3Config.from_hf(cfg, dtype=torch.float32))
    gen = torch.Generator().manual_seed(1)
    init_params(m, gen)
    W = {"llm." + k: v.detach() for k, v in m.state_dict().items()}
    with torch.no_grad():
        for k, v in W.items():
            if k.endswith("e_score_correction_bias"):
                v.normal_(0.0, 0.1, generator=gen)
    B, L = 2, 7
    x = torch.randn(B, L, cfg["hidden_size"], generator=gen)
    valid = torch.ones(B, L, dtype=torch.bool)
    valid[0, :2] = False
    pos = torch.clamp(torch.cumsum(valid.long(), 1) - 1, min=0)
    out_at = torch.arange(L)
    forced = {i: torch.stack([torch.randperm(8, generator=gen)[:2] for _ in range(B * L)])
              .view(B, L, 2) for i in range(1, 3)}
    with torch.no_grad():
        for routing in (None, forced):
            a, ca = ref_ds.forward(Prec("f32"), W, x, valid, pos, cfg, out_at, routing)
            b, cb = port_ref.forward(W, cfg, x, valid, pos, out_at, routing, prefix="llm.")
            assert torch.allclose(a, b, rtol=1e-5, atol=1e-5)
            assert sorted(ca) == sorted(cb) == [1, 2]
            assert all(torch.allclose(ca[i], cb[i], rtol=1e-6, atol=1e-6) for i in ca)


def test_counts_by_hand():
    c = dict(hidden_size=8, num_attention_heads=2, kv_lora_rank=4, qk_nope_head_dim=3,
             qk_rope_head_dim=2, v_head_dim=3, intermediate_size=5, first_k_dense_replace=1,
             num_hidden_layers=3, moe_intermediate_size=2, n_routed_experts=4,
             num_experts_per_tok=2, n_shared_experts=1, vocab_size=10)
    # one expert layer over 1 token: router 8·4, 2 experts and 1 shared of 3·8·2
    call = moe_mla.moe_call(c, 1)
    assert call["flops"] == 2 * (32 + 2 * 48 + 48)
    assert call["bytes"] == 2 * (32 + 2 * 48 + 48) + 2 * 8 * 2
    assert moe_mla.moe_call(c, 3)["bytes"] == 2 * (32 + 4 * 48 + 48) + 2 * 3 * 8 * 2
    # attention weights a layer: q 8·2·5, kv_a 8·6, kv_b 4·2·6, o 2·3·8
    attn = 80 + 48 + 48 + 48
    # prefill over 1 row of 2 tokens: 3 pairs (causal), each 2 heads·(5 + 3)
    p = moe_mla.prefill(c, 1, 2)
    want = 3 * (2 * 2 * attn + 2 * 3 * 2 * 8) + 2 * 2 * 3 * 8 * 5 \
        + 2 * moe_mla.moe_call(c, 2)["flops"] + 2 * 8 * 10
    assert p["flops"] == want
    assert p["bytes"] == (3 * attn + 120 + 80) * 2 + 2 * moe_mla.moe_call(c, 2)["bytes"] \
        + 2 * 8 * 2 + 3 * 2 * 6 * 2
    # a trip of 1 row over 4 keys, absorbed: q 80, kv_a 48, W_UK 2·3·4, W_UV 2·4·3, o 48;
    # per key 2 heads·(4 + 2 + 4)
    t = moe_mla.trip(c, 1, 4)
    per_attn = 2 * (80 + 48 + 24 + 24 + 48) + 2 * 4 * 2 * 10
    assert t["flops"] == 3 * per_attn + 2 * 3 * 8 * 5 + 2 * moe_mla.moe_call(c, 1)["flops"] \
        + 2 * 8 * 10
    assert t["bytes"] == (3 * attn + 120 + 80) * 2 + 2 * moe_mla.moe_call(c, 1)["bytes"] \
        + 8 * 2 + 3 * 4 * 6 * 2


def test_new_manifest_entries_resolve_to_files():
    with open(os.path.join(REPO, "BENCHMARK.json"), "r", encoding="utf-8") as f:
        m = json.load(f)
    cells = {w["name"]: w for w in m["workloads"]}
    for name in NEW_CELLS:
        w = cells[name]
        assert os.path.isfile(os.path.join(ROOT, "traffic", w["traffic"] + ".json"))
        assert os.path.isfile(os.path.join(ROOT, "limits", w["config"] + ".json"))
        cfg = load("configs", w["config"] + ".json")
        assert os.path.isfile(os.path.join(ROOT, "systems", cfg["system"] + ".py"))
    for name in NEW_METRICS:
        assert os.path.isfile(os.path.join(ROOT, "metrics", name + ".py"))
    lists = {x["name"]: x.get("workloads") for k in ("end_to_end", "per_layer") for x in m[k]}
    assert "v4moon-offline-trip16" not in lists["llm_decode_roofline.offline"]
    assert all(lists[n] == ["v4moon-offline-trip16"] for n in NEW_METRICS)
    moon = load("configs", "openpsg_v4_moonlight16b.json")
    assert moon["reduced"] == [] and moon["hidden_size"] == 2048
    assert load("traffic", "vga_landscape_mb4_trip16.json")["trip_budget"] == 16


def tiny_run(seed=SEED, modes=("f32",)):
    from psgbench.systems.psg_v4_moe import System

    cfg, tr = moon_config(), traffic("vga_landscape_mb4_trip16")
    s = System(cfg, tr, seed, "cpu")
    ctx = offline.run(s, tr, seed, 0.2, False, time.perf_counter())
    taps = ctx.pop("taps")
    s.release()
    return s.check(taps, modes), ctx


def judged(readings):
    return bench.judge(readings, load("limits", "openpsg_v4_moonlight16b.json"))[0]


def test_the_port_against_the_reference_and_the_float8_control():
    r, ctx = tiny_run(modes=("f32", "fp8"))
    f = r["f32"]
    assert ctx["failed"] == 0 and ctx["attempted"] > 0
    assert {"route_gap", "llm_logits_rel", "llm_gap"} <= set(f)
    for name, v in f.items():
        assert v < 1e-4, (name, v)
    assert judged(f)
    assert not judged(r["fp8"]), r["fp8"]
    assert r["fp8"]["route_gap"] > 100 * max(f["route_gap"], 1e-6)


def test_a_broken_expert_choice_is_not_correct(monkeypatch):
    """The program's router picks its second choice in place of its first:
    the reference follows that choice and ``route_gap`` reads it."""
    from openpsg_tpu_torch.models.llm import deepseek_v3

    real = deepseek_v3.Router.forward

    def altered(self, h):
        idx, w = real(self, h)
        scores = torch.sigmoid(h.float() @ self.weight.float().t()) \
            + self.e_score_correction_bias.float()
        worst = torch.topk(scores, self.c.experts_per_token + 1, dim=-1).indices[..., -1:]
        return torch.cat([idx[..., :-1], worst], -1), w

    monkeypatch.setattr(deepseek_v3.Router, "forward", altered)
    r, _ = tiny_run()
    assert not judged(r["f32"]), r["f32"]
    assert r["f32"]["route_gap"] > 1e-3
