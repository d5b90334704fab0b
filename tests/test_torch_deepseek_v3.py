"""The DeepSeek-V3-architecture LLM (``models/llm/deepseek_v3.py``:
latent attention, its latent cache, the expert layer) against the plain
float32 reference (``models/llm/deepseek_v3_reference.py``) at a tiny size
on the CPU, through ``greedy_decode`` and a tiny ``PSGv4``; the Llama's
decode unchanged; and the Llama-only paths refusing the new config.

Both sides compute in float32 here, so they differ only in the order of
their sums (grouped products, the absorbed attention's re-associated
products, the expert sums): 1e-4 relative bounds that with two orders of
magnitude to spare, and is far below what a wrong pairing, scale, mask or
routing weight gives (each moves the logits by more than 1e-2)."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from openpsg_tpu_torch.models.common import init_params
from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4, PSGv4Config
from openpsg_tpu_torch.models.llm import deepseek_v3_reference as ref
from openpsg_tpu_torch.models.llm.decode import greedy_decode
from openpsg_tpu_torch.models.llm.deepseek_v3 import (
    DeepseekV3Config,
    DeepseekV3WithEmbeddings,
    Experts,
    MoE,
)
from openpsg_tpu_torch.models.llm.llama import LlamaConfig, LlamaWithEmbeddings

# the suite's workers share the cores, and these tensors are tiny
torch.set_num_threads(1)

REL = 1e-4   # float32 on both sides: only the order of sums differs (module docstring)


def hf(c: DeepseekV3Config):
    """The config as a published ``config.json`` names it."""
    return dict(vocab_size=c.vocab_size, hidden_size=c.dim, num_hidden_layers=c.n_layers,
                num_attention_heads=c.n_heads, num_key_value_heads=c.n_heads,
                kv_lora_rank=c.kv_lora_rank, q_lora_rank=None,
                qk_nope_head_dim=c.qk_nope_head_dim, qk_rope_head_dim=c.qk_rope_head_dim,
                v_head_dim=c.v_head_dim, intermediate_size=c.ffn_hidden,
                first_k_dense_replace=c.first_k_dense, moe_intermediate_size=c.moe_hidden,
                n_routed_experts=c.n_routed_experts, n_shared_experts=c.n_shared_experts,
                num_experts_per_tok=c.experts_per_token,
                routed_scaling_factor=c.routed_scaling_factor,
                norm_topk_prob=c.norm_topk_prob, rope_theta=c.rope_theta,
                rms_norm_eps=c.norm_eps, n_group=1, topk_group=1, scoring_func="sigmoid",
                topk_method="noaux_tc", moe_layer_freq=1, hidden_act="silu")


def build(c: DeepseekV3Config, seed: int = 0):
    """A seeded model whose router biases are nonzero, so they move the
    choice."""
    gen = torch.Generator().manual_seed(seed)
    m = DeepseekV3WithEmbeddings(c).eval().requires_grad_(False)
    init_params(m, gen)
    with torch.no_grad():
        for layer in m.core.layers:
            if isinstance(layer.mlp, MoE):
                layer.mlp.gate.e_score_correction_bias.normal_(0.0, 0.1, generator=gen)
    return m


def rel(a, b):
    return float((a - b).norm() / b.norm())


def inputs(c, B=3, L=9, seed=1):
    """Embeddings, a right-aligned key mask (row 1 padded at the left) and
    HF positions."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(B, L, c.dim, generator=gen)
    mask = torch.ones(B, L, dtype=torch.bool)
    mask[1, :3] = False
    pos = torch.clamp(torch.cumsum(mask.long(), 1) - 1, min=0)
    return x, mask, pos


@pytest.fixture(scope="module")
def tiny():
    c = DeepseekV3Config.tiny_test()
    return c, build(c)


@pytest.mark.parametrize("experts", ["grouped", "loop"])
def test_full_sequence_logits_match_the_reference(monkeypatch, experts):
    """The model as it runs (grouped experts), and with the plain
    per-expert loop in their place."""
    if experts == "loop":
        monkeypatch.setattr(Experts, "forward", Experts.loop)
    c = DeepseekV3Config.tiny_test()
    m = build(c)
    x, mask, pos = inputs(c)
    with torch.no_grad():
        logits, (lat, pe) = m(input_embeds=x, attention_mask=mask, positions=pos)
        want, _ = ref.forward(m.state_dict(), hf(c), x, mask, pos)
    assert lat.shape == (c.n_layers, 3, 9, c.kv_lora_rank)
    assert pe.shape == (c.n_layers, 3, 9, c.qk_rope_head_dim)
    assert rel(logits, want) < REL


def test_prefill_then_absorbed_decode_matches_the_full_forward(tiny):
    """A prefill over 6 positions, then 4 single-token steps through the
    latent cache: every step's logits equal the reference's full causal
    forward at that position."""
    c, m = tiny
    x, mask, pos = inputs(c, L=10)
    Lp, S = 6, 10
    with torch.no_grad():
        want, _ = ref.forward(m.state_dict(), hf(c), x, mask, pos)
        first, (lat, pe) = m(input_embeds=x[:, :Lp], attention_mask=mask[:, :Lp],
                             positions=pos[:, :Lp], last_logit_only=True)
        cache = tuple(torch.zeros((c.n_layers, 3, S) + t.shape[3:]) for t in (lat, pe))
        cache[0][:, :, :Lp], cache[1][:, :, :Lp] = lat, pe
        key_mask = torch.cat([mask[:, :Lp], torch.zeros(3, S - Lp, dtype=torch.bool)], 1)
        key_pos = torch.cat([pos[:, :Lp], torch.zeros(3, S - Lp, dtype=torch.long)], 1)
        steps = [first[:, 0]]
        for t in range(Lp, S - 1):
            key_mask[:, t] = True
            key_pos[:, t] = pos[:, t]
            lg, back = m(input_embeds=x[:, t:t + 1], attention_mask=key_mask,
                         positions=pos[:, t:t + 1], cache=cache, cache_index=t,
                         key_positions=key_pos)
            assert back is cache
            steps.append(lg[:, 0])
    got = torch.stack(steps, 1)
    assert rel(got, want[:, Lp - 1:S - 1]) < REL
    assert cache[0].shape[-1] + cache[1].shape[-1] == c.kv_lora_rank + c.qk_rope_head_dim


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_experts_match_the_loop_with_an_empty_expert(dtype):
    """Two grouped products against one product per expert; expert 3 gets
    no rows.  bf16: both round each product's result once, so only the
    float32 sums' order and the rounding of identical values differ."""
    c = DeepseekV3Config.tiny_test()
    gen = torch.Generator().manual_seed(3)
    ex = Experts(c).to(dtype)
    with torch.no_grad():
        ex.init_extra(gen)
    T, k, E = 11, c.experts_per_token, c.n_routed_experts
    x = torch.randn(T, c.dim, generator=gen).to(dtype)
    others = torch.tensor([e for e in range(E) if e != 3])
    idx = torch.stack([others[torch.randperm(E - 1, generator=gen)[:k]] for _ in range(T)])
    w = torch.rand(T, k, generator=gen)
    before = MoE.grouped_launches
    with torch.no_grad():
        got = ex(x, idx, w)
        want = ex.loop(x, idx, w)
    assert MoE.grouped_launches - before == 2
    assert got.dtype == torch.float32
    assert rel(got, want) < (REL if dtype == torch.float32 else 1e-2)


def test_routing_with_bias_is_the_reference_choice(tiny):
    """The router's choice (top-k of sigmoid scores plus the bias) and
    weights against the reference's own, on scores without ties; the bias
    changes the choice of some tokens, so it is taken into account."""
    c, m = tiny
    x, mask, pos = inputs(c)
    seen = {}
    hooks = [layer.mlp.gate.register_forward_hook(
        lambda mod, a, out, i=i: seen.update({i: (a[0], out)}))
        for i, layer in enumerate(m.core.layers) if isinstance(layer.mlp, MoE)]
    with torch.no_grad():
        m(input_embeds=x, attention_mask=mask, positions=pos)
        _, choices = ref.forward(m.state_dict(), hf(c), x, mask, pos)
    for h in hooks:
        h.remove()
    assert sorted(seen) == sorted(choices) == list(range(c.first_k_dense, c.n_layers))
    moved = 0
    for i, (h, (idx, w)) in seen.items():
        top = torch.topk(choices[i], c.experts_per_token + 1, dim=-1).values
        assert float((top[..., :-1] - top[..., 1:]).min()) > 1e-4   # no ties
        want = torch.topk(choices[i], c.experts_per_token, dim=-1).indices
        assert torch.equal(idx.sort(-1).values, want.sort(-1).values)
        gate = m.core.layers[i].mlp.gate
        scores = torch.sigmoid(h.float() @ gate.weight.float().t())
        ww = scores.gather(-1, idx)
        assert torch.allclose(w, ww / ww.sum(-1, keepdim=True) * c.routed_scaling_factor,
                              rtol=1e-6, atol=0)
        unbiased = torch.topk(scores, c.experts_per_token, dim=-1).indices
        moved += int((unbiased.sort(-1).values != idx.sort(-1).values).any(-1).sum())
    assert moved > 0


def test_greedy_decode_tokens_follow_the_reference(tiny):
    """greedy_decode over a right-aligned prefix: each token is the
    reference's argmax over the prefix and the tokens before it, each
    score its log-softmax there; the top two logits lie apart (no tie)."""
    c, m = tiny
    x, mask, pos = inputs(c, L=7, seed=5)
    T = 5
    with torch.no_grad():
        toks, scores, trips = greedy_decode(m, x, mask, T, eos_id=-1, pad_id=0)
        fed = m.embed(toks[:, :T - 1].long())
        full = torch.cat([x, fed], 1)
        valid = torch.cat([mask, torch.ones(3, T - 1, dtype=torch.bool)], 1)
        n_real = mask.long().sum(1, keepdim=True)
        fpos = torch.cat([pos, n_real + torch.arange(T - 1)[None]], 1)
        want, _ = ref.forward(m.state_dict(), hf(c), full, valid, fpos,
                              out_at=torch.arange(6, 6 + T))
    assert trips == T
    top2 = torch.topk(want, 2, dim=-1).values
    # apart by more than the two sides' discrepancy (REL of logits near 3)
    assert float((top2[..., 0] - top2[..., 1]).min()) > 1e-4
    assert torch.equal(toks.long(), want.argmax(-1))
    assert torch.allclose(scores, torch.log_softmax(want, -1).amax(-1), atol=1e-5)


def _old_greedy(model, prefix, pmask, T):
    """greedy_decode as it stood before the cache tensors were shaped each
    from its own prefill tensor (both from k's), without an EOS exit."""
    c = model.cfg
    B, Lp, _ = prefix.shape
    S = Lp + T
    key_mask = torch.cat([pmask, torch.zeros(B, T, dtype=torch.bool)], 1)
    positions = torch.clamp(torch.cumsum(pmask.long(), 1) - 1, min=0)
    n_real = pmask.sum(1)
    key_pos = torch.cat([positions, torch.zeros(B, T, dtype=torch.int64)], 1)
    rows = torch.arange(B)
    logits, (k0, v0) = model(input_embeds=prefix, attention_mask=pmask, positions=positions,
                             last_logit_only=True)
    shape = (c.n_layers, B, S) + tuple(k0.shape[3:])
    cache = (torch.zeros(shape, dtype=c.dtype), torch.zeros(shape, dtype=c.dtype))
    cache[0][:, :, :Lp] = k0
    cache[1][:, :, :Lp] = v0
    lg = logits[:, -1]
    tok, score = torch.argmax(lg, -1), torch.log_softmax(lg, -1)[rows, torch.argmax(lg, -1)]
    toks, scores = [], []
    for t in range(T):
        toks.append(tok.to(torch.int32))
        scores.append(score)
        key_mask[:, Lp + t] = True
        pos = (n_real + t)[:, None]
        key_pos[:, Lp + t] = pos[:, 0]
        logits, _ = model(input_embeds=model.embed(tok[:, None]), attention_mask=key_mask,
                          positions=pos, cache=cache, cache_index=Lp + t, key_positions=key_pos)
        lg = logits[:, 0]
        tok = torch.argmax(lg, -1)
        score = torch.log_softmax(lg, -1)[rows, tok]
    return torch.stack(toks, 1), torch.stack(scores, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_llama_decode_unchanged_bit_for_bit(dtype):
    c = dataclasses.replace(LlamaConfig.tiny_test(), dtype=dtype)
    m = LlamaWithEmbeddings(c).to(dtype).eval().requires_grad_(False)
    init_params(m, torch.Generator().manual_seed(0))
    x, mask, _ = inputs(DeepseekV3Config.tiny_test(), L=7, seed=6)
    x = x.to(dtype)
    with torch.no_grad():
        toks, scores, _ = greedy_decode(m, x, mask, 5, eos_id=-1, pad_id=0)
        old_toks, old_scores = _old_greedy(m, x, mask, 5)
    assert torch.equal(toks, old_toks)
    assert torch.equal(scores, old_scores)


def test_spans_and_counters_of_the_expert_layer_and_attention(tiny):
    """One ``psg.mla`` a layer and one ``psg.moe`` an expert layer per
    forward; the counters count from shapes."""
    c, m = tiny
    x, mask, pos = inputs(c)
    launches, rows = MoE.grouped_launches, MoE.routed_rows
    with profile(activities=[ProfilerActivity.CPU]) as prof, torch.no_grad():
        m(input_embeds=x, attention_mask=mask, positions=pos)
    names = [e.name for e in prof.events()]
    n_moe = c.n_layers - c.first_k_dense
    assert names.count("psg.mla") == c.n_layers
    assert names.count("psg.moe") == n_moe
    assert MoE.grouped_launches - launches == 2 * n_moe
    assert MoE.routed_rows - rows == n_moe * x.shape[0] * x.shape[1] * c.experts_per_token


def test_config_from_the_published_keys():
    c = DeepseekV3Config.tiny_test()
    assert DeepseekV3Config.from_hf(hf(c), dtype=torch.float32) == c
    moon = DeepseekV3Config()   # the defaults are Moonlight-16B-A3B's
    assert (moon.dim, moon.n_layers, moon.n_routed_experts, moon.kv_lora_rank) == (
        2048, 27, 64, 512)


@pytest.mark.parametrize("key,value", [("q_lora_rank", 1536), ("n_group", 8),
                                       ("scoring_func", "softmax"),
                                       ("rope_scaling", {"type": "yarn"})])
def test_config_refuses_unsupported_variants(key, value):
    d = dict(hf(DeepseekV3Config.tiny_test()), **{key: value})
    with pytest.raises(NotImplementedError, match=key):
        DeepseekV3Config.from_hf(d)


def _tiny_v4(seed=0):
    c = PSGv4Config.tiny_test()
    llm = DeepseekV3Config.tiny_test(vocab_size=c.llm.vocab_size)
    return dataclasses.replace(c, llm=llm, iou_thr=0.1)


@pytest.fixture(scope="module")
def v4moe():
    return PSGv4(_tiny_v4(), seed=0, device="cpu")


def test_psgv4_decodes_with_the_new_llm_through_infer_microbatch(v4moe):
    """The tiny v4 program with the new LLM: the served tokens are the
    reference's greedy choice over the program's own prefix."""
    m = v4moe
    assert isinstance(m.llm, DeepseekV3WithEmbeddings)
    seen = {}
    inner = m.tail_decode

    def tail_decode(prefix, pmask, trip_budget=None):
        out = inner(prefix, pmask, trip_budget)
        seen.update(prefix=prefix, pmask=pmask, toks=out[0], trips=out[2])
        return out

    m.tail_decode = tail_decode
    try:
        rng = np.random.default_rng(0)
        ims = [rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8) for _ in range(2)]
        res = m.infer_microbatch(ims, [(64, 64), (56, 60)], trip_budget=3)
    finally:
        del m.tail_decode
    assert len(res) == 2 and res[0]["decode_steps"] == seen["trips"] == 3
    T, Lp = seen["trips"], seen["prefix"].shape[1]
    toks = seen["toks"][:, :T].long()
    pmask = seen["pmask"]
    B = toks.shape[0]
    with torch.no_grad():
        full = torch.cat([seen["prefix"].float(), m.llm.embed(toks[:, :T - 1]).float()], 1)
        valid = torch.cat([pmask, torch.ones(B, T - 1, dtype=torch.bool)], 1)
        pos = torch.cat([torch.clamp(torch.cumsum(pmask.long(), 1) - 1, min=0),
                         pmask.long().sum(1, keepdim=True) + torch.arange(T - 1)[None]], 1)
        want, _ = ref.forward(m.llm.state_dict(), hf(m.cfg.llm), full, valid, pos,
                              out_at=torch.arange(Lp - 1, Lp - 1 + T))
    stopped = torch.cumsum((toks == m.tokenizer.pad_id).long(), 1) > 0
    assert torch.equal(torch.where(stopped, 0, toks), torch.where(stopped, 0, want.argmax(-1)))


@pytest.mark.parametrize("path", ["V4Trainer", "shard_params", "shard_pipeline",
                                  "pipelined_llama_logits", "llm.quant"])
def test_llama_only_paths_refuse_the_new_config_by_name(v4moe, path):
    """Each refuses at its entry, naming itself and the config, before any
    work (no mesh is even needed to get there)."""
    from openpsg_tpu_torch.parallel.pipeline import pipelined_llama_logits, shard_pipeline
    from openpsg_tpu_torch.parallel.sharding import shard_params
    from openpsg_tpu_torch.train.trainer import V4Trainer

    calls = {
        "V4Trainer": lambda: V4Trainer(v4moe),
        "shard_params": lambda: shard_params(v4moe.llm, None),
        "shard_pipeline": lambda: shard_pipeline(v4moe.llm, None),
        "pipelined_llama_logits": lambda: pipelined_llama_logits(
            v4moe.llm, None, None, None, None, 1),
        "llm.quant": lambda: PSGv4(dataclasses.replace(
            _tiny_v4(), llm=dataclasses.replace(_tiny_v4().llm, quant=True)), device="cpu"),
    }
    with pytest.raises(NotImplementedError, match="DeepseekV3Config") as e:
        calls[path]()
    assert path.split(".")[-1] in str(e.value)


# ------------------------------------------------- the graph path's indexing


def _family(family: str, seed: int = 0):
    """A tiny float32 LLM of either family and a prefix for it."""
    if family == "llama":
        c = LlamaConfig.tiny_test()
        m = LlamaWithEmbeddings(c).eval().requires_grad_(False)
        init_params(m, torch.Generator().manual_seed(seed))
    else:
        c = DeepseekV3Config.tiny_test()
        m = build(c, seed)
    x, mask, _ = inputs(DeepseekV3Config.tiny_test(), L=7, seed=seed + 6)
    return m, x, mask


@pytest.mark.parametrize("L", [1, 2])
@pytest.mark.parametrize("family", ["llama", "llama_full_mask", "deepseek"])
def test_device_cache_index_matches_the_int_index(family, L):
    """A forward over the cache at ``cache_index`` given as a 0-d int64
    tensor (the graph path's) writes the same cache and gives the same
    logits, bit for bit, as the int index (the Llama's ``full_mask`` too,
    sliced at the index)."""
    m, x, mask = _family(family.split("_")[0])
    c = m.cfg
    B, Lp, S = x.shape[0], 5, 9
    pos = torch.clamp(torch.cumsum(mask.long(), 1) - 1, min=0)
    with torch.no_grad():
        _, (k0, v0) = m(input_embeds=x[:, :Lp], attention_mask=mask[:, :Lp],
                        positions=pos[:, :Lp], last_logit_only=True)
        cache = tuple(torch.zeros((c.n_layers, B, S) + t.shape[3:]) for t in (k0, v0))
        cache[0][:, :, :Lp], cache[1][:, :, :Lp] = k0, v0
        key_mask = torch.cat([mask[:, :Lp], torch.ones(B, S - Lp, dtype=torch.bool)], 1)
        key_pos = torch.cat([pos[:, :Lp], pos[:, Lp - 1:Lp] + torch.arange(1, S - Lp + 1)], 1)
        kw = {}
        if family == "llama_full_mask":     # each query sees every other key
            see = torch.ones(B, L, S, dtype=torch.bool)
            see[:, :, 1::2] = False
            kw["full_mask"] = see
        out = {}
        for index in (Lp, torch.tensor(Lp)):
            kv = tuple(t.clone() for t in cache)
            logits, back = m(input_embeds=x[:, Lp:Lp + L], attention_mask=key_mask,
                             positions=key_pos[:, Lp:Lp + L], cache=kv, cache_index=index,
                             key_positions=key_pos, **kw)
            assert back is kv
            out[type(index)] = (logits, kv)
    (li, (ki, vi)), (lt, (kt, vt)) = out[int], out[torch.Tensor]
    assert torch.equal(li, lt) and torch.equal(ki, kt) and torch.equal(vi, vt)
    assert not torch.equal(ki, cache[0])


def _state_path(monkeypatch):
    """greedy_decode's graph path on the CPU, the "capture" and each
    "replay" running the trip eagerly: its kept states and their indexing,
    without graphs.  → the kept :class:`DecodeGraphs`."""
    from types import SimpleNamespace

    from openpsg_tpu_torch.models.llm import decode

    kept = decode.DecodeGraphs(torch.device("cpu"))
    monkeypatch.setattr(decode, "_graphs", lambda model, dev: kept)
    monkeypatch.setattr(decode.SegmentedGraph, "capture",
                        lambda fn, modules, stream: fn() or SimpleNamespace(replay=fn))
    return kept


@pytest.mark.parametrize("family", ["llama", "deepseek"])
def test_decode_state_trip_matches_the_eager_loop(family, monkeypatch):
    """A state kept across calls (the graph path's, run eagerly on the
    CPU) gives the tokens, scores and trips of a state made for each call,
    bit for bit, with each picked token as EOS (rows stop at different
    trips, and all of them before the cap for some), with another pad id,
    with budgets, and over the cap; one state serves every EOS and pad."""
    m, x, mask = _family(family)
    T = 6
    with torch.no_grad():
        free = greedy_decode(m, x, mask, T, eos_id=-1, pad_id=0)
        cases = [dict(eos_id=e) for e in sorted(set(free[0].flatten().tolist()))]
        cases += [dict(eos_id=-1, trip_budget=b) for b in (1, 3, T + 4)]
        cases += [dict(eos_id=cases[0]["eos_id"], early_exit=False),
                  dict(eos_id=int(free[0][0, 1]), pad_id=3)]
        want = [greedy_decode(m, x, mask, T, **dict(dict(pad_id=0), **kw)) for kw in cases]
        with monkeypatch.context() as mp:
            kept = _state_path(mp)
            got = [greedy_decode(m, x, mask, T, **dict(dict(pad_id=0), **kw)) for kw in cases]
    for g, w in zip(got, want):
        assert g[2] == w[2]
        assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
    assert min(w[2] for w in want) < T
    assert any(bool((w[0] == 0).any()) and w[2] == T for w in want)
    assert bool((want[-1][0] == 3).any())
    assert len(kept.states) == 1


@pytest.mark.parametrize("family", ["llama", "deepseek"])
def test_decode_states_keep_the_last_used_shapes(family, monkeypatch):
    """The kept states are the ``KEPT`` decode shapes used last: a shape
    used again keeps its state, and the least recently used goes first;
    each call decodes as a state made for it does."""
    m, x, mask = _family(family)
    rows = [1, 2, 3, 4, 5, 2, 6]
    take = [torch.arange(b) % x.shape[0] for b in rows]
    with torch.no_grad():
        want = [greedy_decode(m, x[i], mask[i], 4, eos_id=-1) for i in take]
        with monkeypatch.context() as mp:
            kept = _state_path(mp)
            got, seen = [], {}
            for b, i in zip(rows, take):
                got.append(greedy_decode(m, x[i], mask[i], 4, eos_id=-1))
                key = next(reversed(kept.states))
                assert key[0] == b
                seen.setdefault(b, []).append(kept.states[key])
    for g, w in zip(got, want):
        assert g[2] == w[2]
        assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
    assert seen[2][0] is seen[2][1]
    assert [k[0] for k in kept.states] == [4, 5, 2, 6]
    assert kept.KEPT == 4


@pytest.mark.parametrize("family", ["llama", "deepseek"])
def test_cpu_decode_runs_its_trips_eagerly(family):
    """On the CPU the graph path never engages: every trip counts as eager."""
    m, x, mask = _family(family)
    counters = ("graph_captures", "graph_trips", "eager_trips")
    before = {k: getattr(greedy_decode, k) for k in counters}
    with torch.no_grad():
        trips = [greedy_decode(m, x, mask, 5, eos_id=-1, pad_id=0, trip_budget=b)[2]
                 for b in (None, 2)]
    ran = {k: getattr(greedy_decode, k) - before[k] for k in counters}
    assert ran == {"graph_captures": 0, "graph_trips": 0, "eager_trips": sum(trips)}
    assert trips == [5, 2]
    assert "_decode_graphs" not in vars(m)


@pytest.mark.parametrize("family", ["llama", "deepseek"])
def test_decode_states_are_dropped_when_weights_move_or_hooks_change(family):
    """A graph reads its weights at fixed addresses and splits where a hook
    runs: loading weights with ``assign=True`` (as the benchmark hands them
    over) or hooking another module drops the captured states."""
    from openpsg_tpu_torch.models.llm.decode import DecodeGraphs

    m, _, _ = _family(family)
    kept = DecodeGraphs(torch.device("cpu"))
    kept.refresh(m)
    kept.states["shape"] = "state"
    kept.refresh(m)
    assert kept.states == {"shape": "state"}
    m.load_state_dict({k: v.clone() for k, v in m.state_dict().items()}, assign=True)
    kept.refresh(m)
    assert kept.states == {}
    kept.states["shape"] = "state"
    handle = m.core.lm_head.register_forward_hook(lambda mod, args, out: None)
    kept.refresh(m)
    assert kept.states == {}
    handle.remove()
    kept.states["shape"] = "state"
    kept.refresh(m)
    assert kept.states == {}
